"""The engine router (ops/fill_auto.py): which engine each backend, mode
and shape takes, the memory budget that splits arrow-emitting batches,
and the compile-cache placement the entry points share."""

import os

import jax
import numpy as np
import pytest

import nw_tpu.ops.fill_auto as fa
from nw_tpu.ops.encode import encode_batch


@pytest.mark.parametrize(
    "platform,nb,L1,L2,need_arrows,engine",
    [
        # GPU: the row-sweep kernel up to 1024-long sides at any batch
        ("gpu", 10240, 150, 150, False, "rows"),
        ("gpu", 4096, 150, 150, True, "rows"),
        ("gpu", 1, 64, 64, True, "rows"),
        ("gpu", 32, 1024, 1024, False, "rows"),
        ("gpu", 32, 1024, 64, True, "rows"),
        # beyond 1024, only batches that fill the card
        ("gpu", 1024, 4096, 4096, False, "rows"),
        ("gpu", 1023, 2048, 2048, False, "scan"),
        ("gpu", 128, 10240, 10240, True, "scan"),
        ("gpu", 32, 2048, 64, False, "scan"),
        # pairs too large for an arrow table go one at a time
        ("gpu", 1, 100_000, 100_000, True, "huge"),
        ("gpu", 1, 100_000, 100_000, False, "scan"),
        ("gpu", 2048, 40_000, 40_000, True, "huge"),
        ("gpu", 4, 64, fa.HUGE_PAIR_MIN_SIDE, True, "scan"),
        ("gpu", 4, 64, fa.HUGE_PAIR_MIN_SIDE + 1, True, "huge"),
        # CPU (and any other backend): the scan, never interpret mode
        ("cpu", 10240, 150, 150, False, "scan"),
        ("cpu", 4096, 150, 150, True, "scan"),
        ("cpu", 1, 100_000, 100_000, True, "huge"),
    ],
)
def test_pick_engine(platform, nb, L1, L2, need_arrows, engine):
    assert (
        fa.pick_engine(nb, L1, L2, need_arrows=need_arrows, platform=platform)
        == engine
    )


def test_pick_engine_default_platform_is_the_backend():
    assert fa.default_platform() == jax.devices()[0].platform
    assert fa.pick_engine(4096, 150, 150, need_arrows=True) == "scan"


@pytest.mark.parametrize(
    "engine,L1,L2,counts,strings,expect",
    [
        ("rows", 150, 150, True, False, 0),  # counts ride the fill
        ("rows", 150, 150, False, True, 152 * 10 * 4),  # 38 strips, 10 words
        ("scan", 150, 150, False, False, 0),  # score-only: no arrows
        ("scan", 150, 150, True, False, 301 * 151),
        ("scan", 10240, 10240, False, True, 20481 * 10241),
    ],
)
def test_pair_bytes(engine, L1, L2, counts, strings, expect):
    assert fa.pair_bytes(engine, L1, L2, counts, strings) == expect


def test_arrow_budget_bytes_host_fallback():
    """A backend without a memory limit (the CPU) gets the fixed host
    budget; a device reporting one gets the configured share of it."""
    assert fa.arrow_budget_bytes() == fa.HOST_ARROW_BUDGET


def test_arrow_budget_bytes_share_of_device_limit(monkeypatch):
    class Dev:
        platform = "gpu"

        def memory_stats(self):
            return {"bytes_limit": 60 << 30}

    monkeypatch.setattr(fa.jax, "devices", lambda: [Dev()])
    assert fa.arrow_budget_bytes() == (60 << 30) // fa.ARROW_BUDGET_SHARE


def test_chunked_splits_on_budget(monkeypatch):
    pairs = [(b"ACGT" * 3, b"AC" * 5)] * 7
    per_pair = (12 + 10 + 1) * 11
    monkeypatch.setattr(fa, "arrow_budget_bytes", lambda: 2 * per_pair)
    sizes = []
    out = fa.chunked(pairs, lambda sub: sizes.append(len(sub)) or list(sub))
    assert sizes == [2, 2, 2, 1] and out == pairs
    assert fa.chunked([], lambda sub: 1 / 0) == []


@pytest.mark.parametrize(
    "counts,strings", [(False, False), (True, False), (False, True), (True, True)]
)
def test_fill_batch_engines_agree(counts, strings, monkeypatch):
    """Both engines return the same outputs for every mode (the rows
    kernel runs through the interpreter here)."""
    import functools

    import nw_tpu.ops.fill_rows as fr

    rng = np.random.default_rng(3)
    pairs = [
        (
            rng.choice(list(b"ACGT"), int(rng.integers(0, 20))).astype(np.uint8).tobytes(),
            rng.choice(list(b"ACGT"), int(rng.integers(0, 20))).astype(np.uint8).tobytes(),
        )
        for _ in range(6)
    ]
    tops, sides, l1, l2 = encode_batch(pairs, 20, 20)
    scan = fa.fill_batch(
        tops, sides, l1, l2, 2, 1, 1, engine="scan", counts=counts,
        strings=strings,
    )
    monkeypatch.setattr(
        fa, "fill_rows_batch",
        functools.partial(fr.fill_rows_batch, interpret=True),
    )
    rows = fa.fill_batch(
        tops, sides, l1, l2, 2, 1, 1, engine="rows", counts=counts,
        strings=strings,
    )
    assert set(rows) == set(scan)
    for key in scan:
        np.testing.assert_array_equal(np.asarray(rows[key]), np.asarray(scan[key]))


def test_compile_cache_dir_env_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, jax reads it itself and the
    program sets no other directory."""
    from nw_tpu import cli

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cli.compile_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        cli.enable_default_compile_cache()
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)


def test_compile_cache_dir_default_in_checkout(monkeypatch):
    """Unset: one fixed path inside the checkout (listed in .gitignore)."""
    from nw_tpu import cli

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cli.compile_cache_dir() == os.path.join(repo, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        cli.enable_default_compile_cache()
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            repo, ".jax_cache"
        )
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
