"""Benchmark rows: DP-fill throughput and end-to-end pair rates on the GPU.

Each row is one JSON line that names the device it ran on
(``jax.devices()[0].platform``, ``device_kind``, the device count, and
the card's name and power limit from nvidia-smi).
The script refuses to run without a GPU: a CPU timing says nothing about
the card.  Rows:

* config 2: 10240 x 150 bp score-only through ``align_batch``;
* short reads: 4096 x 150 bp strings + counts through ``align_batch``;
* config 3: 128 x 10 kb strings + counts through ``align_batch``;
* SW / Gotoh / overlap full alignments at 128 x 3 kb;
* the data-parallel sharded score path over every visible device;
* one 100 kb pair: ``align_huge`` (checkpointed exact traceback).

Times are host wall clock around calls that end in host results (so
every row waits for the device), after one warm-up call of the same
shape; the median of ``trials`` runs is reported with its spread.
Baseline: the reference C binary fills at 10.7 MCUPS single-threaded
(BASELINE.md; measured, 1k x 1k pair).
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

BASELINE_GCUPS = 0.0107  # reference: 10.7 MCUPS (BASELINE.md)


@functools.lru_cache(maxsize=None)
def _device():
    """The device as JAX reports it, and the card's name and power limit
    as nvidia-smi reports them (a card below its maximum limit runs
    slower under load)."""
    import jax

    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": card,
    }


def _emit(metric, value, unit, **extra):
    line = {"metric": metric, "value": value, "unit": unit,
            "device": _device(), **extra}
    print(json.dumps(line), flush=True)


def _pairs(rng, nb, L):
    return [
        (
            rng.integers(65, 69, L).astype(np.uint8).tobytes(),
            rng.integers(65, 69, L).astype(np.uint8).tobytes(),
        )
        for _ in range(nb)
    ]


def _median_time(call, trials):
    call()  # warm: same shapes, so compilation stays out of the window
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return statistics.median(ts), ts[0], ts[-1]


def bench_config2(NB=10240, L=150, trials=5):
    """BASELINE config 2: 10240 x 150 bp score-only."""
    from nw_tpu.models.needleman_wunsch import align_batch

    pairs = _pairs(np.random.default_rng(0), NB, L)
    med, lo, hi = _median_time(lambda: align_batch(pairs, 2, 1, 1), trials)
    _emit(
        f"config 2: {NB}x{L}bp score-only, align_batch (median of {trials},"
        f" min {lo:.4f} s max {hi:.4f} s)",
        round(NB * L * L / med / 1e9, 3), "GCUPS",
        vs_baseline=round(NB * L * L / med / 1e9 / BASELINE_GCUPS, 1),
    )


def bench_e2e_150(NB=4096, L=150, trials=5):
    """Short-read end-to-end: strings + counts."""
    from nw_tpu.models.needleman_wunsch import align_batch

    pairs = _pairs(np.random.default_rng(5), NB, L)

    def run():
        align_batch(
            pairs, 2, 1, 1, traceback_strings=True, count=True
        ).alignment_strings()

    med, lo, hi = _median_time(run, trials)
    _emit(
        f"end-to-end {NB}x{L}bp strings+counts (median of {trials},"
        f" min {lo:.4f} s max {hi:.4f} s)",
        round(NB / med, 1), "pairs/s",
    )


def bench_config3(NB=128, L=10240, trials=3):
    """BASELINE config 3: long pairs, traceback + strings + counts."""
    from nw_tpu.models.needleman_wunsch import align_batch

    pairs = _pairs(np.random.default_rng(4), NB, L)

    def run():
        align_batch(
            pairs, 2, 1, 1, traceback_strings=True, count=True
        ).alignment_strings()

    med, lo, hi = _median_time(run, trials)
    _emit(
        f"config 3: {NB}x{L // 1024}kb strings+counts (median of {trials},"
        f" min {lo:.3f} s max {hi:.3f} s)",
        round(NB / med, 2), "pairs/s",
    )


def bench_variant_tracebacks(NB=128, L=3072, trials=3):
    """Full SW / Gotoh / overlap alignments on long pairs."""
    from nw_tpu.models.affine import affine_align_batch
    from nw_tpu.models.overlap import overlap_align_batch
    from nw_tpu.models.smith_waterman import sw_align_batch

    pairs = _pairs(np.random.default_rng(9), NB, L)
    for name, run in (
        ("SW", lambda: sw_align_batch(pairs, 2, 1, 1)),
        ("Gotoh", lambda: affine_align_batch(pairs, 2, 1, 3, 1)),
        ("Overlap", lambda: overlap_align_batch(pairs, 2, 1, 1)),
    ):
        med, lo, hi = _median_time(run, trials)
        _emit(
            f"{name} full alignments, {NB}x{L // 1024}kb (median of {trials},"
            f" min {lo:.3f} s max {hi:.3f} s)",
            round(NB / med, 2), "pairs/s",
        )


def bench_sharded(NB=10240, L=150, trials=5):
    """Data-parallel score path over every visible device."""
    import jax
    from jax.sharding import Mesh

    from nw_tpu.ops.encode import encode_batch_u8
    from nw_tpu.parallel.data_parallel import align_batch_sharded, shard_batch

    mesh = Mesh(np.array(jax.devices()), ("data",))
    tops, sides, l1, l2 = encode_batch_u8(
        _pairs(np.random.default_rng(6), NB, L)
    )
    args = shard_batch(mesh, "data", tops, sides, l1, l2)

    def run():
        np.asarray(
            align_batch_sharded(*args, m=2, k=1, d=1, mesh=mesh)[0]
        )

    med, lo, hi = _median_time(run, trials)
    _emit(
        f"sharded score path, {NB}x{L}bp over {len(jax.devices())} devices"
        f" (median of {trials}, min {lo:.4f} s max {hi:.4f} s)",
        round(NB * L * L / med / 1e9, 3), "GCUPS",
    )


def bench_huge_pair(L=100_000, trials=1):
    """Single huge pair: exact first-emission traceback (config 5 scale,
    one device)."""
    from nw_tpu.models.needleman_wunsch import NWAligner

    rng = np.random.default_rng(7)
    s1 = rng.integers(65, 69, L).astype(np.uint8).tobytes()
    s2 = rng.integers(65, 69, L).astype(np.uint8).tobytes()
    al = NWAligner()
    med, lo, hi = _median_time(lambda: al.align_huge(s1, s2), trials)
    _emit(f"align_huge exact traceback, 1x{L // 1000}kb", round(med, 3), "s")


def main() -> None:
    from nw_tpu.cli import enable_default_compile_cache

    enable_default_compile_cache()

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(
            f"bench.py measures the GPU; found {jax.devices()[0].platform}"
        )
    bench_config2()
    bench_e2e_150()
    bench_config3()
    bench_variant_tracebacks()
    bench_sharded()
    bench_huge_pair()


if __name__ == "__main__":
    main()
