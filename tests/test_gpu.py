"""Checks that need the card: the row-sweep kernel as compiled for the
GPU (no interpreter) vs the scan oracle at a real read width, and the
router's choice on a GPU backend.  Each test asks for the ``gpu``
fixture, which skips when JAX's first device is not a GPU; on the card
``python chip_smoke.py`` runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {platform}")


def _batch(nb, L, seed):
    rng = np.random.default_rng(seed)
    tops = rng.integers(65, 69, (nb, L)).astype(np.uint8)
    sides = rng.integers(65, 69, (nb, L)).astype(np.uint8)
    l1 = rng.integers(L // 2, L + 1, nb).astype(np.int32)
    l2 = rng.integers(L // 2, L + 1, nb).astype(np.int32)
    return tops, sides, l1, l2


@pytest.mark.parametrize("counts,strings", [(False, False), (True, True)])
def test_rows_kernel_compiled_vs_scan(gpu, counts, strings):
    from nw_tpu.ops.fill_auto import fill_batch

    tops, sides, l1, l2 = _batch(1000, 150, 1)
    rows = fill_batch(
        tops, sides, l1, l2, 2, 1, 1, engine="rows", counts=counts,
        strings=strings,
    )
    scan = fill_batch(
        tops, sides, l1, l2, 2, 1, 1, engine="scan", counts=counts,
        strings=strings,
    )
    for key in scan:
        np.testing.assert_array_equal(
            np.asarray(rows[key]), np.asarray(scan[key])
        )


def test_router_takes_the_kernel_on_gpu(gpu):
    from nw_tpu.ops.fill_auto import pick_engine

    assert pick_engine(10240, 150, 150, need_arrows=False) == "rows"
    assert pick_engine(128, 10240, 10240, need_arrows=True) == "scan"


def test_align_batch_on_gpu_matches_single_pair(gpu):
    from nw_tpu.models.needleman_wunsch import NWAligner

    rng = np.random.default_rng(2)
    pairs = [
        (
            rng.choice(list(b"ACGT"), int(rng.integers(0, 60))).astype(np.uint8).tobytes(),
            rng.choice(list(b"ACGT"), int(rng.integers(0, 60))).astype(np.uint8).tobytes(),
        )
        for _ in range(40)
    ]
    al = NWAligner(match=2, mismatch=1, indel=1)
    r = al.align_batch(pairs, traceback_strings=True, count=True)
    strings = r.alignment_strings()
    for i, (a, b) in enumerate(pairs):
        one = al.align(a, b)
        assert r.scores[i] == one.score
        assert strings[i] == one.best_alignment()
        if a or b:
            assert r.counts[i] == one.solution_count
    assert jnp.asarray(0).devices().pop().platform == "gpu"
