"""The row-sweep GPU kernel (ops/fill_rows.py) in Pallas interpret mode
vs the scan oracle: every mode (score, score + count, greedy walk words,
both) x bucket shapes with empty, one-character, odd, not-a-multiple-of-16
and unequal lengths x scoring (incl. all-tie and negative parameters).

Compiled shapes are shared across the scoring and length cases (the
scoring operands and the true lengths are traced), so each mode
compiles once per bucket shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nw_tpu.ops.encode import encode_batch
from nw_tpu.ops.fill_auto import fill_batch
from nw_tpu.ops.fill_rows import fill_rows_batch
from nw_tpu.ops.traceback import traceback_greedy2_rowmajor_batch

MODES = {
    "score": (False, False),
    "count": (True, False),
    "words": (False, True),
    "count_words": (True, True),
}
# bucket (L1, L2) and the true lengths of the pairs padded into it
SHAPES = {
    "empty_and_one": (1, 1, [(0, 0), (1, 0), (0, 1), (1, 1)]),
    "odd": (13, 7, [(13, 7), (5, 7), (13, 0), (0, 7), (1, 1), (12, 6)]),
    "not16": (24, 33, [(24, 33), (17, 33), (24, 31), (3, 29), (23, 1)]),
    "unequal": (40, 9, [(40, 9), (37, 9), (40, 2), (39, 8), (1, 9)]),
}
SCORING = [(2, 1, 1), (0, 0, 0), (-1, 2, -2), (3, -1, 2)]


def _batch(shape, seed):
    L1, L2, lens = SHAPES[shape]
    rng = np.random.default_rng(seed)
    # a 2-letter alphabet keeps ties (and multi-path counts) dense
    pairs = [
        (
            rng.choice(list(b"AC"), a).astype(np.uint8).tobytes(),
            rng.choice(list(b"AC"), b).astype(np.uint8).tobytes(),
        )
        for a, b in lens
    ]
    return encode_batch(pairs, L1, L2)


def _check(tops, sides, l1, l2, mkd, counts, words, **kw):
    out = fill_rows_batch(
        tops, sides, l1, l2, *mkd, with_counts=counts, with_words=words,
        interpret=True, **kw,
    )
    ref = fill_batch(
        tops, sides, l1, l2, *mkd, engine="scan", counts=True, strings=True
    )
    np.testing.assert_array_equal(np.asarray(out["score"]), np.asarray(ref["score"]))
    if counts:
        assert out["count"].dtype == jnp.uint32
        np.testing.assert_array_equal(
            np.asarray(out["count"]), np.asarray(ref["count"])
        )
    if words:
        steps = int(tops.shape[1] + sides.shape[1])
        ops, n = traceback_greedy2_rowmajor_batch(
            out["words"], jnp.asarray(l1), jnp.asarray(l2), max(steps, 1)
        )
        np.testing.assert_array_equal(np.asarray(n), np.asarray(ref["n"]))
        np.testing.assert_array_equal(
            np.asarray(ops)[:, :steps], np.asarray(ref["ops"])
        )


@pytest.mark.parametrize("mkd", SCORING)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", list(MODES))
def test_rows_kernel_vs_scan(mode, shape, mkd):
    tops, sides, l1, l2 = _batch(shape, seed=len(shape) * 7 + sum(mkd))
    _check(tops, sides, l1, l2, mkd, *MODES[mode])


@pytest.mark.parametrize("rows", [1, 3])
def test_rows_kernel_strip_heights(rows):
    """Strip heights that do not divide the top length (the last strip
    computes rows past L1) and the one-row strip (no skew)."""
    tops, sides, l1, l2 = _batch("odd", seed=rows)
    _check(tops, sides, l1, l2, (2, 1, 1), True, True, rows=rows)


def test_rows_kernel_multi_program_batch():
    """A batch spanning several 32-pair programs, not a multiple of 32,
    with one program's pairs ending in many strips and another's in
    one (the corner capture is per lane)."""
    rng = np.random.default_rng(5)
    pairs = []
    for i in range(70):
        a = int(rng.integers(0, 30)) if i < 32 else 29
        b = int(rng.integers(0, 21))
        pairs.append(
            (
                rng.choice(list(b"ACG"), a).astype(np.uint8).tobytes(),
                rng.choice(list(b"ACG"), b).astype(np.uint8).tobytes(),
            )
        )
    tops, sides, l1, l2 = encode_batch(pairs, 30, 21)
    _check(tops, sides, l1, l2, (2, 1, 1), True, False)


def test_rows_kernel_empty_batch():
    tops, sides, l1, l2 = encode_batch([], 8, 8)
    out = fill_rows_batch(
        tops, sides, l1, l2, 2, 1, 1, with_counts=True, with_words=True,
        interpret=True,
    )
    assert out["score"].shape == (0,) and out["count"].shape == (0,)
    assert out["words"].shape[2] == 0


def test_rows_kernel_word_layout():
    """Output geometry: rows padded to whole strips, 16 columns per
    word (column 0 included), pairs on the last axis."""
    tops, sides, l1, l2 = _batch("not16", seed=3)
    out = fill_rows_batch(
        tops, sides, l1, l2, 2, 1, 1, with_words=True, interpret=True
    )
    assert out["words"].shape == (24, (33 + 16) // 16, len(l1))
    assert out["words"].dtype == jnp.int32


def test_rows_kernel_count_wraps_uint32():
    """Counts wrap at 2^32 exactly like the reference's unsigned
    counter: an all-tie 40x40 table has C(80, 40)-scale path counts
    under (0, 0, 0) scoring."""
    pairs = [(b"A" * 40, b"A" * 40), (b"A" * 40, b"C" * 9)]
    tops, sides, l1, l2 = encode_batch(pairs, 40, 40)
    _check(tops, sides, l1, l2, (0, 0, 0), True, False)
