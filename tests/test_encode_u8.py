"""uint8 sequence encoding (0-pad) vs the sentinel int32 encoding.

``encode_batch_u8`` exists to shrink the host->device sequence upload
4x (see ``ops/encode.py``).  Its 0-pad is only sound because every
consumer extracts lens-masked, true-rectangle outputs — these tests pin
that equivalence on the real pipelines, including mixed-length batches
and NUL bytes (a real byte that COLLIDES with the 0 pad), before the
model layer routes uploads through it.
"""

import numpy as np
import pytest

from nw_tpu.ops import encode as enc

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _mixed_pairs(rng, n, lo, hi, nul_every=3):
    """Random byte pairs with mixed lengths; every ``nul_every``-th pair
    gets NUL bytes spliced in (the 0-pad collision case)."""
    ps = []
    for i in range(n):
        a = bytes(rng.integers(1, 255, int(rng.integers(lo, hi))).astype(np.uint8))
        b = bytes(rng.integers(1, 255, int(rng.integers(lo, hi))).astype(np.uint8))
        if nul_every and i % nul_every == 0:
            a = b"\x00" + a + b"\x00"
            b = b[: len(b) // 2] + b"\x00" + b[len(b) // 2 :]
        ps.append((a, b))
    return ps


def test_u8_matches_int32_on_true_region():
    rng = np.random.default_rng(7)
    ps = _mixed_pairs(rng, 9, 1, 30)
    tops, sides, l1, l2 = enc.encode_batch(ps)
    tops8, sides8, l1b, l2b = enc.encode_batch_u8(ps)
    assert tops8.dtype == np.uint8 and sides8.dtype == np.uint8
    np.testing.assert_array_equal(l1, l1b)
    np.testing.assert_array_equal(l2, l2b)
    assert tops8.shape == tops.shape and sides8.shape == sides.shape
    for i in range(len(ps)):
        np.testing.assert_array_equal(
            tops8[i, : l1[i]].astype(np.int32), tops[i, : l1[i]]
        )
        np.testing.assert_array_equal(
            sides8[i, : l2[i]].astype(np.int32), sides[i, : l2[i]]
        )
        # pad region: 0 bytes (uint8) vs the sentinels (int32)
        assert (tops8[i, l1[i] :] == 0).all()
        assert (tops[i, l1[i] :] == enc.PAD_TOP).all()
        assert (sides8[i, l2[i] :] == 0).all()
        assert (sides[i, l2[i] :] == enc.PAD_SIDE).all()


def test_u8_empty_and_bucket():
    tops8, sides8, l1, l2 = enc.encode_batch_u8([])
    assert tops8.shape == (0, 0) and l1.shape == (0,)
    tops8, sides8, l1, l2 = enc.encode_batch_u8([(b"AB", b"C")], 5, 4)
    assert tops8.shape == (1, 5) and sides8.shape == (1, 4)
    with pytest.raises(ValueError):
        enc.encode_batch_u8([(b"ABCDEF", b"C")], 5, 4)


def test_u8_scan_traceback_equivalence():
    """The scan engine's arrows-based route (scores, counts and greedy
    walks) on uint8 vs sentinel-int32 inputs: identical outputs."""
    from nw_tpu.ops.fill_auto import fill_batch

    rng = np.random.default_rng(11)
    ps = _mixed_pairs(rng, 6, 1, 50)
    tops, sides, l1, l2 = enc.encode_batch(ps)
    tops8, sides8, _, _ = enc.encode_batch_u8(ps)
    kw = dict(engine="scan", counts=True, strings=True)
    ref = fill_batch(tops, sides, l1, l2, 2, 1, 1, **kw)
    got = fill_batch(tops8, sides8, l1, l2, 2, 1, 1, **kw)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]))


def test_u8_scan_scores_equivalence():
    from nw_tpu.ops.fill_scan import fill_scores_batch

    rng = np.random.default_rng(13)
    ps = _mixed_pairs(rng, 6, 1, 60)
    tops, sides, l1, l2 = enc.encode_batch(ps)
    tops8, sides8, _, _ = enc.encode_batch_u8(ps)
    ref = np.asarray(fill_scores_batch(tops, sides, 3, -1, 2, l1, l2))
    got = np.asarray(fill_scores_batch(tops8, sides8, 3, -1, 2, l1, l2))
    np.testing.assert_array_equal(got, ref)


def test_u8_rows_kernel_equivalence():
    """The row-sweep kernel's score / count / greedy-word modes
    (interpret mode) on uint8 vs sentinel inputs."""
    from nw_tpu.ops.fill_rows import fill_rows_batch
    from nw_tpu.ops.traceback import traceback_greedy2_rowmajor_batch

    rng = np.random.default_rng(17)
    ps = _mixed_pairs(rng, 8, 1, 24)
    tops, sides, l1, l2 = enc.encode_batch(ps)
    tops8, sides8, _, _ = enc.encode_batch_u8(ps)
    kw = dict(with_counts=True, with_words=True, interpret=True)
    ref = fill_rows_batch(tops, sides, l1, l2, 2, 1, 1, **kw)
    got = fill_rows_batch(tops8, sides8, l1, l2, 2, 1, 1, **kw)
    np.testing.assert_array_equal(np.asarray(got["score"]), np.asarray(ref["score"]))
    np.testing.assert_array_equal(np.asarray(got["count"]), np.asarray(ref["count"]))
    # walk words beyond the true rectangle may differ (pad-region cells);
    # compare the decoded greedy walks instead, which read only true cells
    steps = int(tops.shape[1] + sides.shape[1])
    r_ops, r_n = traceback_greedy2_rowmajor_batch(ref["words"], l1, l2, steps)
    g_ops, g_n = traceback_greedy2_rowmajor_batch(got["words"], l1, l2, steps)
    np.testing.assert_array_equal(np.asarray(g_n), np.asarray(r_n))
    np.testing.assert_array_equal(np.asarray(g_ops), np.asarray(r_ops))


def test_u8_variant_traceback_equivalence():
    """SW / Gotoh / overlap batched full-alignment fills on uint8 vs
    sentinel inputs (their best/argmax updates are lens-masked, so the
    0-pad must be invisible)."""
    import jax.numpy as jnp

    from nw_tpu.models.affine import _affine_fill_batch
    from nw_tpu.models.overlap import _overlap_fill_batch
    from nw_tpu.models.smith_waterman import _sw_fill_batch

    rng = np.random.default_rng(19)
    ps = _mixed_pairs(rng, 5, 1, 40)
    tops, sides, l1, l2 = enc.encode_batch(ps)
    tops8, sides8, _, _ = enc.encode_batch_u8(ps)
    l1j, l2j = jnp.asarray(l1), jnp.asarray(l2)

    for fn, params in (
        (_sw_fill_batch, (2, 1, 1)),
        (_overlap_fill_batch, (2, 1, 1)),
        (_affine_fill_batch, (2, 1, 3, 1)),
    ):
        ref = fn(tops, sides, *params, l1j, l2j)
        got = fn(tops8, sides8, *params, l1j, l2j)
        for key in ("score", "argmax", "state"):
            if key in ref:
                np.testing.assert_array_equal(
                    np.asarray(got[key]), np.asarray(ref[key])
                )


def test_u8_variant_score_equivalence():
    import jax.numpy as jnp

    from nw_tpu.models.affine import affine_score_batch
    from nw_tpu.models.overlap import overlap_scores_scan_batch
    from nw_tpu.models.smith_waterman import sw_scores_scan_batch

    rng = np.random.default_rng(23)
    ps = _mixed_pairs(rng, 8, 1, 24)
    tops, sides, l1, l2 = enc.encode_batch(ps)
    tops8, sides8, _, _ = enc.encode_batch_u8(ps)
    l1j, l2j = jnp.asarray(l1), jnp.asarray(l2)

    for fn, params in (
        (sw_scores_scan_batch, (2, 1, 1)),
        (overlap_scores_scan_batch, (2, 1, 1)),
        (affine_score_batch, (2, 1, 3, 1)),
    ):
        ref = np.asarray(fn(tops, sides, *params, l1j, l2j))
        got = np.asarray(fn(tops8, sides8, *params, l1j, l2j))
        np.testing.assert_array_equal(got, ref)
