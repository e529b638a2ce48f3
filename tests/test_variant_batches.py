"""Variant batch routes (SW local, Gotoh affine) vs the single-pair scan
engines: ragged bucket-padded batches, degenerate pairs, long sides and
memory-budget sub-batches, for scores and full alignments."""

import jax.numpy as jnp
import numpy as np
import pytest

from nw_tpu.models.affine import (
    affine_align,
    affine_align_batch,
    affine_score,
    affine_score_pairs,
)
from nw_tpu.models.smith_waterman import (
    sw_align,
    sw_align_batch,
    sw_fill_diag,
    sw_score_batch,
)
from nw_tpu.ops.encode import encode


def _pairs(rng, n, lo, hi):
    return [
        (
            "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi)))),
            "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi)))),
        )
        for _ in range(n)
    ]


def _enc(s):
    return jnp.asarray(encode(s.encode()))


@pytest.mark.parametrize("m,k,d", [(2, 1, 1), (1, 1, 1), (3, 2, 5), (2, 3, 1)])
def test_sw_batch_matches_scan(m, k, d):
    rng = np.random.default_rng(7)
    pairs = _pairs(rng, 10, 1, 40) + [("A", "A"), ("AC", "GT"), ("", "AC")]
    got = sw_score_batch(pairs, m, k, d)
    for b, (a, s) in enumerate(pairs):
        ref = int(sw_fill_diag(_enc(a), _enc(s), m, k, d, with_arrows=False)["score"])
        assert got[b] == ref, (b, a, s, got[b], ref)


@pytest.mark.parametrize(
    "m,k,op,ex", [(2, 1, 3, 1), (1, 1, 1, 1), (2, 3, 5, 2), (3, 1, 4, 0)]
)
def test_affine_batch_matches_scan(m, k, op, ex):
    rng = np.random.default_rng(8)
    pairs = _pairs(rng, 10, 1, 40) + [("A", "A"), ("", "ACG"), ("ACG", "")]
    got = affine_score_pairs(pairs, m, k, op, ex)
    for b, (a, s) in enumerate(pairs):
        ref = int(affine_score(_enc(a), _enc(s), m, k, op, ex))
        assert got[b] == ref, (b, a, s, got[b], ref)


def test_model_batch_apis():
    """Model-level ragged batch scoring == per-pair scan engines."""
    rng = np.random.default_rng(9)
    pairs = _pairs(rng, 8, 1, 50)
    sw = sw_score_batch(pairs, 2, 1, 1)
    af = affine_score_pairs(pairs, 2, 1, 3, 1)
    for b, (a, s) in enumerate(pairs):
        t, si = _enc(a), _enc(s)
        assert sw[b] == int(sw_fill_diag(t, si, 2, 1, 1, with_arrows=False)["score"])
        assert af[b] == int(affine_score(t, si, 2, 1, 3, 1))


@pytest.mark.parametrize("m,k,d", [(2, 1, 1), (3, 2, 2), (1, 1, 1)])
def test_sw_align_batch_matches_single(m, k, d):
    """Batched SW alignment (vmapped fill + device walk) == sw_align."""
    rng = np.random.default_rng(31)
    pairs = _pairs(rng, 10, 1, 45) + [("AAAA", "TTTT"), ("A", "A"), ("AC", "CA")]
    got = sw_align_batch(pairs, m, k, d)
    for b, (a, s) in enumerate(pairs):
        want = sw_align(a, s, m, k, d)
        assert got[b] == want, (b, a, s, m, k, d, got[b], want)


@pytest.mark.parametrize("m,k,op,ex", [(2, 1, 3, 1), (1, 1, 1, 1), (3, 1, 4, 0)])
def test_affine_align_batch_matches_single(m, k, op, ex):
    """Batched affine alignment (vmapped Gotoh fill + device walk)
    == per-pair affine_align."""
    rng = np.random.default_rng(41)
    pairs = _pairs(rng, 9, 1, 45) + [("A", "A"), ("", "ACG"), ("ACG", "")]
    got = affine_align_batch(pairs, m, k, op, ex)
    for b, (a, s) in enumerate(pairs):
        want = affine_align(a, s, m, k, op, ex)
        assert got[b] == want, (b, a, s, m, k, op, ex, got[b], want)


def test_variant_batch_long_side():
    """A long side padded into one bucket with short pairs: identical
    to the per-pair engines (no per-pair loop, one dispatch)."""
    rng = np.random.default_rng(53)
    long_b = "".join(rng.choice(list("ACGT"), 2100))
    pairs = [("ACGTAC", long_b), ("GATTACA", "GCATGCU")]
    got = sw_align_batch(pairs, 2, 1, 1)
    assert got[0] == sw_align(*pairs[0], 2, 1, 1)
    assert got[1] == sw_align(*pairs[1], 2, 1, 1)
    long_b2 = "".join(rng.choice(list("ACGT"), 1100))
    pairs2 = [("ACGTAC", long_b2), ("GATTACA", "GCATGCU")]
    got2 = affine_align_batch(pairs2, 2, 1, 3, 1)
    assert got2[0] == affine_align(*pairs2[0], 2, 1, 3, 1)
    assert got2[1] == affine_align(*pairs2[1], 2, 1, 3, 1)


def test_variant_score_long_side():
    rng = np.random.default_rng(57)
    long_b = "".join(rng.choice(list("ACGT"), 4200))
    sw = sw_score_batch([("ACGTAC", long_b), ("AC", "AC")], 2, 1, 1)
    assert sw[0] == int(sw_fill_diag(_enc("ACGTAC"), _enc(long_b), 2, 1, 1)["score"])
    assert sw[1] == 4
    long_b2 = "".join(rng.choice(list("ACGT"), 3200))
    af = affine_score_pairs([("ACGTAC", long_b2)], 2, 1, 3, 1)
    assert af[0] == int(affine_score(_enc("ACGTAC"), _enc(long_b2), 2, 1, 3, 1))


def test_variant_align_batches_chunked(monkeypatch):
    """Memory-budget sub-batches give the same alignments as one bucket."""
    import nw_tpu.ops.fill_auto as fa

    rng = np.random.default_rng(61)
    pairs = _pairs(rng, 9, 0, 30)
    sw_whole = sw_align_batch(pairs, 2, 1, 1)
    af_whole = affine_align_batch(pairs, 2, 1, 3, 1)
    monkeypatch.setattr(fa, "arrow_budget_bytes", lambda: 4000)
    assert sw_align_batch(pairs, 2, 1, 1) == sw_whole
    assert affine_align_batch(pairs, 2, 1, 3, 1) == af_whole
