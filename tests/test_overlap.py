"""Overlap (semi-global) alignment vs an independent numpy DP oracle.

The reference names overlap as the third classic algorithm it wants a
common tool for (FUTURE WORK, README:182-187) but ships none — these
semantics are new surface, pinned by models/overlap.py's docstring and
cross-checked here against a from-scratch numpy implementation.
"""

import numpy as np
import pytest

from nw_tpu.models.overlap import (
    overlap_align,
    overlap_fill_diag,
    overlap_score_batch,
)
from nw_tpu.ops import encode as enc


def np_overlap_score(a: bytes, b: bytes, m: int, k: int, d: int) -> int:
    """Brute-force end-gap-free DP: free row 0 / col 0, best over the
    last row and last column."""
    M, N = len(a), len(b)
    H = np.zeros((M + 1, N + 1), np.int64)
    for i in range(1, M + 1):
        for j in range(1, N + 1):
            sub = m if a[i - 1] == b[j - 1] else -k
            H[i, j] = max(
                H[i - 1, j - 1] + sub, H[i - 1, j] - d, H[i, j - 1] - d
            )
    return int(max(H[M, :].max(), H[:, N].max()))


def _pairs(rng, n, lo, hi):
    out = []
    for _ in range(n):
        a = rng.integers(65, 69, rng.integers(lo, hi)).astype(np.uint8)
        b = rng.integers(65, 69, rng.integers(lo, hi)).astype(np.uint8)
        out.append((a.tobytes(), b.tobytes()))
    return out


EDGE = [(b"", b""), (b"GCATGCU", b"GATTACA"), (b"A" * 19, b""),
        (b"", b"T" * 23), (b"AAAA", b"TTTT")]


@pytest.mark.parametrize("mkd", [(2, 1, 1), (1, 1, 1), (0, 0, 0), (-2, 3, -1)])
def test_overlap_oracle_vs_numpy(mkd):
    import jax.numpy as jnp

    m, k, d = mkd
    rng = np.random.default_rng(61 + m + k + d)
    for a, b in _pairs(rng, 12, 0, 24) + EDGE:
        got = int(
            overlap_fill_diag(
                jnp.asarray(enc.encode(a)), jnp.asarray(enc.encode(b)),
                m, k, d, with_arrows=False,
            )["score"]
        )
        assert got == np_overlap_score(a, b, m, k, d), (a, b)


def test_overlap_suffix_prefix():
    """The textbook use: suffix of s1 overlapping a prefix of s2 scores
    the full overlap length at match-heavy params."""
    sc, X, Y, start, end = overlap_align(b"AAAATTTT", b"TTTTCCCC", 2, 3, 3)
    assert sc == 8  # TTTT overlap, 4 matches x 2
    assert X == b"TTTT" and Y == b"TTTT"
    assert start == (0, 4) and end == (4, 8)  # (j, i) convention


@pytest.mark.parametrize("mkd", [(2, 1, 1), (0, 0, 0)])
def test_overlap_align_invariants(mkd):
    m, k, d = mkd
    rng = np.random.default_rng(67 + m + k + d)
    for a, b in _pairs(rng, 12, 0, 24) + EDGE:
        sc, X, Y, (js, is_), (je, ie) = overlap_align(a, b, m, k, d)
        # strings re-score to the reported score
        assert len(X) == len(Y)
        tot = 0
        for x, y in zip(X, Y):
            if x == ord("-") or y == ord("-"):
                tot -= d
            elif x == y:
                tot += m
            else:
                tot -= k
        assert tot == sc, (a, b)
        # gap-stripped strings are the substrings between start and end
        assert bytes(c for c in X if c != ord("-")) == a[is_:ie]
        assert bytes(c for c in Y if c != ord("-")) == b[js:je]
        # start on a free boundary, end on the end boundary
        assert is_ == 0 or js == 0
        assert ie == len(a) or je == len(b)
        assert sc >= 0


@pytest.mark.parametrize("mkd", [(2, 1, 1), (-2, 3, -1)])
def test_overlap_score_batch_vs_oracle(mkd):
    """Ragged bucket-padded batches (incl. empty sides) through the
    batched score route vs the single-pair scan oracle."""
    import jax.numpy as jnp

    m, k, d = mkd
    rng = np.random.default_rng(71 + m)
    ps = _pairs(rng, 18, 0, 30) + EDGE
    got = overlap_score_batch(ps, m, k, d)
    for b_i, (a, b) in enumerate(ps):
        want = int(
            overlap_fill_diag(
                jnp.asarray(enc.encode(a)), jnp.asarray(enc.encode(b)),
                m, k, d, with_arrows=False,
            )["score"]
        )
        assert got[b_i] == want, (b_i, a, b)


def test_overlap_align_batch_matches_single():
    """Batched fill + vmapped walk == the per-pair scan walk (same tie
    rules), including ragged lengths and degenerate pairs."""
    from nw_tpu.models.overlap import overlap_align_batch

    rng = np.random.default_rng(79)
    ps = _pairs(rng, 14, 0, 28) + EDGE
    got = overlap_align_batch(ps, 2, 1, 1)
    for b_i, (a, b) in enumerate(ps):
        assert got[b_i] == overlap_align(a, b, 2, 1, 1), (b_i, a, b)


def test_overlap_score_batch_long_sides_no_cliff():
    """>512-side batches route to the vmapped scan fill (one compile,
    no per-pair recompiles) and still match the numpy DP."""
    rng = np.random.default_rng(83)
    ps = [
        (rng.integers(65, 69, 600).astype(np.uint8).tobytes(),
         rng.integers(65, 69, rng.integers(500, 700)).astype(np.uint8).tobytes())
        for _ in range(3)
    ]
    got = overlap_score_batch(ps, 2, 1, 1)
    a, b = ps[0]
    assert got[0] == np_overlap_score(a, b, 2, 1, 1)


@pytest.mark.parametrize("mkd", [(2, 1, 1), (-2, 3, -1)])
def test_overlap_score_batch_long_ragged(mkd):
    """Long ragged shapes (one side empty, very unequal sides) in one
    padded bucket vs the scan oracle, both parameter signs (the
    free-boundary pins must hold for negative d too)."""
    import jax.numpy as jnp

    m, k, d = mkd
    rng = np.random.default_rng(89 + m + k + d)
    ps = []
    for L1, L2 in [(300, 290), (127, 260), (5, 300), (300, 5), (0, 80),
                   (80, 0), (257, 257), (33, 190)]:
        a = rng.integers(65, 69, L1).astype(np.uint8).tobytes()
        b = rng.integers(65, 69, L2).astype(np.uint8).tobytes()
        ps.append((a, b))
    got = overlap_score_batch(ps, m, k, d)
    for b_i, (a, b) in enumerate(ps):
        want = int(
            overlap_fill_diag(
                jnp.asarray(enc.encode(a)), jnp.asarray(enc.encode(b)),
                m, k, d, with_arrows=False,
            )["score"]
        )
        assert got[b_i] == want, (b_i, len(a), len(b))


def test_overlap_align_batch_chunked(monkeypatch):
    """The memory-budget auto-split produces identical results to one
    bucket (sub-batch boundaries must not change any alignment)."""
    import nw_tpu.models.overlap as ov
    import nw_tpu.ops.fill_auto as fa

    rng = np.random.default_rng(101)
    ps = _pairs(rng, 11, 0, 24) + EDGE
    whole = ov.overlap_align_batch(ps, 2, 1, 1)
    monkeypatch.setattr(fa, "arrow_budget_bytes", lambda: 2000)
    chunked = ov.overlap_align_batch(ps, 2, 1, 1)
    assert chunked == whole


@pytest.mark.parametrize("budget", [None, 30_000])
@pytest.mark.parametrize("mkd", [(2, 1, 1), (0, 0, 0)])
def test_overlap_align_batch_long_vs_scan(mkd, budget, monkeypatch):
    """Batched overlap FULL alignments == the single-pair scan walker
    (scores, strings, start AND end cells) on long ragged pairs, incl.
    all-tie and degenerate pairs, in one bucket or split into
    memory-budget sub-batches."""
    import nw_tpu.ops.fill_auto as fa
    from nw_tpu.models.overlap import overlap_align, overlap_align_batch

    if budget is not None:
        monkeypatch.setattr(fa, "arrow_budget_bytes", lambda: budget)
    m, k, d = mkd
    rng = np.random.default_rng(103 + m + k + d)
    ps = []
    for L1, L2 in [(90, 85), (40, 100), (100, 40), (0, 30), (30, 0),
                   (65, 65), (1, 99), (99, 1)]:
        a = rng.integers(65, 69, L1).astype(np.uint8).tobytes()
        b = rng.integers(65, 69, L2).astype(np.uint8).tobytes()
        ps.append((a, b))
    ps += [(b"AAAATTTT", b"TTTTCCCC")]
    got = overlap_align_batch(ps, m, k, d)
    for b_i, (a, b) in enumerate(ps):
        assert got[b_i] == overlap_align(a, b, m, k, d), b_i


def test_overlap_score_batch_routes():
    rng = np.random.default_rng(73)
    ps = _pairs(rng, 10, 0, 20) + EDGE
    got = overlap_score_batch(ps, 2, 1, 1)
    for b_i, (a, b) in enumerate(ps):
        assert got[b_i] == np_overlap_score(a, b, 2, 1, 1), b_i
