"""Traceback, enumeration, counting, and marking tests."""

import numpy as np
import pytest

from nw_tpu.ops import enumerate_walk, pathcount, traceback
from nw_tpu.ops.encode import encode
from nw_tpu.ops.fill_scan import diag_to_matrix, fill_diag


def _fill(s1, s2, m=1, k=1, d=1):
    out = fill_diag(encode(s1), encode(s2), m, k, d, with_scores=True)
    return np.asarray(out["arrows"]), int(out["score"])


def brute_force_alignments(s1, s2, m, k, d):
    """Exponential-but-tiny reference: enumerate every alignment path by
    recursion over the naive DP, in diag>left>up order."""
    from tests.test_fill import naive_nw

    H, Ar = naive_nw(s1, s2, m, k, d)
    results = []

    def rec(i, j, X, Y):
        if i == 0 and j == 0:
            results.append((X[::-1], Y[::-1]))
            return
        a = Ar[j, i]
        if a & 1:
            rec(i - 1, j - 1, X + s1[i - 1], Y + s2[j - 1])
        if a & 2:
            rec(i - 1, j, X + s1[i - 1], Y + "-")
        if a & 4:
            rec(i, j - 1, X + "-", Y + s2[j - 1])

    if len(s1) or len(s2):
        rec(len(s1), len(s2), "", "")
    return results


GOLDEN = [
    # (s1, s2, m, k, d, expected alignments in emission order)
    ("GCATGCU", "GATTACA", 1, 1, 1,
     [("GCA-TGCU", "G-ATTACA"), ("GCAT-GCU", "G-ATTACA"), ("GCATG-CU", "G-ATTACA")]),
    ("GAT", "GTA", 1, 1, 1, [("G-AT", "GTA-"), ("GAT-", "G-TA")]),
    ("GT", "GT", 1, 1, 1, [("GT", "GT")]),
]


@pytest.mark.parametrize("s1,s2,m,k,d,expected", GOLDEN)
def test_enumeration_golden_order(s1, s2, m, k, d, expected):
    arrows_diag, _ = _fill(s1, s2, m, k, d)
    arrows = diag_to_matrix(arrows_diag, len(s1), len(s2))
    got = [
        (X.decode(), Y.decode())
        for X, Y in enumerate_walk.iter_alignments(arrows, s1.encode(), s2.encode())
    ]
    assert got == expected


def test_enumeration_matches_bruteforce_random():
    rng = np.random.default_rng(3)
    for _ in range(15):
        s1 = "".join(rng.choice(list("ACG"), 6))
        s2 = "".join(rng.choice(list("ACG"), 6))
        m, k, d = (int(x) for x in rng.integers(0, 3, 3))
        expected = brute_force_alignments(s1, s2, m, k, d)
        arrows_diag, _ = _fill(s1, s2, m, k, d)
        arrows = diag_to_matrix(arrows_diag, len(s1), len(s2))
        got = [
            (X.decode(), Y.decode())
            for X, Y in enumerate_walk.iter_alignments(arrows, s1.encode(), s2.encode())
        ]
        assert got == expected, (s1, s2, m, k, d)


def test_native_walker_matches_python():
    native = pytest.importorskip("nw_tpu.runtime.native")
    walker = native.load()
    if walker is None:
        pytest.skip("native walker unavailable")
    rng = np.random.default_rng(5)
    for _ in range(10):
        s1 = "".join(rng.choice(list("ACGT"), 8))
        s2 = "".join(rng.choice(list("ACGT"), 7))
        arrows_diag, _ = _fill(s1, s2, 1, 1, 1)
        arrows = diag_to_matrix(arrows_diag, len(s1), len(s2))
        py = list(enumerate_walk.iter_alignments(arrows, s1.encode(), s2.encode()))
        nat = []
        cnt = walker.enumerate(
            arrows, s1.encode(), s2.encode(), lambda X, Y: nat.append((X, Y))
        )
        assert nat == py
        assert cnt == len(py)


def test_count_paths_matches_enumeration():
    rng = np.random.default_rng(11)
    for _ in range(10):
        s1 = "".join(rng.choice(list("AC"), 7))
        s2 = "".join(rng.choice(list("AC"), 7))
        m, k, d = (int(x) for x in rng.integers(0, 2, 3))
        arrows_diag, _ = _fill(s1, s2, m, k, d)
        arrows = diag_to_matrix(arrows_diag, len(s1), len(s2))
        n_enum = sum(
            1 for _ in enumerate_walk.iter_alignments(arrows, s1.encode(), s2.encode())
        )
        n_dp = int(pathcount.count_paths(arrows_diag, len(s1), len(s2)))
        assert n_dp == n_enum, (s1, s2, m, k, d)


def test_mark_optimal_cells_matches_visited():
    """DP marking == the set of cells the DFS visits."""
    rng = np.random.default_rng(13)
    for _ in range(8):
        s1 = "".join(rng.choice(list("ACG"), 6))
        s2 = "".join(rng.choice(list("ACG"), 5))
        arrows_diag, _ = _fill(s1, s2, 1, 1, 1)
        arrows = diag_to_matrix(arrows_diag, len(s1), len(s2))
        N, M = arrows.shape
        visited = np.zeros((N, M), bool)
        # replicate the DFS visit set directly
        stack = [(M - 1, N - 1)]
        seen = set()
        while stack:
            i, j = stack.pop()
            if (i, j) in seen:
                continue
            seen.add((i, j))
            visited[j, i] = True
            a = arrows[j, i]
            if a & 1:
                stack.append((i - 1, j - 1))
            if a & 2:
                stack.append((i - 1, j))
            if a & 4:
                stack.append((i, j - 1))
        marks = diag_to_matrix(
            np.asarray(pathcount.mark_optimal_cells(arrows_diag, len(s1), len(s2))),
            len(s1),
            len(s2),
        )
        np.testing.assert_array_equal(marks.astype(bool), visited)


def test_greedy_traceback_is_first_alignment():
    rng = np.random.default_rng(17)
    for _ in range(8):
        s1 = "".join(rng.choice(list("ACGT"), 9))
        s2 = "".join(rng.choice(list("ACGT"), 7))
        arrows_diag, _ = _fill(s1, s2, 1, 1, 1)
        arrows = diag_to_matrix(arrows_diag, len(s1), len(s2))
        first = next(
            enumerate_walk.iter_alignments(arrows, s1.encode(), s2.encode())
        )
        ops, n = traceback.traceback_greedy(
            arrows_diag, len(s1), len(s2), max_steps=len(s1) + len(s2)
        )
        X, Y = traceback.ops_to_strings(ops, int(n), s1.encode(), s2.encode())
        assert (X, Y) == first


def test_ops_to_strings_batch_matches_scalar():
    """Vectorized batched string rendering == per-pair rendering."""
    import jax.numpy as jnp

    from nw_tpu.ops.encode import encode_batch
    from nw_tpu.ops.fill_scan import fill_diag_batch

    rng = np.random.default_rng(23)
    pairs = [
        (
            rng.choice(list(b"ACGT"), int(rng.integers(0, 30))).astype("u1").tobytes(),
            rng.choice(list(b"ACGT"), int(rng.integers(0, 30))).astype("u1").tobytes(),
        )
        for _ in range(40)
    ]
    tops, sides, l1, l2 = encode_batch(pairs, 30, 30)
    out = fill_diag_batch(tops, sides, 2, 1, 1, jnp.asarray(l1), jnp.asarray(l2))
    ops, ns = traceback.traceback_greedy_batch(
        out["arrows"], jnp.asarray(l1), jnp.asarray(l2), max_steps=60
    )
    got = traceback.ops_to_strings_batch(ops, ns, pairs)
    want = [
        traceback.ops_to_strings(ops[b], int(ns[b]), s1, s2)
        for b, (s1, s2) in enumerate(pairs)
    ]
    assert got == want


def test_mark_optimal_cells_padded():
    """mark_optimal_cells over bucket-padded batch arrows (true lengths)
    equals the marks of the unpadded single-pair table."""
    import jax.numpy as jnp

    from nw_tpu.ops.encode import encode_batch
    from nw_tpu.ops.fill_scan import fill_diag_batch

    rng = np.random.default_rng(61)
    pairs = [
        (
            "".join(rng.choice(list("ACGT"), int(rng.integers(1, 13)))),
            "".join(rng.choice(list("ACGT"), int(rng.integers(1, 11)))),
        )
        for _ in range(4)
    ]
    tops, sides, l1, l2 = encode_batch(pairs, 12, 10)
    arr = fill_diag_batch(
        tops, sides, 2, 1, 1, jnp.asarray(l1), jnp.asarray(l2)
    )["arrows"]
    for b, (s1, s2) in enumerate(pairs):
        a1, a2 = int(l1[b]), int(l2[b])
        mk_pad = diag_to_matrix(
            np.asarray(pathcount.mark_optimal_cells(arr[b], a1, a2)), a1, a2
        )
        one = fill_diag(encode(s1), encode(s2), 2, 1, 1)["arrows"]
        mk_one = diag_to_matrix(
            np.asarray(pathcount.mark_optimal_cells(one, a1, a2)), a1, a2
        )
        np.testing.assert_array_equal(mk_pad, mk_one)
