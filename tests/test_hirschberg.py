"""Hirschberg linear-space alignment: optimality + validity."""

import numpy as np
import pytest

from nw_tpu.ops import enumerate_walk
from nw_tpu.ops.encode import encode
from nw_tpu.ops.fill_scan import diag_to_matrix, fill_diag, fill_last_row
from nw_tpu.ops.hirschberg import hirschberg_align


def rescore(X: bytes, Y: bytes, m, k, d) -> int:
    s = 0
    for c1, c2 in zip(X, Y):
        if c1 == ord("-") or c2 == ord("-"):
            s -= d
        elif c1 == c2:
            s += m
        else:
            s -= k
    return s


def test_fill_last_row_matches_matrix():
    rng = np.random.default_rng(0)
    for _ in range(6):
        s1 = "".join(rng.choice(list("ACGT"), 13))
        s2 = "".join(rng.choice(list("ACGT"), 9))
        out = fill_diag(encode(s1), encode(s2), 2, 1, 1, with_scores=True)
        H = diag_to_matrix(np.asarray(out["scores"]), len(s1), len(s2))
        for j in (0, 4, len(s2)):
            row = np.asarray(
                fill_last_row(encode(s1), encode(s2), 2, 1, 1, len(s1), j)
            )
            np.testing.assert_array_equal(row, H[j])


def test_hirschberg_is_optimal_alignment():
    rng = np.random.default_rng(1)
    for trial in range(8):
        s1 = "".join(rng.choice(list("ACGT"), int(rng.integers(20, 400))))
        s2 = "".join(rng.choice(list("ACGT"), int(rng.integers(20, 400))))
        m, k, d = (int(x) for x in rng.integers(1, 4, 3))
        X, Y = hirschberg_align(s1, s2, m, k, d)
        # valid alignment of the inputs
        assert X.replace(b"-", b"") == s1.encode()
        assert Y.replace(b"-", b"") == s2.encode()
        # optimal score
        ref = int(
            fill_diag(encode(s1), encode(s2), m, k, d, with_arrows=False)["score"]
        )
        assert rescore(X, Y, m, k, d) == ref, (trial, ref)


def test_hirschberg_in_enumeration_set():
    """On a small pair, the result is one of the enumerated optima."""
    s1, s2 = "GCATGCU", "GATTACA"
    X, Y = hirschberg_align(s1, s2, 1, 1, 1)
    out = fill_diag(encode(s1), encode(s2), 1, 1, 1)
    arrows = diag_to_matrix(np.asarray(out["arrows"]), len(s1), len(s2))
    all_opt = set(
        enumerate_walk.iter_alignments(arrows, s1.encode(), s2.encode())
    )
    assert (X, Y) in all_opt


def test_hirschberg_empty_and_degenerate():
    assert hirschberg_align("", "ACG", 1, 1, 1) == (b"---", b"ACG")
    assert hirschberg_align("ACG", "", 1, 1, 1) == (b"ACG", b"---")
    X, Y = hirschberg_align("A", "A", 1, 1, 1)
    assert (X, Y) == (b"A", b"A")


@pytest.mark.parametrize(
    "A,B,Ab,Bb", [(20, 10, 32, 16), (150, 150, 150, 150), (37, 260, 64, 512)]
)
def test_last_row_matches_full_table(A, B, Ab, Bb):
    """fill_last_row on bucket-padded inputs == row B of the full table."""
    import jax.numpy as jnp

    rng = np.random.default_rng(A + B)
    t = np.full((Ab,), -1, np.int32)
    t[:A] = rng.integers(65, 69, A)
    s = np.full((Bb,), -2, np.int32)
    s[:B] = rng.integers(65, 69, B)
    got = np.asarray(
        fill_last_row(jnp.asarray(t), jnp.asarray(s), 2, 1, 1, A, B)
    )[: A + 1]
    full = fill_diag(t[:A], s[:B], 2, 1, 1, with_scores=True)
    want = diag_to_matrix(np.asarray(full["scores"]), A, B)[B]
    np.testing.assert_array_equal(got, want)
