"""Property tests for the anti-diagonal fill (SURVEY.md §4.3 item 2)."""

import numpy as np
import pytest

from nw_tpu.ops.encode import encode, encode_pair
from nw_tpu.ops.fill_scan import fill_diag, fill_matrix


def naive_nw(s1: str, s2: str, m: int, k: int, d: int):
    """Cell-at-a-time reference DP, transcribing the reference scoring
    rules (needleman-wunsch.c:418-510, computation.c:94-120)."""
    A, B = len(s1), len(s2)
    H = np.zeros((B + 1, A + 1), np.int64)
    Ar = np.zeros((B + 1, A + 1), np.uint8)
    for i in range(1, A + 1):
        H[0, i] = -i * d
        Ar[0, i] = 2
    for j in range(1, B + 1):
        H[j, 0] = -j * d
        Ar[j, 0] = 4
    for j in range(1, B + 1):
        for i in range(1, A + 1):
            sub = m if s1[i - 1] == s2[j - 1] else -k
            cd, cu, cl = H[j - 1, i - 1] + sub, H[j - 1, i] - d, H[j, i - 1] - d
            s = max(cd, cu, cl)
            H[j, i] = s
            Ar[j, i] = (cd == s) | ((cl == s) << 1) | ((cu == s) << 2)
    return H, Ar


CASES = [
    ("GCATGCU", "GATTACA", 1, 1, 1),
    ("GT", "GT", 1, 1, 1),
    ("GT", "GA", 1, 1, 1),
    ("GAT", "GTA", 1, 1, 1),
    ("GT", "GA", 0, 0, 0),  # degenerate: everything ties
    ("ACGT", "ACGT", -2, -1, 3),  # negative match bonus
    ("", "ACG", 1, 1, 1),  # empty top string
    ("ACG", "", 1, 1, 1),  # empty side string
    ("AAAA", "AAAA", 2, 1, 0),  # zero gap penalty
]


@pytest.mark.parametrize("s1,s2,m,k,d", CASES)
def test_fill_matches_naive(s1, s2, m, k, d):
    He, Ae = naive_nw(s1, s2, m, k, d)
    Hs, As = fill_matrix(encode(s1), encode(s2), m, k, d)
    np.testing.assert_array_equal(He, Hs)
    np.testing.assert_array_equal(Ae, As)


def test_fill_random_fixed_shape():
    """Many random contents at ONE shape (single jit compile)."""
    rng = np.random.default_rng(7)
    for _ in range(25):
        s1 = "".join(rng.choice(list("ACGT"), 12))
        s2 = "".join(rng.choice(list("ACGT"), 10))
        m, k, d = (int(x) for x in rng.integers(-3, 4, 3))
        He, Ae = naive_nw(s1, s2, m, k, d)
        Hs, As = fill_matrix(encode(s1), encode(s2), m, k, d)
        np.testing.assert_array_equal(He, Hs)
        np.testing.assert_array_equal(Ae, As)


def test_padding_does_not_contaminate():
    """A padded fill agrees with an unpadded fill inside the true
    rectangle, and the captured true-corner score is right."""
    s1, s2, m, k, d = "GCATGCU", "GATTACA", 1, 2, 1
    top, side, l1, l2 = encode_pair(s1, s2, 16, 12)
    out = fill_diag(top, side, m, k, d, l1, l2, with_scores=True)
    He, Ae = naive_nw(s1, s2, m, k, d)
    from nw_tpu.ops.fill_scan import diag_to_matrix

    H = diag_to_matrix(np.asarray(out["scores"]), l1, l2)
    A = diag_to_matrix(np.asarray(out["arrows"]), l1, l2)
    np.testing.assert_array_equal(He[: l2 + 1, : l1 + 1], H)
    np.testing.assert_array_equal(Ae[: l2 + 1, : l1 + 1], A)
    assert int(out["score"]) == He[l2, l1]


def test_symmetry_swap():
    """score(A,B) == score(B,A); arrows swap LEFT<->UP and transpose."""
    s1, s2, m, k, d = "GATTACA", "GCATGCU", 1, 1, 1
    H1, A1 = fill_matrix(encode(s1), encode(s2), m, k, d)
    H2, A2 = fill_matrix(encode(s2), encode(s1), m, k, d)
    np.testing.assert_array_equal(H1, H2.T)
    swapped = (
        (A2 & 1) | ((A2 & 2) << 1) | ((A2 & 4) >> 1)
    )  # LEFT<->UP under transpose
    np.testing.assert_array_equal(A1, swapped.T)


def naive_count(Ar):
    """Optimal-path count over rectangular arrows (uint32 wraparound,
    the reference's unsigned counter, computation.h:65)."""
    N, M = Ar.shape
    C = np.zeros((N, M), np.uint64)
    C[0, 0] = 1
    for j in range(N):
        for i in range(M):
            if i == 0 and j == 0:
                continue
            a = int(Ar[j, i])
            c = 0
            if a & 1:
                c += int(C[j - 1, i - 1])
            if a & 2:
                c += int(C[j, i - 1])
            if a & 4:
                c += int(C[j - 1, i])
            C[j, i] = c % 2**32
    return int(C[N - 1, M - 1])


@pytest.mark.parametrize("s1,s2,m,k,d", CASES)
def test_score_count_matches_naive(s1, s2, m, k, d):
    """The O(N)-memory fused score + count pass == the full-table DP."""
    from nw_tpu.ops.fill_scan import fill_score_count

    H, Ar = naive_nw(s1, s2, m, k, d)
    sc, cnt = fill_score_count(encode(s1), encode(s2), m, k, d)
    assert int(sc) == H[-1, -1]
    assert int(cnt) == naive_count(Ar)


@pytest.mark.parametrize("L1,L2", [(23, 17), (1, 40), (40, 1), (31, 31)])
def test_score_count_padded_matches_count_paths(L1, L2):
    """Bucket-padded inputs with true lengths, tie-dense alphabet: the
    fused pass equals fill_diag + count_paths on the unpadded pair."""
    from nw_tpu.ops import pathcount
    from nw_tpu.ops.fill_scan import fill_score_count

    rng = np.random.default_rng(L1 * 100 + L2)
    s1 = "".join(rng.choice(list("AC"), L1))
    s2 = "".join(rng.choice(list("AC"), L2))
    top, side, _, _ = encode_pair(s1, s2, 48, 48)
    sc, cnt = fill_score_count(top, side, 1, 1, 1, L1, L2)
    ref = fill_diag(encode(s1), encode(s2), 1, 1, 1)
    assert int(sc) == int(ref["score"])
    assert int(cnt) == int(pathcount.count_paths(ref["arrows"], L1, L2))


def test_summary_huge_matches_align():
    from nw_tpu.models.needleman_wunsch import NWAligner

    al = NWAligner(match=1, mismatch=1, indel=1)
    for s1, s2 in [("GCATGCU", "GATTACA"), ("", ""), ("", "AC"), ("A" * 30, "A" * 28)]:
        full = al.align(s1, s2)
        assert al.summary_huge(s1, s2) == (full.score, full.solution_count % 2**32)
