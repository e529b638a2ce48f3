"""NWAligner library-surface tests (single pair + batched paths)."""

import numpy as np
import pytest

from nw_tpu import AlignConfig, NWAligner, ScoringParams, align, align_batch


def test_align_single_readme_case():
    r = align("GCATGCU", "GATTACA", 1, 1, 1)
    assert r.score == 0
    assert r.solution_count == 3
    assert [
        (x.decode(), y.decode()) for x, y in r.alignments()
    ] == [
        ("GCA-TGCU", "G-ATTACA"),
        ("GCAT-GCU", "G-ATTACA"),
        ("GCATG-CU", "G-ATTACA"),
    ]
    assert r.best_alignment() == (b"GCA-TGCU", b"G-ATTACA")


def test_align_batch_traceback_and_counts():
    rng = np.random.default_rng(0)
    pairs = [
        (
            "".join(rng.choice(list("ACGT"), int(rng.integers(3, 14)))),
            "".join(rng.choice(list("ACGT"), int(rng.integers(3, 14)))),
        )
        for _ in range(9)
    ]
    res = align_batch(pairs, 1, 1, 1, traceback_strings=True, count=True)
    aligner = NWAligner(AlignConfig(scoring=ScoringParams(1, 1, 1)))
    strings = res.alignment_strings()
    for b, (s1, s2) in enumerate(pairs):
        single = aligner.align(s1, s2)
        assert res.scores[b] == single.score
        assert res.counts[b] == single.solution_count
        assert strings[b] == single.best_alignment()


def test_align_batch_scores_only():
    pairs = [("GT", "GT"), ("GT", "GA"), ("GCATGCU", "GATTACA")]
    res = align_batch(pairs, 1, 1, 1)
    assert list(res.scores) == [2, 0, 0]


def test_empty_pair_library_semantics():
    r = align("", "", 1, 1, 1)
    assert r.score == 0 and r.solution_count == 0
    assert list(r.alignments()) == []


def test_align_batch_small_huge_pairs_route(monkeypatch):
    """Pairs beyond HUGE_PAIR_MIN_SIDE run one at a time through the
    O(N)-memory huge-pair routes (a 100 kb pair's uint8 arrows alone
    are ~20 GB).  Shrunk threshold: results must equal the normal batch
    route bit-for-bit."""
    import numpy as np

    import nw_tpu.ops.fill_auto as fa
    from nw_tpu.models.needleman_wunsch import NWAligner

    rng = np.random.default_rng(44)
    pairs = [
        (
            "".join(rng.choice(list("ACGT"), 60)),
            "".join(rng.choice(list("ACGT"), int(n))),
        )
        for n in (55, 64, 40)
    ]
    al = NWAligner(match=2, mismatch=1, indel=1)
    want = al.align_batch(pairs, traceback_strings=True, count=True)
    monkeypatch.setattr(fa, "HUGE_PAIR_MIN_SIDE", 32)
    got = al.align_batch(pairs, traceback_strings=True, count=True)
    np.testing.assert_array_equal(want.scores, got.scores)
    np.testing.assert_array_equal(want.counts, got.counts)
    assert want.alignment_strings() == got.alignment_strings()
    # strings-only (no counts): the route derives scores itself
    got2 = al.align_batch(pairs, traceback_strings=True)
    np.testing.assert_array_equal(got2.scores, want.scores)
    assert got2.alignment_strings() == want.alignment_strings()


def test_align_batch_auto_chunking(monkeypatch):
    """Memory-aware auto-split produces identical results to one batch."""
    import numpy as np

    import nw_tpu.ops.fill_auto as fa
    from nw_tpu.models.needleman_wunsch import NWAligner

    rng = np.random.default_rng(33)
    pairs = [
        (
            "".join(rng.choice(list("ACGT"), int(rng.integers(1, 25)))),
            "".join(rng.choice(list("ACGT"), int(rng.integers(1, 25)))),
        )
        for _ in range(17)
    ]
    al = NWAligner(match=2, mismatch=1, indel=1)
    whole = al.align_batch(pairs, traceback_strings=True, count=True)
    # force ~3-pair chunks
    monkeypatch.setattr(fa, "arrow_budget_bytes", lambda: 3 * (64 + 64 + 1) * 65)
    split = al.align_batch(pairs, traceback_strings=True, count=True)
    np.testing.assert_array_equal(whole.scores, split.scores)
    np.testing.assert_array_equal(whole.counts, split.counts)
    assert whole.alignment_strings() == split.alignment_strings()


@pytest.mark.parametrize(
    "strings,count", [(False, False), (False, True), (True, False), (True, True)]
)
def test_align_batch_empty_and_one_sided_pairs(strings, count):
    """Empty and one-sided pairs in a ragged batch, every mode: scores,
    counts (1 for a both-empty pair in a batch, like count_paths) and
    strings equal the single-pair engine."""
    pairs = [("", ""), ("", "ACG"), ("GT", ""), ("A", "A"), ("GATTACA", "GCATGCU")]
    al = NWAligner(match=2, mismatch=1, indel=1)
    r = al.align_batch(pairs, traceback_strings=strings, count=count)
    for i, (a, b) in enumerate(pairs):
        one = al.align(a, b)
        assert r.scores[i] == one.score
        if count:
            assert r.counts[i] == (one.solution_count if (a or b) else 1)
    if strings:
        got = r.alignment_strings()
        for i, (a, b) in enumerate(pairs):
            assert got[i] == al.align(a, b).best_alignment()
