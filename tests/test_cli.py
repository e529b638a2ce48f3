"""CLI golden tests — expected bytes captured from the reference binary
(verified build, SURVEY.md §4.2), inlined so they run with no reference
checkout present."""

import pytest

from tests.conftest import run_ours
from tests.golden import (
    GT_GA_COUNTS,
    README_ALIGNMENTS,
    README_INPUT,
    README_SUMMARY,
    README_TABLE,
)


def test_basic_gt_gt():
    rc, out, err = run_ours(["1", "1", "1"], b"GT GT")
    assert rc == 0
    assert out == b"GT\nGT\n\n"
    assert err == b""


def test_counts_line():
    rc, out, err = run_ours(["-l", "1", "1", "1"], b"GT GA")
    assert out == GT_GA_COUNTS


def test_multiple_alignments_order():
    rc, out, err = run_ours(["1", "1", "1"], b"GAT GTA")
    assert out == b"G-AT\nGTA-\n\nGAT-\nG-TA\n\n"


def test_readme_example_summary_to_stderr():
    rc, out, err = run_ours(["-s", "1", "1", "1"], README_INPUT)
    assert out == README_ALIGNMENTS
    assert err == README_SUMMARY


def test_quiet_summary_only():
    rc, out, err = run_ours(["-q", "-s", "1", "1", "1"], b"GCATGCU GATTACA")
    assert out == b""
    assert err == b"3 optimal alignments\nOptimal score is 0\n"


def test_quiet_no_flags_no_output():
    rc, out, err = run_ours(["-q", "1", "1", "1"], b"GCATGCU GATTACA")
    assert rc == 0 and out == b"" and err == b""


def test_singular_pluralization():
    rc, out, err = run_ours(["-q", "-s", "1", "1", "1"], b"GT GT")
    assert err == b"1 optimal alignment\nOptimal score is 2\n"


def test_table_ascii():
    rc, out, err = run_ours(["-q", "-s", "-t", "1", "1", "1"], b"GCATGCU GATTACA")
    expected = README_TABLE
    assert out == expected
    assert err == b"3 optimal alignments\nOptimal score is 0\n"


def test_atoi_garbage_operands():
    rc, out, err = run_ours(["-q", "-s", "x", "y", "z"], b"GT GA")
    assert err == b"13 optimal alignments\nOptimal score is 0\n"


def test_usage_exits_1():
    rc, out, err = run_ours(["-h", "1", "1", "1"], b"")
    assert rc == 1
    assert err.startswith(b"usage: needleman-wunsch")
    assert out == b""


def test_operand_count_errors():
    rc, out, err = run_ours([], b"")
    assert rc == 1
    assert err.startswith(
        b"needleman-wunsch: error: expected 3 operands but received 0: \x08\x08 \x08\n"
    )
    rc, out, err = run_ours(["1", "1"], b"")
    assert b"received only 2" in err
    rc, out, err = run_ours(["1", "1", "1", "1", "1"], b"")
    assert b"received 5" in err and b"only 5" not in err


def test_p_flag_validation():
    rc, out, err = run_ours(["-p", "1", "1", "1", "1"], b"GT GT")
    assert rc == 1
    assert err == (
        b"needleman-wunsch: error: num-threads == 1; num-threads "
        b"must be greater than 1: \x08\x08 \x08\n"
    )
    rc, out, err = run_ours(["-p", "4", "1", "1", "1"], b"GT GT")
    assert rc == 0 and out == b"GT\nGT\n\n"


def test_eof_too_early():
    rc, out, err = run_ours(["1", "1", "1"], b"GT")
    assert rc == 1
    assert err == (
        b"needleman-wunsch: error: got EOF too early when reading input "
        b"strings: \x08\x08 \x08\n"
    )


def test_bad_file():
    rc, out, err = run_ours(["-f", "/nonexistent-nw", "1", "1", "1"], b"")
    assert rc == 1
    assert err == (
        b"needleman-wunsch: error: failed to open /nonexistent-nw: "
        b"No such file or directory\n"
    )


def test_invalid_option_glibc_message():
    rc, out, err = run_ours(["-z", "1", "1", "1"], b"")
    assert rc == 1
    assert err.startswith(b"needleman-wunsch: invalid option -- 'z'\n")


def test_color_output():
    rc, out, err = run_ours(["-c", "1", "1", "1"], b"GT GA")
    # G match (empty fmt + reset), T mismatch (red;bold + reset)
    assert out == (
        b"G\x1b[0m\x1b[31;1mT\x1b[0m\n"
        b"G\x1b[0m\x1b[31;1mA\x1b[0m\n\n"
    )


def test_unicode_table():
    rc, out, err = run_ours(["-q", "-t", "-u", "1", "1", "1"], b"GT GT")
    text = out.decode("utf-8")
    assert "↖" in text and "←" in text and "↑" in text


def test_empty_first_sequence():
    rc, out, err = run_ours(["-s", "1", "1", "1"], b" GT GA")
    assert out == b"--\nGT\n\n"
    assert err == b"1 optimal alignment\nOptimal score is -2\n"


def test_huge_path_byte_identical(monkeypatch):
    """Forcing the huge-pair fused-kernel path (-q/-q -s) produces the
    same bytes as the full-table path."""
    cases = [
        (["-q", "-s", "1", "1", "1"], b"GCATGCU GATTACA"),
        (["-q", "-s", "2", "1", "1"], b"GATTACA GCATGCU"),
        (["-q", "1", "1", "1"], b"GT GA"),
        (["-q", "-s", "0", "0", "0"], b"GT GA"),
    ]
    normal = [run_ours(a, s) for a, s in cases]
    monkeypatch.setenv("NW_TPU_HUGE_CELLS", "1")
    forced = [run_ours(a, s) for a, s in cases]
    assert normal == forced


def test_count_beyond_reference_reach_delannoy():
    """-q -s 0 0 0 on all-'A' strings: every monotone path is optimal,
    so the solution count is the Delannoy number D(24,16) mod 2^32
    (printed with %d).  The reference computes this count by full
    enumeration — 8.5e13 paths, hours of CPU (it times out in testing);
    the O(M*N) count DP answers instantly with the identical wrapped
    value, verified here against the closed form."""
    from functools import lru_cache

    @lru_cache(None)
    def delannoy(m, n):
        if m == 0 or n == 0:
            return 1
        return delannoy(m - 1, n) + delannoy(m, n - 1) + delannoy(m - 1, n - 1)

    d = delannoy(24, 16) % 2**32
    signed = d - 2**32 if d >= 2**31 else d
    rc, out, err = run_ours(["-q", "-s", "0", "0", "0"], b"A" * 24 + b" " + b"A" * 16)
    assert rc == 0 and out == b""
    assert err == (
        b"%d optimal alignments\nOptimal score is 0\n" % signed
    )
