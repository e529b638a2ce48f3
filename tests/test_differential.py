"""Differential tests: byte-exact stdout AND stderr vs the reference C
binary (SURVEY.md §4.3 item 1).  Skipped when no reference build exists;
golden tests in test_cli.py cover the same surface standalone."""

import numpy as np
import pytest

from tests.conftest import run_ours, run_ref

# (args, stdin) cases — chosen to exercise flags, quirks, and edge cases.
CASES = [
    (["1", "1", "1"], b"GT GT"),
    (["1", "1", "1"], b"GT GA"),
    (["-l", "1", "1", "1"], b"GT GA"),
    (["1", "1", "1"], b"GAT GTA"),
    (["-s", "1", "1", "1"], b"GCATGCU GATTACA"),
    (["-q", "-s", "1", "1", "1"], b"GCATGCU GATTACA"),
    (["-q", "-l", "1", "1", "1"], b"GAT GTA"),
    (["-s", "-l", "-t", "1", "1", "1"], b"GCATGCU GATTACA"),
    (["-q", "-s", "-t", "1", "1", "1"], b"GCATGCU GATTACA"),
    (["-q", "-t", "-u", "1", "1", "1"], b"GCATGCU GATTACA"),
    (["-c", "-s", "-l", "-t", "1", "1", "1"], b"GCATGCU GATTACA"),
    (["-c", "-t", "-u", "-q", "1", "1", "1"], b"GAT GTA"),
    (["-c", "1", "1", "1"], b"GT GA"),
    (["x", "y", "z"], b"GT GA"),  # atoi garbage -> 0 0 0, tie explosion
    (["-s", "x", "y", "z"], b"GT GA"),
    (["-s", "--", "-1", "1", "1"], b"GT GA"),  # negative operand after --
    (["-s", "--", "1", "1", "-2"], b"GT GA"),  # negative gap penalty
    (["-s", "0", "5", "2"], b"AAAA AAAA"),
    (["-s", "-t", "3", "2", "1"], b"TTCATA TGCTCGTA"),
    (["-s", "1", "1", "1"], b" GT GA"),  # empty first sequence
    (["-s", "1", "1", "1"], b"G\nGATTACA\n"),  # newline separator
    (["-s", "1", "1", "1"], b"AB\tCD\textra ignored"),  # tab sep, extra input
    (["-p", "4", "-s", "1", "1", "1"], b"GCATGCU GATTACA"),  # threads accepted
    (["1", "1", "1", "-s"], b"GT GT"),  # glibc operand permutation
    # error paths
    ([], b""),
    (["1", "1"], b""),
    (["1", "1", "1", "1"], b""),
    (["-h"], b""),
    (["-p", "1", "1", "1", "1"], b"GT GT"),
    (["-p", "x", "1", "1", "1"], b"GT GT"),
    (["-f", "/nonexistent-nw-file", "1", "1", "1"], b""),
    (["1", "1", "1"], b"GT"),
    (["1", "1", "1"], b"GT "),
    (["1", "1", "1"], b""),
    (["-z", "1", "1", "1"], b""),
]


CASES += [
    # arbitrary non-whitespace bytes are valid sequence characters
    (["-s", "1", "1", "1"], b"a+b/c a-b*c"),
    (["-l", "2", "1", "1"], b"Hello! hello?"),
    (["-s", "-l", "1", "2", "3"], b"12345 54321"),
    (["-c", "-t", "1", "1", "1"], b"A.B A,B"),
    (["-s", "1", "1", "1"], bytes([200, 201, 202]) + b" " + bytes([200, 202])),
    # extreme / degenerate params
    (["-s", "--", "-3", "-2", "-1"], b"ACGT TGCA"),
    (["-s", "1000000", "1000000", "1000000"], b"ACGT ACG"),
    (["-q", "-s", "--", "0", "0", "-1"], b"AC GT"),  # gap reward
]


@pytest.mark.parametrize("args,stdin", CASES, ids=[str(i) for i in range(len(CASES))])
def test_differential(reference_binary, args, stdin):
    rc_ref, out_ref, err_ref = run_ref(reference_binary, args, stdin)
    rc_our, out_our, err_our = run_ours(args, stdin)
    # normalize prog name in stderr (binary path vs our argv[0])
    import os

    ref_prog = os.path.basename(reference_binary).encode()
    err_ref_n = err_ref.replace(reference_binary.encode(), b"needleman-wunsch").replace(
        ref_prog, b"needleman-wunsch"
    )
    assert out_our == out_ref, f"stdout mismatch for {args} {stdin!r}"
    assert err_our == err_ref_n, f"stderr mismatch for {args} {stdin!r}"
    assert rc_our == rc_ref, f"exit code mismatch for {args} {stdin!r}"


def test_differential_random_small(reference_binary):
    """Randomized fuzzing over small pairs and scoring params
    (fixed shapes to bound jit compiles)."""
    rng = np.random.default_rng(42)
    for trial in range(20):
        s1 = "".join(rng.choice(list("ACGT"), 8))
        s2 = "".join(rng.choice(list("ACGT"), 6))
        m, k, d = (str(int(x)) for x in rng.integers(0, 4, 3))
        args = ["-s", "-l", m, k, d]
        stdin = f"{s1} {s2}".encode()
        rc_ref, out_ref, err_ref = run_ref(reference_binary, args, stdin)
        rc_our, out_our, err_our = run_ours(args, stdin)
        assert out_our == out_ref, (s1, s2, m, k, d)
        assert err_our == err_ref.replace(b"./needleman-wunsch", b"needleman-wunsch"), (s1, s2, m, k, d)


def test_differential_table_random(reference_binary):
    """Random tables with -t -c -u: full renderer parity."""
    rng = np.random.default_rng(43)
    for trial in range(8):
        s1 = "".join(rng.choice(list("ACGT"), 5))
        s2 = "".join(rng.choice(list("ACGT"), 5))
        m, k, d = (str(int(x)) for x in rng.integers(0, 3, 3))
        args = ["-c", "-t", "-u", "-s", m, k, d]
        stdin = f"{s1} {s2}".encode()
        rc_ref, out_ref, err_ref = run_ref(reference_binary, args, stdin)
        rc_our, out_our, err_our = run_ours(args, stdin)
        assert out_our == out_ref, (s1, s2, m, k, d)


def test_differential_random_bytes(reference_binary):
    """Random printable-byte alphabets + negative params (fixed shapes)."""
    rng = np.random.default_rng(44)
    alphabet = [c for c in range(33, 127)]  # non-whitespace printable
    for trial in range(12):
        s1 = bytes(rng.choice(alphabet, 7).astype("u1").tolist())
        s2 = bytes(rng.choice(alphabet, 5).astype("u1").tolist())
        m, k, d = (str(int(x)) for x in rng.integers(-3, 4, 3))
        args = ["-s", "-l", "--", m, k, d]
        stdin = s1 + b" " + s2
        rc_ref, out_ref, err_ref = run_ref(reference_binary, args, stdin)
        rc_our, out_our, err_our = run_ours(args, stdin)
        assert out_our == out_ref, (s1, s2, m, k, d)
        assert err_our == err_ref.replace(
            b"./needleman-wunsch", b"needleman-wunsch"
        ), (s1, s2, m, k, d)


def test_differential_real_subprocess(reference_binary, tmp_path):
    """Raw-fd parity: run our CLI as an actual subprocess (C++-level
    stderr included — the in-process harness can't see it; jax/XLA
    library logging once leaked here)."""
    import os
    import subprocess
    import sys

    env = dict(
        os.environ,
        NW_TPU_PLATFORM="cpu",
        PYTHONPATH=os.getcwd(),
        HOME=str(tmp_path),  # isolate the CLI's default compile cache
    )
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    code = (
        "import sys; from nw_tpu.cli import console_main; "
        "sys.argv = ['needleman-wunsch'] + sys.argv[1:]; console_main()"
    )
    # same case twice: cold (compiles + writes cache) and warm (loads
    # cached AOT executables — the path that once spewed loader errors)
    for args, stdin in [
        (["-s", "1", "1", "1"], b"GCATGCU GATTACA"),
        (["-s", "1", "1", "1"], b"GCATGCU GATTACA"),
        (["-l", "2", "1", "1"], b"GT GA"),
    ]:
        ref = subprocess.run([reference_binary] + args, input=stdin, capture_output=True)
        ours = subprocess.run(
            [sys.executable, "-c", code] + args,
            input=stdin, capture_output=True, env=env, timeout=600,
        )
        assert ours.stdout == ref.stdout, (args, ours.stdout, ref.stdout)
        assert ours.stderr == ref.stderr, (args, ours.stderr[:500], ref.stderr)
        assert ours.returncode == ref.returncode


def _run_ref_guarded(reference_binary, args, stdin, timeout=10):
    """Run the reference with a hard timeout, returning None when it
    explodes (the DFS enumerates ALL optimal alignments whenever it
    prints, needleman-wunsch.c:667; degenerate params make that set
    astronomical).  The guard is REFERENCE-side — a pre-count with our
    own engine would skip exactly the cases where an under-reporting
    count bug hides (VERDICT r2 weak 6)."""
    import subprocess

    try:
        r = subprocess.run(
            [reference_binary, *args], input=stdin, capture_output=True,
            timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        return None
    return r.returncode, r.stdout, r.stderr


def _diff_one(reference_binary, args, stdin, timeout=10):
    """One guarded differential case; returns False if skipped."""
    import os

    ref = _run_ref_guarded(reference_binary, args, stdin, timeout)
    if ref is None:
        return False
    rc_ref, out_ref, err_ref = ref
    rc, out, err = run_ours(args, stdin)
    err_ref = err_ref.replace(
        reference_binary.encode(), b"needleman-wunsch"
    ).replace(
        os.path.basename(reference_binary).encode(), b"needleman-wunsch"
    )
    assert out == out_ref, (args, stdin[:80], out[:200], out_ref[:200])
    assert err == err_ref, (args, stdin[:80], err[:200], err_ref[:200])
    assert rc == rc_ref, (args, stdin[:80])
    return True


def test_mixed_flag_campaign(reference_binary):
    """The randomized mixed-flag campaign, in the gate (VERDICT r1
    item 5): seed-pinned cases over every flag combination class,
    ACGT + full printable-byte alphabets, params in [-3, 4], lengths up
    to 20 — byte-compared on stdout, stderr, and exit code.  Explosive
    cases are dropped by a reference-side timeout, not by pre-counting
    with our own engine."""
    import random

    rng = random.Random(20260816)
    full_alpha = [chr(c) for c in range(33, 127)]
    ran = 0
    for trial in range(220):
        lens = rng.choice([(4, 3), (8, 6), (8, 8), (12, 5), (20, 14), (1, 20)])
        alpha = "ACGT" if trial % 3 else full_alpha
        s1 = "".join(rng.choice(alpha) for _ in range(lens[0]))
        s2 = "".join(rng.choice(alpha) for _ in range(lens[1]))
        params = [str(rng.randint(-3, 4)) for _ in range(3)]
        flags = [
            f for f in ("-c", "-l", "-q", "-s", "-t", "-u") if rng.random() < 0.35
        ]
        if rng.random() < 0.15:
            flags += ["-p", str(rng.randint(2, 8))]
        args = flags + ["--"] + params
        stdin = f"{s1} {s2}".encode()
        ran += _diff_one(reference_binary, args, stdin)
    assert ran >= 150  # the timeout guard must not hollow out the campaign


def test_differential_long_reads(reference_binary):
    """50-200 bp differential cases (VERDICT r2 weak 6: fuzz lengths
    capped at 20).  s2 is s1 with a few point edits so the optimal-
    alignment set stays printable; params vary so ties still occur."""
    import random

    rng = random.Random(20260817)
    for L, nmut, flags in [
        (50, 3, ["-s"]),
        (80, 5, ["-l"]),
        (120, 4, ["-q", "-s"]),
        (200, 6, ["-s", "-l"]),
        (64, 2, ["-c"]),
        (100, 8, ["-q", "-s"]),
    ]:
        s1 = "".join(rng.choice("ACGT") for _ in range(L))
        s2l = list(s1)
        for _ in range(nmut):
            p = rng.randrange(L)
            s2l[p] = rng.choice("ACGT")
        if nmut % 2:
            del s2l[rng.randrange(len(s2l))]  # an indel too
        s2 = "".join(s2l)
        params = [str(rng.randint(1, 3)) for _ in range(3)]
        args = flags + ["--"] + params
        assert _diff_one(
            reference_binary, args, f"{s1} {s2}".encode(), timeout=30
        )


def test_differential_table_render_long(reference_binary):
    """Table rendering (-t, with -c/-u coloring) at 30-120 bp —
    fuzz render cases cap at 20 bp, so column widths > 1 digit, long
    top strings, and long colored optimal paths were untested.  Pairs
    are near-identical (1-3 mutations) so the reference's exponential
    path-marking DFS terminates; tie-dense cases are dropped by the
    reference-side timeout, and at least 4 must complete."""
    import random

    rng = random.Random(177)
    done = 0
    for _ in range(30):
        if done >= 6:
            break
        L1 = rng.randint(30, 120)
        L2 = max(4, L1 + rng.randint(-8, 8))
        s1 = "".join(rng.choice("ACGT") for _ in range(L1))
        s2l = list(
            s1[:L2] if L2 <= L1
            else s1 + "".join(rng.choice("ACGT") for _ in range(L2 - L1))
        )
        for _ in range(rng.randint(1, 3)):
            s2l[rng.randrange(len(s2l))] = rng.choice("ACGT")
        flags = rng.choice(
            [
                ["-t", "-s", "-q"], ["-t", "-c", "-q"],
                ["-t", "-u", "-q"], ["-t", "-c", "-u", "-s", "-q"],
            ]
        )
        params = [str(rng.randint(1, 3)) for _ in range(3)]
        stdin = f"{s1} {''.join(s2l)}".encode()
        done += _diff_one(
            reference_binary, flags + params, stdin, timeout=45
        )
    assert done >= 4


def test_differential_file_input(reference_binary, tmp_path):
    """-f sequence-file cases (untested differentially before —
    VERDICT r2 weak 6): both binaries read the same file."""
    cases = [
        (b"GCATGCU GATTACA\n", ["-s", "1", "1", "1"]),
        (b"GT\tGA", ["-l", "2", "1", "1"]),
        (b"G\nGATTACA\n", ["-s", "1", "1", "1"]),
        (b"GT", ["-s", "1", "1", "1"]),  # early EOF from a file
    ]
    for i, (content, flags) in enumerate(cases):
        p = tmp_path / f"seq{i}.txt"
        p.write_bytes(content)
        assert _diff_one(reference_binary, ["-f", str(p)] + flags, b"")


def test_differential_file_errors(reference_binary, tmp_path):
    """-f pathological targets: fopen("r") SUCCEEDS on a directory
    (needleman-wunsch.c:776-777) and the failure surfaces at the first
    fgetc as "fgetc failed: Is a directory" (ferror is checked before
    feof, read-sequences.c:46-55); an empty file is the early-EOF case;
    a missing file fails at open."""
    d = tmp_path / "a_directory"
    d.mkdir()
    empty = tmp_path / "empty.txt"
    empty.write_bytes(b"")
    for target in [str(d), str(empty), str(tmp_path / "does-not-exist")]:
        assert _diff_one(reference_binary, ["-f", target, "-s", "1", "1", "1"], b"")


def test_differential_atoi_overflow(reference_binary):
    """atoi overflow wraps mod 2^32 (glibc (int)strtol truncation):
    -p -99999999999999 -> num-threads == -276447231 in the error text
    (needleman-wunsch.c:738-741); an operand of 4294967297 scores as 1
    (:783-785).  The positive -p overflow is NOT tested: the reference
    then really spawns threads until pthread_create fails, which is
    resource-dependent."""
    assert _diff_one(
        reference_binary, ["-p", "-99999999999999", "-s", "1", "1", "1"], b"GT GA\n"
    )
    assert _diff_one(reference_binary, ["-s", "4294967297", "1", "1"], b"GT GA\n")
    assert _diff_one(reference_binary, ["-s", "1", "-4294967295", "1"], b"GT GA\n")


def test_differential_crlf_and_nul(reference_binary):
    """CRLF separators and embedded NUL bytes (VERDICT r2 weak 6).
    \\r is isspace so CRLF delimits like any whitespace; a NUL is read
    into the buffer but the reference computes with strlen
    (computation.c:158-160), so it truncates the sequence."""
    cases = [
        (["-s", "1", "1", "1"], b"GT\r\nGA\r\n"),
        (["-s", "1", "1", "1"], b"GCATGCU\r\nGATTACA"),
        (["-s", "-l", "1", "1", "1"], b"G\x00T GA"),
        (["-s", "1", "1", "1"], b"GT G\x00ATTACA"),
        (["-q", "-s", "1", "1", "1"], b"\x00GT GA"),  # len-0 first seq
        (["-s", "-t", "1", "1", "1"], b"A\x00B\tC\x00"),
    ]
    for args, stdin in cases:
        assert _diff_one(reference_binary, args, stdin)


def test_debug_build_parity(reference_debug_binary, monkeypatch):
    """NW_TPU_DEBUG=1 reproduces the reference DEBUG build's stderr
    traces (dbg.h:53-57) byte-for-byte, including the walk-table
    branch-count print (needleman-wunsch.c:624-625) and the threaded
    spawn/join lines (VERDICT r1 item 8).  Program-name prefixes are
    normalized (each build embeds its own argv[0])."""
    import re

    monkeypatch.setenv("NW_TPU_DEBUG", "1")
    norm = lambda b: re.sub(rb"(?m)^[^ ]*: debug:", b"X: debug:", b)
    cases = [
        (["-s", "1", "1", "1"], b"GCATGCU GATTACA"),
        (["-l", "2", "1", "1"], b"GT GA"),
        (["-q", "-s", "1", "1", "1"], b"GAT GTA"),
        (["-p", "4", "-s", "1", "1", "1"], b"GCATGCU GATTACA"),
        (["-q", "1", "1", "1"], b"A B"),
        (["-q", "-s", "-t", "0", "0", "0"], b"GT GA"),
    ]
    for args, stdin in cases:
        rc_ref, out_ref, err_ref = run_ref(reference_debug_binary, args, stdin)
        rc, out, err = run_ours(args, stdin)
        assert out == out_ref, (args, out, out_ref)
        assert norm(err) == norm(err_ref), (args, err, err_ref)
        assert rc == rc_ref


# ---- batch-API differential: align_batch vs the reference binary ----
# The CLI differentials above exercise the single-pair engines; the
# BATCH engines (the production route for real workloads — the row-sweep
# kernel on the GPU, the scan oracles here on CPU) were only
# transitively covered.  This drives nw_tpu.models.align_batch directly
# against per-pair reference runs: score + solution count (-q -s) and
# the first-emitted alignment (the reference DFS's first block).

def _ref_summary(reference_binary, s1, s2, m, k, d):
    """(score, count) from the reference's -q -s stderr summary."""
    import re

    rc, out, err = run_ref(
        reference_binary, ["-q", "-s", str(m), str(k), str(d)],
        f"{s1} {s2}".encode(),
    )
    assert rc == 0, err
    cm = re.search(rb"(\d+) optimal alignment", err)
    sm = re.search(rb"Optimal score is (-?\d+)", err)
    return int(sm.group(1)), int(cm.group(1))


def _ref_first_alignment(reference_binary, s1, s2, m, k, d):
    rc, out, err = run_ref(
        reference_binary, [str(m), str(k), str(d)], f"{s1} {s2}".encode()
    )
    assert rc == 0, err
    lines = out.split(b"\n")
    return lines[0], lines[1]


def batch_vs_reference(reference_binary, pairs, m, k, d, first_cap=32):
    """Shared driver of the batch-API differential cases."""
    from nw_tpu.models.needleman_wunsch import align_batch

    res = align_batch(pairs, m, k, d, traceback_strings=True, count=True)
    strs = res.alignment_strings()
    for b, (s1, s2) in enumerate(pairs):
        score, count = _ref_summary(reference_binary, s1, s2, m, k, d)
        assert res.scores[b] == score, (b, s1, s2, res.scores[b], score)
        assert int(res.counts[b]) == count % 2**32, (
            b, s1, s2, int(res.counts[b]), count)
        if 1 <= count <= first_cap:
            x, y = _ref_first_alignment(reference_binary, s1, s2, m, k, d)
            assert strs[b] == (x, y), (b, s1, s2, strs[b], (x, y))


def test_differential_batch_api(reference_binary):
    rng = np.random.default_rng(91)
    for m, k, d in [(1, 1, 1), (2, 1, 1), (3, 2, 2)]:
        pairs = []
        # min length 1: an empty sequence cannot round-trip through the
        # reference's whitespace-delimited stdin
        for _ in range(14):
            l1, l2 = int(rng.integers(1, 27)), int(rng.integers(1, 27))
            pairs.append((
                "".join(rng.choice(list("ACGT"), l1)),
                "".join(rng.choice(list("ACGT"), l2)),
            ))
        batch_vs_reference(reference_binary, pairs, m, k, d)
