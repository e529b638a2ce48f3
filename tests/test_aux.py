"""Auxiliary subsystems: metrics, branch counting, failure isolation,
checkpoint/resume (SURVEY.md §5)."""

import numpy as np
import pytest

from nw_tpu import align_batch
from nw_tpu.ops.encode import encode
from nw_tpu.ops.fill_scan import fill_diag
from nw_tpu.ops.pathcount import count_branches
from nw_tpu.runtime.checkpoint import CheckpointedRunner
from nw_tpu.utils.metrics import RunReport, timed


def test_branch_count_matches_naive():
    rng = np.random.default_rng(0)
    for _ in range(8):
        s1 = "".join(rng.choice(list("AC"), 9))
        s2 = "".join(rng.choice(list("AC"), 8))
        m, k, d = (int(x) for x in rng.integers(0, 3, 3))
        out = fill_diag(encode(s1), encode(s2), m, k, d)
        from nw_tpu.ops.fill_scan import diag_to_matrix

        arr = diag_to_matrix(np.asarray(out["arrows"]), len(s1), len(s2))
        bits = (arr & 1) + ((arr >> 1) & 1) + ((arr >> 2) & 1)
        expected = int((bits[1:, 1:] > 1).sum())
        got = int(count_branches(out["arrows"], len(s1), len(s2)))
        assert got == expected, (s1, s2, m, k, d)


def test_failure_isolation_masks_oversized():
    pairs = [("GT", "GT"), ("A" * 50, "GT"), ("GT", "GA")]
    with pytest.raises(ValueError):
        align_batch(pairs, 1, 1, 1, max_length=10)
    res = align_batch(pairs, 1, 1, 1, max_length=10, on_error="mask")
    assert list(res.status) == [0, 1, 0]
    assert res.scores[0] == 2 and res.scores[2] == 0


def test_run_report():
    r = RunReport(pairs=4, cells=1000)
    with timed(r, "fill"):
        pass
    with timed(r, "walk"):
        pass
    r.solution_count = 1
    s = r.summary()
    assert "1 optimal alignment" in s and "4 pairs" in s and "GCUPS" in s


def test_checkpoint_resume(tmp_path):
    pairs = [(f"ACGT{i}".encode(), b"ACGTA") for i in range(10)]
    calls = []

    def chunk_fn(chunk):
        calls.append(len(chunk))
        return {"scores": np.arange(len(chunk), dtype=np.int32)}

    runner = CheckpointedRunner(str(tmp_path / "ckpt"), chunk_size=3)
    out = runner.run(pairs, chunk_fn)
    assert out["scores"].shape == (10,)
    assert len(calls) == 4  # 3+3+3+1

    # resume: nothing recomputed
    calls.clear()
    out2 = runner.run(pairs, chunk_fn)
    assert len(calls) == 0
    np.testing.assert_array_equal(out["scores"], out2["scores"])

    # partial: delete one chunk, only it is recomputed
    (tmp_path / "ckpt" / "chunk_00002.npz").unlink()
    calls.clear()
    runner.run(pairs, chunk_fn)
    assert calls == [3]

    # shape mismatch is rejected
    with pytest.raises(ValueError):
        CheckpointedRunner(str(tmp_path / "ckpt"), chunk_size=5).run(
            pairs, chunk_fn
        )


def test_native_renderer_matches_python():
    native = pytest.importorskip("nw_tpu.runtime.native")
    rt = native.load()
    if rt is None:
        pytest.skip("native runtime unavailable")
    from nw_tpu.ops.fill_scan import diag_to_matrix, fill_diag
    from nw_tpu.ops.pathcount import mark_optimal_cells
    from nw_tpu.utils.render import render_table_py

    rng = np.random.default_rng(7)
    for _ in range(6):
        s1 = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 9))))
        s2 = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 9))))
        m, k, d = (int(x) for x in rng.integers(0, 3, 3))
        out = fill_diag(encode(s1), encode(s2), m, k, d, with_scores=True)
        sc = diag_to_matrix(np.asarray(out["scores"]), len(s1), len(s2))
        ar = diag_to_matrix(np.asarray(out["arrows"]), len(s1), len(s2))
        marks = diag_to_matrix(
            np.asarray(mark_optimal_cells(out["arrows"], len(s1), len(s2))),
            len(s1),
            len(s2),
        ).astype(bool)
        for uni in (False, True):
            for col in (False, True):
                py = render_table_py(sc, ar, marks, s1.encode(), s2.encode(), uni, col)
                cc = rt.render_table(sc, ar, marks, s1.encode(), s2.encode(), uni, col)
                assert py == cc, (s1, s2, m, k, d, uni, col)


def test_native_reader_equivalence(tmp_path):
    """Native C++ reader == Python reader on fd-backed streams."""
    import io

    from nw_tpu.runtime import native
    from nw_tpu.utils.textio import EarlyEOFError, read_two_sequences

    rt = native.load()
    if rt is None:
        import pytest

        pytest.skip("native runtime unavailable")

    cases = [
        b"GT GA",
        b"  GT \t\n GA  trailing ignored",
        b"G\nGATTACA\n",
        b" AB CD",            # empty first sequence
        bytes([200, 201]) + b"\v" + bytes([202]),
    ]
    for data in cases:
        p = tmp_path / "in.txt"
        p.write_bytes(data)
        with open(p, "rb") as f:
            got = read_two_sequences(f)  # routes native (real fd)
        want = read_two_sequences(io.BytesIO(data))  # python path
        assert got == want, data

    # early-EOF fatal cases raise identically through both paths
    # (EOF while skipping whitespace before seq 2 is fatal too)
    for data in [b"", b"GT", b"GT "]:
        p = tmp_path / "in.txt"
        p.write_bytes(data)
        import pytest

        with open(p, "rb") as f:
            with pytest.raises(EarlyEOFError):
                read_two_sequences(f)
        with pytest.raises(EarlyEOFError):
            read_two_sequences(io.BytesIO(data))


def test_batch_cli(tmp_path):
    """nw-tpu-batch: TSV output matches per-pair align(); resume works."""
    import numpy as np

    from nw_tpu.batch_cli import main as batch_main
    from nw_tpu.models.needleman_wunsch import NWAligner

    rng = np.random.default_rng(27)
    pairs = [
        (
            "".join(rng.choice(list("ACGT"), int(rng.integers(1, 20)))),
            "".join(rng.choice(list("ACGT"), int(rng.integers(1, 20)))),
        )
        for _ in range(9)
    ]
    src = tmp_path / "pairs.txt"
    src.write_text("".join(f"{a} {b}\n" for a, b in pairs))
    out = tmp_path / "out.tsv"
    ck = tmp_path / "ck"
    rc = batch_main([
        "--pairs", str(src), "--out", str(out), "--counts", "--alignments",
        "-m", "2", "-k", "1", "-d", "1", "--chunk", "4",
        "--checkpoint-dir", str(ck), "--sort-by-length",
    ])
    assert rc == 0
    rows = [l.split("\t") for l in out.read_text().splitlines()]
    assert len(rows) == len(pairs)
    al = NWAligner(match=2, mismatch=1, indel=1)
    for i, (a, b) in enumerate(pairs):
        full = al.align(a, b)
        assert int(rows[i][1]) == full.score, (i, a, b)
        assert int(rows[i][2]) == full.solution_count % 2**32
        X, Y = full.best_alignment()
        assert rows[i][3] == X.decode() and rows[i][4] == Y.decode()
    # resume: rerun with chunks on disk produces identical output
    out2 = tmp_path / "out2.tsv"
    rc = batch_main([
        "--pairs", str(src), "--out", str(out2), "--counts", "--alignments",
        "-m", "2", "-k", "1", "-d", "1", "--chunk", "4",
        "--checkpoint-dir", str(ck), "--sort-by-length",
    ])
    assert rc == 0 and out2.read_text() == out.read_text()


def test_batch_cli_modes(tmp_path):
    """nw-tpu-batch --mode sw/affine matches the per-pair engines."""
    import numpy as np

    from nw_tpu.batch_cli import main as batch_main
    from nw_tpu.models.affine import affine_align
    from nw_tpu.models.smith_waterman import sw_align

    rng = np.random.default_rng(29)
    pairs = [
        (
            "".join(rng.choice(list("ACGT"), int(rng.integers(1, 15)))),
            "".join(rng.choice(list("ACGT"), int(rng.integers(1, 15)))),
        )
        for _ in range(5)
    ]
    src = tmp_path / "pairs.txt"
    src.write_text("".join(f"{a} {b}\n" for a, b in pairs))

    out = tmp_path / "sw.tsv"
    assert batch_main([
        "--pairs", str(src), "--out", str(out), "--mode", "sw",
        "--alignments", "-m", "2", "-k", "1", "-d", "1",
    ]) == 0
    rows = [l.split("\t") for l in out.read_text().splitlines()]
    for i, (a, b) in enumerate(pairs):
        score, X, Y, _ = sw_align(a, b, 2, 1, 1)
        assert int(rows[i][1]) == score and rows[i][2] == X.decode()

    out = tmp_path / "af.tsv"
    assert batch_main([
        "--pairs", str(src), "--out", str(out), "--mode", "affine",
        "--alignments", "-m", "2", "-k", "1", "--open", "3", "--extend", "1",
    ]) == 0
    rows = [l.split("\t") for l in out.read_text().splitlines()]
    for i, (a, b) in enumerate(pairs):
        score, X, Y = affine_align(a, b, 2, 1, 3, 1)
        assert int(rows[i][1]) == score and rows[i][2] == X.decode()

    from nw_tpu.models.overlap import overlap_align

    out = tmp_path / "ov.tsv"
    assert batch_main([
        "--pairs", str(src), "--out", str(out), "--mode", "overlap",
        "--alignments", "-m", "2", "-k", "1", "-d", "1",
    ]) == 0
    rows = [l.split("\t") for l in out.read_text().splitlines()]
    for i, (a, b) in enumerate(pairs):
        score, X, Y, _, _ = overlap_align(a, b, 2, 1, 1)
        assert int(rows[i][1]) == score and rows[i][2] == X.decode()


def test_checkpoint_retry(tmp_path):
    """Transient chunk failures are retried; persistent ones propagate."""
    attempts = []

    def flaky(chunk):
        attempts.append(1)
        if len(attempts) < 3:  # fail twice, then succeed
            raise RuntimeError("transient")
        return {"scores": np.zeros(len(chunk), np.int32)}

    runner = CheckpointedRunner(str(tmp_path / "r"), chunk_size=8)
    out = runner.run([(b"A", b"A")] * 4, flaky, retries=2)
    assert out["scores"].shape == (4,) and len(attempts) == 3

    def always_fails(chunk):
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError):
        CheckpointedRunner(str(tmp_path / "r2"), chunk_size=8).run(
            [(b"A", b"A")] * 4, always_fails, retries=1
        )
