"""Cross-device huge-pair mode (BASELINE config 5) vs single-device
oracles: tiled block-wavefront fill with chunked halo exchange, sharded
arrow storage, and the segment-relay exact traceback — all on the
8-virtual-device CPU mesh (SURVEY §4.3 item 4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from nw_tpu.ops import encode as enc
from nw_tpu.ops import traceback
from nw_tpu.ops.fill_scan import fill_diag


def _mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"need {n} devices")
    return Mesh(np.array(jax.devices()[:n]), ("seq",))


def _case(rng, la, lb):
    top = jnp.asarray(enc.encode("".join(rng.choice(list("ACGT"), la))))
    side = jnp.asarray(enc.encode("".join(rng.choice(list("ACGT"), lb))))
    return top, side


@pytest.mark.parametrize(
    "la,lb,C,mkd",
    [
        (33, 41, 8, (2, 1, 1)),
        (57, 23, 16, (1, 1, 1)),
        (100, 90, 8, (2, 1, 1)),
        (5, 80, 8, (2, 1, 1)),    # walk crosses every device
        (80, 5, 8, (2, 1, 1)),    # single-device rows, long top
        (64, 64, 8, (0, 0, 0)),   # degenerate scoring (max tie density)
        (70, 30, 8, (3, -1, 2)),  # negative mismatch penalty
    ],
)
def test_sharded_huge_pair_vs_oracle(la, lb, C, mkd):
    from nw_tpu.parallel.huge_pair import (
        huge_pair_align_sharded,
        huge_pair_score_sharded,
    )

    mesh = _mesh(8)
    rng = np.random.default_rng(la * 1000 + lb)
    top, side = _case(rng, la, lb)
    ref = fill_diag(top, side, *mkd, with_scores=False)
    opsr, nr = traceback.traceback_greedy(
        ref["arrows"], la, lb, max_steps=la + lb
    )
    opsr, nr = np.asarray(opsr), int(nr)

    sc = huge_pair_score_sharded(top, side, *mkd, mesh, chunk=C)
    assert sc == int(ref["score"])
    r = huge_pair_align_sharded(top, side, *mkd, mesh, chunk=C)
    assert r.score == int(ref["score"])
    assert r.n == nr
    np.testing.assert_array_equal(r.ops, opsr[:nr])


@pytest.mark.parametrize("ndev", [2, 3, 5])
def test_sharded_huge_pair_mesh_sizes(ndev):
    from nw_tpu.parallel.huge_pair import huge_pair_align_sharded

    mesh = _mesh(ndev)
    rng = np.random.default_rng(ndev)
    top, side = _case(rng, 40, 50)
    ref = fill_diag(top, side, 2, 1, 1, with_scores=False)
    opsr, nr = traceback.traceback_greedy(ref["arrows"], 40, 50, max_steps=90)
    r = huge_pair_align_sharded(top, side, 2, 1, 1, mesh, chunk=8)
    assert r.score == int(ref["score"])
    assert r.n == int(nr)
    np.testing.assert_array_equal(r.ops, np.asarray(opsr)[: int(nr)])


def test_sharded_huge_pair_strings_roundtrip():
    """Stitched ops must materialize the reference's first alignment."""
    from nw_tpu.parallel.huge_pair import huge_pair_align_sharded

    mesh = _mesh(8)
    rng = np.random.default_rng(77)
    s1 = "".join(rng.choice(list("ACGT"), 60)).encode()
    s2 = "".join(rng.choice(list("ACGT"), 75)).encode()
    top = jnp.asarray(enc.encode(s1))
    side = jnp.asarray(enc.encode(s2))
    ref = fill_diag(top, side, 2, 1, 1, with_scores=False)
    opsr, nr = traceback.traceback_greedy(ref["arrows"], 60, 75, max_steps=135)
    want = traceback.ops_to_strings(np.asarray(opsr), int(nr), s1, s2)
    r = huge_pair_align_sharded(top, side, 2, 1, 1, mesh, chunk=16)
    got = traceback.ops_to_strings(r.ops, r.n, s1, s2)
    assert got == want


def test_align_huge_sharded_api():
    from nw_tpu.models.needleman_wunsch import NWAligner, align

    mesh = _mesh(8)
    rng = np.random.default_rng(5)
    s1 = "".join(rng.choice(list("ACGT"), 70))
    s2 = "".join(rng.choice(list("ACGT"), 85))
    ref = align(s1, s2, 2, 1, 1)
    want_X, want_Y = ref.best_alignment()
    r = NWAligner(match=2, mismatch=1, indel=1).align_huge_sharded(
        s1, s2, mesh, chunk=16
    )
    assert r.score == ref.score
    assert (r.X, r.Y) == (want_X, want_Y)


def test_auto_chunk_efficiency():
    """Chunk auto-pick keeps the phase pipeline >= 85% efficient at
    production scale and stays correct on a real (tiny) mesh run
    (VERDICT r2 item 8)."""
    from nw_tpu.parallel.huge_pair import (
        auto_chunk,
        huge_pair_align_sharded,
        pipeline_efficiency,
    )

    for nseq in (2, 4, 8):
        for L in (30_000, 100_000, 400_000):
            C = auto_chunk(L, L, nseq)
            eff = pipeline_efficiency(L, L, nseq, C)
            assert eff >= 0.85, (nseq, L, C, eff)
    # smaller chunks only help: the efficiency model is monotone
    assert pipeline_efficiency(100_000, 100_000, 8, 128) >= (
        pipeline_efficiency(100_000, 100_000, 8, 2048)
    )

    # chunk=None (auto) drives a real mesh run to the oracle answer
    mesh = _mesh(4)
    rng = np.random.default_rng(123)
    top, side = _case(rng, 60, 70)
    ref = fill_diag(top, side, 2, 1, 1, with_scores=False)
    opsr, nr = traceback.traceback_greedy(ref["arrows"], 60, 70, max_steps=130)
    r = huge_pair_align_sharded(top, side, 2, 1, 1, mesh)
    assert r.score == int(ref["score"])
    assert r.n == int(nr)
    np.testing.assert_array_equal(r.ops, np.asarray(opsr)[: int(nr)])


def test_resumable_huge_pair_kill_and_resume(tmp_path):
    """Config-5 checkpoint/resume: the tiled fill persists its
    per-device phase carry + arrow planes each span; a killed run
    resumes and produces the identical score/ops as the uninterrupted
    sharded engine."""
    from nw_tpu.parallel.huge_pair import huge_pair_align_sharded
    from nw_tpu.runtime.checkpoint import ResumableHugePair

    mesh = _mesh(4)
    rng = np.random.default_rng(103)
    top, side = _case(rng, 40, 50)
    want = huge_pair_align_sharded(top, side, 2, 1, 1, mesh, chunk=8)

    rdir = tmp_path / "huge"
    runner = ResumableHugePair(str(rdir), span=3)
    with pytest.raises(KeyboardInterrupt):
        runner.run(top, side, 2, 1, 1, mesh, chunk=8, _abort_after_spans=2)
    assert (rdir / "huge_state.npz").exists()
    got = ResumableHugePair(str(rdir), span=3).run(
        top, side, 2, 1, 1, mesh, chunk=8
    )
    assert got.score == want.score
    assert got.n == want.n
    np.testing.assert_array_equal(got.ops, want.ops)

    # uninterrupted run through the runner matches too
    got2 = ResumableHugePair(str(tmp_path / "h0"), span=4).run(
        top, side, 2, 1, 1, mesh, chunk=8
    )
    assert (got2.score, got2.n) == (want.score, want.n)

    # wrong-params resume is refused
    with pytest.raises(ValueError):
        ResumableHugePair(str(rdir), span=3).run(
            top, side, 3, 1, 1, mesh, chunk=8
        )


@pytest.mark.parametrize(
    "nseq,la,lb,C,mkd",
    [
        (8, 33, 41, 8, (2, 1, 1)),
        (8, 5, 80, 8, (2, 1, 1)),
        (8, 64, 64, 8, (0, 0, 0)),    # max tie density
        (8, 300, 280, 32, (3, -1, 2)),
        (2, 257, 511, 16, (2, 1, 1)),
        (1, 120, 999, 16, (3, -1, 2)),  # one device: the single-card route
        (2, 150, 900, 24, (2, 1, 1)),
        (8, 80, 2100, 16, (2, 1, 1)),   # long side over the full mesh
        (4, 1, 0, 4, (2, 1, 1)),        # degenerate lengths
        (3, 0, 17, 4, (2, 1, 1)),
    ],
)
def test_sharded_huge_pair_shapes(nseq, la, lb, C, mkd):
    """Mesh sizes x shapes (long sides, one-device meshes, chunks that
    do not divide the table) vs the single-device oracles: score-only
    fill, and the relay walk's exact first-emission alignment."""
    from nw_tpu.parallel.huge_pair import (
        huge_pair_align_sharded,
        huge_pair_score_sharded,
    )

    mesh = _mesh(nseq)
    rng = np.random.default_rng(la * 11 + lb + nseq)
    top, side = _case(rng, la, lb)
    ref = fill_diag(top, side, *mkd, with_scores=False)
    opsr, nr = traceback.traceback_greedy(
        ref["arrows"], la, lb, max_steps=max(1, la + lb)
    )
    assert huge_pair_score_sharded(top, side, *mkd, mesh, chunk=C) == int(
        ref["score"]
    )
    r = huge_pair_align_sharded(top, side, *mkd, mesh, chunk=C)
    assert r.score == int(ref["score"])
    assert r.n == int(nr)
    np.testing.assert_array_equal(r.ops, np.asarray(opsr)[: int(nr)])


def test_auto_chunk_contracts():
    """auto_chunk stays inside [1, table diagonals] and one device takes
    the largest chunk (no pipeline bubble to amortize)."""
    from nw_tpu.parallel.huge_pair import auto_chunk

    for nseq in (1, 2, 8):
        for L in (1, 100, 5_000, 100_000):
            C = auto_chunk(L, L, nseq)
            assert 1 <= C <= 2 * L + nseq
    assert auto_chunk(100_000, 100_000, 1) == 2048


def test_resumable_huge_pair_score_only(tmp_path):
    """Score-only config-5 resume: kill mid-fill, resume, identical
    score to the uninterrupted run."""
    from nw_tpu.parallel.huge_pair import huge_pair_score_sharded
    from nw_tpu.runtime.checkpoint import ResumableHugePair

    mesh = _mesh(4)
    rng = np.random.default_rng(7)
    top, side = _case(rng, 40, 50)
    want = huge_pair_score_sharded(top, side, 2, 1, 1, mesh, chunk=8)

    rdir = tmp_path / "huge-score"
    with pytest.raises(KeyboardInterrupt):
        ResumableHugePair(str(rdir), span=3).run(
            top, side, 2, 1, 1, mesh, chunk=8, traceback=False,
            _abort_after_spans=2,
        )
    got = ResumableHugePair(str(rdir), span=3).run(
        top, side, 2, 1, 1, mesh, chunk=8, traceback=False
    )
    assert got == want
