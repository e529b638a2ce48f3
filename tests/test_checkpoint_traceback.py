"""Checkpointed exact traceback == greedy traceback over full arrows.

The greedy walk over the full arrow table is itself verified (golden
order + enumeration-set membership) in test_traceback.py; here the
block-checkpointed re-fill walk must reproduce it bit-for-bit while only
ever materializing C diagonals of arrows.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nw_tpu.ops import traceback
from nw_tpu.ops.checkpoint_traceback import traceback_checkpointed
from nw_tpu.ops.encode import encode
from nw_tpu.ops.fill_scan import fill_diag


def _check(s1: str, s2: str, m, k, d, C):
    top, side = encode(s1.encode()), encode(s2.encode())
    out = fill_diag(top, side, m, k, d)
    ops_ref, n_ref = traceback.traceback_greedy(
        out["arrows"], len(s1), len(s2), max_steps=max(1, len(s1) + len(s2))
    )
    ops, n, score = traceback_checkpointed(
        jnp.asarray(top), jnp.asarray(side), m, k, d, block_diagonals=C,
    )
    assert int(score) == int(out["score"])
    assert int(n) == int(n_ref)
    nn = int(n)
    np.testing.assert_array_equal(np.asarray(ops)[:nn], np.asarray(ops_ref)[:nn])
    # and the rendered strings match
    X, Y = traceback.ops_to_strings(ops, n, s1.encode(), s2.encode())
    Xr, Yr = traceback.ops_to_strings(ops_ref, n_ref, s1.encode(), s2.encode())
    assert (X, Y) == (Xr, Yr)


@pytest.mark.parametrize("m,k,d", [(2, 1, 1), (1, 1, 1), (0, 0, 0), (-1, 2, -2)])
def test_checkpointed_matches_greedy(m, k, d):
    rng = np.random.default_rng(17)
    for _ in range(6):
        s1 = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 90))))
        s2 = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 90))))
        _check(s1, s2, m, k, d, C=32)


def test_checkpointed_block_boundary_sizes():
    rng = np.random.default_rng(18)
    s1 = "".join(rng.choice(list("ACGT"), 100))
    s2 = "".join(rng.choice(list("ACGT"), 67))
    for C in (32, 64, 128, 256):
        _check(s1, s2, 2, 1, 1, C)


def test_checkpointed_degenerate():
    _check("A", "A", 1, 1, 1, 32)
    _check("ACGT", "", 1, 1, 1, 32)
    _check("", "ACGT", 1, 1, 1, 32)
    _check("", "", 1, 1, 1, 32)


@pytest.mark.parametrize(
    "s1,s2",
    [
        ("A" * 40, "A" * 3),      # gap-dense: the walk runs long LEFT runs
        ("C" * 3, "ACGT" * 10),   # long UP runs across several blocks
        ("ACGT" * 9, "TGCA" * 9), # mismatch-dense
    ],
)
@pytest.mark.parametrize("C", [1, 7, 16])
def test_checkpointed_gap_dense_and_tiny_blocks(s1, s2, C):
    """Gap runs that cross many blocks, and blocks as small as one
    diagonal (every step of the walk re-enters a new block)."""
    _check(s1, s2, 2, 1, 1, C)


def test_checkpointed_padded_lengths():
    """Bucket-padded inputs with true lengths: identical to the unpadded
    walk (the pad region is never read)."""
    rng = np.random.default_rng(20)
    s1 = "".join(rng.choice(list("ACGT"), 45))
    s2 = "".join(rng.choice(list("ACGT"), 38))
    top = np.full((64,), -1, np.int32)
    top[:45] = encode(s1.encode())
    side = np.full((48,), -2, np.int32)
    side[:38] = encode(s2.encode())
    ops, n, score = traceback_checkpointed(
        jnp.asarray(top), jnp.asarray(side), 2, 1, 1, 45, 38,
        block_diagonals=16,
    )
    out = fill_diag(encode(s1.encode()), encode(s2.encode()), 2, 1, 1)
    ops_ref, n_ref = traceback.traceback_greedy(out["arrows"], 45, 38, 83)
    assert (int(score), int(n)) == (int(out["score"]), int(n_ref))
    np.testing.assert_array_equal(
        np.asarray(ops)[: int(n)], np.asarray(ops_ref)[: int(n)]
    )


def test_align_huge_matches_first_emission():
    """NWAligner.align_huge == the reference DFS's first alignment."""
    from nw_tpu.config import AlignConfig, ScoringParams
    from nw_tpu.models.needleman_wunsch import NWAligner

    rng = np.random.default_rng(19)
    al = NWAligner(AlignConfig(scoring=ScoringParams(2, 1, 1)))
    for _ in range(3):
        s1 = "".join(rng.choice(list("ACGT"), int(rng.integers(30, 120))))
        s2 = "".join(rng.choice(list("ACGT"), int(rng.integers(30, 120))))
        full = al.align(s1, s2)
        X_ref, Y_ref = full.best_alignment()
        r = al.align_huge(s1, s2, block_diagonals=64)
        assert (r.X, r.Y) == (X_ref, Y_ref)
        assert r.score == full.score
