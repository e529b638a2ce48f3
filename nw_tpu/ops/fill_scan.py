"""Anti-diagonal Needleman-Wunsch fill as a ``jax.lax.scan``.

This is the data-parallel restatement of the reference's cell-at-a-time
fill (``score_cell`` / ``score_cell_column`` / ``compute_table_scores``,
needleman-wunsch.c:418-626).  The reference extracts parallelism with a
per-cell mutex/condvar pipeline across pthreads; here the dependency
structure itself is exploited: every cell on an anti-diagonal ``k = i + j``
depends only on diagonals ``k-1`` and ``k-2``, so one diagonal is one
vectorized step and the whole fill is a scan of ``M+N-2`` steps carrying
two rolling diagonal vectors — no locks, no atomics.  It is plain
``lax`` code that XLA compiles for any backend, and the oracle every
other engine is tested against.

Table orientation matches the reference (computation.c:154-161): the "top"
string ``s1`` spans columns ``i`` (M = len(s1)+1 columns), the "side"
string ``s2`` spans rows ``j`` (N = len(s2)+1 rows).

Outputs are stored diagonal-major: ``D[k, j]`` holds cell
``(row=j, col=k-j)``.  This makes every scan step a contiguous vector
write (no scatters); the rectangular view is a cheap gather
(:func:`diag_to_matrix`).

Scoring semantics are bit-identical to the reference:

* boundary row 0: ``score = i * (-d)``, arrow LEFT (computation.c:104-110)
* boundary col 0: ``score = j * (-d)``, arrow UP  (computation.c:114-120)
* interior (needleman-wunsch.c:430-465): ``max(diag + (m | -k), up - d,
  left - d)`` with an arrow bit for *every* candidate equal to the max
  (ties preserved, needleman-wunsch.c:485-503).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = np.int32(-(2**30))  # sentinel (numpy: module-scope jnp would init the backend)


def num_diagonals(len1: int, len2: int) -> int:
    """Number of anti-diagonals of the (len2+1) x (len1+1) table."""
    return len1 + len2 + 1


def _prep(top, side):
    """(side_sh, top_ext): sentinel-framed inputs of the diagonal step.

    Side character for row j is ``side_sh[j]`` (row 0 gets a
    non-matching sentinel; it is never an interior row).  The top
    character of the cell at (diagonal kk, row j) is ``top[kk-1-j]``; as
    j varies this is a contiguous slice of reversed(top), so both ends
    are padded to keep every slice in bounds:
    ``top_ext[(N + A - kk) + j] = top[kk - 1 - j]``."""
    N = side.shape[0] + 1
    side_sh = jnp.concatenate(
        [jnp.full((1,), -3, jnp.int32), side.astype(jnp.int32)]
    )
    pad = jnp.full((N,), -4, jnp.int32)
    top_ext = jnp.concatenate([pad, top[::-1].astype(jnp.int32), pad])
    return side_sh, top_ext


def _diag_step(prev, prev2, kk, side_sh, top_ext, A, m, k, d):
    """Scores and arrows of diagonal ``kk`` from diagonals kk-1, kk-2.

    The interior recurrence is ``max(diag + (m | -k), up - d, left - d)``
    with an arrow bit for every candidate equal to the max; row 0 is
    ``i * (-d)`` with a LEFT arrow and column 0 ``j * (-d)`` with an UP
    arrow (computation.c:104-120); cells outside the table hold
    NEG_INF and no arrows."""
    N = prev.shape[0]
    j_idx = jnp.arange(N, dtype=jnp.int32)
    i_idx = kk - j_idx  # column index of each lane
    valid = (i_idx >= 0) & (i_idx <= A)
    interior = valid & (j_idx >= 1) & (i_idx >= 1)

    ch_top = jax.lax.dynamic_slice(top_ext, (N + A - kk,), (N,))
    sub = jnp.where(ch_top == side_sh, m, -k)

    # shift down by one lane: lane j reads former lane j-1
    neg1 = jnp.full((1,), NEG_INF, jnp.int32)
    prev_sh = jnp.concatenate([neg1, prev[:-1]])
    prev2_sh = jnp.concatenate([neg1, prev2[:-1]])

    cand_diag = prev2_sh + sub  # (j-1, i-1) on diagonal k-2
    cand_up = prev_sh - d       # (j-1, i)   on diagonal k-1
    cand_left = prev - d        # (j,   i-1) on diagonal k-1

    score = jnp.maximum(jnp.maximum(cand_diag, cand_up), cand_left)
    arrows = (
        (cand_diag == score).astype(jnp.uint8)
        | ((cand_left == score).astype(jnp.uint8) << 1)
        | ((cand_up == score).astype(jnp.uint8) << 2)
    )
    arrows = jnp.where(interior, arrows, jnp.uint8(0))
    score = jnp.where(interior, score, NEG_INF)

    # Boundary row 0 (j == 0, i = kk >= 1): i*(-d), LEFT.
    on_top_row = valid & (j_idx == 0)
    score = jnp.where(on_top_row, -kk * d, score)
    arrows = jnp.where(on_top_row, jnp.uint8(2), arrows)
    # Boundary col 0 (i == 0 -> j == kk >= 1): j*(-d), UP.
    on_left_col = valid & (i_idx == 0)
    score = jnp.where(on_left_col, -kk * d, score)
    arrows = jnp.where(on_left_col & (kk > 0), jnp.uint8(4), arrows)
    # cell (0,0) (diagonal 0): score 0 and no arrows (computation.c:96-100)
    arrows = jnp.where(kk == 0, jnp.uint8(0), arrows)
    return score, arrows


def _init_diags(top, side, len1, len2):
    """(diagonal 0, "diagonal -1") carrying the inputs' varying-axes type.

    Under shard_map, scan carries initialized from plain constants would
    differ in vma type from the body outputs (which depend on sharded
    inputs), so both start from a zero derived from the inputs.  Diagonal
    0 is only cell (0,0), score 0 and no arrows (computation.c:96-100).
    """
    N = side.shape[0] + 1
    vary0 = (top.sum() + side.sum() + len1 + len2).astype(jnp.int32) * 0
    j_idx = jnp.arange(N, dtype=jnp.int32)
    diag0 = jnp.where(j_idx == 0, jnp.int32(0), NEG_INF) + vary0
    prev2 = jnp.full((N,), NEG_INF, jnp.int32) + vary0
    return diag0, prev2, vary0


def _scalars(len1, len2, A, B, m, k, d):
    len1 = jnp.asarray(A if len1 is None else len1, jnp.int32)
    len2 = jnp.asarray(B if len2 is None else len2, jnp.int32)
    return len1, len2, *(jnp.asarray(x, jnp.int32) for x in (m, k, d))


@functools.partial(jax.jit, static_argnames=("with_scores", "with_arrows"))
def fill_diag(
    top,
    side,
    m,
    k,
    d,
    len1=None,
    len2=None,
    with_scores: bool = False,
    with_arrows: bool = True,
):
    """Fill the DP table along anti-diagonals.

    Args:
      top: int32[A] encoded top string (s1) — columns (possibly padded).
      side: int32[B] encoded side string (s2) — rows (possibly padded).
      m, k, d: match bonus / mismatch penalty / indel penalty (int32).
      len1, len2: true (unpadded) lengths; the returned ``score`` is read
        at the true corner cell (len2, len1).  Default: the padded corner.
        Padding never contaminates the true rectangle because the NW
        recurrence only reads smaller row/col indices (see ops/encode.py).
      with_scores: also return the full diagonal-major score table
        (needed for ``-t`` rendering).
      with_arrows: return packed arrows (disable for score-only fills).

    Returns:
      dict with:
        ``score``: int32 — score at the true corner (the optimal
          alignment score).
        ``arrows``: uint8[K, N] diagonal-major packed arrows (if
          ``with_arrows``); K = A+B+1 diagonals, N = B+1 rows.
        ``scores``: int32[K, N] diagonal-major scores (if
          ``with_scores``); cells outside the table hold ``NEG_INF``.
    """
    A = top.shape[0]
    B = side.shape[0]
    N = B + 1
    K = A + B + 1
    len1, len2, m, k, d = _scalars(len1, len2, A, B, m, k, d)
    k_corner = len1 + len2
    side_sh, top_ext = _prep(top, side)
    # the scan starts one diagonal early, so diagonal 0 is a scan output
    # and the stacked tables need no concatenate (no second copy)
    _, neg, _ = _init_diags(top, side, len1, len2)

    def step(carry, kk):
        prev, prev2, captured = carry
        score, arrows = _diag_step(prev, prev2, kk, side_sh, top_ext, A, m, k, d)
        # Capture the true-corner score as the wavefront passes it.
        captured = jnp.where(
            kk == k_corner,
            jax.lax.dynamic_index_in_dim(score, len2, keepdims=False),
            captured,
        )
        ys = {}
        if with_scores:
            ys["scores"] = score
        if with_arrows:
            ys["arrows"] = arrows
        return (score, prev, captured), ys

    ks = jnp.arange(0, K, dtype=jnp.int32)
    (_, _, captured), ys = jax.lax.scan(step, (neg, neg, neg[0]), ks)
    return {"score": captured, **ys}


def _count_step(arr, prev, prev2):
    """Path counts of one diagonal from its arrows and the counts of
    diagonals k-1, k-2 (uint32, wrapping like the reference's
    ``unsigned int solution_count``, computation.h:65)."""
    zero1 = jnp.zeros((1,), jnp.uint32)
    prev_sh = jnp.concatenate([zero1, prev[:-1]])
    prev2_sh = jnp.concatenate([zero1, prev2[:-1]])
    return (
        jnp.where((arr & 1) != 0, prev2_sh, 0)  # diag pred (j-1 on k-2)
        + jnp.where((arr & 2) != 0, prev, 0)     # left pred (j   on k-1)
        + jnp.where((arr & 4) != 0, prev_sh, 0)  # up pred   (j-1 on k-1)
    ).astype(jnp.uint32)


@jax.jit
def fill_score_count(top, side, m, k, d, len1=None, len2=None):
    """(optimal score int32, optimal-alignment count uint32) of ONE pair
    in a single O(A + B)-memory pass: the count DP rides the score
    wavefront, so no arrow table is ever stored.  The count equals
    :func:`nw_tpu.ops.pathcount.count_paths` over the full arrows (it is
    1 for an empty pair; callers apply the reference's 0 there)."""
    A = top.shape[0]
    B = side.shape[0]
    N = B + 1
    len1, len2, m, k, d = _scalars(len1, len2, A, B, m, k, d)
    k_corner = len1 + len2
    side_sh, top_ext = _prep(top, side)
    diag0, prev2_init, vary0 = _init_diags(top, side, len1, len2)
    j_idx = jnp.arange(N, dtype=jnp.int32)
    cdiag0 = jnp.where(j_idx == 0, jnp.uint32(1), jnp.uint32(0)) + vary0.astype(
        jnp.uint32
    )
    czero = jnp.zeros((N,), jnp.uint32) + vary0.astype(jnp.uint32)

    def step(carry, kk):
        prev, prev2, cprev, cprev2, cap, ccap = carry
        score, arrows = _diag_step(prev, prev2, kk, side_sh, top_ext, A, m, k, d)
        cnt = _count_step(arrows, cprev, cprev2)
        hit = kk == k_corner
        cap = jnp.where(
            hit, jax.lax.dynamic_index_in_dim(score, len2, keepdims=False), cap
        )
        ccap = jnp.where(
            hit, jax.lax.dynamic_index_in_dim(cnt, len2, keepdims=False), ccap
        )
        return (score, prev, cnt, cprev, cap, ccap), None

    init = (
        diag0, prev2_init, cdiag0, czero,
        jnp.int32(0) + vary0, jnp.uint32(1) + vary0.astype(jnp.uint32),
    )
    ks = jnp.arange(1, A + B + 1, dtype=jnp.int32)
    carry, _ = jax.lax.scan(step, init, ks)
    return carry[4], carry[5]


# Batched variants: one pair per leading-dim row (all padded to a bucket).
fill_diag_batch = jax.jit(
    jax.vmap(
        lambda top, side, m, k, d, l1, l2: fill_diag(
            top, side, m, k, d, l1, l2, with_scores=False, with_arrows=True
        ),
        in_axes=(0, 0, None, None, None, 0, 0),
    ),
)

# the same fill with the arrows stacked diagonal-major, (K, B, N): the
# scan's own output layout, so no transposed copy of a batch's table
fill_arrows_batch_kbn = jax.jit(
    jax.vmap(
        lambda top, side, m, k, d, l1, l2: fill_diag(
            top, side, m, k, d, l1, l2, with_scores=False, with_arrows=True
        ),
        in_axes=(0, 0, None, None, None, 0, 0),
        out_axes={"score": 0, "arrows": 1},
    ),
)

fill_scores_batch = jax.jit(
    jax.vmap(
        lambda top, side, m, k, d, l1, l2: fill_diag(
            top, side, m, k, d, l1, l2, with_scores=False, with_arrows=False
        )["score"],
        in_axes=(0, 0, None, None, None, 0, 0),
    ),
)


def diag_to_matrix(diag, len1: int, len2: int):
    """Convert a diagonal-major table D[k, j] to rectangular H[j, i].

    ``H[j, i] = D[i + j, j]``.  Works on numpy or jnp arrays; the result
    is the true (len2+1, len1+1) table (pad region sliced away).
    """
    import numpy as np

    D = np.asarray(diag)
    N, M = len2 + 1, len1 + 1
    jj, ii = np.mgrid[0:N, 0:M]
    return D[ii + jj, jj]


def fill_matrix(top, side, m, k, d):
    """Convenience: rectangular (N, M) scores and arrows for one pair.

    Used by the CLI and tests; production batched paths keep the
    diagonal-major layout.
    """
    import numpy as np

    A, B = int(top.shape[0]), int(side.shape[0])
    out = fill_diag(top, side, m, k, d, with_scores=True)
    scores = diag_to_matrix(np.asarray(out["scores"]), A, B)
    arrows = diag_to_matrix(np.asarray(out["arrows"]), A, B)
    return scores, arrows


@jax.jit
def fill_last_row(top, side, m, k, d, len1, len2):
    """Scores of the DP row ``len2`` for columns 0..A (valid through
    ``len1``) — the building block of Hirschberg's linear-space
    traceback (ops/hirschberg.py).

    Runs the same anti-diagonal scan but emits only one scalar per step
    (the wavefront's value at row ``len2``), so memory is O(A+B) instead
    of O(A*B).  ``H[len2, i]`` sits on diagonal ``len2 + i``.
    """
    A = top.shape[0]
    B = side.shape[0]
    K = A + B + 1
    len1, len2, m, k, d = _scalars(len1, len2, A, B, m, k, d)
    side_sh, top_ext = _prep(top, side)
    diag0, prev2_0, _ = _init_diags(top, side, len1, len2)

    def step(carry, kk):
        prev, prev2 = carry
        score, _ = _diag_step(prev, prev2, kk, side_sh, top_ext, A, m, k, d)
        emit = jax.lax.dynamic_index_in_dim(score, len2, keepdims=False)
        return (score, prev), emit

    ks = jnp.arange(1, K, dtype=jnp.int32)
    _, ys = jax.lax.scan(step, (diag0, prev2_0), ks)  # ys[kk-1], kk=1..K-1

    # H[len2, i] for i >= 1 is ys[len2 + i - 1]; H[len2, 0] = -len2*d
    row_tail = jax.lax.dynamic_slice(ys, (len2,), (A,)) if A > 0 else ys[:0]
    row0 = (-len2 * d)[None]
    return jnp.concatenate([row0, row_tail])
