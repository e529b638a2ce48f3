"""O(M*N) optimal-path counting and optimal-path-cell marking.

The reference obtains the number of optimal alignments by *enumerating
every one of them* with a DFS and incrementing a counter
(``inc_solution_count``, computation.c:223-235, called at
needleman-wunsch.c:254) — worst-case exponential, and measured to not
terminate within 120 s on a random 1k pair (SURVEY.md §3.4).  The count
and the ``-t`` optimal-path marking are both plain dynamic programs over
the arrow table, so when the alignments themselves don't need to be
printed (reference invocations like ``-q -s`` or ``-q -t``), this module
computes identical output in two more wavefront scans:

* **count**: paths[0,0] = 1; paths[c] = sum of paths over optimal
  predecessors (arrow bits).  The count at the bottom-right corner is the
  number of optimal alignments.  Arithmetic is uint32 with wraparound —
  exactly the reference's ``unsigned int solution_count`` overflow
  behavior (computation.h:65, printed with %d: computation.c:277).

* **mark**: a cell is on *some* optimal path iff it is backward-reachable
  from the corner via arrows.  The reference's DFS visits (and marks,
  needleman-wunsch.c:239-241) exactly this set, because it explores every
  arrow of every visited cell.

Both run on the diagonal-major layout as ``lax.scan``s, forward and
backward respectively.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def count_paths(arrows_diag, len1, len2):
    """Number of optimal alignments (uint32, reference-wrapping).

    arrows_diag: uint8[K, N] diagonal-major arrows.  len1/len2: true
    lengths (traced ok).  Pad-region cells are harmless: counts flow
    only along arrows inside the true rectangle, and the count is read
    at the true corner — captured in the scan carry, so the live state
    is two count diagonals, never a (K, N) count table.
    """
    from nw_tpu.ops.fill_scan import _count_step

    K, N = arrows_diag.shape
    j_idx = jnp.arange(N, dtype=jnp.int32)
    k_corner = jnp.asarray(len1 + len2, jnp.int32)
    # zero carrying the inputs' varying-axes type (see fill_scan)
    vary0 = arrows_diag[0, 0].astype(jnp.uint32) * 0 + (len1 + len2).astype(
        jnp.uint32
    ) * 0
    diag0 = jnp.where(j_idx == 0, jnp.uint32(1), jnp.uint32(0)) + vary0
    zero = jnp.zeros((N,), jnp.uint32) + vary0

    def step(carry, xs):
        prev, prev2, corner = carry
        arr_k, kk = xs
        cnt = _count_step(arr_k, prev, prev2)
        corner = jnp.where(
            kk == k_corner,
            jax.lax.dynamic_index_in_dim(cnt, len2, keepdims=False),
            corner,
        )
        return (cnt, prev, corner), None

    (_, _, corner), _ = jax.lax.scan(
        step,
        (diag0, zero, jnp.uint32(1) + vary0),
        (arrows_diag[1:], jnp.arange(1, K, dtype=jnp.int32)),
    )
    return corner


@jax.jit
def mark_optimal_cells(arrows_diag, len1, len2):
    """bool[K, N] — cells backward-reachable from the true corner.

    Matches the set of cells the reference DFS marks ``in_optimal_path``
    when ``-t`` is given (needleman-wunsch.c:239-241).
    """
    K, N = arrows_diag.shape
    j_idx = jnp.arange(N, dtype=jnp.int32)
    k_corner = len1 + len2

    def step(carry, k_rev):
        nxt, nxt2 = carry  # reach on diagonals k+1 and k+2
        k = K - 1 - k_rev
        arr_next = arrows_diag[jnp.minimum(k + 1, K - 1)]
        arr_next2 = arrows_diag[jnp.minimum(k + 2, K - 1)]
        # successor (j, i+1) on k+1 points LEFT at me
        via_left = nxt & ((arr_next & 2) != 0)
        # successor (j+1, i) on k+1 points UP at me -> shift up by one lane
        up_bit = nxt & ((arr_next & 4) != 0)
        via_up = jnp.concatenate([up_bit[1:], jnp.zeros((1,), jnp.bool_)])
        # successor (j+1, i+1) on k+2 points DIAG at me
        diag_bit = nxt2 & ((arr_next2 & 1) != 0)
        via_diag = jnp.concatenate([diag_bit[1:], jnp.zeros((1,), jnp.bool_)])
        is_corner = (k == k_corner) & (j_idx == len2)
        reach = is_corner | via_left | via_up | via_diag
        # kill anything at/beyond diagonal boundaries of the true table
        reach = reach & (k <= k_corner)
        return (reach, nxt), reach

    zero = jnp.zeros((N,), jnp.bool_)
    _, reach_rev = jax.lax.scan(step, (zero, zero), jnp.arange(K))
    return reach_rev[::-1]


@jax.jit
def count_branches(arrows_diag, len1, len2):
    """Number of cells with more than one optimal direction — the
    reference's walk-table ``branch_count`` (incremented at
    needleman-wunsch.c:507-509, reported in debug builds at :624-625).

    Counted over interior cells of the true rectangle only (the
    reference increments inside score_cell, which runs for col,row >= 1).
    """
    K, N = arrows_diag.shape
    j_idx = jnp.arange(N, dtype=jnp.int32)[None, :]
    k_idx = jnp.arange(K, dtype=jnp.int32)[:, None]
    i_idx = k_idx - j_idx
    interior = (j_idx >= 1) & (j_idx <= len2) & (i_idx >= 1) & (i_idx <= len1)
    a = arrows_diag.astype(jnp.int32)
    nbits = (a & 1) + ((a >> 1) & 1) + ((a >> 2) & 1)
    return jnp.sum(jnp.where(interior & (nbits > 1), 1, 0).astype(jnp.uint32))
