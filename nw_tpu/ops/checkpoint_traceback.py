"""Checkpointed exact traceback for huge pairs.

The reference materializes 32 B of walk state per cell
(walk-table.h:48-57) and cannot trace back a pair whose table outgrows
RAM; the full-arrow path stores 1 byte per cell, so a 100 kb x 100 kb
pair would still need ~20 GB of arrows, and the Hirschberg route
(ops/hirschberg.py) returns only *an* optimal alignment, not the one
the reference DFS emits first.

This module recovers the exact first-emitted alignment (greedy
diag > left > up over the arrows, needleman-wunsch.c:305-324) in
O(K*N/C + C*N) memory with the classic two-pass checkpoint scheme,
both passes being ``lax.scan`` steps of :mod:`nw_tpu.ops.fill_scan`'s
diagonal recurrence:

1. **Checkpoint pass**: one score wavefront that keeps the rolling
   state (the two previous diagonals) entering every block of C
   diagonals — K/C checkpoints of 2 diagonals each — and captures the
   corner score on the way.
2. **Backward block pass**: walking from the corner, each C-diagonal
   block is *re-filled* from its checkpoint (emitting uint8 arrows for
   just that block) and walked greedily; the walk leaves the block
   after <= C steps and continues in the previous block.  Blocks above
   the walk head are skipped.

Total fill work is 2x a plain fill; the arrow storage live at any
moment is one C x N block.  The emitted op codes match
:func:`nw_tpu.ops.traceback.traceback_greedy` (OP_DIAG/OP_LEFT/OP_UP,
corner -> origin order), so ``traceback.ops_to_strings`` renders the
aligned strings.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from nw_tpu.ops.fill_scan import _diag_step, _init_diags, _prep, _scalars
from nw_tpu.ops.traceback import OP_DIAG, OP_LEFT, OP_NONE, OP_UP


def auto_block_diagonals(A: int, B: int) -> int:
    """Memory-optimal C: checkpoints cost 8*N*K/C bytes (two int32
    diagonals per block), the live arrow block C*N bytes — minimized at
    C = sqrt(8K)."""
    return max(16, int((8 * (A + B + 1)) ** 0.5))


@functools.partial(jax.jit, static_argnames=("block_diagonals",))
def traceback_checkpointed(
    top, side, m, k, d, len1=None, len2=None,
    block_diagonals: int | None = None,
):
    """Exact greedy-first traceback of ONE huge pair in O(K*N/C) memory.

    Args:
      top: int32[A] encoded top string; side: int32[B] (bucket-padded
        OK; pass true lengths via len1/len2).
      block_diagonals: C — diagonals re-filled per backward block
        (default: the memory-optimal sqrt(8K)).
    Returns:
      (ops int8[A+B], n int32, score int32) — op codes corner -> origin
      exactly as :func:`nw_tpu.ops.traceback.traceback_greedy` (and
      therefore the reference DFS's first emission,
      needleman-wunsch.c:305-324), and the optimal score.
    """
    A = top.shape[0]
    B = side.shape[0]
    l1, l2, m, k, d = _scalars(len1, len2, A, B, m, k, d)
    C = block_diagonals or auto_block_diagonals(A, B)
    K = A + B + 1
    S = max(1, -(-(K - 1) // C))  # blocks over diagonals 1 .. K-1
    side_sh, top_ext = _prep(top, side)
    diag0, prev2_0, vary0 = _init_diags(top, side, l1, l2)
    k_corner = l1 + l2

    def fill_block(prev, prev2, lo, emit_arrows):
        def step(carry, t):
            prev, prev2 = carry
            score, arrows = _diag_step(
                prev, prev2, lo + t, side_sh, top_ext, A, m, k, d
            )
            if emit_arrows:
                return (score, prev), arrows
            return (score, prev), jax.lax.dynamic_index_in_dim(
                score, l2, keepdims=False
            )

        return jax.lax.scan(step, (prev, prev2), jnp.arange(C, dtype=jnp.int32))

    # ---- pass 1: checkpoints entering each block, corner capture
    def block_fwd(carry, b):
        prev, prev2, cap = carry
        lo = 1 + b * C
        (nprev, nprev2), row_l2 = fill_block(prev, prev2, lo, False)
        t = k_corner - lo
        cap = jnp.where(
            (t >= 0) & (t < C), row_l2[jnp.clip(t, 0, C - 1)], cap
        )
        return (nprev, nprev2, cap), (prev, prev2)

    (_, _, score), (ck_prev, ck_prev2) = jax.lax.scan(
        block_fwd,
        (diag0, prev2_0, jnp.int32(0) + vary0),
        jnp.arange(S, dtype=jnp.int32),
    )

    # ---- pass 2: backward blocks, re-fill + greedy walk
    MAX_OPS = A + B

    def block_bwd(carry, b_rev):
        b = S - 1 - b_rev
        lo = 1 + b * C

        def run(args):
            _, arr = fill_block(ck_prev[b], ck_prev2[b], lo, True)

            def wstep(_, st):
                i, j, pos, ops = st
                kk = i + j
                active = (kk >= lo) & ((i > 0) | (j > 0))
                a = arr[jnp.clip(kk - lo, 0, C - 1), j]
                take_diag = (a & 1) != 0
                take_left = ~take_diag & ((a & 2) != 0)
                op = jnp.where(
                    take_diag, OP_DIAG, jnp.where(take_left, OP_LEFT, OP_UP)
                ).astype(jnp.int8)
                ops = ops.at[pos].set(jnp.where(active, op, ops[pos]))
                i = i - jnp.where(active & (take_diag | take_left), 1, 0)
                j = j - jnp.where(active & ~take_left, 1, 0)
                pos = pos + active.astype(jnp.int32)
                return (i, j, pos, ops)

            return jax.lax.fori_loop(0, C, wstep, args)

        i, j = carry[0], carry[1]
        return jax.lax.cond(i + j >= lo, run, lambda a: a, carry), None

    ops0 = jnp.full((MAX_OPS + 1,), OP_NONE, jnp.int8)
    (_, _, n, ops), _ = jax.lax.scan(
        block_bwd, (l1, l2, jnp.int32(0), ops0), jnp.arange(S, dtype=jnp.int32)
    )
    return ops[:MAX_OPS], n, score
