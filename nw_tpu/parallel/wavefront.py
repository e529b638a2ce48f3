"""Sequence-parallel wavefront: ONE pair's fill sharded across devices.

The long-context analogue for alignment (SURVEY.md §5.7): a huge DP
matrix's anti-diagonal state vector is split into contiguous row-chunks,
one per device along the ``seq`` mesh axis.  Every scan step, each device
computes its chunk of the new diagonal; the only cross-device dependency
is a **one-element halo** — lane ``j`` needs lanes ``j-1`` of the two
previous diagonals, so each device ships its last lane to its right
neighbor via ``ppermute``.  The reference's equivalent is the
pthread condvar handoff on the left cell (needleman-wunsch.c:444-452);
here the collective's data dependency *is* the synchronization.

The ``prev2`` halo needs no second transfer: the neighbor's previous
``prev`` halo (received one step earlier) is carried forward.

This module is score-only (what one wants for huge pairs; arrows at this
scale are an HBM-budget problem solved separately via tiling/Hirschberg).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from nw_tpu.ops.fill_scan import NEG_INF

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.partial(jax.jit, static_argnames=("m", "k", "d", "mesh", "axis"))
def fill_score_seq_sharded(top, side, *, m: int, k: int, d: int, mesh: Mesh, axis: str = "seq"):
    """Optimal score of one pair, diagonal state sharded over ``axis``.

    Args:
      top: int32[A] encoded top string.
      side: int32[B] encoded side string.
    Returns:
      int32 scalar — score at cell (B, A), bit-identical to the
      single-device fill.
    """
    A = top.shape[0]
    B = side.shape[0]
    if A == 0 and B == 0:
        return jnp.int32(0)  # 1x1 table: the corner is cell (0,0)
    nseq = mesh.shape[axis]

    # pad the row dimension so every device owns an equal chunk
    N_pad = _round_up(B + 1, nseq)
    C = N_pad // nseq

    side_sh = jnp.concatenate(
        [
            jnp.full((1,), -3, jnp.int32),
            side.astype(jnp.int32),
            jnp.full((N_pad - B - 1,), -5, jnp.int32),
        ]
    )  # (N_pad,) — row j's side char lives at index j
    top_rev = top[::-1].astype(jnp.int32)
    pad = jnp.full((N_pad,), -4, jnp.int32)
    top_ext = jnp.concatenate([pad, top_rev, pad])  # (A + 2*N_pad,)

    K = A + N_pad - 1  # enough diagonals to cross the true corner
    perm = [(i, (i + 1) % nseq) for i in range(nseq)]

    def local(side_local, top_ext):
        p = jax.lax.axis_index(axis)
        jl = jnp.arange(C, dtype=jnp.int32)
        jg = p * C + jl  # global row indices of this chunk

        # zero carrying the sharded input's varying-axes type, so scan
        # carry inits type-match the body outputs under shard_map
        vary0 = side_local.sum() * 0

        prev = jnp.where(jg == 0, jnp.int32(0), NEG_INF) + vary0  # diagonal 0
        prev2 = jnp.full((C,), NEG_INF, jnp.int32) + vary0
        halo_prev = jnp.full((1,), NEG_INF, jnp.int32) + vary0
        cap = NEG_INF + vary0

        is_p0 = (p == 0)

        def step(carry, kk):
            prev, prev2, halo_prev, cap = carry

            # neighbor's last lane of the previous diagonal; device 0's
            # wrap-around halo is masked to NEG_INF so the j == 0 and
            # j == kk boundary values emerge naturally from the
            # recurrence (prev[0] - d chain) — no boundary select
            halo = jnp.where(
                is_p0, NEG_INF, jax.lax.ppermute(prev[-1:], axis, perm)
            )

            prev_sh = jnp.concatenate([halo, prev[:-1]])
            prev2_sh = jnp.concatenate([halo_prev, prev2[:-1]])

            ch_top = jax.lax.dynamic_slice(
                top_ext, (N_pad + A - kk + p * C,), (C,)
            )
            sub = jnp.where(ch_top == side_local, m, -k)

            score = jnp.maximum(
                prev2_sh + sub, jnp.maximum(prev_sh, prev) - d
            )

            hit = (kk == A + B) & (jg == B)
            cap = jnp.where(jnp.any(hit), jnp.where(hit, score, NEG_INF).max(), cap)

            return (score, prev, halo, cap), None

        (prev, _, _, cap), _ = jax.lax.scan(
            step, (prev, prev2, halo_prev, cap), jnp.arange(1, K + 1)
        )
        # merge: exactly one device captured the corner
        return jax.lax.pmax(cap, axis)

    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=P(),
    )
    return mapped(side_sh, top_ext)
