"""Gotoh affine-gap global alignment (reference FUTURE WORK, README:187-193).

Three-matrix recurrence (M = match/mismatch state, IX = gap in the side
string / leftward moves, IY = gap in the top string / upward moves) with
gap cost ``open + (L-1) * extend``:

    M[j,i]  = max(M, IX, IY)[j-1,i-1] + sub(i,j)
    IX[j,i] = max(M[j,i-1] - open, IX[j,i-1] - extend)
    IY[j,i] = max(M[j-1,i] - open, IY[j-1,i] - extend)

Same anti-diagonal scan as the linear-gap fill, carrying two rolling
diagonals of all three matrices.  Score-only (affine traceback lands
with the tiled/huge-pair work); setting ``extend == open`` reproduces
the linear-gap score with ``d = open``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from nw_tpu.ops.fill_scan import NEG_INF


@jax.jit
def affine_score(top, side, m, k, open_, extend, len1=None, len2=None):
    """Optimal affine-gap global alignment score (int32 scalar), read at
    the true corner (len2, len1) of a possibly padded pair."""
    A = top.shape[0]
    B = side.shape[0]
    N = B + 1
    K = A + B + 1
    len1 = jnp.asarray(A if len1 is None else len1, jnp.int32)
    len2 = jnp.asarray(B if len2 is None else len2, jnp.int32)

    m = jnp.asarray(m, jnp.int32)
    k = jnp.asarray(k, jnp.int32)
    op = jnp.asarray(open_, jnp.int32)
    ex = jnp.asarray(extend, jnp.int32)

    side_sh = jnp.concatenate([jnp.full((1,), -3, jnp.int32), side.astype(jnp.int32)])
    top_rev = top[::-1].astype(jnp.int32)
    pad = jnp.full((N,), -4, jnp.int32)
    top_ext = jnp.concatenate([pad, top_rev, pad])

    j_idx = jnp.arange(N, dtype=jnp.int32)
    vary0 = (top.sum() + side.sum()).astype(jnp.int32) * 0
    # NEG_INF/2 so that NEG - open cannot wrap around
    NEG = jnp.int32(NEG_INF // 2)

    def boundary_gap(L):  # cost of a length-L boundary gap (L >= 1)
        return -(op + (L - 1) * ex)

    # diagonal 0: M(0,0) = 0; IX/IY undefined
    M0 = jnp.where(j_idx == 0, jnp.int32(0), NEG) + vary0
    IX0 = jnp.full((N,), NEG, jnp.int32) + vary0
    IY0 = jnp.full((N,), NEG, jnp.int32) + vary0
    negs = jnp.full((N,), NEG, jnp.int32) + vary0

    def shift(v):
        return jnp.concatenate([jnp.full((1,), NEG, jnp.int32), v[:-1]])

    def step(carry, kk):
        (Mp, IXp, IYp, Mp2, IXp2, IYp2, cap) = carry
        i_idx = kk - j_idx
        valid = (i_idx >= 0) & (i_idx <= A)
        interior = valid & (j_idx >= 1) & (i_idx >= 1)

        ch_top = jax.lax.dynamic_slice(top_ext, (N + A - kk,), (N,))
        sub = jnp.where(ch_top == side_sh, m, -k)

        best_p2 = jnp.maximum(jnp.maximum(Mp2, IXp2), IYp2)
        M = shift(best_p2) + sub
        IX = jnp.maximum(Mp - op, IXp - ex)          # (j, i-1) on k-1
        IY = jnp.maximum(shift(Mp) - op, shift(IYp) - ex)  # (j-1, i) on k-1

        M = jnp.where(interior, M, NEG)
        IX = jnp.where(interior, IX, NEG)
        IY = jnp.where(interior, IY, NEG)

        # boundaries: row 0 (j == 0, i = kk) is an all-IX gap; col 0
        # (i == 0, j == kk) all-IY
        on_top = valid & (j_idx == 0)
        on_left = valid & (i_idx == 0)
        IX = jnp.where(on_top, boundary_gap(kk), IX)
        IY = jnp.where(on_left, boundary_gap(kk), IY)

        best = jnp.maximum(jnp.maximum(M, IX), IY)
        cap = jnp.where(
            kk == len1 + len2,
            jax.lax.dynamic_index_in_dim(best, len2, keepdims=False),
            cap,
        )
        return (M, IX, IY, Mp, IXp, IYp, cap), None

    cap0 = jnp.int32(0) + vary0
    ks = jnp.arange(1, K, dtype=jnp.int32)
    (_, _, _, _, _, _, cap), _ = jax.lax.scan(
        step, (M0, IX0, IY0, negs, negs, negs, cap0), ks
    )
    return cap


# ragged batched fills (padded to a bucket; lens pick the true corner)
affine_score_batch = jax.jit(
    jax.vmap(affine_score, in_axes=(0, 0, None, None, None, None, 0, 0))
)


@jax.jit
def affine_fill_arrows(top, side, m, k, open_, extend, len1=None, len2=None):
    """Gotoh fill emitting per-cell traceback state bits.

    Per cell (diagonal-major uint8[K, N]):
      bits 0-1: the M cell's predecessor state at (j-1, i-1)
                (0 = M, 1 = IX, 2 = IY; ties resolve M > IX > IY)
      bit 2:    the IX cell extends (pred IX) rather than opens (pred M);
                ties resolve to open
      bit 3:    same for IY

    Returns dict(score, state, arrows) — ``state`` is the true corner
    (len2, len1) cell's best matrix (0/1/2, ties M > IX > IY), the
    traceback start.
    """
    A = top.shape[0]
    B = side.shape[0]
    N = B + 1
    K = A + B + 1
    len1 = jnp.asarray(A if len1 is None else len1, jnp.int32)
    len2 = jnp.asarray(B if len2 is None else len2, jnp.int32)

    m = jnp.asarray(m, jnp.int32)
    k = jnp.asarray(k, jnp.int32)
    op = jnp.asarray(open_, jnp.int32)
    ex = jnp.asarray(extend, jnp.int32)

    side_sh = jnp.concatenate([jnp.full((1,), -3, jnp.int32), side.astype(jnp.int32)])
    top_rev = top[::-1].astype(jnp.int32)
    pad = jnp.full((N,), -4, jnp.int32)
    top_ext = jnp.concatenate([pad, top_rev, pad])

    j_idx = jnp.arange(N, dtype=jnp.int32)
    vary0 = (top.sum() + side.sum()).astype(jnp.int32) * 0
    NEGc = jnp.int32(NEG_INF // 2)

    def boundary_gap(L):
        return -(op + (L - 1) * ex)

    M0 = jnp.where(j_idx == 0, jnp.int32(0), NEGc) + vary0
    IX0 = jnp.full((N,), NEGc, jnp.int32) + vary0
    IY0 = jnp.full((N,), NEGc, jnp.int32) + vary0
    negs = jnp.full((N,), NEGc, jnp.int32) + vary0

    def shift(v):
        return jnp.concatenate([jnp.full((1,), NEGc, jnp.int32), v[:-1]])

    def step(carry, kk):
        (Mp, IXp, IYp, Mp2, IXp2, IYp2, cap, cstate) = carry
        i_idx = kk - j_idx
        valid = (i_idx >= 0) & (i_idx <= A)
        interior = valid & (j_idx >= 1) & (i_idx >= 1)

        ch_top = jax.lax.dynamic_slice(top_ext, (N + A - kk,), (N,))
        sub = jnp.where(ch_top == side_sh, m, -k)

        Ms, IXs, IYs = shift(Mp2), shift(IXp2), shift(IYp2)
        best_p2 = jnp.maximum(jnp.maximum(Ms, IXs), IYs)
        M = best_p2 + sub
        # M pred state, priority M > IX > IY on ties
        mpred = jnp.where(Ms >= best_p2, 0, jnp.where(IXs >= IYs, 1, 2))

        cand_open_x = Mp - op
        cand_ext_x = IXp - ex
        IX = jnp.maximum(cand_open_x, cand_ext_x)
        ixext = cand_ext_x > cand_open_x  # ties open (pred M)

        Mps, IYps = shift(Mp), shift(IYp)
        cand_open_y = Mps - op
        cand_ext_y = IYps - ex
        IY = jnp.maximum(cand_open_y, cand_ext_y)
        iyext = cand_ext_y > cand_open_y

        bits = (
            mpred + (ixext.astype(jnp.int32) << 2) + (iyext.astype(jnp.int32) << 3)
        ).astype(jnp.uint8)

        M = jnp.where(interior, M, NEGc)
        IX = jnp.where(interior, IX, NEGc)
        IY = jnp.where(interior, IY, NEGc)
        on_top = valid & (j_idx == 0)
        on_left = valid & (i_idx == 0)
        IX = jnp.where(on_top, boundary_gap(kk), IX)
        IY = jnp.where(on_left, boundary_gap(kk), IY)

        best = jnp.maximum(jnp.maximum(M, IX), IY)
        state = jnp.where(M >= best, 0, jnp.where(IX >= IY, 1, 2))
        at_corner = kk == len1 + len2
        cap = jnp.where(
            at_corner, jax.lax.dynamic_index_in_dim(best, len2, keepdims=False), cap
        )
        cstate = jnp.where(
            at_corner,
            jax.lax.dynamic_index_in_dim(state, len2, keepdims=False),
            cstate,
        )
        return (M, IX, IY, Mp, IXp, IYp, cap, cstate), bits

    cap0 = jnp.int32(0) + vary0
    st0 = jnp.int32(0) + vary0
    ks = jnp.arange(1, K, dtype=jnp.int32)
    (_, _, _, _, _, _, cap, cstate), bits_tail = jax.lax.scan(
        step, (M0, IX0, IY0, negs, negs, negs, cap0, st0), ks
    )
    bits0 = jnp.zeros((1, N), jnp.uint8) + bits_tail[:1] * 0
    return {
        "score": cap,
        "state": cstate,
        "arrows": jnp.concatenate([bits0, bits_tail]),
    }


GAP = ord("-")


def affine_traceback(bits_diag, state, top: bytes, side: bytes):
    """Host walk over :func:`affine_fill_arrows` bits -> (X, Y)."""
    import numpy as np

    bits = np.asarray(bits_diag)
    i, j = len(top), len(side)
    st = int(state)
    X, Y = bytearray(), bytearray()
    while i > 0 or j > 0:
        b = int(bits[i + j, j])
        if st == 0:  # M: consume both
            X.append(top[i - 1])
            Y.append(side[j - 1])
            i -= 1
            j -= 1
            st = b & 3
        elif st == 1:  # IX: consume top char
            X.append(top[i - 1])
            Y.append(GAP)
            i -= 1
            st = 1 if (b >> 2) & 1 else 0
        else:  # IY: consume side char
            X.append(GAP)
            Y.append(side[j - 1])
            j -= 1
            st = 2 if (b >> 3) & 1 else 0
    return bytes(X[::-1]), bytes(Y[::-1])


def affine_align(s1, s2, m: int, k: int, open_: int, extend: int):
    """One optimal affine-gap global alignment: (score, X, Y).

    Completes the reference's affine-gap wishlist (README:187-193) with
    actual aligned output, not just the score.  Gap runs cost
    ``open + (L-1) * extend``; tie-breaking prefers M > IX > IY and
    gap-open over gap-extend (there is no reference convention to
    match — the reference never implemented affine gaps).
    """
    from nw_tpu.ops.encode import encode

    s1b = s1.encode() if isinstance(s1, str) else bytes(s1)
    s2b = s2.encode() if isinstance(s2, str) else bytes(s2)
    out = affine_fill_arrows(
        jnp.asarray(encode(s1b)), jnp.asarray(encode(s2b)), m, k, open_, extend
    )
    X, Y = affine_traceback(out["arrows"], out["state"], s1b, s2b)
    return int(out["score"]), X, Y


def _norm(pairs):
    return [
        (a.encode() if isinstance(a, str) else bytes(a),
         b.encode() if isinstance(b, str) else bytes(b))
        for a, b in pairs
    ]


def affine_score_pairs(pairs, m: int, k: int, open_: int, extend: int):
    """Optimal affine-gap score per pair (int32[B]), variable lengths:
    the scan fill vmapped over the length-bucketed batch in one
    dispatch (score-only, so no per-cell state is stored)."""
    import numpy as np

    from nw_tpu.ops.encode import encode_batch_u8

    tops, sides, l1, l2 = encode_batch_u8(_norm(pairs))
    return np.asarray(
        affine_score_batch(
            tops, sides, m, k, open_, extend, jnp.asarray(l1), jnp.asarray(l2)
        )
    )


@functools.partial(jax.jit, static_argnames=("max_steps",))
def _affine_walk(bits, state0, l1, l2, max_steps: int):
    """Device walk over :func:`affine_fill_arrows` bits (one pair): the
    jitted counterpart of :func:`affine_traceback`, emitting traceback.py
    op codes (M->OP_DIAG, IX->OP_LEFT, IY->OP_UP) corner -> origin."""

    def step(t, st):
        i, j, s, n, ops = st
        active = (i > 0) | (j > 0)
        b = bits[i + j, j].astype(jnp.int32)
        is_m = s == 0
        is_ix = s == 1
        op = jnp.where(is_m, 0, jnp.where(is_ix, 1, 2)).astype(jnp.int8)
        ops = ops.at[t].set(jnp.where(active, op, jnp.int8(3)))
        di = jnp.where(is_m | is_ix, 1, 0)
        dj = jnp.where(is_ix, 0, 1)
        ns = jnp.where(
            is_m, b & 3,
            jnp.where(
                is_ix,
                jnp.where((b >> 2) & 1, 1, 0),
                jnp.where((b >> 3) & 1, 2, 0),
            ),
        )
        i = jnp.where(active, i - di, i)
        j = jnp.where(active, j - dj, j)
        s = jnp.where(active, ns, s)
        n = n + active.astype(jnp.int32)
        return (i, j, s, n, ops)

    ops0 = jnp.full((max_steps,), 3, jnp.int8)
    _, _, _, n, ops = jax.lax.fori_loop(
        0, max_steps, step,
        (jnp.asarray(l1, jnp.int32), jnp.asarray(l2, jnp.int32),
         jnp.asarray(state0, jnp.int32), jnp.int32(0), ops0),
    )
    return ops, n


_affine_fill_batch = jax.jit(
    jax.vmap(affine_fill_arrows, in_axes=(0, 0, None, None, None, None, 0, 0))
)


@functools.lru_cache(maxsize=None)
def _affine_walk_vmapped(max_steps: int):
    """Cached jitted batched walk (a fresh jax.jit per call recompiles
    every invocation)."""
    return jax.jit(
        jax.vmap(
            lambda w, s, a1, a2: _affine_walk(w, s, a1, a2, max_steps=max_steps),
            in_axes=(0, 0, 0, 0),
        )
    )


def affine_align_batch(pairs, m: int, k: int, open_: int, extend: int):
    """Batched affine-gap alignment: one (score, X, Y) per pair.

    The vmapped Gotoh fill emits per-cell state bits for a sub-batch, a
    vmapped device walk follows them; identical tie conventions to
    :func:`affine_align` (M > IX > IY, open over extend).  Sub-batches
    are sized to :func:`nw_tpu.ops.fill_auto.arrow_budget_bytes`.
    """
    from nw_tpu.ops.fill_auto import chunked

    return chunked(
        _norm(pairs),
        lambda sub: _affine_align_bucket(sub, m, k, open_, extend),
    )


def _affine_align_bucket(norm, m, k, open_, extend):
    from nw_tpu.ops.encode import encode_batch_u8
    from nw_tpu.ops.traceback import ops_to_strings_batch

    tops, sides, l1, l2 = encode_batch_u8(norm)
    l1j, l2j = jnp.asarray(l1), jnp.asarray(l2)
    out = _affine_fill_batch(tops, sides, m, k, open_, extend, l1j, l2j)
    max_steps = max(1, int(tops.shape[1] + sides.shape[1]))
    ops, n = _affine_walk_vmapped(max_steps)(out["arrows"], out["state"], l1j, l2j)
    best, ops, n = jax.device_get((out["score"], ops, n))
    strs = ops_to_strings_batch(ops, n, norm)
    return [(int(best[b]), X, Y) for b, (X, Y) in enumerate(strs)]
