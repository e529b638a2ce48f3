"""Smith-Waterman local alignment (reference FUTURE WORK, README:179-186).

Same anti-diagonal wavefront machinery as the global fill
(:mod:`nw_tpu.ops.fill_scan`), with the local-alignment recurrence:
scores clamp at zero, the result is the maximum over *all* cells, and
traceback starts at that argmax and stops at the first zero cell.

Arrow bits reuse the global encoding (DIAG=1, LEFT=2, UP=4); a cell
whose best is the zero-clamp gets no arrows (it is a local-alignment
start point).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nw_tpu.ops.fill_scan import NEG_INF


@functools.partial(jax.jit, static_argnames=("with_arrows",))
def sw_fill_diag(top, side, m, k, d, len1=None, len2=None, with_arrows: bool = True):
    """Local-alignment fill along anti-diagonals.

    ``len1``/``len2`` are the true lengths of a padded pair (default:
    the array lengths); cells outside the true rectangle are zero and
    arrow-free, so padding never reaches the maximum.

    Returns dict with ``score`` (best local score, >= 0), ``argmax``
    (int32[2]: (j, i) cell of the maximum — first hit in diagonal order,
    lowest row index within a diagonal), and ``arrows`` uint8[K, N].
    """
    A = top.shape[0]
    B = side.shape[0]
    N = B + 1
    K = A + B + 1
    len1 = jnp.asarray(A if len1 is None else len1, jnp.int32)
    len2 = jnp.asarray(B if len2 is None else len2, jnp.int32)

    m = jnp.asarray(m, jnp.int32)
    k = jnp.asarray(k, jnp.int32)
    d = jnp.asarray(d, jnp.int32)

    side_sh = jnp.concatenate([jnp.full((1,), -3, jnp.int32), side.astype(jnp.int32)])
    top_rev = top[::-1].astype(jnp.int32)
    pad = jnp.full((N,), -4, jnp.int32)
    top_ext = jnp.concatenate([pad, top_rev, pad])

    j_idx = jnp.arange(N, dtype=jnp.int32)
    vary0 = (top.sum() + side.sum() + len1 + len2).astype(jnp.int32) * 0

    zeros = jnp.zeros((N,), jnp.int32) + vary0
    # row 0 / col 0 are all zero in SW; diagonal 0 likewise
    best0 = jnp.int32(0) + vary0
    arg0 = jnp.zeros((2,), jnp.int32) + vary0

    def step(carry, kk):
        prev, prev2, best, arg = carry
        i_idx = kk - j_idx
        interior = (
            (j_idx >= 1) & (j_idx <= len2) & (i_idx >= 1) & (i_idx <= len1)
        )

        ch_top = jax.lax.dynamic_slice(top_ext, (N + A - kk,), (N,))
        sub = jnp.where(ch_top == side_sh, m, -k)

        prev_sh = jnp.concatenate([jnp.full((1,), NEG_INF, jnp.int32), prev[:-1]])
        prev2_sh = jnp.concatenate([jnp.full((1,), NEG_INF, jnp.int32), prev2[:-1]])

        cand_d = prev2_sh + sub
        cand_u = prev_sh - d
        cand_l = prev - d
        score = jnp.maximum(
            jnp.maximum(jnp.maximum(cand_d, cand_u), cand_l), 0
        )
        arrows = (
            ((cand_d == score) & (score > 0)).astype(jnp.uint8)
            | (((cand_l == score) & (score > 0)).astype(jnp.uint8) << 1)
            | (((cand_u == score) & (score > 0)).astype(jnp.uint8) << 2)
        )
        score = jnp.where(interior, score, 0)
        arrows = jnp.where(interior, arrows, jnp.uint8(0))

        # running max; first diagonal wins ties, then lowest row index
        diag_best = jnp.max(score)
        diag_row = jnp.argmax(score).astype(jnp.int32)
        take = diag_best > best
        best = jnp.where(take, diag_best, best)
        arg = jnp.where(take, jnp.stack([diag_row, kk - diag_row]), arg)

        return (score, prev, best, arg), arrows

    ks = jnp.arange(1, K, dtype=jnp.int32)
    (prev, _, best, arg), arrows_tail = jax.lax.scan(
        step, (zeros, zeros, best0, arg0), ks
    )
    out = {"score": best, "argmax": arg}
    if with_arrows:
        out["arrows"] = jnp.concatenate([jnp.zeros((1, N), jnp.uint8), arrows_tail])
    return out


# ragged batched fills (padded to a bucket; lens mask the table)
sw_scores_scan_batch = jax.jit(
    jax.vmap(
        lambda t, s, m, k, d, l1, l2: sw_fill_diag(
            t, s, m, k, d, l1, l2, with_arrows=False
        )["score"],
        in_axes=(0, 0, None, None, None, 0, 0),
    )
)

_sw_fill_batch = jax.jit(
    jax.vmap(
        lambda t, s, m, k, d, l1, l2: sw_fill_diag(t, s, m, k, d, l1, l2),
        in_axes=(0, 0, None, None, None, 0, 0),
    )
)


def sw_traceback(arrows_diag: np.ndarray, argmax, top: bytes, side: bytes) -> Tuple[bytes, bytes, Tuple[int, int]]:
    """Host traceback for one local alignment: greedy diag > left > up
    from the argmax cell until a cell with no arrows (score 0).

    Returns (X, Y, (j_start, i_start)) — the aligned substrings and the
    (row, col) cell where the local alignment begins.
    """
    arrows_diag = np.asarray(arrows_diag)
    j, i = (int(x) for x in np.asarray(argmax))
    X = bytearray()
    Y = bytearray()
    while True:
        a = int(arrows_diag[i + j, j])
        if a & 1:
            i -= 1
            j -= 1
            X.append(top[i])
            Y.append(side[j])
        elif a & 2:
            i -= 1
            X.append(top[i])
            Y.append(ord("-"))
        elif a & 4:
            j -= 1
            X.append(ord("-"))
            Y.append(side[j])
        else:
            break
    return bytes(X[::-1]), bytes(Y[::-1]), (j, i)


def sw_align(s1: str | bytes, s2: str | bytes, m: int = 2, k: int = 1, d: int = 1):
    """One-shot local alignment: (score, X, Y, start_cell)."""
    from nw_tpu.ops.encode import encode

    s1b = s1.encode() if isinstance(s1, str) else bytes(s1)
    s2b = s2.encode() if isinstance(s2, str) else bytes(s2)
    out = sw_fill_diag(encode(s1b), encode(s2b), m, k, d)
    X, Y, start = sw_traceback(out["arrows"], out["argmax"], s1b, s2b)
    return int(out["score"]), X, Y, start


def _norm(pairs):
    return [
        (a.encode() if isinstance(a, str) else bytes(a),
         b.encode() if isinstance(b, str) else bytes(b))
        for a, b in pairs
    ]


def sw_score_batch(pairs, m: int = 2, k: int = 1, d: int = 1):
    """Best local-alignment score per pair (int32[B]): the ragged scan
    fill vmapped over the batch in one dispatch (score-only, so no
    per-cell state is stored)."""
    from nw_tpu.ops.encode import encode_batch_u8

    tops, sides, l1, l2 = encode_batch_u8(_norm(pairs))
    return np.asarray(
        sw_scores_scan_batch(tops, sides, m, k, d, jnp.asarray(l1), jnp.asarray(l2))
    )


def sw_align_batch(pairs, m: int = 2, k: int = 1, d: int = 1):
    """Batched local alignment with strings: one (score, X, Y, start)
    per pair, identical to :func:`sw_align`.

    The vmapped scan fill emits diagonal-major uint8 arrows for a whole
    sub-batch, a vmapped device walk follows them, and the host only
    renders the byte strings; sub-batches are sized to
    :func:`nw_tpu.ops.fill_auto.arrow_budget_bytes`.
    """
    from nw_tpu.ops.fill_auto import chunked

    return chunked(_norm(pairs), lambda sub: _sw_align_bucket(sub, m, k, d))


def _sw_align_bucket(norm, m, k, d):
    from nw_tpu.ops.encode import encode_batch_u8
    from nw_tpu.ops.traceback import ops_to_strings_batch, walk_until_zero_batch

    tops, sides, l1, l2 = encode_batch_u8(norm)
    out = _sw_fill_batch(tops, sides, m, k, d, jnp.asarray(l1), jnp.asarray(l2))
    arg = out["argmax"]
    max_steps = max(1, int(tops.shape[1] + sides.shape[1]))
    ops, n, i_st, j_st = walk_until_zero_batch(
        out["arrows"], arg[:, 0], arg[:, 1], max_steps
    )
    best, arg, ops, n, i_st, j_st = jax.device_get(
        (out["score"], arg, ops, n, i_st, j_st)
    )
    trunc = [
        (s1[: int(arg[b, 1])], s2[: int(arg[b, 0])])
        for b, (s1, s2) in enumerate(norm)
    ]
    strs = ops_to_strings_batch(ops, n, trunc)
    return [
        (int(best[b]), X, Y, (int(j_st[b]), int(i_st[b])))
        for b, (X, Y) in enumerate(strs)
    ]
