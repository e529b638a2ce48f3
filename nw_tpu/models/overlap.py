"""Overlap (semi-global, end-gap-free) alignment — the third of the
reference's "three classic sequence alignment algorithms" (FUTURE WORK,
README:182-187; only NW ships, SW/overlap are wishlist).

Recurrence: Needleman-Wunsch's interior recurrence with FREE end gaps —
row 0 and column 0 are all zero (leading gaps in either sequence cost
nothing) and the result is the maximum over the LAST row and LAST
column (trailing gaps cost nothing).  The traceback starts at that
boundary argmax and stops on reaching row 0 or column 0; the aligned
strings cover only the overlapping segment, with the start/end cells
reported so callers can reconstruct the full end-gapped layout.

Scores never clamp at zero (unlike Smith-Waterman) but the overlap
score is always >= 0: the last row/column contain the zero-cost cells
(M, 0) and (0, N).

Tie rules (new surface — no reference semantics to match; fixed here
so every engine agrees): the trivial zero-cost corner — (len1, 0), or
(0, len2) when len1 == 0 — seeds the argmax, and an end-boundary cell
replaces it only with a STRICTLY greater score; so a best score of 0
always reports the empty overlap at that corner.  Among positive
maxima the argmax takes the FIRST in anti-diagonal order, lowest row
index within a diagonal (the Smith-Waterman rule,
smith_waterman.sw_fill_diag); the walk descends diag > left > up (the
DFS order of needleman-wunsch.c:305-324).

Arrow bits reuse the global encoding (DIAG=1, LEFT=2, UP=4,
needleman-wunsch.c:485-503); boundary cells get no arrows (they are
walk stop cells).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nw_tpu.ops.fill_scan import NEG_INF

@functools.partial(jax.jit, static_argnames=("with_arrows",))
def overlap_fill_diag(
    top, side, m, k, d, len1=None, len2=None, with_arrows: bool = True
):
    """Overlap-alignment fill along anti-diagonals (one pair, possibly
    padded — ``len1``/``len2`` are the true lengths; padding cannot
    contaminate the true rectangle because the recurrence only reads
    smaller indices, and the end-boundary argmax is masked to it).

    Returns dict with ``score`` (best end-gap-free score, >= 0),
    ``argmax`` (int32[2]: (j, i) boundary cell of the maximum) and
    ``arrows`` uint8[K, N] in the diagonal-major layout of
    smith_waterman.sw_fill_diag.
    """
    A = top.shape[0]
    B = side.shape[0]
    N = B + 1
    K = A + B + 1

    if len1 is None:
        len1 = A
    if len2 is None:
        len2 = B
    len1 = jnp.asarray(len1, jnp.int32)
    len2 = jnp.asarray(len2, jnp.int32)

    m = jnp.asarray(m, jnp.int32)
    k = jnp.asarray(k, jnp.int32)
    d = jnp.asarray(d, jnp.int32)

    side_sh = jnp.concatenate(
        [jnp.full((1,), -3, jnp.int32), side.astype(jnp.int32)]
    )
    top_rev = top[::-1].astype(jnp.int32)
    pad = jnp.full((N,), -4, jnp.int32)
    top_ext = jnp.concatenate([pad, top_rev, pad])

    j_idx = jnp.arange(N, dtype=jnp.int32)
    vary0 = (top.sum() + side.sum() + len1 + len2).astype(jnp.int32) * 0

    # diagonal 0 = cell (0, 0) = 0; every other slot does not exist
    prev0 = jnp.where(j_idx == 0, 0, NEG_INF).astype(jnp.int32) + vary0
    neg = jnp.full((N,), NEG_INF, jnp.int32) + vary0
    # (len1, 0) and (0, len2) are always reachable at zero cost
    best0 = jnp.int32(0) + vary0
    arg0 = jnp.where(
        len1 == 0,
        jnp.stack([len2, jnp.int32(0)]),
        jnp.stack([jnp.int32(0), len1]),
    ) + vary0

    def step(carry, kk):
        prev, prev2, best, arg = carry
        i_idx = kk - j_idx
        valid = (i_idx >= 0) & (i_idx <= A)
        interior = valid & (j_idx >= 1) & (i_idx >= 1)

        ch_top = jax.lax.dynamic_slice(top_ext, (N + A - kk,), (N,))
        sub = jnp.where(ch_top == side_sh, m, -k)

        prev_sh = jnp.concatenate(
            [jnp.full((1,), NEG_INF, jnp.int32), prev[:-1]]
        )
        prev2_sh = jnp.concatenate(
            [jnp.full((1,), NEG_INF, jnp.int32), prev2[:-1]]
        )

        cand_d = prev2_sh + sub
        cand_u = prev_sh - d  # from (i, j-1): consumes side
        cand_l = prev - d  # from (i-1, j): consumes top
        score = jnp.maximum(jnp.maximum(cand_d, cand_u), cand_l)
        arrows = (
            (cand_d == score).astype(jnp.uint8)
            | ((cand_l == score).astype(jnp.uint8) << 1)
            | ((cand_u == score).astype(jnp.uint8) << 2)
        )
        # free boundaries: row 0 / col 0 are zero, no arrows
        score = jnp.where(interior, score, jnp.where(valid, 0, NEG_INF))
        arrows = jnp.where(interior, arrows, jnp.uint8(0))

        # running max over the END boundary (last TRUE row or column)
        on_end = (
            interior
            & ((i_idx == len1) | (j_idx == len2))
            & (i_idx <= len1)
            & (j_idx <= len2)
        )
        masked = jnp.where(on_end, score, NEG_INF)
        diag_best = jnp.max(masked)
        diag_row = jnp.argmax(masked).astype(jnp.int32)
        take = diag_best > best
        best = jnp.where(take, diag_best, best)
        arg = jnp.where(take, jnp.stack([diag_row, kk - diag_row]), arg)

        return (score, prev, best, arg), arrows

    ks = jnp.arange(1, K, dtype=jnp.int32)
    (prev, _, best, arg), arrows_tail = jax.lax.scan(
        step, (prev0, neg, best0, arg0), ks
    )
    out = {"score": best, "argmax": arg}
    if with_arrows:
        out["arrows"] = jnp.concatenate(
            [jnp.zeros((1, N), jnp.uint8), arrows_tail]
        )
    return out


# ragged batched fills (padded to a bucket; lens mask the argmax) —
# any side length, pure XLA scan, no per-shape recompiles
overlap_scores_scan_batch = jax.jit(
    jax.vmap(
        lambda t, s, m, k, d, l1, l2: overlap_fill_diag(
            t, s, m, k, d, l1, l2, with_arrows=False
        )["score"],
        in_axes=(0, 0, None, None, None, 0, 0),
    )
)

_overlap_fill_batch = jax.jit(
    jax.vmap(
        lambda t, s, m, k, d, l1, l2: overlap_fill_diag(
            t, s, m, k, d, l1, l2, with_arrows=True
        ),
        in_axes=(0, 0, None, None, None, 0, 0),
    )
)


def overlap_traceback(
    arrows_diag: np.ndarray, argmax, top: bytes, side: bytes
) -> Tuple[bytes, bytes, Tuple[int, int]]:
    """Host traceback for one overlap alignment: greedy diag > left > up
    from the boundary argmax until row 0 or column 0.

    Returns (X, Y, (j_start, i_start)) — the aligned overlap segment
    and the (row, col) cell where it begins (j indexes ``side`` = s2,
    the table's row axis; same layout as sw_traceback's).
    """
    arrows_diag = np.asarray(arrows_diag)
    j, i = (int(x) for x in np.asarray(argmax))
    X = bytearray()
    Y = bytearray()
    while i > 0 and j > 0:
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
        else:  # boundary cell reached exactly
            break
    return bytes(X[::-1]), bytes(Y[::-1]), (j, i)


def overlap_align(
    s1: str | bytes, s2: str | bytes, m: int = 2, k: int = 1, d: int = 1
):
    """One-shot overlap alignment: (score, X, Y, start_cell, end_cell).

    ``start_cell``/``end_cell`` are (j, i) table coordinates — j
    indexes s2 (the row axis), i indexes s1 — the walk runs
    end -> start; s1[start_i:end_i] and s2[start_j:end_j] are the
    overlapped substrings.
    """
    from nw_tpu.ops.encode import encode

    s1b = s1.encode() if isinstance(s1, str) else bytes(s1)
    s2b = s2.encode() if isinstance(s2, str) else bytes(s2)
    out = overlap_fill_diag(encode(s1b), encode(s2b), m, k, d)
    X, Y, start = overlap_traceback(out["arrows"], out["argmax"], s1b, s2b)
    j_end, i_end = (int(x) for x in np.asarray(out["argmax"]))
    return int(out["score"]), X, Y, start, (j_end, i_end)


def _norm(pairs):
    return [
        (a.encode() if isinstance(a, str) else bytes(a),
         b.encode() if isinstance(b, str) else bytes(b))
        for a, b in pairs
    ]


def overlap_score_batch(pairs, m: int = 2, k: int = 1, d: int = 1):
    """Best overlap score per pair (int32[B]): the vmapped ragged scan
    fill (one compile per padded bucket, no per-pair cliff; score-only,
    so no per-cell state is stored)."""
    from nw_tpu.ops.encode import encode_batch_u8

    tops, sides, l1, l2 = encode_batch_u8(_norm(pairs))
    return np.asarray(
        overlap_scores_scan_batch(
            tops, sides, m, k, d, jnp.asarray(l1), jnp.asarray(l2)
        )
    )


def overlap_align_batch(pairs, m: int = 2, k: int = 1, d: int = 1):
    """Batched overlap alignment with strings: one
    (score, X, Y, start, end) per pair, identical to
    :func:`overlap_align` (scan tie rules).

    Batched fill + vmapped device walk (one compile per padded bucket);
    host only renders the byte strings through the native batch
    builder.  The batched fill materializes diagonal-major uint8 arrows
    (B, K, N) — ~200 MB per 10 kb pair — so batches are split into
    sub-batches whose arrows fit
    :func:`nw_tpu.ops.fill_auto.arrow_budget_bytes`."""
    from nw_tpu.ops.fill_auto import chunked

    return chunked(
        _norm(pairs), lambda sub: _overlap_align_bucket(sub, m, k, d)
    )


def _overlap_align_bucket(norm, m, k, d):
    """One memory-sized sub-batch of overlap alignments (see
    overlap_align_batch)."""
    from nw_tpu.ops.encode import encode_batch_u8
    from nw_tpu.ops.traceback import ops_to_strings_batch, walk_until_zero_batch

    # uint8 upload: the fill casts on device and all outputs are
    # lens-gated (tests/test_encode_u8.py)
    tops, sides, l1, l2 = encode_batch_u8(norm)
    out = _overlap_fill_batch(
        tops, sides, m, k, d, jnp.asarray(l1), jnp.asarray(l2)
    )
    max_steps = int(tops.shape[1] + sides.shape[1])
    if max_steps == 0:
        return [(0, b"", b"", (0, 0), (0, 0)) for _ in norm]
    arg = out["argmax"]
    ops, n, i_st, j_st = walk_until_zero_batch(
        out["arrows"], arg[:, 0], arg[:, 1], max_steps
    )
    best, arg, ops, n, i_st, j_st = jax.device_get(
        (out["score"], arg, ops, n, i_st, j_st)
    )
    j_end, i_end = arg[:, 0], arg[:, 1]
    trunc = [
        (s1[: int(i_end[b])], s2[: int(j_end[b])])
        for b, (s1, s2) in enumerate(norm)
    ]
    strs = ops_to_strings_batch(ops, n, trunc)
    return [
        (int(best[b]), X, Y, (int(j_st[b]), int(i_st[b])),
         (int(j_end[b]), int(i_end[b])))
        for b, (X, Y) in enumerate(strs)
    ]
