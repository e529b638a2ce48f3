"""Vectorized single-path traceback on device.

The reference's walk (needleman-wunsch.c:209-331) is a host DFS that
enumerates *all* optimal alignments.  When only one optimal alignment per
pair is needed (the common production case for large batches), the walk is
a deterministic backward scan: start at the true bottom-right corner and
repeatedly follow the highest-priority arrow, with the same diag > left >
up priority the reference DFS descends with (needleman-wunsch.c:305-324)
— so the path produced here is exactly the *first* alignment the
reference emits.

Works directly on the diagonal-major arrow layout (cell (j, i) lives at
``D[i + j, j]``), runs as a ``lax.while_loop``-free fixed-trip
``fori_loop`` (static bound = len1 + len2 steps, masked when done), and is
``vmap``-friendly for batches.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# op codes emitted per step (order matters: reference DFS descend
# priority).  numpy scalars, NOT jnp: module-scope jnp constants
# initialize the XLA backend at import time, which breaks
# jax.distributed.initialize in multi-process programs.
import numpy as _np

OP_DIAG = _np.int8(0)
OP_LEFT = _np.int8(1)
OP_UP = _np.int8(2)
OP_NONE = _np.int8(3)


@functools.partial(jax.jit, static_argnames=("max_steps",))
def traceback_greedy(arrows_diag, len1, len2, max_steps: int):
    """Greedy (first-alignment) backward walk over one pair's arrows.

    Args:
      arrows_diag: uint8[K, N] diagonal-major arrows.
      len1, len2: true sequence lengths (int32 scalars; the walk starts at
        cell (len2, len1), cf. construct_alignments, needleman-wunsch.c:376).
      max_steps: static trip count; must be >= len1 + len2.

    Returns:
      ops: int8[max_steps] — op codes in walk order (corner -> origin),
        padded with OP_NONE.
      n: int32 — number of real ops (= aligned string length).
    """
    def step(t, state):
        i, j, n, ops = state
        active = (i > 0) | (j > 0)
        a = arrows_diag[i + j, j]
        take_diag = (a & 1) != 0
        take_left = jnp.logical_and(~take_diag, (a & 2) != 0)
        take_up = jnp.logical_and(~(take_diag | take_left), (a & 4) != 0)

        op = jnp.where(
            take_diag, OP_DIAG, jnp.where(take_left, OP_LEFT, OP_UP)
        ).astype(jnp.int8)
        di = jnp.where(take_diag | take_left, 1, 0)
        dj = jnp.where(take_diag | take_up, 1, 0)

        ops = ops.at[t].set(jnp.where(active, op, OP_NONE))
        i = jnp.where(active, i - di, i)
        j = jnp.where(active, j - dj, j)
        n = n + jnp.where(active, 1, 0)
        return (i, j, n, ops)

    ops0 = jnp.full((max_steps,), OP_NONE, jnp.int8)
    i0 = jnp.asarray(len1, jnp.int32)
    j0 = jnp.asarray(len2, jnp.int32)
    _, _, n, ops = jax.lax.fori_loop(0, max_steps, step, (i0, j0, jnp.int32(0), ops0))
    return ops, n


@functools.partial(jax.jit, static_argnames=("max_steps",))
def traceback_greedy2_rowmajor(words, len1, len2, max_steps: int):
    """Greedy walk over ROW-MAJOR 2-bit greedy words.

    ``words``: int32[L1w, W16] from
    :func:`nw_tpu.ops.fill_rows.fill_rows_batch` (``with_words``) —
    cell (i, j) (i over s1 rows 1..len1, j over s2 columns) is bits
    ``2 * (j & 15)`` of ``words[i - 1, j >> 4]``; the code IS the op
    (0 diag / 1 left / 2 up, reference descend priority,
    needleman-wunsch.c:305-324).  Row i = 0 is not stored: the only
    move there consumes s2, i.e. OP_UP.
    """

    def step(t, state):
        i, j, n, ops = state
        active = (i > 0) | (j > 0)
        stored = (
            words[jnp.maximum(i - 1, 0), j >> 4] >> ((j & 15) * 2)
        ) & 3
        a = jnp.where(i == 0, jnp.int32(OP_UP), stored)
        di = jnp.where(a != OP_UP, 1, 0)
        dj = jnp.where(a != OP_LEFT, 1, 0)
        ops = ops.at[t].set(
            jnp.where(active, a, jnp.int32(OP_NONE)).astype(jnp.int8)
        )
        i = jnp.where(active, i - di, i)
        j = jnp.where(active, j - dj, j)
        n = n + jnp.where(active, 1, 0)
        return (i, j, n, ops)

    ops0 = jnp.full((max_steps,), OP_NONE, jnp.int8)
    i0 = jnp.asarray(len1, jnp.int32)
    j0 = jnp.asarray(len2, jnp.int32)
    _, _, n, ops = jax.lax.fori_loop(
        0, max_steps, step, (i0, j0, jnp.int32(0), ops0)
    )
    return ops, n


@functools.lru_cache(maxsize=None)
def _greedy2_rowmajor_batch_vmapped(max_steps: int):
    return jax.jit(
        jax.vmap(
            lambda a, l1, l2: traceback_greedy2_rowmajor(
                a, l1, l2, max_steps
            ),
            in_axes=(2, 0, 0),
        )
    )


def traceback_greedy2_rowmajor_batch(words, lens1, lens2, max_steps: int):
    """Batched row-major 2-bit greedy traceback: words int32[L1w, W16, B]."""
    return _greedy2_rowmajor_batch_vmapped(max_steps)(words, lens1, lens2)


@functools.lru_cache(maxsize=None)
def _greedy_batch_vmapped(max_steps: int, axis: int):
    # cached: a fresh jax.jit wrapper per call would recompile every time
    return jax.jit(
        jax.vmap(
            lambda a, l1, l2: traceback_greedy(a, l1, l2, max_steps),
            in_axes=(axis, 0, 0),
        )
    )


def traceback_greedy_batch(arrows_diag, lens1, lens2, max_steps: int, axis: int = 0):
    """Batched greedy traceback: arrows_diag uint8[B, K, N] (or [K, B, N]
    with ``axis=1``)."""
    return _greedy_batch_vmapped(max_steps, axis)(arrows_diag, lens1, lens2)


@functools.partial(jax.jit, static_argnames=("max_steps",))
def walk_until_zero(arrows_diag, j0, i0, max_steps: int):
    """Greedy diag > left > up walk from cell (j0, i0) over uint8
    diagonal-major arrows until row 0, column 0 or an arrow-free cell —
    the local (Smith-Waterman) and overlap tracebacks, whose start cells
    carry no arrows.  Returns (ops, n, i, j): ops corner -> start in
    :func:`ops_to_strings` order, and the cell where the walk stopped."""

    def step(t, st):
        i, j, n, ops, done = st
        a = arrows_diag[i + j, j]
        active = ~done & (i > 0) & (j > 0) & (a != 0)
        take_diag = active & ((a & 1) != 0)
        take_left = active & ~take_diag & ((a & 2) != 0)
        op = jnp.where(
            take_diag, OP_DIAG, jnp.where(take_left, OP_LEFT, OP_UP)
        ).astype(jnp.int8)
        ops = ops.at[t].set(jnp.where(active, op, OP_NONE))
        i = i - jnp.where(take_diag | take_left, 1, 0)
        j = j - jnp.where(active & ~take_left, 1, 0)
        n = n + active.astype(jnp.int32)
        return (i, j, n, ops, ~active | done)

    ops0 = jnp.full((max_steps,), OP_NONE, jnp.int8)
    i, j, n, ops, _ = jax.lax.fori_loop(
        0, max_steps, step,
        (jnp.asarray(i0, jnp.int32), jnp.asarray(j0, jnp.int32),
         jnp.int32(0), ops0, jnp.asarray(False)),
    )
    return ops, n, i, j


@functools.lru_cache(maxsize=None)
def _walk_until_zero_vmapped(max_steps: int):
    return jax.jit(
        jax.vmap(
            lambda a, j0, i0: walk_until_zero(a, j0, i0, max_steps),
            in_axes=(0, 0, 0),
        )
    )


def walk_until_zero_batch(arrows_diag, j0, i0, max_steps: int):
    """Batched :func:`walk_until_zero`: arrows_diag uint8[B, K, N]."""
    return _walk_until_zero_vmapped(max_steps)(arrows_diag, j0, i0)


def ops_to_strings_batch(ops, ns, pairs, gap: int = ord("-")):
    """Host: vectorized batched version of :func:`ops_to_strings`.

    ops: int8[B, S] walk op codes (corner -> origin); ns: int32[B];
    pairs: sequence of (s1 bytes, s2 bytes).  Returns a list of (X, Y)
    aligned byte strings.  Takes the native one-pass builder
    (runtime/cc/nwstrings.cc) when available — the numpy fallback
    below does ~10 full passes over the ops matrix and dominated the
    e2e host tail at 4k x 150 bp (58 ms vs ~4 ms native).
    """
    import numpy as np

    from nw_tpu.runtime import native

    rt = native.load()
    if rt is not None:
        return rt.ops_to_strings_batch(ops, ns, pairs, gap)

    ops = np.asarray(ops)
    ns = np.asarray(ns)
    B, S = ops.shape
    if B == 0:
        return []
    l1 = np.array([len(a) for a, _ in pairs], np.int32)
    l2 = np.array([len(b) for _, b in pairs], np.int32)
    col = np.arange(S, dtype=np.int32)[None, :]
    valid = col < ns[:, None]
    # plain ints, NOT the jnp OP_* scalars: comparing a numpy array
    # against a jax scalar silently dispatches the whole expression to
    # the device (a compile + 2 transfers per call)
    take1 = (ops != int(OP_UP)) & valid  # diag/left consume an s1 char
    take2 = (ops != int(OP_LEFT)) & valid  # diag/up consume an s2 char
    # index of the consumed char: lengths minus running consumption
    i_idx = l1[:, None] - np.cumsum(take1, axis=1, dtype=np.int32)
    j_idx = l2[:, None] - np.cumsum(take2, axis=1, dtype=np.int32)
    # padded char matrices (batch scatter, as in encode._scatter_encode)
    s1m = np.full((B, max(int(l1.max()), 1)), gap, np.uint8)
    s2m = np.full((B, max(int(l2.max()), 1)), gap, np.uint8)
    m1 = np.arange(s1m.shape[1], dtype=np.int32)[None, :] < l1[:, None]
    m2 = np.arange(s2m.shape[1], dtype=np.int32)[None, :] < l2[:, None]
    if l1.sum():
        s1m[m1] = np.frombuffer(b"".join(a for a, _ in pairs), np.uint8)
    if l2.sum():
        s2m[m2] = np.frombuffer(b"".join(b for _, b in pairs), np.uint8)
    rows = np.arange(B)[:, None]
    X = np.where(
        take1, s1m[rows, np.clip(i_idx, 0, s1m.shape[1] - 1)], np.uint8(gap)
    )
    Y = np.where(
        take2, s2m[rows, np.clip(j_idx, 0, s2m.shape[1] - 1)], np.uint8(gap)
    )
    result = []
    for b in range(B):
        n = int(ns[b])
        result.append((X[b, :n][::-1].tobytes(), Y[b, :n][::-1].tobytes()))
    return result


def ops_to_strings(ops, n, s1: bytes, s2: bytes, gap: int = ord("-")):
    """Host: materialize (X, Y) aligned byte strings from walk ops.

    The walk runs corner -> origin, consuming characters from the ends of
    the sequences; the reference prints its buffers back-to-front
    (needleman-wunsch.c:149), i.e. origin -> corner, so we reverse.
    """
    import numpy as np

    ops = np.asarray(ops)[: int(n)]
    X = bytearray()
    Y = bytearray()
    i, j = len(s1), len(s2)
    for op in ops:
        if op == 0:  # diag
            i -= 1
            j -= 1
            X.append(s1[i])
            Y.append(s2[j])
        elif op == 1:  # left
            i -= 1
            X.append(s1[i])
            Y.append(gap)
        else:  # up
            j -= 1
            X.append(gap)
            Y.append(s2[j])
    return bytes(X[::-1]), bytes(Y[::-1])
