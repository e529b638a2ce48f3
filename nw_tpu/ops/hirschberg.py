"""Hirschberg linear-space optimal alignment for huge pairs.

The reference can only trace back by materializing 32 B of walk state
per cell (walk-table.h:48-57) — 13.6 GB for one 10k x 10k pair
(BASELINE.md).  For 100 kb+ pairs even 1-byte packed arrows outgrow HBM
(10^10 cells).  Hirschberg's divide-and-conquer needs only the DP row at
the split line: align(s1, s2) splits s2 at h = len2//2, computes the
forward last-row of (s1, s2[:h]) and the backward last-row of
(reversed(s1), reversed(s2[h:])), picks the column where their sum is
maximal, and recurses on the two halves.  Total work is ~2x one fill;
memory is O(len1 + len2).

The row fills run on device (:func:`nw_tpu.ops.fill_scan.fill_last_row`)
with power-of-two length buckets so the recursion reuses compiled
shapes; tiny subproblems drop to a host DP to avoid device round-trips.

The produced alignment is *an* optimal alignment (score-verified in
tests against the full fill and membership-checked against the complete
enumeration); it is not guaranteed to be the reference DFS's
first-emitted one.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from nw_tpu.ops.fill_scan import fill_last_row

_HOST_CELLS = 16384  # subproblems at most this many cells run on host
GAP = ord("-")


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


def _device_last_row(top: np.ndarray, side: np.ndarray, m, k, d) -> np.ndarray:
    """H[len(side), 0..len(top)] on device (:func:`fill_last_row`),
    bucket-padded so the recursion reuses compiled shapes."""
    import jax.numpy as jnp

    A, B = top.shape[0], side.shape[0]
    Ab, Bb = _bucket(A), _bucket(B)
    tp = np.full((Ab,), -1, np.int32)
    tp[:A] = top
    sp = np.full((Bb,), -2, np.int32)
    sp[:B] = side
    row = fill_last_row(jnp.asarray(tp), jnp.asarray(sp), m, k, d, A, B)
    return np.asarray(row)[: A + 1]


def _host_last_row(top: np.ndarray, side: np.ndarray, m, k, d) -> np.ndarray:
    """Row DP on host for small subproblems (int32 wraparound like C)."""
    A, B = top.shape[0], side.shape[0]
    with np.errstate(over="ignore"):
        row = (-d * np.arange(A + 1, dtype=np.int64)).astype(np.int32)
        for j in range(1, B + 1):
            sub = np.where(top == side[j - 1], m, -k).astype(np.int32)
            cand = np.maximum(row[:-1] + sub, row[1:] - d)  # diag, up
            new = np.empty_like(row)
            new[0] = -j * d
            # left-dependency: new[i] = max(cand[i-1], new[i-1] - d)
            acc = new[0]
            for i in range(1, A + 1):
                acc = max(int(cand[i - 1]), int(acc) - d)
                new[i] = acc
            row = new
    return row


def _last_row(top, side, m, k, d) -> np.ndarray:
    if top.shape[0] * max(side.shape[0], 1) <= _HOST_CELLS:
        return _host_last_row(top, side, m, k, d)
    return _device_last_row(top, side, m, k, d)


def _small_align(top: np.ndarray, side: np.ndarray, s1: bytes, s2: bytes, m, k, d) -> Tuple[bytes, bytes]:
    """Full DP + greedy (diag > left > up) traceback on host."""
    A, B = len(s1), len(s2)
    H = np.zeros((B + 1, A + 1), np.int64)
    H[0, :] = -d * np.arange(A + 1)
    H[:, 0] = -d * np.arange(B + 1)
    for j in range(1, B + 1):
        sub = np.where(top == side[j - 1], m, -k)
        acc = H[j, 0]
        prev_row = H[j - 1]
        cand = np.maximum(prev_row[:-1] + sub, prev_row[1:] - d)
        for i in range(1, A + 1):
            acc = max(int(cand[i - 1]), int(acc) - d)
            H[j, i] = acc
    X = bytearray()
    Y = bytearray()
    i, j = A, B
    while i > 0 or j > 0:
        if i > 0 and j > 0 and H[j, i] == H[j - 1, i - 1] + (
            m if s1[i - 1] == s2[j - 1] else -k
        ):
            i -= 1
            j -= 1
            X.append(s1[i])
            Y.append(s2[j])
        elif i > 0 and H[j, i] == H[j, i - 1] - d:
            i -= 1
            X.append(s1[i])
            Y.append(GAP)
        else:
            j -= 1
            X.append(GAP)
            Y.append(s2[j])
    return bytes(X[::-1]), bytes(Y[::-1])


def hirschberg_align(
    s1: bytes | str, s2: bytes | str, m: int = 1, k: int = 1, d: int = 1
) -> Tuple[bytes, bytes]:
    """One optimal global alignment of (s1, s2) in O(len1+len2) memory."""
    s1 = s1.encode() if isinstance(s1, str) else bytes(s1)
    s2 = s2.encode() if isinstance(s2, str) else bytes(s2)
    top = np.frombuffer(s1, np.uint8).astype(np.int32)
    side = np.frombuffer(s2, np.uint8).astype(np.int32)

    out_X = bytearray()
    out_Y = bytearray()

    def rec(t0: int, t1: int, v0: int, v1: int):
        """Align s1[t0:t1] vs s2[v0:v1], appending to out buffers."""
        a = t1 - t0
        b = v1 - v0
        if a == 0:
            out_X.extend(b"-" * b)
            out_Y.extend(s2[v0:v1])
            return
        if b == 0:
            out_X.extend(s1[t0:t1])
            out_Y.extend(b"-" * a)
            return
        if a * b <= _HOST_CELLS or b <= 2:
            X, Y = _small_align(
                top[t0:t1], side[v0:v1], s1[t0:t1], s2[v0:v1], m, k, d
            )
            out_X.extend(X)
            out_Y.extend(Y)
            return
        h = b // 2
        fwd = _last_row(top[t0:t1], side[v0 : v0 + h], m, k, d)
        rev = _last_row(top[t0:t1][::-1].copy(), side[v0 + h : v1][::-1].copy(), m, k, d)
        split = int(np.argmax(fwd + rev[::-1]))
        rec(t0, t0 + split, v0, v0 + h)
        rec(t0 + split, t1, v0 + h, v1)

    rec(0, len(s1), 0, len(s2))
    return bytes(out_X), bytes(out_Y)
