"""Host-side sequence encoding, padding, and length bucketing.

The reference operates on raw C strings of arbitrary non-whitespace bytes
(``read-sequences.c:56-86``).  For the device kernels, sequences become
fixed-shape integer arrays:

* characters are encoded as their byte value (0..255) in ``int32``;
* the two sequences of a pair are padded with *distinct* sentinels
  (``PAD_TOP = -1``, ``PAD_SIDE = -2``) so a padded "top" character can
  never spuriously match a padded "side" character.  Because the NW
  recurrence for cell (j, i) only ever reads cells with smaller row and
  column indices, the scores and arrows inside the true (len2+1, len1+1)
  rectangle are unaffected by padding — traceback starts at the true
  corner and never enters the pad region.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

PAD_TOP = -1
PAD_SIDE = -2


def encode(seq: str | bytes) -> np.ndarray:
    """Encode one sequence as an int32 vector of byte values."""
    if isinstance(seq, str):
        seq = seq.encode("utf-8")
    return np.frombuffer(bytes(seq), dtype=np.uint8).astype(np.int32)


def decode(arr: np.ndarray) -> str:
    """Inverse of :func:`encode` (drops pad sentinels)."""
    arr = np.asarray(arr)
    return bytes(int(c) for c in arr if c >= 0).decode("utf-8")


def pad_to(arr: np.ndarray, length: int, fill: int) -> np.ndarray:
    if arr.shape[0] > length:
        raise ValueError(f"sequence length {arr.shape[0]} exceeds bucket {length}")
    out = np.full((length,), fill, dtype=np.int32)
    out[: arr.shape[0]] = arr
    return out


def encode_pair(
    s1: str | bytes, s2: str | bytes, len1: int | None = None, len2: int | None = None
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Encode a (top, side) pair, padded to (len1, len2).

    Returns (top_codes, side_codes, true_len1, true_len2).
    """
    a = encode(s1)
    b = encode(s2)
    n1, n2 = a.shape[0], b.shape[0]
    if len1 is None:
        len1 = n1
    if len2 is None:
        len2 = n2
    return pad_to(a, len1, PAD_TOP), pad_to(b, len2, PAD_SIDE), n1, n2


def encode_batch(
    pairs: Sequence[Tuple[str | bytes, str | bytes]],
    len1: int | None = None,
    len2: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Encode a batch of pairs into stacked (B, len1) / (B, len2) arrays.

    Returns (tops, sides, lens1, lens2).  ``len1``/``len2`` default to the
    batch maxima.
    """
    return _encode_batch_impl(
        pairs, len1, len2, fills=(PAD_TOP, PAD_SIDE), dtype=np.int32
    )


def _encode_batch_impl(
    pairs: Sequence[Tuple[str | bytes, str | bytes]],
    len1: int | None,
    len2: int | None,
    fills: Tuple[int, int],
    dtype,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    raw = [
        (
            a.encode("utf-8") if isinstance(a, str) else bytes(a),
            b.encode("utf-8") if isinstance(b, str) else bytes(b),
        )
        for a, b in pairs
    ]
    lens1 = np.array([len(a) for a, _ in raw], dtype=np.int32)
    lens2 = np.array([len(b) for _, b in raw], dtype=np.int32)
    if len1 is None:
        len1 = int(lens1.max()) if len(raw) else 0
    if len2 is None:
        len2 = int(lens2.max()) if len(raw) else 0
    tops = _scatter_encode([a for a, _ in raw], lens1, len1, fills[0], dtype)
    sides = _scatter_encode([b for _, b in raw], lens2, len2, fills[1], dtype)
    return tops, sides, lens1, lens2


def _scatter_encode(
    seqs: Sequence[bytes],
    lens: np.ndarray,
    bucket: int,
    fill: int,
    dtype=np.int32,
) -> np.ndarray:
    """Vectorized batch encoding: one concatenated buffer + one masked
    scatter instead of a per-pair stack (the per-pair version costs
    ~15 us/pair in Python; this is ~40x faster at batch-4096)."""
    B = len(seqs)
    if (lens > bucket).any():
        bad = int(np.argmax(lens > bucket))
        raise ValueError(
            f"sequence length {int(lens[bad])} exceeds bucket {bucket}"
        )
    out = np.full((B, bucket), fill, dtype=dtype)
    if B and bucket:
        flat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
        mask = np.arange(bucket, dtype=np.int32)[None, :] < lens[:, None]
        out[mask] = flat  # row-major mask order == concatenation order
    return out


def encode_batch_u8(
    pairs: Sequence[Tuple[str | bytes, str | bytes]],
    len1: int | None = None,
    len2: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`encode_batch` with **uint8** outputs (pad byte 0) — a 4x
    smaller host->device upload for paths whose jitted programs cast to
    int32 on device (every batched engine of this package does).

    Soundness of the 0 pad (vs ``PAD_TOP``/``PAD_SIDE``): the module
    docstring's invariant — cell (j, i) reads only smaller row/column
    indices, so cells inside a pair's true (len2+1, len1+1) rectangle
    never read a padded cell — means pad VALUES can't reach any
    extracted output (scores/counts/walks all read true-rectangle cells
    only, and walks start at the true corner).  A 0 pad colliding with
    a real NUL byte is therefore harmless; consumers that materialize
    whole tables (the ``-t`` renderer) keep the sentinel encoding.
    """
    return _encode_batch_impl(pairs, len1, len2, fills=(0, 0), dtype=np.uint8)
