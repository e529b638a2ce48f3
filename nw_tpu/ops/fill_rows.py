"""Row-sweep batch fill for the GPU: one lane per pair, Pallas via Triton.

The short-read hot path.  XLA's anti-diagonal scan
(:mod:`nw_tpu.ops.fill_scan`) runs one loop iteration per diagonal and
sends the rolling diagonals through device memory on every step; at
150 bp that is ~300 iterations for a few thousand int32 add/max per
pair.  This kernel instead gives every pair its own lane (the
inter-pair layout of GPU short-read aligners): a program owns ``BP``
pairs, one per thread, and sweeps the DP table row-major.

* ``R`` rows of the top sequence advance together as a *strip*, row
  ``r`` one column behind row ``r - 1``, so every value a row needs
  from the row above was computed one or two steps earlier and is still
  in a register.  Only the strip's first row reads the boundary row
  (the previous strip's last row) and only its last row writes it; that
  row lives in device memory, indexed ``[column, pair]`` so a warp's
  accesses coalesce.
* Boundaries need no selects: row 0 is the boundary row's initial
  content (``-j*d``), column 0 emerges from NEG_INF-initialised left and
  diagonal registers (``max(up, NEG_INF) - d``).
* The true corner ``(len1, len2)`` is captured by a masked select per
  row and step (gating it to the strips that hold some lane's ``len1``
  saved 6% at 10,240 x 150 bp and cost a second copy of the strip loop).

Modes (static flags): the corner score always; ``with_counts`` adds the
number of optimal alignments (uint32 wraparound, exactly
:func:`nw_tpu.ops.pathcount.count_paths`); ``with_words`` adds 2-bit
greedy walk codes in the row-major layout that
:func:`nw_tpu.ops.traceback.traceback_greedy2_rowmajor` walks: cell
``(i, j)`` (``i`` over s1 rows ``1..len1``, ``j`` over s2 columns) is
bits ``2 * (j & 15)`` of ``words[i - 1, j >> 4, pair]``, code 0 = diag,
1 = the s1-consuming move, 2 = the s2-consuming move (the reference's
descend priority diag > left > up, needleman-wunsch.c:305-324).

The arithmetic is int32 add/max on CUDA cores: (max, +) has no
tensor-core form.  ``interpret=True`` runs the same kernel through the
Pallas interpreter; only tests pass it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from nw_tpu.ops.encode import PAD_SIDE, PAD_TOP

NEG_INF = -(2**30)
# strip height R: 8 rows, 4 when the walk words ride the fill (measured
# faster there, and it compiles in a third of the time)
ROWS = 8
ROWS_WITH_WORDS = 4
BLOCK_PAIRS = 32  # pairs per program: one warp, one pair per thread


def strip_rows(with_words: bool) -> int:
    return ROWS_WITH_WORDS if with_words else ROWS


def _c32(v: int) -> int:
    """A shifted word constant wrapped to signed int32."""
    return ((v + 2**31) % 2**32) - 2**31


def _make_kernel(R, U, L2p, W16, nchunks, npass, BP, with_counts, with_words):
    def kernel(*refs):
        it = iter(refs)
        mkd_ref, tops_ref, sides_ref, lens_ref = (next(it) for _ in range(4))
        score_ref = next(it)
        count_ref = next(it) if with_counts else None
        words_ref = next(it) if with_words else None
        row_ref = next(it)
        crow_ref = next(it) if with_counts else None

        pid = pl.program_id(0)
        lanes = pl.ds(pid * BP, BP)
        m = mkd_ref[0]
        kmis = mkd_ref[1]
        d = mkd_ref[2]
        len1 = lens_ref[0, lanes]
        len2 = lens_ref[1, lanes]
        zero = jnp.zeros((BP,), jnp.int32)
        neg = zero + NEG_INF
        one = zero + 1

        def init_row(j, _):
            row_ref[j, lanes] = zero - j * d
            if with_counts:
                crow_ref[j, lanes] = one

        # no carry: the Triton lowering rejects a constant loop carry
        jax.lax.fori_loop(0, L2p + 2, init_row, None)

        # lanes with len1 == 0 never enter a strip: their corner is the
        # row-0 cell (0, len2)
        cap0 = jnp.where(len1 == 0, zero - len2 * d, neg)
        ccap0 = jnp.where(len1 == 0, one, zero)

        def strip(p, caps):
            i0 = p * R
            t_ch = [tops_ref[i0 + r, lanes] for r in range(R)]

            def chunk(c, carry):
                st, caps = carry
                (scores, prevs, win, ld_prev, cnts, cprevs, cld_prev,
                 wregs) = st
                scores, prevs, win = list(scores), list(prevs), list(win)
                cnts, cprevs, wregs = list(cnts), list(cprevs), list(wregs)
                cap, ccap = caps
                s0 = c * U
                # the U steps' boundary-row and side-char loads go
                # first: a column is read U - 1 + R steps before
                # this strip overwrites it
                lds = [
                    row_ref[jnp.minimum(s0 + u, L2p), lanes]
                    for u in range(U)
                ]
                clds = [
                    crow_ref[jnp.minimum(s0 + u, L2p), lanes]
                    for u in range(U)
                ] if with_counts else None
                chs = [
                    sides_ref[jnp.clip(s0 + u - 1, 0, L2p - 1), lanes]
                    for u in range(U)
                ]
                for u in range(U):
                    s = s0 + u
                    ld = lds[u]
                    win = [chs[u]] + win[:-1]
                    new, cnew = [], []
                    for r in range(R):
                        up = ld if r == 0 else scores[r - 1]
                        diag = ld_prev if r == 0 else prevs[r - 1]
                        left = scores[r]
                        sub = jnp.where(t_ch[r] == win[r], m, -kmis)
                        cand_d = diag + sub
                        mx = jnp.maximum(up, left) - d
                        h = jnp.maximum(cand_d, mx)
                        new.append(h)
                        if with_counts:
                            c_up = clds[u] if r == 0 else cnts[r - 1]
                            c_diag = cld_prev if r == 0 else cprevs[r - 1]
                            hd = h + d
                            cnew.append(
                                jnp.where(cand_d == h, c_diag, 0)
                                + jnp.where(up == hd, c_up, 0)
                                + jnp.where(left == hd, cnts[r], 0)
                            )
                        if with_words:
                            # column j = s - r with s0 % 16 == 0, so
                            # the bit position is static per (u, r)
                            sh = 2 * ((u - r) % 16)
                            code = jnp.where(
                                cand_d >= mx,
                                0,
                                jnp.where(
                                    up >= left, _c32(1 << sh), _c32(2 << sh)
                                ),
                            )
                            wregs[r] = code if sh == 0 else wregs[r] | code
                    if with_words:
                        for r in range(R):
                            if (u - r) % 16 != 15:
                                continue
                            wcol = c + (u - r - 15) // 16

                            @pl.when((wcol >= 0) & (wcol < W16))
                            def _(r=r, wcol=wcol, w=wregs[r]):
                                words_ref[i0 + r, wcol, lanes] = w

                    # the strip's last row becomes the next boundary
                    # row; warm-up and flush steps land in the spare
                    # column L2p + 1, which is never read
                    # (an arithmetic select: the Triton lowering mistypes
                    # a scalar jnp.where with a literal branch)
                    col = s - (R - 1)
                    off = ((col < 0) | (col > L2p)).astype(jnp.int32)
                    col = col + off * (L2p + 1 - col)
                    row_ref[col, lanes] = new[R - 1]
                    if with_counts:
                        crow_ref[col, lanes] = cnew[R - 1]
                    for r in range(R):
                        hit = (len1 == i0 + r + 1) & (len2 == s - r)
                        cap = jnp.where(hit, new[r], cap)
                        if with_counts:
                            ccap = jnp.where(hit, cnew[r], ccap)
                    if with_counts:
                        cld_prev = clds[u]
                        cprevs, cnts = cnts, cnew
                    ld_prev, prevs, scores = ld, scores, new
                st = (
                    tuple(scores), tuple(prevs), tuple(win), ld_prev,
                    tuple(cnts), tuple(cprevs), cld_prev, tuple(wregs),
                )
                return st, (cap, ccap)

            st0 = (
                (neg,) * R, (neg,) * R, (zero - 5,) * R, neg,
                (one,) * R if with_counts else (),
                (one,) * R if with_counts else (),
                one if with_counts else zero,
                (zero,) * R if with_words else (),
            )
            return jax.lax.fori_loop(0, nchunks, chunk, (st0, caps))[1]

        cap, ccap = jax.lax.fori_loop(0, npass, strip, (cap0, ccap0))
        score_ref[lanes] = cap
        if with_counts:
            count_ref[lanes] = ccap

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=("with_counts", "with_words", "rows", "interpret"),
)
def fill_rows_batch(
    tops, sides, lens1, lens2, m, k, d, *, with_counts: bool = False,
    with_words: bool = False, rows: int | None = None,
    interpret: bool = False,
):
    """Batched linear-gap NW fill, one lane per pair.

    Args:
      tops: int32/uint8[nb, L1] encoded top strings (s1); sides:
        [nb, L2] (s2); lens1/lens2: int32[nb] true lengths.  Pad values
        are never read inside a pair's true rectangle.
      m, k, d: match bonus, mismatch penalty, indel penalty.
      rows: strip height (default: :func:`strip_rows` of the mode).
    Returns:
      dict with ``score`` int32[nb]; ``count`` uint32[nb] with
      ``with_counts``; ``words`` int32[L1w, W16, nb] with ``with_words``
      (``L1w >= L1`` rows, ``W16 = (L2 + 16) // 16`` words per row).
    """
    nb, L1 = tops.shape
    L2 = sides.shape[1]
    R = rows or strip_rows(with_words)
    BP = BLOCK_PAIRS
    U = 16 if with_words else 8
    L2p = max(L2, 1)
    npass = -(-max(L1, 1) // R)
    L1w = npass * R
    W16 = (L2p + 1 + 15) // 16
    # enough steps for the last row to reach the last word's last column
    nchunks = -(-(16 * W16 + R) // U)
    nbp = -(-max(nb, 1) // BP) * BP
    nprog = nbp // BP

    tops_t = jnp.pad(
        jnp.asarray(tops).astype(jnp.int32), ((0, nbp - nb), (0, L1w - L1)),
        constant_values=PAD_TOP,
    ).T
    sides_t = jnp.pad(
        jnp.asarray(sides).astype(jnp.int32), ((0, nbp - nb), (0, L2p - L2)),
        constant_values=PAD_SIDE,
    ).T
    l1 = jnp.pad(jnp.asarray(lens1, jnp.int32), (0, nbp - nb))
    l2 = jnp.pad(jnp.asarray(lens2, jnp.int32), (0, nbp - nb))
    lens = jnp.stack([l1, l2])
    mkd = jnp.stack([jnp.asarray(x, jnp.int32) for x in (m, k, d)])

    out_shape = [jax.ShapeDtypeStruct((nbp,), jnp.int32)]
    if with_counts:
        out_shape.append(jax.ShapeDtypeStruct((nbp,), jnp.int32))
    if with_words:
        out_shape.append(jax.ShapeDtypeStruct((L1w, W16, nbp), jnp.int32))
    # boundary row(s): written by the kernel before any read
    out_shape.append(jax.ShapeDtypeStruct((L2p + 2, nbp), jnp.int32))
    if with_counts:
        out_shape.append(jax.ShapeDtypeStruct((L2p + 2, nbp), jnp.int32))

    outs = pl.pallas_call(
        _make_kernel(R, U, L2p, W16, nchunks, npass, BP, with_counts, with_words),
        out_shape=out_shape,
        grid=(nprog,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=BP // 32, num_stages=1),
        interpret=interpret,
        name="nw_fill_rows",
    )(mkd, tops_t, sides_t, lens)
    outs = iter(outs)
    result = {"score": next(outs)[:nb]}
    if with_counts:
        result["count"] = next(outs)[:nb].astype(jnp.uint32)
    if with_words:
        result["words"] = next(outs)[:, :, :nb]
    return result
