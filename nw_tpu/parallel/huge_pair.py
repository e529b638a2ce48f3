"""Cross-device huge-pair mode: one DP matrix tiled over a device mesh.

BASELINE config 5: pairs too large for one device's HBM (or one host's
patience) — the matrix's *rows* are sharded over the ``seq`` mesh axis
and the fill runs as a **2-D block wavefront** over (device-row x
diagonal-chunk) tiles:

* device ``p`` owns rows ``[p*H, (p+1)*H)``;
* the sweep is pipelined with a skew: at phase ``s``, device ``p``
  processes diagonal chunk ``c = s - p`` (``C`` diagonals).  Once the
  pipeline fills, every device computes a different chunk concurrently —
  the reference's condvar handoff (needleman-wunsch.c:444-475) becomes
  ONE ``ppermute`` of ``C`` boundary values per phase, not one element
  per diagonal (the latency wall of parallel/wavefront.py r1);
* the halo is the owner's **last-row values by diagonal** — decisions
  (arrow bits) are recomputed locally from exchanged *values*, so tie
  flags are deterministic across tile boundaries (SURVEY §7 hard part);
* each device stores its own rows' uint8 arrows diagonal-major in its
  own device memory ("tiled arrow storage": a 100 kb pair is ~20 GB,
  which one 80 GB card holds, or a quarter of it on each of four);
* the exact greedy traceback (reference first-emission order) runs as a
  **segment relay**: the device owning the walk head walks through its
  rows in a local loop (no collectives), then the head state moves down
  the mesh with one ``psum`` per device crossing; segments are stitched
  on the host.

The per-chunk compute is the natural-boundary anti-diagonal recurrence
as plain ``lax.scan`` vector ops, cross-checked against the
single-device fill (:mod:`nw_tpu.ops.fill_scan`).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from nw_tpu.ops.fill_scan import NEG_INF
from nw_tpu.ops.traceback import OP_DIAG, OP_LEFT, OP_NONE, OP_UP

from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tile_geometry(A, B, nseq, C):
    """(N_pad, H, nch, nphases) for the 2-D block-wavefront tiling."""
    N_pad = _round_up(B + 1, nseq)
    H = N_pad // nseq
    K_pad = _round_up(A + N_pad, C)
    nch = K_pad // C
    return N_pad, H, nch, nch + nseq - 1


def _tile_inputs(top, side, N_pad):
    """(side_sh, top_ext): sentinel-framed global inputs of the tiling."""
    B = side.shape[0]
    side_sh = jnp.concatenate(
        [
            jnp.full((1,), -3, jnp.int32),
            side.astype(jnp.int32),
            jnp.full((N_pad - B - 1,), -5, jnp.int32),
        ]
    )
    top_rev = top[::-1].astype(jnp.int32)
    pad = jnp.full((N_pad,), -4, jnp.int32)
    top_ext = jnp.concatenate([pad, top_rev, pad])
    return side_sh, top_ext


def _make_scan_phase(
    p, jg, side_local, top_ext, m, k, d, C, nch, A, B, H, N_pad,
    axis, perm_down, traceback,
):
    """Scan-engine phase body (pure lax.scan recurrence); shared by the
    monolithic fill and the span-wise resumable fill."""

    def phase(st, s):
        c = s - p
        active = (c >= 0) & (c < nch)
        cc = jnp.clip(c, 0, nch - 1)

        # parent's last-row values for diags [c*C - 1, c*C + C - 1)
        inj = jnp.concatenate([st["tail"][None], st["recv"][:-1]])
        inj = jnp.where(p == 0, NEG_INF, inj)

        def step(carry, t):
            prev, prev2, hprev, cap = carry
            kk = cc * C + t
            halo = inj[t]
            prev_sh = jnp.concatenate([halo[None], prev[:-1]])
            prev2_sh = jnp.concatenate([hprev[None], prev2[:-1]])
            ch_top = jax.lax.dynamic_slice(
                top_ext, (N_pad + A - kk + p * H,), (H,)
            )
            sub = jnp.where(ch_top == side_local, m, -k)
            cand_d = prev2_sh + sub
            score = jnp.maximum(
                cand_d, jnp.maximum(prev_sh, prev) - d
            )
            # diagonal 0 is the DP seed, not a recurrence result
            score = jnp.where(
                kk == 0, jnp.where(jg == 0, jnp.int32(0), NEG_INF), score
            )
            score_d = score + d
            arrows = (
                (cand_d == score).astype(jnp.uint8)
                | ((prev == score_d).astype(jnp.uint8) << 1)
                | ((prev_sh == score_d).astype(jnp.uint8) << 2)
            )
            hit = (kk == A + B) & (jg == B)
            cap = jnp.where(
                jnp.any(hit), jnp.where(hit, score, NEG_INF).max(), cap
            )
            emit = score[-1]
            return (score, prev, halo, cap), (emit, arrows)

        (prev, prev2, hprev, cap), (emits, arr) = jax.lax.scan(
            step,
            (st["prev"], st["prev2"], st["hprev"], st["cap"]),
            jnp.arange(C, dtype=jnp.int32),
        )

        # inactive phases must not advance state
        def keep(new, old):
            return jnp.where(active, new, old)

        new_st = dict(
            prev=keep(prev, st["prev"]),
            prev2=keep(prev2, st["prev2"]),
            hprev=keep(hprev, st["hprev"]),
            cap=keep(cap, st["cap"]),
            # child consumes my emits next phase; send even when
            # inactive (garbage chunks are never marked active there)
            recv=jax.lax.ppermute(
                jnp.where(active, emits, NEG_INF), axis, perm_down
            ),
            tail=keep(st["recv"][-1], st["tail"]),
        )
        arr = jnp.where(active, arr, jnp.uint8(0))
        return new_st, arr if traceback else None

    return phase


def _make_relay_walk(p, axis, A, H, nseq, vary0):
    """Segment-relay exact greedy walk over the tiled arrows: the owner
    of the walk head runs a local loop; one psum per device crossing;
    tiny per-round segments are all_gathered so every process can
    stitch them (real multi-host meshes cannot address remote
    shards)."""
    cap_seg = A + H + 8  # one device's worst-case path segment

    def relay_walk(B, score, arrow_at):
        def seg_round(carry, _):
            i, j = carry
            mine = (j // H == p) & ((i > 0) | (j > 0))

            def cond(stw):
                i2, j2, n2, _ = stw
                return (
                    ((i2 > 0) | (j2 > 0))
                    & (j2 // H == p)
                    & (n2 < cap_seg)
                )

            def body(stw):
                i2, j2, n2, ops = stw
                a = arrow_at(i2, j2)
                take_diag = (a & 1) != 0
                take_left = (~take_diag) & ((a & 2) != 0)
                take_up = ~(take_diag | take_left)
                op = jnp.where(
                    take_diag, OP_DIAG,
                    jnp.where(take_left, OP_LEFT, OP_UP),
                ).astype(jnp.int8)
                ops = ops.at[n2].set(op)
                di = jnp.where(take_diag | take_left, 1, 0)
                dj = jnp.where(take_diag | take_up, 1, 0)
                return (i2 - di, j2 - dj, n2 + 1, ops)

            ops0 = (
                jnp.full((cap_seg,), OP_NONE, jnp.int8)
                + vary0.astype(jnp.int8)
            )
            iw, jw, nw, ops = jax.lax.while_loop(
                cond,
                body,
                (
                    jnp.where(mine, i, 0) + vary0,
                    jnp.where(mine, j, 0) + vary0,
                    jnp.int32(0) + vary0,
                    ops0,
                ),
            )
            # the owner's new head replaces the replicated shared head
            any_mine = jax.lax.psum(mine.astype(jnp.int32), axis) > 0
            i = jnp.where(
                any_mine, jax.lax.psum(jnp.where(mine, iw, 0), axis), i
            )
            j = jnp.where(
                any_mine, jax.lax.psum(jnp.where(mine, jw, 0), axis), j
            )
            return (i, j), (ops, jnp.where(mine, nw, 0))

        _, (segs, seg_ns) = jax.lax.scan(
            seg_round,
            (jnp.int32(A) + vary0, jnp.int32(B) + vary0),
            None,
            length=nseq,
        )
        segs_all = jax.lax.all_gather(segs, axis)  # (ndev, nround, cap)
        ns_all = jax.lax.all_gather(seg_ns, axis)
        return score, segs_all, ns_all

    return relay_walk


def _make_arrow_at_scan(arr_phases, p, C, H):
    """Cell reader over the scan engine's per-phase arrows
    ((nphases, C, H) uint8; chunk c sits at phase c + p)."""

    def arrow_at(i2, j2):
        jloc = j2 - p * H
        kk = i2 + j2
        c = kk // C
        return arr_phases[c + p, kk - c * C, jloc]

    return arrow_at


def _shard_mapped(fn, mesh, in_specs, out_specs):
    return jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )


def _scan_state0(H, C, vary0):
    """The per-device carry of the phase scan: diag 0 (the DP seed) is
    produced by the kk == 0 step override, so the registers start one
    diagonal EARLIER (all out-of-table)."""
    return dict(
        prev=jnp.full((H,), NEG_INF, jnp.int32) + vary0,
        prev2=jnp.full((H,), NEG_INF, jnp.int32) + vary0,
        hprev=jnp.int32(NEG_INF) + vary0,  # diag-halo carry (kk-2)
        cap=jnp.int32(NEG_INF) + vary0,
        recv=jnp.full((C,), NEG_INF, jnp.int32) + vary0,
        tail=jnp.int32(NEG_INF) + vary0,  # parent chunk c-1 last diag
    )


@functools.partial(
    jax.jit,
    static_argnames=("m", "k", "d", "mesh", "axis", "chunk", "traceback"),
)
def _huge_pair_device(
    top, side, *, m: int, k: int, d: int, mesh: Mesh, axis: str,
    chunk: int, traceback: bool,
):
    A = top.shape[0]
    B = side.shape[0]
    nseq = mesh.shape[axis]
    C = chunk
    N_pad, H, nch, nphases = _tile_geometry(A, B, nseq, C)
    side_sh, top_ext = _tile_inputs(top, side, N_pad)
    perm_down = [(i, (i + 1) % nseq) for i in range(nseq)]  # p -> p+1

    def local(side_local, top_ext):
        p = jax.lax.axis_index(axis)
        jg = p * H + jnp.arange(H, dtype=jnp.int32)
        vary0 = side_local.sum() * 0  # shard_map varying-type anchor
        phase = _make_scan_phase(
            p, jg, side_local, top_ext, m, k, d, C, nch, A, B, H, N_pad,
            axis, perm_down, traceback,
        )
        st, arr_phases = jax.lax.scan(
            phase, _scan_state0(H, C, vary0),
            jnp.arange(nphases, dtype=jnp.int32),
        )
        score = jax.lax.pmax(st["cap"], axis)
        if not traceback:
            return score
        arrow_at = _make_arrow_at_scan(arr_phases, p, C, H)
        relay_walk = _make_relay_walk(p, axis, A, H, nseq, vary0)
        return relay_walk(B, score, arrow_at)

    out_specs = (P(), P(), P()) if traceback else P()
    mapped = _shard_mapped(local, mesh, (P(axis), P()), out_specs)
    return mapped(side_sh, top_ext)


@functools.partial(
    jax.jit,
    static_argnames=(
        "A", "B", "m", "k", "d", "mesh", "axis", "chunk", "span", "traceback",
    ),
)
def _huge_span_device(
    side_sh, top_ext, state, s0, *, A, B, m, k, d, mesh, axis,
    chunk, span, traceback,
):
    """Phases [s0, s0 + span) of the tiled fill, state in/out.

    The resumable building block: ``state`` is the per-device carry of
    the phase scan with a leading device axis (sharded over ``axis``),
    so a host loop can persist it between spans — the carry IS the
    fill's only cross-phase state.  Returns (state', arr_span) with
    ``arr_span`` leading-device-axis sharded ((nseq, span, ...));
    ``None`` when not tracing arrows."""
    nseq = mesh.shape[axis]
    C = chunk
    N_pad, H, nch, _ = _tile_geometry(A, B, nseq, C)
    perm_down = [(i, (i + 1) % nseq) for i in range(nseq)]

    def local(side_local, top_ext, st_local, s0):
        p = jax.lax.axis_index(axis)
        st = jax.tree.map(lambda x: x[0], st_local)
        jg = p * H + jnp.arange(H, dtype=jnp.int32)
        phase = _make_scan_phase(
            p, jg, side_local, top_ext, m, k, d, C, nch, A, B, H,
            N_pad, axis, perm_down, traceback,
        )
        st, arr = jax.lax.scan(
            phase, st, s0 + jnp.arange(span, dtype=jnp.int32)
        )
        out_st = jax.tree.map(lambda x: x[None], st)
        return (out_st, arr[None]) if traceback else (out_st, None)

    state_specs = jax.tree.map(lambda _: P(axis), state)
    out_specs = (state_specs, P(axis) if traceback else None)
    mapped = _shard_mapped(
        local, mesh, (P(axis), P(), state_specs, P()), out_specs
    )
    return mapped(side_sh, top_ext, state, jnp.asarray(s0, jnp.int32))


@functools.partial(
    jax.jit, static_argnames=("A", "B", "mesh", "axis", "chunk"),
)
def _huge_walk_sharded(arr_all, score, *, A, B, mesh, axis, chunk):
    """Standalone segment-relay walk over fully-materialized tiled
    arrows ((nseq, nphases, ...) leading-device-axis sharded) — the
    pass a resumed config-5 run executes after its fill completes."""
    nseq = mesh.shape[axis]
    C = chunk
    _, H, _, _ = _tile_geometry(A, B, nseq, C)

    def local(arr_local):
        p = jax.lax.axis_index(axis)
        vary0 = (arr_local.reshape(-1)[0] * 0).astype(jnp.int32)
        arrow_at = _make_arrow_at_scan(arr_local[0], p, C, H)
        relay_walk = _make_relay_walk(p, axis, A, H, nseq, vary0)
        _, segs, ns = relay_walk(B, jnp.int32(0), arrow_at)
        return segs, ns

    mapped = _shard_mapped(local, mesh, (P(axis),), (P(), P()))
    return mapped(arr_all)


def _stitch_segments(segs, seg_ns, nseq) -> np.ndarray:
    """Per-device relay segments -> one op string (walk order)."""
    segs = np.asarray(segs)  # (nseq devices, nseq rounds, cap_seg)
    seg_ns = np.asarray(seg_ns)
    parts = []
    for r in range(nseq):  # rounds in walk order
        for pdev in range(nseq):
            nn = int(seg_ns[pdev, r])
            if nn:
                parts.append(segs[pdev, r, :nn])
    return np.concatenate(parts) if parts else np.zeros((0,), np.int8)


def huge_state_init(A, B, mesh, axis, chunk):
    """Global (leading-device-axis) initial carry for the span fill."""
    nseq = mesh.shape[axis]
    _, H, _, _ = _tile_geometry(A, B, nseq, chunk)
    return {
        k2: np.broadcast_to(np.asarray(v), (nseq, *np.shape(v))).copy()
        for k2, v in _scan_state0(H, chunk, np.int32(0)).items()
    }


@dataclasses.dataclass
class HugeShardedResult:
    score: int
    ops: np.ndarray  # int8[n] op codes, corner -> origin
    n: int


def auto_chunk(
    A: int, B: int, nseq: int,
    target_eff: float = 0.875, c_min: int = 128, c_max: int = 2048,
) -> int:
    """Pick the halo-chunk size C for the tiled fill.

    The pipeline runs ``nphases = nch + nseq - 1`` phases for ``nch``
    chunks of useful work: efficiency ``nch / nphases``; the fill/drain
    bubble is ``(nseq - 1) / nphases``.  Smaller C means more chunks
    and less bubble but more per-phase dispatch + ppermute overhead, so
    C is chosen as the LARGEST value that still meets ``target_eff``,
    clamped to [c_min, c_max] (SURVEY §5.7).
    """
    N_pad = _round_up(B + 1, nseq)
    if nseq <= 1:
        return max(1, min(c_max, A + N_pad))
    # nch >= need  <=>  eff = nch / (nch + nseq - 1) >= target_eff
    need = int(np.ceil((nseq - 1) * target_eff / (1.0 - target_eff)))
    C = max(c_min, min(c_max, (A + N_pad) // max(need, 1)))
    # the per-phase top-char slice reads C entries of the framed top
    # (len 2*N_pad + A): clamp to the table for small pairs
    return max(1, min(C, A + N_pad))


def pipeline_efficiency(A: int, B: int, nseq: int, chunk: int) -> float:
    """Useful-phase fraction ``nch / nphases`` of the tiled fill."""
    _, _, nch, nphases = _tile_geometry(A, B, nseq, chunk)
    return nch / nphases


def huge_pair_score_sharded(
    top, side, m, k, d, mesh: Mesh, axis: str = "seq",
    chunk: int | None = None,
) -> int:
    """Score of ONE huge pair, rows sharded over ``axis``, chunked halo.

    ``chunk=None`` auto-picks C for >= 87.5% pipeline efficiency
    (:func:`auto_chunk`)."""
    if chunk is None:
        chunk = auto_chunk(top.shape[0], side.shape[0], mesh.shape[axis])
    return int(
        _huge_pair_device(
            jnp.asarray(top), jnp.asarray(side),
            m=int(m), k=int(k), d=int(d), mesh=mesh, axis=axis,
            chunk=chunk, traceback=False,
        )
    )


def huge_pair_align_sharded(
    top, side, m, k, d, mesh: Mesh, axis: str = "seq",
    chunk: int | None = None,
) -> HugeShardedResult:
    """Exact first-emission alignment of ONE huge pair across the mesh.

    The fill is the tiled block wavefront; arrows live sharded in each
    device's memory; the walk relays across devices.  Returns op codes
    with :mod:`nw_tpu.ops.traceback` semantics (use ``ops_to_strings``).
    """
    if chunk is None:
        chunk = auto_chunk(top.shape[0], side.shape[0], mesh.shape[axis])
    score, segs, seg_ns = _huge_pair_device(
        jnp.asarray(top), jnp.asarray(side),
        m=int(m), k=int(k), d=int(d), mesh=mesh, axis=axis,
        chunk=chunk, traceback=True,
    )
    ops = _stitch_segments(segs, seg_ns, mesh.shape[axis])
    return HugeShardedResult(score=int(score), ops=ops, n=len(ops))
