"""Engine routing: the one place that maps (backend, mode, shapes) to an
engine.

Shared by the single-host batched API
(:meth:`nw_tpu.models.needleman_wunsch.NWAligner.align_batch`) and the
mesh-sharded path (:mod:`nw_tpu.parallel.data_parallel`).  Engines:

* ``"rows"`` — the one-lane-per-pair row-sweep kernel
  (:mod:`nw_tpu.ops.fill_rows`, Pallas through Triton), GPU only.  It
  serves every mode: score, score + count, and 2-bit greedy walk words
  for strings.
* ``"scan"`` — XLA's anti-diagonal ``lax.scan`` (:mod:`nw_tpu.ops.fill_scan`)
  on any backend; modes that need more than the score materialize uint8
  arrows, so those batches are chunked to :func:`arrow_budget_bytes`.
* ``"huge"`` — pairs too large for any per-pair arrow table go one at a
  time through the O(N)-memory routes (checkpointed traceback and fused
  score + count), see ``NWAligner._align_batch_huge_pairs``.

Routing bounds, measured end to end on an H100 (PERF.md): the kernel
beats the scan at every batch size up to 1024-long sides; beyond that it
wins only when the batch fills the card (>= 1024 pairs), because one
lane walks its pair's whole table serially while the scan spreads one
long diagonal over the card.  Interpret mode is never routed to: only
tests run the kernel off the GPU, and they call it directly.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from nw_tpu.ops import pathcount, traceback
from nw_tpu.ops.fill_rows import fill_rows_batch, strip_rows
from nw_tpu.ops.fill_scan import fill_arrows_batch_kbn, fill_scores_batch

ROWS_ANY_BATCH_MAX_SIDE = 1024
ROWS_MIN_BATCH = 1024
# beyond this side, an arrow-emitting pair goes through the huge-pair
# routes: its uint8 arrow table alone would be >= 2 GB
HUGE_PAIR_MIN_SIDE = 32768
# arrow-emitting scan batches are chunked to this share of device memory
ARROW_BUDGET_SHARE = 4
# budget where the backend reports no memory limit (the CPU)
HOST_ARROW_BUDGET = 1 << 30


def default_platform() -> str:
    return jax.devices()[0].platform


def pick_engine(
    nb: int, L1: int, L2: int, *, need_arrows: bool,
    platform: Optional[str] = None,
) -> str:
    """Engine for a batch of ``nb`` pairs padded to (L1, L2)."""
    if need_arrows and L2 > HUGE_PAIR_MIN_SIDE:
        return "huge"
    if (platform or default_platform()) == "gpu" and (
        max(L1, L2) <= ROWS_ANY_BATCH_MAX_SIDE or nb >= ROWS_MIN_BATCH
    ):
        return "rows"
    return "scan"


def pair_bytes(engine: str, L1: int, L2: int, counts: bool, strings: bool) -> int:
    """Device bytes one pair's traceback state holds on ``engine``
    (0 when nothing per-cell is stored)."""
    if engine == "rows":
        R = strip_rows(strings)
        return -(-max(L1, 1) // R) * R * ((L2 + 16) // 16) * 4 if strings else 0
    if engine == "scan" and (counts or strings):
        return (L1 + L2 + 1) * (L2 + 1)
    return 0


def arrow_budget_bytes() -> int:
    """Bytes an arrow-emitting batch may hold on the default device."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return limit // ARROW_BUDGET_SHARE if limit else HOST_ARROW_BUDGET


def chunked(norm, run):
    """Run ``run`` over sub-batches of ``norm`` (byte pairs) sized so
    each sub-batch's diagonal-major uint8 arrow table fits
    :func:`arrow_budget_bytes`, and concatenate the per-pair results —
    the variant (SW, Gotoh, overlap) alignment batches."""
    if not norm:
        return []
    A = max(len(a) for a, _ in norm)
    B = max(len(b) for _, b in norm)
    chunk = max(1, arrow_budget_bytes() // ((A + B + 1) * (B + 1)))
    out = []
    for i in range(0, len(norm), chunk):
        out.extend(run(norm[i : i + chunk]))
    return out


def fill_batch(
    tops, sides, lens1, lens2, m, k, d, *, engine: str,
    counts: bool = False, strings: bool = False,
) -> Dict[str, jax.Array]:
    """Run one padded batch on ``engine`` ("rows" or "scan").

    Returns a dict of device arrays: ``score`` int32[B]; ``count``
    uint32[B] with ``counts``; ``ops`` int8[B, L1+L2] and ``n`` int32[B]
    (the greedy first-emission walk, :mod:`nw_tpu.ops.traceback`) with
    ``strings``.  Traceable, so the sharded path runs it per shard.
    """
    l1 = jnp.asarray(lens1, jnp.int32)
    l2 = jnp.asarray(lens2, jnp.int32)
    max_steps = tops.shape[1] + sides.shape[1]
    if engine == "rows":
        out = fill_rows_batch(
            tops, sides, l1, l2, m, k, d,
            with_counts=counts, with_words=strings,
        )
        res = {"score": out["score"]}
        if counts:
            res["count"] = out["count"]
        if strings:
            res["ops"], res["n"] = traceback.traceback_greedy2_rowmajor_batch(
                out["words"], l1, l2, max_steps=max_steps
            )
        return res
    if not (counts or strings):
        return {"score": fill_scores_batch(tops, sides, m, k, d, l1, l2)}
    out = fill_arrows_batch_kbn(tops, sides, m, k, d, l1, l2)
    res = {"score": out["score"]}
    if counts:
        res["count"] = jax.vmap(pathcount.count_paths, in_axes=(1, 0, 0))(
            out["arrows"], l1, l2
        )
    if strings:
        res["ops"], res["n"] = traceback.traceback_greedy_batch(
            out["arrows"], l1, l2, max_steps=max_steps, axis=1
        )
    return res
