"""Data-parallel batched alignment over a device mesh.

Pair batches shard along the ``data`` mesh axis (one shard of pairs per
device); each device runs the wavefront fill on its shard, and run-level
statistics merge with XLA collectives.  The merged counters are the
collective replacement for the reference's rwlock-protected globals
(``solution_count``, computation.c:223-260; ``branch_count``,
walk-table.c:108-147): instead of threads serializing on a lock, every
device owns its partial sums and one ``psum`` combines them.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from nw_tpu.ops.fill_auto import fill_batch, pick_engine


@functools.partial(
    jax.jit, static_argnames=("mesh", "axis", "with_counts", "m", "k", "d")
)
def _align_batch_sharded(
    tops, sides, lens1, lens2, *, m, k, d, mesh, axis, with_counts
):
    # per-shard engine choice follows the mesh's platform and the
    # shard's shapes (GPU shards run the row-sweep kernel)
    nshard = tops.shape[0] // mesh.shape[axis]
    engine = pick_engine(
        nshard, tops.shape[1], sides.shape[1], need_arrows=False,
        platform=mesh.devices.flat[0].platform,
    )

    def shardfn(tops, sides, lens1, lens2):
        out = fill_batch(
            tops, sides, lens1, lens2, m, k, d, engine=engine,
            counts=with_counts,
        )
        scores = out["score"]
        real = (lens1 > 0) | (lens2 > 0)
        stats = {
            "pairs": jax.lax.psum(real.sum(), axis),
            "score_sum": jax.lax.psum(jnp.where(real, scores, 0).sum(), axis),
            "score_min": jax.lax.pmin(
                jnp.where(real, scores, jnp.int32(2**31 - 1)).min(), axis
            ),
            "score_max": jax.lax.pmax(
                jnp.where(real, scores, jnp.int32(-(2**31))).max(), axis
            ),
        }
        if with_counts:
            stats["solutions"] = jax.lax.psum(out["count"].sum(), axis)
        return scores, stats

    spec = P(axis)
    mapped = jax.shard_map(
        shardfn,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec, P()),
        # pallas_call outputs carry no varying-mesh-axes metadata; the
        # explicit in/out specs above are the contract
        check_vma=False,
    )
    return mapped(tops, sides, jnp.asarray(lens1), jnp.asarray(lens2))


def align_batch_sharded(
    tops,
    sides,
    lens1,
    lens2,
    *,
    m: int,
    k: int,
    d: int,
    mesh: Mesh,
    axis: str = "data",
    with_counts: bool = False,
) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    """Shard a pair batch over ``axis``, fill, and psum-merge run stats.

    Args:
      tops: int32/uint8[B, A]; sides: [B, Bs]; lens1/lens2: int32[B].
        B must divide evenly by the mesh axis size (pad with dummy pairs
        of length 0; they are masked out of the stats by
        ``lens1 > 0 | lens2 > 0``).
    Returns:
      (scores int32[B] — sharded over ``axis``,
       stats dict of replicated scalars: ``pairs``, ``score_sum``
       (int32 psum), ``score_min``, ``score_max``, ``cells`` (an exact
       host int: sum of len1*len2) and, with ``with_counts``,
       ``solutions`` — the psum of per-pair optimal alignment counts,
       uint32-wrapping like the reference's global counter.)
    """
    scores, stats = _align_batch_sharded(
        tops, sides, lens1, lens2, m=m, k=k, d=d, mesh=mesh, axis=axis,
        with_counts=with_counts,
    )
    stats["cells"] = _cells(lens1, lens2)
    return scores, stats


def _cells(lens1, lens2) -> int:
    """Exact sum of len1*len2 on the host: int32 device arithmetic
    overflows at real sizes (and int64 is int32 with x64 off).  A batch
    spread over several processes sums each process's own shards, then
    the per-process totals, sent as two int32 limbs of 30 bits."""
    if not isinstance(lens1, jax.Array) or lens1.is_fully_addressable:
        return int(
            (np.asarray(lens1, np.int64) * np.asarray(lens2, np.int64)).sum()
        )
    from jax.experimental import multihost_utils

    local = {}
    for s1, s2 in zip(lens1.addressable_shards, lens2.addressable_shards):
        local[str(s1.index)] = int(
            (np.asarray(s1.data, np.int64) * np.asarray(s2.data, np.int64)).sum()
        )
    total = sum(local.values())
    limbs = np.asarray([total >> 30, total & ((1 << 30) - 1)], np.int32)
    hi, lo = np.asarray(multihost_utils.process_allgather(limbs), np.int64).sum(0)
    return int((hi << 30) + lo)


def shard_batch(mesh: Mesh, axis: str, *arrays):
    """Place host arrays with a batch-sharded layout on the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return tuple(jax.device_put(a, sharding) for a in arrays)
