"""Multi-host (multi-process) initialization and sharded-run helpers.

The reference has no distributed backend at all — pthreads shared memory
only (Makefile:38, SURVEY §2.1).  Here multi-host runs are plain JAX
multi-process SPMD: every host calls :func:`init_distributed`, builds the
same global mesh over ``jax.devices()`` (which then spans all hosts),
feeds its local shard of the pair batch with
``jax.make_array_from_process_local_data``, and runs the same
``shard_map`` programs from :mod:`nw_tpu.parallel.data_parallel` — the
``psum`` stat merges ride NVLink within a host and the network across
hosts (XLA hands them to NCCL), with no code changes.

This module is exercised single-process in CI (the collectives are
identical); real multi-host bring-up is coordinator-address plumbing
only.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed from args or standard env vars.

    Uses ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` when args are omitted.  Returns True if a
    multi-process runtime was initialized, False for single-process runs
    (no env set) — callers need no branching either way.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return False
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0")
    )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_batch_from_local(mesh, axis: str, *local_arrays):
    """Assemble process-local batch shards into global sharded arrays.

    Each host passes only its own pairs; the returned arrays are global
    jax.Arrays sharded over ``axis`` and feed directly into
    ``align_batch_sharded``.
    """
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    return tuple(
        jax.make_array_from_process_local_data(sharding, a) for a in local_arrays
    )
