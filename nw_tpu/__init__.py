"""nw_tpu — an accelerator Needleman-Wunsch global-alignment engine (JAX).

A from-scratch re-design of the capabilities of the reference C99+pthreads
tool ``skotchandsoda/needleman-wunsch`` for a GPU:

* the DP score-table fill (reference ``needleman-wunsch.c:418-626``) becomes
  an anti-diagonal ``lax.scan`` wavefront (:mod:`nw_tpu.ops.fill_scan`,
  any backend, the oracle) and, for short reads on the GPU, a
  one-lane-per-pair row-sweep Pallas kernel (:mod:`nw_tpu.ops.fill_rows`)
  that emits scores, optimal-alignment counts and 2-bit greedy walk words;
* the traceback / all-optimal-alignment enumeration (reference
  ``needleman-wunsch.c:209-388``) becomes a device-side vectorized backward
  walk for single alignments (:mod:`nw_tpu.ops.traceback`), an O(M*N)
  path-counting pass (:mod:`nw_tpu.ops.pathcount`), and a host-side
  enumerator with a native C++ fast path (:mod:`nw_tpu.ops.enumerate`);
* scale comes from batching pairs (one pair per wavefront lane block),
  sharding batches over a ``jax.sharding.Mesh``
  (:mod:`nw_tpu.parallel.data_parallel`), and 2-D block-wavefront tiling of
  huge DP matrices across devices (:mod:`nw_tpu.parallel.wavefront`).

The CLI (:mod:`nw_tpu.cli`) is byte-for-byte compatible with the reference
binary's flag surface, stdout/stderr split, and formatting quirks.
"""

from nw_tpu.config import AlignConfig, ScoringParams
from nw_tpu.models.needleman_wunsch import (
    HugeAlignmentResult,
    NWAligner,
    align,
    align_batch,
)

__all__ = [
    "AlignConfig",
    "ScoringParams",
    "NWAligner",
    "HugeAlignmentResult",
    "align",
    "align_batch",
    # variants (lazy modules): nw_tpu.models.smith_waterman.sw_align /
    # sw_align_batch, nw_tpu.models.affine.affine_align /
    # affine_align_batch; huge pairs: NWAligner.align_huge /
    # summary_huge, nw_tpu.ops.hirschberg.hirschberg_align
]

__version__ = "0.1.0"
