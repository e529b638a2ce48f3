"""Device compute kernels and host-side engines.

* :mod:`nw_tpu.ops.encode` — sequence encoding / padding / bucketing.
* :mod:`nw_tpu.ops.fill_scan` — anti-diagonal DP fill as a ``lax.scan``.
* :mod:`nw_tpu.ops.fill_rows` — one-lane-per-pair row-sweep GPU kernel
  (Pallas through Triton).
* :mod:`nw_tpu.ops.fill_auto` — the engine router.
* :mod:`nw_tpu.ops.checkpoint_traceback` — O(N)-memory exact traceback
  for huge pairs.
* :mod:`nw_tpu.ops.traceback` — vectorized single-path backward walk.
* :mod:`nw_tpu.ops.pathcount` — O(M*N) optimal-alignment counting and
  optimal-path marking (replaces exponential DFS when only counts/marks
  are needed).
* :mod:`nw_tpu.ops.enumerate_walk` — host all-optimal-alignments DFS
  (Python + native C++ fast path).
"""

from nw_tpu.ops.arrows import ARROW_DIAG, ARROW_LEFT, ARROW_UP

__all__ = ["ARROW_DIAG", "ARROW_LEFT", "ARROW_UP"]
