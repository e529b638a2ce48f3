"""Configuration dataclasses for the alignment engine.

The reference configures a run entirely through CLI flags and three
positional operands (``needleman-wunsch.c:698-795``).  The library surface
here generalizes that into two dataclasses: :class:`ScoringParams` (the
``m k d`` operands, ``needleman-wunsch.c:654-689``) and
:class:`AlignConfig` (batching / bucketing / device-mapping knobs, which
have no reference equivalent — the reference is one pair per process).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ScoringParams:
    """Linear gap scoring: +m for match, -k for mismatch, -d per indel.

    Matches the reference semantics exactly (``needleman-wunsch.c:430-437``,
    ``:454``): candidate scores are ``diag + m`` on character equality,
    ``diag - k`` otherwise, and ``up - d`` / ``left - d`` for gaps.
    Values may be negative (the reference does not validate operands).
    """

    match: int = 1
    mismatch: int = 1
    indel: int = 1

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.match, self.mismatch, self.indel)


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Engine configuration.

    Attributes:
      scoring: the ``m k d`` scoring operands.
      bucket_sizes: length buckets for batched alignment; each input pair is
        padded up to the smallest bucket that fits so that compiled kernel
        shapes are reused across calls.  ``None`` disables bucketing
        (pad to per-call max length).
      traceback: whether the fill emits packed direction arrows (needed for
        any traceback / enumeration / table rendering).  Score-only fills
        are cheaper (reference equivalent: ``-q`` with no ``-l/-s/-t``,
        which skips ``construct_alignments``, needleman-wunsch.c:667).
      band: optional alignment band half-width (framework extension; the
        reference always fills the full table).  ``None`` = full fill.
      max_alignments: safety cap on all-optimal-alignment enumeration.
        The reference has no cap and can run forever
        (needleman-wunsch.c:231, README:196-197).  ``None`` reproduces the
        uncapped reference behavior.
      mesh_shape: optional device mesh shape ``(data, seq)`` used by the
        sharded batch/wavefront paths.
    """

    scoring: ScoringParams = dataclasses.field(default_factory=ScoringParams)
    # Dense ladder: DP work scales with the PRODUCT of the padded
    # lengths, so power-of-2 buckets cost up to 4x work at a boundary
    # (measured: 10240 -> 16384 made config-3 runs 2.5x slower).  ~1.2x
    # steps keep worst-case padding waste under ~45% quadratic; beyond
    # the ladder, lengths round to 1 KiB (<12% waste, one compile per
    # distinct kilo-length).
    bucket_sizes: Optional[Sequence[int]] = (
        64, 96, 128, 160, 192, 256, 320, 384, 512, 640, 768, 1024,
        1280, 1536, 2048, 2560, 3072, 4096, 5120, 6144, 8192,
    )
    traceback: bool = True
    band: Optional[int] = None
    max_alignments: Optional[int] = None
    mesh_shape: Optional[Tuple[int, int]] = None

    def bucket_for(self, length: int) -> int:
        """Smallest configured bucket that holds ``length`` characters."""
        if self.bucket_sizes:
            for b in self.bucket_sizes:
                if length <= b:
                    return b
            # beyond the ladder: next KiB (padding waste <12%, shapes
            # still coarse enough to reuse compilations)
            return -(-length // 1024) * 1024
        # Fall back to the next multiple of 128.
        return max(128, -(-length // 128) * 128)
