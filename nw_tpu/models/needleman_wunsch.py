"""The flagship model: batched global alignment with linear gap penalties.

Library equivalent of the reference driver ``needleman_wunsch()``
(needleman-wunsch.c:654-689), re-shaped for accelerator execution:

* one call aligns a *batch* of pairs (the reference: one pair per
  process); pairs are padded into length buckets so compiled shapes are
  reused;
* the fill runs on device, on the engine :mod:`nw_tpu.ops.fill_auto`
  picks (the row-sweep GPU kernel or the ``lax.scan`` wavefront);
* traceback is a device walk for first-optimal alignments, or a host
  enumeration (native C++ fast path) for *all* optimal alignments;
* counting / optimal-path marking are O(M*N) device scans
  (:mod:`nw_tpu.ops.pathcount`) instead of the reference's exponential
  DFS (needleman-wunsch.c:231-331).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nw_tpu.config import AlignConfig, ScoringParams
from nw_tpu.ops import encode as enc
from nw_tpu.ops import enumerate_walk, pathcount, traceback
from nw_tpu.ops.fill_scan import diag_to_matrix, fill_diag, fill_score_count


def _as_bytes(s: str | bytes) -> bytes:
    return s.encode() if isinstance(s, str) else bytes(s)


@dataclasses.dataclass
class AlignmentResult:
    """Result for a single pair."""

    s1: bytes
    s2: bytes
    score: int
    solution_count: int
    arrows_diag: Optional[np.ndarray] = None  # uint8[K, N] diagonal-major
    scores_diag: Optional[np.ndarray] = None  # int32[K, N]

    @property
    def arrows(self) -> np.ndarray:
        """Rectangular uint8[N, M] arrow matrix."""
        return diag_to_matrix(self.arrows_diag, len(self.s1), len(self.s2))

    @property
    def score_matrix(self) -> np.ndarray:
        return diag_to_matrix(self.scores_diag, len(self.s1), len(self.s2))

    def alignments(
        self, max_alignments: Optional[int] = None
    ) -> Iterator[Tuple[bytes, bytes]]:
        """All optimal alignments in reference DFS order (diag>left>up)."""
        return enumerate_walk.iter_alignments(
            self.arrows, self.s1, self.s2, max_alignments
        )

    def best_alignment(self) -> Tuple[bytes, bytes]:
        """First optimal alignment (== the reference's first-emitted one)."""
        for a in self.alignments(max_alignments=1):
            return a
        return b"", b""


@dataclasses.dataclass
class BatchResult:
    """Result for a batch of pairs."""

    scores: np.ndarray  # int32[B] optimal scores
    counts: Optional[np.ndarray] = None  # uint32[B] optimal-alignment counts
    ops: Optional[np.ndarray] = None  # int8[B, S] greedy traceback op codes
    ops_len: Optional[np.ndarray] = None  # int32[B]
    status: Optional[np.ndarray] = None  # uint8[B]: 0 = ok, 1 = rejected
    _pairs: Optional[Sequence[Tuple[bytes, bytes]]] = None

    STATUS_OK = 0
    STATUS_TOO_LONG = 1

    def alignment_strings(self) -> List[Tuple[bytes, bytes]]:
        """One (first-)optimal aligned pair of byte strings per input."""
        assert self.ops is not None, "batch was run without traceback"
        return traceback.ops_to_strings_batch(self.ops, self.ops_len, self._pairs)


@dataclasses.dataclass
class HugeAlignmentResult:
    """Result of :meth:`NWAligner.align_huge` — the first-optimal
    alignment without any per-cell table state."""

    s1: bytes
    s2: bytes
    score: int
    X: bytes  # aligned top string (with '-' gaps)
    Y: bytes  # aligned side string


class NWAligner:
    """Needleman-Wunsch aligner configured once, applied to many inputs."""

    def __init__(self, config: AlignConfig | None = None, **scoring_kwargs):
        if config is None:
            config = AlignConfig(scoring=ScoringParams(**scoring_kwargs))
        self.config = config

    # ---------------- single pair (CLI / exploratory path) ----------------

    def align(self, s1: str | bytes, s2: str | bytes) -> AlignmentResult:
        """Align one pair, returning full arrows + scores for enumeration
        and table rendering.

        Mirrors init_computation + compute_table_scores
        (computation.c:145-191, needleman-wunsch.c:583-626) followed by
        the O(M*N) solution count.
        """
        s1b, s2b = _as_bytes(s1), _as_bytes(s2)
        m, k, d = self.config.scoring.as_tuple()
        top = enc.encode(s1b)
        side = enc.encode(s2b)
        out = fill_diag(top, side, m, k, d, with_scores=True)
        if len(s1b) == 0 and len(s2b) == 0:
            count = 0  # reference DFS emits nothing on a 1x1 table
        else:
            count = int(pathcount.count_paths(out["arrows"], len(s1b), len(s2b)))
        return AlignmentResult(
            s1=s1b,
            s2=s2b,
            score=int(out["score"]),
            solution_count=count,
            arrows_diag=np.asarray(out["arrows"]),
            scores_diag=np.asarray(out["scores"]),
        )

    def align_huge(
        self,
        s1: str | bytes,
        s2: str | bytes,
        block_diagonals: Optional[int] = None,
    ) -> "HugeAlignmentResult":
        """Exact first-optimal alignment of ONE huge pair (100kb+).

        The alignment is byte-identical to the reference DFS's
        *first-emitted* one (needleman-wunsch.c:305-324) — unlike
        Hirschberg (:func:`nw_tpu.ops.hirschberg.hirschberg_align`),
        which returns an arbitrary optimal alignment.  The reference
        itself cannot trace back pairs at this scale at all (136 B/cell
        of table state, SURVEY.md §6: 13.6 GB at 10k x 10k).

        Route: the checkpointed re-fill traceback
        (:mod:`nw_tpu.ops.checkpoint_traceback`): two fill passes, only
        ``O(K*N/C + C*N)`` memory, any length.
        """
        s1b, s2b = _as_bytes(s1), _as_bytes(s2)
        top = jnp.asarray(enc.encode(s1b))
        side = jnp.asarray(enc.encode(s2b))
        ops, n, score = self._huge_ops(top, side, block_diagonals)
        X, Y = traceback.ops_to_strings(ops, n, s1b, s2b)
        return HugeAlignmentResult(s1=s1b, s2=s2b, score=score, X=X, Y=Y)

    def _huge_ops(self, top, side, block_diagonals=None):
        """(ops int8[n], n, score) for ONE huge pair through the
        checkpointed re-fill traceback."""
        from nw_tpu.ops.checkpoint_traceback import traceback_checkpointed

        m, k, d = self.config.scoring.as_tuple()
        ops, n, score = jax.device_get(
            traceback_checkpointed(
                top, side, m, k, d, block_diagonals=block_diagonals
            )
        )
        return ops, int(n), int(score)

    def align_huge_sharded(
        self,
        s1: str | bytes,
        s2: str | bytes,
        mesh,
        axis: str = "seq",
        chunk: Optional[int] = None,
    ) -> "HugeAlignmentResult":
        """Exact first-optimal alignment of ONE pair too large for a
        single device: the DP matrix is tiled over ``mesh``'s ``axis``
        (BASELINE config 5 — 2-D block wavefront, chunked halo
        collectives, per-device arrow storage, segment-relay walk; see
        :mod:`nw_tpu.parallel.huge_pair`).  Byte-identical to the
        reference DFS's first-emitted alignment."""
        from nw_tpu.parallel.huge_pair import huge_pair_align_sharded

        s1b, s2b = _as_bytes(s1), _as_bytes(s2)
        m, k, d = self.config.scoring.as_tuple()
        r = huge_pair_align_sharded(
            jnp.asarray(enc.encode(s1b)), jnp.asarray(enc.encode(s2b)),
            m, k, d, mesh, axis=axis, chunk=chunk,
        )
        X, Y = traceback.ops_to_strings(r.ops, r.n, s1b, s2b)
        return HugeAlignmentResult(s1=s1b, s2=s2b, score=r.score, X=X, Y=Y)

    def summary_huge(
        self, s1: str | bytes, s2: str | bytes
    ) -> Tuple[int, int]:
        """(optimal score, solution count mod 2^32) of ONE huge pair in
        a single O(N)-memory pass (:func:`nw_tpu.ops.fill_scan.fill_score_count`)
        — the reference ``-s`` summary (computation.c:271-281) at scales
        where no table can be materialized."""
        s1b, s2b = _as_bytes(s1), _as_bytes(s2)
        m, k, d = self.config.scoring.as_tuple()
        sc, cnt = fill_score_count(
            jnp.asarray(enc.encode(s1b)), jnp.asarray(enc.encode(s2b)), m, k, d
        )
        count = 0 if not s1b and not s2b else int(cnt)
        return int(sc), count

    def _align_batch_huge_pairs(
        self, norm, status, traceback_strings, count
    ) -> "BatchResult":
        """A batch of HUGE pairs, one pair at a time through the
        O(N)-memory routes (see the dispatch in align_batch): strings
        ride :meth:`_huge_ops` (checkpointed re-fill, first-emission
        exact), counts the fused score+count pass (:meth:`summary_huge`)."""
        nb = len(norm)
        scores = np.zeros(nb, np.int32)
        counts = np.zeros(nb, np.uint32) if count else None
        ops_rows: List[np.ndarray] = []
        ns = np.zeros(nb, np.int32)
        for i, (a, b) in enumerate(norm):
            if traceback_strings:
                top = jnp.asarray(enc.encode(a))
                side = jnp.asarray(enc.encode(b))
                ops, n, scores[i] = self._huge_ops(top, side)
                ops_rows.append(ops[:n])
                ns[i] = n
            if count:
                scores[i], counts[i] = self.summary_huge(a, b)
        result = BatchResult(scores=scores, status=status, _pairs=norm)
        if count:
            result.counts = counts
        if traceback_strings:
            S = max((len(a) + len(b) for a, b in norm), default=1)
            ops_arr = np.full((nb, max(S, 1)), traceback.OP_NONE, np.int8)
            for i, row in enumerate(ops_rows):
                ops_arr[i, : len(row)] = row
            result.ops = ops_arr
            result.ops_len = ns
        return result

    # ---------------- batched (production path) ----------------

    def align_batch(
        self,
        pairs: Sequence[Tuple[str | bytes, str | bytes]],
        traceback_strings: bool = False,
        count: bool = False,
        max_length: Optional[int] = None,
        on_error: str = "raise",
    ) -> BatchResult:
        """Score a batch of pairs on device (one DP table per pair).

        The engine is chosen by :func:`nw_tpu.ops.fill_auto.pick_engine`
        from the backend, the mode and the padded shapes.

        Failure isolation (reference equivalent: none — every error is a
        fatal ``check()`` exit, dbg.h:96-100): with ``on_error="mask"``,
        pairs longer than ``max_length`` are masked out of the batch and
        reported per-pair in ``result.status`` instead of failing the
        whole run.

        Batches whose engine stores per-cell traceback state are
        auto-split into sub-batches that fit
        :func:`nw_tpu.ops.fill_auto.arrow_budget_bytes` (a 10kb pair's
        uint8 arrows are ~200 MB; the whole batch need not fit at once).
        """
        from nw_tpu.ops import fill_auto

        m, k, d = self.config.scoring.as_tuple()
        norm = [(_as_bytes(a), _as_bytes(b)) for a, b in pairs]
        need_arrows = traceback_strings or count

        def route(batch):
            L1 = self.config.bucket_for(max((len(a) for a, _ in batch), default=1))
            L2 = self.config.bucket_for(max((len(b) for _, b in batch), default=1))
            return L1, L2, fill_auto.pick_engine(
                len(batch), L1, L2, need_arrows=need_arrows
            )

        L1, L2, engine = route(norm)
        per_pair = fill_auto.pair_bytes(engine, L1, L2, count, traceback_strings)
        chunk = (
            max(1, fill_auto.arrow_budget_bytes() // per_pair)
            if per_pair else len(norm)
        )
        if chunk < len(norm):
            parts = [
                self.align_batch(
                    norm[i : i + chunk],
                    traceback_strings=traceback_strings,
                    count=count,
                    max_length=max_length,
                    on_error=on_error,
                )
                for i in range(0, len(norm), chunk)
            ]
            merged = BatchResult(
                scores=np.concatenate([p.scores for p in parts]),
                status=np.concatenate([p.status for p in parts]),
                _pairs=norm,
            )
            if count:
                merged.counts = np.concatenate([p.counts for p in parts])
            if traceback_strings:
                S = max(p.ops.shape[1] for p in parts)
                merged.ops = np.concatenate(
                    [
                        np.pad(
                            p.ops, ((0, 0), (0, S - p.ops.shape[1])),
                            constant_values=traceback.OP_NONE,
                        )
                        for p in parts
                    ]
                )
                merged.ops_len = np.concatenate([p.ops_len for p in parts])
            return merged
        status = np.zeros((len(norm),), np.uint8)
        if max_length is not None:
            bad = [
                i
                for i, (a, b) in enumerate(norm)
                if len(a) > max_length or len(b) > max_length
            ]
            if bad and on_error == "raise":
                raise ValueError(
                    f"{len(bad)} pair(s) exceed max_length={max_length} "
                    f"(first: index {bad[0]}); pass on_error='mask' to "
                    "isolate them"
                )
            for i in bad:
                status[i] = BatchResult.STATUS_TOO_LONG
                norm[i] = (b"", b"")
            L1, L2, engine = route(norm)

        if engine == "huge":
            return self._align_batch_huge_pairs(
                norm, status, traceback_strings, count
            )
        # uint8 upload (4x smaller than int32); every engine casts on
        # device and reads only true-rectangle cells, so the 0 pad is
        # equivalent to the sentinels (tests/test_encode_u8.py)
        tops, sides, lens1, lens2 = enc.encode_batch_u8(norm, L1, L2)
        out = fill_auto.fill_batch(
            tops, sides, lens1, lens2, m, k, d, engine=engine,
            counts=count, strings=traceback_strings,
        )
        # one device round-trip for all outputs
        out = jax.device_get(out)
        result = BatchResult(scores=out["score"], status=status, _pairs=norm)
        if count:
            result.counts = out["count"]
        if traceback_strings:
            result.ops = out["ops"]
            result.ops_len = out["n"]
        return result


def align(s1, s2, m: int = 1, k: int = 1, d: int = 1) -> AlignmentResult:
    """One-shot single-pair alignment (reference CLI semantics)."""
    return NWAligner(AlignConfig(scoring=ScoringParams(m, k, d))).align(s1, s2)


def align_batch(pairs, m: int = 1, k: int = 1, d: int = 1, **kw) -> BatchResult:
    """One-shot batched alignment."""
    return NWAligner(AlignConfig(scoring=ScoringParams(m, k, d))).align_batch(
        pairs, **kw
    )
