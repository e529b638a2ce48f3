"""Checkpoint/resume for long batch runs.

The reference is a single-shot process with no persistence (SURVEY §5);
at production scale a multi-hour batch alignment must survive
preemption.  A :class:`CheckpointedRunner` splits a pair batch into
chunks, persists each chunk's results (scores / counts / traceback ops)
as ``chunk_XXXXX.npz`` next to a manifest, and on restart skips chunks
whose files already exist — so a re-run after preemption costs only the
in-flight chunk.

Files are written atomically (tmp + rename), so a chunk file either
exists complete or not at all.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np


class CheckpointedRunner:
    def __init__(self, directory: str, chunk_size: int = 1024, key: str = ""):
        """``key`` identifies the computation (scoring params, engine,
        mode, ...).  It is stored in the manifest and checked on resume
        so a directory of chunk files from a *different* computation is
        rejected instead of silently concatenated into mixed results
        (ResumableHugePair keys its state the same way)."""
        self.directory = directory
        self.chunk_size = chunk_size
        self.key = key
        os.makedirs(directory, exist_ok=True)

    def _chunk_path(self, idx: int) -> str:
        return os.path.join(self.directory, f"chunk_{idx:05d}.npz")

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, "manifest.json")

    def run(
        self,
        pairs: Sequence[Tuple[bytes, bytes]],
        align_chunk: Callable[[Sequence[Tuple[bytes, bytes]]], Dict[str, np.ndarray]],
        progress: Optional[Callable[[int, int], None]] = None,
        retries: int = 0,
    ) -> Dict[str, np.ndarray]:
        """Run ``align_chunk`` over chunks, resuming from existing files.

        align_chunk: maps a list of pairs to a dict of equal-length
        arrays (e.g. {"scores": ...}).  Returns the concatenated dict.
        retries: re-attempt a failing chunk this many times before
        propagating (transient device/runtime failures requeue the
        shard instead of losing the whole run — SURVEY.md §5's elastic
        recovery; completed chunks are never recomputed either way).
        """
        n = len(pairs)
        nchunks = -(-n // self.chunk_size) if n else 0
        manifest = {
            "total_pairs": n,
            "chunk_size": self.chunk_size,
            "num_chunks": nchunks,
            "key": self.key,
        }
        mpath = self._manifest_path()
        if os.path.exists(mpath):
            old = json.loads(open(mpath).read())
            if (
                old["total_pairs"], old["chunk_size"], old.get("key", "")
            ) != (n, self.chunk_size, self.key):
                raise ValueError(
                    f"checkpoint dir {self.directory} was written by a "
                    f"different run shape/computation: {old}"
                )
        else:
            tmp = mpath + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, mpath)

        results = []
        for c in range(nchunks):
            path = self._chunk_path(c)
            if os.path.exists(path):
                results.append(dict(np.load(path)))
                if progress:
                    progress(c, nchunks)
                continue
            chunk = pairs[c * self.chunk_size : (c + 1) * self.chunk_size]
            attempt = 0
            while True:
                try:
                    out = align_chunk(chunk)
                    break
                except Exception:
                    attempt += 1
                    if attempt > retries:
                        raise
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(f, **out)
            os.replace(tmp, path)
            results.append({k: np.asarray(v) for k, v in out.items()})
            if progress:
                progress(c, nchunks)

        if not results:
            return {}
        keys = results[0].keys()
        return {k: np.concatenate([r[k] for r in results]) for k in keys}

    def completed_chunks(self) -> int:
        return sum(
            1
            for f in os.listdir(self.directory)
            if f.startswith("chunk_") and f.endswith(".npz")
        )


class ResumableHugePair:
    """Checkpoint/resume for the config-5 sharded huge-pair run
    (:mod:`nw_tpu.parallel.huge_pair`) — VERDICT r2 item 6: the tiled
    fill used to restart from phase 0 on preemption.

    The fill runs as spans of ``span`` pipeline phases through
    :func:`nw_tpu.parallel.huge_pair._huge_span_device`; after each
    span the per-device carry (boundary registers, halo queue, corner
    capture) plus the arrow planes produced so far are persisted
    atomically.  A killed run resumes from the last completed span; the
    final walk runs over the reassembled arrows and is bit-identical to
    the uninterrupted :func:`huge_pair_align_sharded`.
    """

    def __init__(self, directory: str, span: int = 4):
        self.directory = directory
        self.span = span
        os.makedirs(directory, exist_ok=True)

    def _state_path(self) -> str:
        return os.path.join(self.directory, "huge_state.npz")

    def run(
        self,
        top,
        side,
        m: int,
        k: int,
        d: int,
        mesh,
        axis: str = "seq",
        chunk: int = 64,
        traceback: bool = True,
        _abort_after_spans: Optional[int] = None,
    ):
        """Returns :class:`nw_tpu.parallel.huge_pair.HugeShardedResult`
        (or just the int score with ``traceback=False``)."""
        import jax.numpy as jnp

        from nw_tpu.parallel.huge_pair import (
            HugeShardedResult,
            _huge_span_device,
            _huge_walk_sharded,
            _stitch_segments,
            _tile_geometry,
            _tile_inputs,
            huge_state_init,
        )

        top = np.asarray(top)
        side = np.asarray(side)
        A, B = top.shape[0], side.shape[0]
        nseq = mesh.shape[axis]
        N_pad, _, _, nphases = _tile_geometry(A, B, nseq, chunk)
        side_sh, top_ext = _tile_inputs(jnp.asarray(top), jnp.asarray(side), N_pad)

        shape_key = dict(
            A=A, B=B, m=int(m), k=int(k), d=int(d), nseq=nseq,
            chunk=chunk, traceback=traceback, span=self.span,
        )
        spath = self._state_path()
        s0 = 0
        arr_spans: list = []
        state = None
        if os.path.exists(spath):
            saved = np.load(spath, allow_pickle=True)
            if json.loads(str(saved["key"])) != shape_key:
                raise ValueError(
                    f"checkpoint at {spath} is from a different run: "
                    f"{saved['key']}"
                )
            s0 = int(saved["s0"])
            state = {
                k2[3:]: saved[k2]
                for k2 in saved.files
                if k2.startswith("st_")
            }
            if traceback and "arr" in saved.files and s0 > 0:
                arr_spans = [saved["arr"]]
        if state is None:
            state = huge_state_init(A, B, mesh, axis, chunk)

        spans_done = 0
        while s0 < nphases:
            n_span = min(self.span, nphases - s0)
            state, arr = _huge_span_device(
                side_sh, top_ext, state, s0,
                A=A, B=B, m=int(m), k=int(k), d=int(d), mesh=mesh,
                axis=axis, chunk=chunk, span=n_span, traceback=traceback,
            )
            state = {k2: np.asarray(v) for k2, v in state.items()}
            if traceback:
                arr_spans.append(np.asarray(arr))
            s0 += n_span
            payload = dict(
                key=json.dumps(shape_key), s0=s0,
                **{f"st_{k2}": v for k2, v in state.items()},
            )
            if traceback:
                payload["arr"] = np.concatenate(arr_spans, axis=1)
                arr_spans = [payload["arr"]]
            tmp = spath + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, spath)
            spans_done += 1
            if (
                _abort_after_spans
                and spans_done >= _abort_after_spans
                and s0 < nphases
            ):
                raise KeyboardInterrupt("simulated preemption")

        cap = state["cap"]
        score = int(cap.reshape(nseq, -1).max())
        if not traceback:
            return score
        segs, seg_ns = _huge_walk_sharded(
            jnp.asarray(arr_spans[0]), np.int32(score),
            A=A, B=B, mesh=mesh, axis=axis, chunk=chunk,
        )
        ops = _stitch_segments(segs, seg_ns, nseq)
        return HugeShardedResult(score=score, ops=ops, n=len(ops))
