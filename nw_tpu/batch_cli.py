"""Production batch CLI: align many pairs from a file at device speed.

The reference binary processes one pair per process; this is the
batch/serving front-end the accelerator engine is built for:

    nw-tpu-batch --pairs pairs.txt --alignments --counts -m 2 -k 1 -d 1

Input: one pair per line, two whitespace-separated sequences (the same
byte alphabet rules as the reference reader).  Output: TSV to stdout
(or --out) with one row per input pair, preserving input order:

    index  score  [count]  [X  Y]

Engine: pairs are length-bucketed and chunked; each chunk runs through
NWAligner.align_batch (the engine nw_tpu.ops.fill_auto picks); --checkpoint-dir makes
the run resumable after preemption (runtime.CheckpointedRunner — chunks
already on disk are skipped).  --sort-by-length reduces padding waste
for mixed-length inputs (output order is still input order).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np


def _read_pairs(stream) -> List[Tuple[bytes, bytes]]:
    pairs = []
    for lineno, raw in enumerate(stream, 1):
        line = raw.strip()
        if not line:
            continue
        parts = line.split(None, 1)
        if len(parts) != 2:
            raise SystemExit(
                f"line {lineno}: expected two whitespace-separated "
                f"sequences, got {len(parts)}"
            )
        pairs.append((parts[0], parts[1].split(None, 1)[0]))
    return pairs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nw-tpu-batch",
        description="Batched Needleman-Wunsch alignment on the GPU",
    )
    ap.add_argument("--pairs", help="input file (default: stdin)")
    ap.add_argument("--out", help="output TSV (default: stdout)")
    ap.add_argument("-m", type=int, default=1, help="match bonus")
    ap.add_argument("-k", type=int, default=1, help="mismatch penalty")
    ap.add_argument("-d", type=int, default=1, help="indel penalty")
    ap.add_argument("--mode", choices=("nw", "sw", "overlap", "affine"),
                    default="nw",
                    help="global (nw), local (sw), semi-global (overlap), "
                    "or affine-gap scoring — the reference FUTURE WORK's "
                    "common 'align' tool (README:182-187)")
    ap.add_argument("--open", type=int, default=3, dest="gap_open",
                    help="affine gap-open cost (--mode affine)")
    ap.add_argument("--extend", type=int, default=1, dest="gap_extend",
                    help="affine gap-extend cost (--mode affine)")
    ap.add_argument("--counts", action="store_true",
                    help="emit optimal-alignment counts (mod 2^32; nw only)")
    ap.add_argument("--alignments", action="store_true",
                    help="emit one optimal alignment per pair")
    ap.add_argument("--chunk", type=int, default=2048,
                    help="pairs per device batch")
    ap.add_argument("--checkpoint-dir",
                    help="persist per-chunk results; reruns resume")
    ap.add_argument("--retries", type=int, default=0,
                    help="re-attempts per failing chunk (with --checkpoint-dir)")
    ap.add_argument("--sort-by-length", action="store_true",
                    help="bucket-sort pairs to reduce padding waste")
    args = ap.parse_args(argv)

    from nw_tpu.config import AlignConfig, ScoringParams
    from nw_tpu.models.needleman_wunsch import NWAligner

    src = open(args.pairs, "rb") if args.pairs else sys.stdin.buffer
    try:
        pairs = _read_pairs(src)
    finally:
        if args.pairs:
            src.close()

    order = np.arange(len(pairs))
    if args.sort_by_length:
        key = np.array([max(len(a), len(b)) for a, b in pairs])
        order = np.argsort(key, kind="stable")
        pairs = [pairs[i] for i in order]

    if args.counts and args.mode != "nw":
        raise SystemExit("--counts is only defined for --mode nw")

    al = NWAligner(AlignConfig(scoring=ScoringParams(args.m, args.k, args.d)))

    def align_chunk(chunk):
        if args.mode == "sw":
            from nw_tpu.models.smith_waterman import sw_align_batch, sw_score_batch

            if args.alignments:
                res = sw_align_batch(chunk, args.m, args.k, args.d)
                return {
                    "scores": np.array([r[0] for r in res], np.int32),
                    "X": np.array([r[1] for r in res], dtype=np.bytes_),
                    "Y": np.array([r[2] for r in res], dtype=np.bytes_),
                }
            return {"scores": sw_score_batch(chunk, args.m, args.k, args.d)}
        if args.mode == "overlap":
            from nw_tpu.models.overlap import (
                overlap_align_batch,
                overlap_score_batch,
            )

            if args.alignments:
                res = overlap_align_batch(chunk, args.m, args.k, args.d)
                return {
                    "scores": np.array([r[0] for r in res], np.int32),
                    "X": np.array([r[1] for r in res], dtype=np.bytes_),
                    "Y": np.array([r[2] for r in res], dtype=np.bytes_),
                }
            return {
                "scores": overlap_score_batch(chunk, args.m, args.k, args.d)
            }
        if args.mode == "affine":
            from nw_tpu.models.affine import affine_align_batch, affine_score_pairs

            if args.alignments:
                res = affine_align_batch(
                    chunk, args.m, args.k, args.gap_open, args.gap_extend
                )
                return {
                    "scores": np.array([r[0] for r in res], np.int32),
                    "X": np.array([r[1] for r in res], dtype=np.bytes_),
                    "Y": np.array([r[2] for r in res], dtype=np.bytes_),
                }
            return {
                "scores": affine_score_pairs(
                    chunk, args.m, args.k, args.gap_open, args.gap_extend
                )
            }
        r = al.align_batch(
            chunk, traceback_strings=args.alignments, count=args.counts
        )
        out = {"scores": r.scores}
        if args.counts:
            out["counts"] = r.counts
        if args.alignments:
            strs = r.alignment_strings()
            # fixed-width 'S' arrays: npz-serializable without pickle
            out["X"] = np.array([x for x, _ in strs], dtype=np.bytes_)
            out["Y"] = np.array([y for _, y in strs], dtype=np.bytes_)
        return out

    if args.checkpoint_dir:
        from nw_tpu.runtime.checkpoint import CheckpointedRunner

        # key the manifest on everything that shapes chunk results, so
        # resuming with different params/flags is rejected instead of
        # silently concatenating stale chunk files
        key = (
            f"mode={args.mode} m={args.m} k={args.k} d={args.d} "
            f"open={args.gap_open} extend={args.gap_extend} "
            f"counts={args.counts} alignments={args.alignments} "
            f"sorted={args.sort_by_length}"
        )
        runner = CheckpointedRunner(
            args.checkpoint_dir, chunk_size=args.chunk, key=key
        )
        res = runner.run(pairs, align_chunk, retries=args.retries)
    else:
        parts = [
            align_chunk(pairs[i : i + args.chunk])
            for i in range(0, len(pairs), args.chunk)
        ]
        res = (
            {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
            if parts
            else {}
        )

    # undo the length sort: emit rows in input order
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))

    dst = open(args.out, "w") if args.out else sys.stdout
    try:
        for i in range(len(pairs)):
            j = inv[i] if args.sort_by_length else i
            row = [str(i), str(int(res["scores"][j]))]
            if args.counts:
                row.append(str(int(res["counts"][j]) % 2**32))
            if args.alignments:
                x, y = res["X"][j], res["Y"][j]
                row.append(x.decode("latin-1") if isinstance(x, bytes) else str(x))
                row.append(y.decode("latin-1") if isinstance(y, bytes) else str(y))
            dst.write("\t".join(row) + "\n")
    finally:
        if args.out:
            dst.close()
    return 0


def console_main() -> None:
    from nw_tpu.cli import (
        _quiet_library_logging,
        apply_platform_override,
        enable_default_compile_cache,
    )

    _quiet_library_logging()
    apply_platform_override()
    enable_default_compile_cache()
    sys.exit(main())


if __name__ == "__main__":
    console_main()
