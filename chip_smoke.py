"""Smoke run of nw-tpu on NVIDIA GPUs: the main paths through the entry
points a user calls, at real sizes, each compared exactly with the
repo's plain references (every engine is int32 add/max, so every
comparison has tolerance 0).

    python chip_smoke.py            # one card: phases 1-8
    python chip_smoke.py --cards 4  # the multi-card paths only

Phases on one card:

1. devices, card name and power limit;
2. the CLI in-process: the README pair (``-s -t``, ``-l``) byte-equal to
   the golden bytes of tests/golden.py, and a 20 kb pair with ``-q -s``
   (the O(N)-memory score + count) vs fill_diag + count_paths;
3. 10,240 x 150 bp score-only through ``align_batch`` vs the scan fill;
4. 4,096 x 150 bp strings + counts through ``align_batch`` vs the scan
   arrows + count_paths + greedy traceback;
5. 128 x 10 kb strings + counts (config 3): every score recomputed from
   its alignment strings;
6. one 100 kb related pair: ``align_huge`` and ``summary_huge`` vs the
   tiled scan engine on a one-device mesh, the score three ways;
7. SW, overlap and affine at 128 x 3 kb with strings, every score
   recomputed from its strings;
8. the tests marked ``gpu`` (tests/test_gpu.py).

``--cards 4``: ``align_huge_sharded`` of a 100 kb pair over a 4-card
``("seq",)`` mesh bit-equal to the one-card ``align_huge``, and
``align_batch_sharded`` over ``("data",)`` equal to one-card
``align_batch`` scores and stats.

Inputs come from ``--seed``.  Every phase prints its wall time, the time
JAX spent compiling in it and the device's peak bytes in use; a failed
comparison raises, so the script exits non-zero and prints no result.
The last line is the JSON result.  It runs in one process that spawns no
other JAX process.
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def _related(rng, n, L, div):
    """``n`` pairs: a random sequence of length L and a copy with about
    ``div`` of its positions substituted, deleted or followed by an
    inserted base (the error model of sequencing reads against their
    reference)."""
    out = []
    for _ in range(n):
        a = rng.integers(0, 4, L)
        ev = rng.random(L)
        sub, dele, ins = ev < div / 3, (ev >= div / 3) & (ev < 2 * div / 3), (
            ev >= 2 * div / 3
        ) & (ev < div)
        b = np.where(sub, (a + rng.integers(1, 4, L)) % 4, a)
        reps = np.where(dele, 0, np.where(ins, 2, 1))
        b = np.repeat(b, reps)
        b[np.cumsum(reps)[ins] - 1] = rng.integers(0, 4, int(ins.sum()))
        acgt = np.frombuffer(b"ACGT", np.uint8)
        out.append((acgt[a].tobytes(), acgt[b].tobytes()))
    return out


def _linear_score(X, Y, m, k, d):
    x = np.frombuffer(X, np.uint8)
    y = np.frombuffer(Y, np.uint8)
    gap = (x == ord("-")) | (y == ord("-"))
    same = (x == y) & ~gap
    return int(same.sum() * m - (~same & ~gap).sum() * k - gap.sum() * d)


def _affine_score(X, Y, m, k, open_, extend):
    x = np.frombuffer(X, np.uint8)
    y = np.frombuffer(Y, np.uint8)
    gx, gy = x == ord("-"), y == ord("-")
    both = ~gx & ~gy
    score = int(((x == y) & both).sum() * m - ((x != y) & both).sum() * k)
    for g in (gx, gy):  # gap runs: open + (L-1) * extend
        runs = int((g & ~np.concatenate([[False], g[:-1]])).sum())
        score -= runs * open_ + (int(g.sum()) - runs) * extend
    return score


def _expect(cond, what):
    if not cond:
        raise AssertionError(what)


class Phase:
    """Wall time, compile time and peak device bytes of one phase."""

    compile_secs = 0.0

    def __init__(self, name, card):
        self.name, self.card = name, card

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = Phase.compile_secs
        print(f"[{self.name}] start", flush=True)
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            import jax

            stats = jax.devices()[0].memory_stats() or {}
            print(
                f"[{self.name}] passed: wall {time.perf_counter() - self.t0:.3f} s,"
                f" compile {Phase.compile_secs - self.c0:.3f} s,"
                f" peak_bytes_in_use {stats.get('peak_bytes_in_use')}"
                f" ({self.card})",
                flush=True,
            )


def _on_duration(event, secs, **_):
    if event.startswith("/jax/core/compile/"):
        Phase.compile_secs += secs


def phase_cli(seed, L=20_000):
    from nw_tpu import cli
    from nw_tpu.ops import pathcount
    from nw_tpu.ops.encode import encode
    from nw_tpu.ops.fill_scan import fill_diag

    # by path: an installed package may own the top-level name "tests"
    spec = importlib.util.spec_from_file_location(
        "nw_golden", os.path.join(REPO, "tests", "golden.py")
    )
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)

    def run(args, stdin):
        out, err = io.BytesIO(), io.BytesIO()
        rc = cli.main(
            ["needleman-wunsch", *args], stdin=io.BytesIO(stdin),
            stdout=out, stderr=err,
        )
        return rc, out.getvalue(), err.getvalue()

    got = run(["-s", "-t", "1", "1", "1"], g.README_INPUT)
    _expect(got == (0, g.README_ALIGNMENTS + g.README_TABLE, g.README_SUMMARY),
            "README -s -t bytes")
    _expect(run(["-l", "1", "1", "1"], b"GT GA") == (0, g.GT_GA_COUNTS, b""),
            "-l bytes")
    rc, out, _ = run(["-l", "1", "1", "1"], g.README_INPUT)
    want = [blk.split(b"\n") for blk in g.README_ALIGNMENTS.split(b"\n\n")[:3]]
    got = [blk.split(b"\n")[:2] for blk in out.split(b"\n\n")[:3]]
    _expect(rc == 0 and got == want, "README -l alignments")

    (a, b), = _related(np.random.default_rng(seed), 1, L, 0.01)
    rc, out, err = run(["-q", "-s", "2", "1", "1"], a + b" " + b)
    ref = fill_diag(encode(a), encode(b), 2, 1, 1)
    cnt = int(pathcount.count_paths(ref["arrows"], len(a), len(b)))
    signed = cnt - 2**32 if cnt >= 2**31 else cnt
    want = b"%d optimal alignment%s\nOptimal score is %d\n" % (
        signed, b"s" if cnt > 1 else b"", int(ref["score"])
    )
    _expect((rc, out, err) == (0, b"", want), f"-q -s {L}: {err!r} != {want!r}")
    print(f"  {len(a)}x{len(b)} -q -s: {err!r}", flush=True)


def phase_score_batch(seed, nb=10240, L=150):
    from nw_tpu import AlignConfig, align_batch
    from nw_tpu.ops.encode import encode_batch_u8
    from nw_tpu.ops.fill_auto import pick_engine
    from nw_tpu.ops.fill_scan import fill_scores_batch

    pairs = _related(np.random.default_rng(seed + 1), nb, L, 0.03)
    t0 = time.perf_counter()
    r = align_batch(pairs, 2, 1, 1)
    t1 = time.perf_counter()
    align_batch(pairs, 2, 1, 1)
    t2 = time.perf_counter()
    tops, sides, l1, l2 = encode_batch_u8(pairs)
    ref = np.asarray(fill_scores_batch(tops, sides, 2, 1, 1, l1, l2))
    _expect(np.array_equal(r.scores, ref), "score batch vs scan")
    bucket = AlignConfig().bucket_for
    engine = pick_engine(
        nb, bucket(tops.shape[1]), bucket(sides.shape[1]), need_arrows=False
    )
    print(
        f"  engine {engine}: first call {t1 - t0:.3f} s,"
        f" warm call {t2 - t1:.3f} s",
        flush=True,
    )


def phase_strings_counts(seed, nb=4096, L=150):
    from nw_tpu import align_batch
    from nw_tpu.ops.encode import encode_batch_u8
    from nw_tpu.ops.fill_auto import fill_batch
    from nw_tpu.ops.traceback import ops_to_strings_batch

    pairs = _related(np.random.default_rng(seed + 2), nb, L, 0.03)
    t0 = time.perf_counter()
    r = align_batch(pairs, 2, 1, 1, traceback_strings=True, count=True)
    strings = r.alignment_strings()
    t1 = time.perf_counter()
    align_batch(pairs, 2, 1, 1, traceback_strings=True, count=True).alignment_strings()
    t2 = time.perf_counter()
    tops, sides, l1, l2 = encode_batch_u8(pairs)
    ref = fill_batch(tops, sides, l1, l2, 2, 1, 1, engine="scan",
                     counts=True, strings=True)
    _expect(np.array_equal(r.scores, np.asarray(ref["score"])), "scores")
    _expect(np.array_equal(r.counts, np.asarray(ref["count"])), "counts")
    _expect(
        strings == ops_to_strings_batch(np.asarray(ref["ops"]), np.asarray(ref["n"]), pairs),
        "first-emission strings",
    )
    print(f"  first call {t1 - t0:.3f} s, warm call {t2 - t1:.3f} s", flush=True)


def phase_config3(seed, nb=128, L=10240):
    from nw_tpu import align_batch

    pairs = _related(np.random.default_rng(seed + 3), nb, L, 0.05)
    r = align_batch(pairs, 2, 1, 1, traceback_strings=True, count=True)
    for i, (X, Y) in enumerate(r.alignment_strings()):
        _expect(_linear_score(X, Y, 2, 1, 1) == int(r.scores[i]), f"pair {i}")
        _expect(X.replace(b"-", b"") == pairs[i][0], f"pair {i} s1")
        _expect(Y.replace(b"-", b"") == pairs[i][1], f"pair {i} s2")


def phase_huge(seed, L=100_000):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from nw_tpu import NWAligner
    from nw_tpu.ops.encode import encode
    from nw_tpu.ops.traceback import ops_to_strings
    from nw_tpu.parallel.huge_pair import huge_pair_align_sharded

    (a, b), = _related(np.random.default_rng(seed + 4), 1, L, 0.01)
    al = NWAligner(match=2, mismatch=1, indel=1)
    t0 = time.perf_counter()
    h = al.align_huge(a, b)
    t1 = time.perf_counter()
    score, count = al.summary_huge(a, b)
    t2 = time.perf_counter()
    mesh = Mesh(np.array(jax.devices()[:1]), ("seq",))
    ref = huge_pair_align_sharded(
        jnp.asarray(encode(a)), jnp.asarray(encode(b)), 2, 1, 1, mesh
    )
    t3 = time.perf_counter()
    _expect((h.X, h.Y) == ops_to_strings(ref.ops, ref.n, a, b), "huge ops")
    _expect(
        _linear_score(h.X, h.Y, 2, 1, 1) == h.score == score == ref.score,
        f"huge score {h.score} {score} {ref.score}",
    )
    print(
        f"  align_huge {t1 - t0:.3f} s, summary_huge {t2 - t1:.3f} s,"
        f" tiled scan engine {t3 - t2:.3f} s; score {score}, count {count}",
        flush=True,
    )


def phase_variants(seed, nb=128, L=3072):
    from nw_tpu.models.affine import affine_align_batch
    from nw_tpu.models.overlap import overlap_align_batch
    from nw_tpu.models.smith_waterman import sw_align_batch

    pairs = _related(np.random.default_rng(seed + 5), nb, L, 0.05)
    for i, (sc, X, Y, _) in enumerate(sw_align_batch(pairs, 2, 1, 1)):
        _expect(_linear_score(X, Y, 2, 1, 1) == sc, f"SW pair {i}")
    for i, (sc, X, Y, _, _) in enumerate(overlap_align_batch(pairs, 2, 1, 1)):
        _expect(_linear_score(X, Y, 2, 1, 1) == sc, f"overlap pair {i}")
    for i, (sc, X, Y) in enumerate(affine_align_batch(pairs, 2, 1, 3, 1)):
        _expect(_affine_score(X, Y, 2, 1, 3, 1) == sc, f"affine pair {i}")


def phase_gpu_tests():
    import pytest

    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(REPO, "tests", "test_gpu.py")]
    )
    _expect(rc == 0, f"gpu tests exit {rc}")


def phase_multicard(seed, cards, L=100_000, nb=10240):
    import jax
    from jax.sharding import Mesh

    from nw_tpu import NWAligner
    from nw_tpu.ops.encode import encode_batch_u8
    from nw_tpu.parallel.data_parallel import align_batch_sharded, shard_batch

    devs = jax.devices()[:cards]
    (a, b), = _related(np.random.default_rng(seed + 4), 1, L, 0.01)
    al = NWAligner(match=2, mismatch=1, indel=1)
    t0 = time.perf_counter()
    many = al.align_huge_sharded(a, b, Mesh(np.array(devs), ("seq",)))
    t1 = time.perf_counter()
    one = al.align_huge(a, b)
    t2 = time.perf_counter()
    _expect((many.score, many.X, many.Y) == (one.score, one.X, one.Y),
            "4-card huge pair != one-card")
    print(f"  align_huge_sharded x{cards} {t1 - t0:.3f} s,"
          f" one-card align_huge {t2 - t1:.3f} s", flush=True)

    pairs = _related(np.random.default_rng(seed + 1), nb, 150, 0.03)
    tops, sides, l1, l2 = encode_batch_u8(pairs)
    mesh = Mesh(np.array(devs), ("data",))
    t0 = time.perf_counter()
    scores, stats = align_batch_sharded(
        *shard_batch(mesh, "data", tops, sides, l1, l2),
        m=2, k=1, d=1, mesh=mesh, with_counts=True,
    )
    scores = np.asarray(scores)
    t1 = time.perf_counter()
    r = al.align_batch(pairs, count=True)
    _expect(np.array_equal(scores, r.scores), "sharded scores")
    want = {
        "pairs": nb,
        "score_sum": int(r.scores.astype(np.int64).sum()),
        "score_min": int(r.scores.min()),
        "score_max": int(r.scores.max()),
        "cells": int((l1.astype(np.int64) * l2).sum()),
        "solutions": int(r.counts.astype(np.uint64).sum() % 2**32),
    }
    got = {key: int(np.asarray(v)) for key, v in stats.items()}
    _expect(got == want, f"sharded stats {got} != {want}")
    print(f"  align_batch_sharded x{cards} {t1 - t0:.3f} s: {got}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform})",
              file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: {args.cards} cards asked, {len(devices)} found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from nw_tpu.cli import enable_default_compile_cache

    enable_default_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    with Phase("1 devices", card):
        print(f"  {devices}", flush=True)
        print(f"  device_kind {devices[0].device_kind!r}, count {len(devices)}",
              flush=True)
        print(f"  {smi}", flush=True)
    if args.cards == 1:
        with Phase("2 cli", card):
            phase_cli(args.seed)
        with Phase("3 score 10240x150bp", card):
            phase_score_batch(args.seed)
        with Phase("4 strings+counts 4096x150bp", card):
            phase_strings_counts(args.seed)
        with Phase("5 strings+counts 128x10kb", card):
            phase_config3(args.seed)
        with Phase("6 huge pair 1x100kb", card):
            phase_huge(args.seed)
        with Phase("7 SW/overlap/affine 128x3kb", card):
            phase_variants(args.seed)
        with Phase("8 gpu-marked tests", card):
            phase_gpu_tests()
    else:
        with Phase(f"multi-card x{args.cards}", card):
            phase_multicard(args.seed, args.cards)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
