"""Time ``align_batch`` end to end on the GPU with the router pinned to
each batch engine: the row-sweep kernel ("rows") vs XLA's scan ("scan").

    python scripts/compare_engines.py [--trials 7]

Cells: 10,240 x 150 bp score-only and 4,096 x 150 bp strings + counts
(random related pairs, 3% divergence, seed 0).  Each cell warms both
engines, checks that they return identical scores, counts and strings,
then times them in turns (rows, scan, scan, rows, ...).  Every timed
call ends in host results (strings built), so it includes host
encoding, transfers and string building.  One JSON line per cell and
engine: median, min and max seconds, with the card name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=7)
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"needs a GPU; found {jax.devices()[0].platform}")
    import numpy as np

    import nw_tpu.ops.fill_auto as fa
    from chip_smoke import _related
    from nw_tpu import align_batch
    from nw_tpu.cli import enable_default_compile_cache

    enable_default_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    pick = fa.pick_engine

    def run(pairs, engine, strings):
        fa.pick_engine = lambda *a, **kw: engine
        try:
            r = align_batch(
                pairs, 2, 1, 1, traceback_strings=strings, count=strings
            )
            return r, r.alignment_strings() if strings else None
        finally:
            fa.pick_engine = pick

    for nb, strings in ((10240, False), (4096, True)):
        pairs = _related(np.random.default_rng(0), nb, 150, 0.03)
        (ra, sa), (rb, sb) = run(pairs, "rows", strings), run(pairs, "scan", strings)
        assert np.array_equal(ra.scores, rb.scores) and sa == sb
        if strings:
            assert np.array_equal(ra.counts, rb.counts)
        times = {"rows": [], "scan": []}
        for t in range(args.trials):
            for engine in (("rows", "scan") if t % 2 == 0 else ("scan", "rows")):
                t0 = time.perf_counter()
                run(pairs, engine, strings)
                times[engine].append(time.perf_counter() - t0)
        for engine, ts in times.items():
            print(json.dumps({
                "cell": f"{nb}x150bp {'strings+counts' if strings else 'score-only'}",
                "engine": engine,
                "median_s": statistics.median(ts),
                "min_s": min(ts),
                "max_s": max(ts),
                "trials": len(ts),
                "card": card,
            }), flush=True)


if __name__ == "__main__":
    main()
