"""Finds the highest rate an open-loop cell's system sustains, once.

    python3 nksbench/sweep.py --workload NAME --seed N --seconds S \
        --rates 60,80,100,120

Builds the cell's system once, then runs the mix's open loop at each rate
in turn (a fresh runtime a rate, the same corpus and engine) and prints a
JSON line a rate: requests, failed, p50 and p95 latency from due time,
the answered requests over the window, and ``backlog``: the mean latency
of the window's last quarter of requests over that of its first quarter.
A rate is sustained where nothing failed and ``backlog`` stays near 1; a
growing queue makes it climb with the window. The cell's rate is then
fixed, as a number in its mix file, below the highest rate sustained: at
about 4/5 of it where the tails hold still from run to run there, lower
where they do not (``synth10m-d100.stream.q9k10``: 80/s, 0.62 of the
130/s sustained, since at 104/s its p95 swung by 40-60% between runs of
one seed; see PERF.md). The benchmark's runs never search for a rate.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    sys.argv = sys.argv[:1]
    from run import cache_env
    cache_env(ROOT)

    from harness.bench import Ctx
    from harness.spec import BENCH, cell, load_bench, load_module
    from harness.system import Spans
    from harness.traffic import make_traffic

    the_cell = cell(load_bench(ROOT), args.workload)
    if the_cell.mix["loop"] != "open":
        raise SystemExit(f"{args.workload} is not an open loop")
    ctx = Ctx(the_cell, args.seed, args.seconds, False, args.device,
              time.perf_counter())
    ctx.corpus = ctx.system.make_data(the_cell.config, args.seed)
    ctx.engine = ctx.system.build(the_cell.config, ctx.corpus, args.device)
    loop = load_module(BENCH / "loops" / "open.py")
    for rate in (float(r) for r in args.rates.split(",")):
        ctx.spans = Spans()
        ctx.system.instrument(ctx.engine, ctx.spans)
        ctx.traffic = make_traffic(the_cell.mix, ctx.corpus, args.seed,
                                   args.seconds, rate_qps=rate)
        win = loop.run(ctx)
        lat = win.latency_s
        due = ctx.traffic.due_s[[a is not None for a in win.answers]]
        q = max(1, len(lat) // 4)
        order = np.argsort(due, kind="stable")
        first, last = lat[order[:q]], lat[order[-q:]]
        print(json.dumps({
            "rate_qps": rate, "requests": len(win.answers),
            "failed": len(win.answers) - len(lat),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "answered_per_s": len(lat) / win.window_s,
            "backlog": float(last.mean() / max(first.mean(), 1e-9)),
            "mean_batch": win.runtime["batched_queries"]
            / max(win.runtime["batches"], 1),
            "setup_s": ctx.setup_s}), flush=True)
        del ctx.engine.query_batch      # the wrapper of this rate's spans
    return 0


if __name__ == "__main__":
    sys.exit(main())
