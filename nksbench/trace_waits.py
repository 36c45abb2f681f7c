"""Where an open-loop cell's requests wait: the serving runtime's span log
and the device's idle gaps, over windows of the cell.

    python3 nksbench/trace_waits.py --workload NAME --seeds 11,12,13 \
        --seconds 51 --logs 0,1 [--trace 1]

Builds the cell's system once, from the first seed, then runs the mix's
open loop once a (seed, log) pair, the logs in the order given for the
first seed and reversed for every other one, so that neither side always
runs first: a fresh runtime with its span log off (0) or sized to hold
every batch of the window (1), and the seed's traffic. It prints a JSON
line a window, and appends it to ``--out`` where given:

* ``p50_ms``, ``p95_ms``: the cell's end-to-end metrics, read as the
  benchmark reads them (due time to answer), so that the log's cost shows
  from windows with it off and on;
* from the runtime's counters over the window: ``coalesce_wait_ms`` (the
  window's ``t_window_s`` a request), the mean queue wait and the share of
  batches that waited out the coalescing window;
* with the log on, from its batches (``harness/waits.py``):
  ``queue_wait_ms`` and ``batchmate_wait_ms`` (95th percentiles), the
  median and 95th percentile of each part of a request's time, and
  ``untiled_ms``, the median of the engine lock and the call's entry: what
  the queue, batchmate, own packing and dispatch, and readback-to-answer
  parts leave of a request's latency;
* with ``--trace 1``, under the benchmark's profiler (``harness/trace.py``)
  with a clock label just inside each end of the window: ``device_idle``
  and the gaps named by the profiler's host events as ``trace.reduce``
  names them (``idle_gaps_harness``), and with the log on ``idle_queued``
  (the window's share idle while a request is in hand), the idle time
  named by the program's spans (``idle_gaps``), and the anchor's error
  (``anchor_error_us``: the window label's anchor, then the end's label).
  It takes one window: the benchmark's traced run profiles one window a
  process, and on the card a second profiled window in one process
  stalled the runtime's worker for seconds.

The benchmark's own runs leave the span log off; this tool reads it
beside them, until the benchmark's traced run reads it itself and this
tool goes (ROADMAP.md, "Held until a `benchmark` PR").
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _windows(the_cell, seeds, seconds, logs, trace, device):
    """One result a (seed, log) pair, on one engine built from
    ``seeds[0]``."""
    from harness.bench import Ctx
    from harness.spec import BENCH, load_module
    from harness.traffic import make_traffic

    first = Ctx(the_cell, seeds[0], seconds, trace, device,
                time.perf_counter())
    corpus = first.system.make_data(the_cell.config, seeds[0])
    engine = first.system.build(the_cell.config, corpus, device)
    loop = load_module(BENCH / "loops" / "open.py")
    for i, seed in enumerate(seeds):
        for log in (logs if i % 2 == 0 else logs[::-1]):
            yield _window(the_cell, corpus, engine, loop, make_traffic,
                          seed, seconds, log, trace, device)


@contextlib.contextmanager
def _runtimes():
    """The serving runtimes that the open loop makes meanwhile."""
    from repro_torch.serve import runtime

    made, base = [], runtime.ServingRuntime

    class Kept(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    runtime.ServingRuntime = Kept
    try:
        yield made
    finally:
        runtime.ServingRuntime = base


def _ctx_class():
    from harness.bench import Ctx
    from harness.waits import stamp_clock

    class WaitCtx(Ctx):
        """The run's context, with the runtime's counters at the end of
        set-up and a clock label inside each end of a traced window;
        ``runtimes`` lists the runtimes made for the run."""

        def setup_done(self) -> None:
            super().setup_done()
            self.stats0 = dataclasses.replace(self.runtimes[-1].stats)

        @contextlib.contextmanager
        def window(self):
            with super().window():
                if self.trace:
                    stamp_clock(self.holder)
                yield
                if self.trace:
                    stamp_clock(self.holder)

    return WaitCtx


def _window(the_cell, corpus, engine, loop, make_traffic, seed, seconds,
            log, trace, device) -> dict:
    from harness import trace as tracemod
    from harness import waits
    from harness.readers import latency_ms

    mix = copy.deepcopy(the_cell.mix)
    n_warm = int(mix.get("warmup", 32))
    traffic = make_traffic(mix, corpus, seed, seconds)
    if log:
        mix.setdefault("runtime", {})["span_log"] = \
            len(traffic.queries) + n_warm
    ctx = _ctx_class()(dataclasses.replace(the_cell, mix=mix), seed,
                       seconds, trace, device, time.perf_counter())
    ctx.corpus, ctx.engine, ctx.traffic = corpus, engine, traffic
    ctx.system.instrument(engine, ctx.spans)
    try:
        with _runtimes() as made:
            ctx.runtimes = made
            ctx.win = loop.run(ctx)
    finally:
        del engine.query_batch          # this window's wrapper
    rt, s0 = made[-1], ctx.stats0
    n = len(ctx.win.answers)
    batches = ctx.win.runtime["batches"]
    out = {"seed": seed, "span_log": bool(log), "trace": bool(trace),
           "p50_ms": latency_ms(ctx, 50), "p95_ms": latency_ms(ctx, 95),
           "requests": n, "failed": n - len(ctx.win.latency_s),
           "batches": batches,
           "coalesce_wait_ms": (rt.stats.t_window_s - s0.t_window_s)
           * 1e3 / max(n, 1),
           "queue_wait_ms_mean": (rt.stats.t_queue_s - s0.t_queue_s)
           * 1e3 / max(n, 1),
           "window_wait_share": (rt.stats.window_waits - s0.window_waits)
           / max(batches, 1),
           "pack_ms": ctx.spans.total("pack_s") * 1e3
           / max(ctx.spans.queries(), 1),
           "dispatch_ms": ctx.spans.total("dispatch_s") * 1e3
           / max(ctx.spans.queries(), 1)}
    table = spans = None
    if log:
        kept = waits.window_batches(rt.spans(), n_warm)
        table, spans = waits.request_table(kept), waits.program_spans(kept)
        parts = waits.waits_ms(table)
        out.update(
            logged_requests=len(table["rid"]),
            queue_wait_ms=waits.percentile(parts["queue"], 95),
            batchmate_wait_ms=waits.percentile(parts["batchmate"], 95),
            not_first_share=float(np.mean(table["pos"] > 0)),
            median_ms={k: waits.percentile(v, 50) for k, v in parts.items()},
            p95_part_ms={k: waits.percentile(v, 95)
                         for k, v in parts.items()},
            untiled_ms=waits.percentile(parts["lock"] + parts["entry"], 50),
            pack_ms_logged=float(parts["pack"].mean()),
            dispatch_ms_logged=float(parts["dispatch"].mean()))
    if trace and "prof" in ctx.holder:
        prof = ctx.holder.pop("prof")
        traced = tracemod.reduce(
            prof, {k: (m, ctx.launches.get(k, 0))
                   for k, m in ctx.system.KERNELS.items()},
            [(s.start, s.end) for s in ctx.spans.items],
            ctx.holder.get("t0_perf"))
        if traced is not None:
            out.update(device_idle=100.0 * (1.0 - traced["busy_s"]
                                            / traced["window_s"]),
                       busy_s=traced["busy_s"], window_s=traced["window_s"],
                       idle_gaps_harness=traced["idle_gaps"])
        if log:
            tl = waits.timeline(prof, ctx.holder["t0_perf"],
                                ctx.holder.get("clock", ()))
            out.update(idle_queued=waits.idle_queued(tl, table),
                       anchor_error_us=tl.anchor_error_us(),
                       idle_gaps=waits.name_gaps(tl, table, spans))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--logs", default="0,1")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="a JSON-lines file to append to")
    args = ap.parse_args()
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    sys.argv = sys.argv[:1]
    from run import cache_env
    cache_env(ROOT)

    import torch

    from harness.spec import cell, load_bench

    the_cell = cell(load_bench(ROOT), args.workload)
    if the_cell.mix["loop"] != "open":
        raise SystemExit(f"{args.workload} is not an open loop")
    seeds = [int(s) for s in args.seeds.split(",")]
    logs = [int(x) for x in args.logs.split(",")]
    if args.trace and len(seeds) * len(logs) > 1:
        raise SystemExit("--trace 1 takes one seed and one log setting")
    if args.device == "cuda":
        torch.set_num_threads(4)
    out = pathlib.Path(args.out) if args.out else None
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
    device = "card " + torch.cuda.get_device_name() \
        if args.device == "cuda" else "cpu"
    for res in _windows(the_cell, seeds, args.seconds, logs,
                        bool(args.trace), args.device):
        line = json.dumps({"workload": args.workload, "device": device,
                           **res})
        print(line, flush=True)
        if out is not None:
            with out.open("a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
