"""One run of one cell: set-up, the window, the check, the metrics.

:func:`run_cell` takes the system under test that the cell's
configuration names (``nksbench/systems/<system>.py``), makes its data
from the seed and builds it, draws the traffic, and hands them to the
mix's loop
(``nksbench/loops/<loop>.py``), which warms the path up, marks the end of
set-up and runs the window. Once the window has closed it reads the
device's memory peak, frees the program's state, checks the window's
answers against the plain reference (``nksbench/checks/<check>.py``) and
reads the cell's metrics (``nksbench/metrics/<name>.py``). It returns the
result line's object; ``run.py`` prints it. ``run_cell`` does not look
for a chip: the CLI does, and the CPU tests drive it with
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from harness import trace as tracemod
from harness.spec import BENCH, Cell, load_module, system_module
from harness.system import Spans
from harness.traffic import check_sample, make_traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Window:
    queries: list
    answers: list               # per request: [(ids, diameter)] or None
    window_s: float
    latency_s: np.ndarray | None = None
    lag_s: np.ndarray | None = None
    runtime: dict | None = None


class Ctx:
    """What a loop, a check and a metric reader see of the run."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, float(seconds)
        self.trace, self.device, self.t_start = trace, device, t_start
        self.mix, self.config = cell.mix, cell.config
        self.system = system_module(cell.config)
        self.setup_s: float | None = None
        self.corpus = self.engine = self.traffic = None
        self.spans = Spans(trace)
        self.holder: dict = {}
        self.win: Window | None = None
        self.traced: dict | None = None
        self.launches: dict[str, int] = {}

    def setup_done(self) -> None:
        if self.device_is_cuda:
            torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - self.t_start
        self._launch0 = self.system.launches()

    @property
    def device_is_cuda(self) -> bool:
        return torch.device(self.device).type == "cuda"

    def window(self):
        return tracemod.window(self.trace, self.device, self.holder)

    def result_window(self, **kw) -> Window:
        now = self.system.launches()
        self.launches = {k: now[k] - self._launch0[k] for k in now}
        return Window(**kw)

    # what the metric readers use
    def work(self) -> tuple[float, float, float]:
        """(operations, bytes, bound seconds) of the window's answered
        queries, counted by the system from their inputs."""
        return self.system.work(self.corpus, self.win.queries,
                                self.win.answers)

    def answered(self) -> int:
        return sum(a is not None for a in self.win.answers)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None) -> dict:
    ctx = Ctx(cell, seed, seconds, trace, device,
              time.perf_counter() if t_start is None else t_start)
    ctx.corpus = ctx.system.make_data(cell.config, seed)
    ctx.engine = ctx.system.build(cell.config, ctx.corpus, device)
    ctx.system.instrument(ctx.engine, ctx.spans)
    ctx.traffic = make_traffic(cell.mix, ctx.corpus, seed, seconds)
    loop = load_module(BENCH / "loops" / f"{cell.mix['loop']}.py")
    ctx.win = loop.run(ctx)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    peak = torch.cuda.max_memory_allocated() if ctx.device_is_cuda else 0
    ctx.engine = None
    gc.collect()
    if ctx.device_is_cuda:
        torch.cuda.empty_cache()
    if trace and "prof" in ctx.holder:
        ctx.traced = tracemod.reduce(
            ctx.holder.pop("prof"),
            {k: (m, ctx.launches.get(k, 0))
             for k, m in ctx.system.KERNELS.items()},
            [(s.start, s.end) for s in ctx.spans.items],
            ctx.holder.get("t0_perf"))
    check = load_module(BENCH / "checks" / f"{cell.config['check']}.py")
    answered = ctx.answered()
    sample = check_sample(answered, int(cell.mix["check_sample"]), seed)
    with torch.no_grad():
        numbers = check.compare(ctx.corpus, ctx.win.queries, ctx.win.answers,
                                ctx.traffic.k, sample, device)
    checks = {name: {"value": float(v), "limit": float(cell.limits[name])}
              for name, v in numbers.items() if name in cell.limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device_is_cuda else "cpu",
           "kind": torch.cuda.get_device_name() if ctx.device_is_cuda
           else "cpu", "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(ctx.win.answers),
           "failed": len(ctx.win.answers) - answered, "metrics": metrics,
           "device": dev}
    if trace and ctx.traced is not None:
        dev["busy_s"] = ctx.traced["busy_s"]
        dev["window_s"] = ctx.traced["window_s"]
        out["breakdown"] = {"device_ops": ctx.traced["device_ops"],
                            "idle_gaps": ctx.traced["idle_gaps"]}
    out["host"] = host_numbers(ctx)
    out["checks"] = checks
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    return out


def host_numbers(ctx) -> dict:
    """What the host did in the window, for reading a run's noise (``run.py``
    prints it on standard error, not in the result line): the calls into
    the system, its phase timers a query, and an open loop's lateness."""
    n = max(ctx.spans.queries(), 1)
    out = {"window_s": ctx.win.window_s, "calls": len(ctx.spans.items),
           "queries": ctx.spans.queries(),
           "call_ms_per_query": ctx.spans.wall_s() * 1e3 / n,
           "pack_ms_per_query": ctx.spans.total("pack_s") * 1e3 / n,
           "dispatch_ms_per_query": ctx.spans.total("dispatch_s") * 1e3 / n}
    lat, lag = ctx.win.latency_s, ctx.win.lag_s
    if lat is not None and lag is not None and len(lat):
        ok = [i for i, a in enumerate(ctx.win.answers) if a is not None]
        sub = lat - lag[ok]
        out.update(lag_ms_mean=float(lag.mean()) * 1e3,
                   lag_ms_p95=float(np.percentile(lag, 95)) * 1e3,
                   p95_ms_from_submit=float(np.percentile(sub, 95)) * 1e3,
                   p50_ms_from_submit=float(np.percentile(sub, 50)) * 1e3)
    return out
