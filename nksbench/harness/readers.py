"""What the metric readers (``nksbench/metrics/<name>.py``) compute, from
the run's :class:`~harness.bench.Ctx`. A reader returns None where it
finds nothing to read, and the metric is left out of the result line."""
from __future__ import annotations

import numpy as np

from harness.roofline import PEAK_FP32_FLOPS


def latency_ms(ctx, pct: float):
    """The ``pct`` percentile of the window's request latencies (due time
    to answer), failed requests counted as never answered: None where they
    reach the percentile."""
    lat = ctx.win.latency_s
    if lat is None:
        return None
    failed = len(ctx.win.answers) - len(lat)
    allv = np.concatenate([lat, np.full(failed, np.inf)])
    if not len(allv):
        return None
    v = float(np.percentile(allv, pct))
    return v * 1e3 if np.isfinite(v) else None


def per_query_ms(ctx, field: str):
    """An engine phase timer summed over the window's ``query_batch``
    calls, per query, ms."""
    n = ctx.spans.queries()
    return ctx.spans.total(field) * 1e3 / n if n else None


def roofline(ctx, kernel: str):
    """The window's summed bound over ``kernel``'s device time, %; None
    without a trace or where the profiler lost events of it."""
    if ctx.traced is None or not ctx.traced["kernel_s"].get(kernel):
        return None
    return 100.0 * ctx.work()[2] / ctx.traced["kernel_s"][kernel]


def mfu(ctx, seconds: float | None):
    """The window's anchor-star operations over ``seconds`` at the fp32
    peak, %."""
    if not seconds:
        return None
    return 100.0 * ctx.work()[0] / (seconds * PEAK_FP32_FLOPS)


def device_idle(ctx):
    """1 - the device's busy share of the traced window, %."""
    if ctx.traced is None or not ctx.traced["window_s"]:
        return None
    return 100.0 * (1.0 - ctx.traced["busy_s"] / ctx.traced["window_s"])
