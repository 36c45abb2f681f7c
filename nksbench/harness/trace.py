"""The traced window: ``torch.profiler`` over it, and what is read from it.

The traced run is the run with ``--trace 1``, a fresh process. The window
runs inside one profiling context (CPU and CUDA activity) under a
``record_function("nksbench.window")`` label, whose CPU event bounds the
window on the profiler's timeline. From the device events inside it:

* ``busy_s``: the union of the intervals in which an operation (kernel,
  copy or fill) ran on the device;
* the device time of each of the system's hand-written kernels (its
  ``KERNELS``: the events whose names hold the kernel's mark), kept only
  where the profiler's events of it equal the program's launch counter
  over the window, since the profiler has lost events in long-lived
  processes (``chip_smoke.py``'s ``profile_window`` rule); else None;
* the device operations that took most time, by name;
* the idle gaps between busy intervals, each named by the innermost host
  event of the profiler that covers its middle (an operator or a CUDA
  call), else by the harness's own span around ``query_batch`` calls if
  one covers it (the profiler records operators of the thread that
  opened it, not of the serving runtime's worker), else as no query in
  flight; summed by name over the longest gaps.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

WINDOW_LABEL = "nksbench.window"
TOP = 10
GAPS_NAMED = 1000


@contextlib.contextmanager
def window(trace: bool, device: str, holder: dict):
    """Run the body as the window; with ``trace`` under the profiler,
    which is left in ``holder["prof"]``."""
    if not trace:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_LABEL):
            holder["t0_perf"] = time.perf_counter()
            yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    holder["prof"] = prof


def _merge(iv: np.ndarray) -> np.ndarray:
    """Sorted, disjoint union of (n, 2) intervals."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.float64)


def reduce(prof, kernels: dict, spans=(), t0_perf: float | None = None
           ) -> dict | None:
    """The window's device figures, or None if the profiler saw no device
    operation in it. Times in seconds. ``kernels``: name -> (mark in its
    device events' names, launches counted over the window). ``spans``: the
    harness's
    (start, end) ``time.perf_counter()`` spans around ``query_batch``
    calls; ``t0_perf``: the same clock at the window's start."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    win = [e for e in events if e.name == WINDOW_LABEL]
    if not win:
        return None
    w0, w1 = float(win[0].time_range.start), float(win[0].time_range.end)
    # device events, without the GPU-side copies of record_function labels
    dev = [(e.name, float(e.time_range.start), float(e.time_range.end))
           for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("nksbench.")]
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev
           if e > w0 and s < w1]
    if not dev:
        return None
    iv = np.asarray([[s, e] for _, s, e in dev], dtype=np.float64)
    busy = _merge(iv)
    busy_us = float((busy[:, 1] - busy[:, 0]).sum())
    by_name: dict[str, float] = {}
    k_us = dict.fromkeys(kernels, 0.0)
    k_events = dict.fromkeys(kernels, 0)
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
        for k, (mark, _) in kernels.items():
            if mark in n:
                k_us[k] += e - s
                k_events[k] += 1
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # idle gaps inside the window, longest first, named by the host
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")]
    gaps = gaps[:GAPS_NAMED]
    host = [(e.name, float(e.time_range.start), float(e.time_range.end))
            for e in events
            if e.device_type == DeviceType.CPU and e.name != WINDOW_LABEL]
    h_name = np.asarray([n for n, _, _ in host], dtype=object)
    h_s = np.asarray([s for _, s, _ in host], dtype=np.float64)
    h_e = np.asarray([e for _, _, e in host], dtype=np.float64)
    # the harness's spans on the profiler's clock (microseconds)
    sp = np.asarray([[a, b] for a, b in spans], dtype=np.float64) \
        .reshape(-1, 2)
    if t0_perf is not None:
        sp = (sp - t0_perf) * 1e6 + w0
    named: dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        cover = np.flatnonzero((h_s <= mid) & (h_e >= mid)) if len(h_s) \
            else np.zeros(0, dtype=np.int64)
        if len(cover):
            label = str(h_name[cover[np.argmin(h_e[cover] - h_s[cover])]])
        elif t0_perf is not None and ((sp[:, 0] <= mid)
                                      & (sp[:, 1] >= mid)).any():
            label = "host work inside nksbench.query_batch"
        else:
            label = "no query in flight"
        named[label] = named.get(label, 0.0) + (e - s) * 1e-6
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "kernel_s": {k: k_us[k] * 1e-6
                     if k_events[k] == kernels[k][1] > 0 else None
                     for k in kernels},
        "kernel_events": k_events,
        "device_ops": [[n[:120], t * 1e-6] for n, t in top_ops],
        "idle_gaps": [[n[:120], t] for n, t in idle],
    }
