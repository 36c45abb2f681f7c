"""Where an open loop's requests wait, read from the serving runtime's span
log and, in a traced window, from the device's busy intervals.

The runtime's log (``ServingRuntime.spans()`` with
``RuntimeConfig.span_log`` set) holds one ``BatchSpan`` a coalesced batch:
its coalescing-window wait, pick-up, engine call and its requests' admission
and answer stamps, with the engine's per-query (pack_start, dispatch_start,
readback_done) spans of the call inside. Every stamp is
``time.perf_counter()``.

A program stamp goes on the profiler's timeline (microseconds) through an
anchor: a profiler label's start beside a ``perf_counter()`` read just
inside it. ``harness/trace.py`` takes its window label for one,
``(w0, t0_perf)``; its error is the time the label's entry takes, about
0.8 ms on the CPU where that label is the process's first
``record_function`` (in the traced run the warm-up's ``query_batch`` labels
come first) and some 10-30 us after. :func:`stamp_clock` takes a second
label just inside the window, to anchor by and to measure the window's
anchor against; one at the window's end measures the drift over it.

What this module computes, per window:

* :func:`request_table` and :func:`waits_ms`: one row a request, and its
  time cut at every stamp: the queue (admission to pick-up), the engine
  lock (pick-up to the call's start), the call's entry, its batchmates
  before it (``t_call_start`` to its own ``pack_start``), its packing and
  dispatch, its batchmates after it (its readback to the call's return)
  and the batch's resolution (the return to its answer);
* :func:`idle_queued`: the share of the window in which no device
  operation ran while some request of the window was admitted and not
  answered;
* :func:`program_spans` and :func:`name_gaps`: the device's idle time cut
  where a request comes into hand or leaves it and at every program
  span's edge; the pieces with a request in hand are named by the
  innermost program span over them (``runtime.queue``, ``runtime.window``,
  ``runtime.batch``, ``engine.batchmate``, ``engine.pack``,
  ``engine.dispatch``), the others are no query in flight.

This module reads the program's spans only. ``trace.reduce`` names the
same gaps by the profiler's host events (operators, CUDA calls); it keeps
its busy intervals to itself, so :func:`timeline` selects the device
operations by the same rule to get them (a test holds the two busy sums
equal). The ``benchmark`` PR that reads these metrics in the benchmark's
own runs makes ``trace.reduce`` return its intervals and call
:func:`name_gaps` for the gaps no host event covers, and drops
:func:`timeline` with ``trace_waits.py``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from harness.trace import WINDOW_LABEL, _merge

CLOCK_LABEL = "nksbench.clock"

# the request table's columns: request id, batch id, place in the batch,
# then perf_counter() seconds
COLUMNS = ("rid", "batch", "pos", "admitted", "picked", "started", "t_call",
           "pack", "dispatch", "readback", "ended", "answered")
# waits_ms's parts of a request's time, in order; they tile ``latency``
PARTS = ("queue", "lock", "entry", "batchmate", "pack", "dispatch", "tail",
         "resolve")


def stamp_clock(holder: dict) -> None:
    """Inside a traced window: a profiler label and a ``perf_counter()``
    read just inside it, appended to ``holder["clock"]``."""
    with torch.profiler.record_function(CLOCK_LABEL):
        holder.setdefault("clock", []).append(time.perf_counter())


@dataclasses.dataclass
class Timeline:
    """A traced window on the profiler's clock (microseconds)."""

    w0: float
    w1: float
    busy: np.ndarray                # (n, 2) merged device-busy intervals
    anchor: tuple[float, float]     # (label start, perf_counter() read)
    others: list                    # more anchors, to check ``anchor`` by

    def to_us(self, t):
        """``perf_counter()`` seconds on the profiler's clock."""
        us, perf = self.anchor
        return (np.asarray(t, dtype=np.float64) - perf) * 1e6 + us

    def anchor_error_us(self) -> list[float]:
        """Each of ``others``' label start less its read as ``to_us`` maps
        it: 0 where the two anchors agree."""
        return [float(us - self.to_us(perf)) for us, perf in self.others]


def timeline(prof, t0_perf: float, clock=()) -> Timeline:
    """The window of ``harness/trace.py``'s profiler ``prof``: its device
    operations as ``trace.reduce`` selects them, merged. The first
    :func:`stamp_clock` label, with the first read of ``clock``, anchors
    the map where there is one, else the window's ``(w0, t0_perf)``; the
    other anchors are kept to check it by, the window's own first."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    win = [e for e in cpu if e.name == WINDOW_LABEL][0]
    w0, w1 = float(win.time_range.start), float(win.time_range.end)
    dev = [[max(float(e.time_range.start), w0), min(float(e.time_range.end),
                                                   w1)]
           for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("nksbench.")]
    busy = _merge(np.asarray([iv for iv in dev if iv[1] > iv[0]],
                             dtype=np.float64).reshape(-1, 2))
    labels = sorted(float(e.time_range.start) for e in cpu
                    if e.name == CLOCK_LABEL)
    pairs = [(w0, t0_perf)] + list(zip(labels, clock))
    anchor = pairs.pop(1 if len(pairs) > 1 else 0)
    return Timeline(w0, w1, busy, anchor, pairs)


def window_batches(batches, first_rid: int = 0) -> list:
    """The batches whose requests all have ids from ``first_rid`` on (an
    open loop's window follows its warm-up's ``first_rid`` requests)."""
    return [b for b in batches if min(r[0] for r in b.requests) >= first_rid]


def request_table(batches) -> dict[str, np.ndarray]:
    """One row a request that the engine's spans cover (:data:`COLUMNS`),
    in the log's order."""
    rows = []
    for b in batches:
        for i, ((rid, adm, ans), (p, d, r)) in enumerate(
                zip(b.requests, b.query_spans)):
            rows.append((rid, b.batch, i, adm, b.picked, b.started,
                         b.t_call_start, p, d, r, b.ended, ans))
    arr = np.asarray(rows, dtype=np.float64).reshape(-1, len(COLUMNS))
    return {c: arr[:, i] for i, c in enumerate(COLUMNS)}


def waits_ms(table: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A request's parts (:data:`PARTS`), ms: ``queue`` (admission to
    pick-up, the coalescing window inside it), ``lock`` (pick-up to the
    engine call's start: the engine lock and the fault check), ``entry``
    (the call's start to the engine's own entry stamp), ``batchmate`` (the
    engine's entry to its own packing), ``pack``, ``dispatch``, ``tail``
    (its readback to the call's return: later batchmates), ``resolve``
    (the return to its answer). They add up to ``latency``, admission to
    answer."""
    t = table
    edges = ("admitted", "picked", "started", "t_call", "pack", "dispatch",
             "readback", "ended", "answered")
    out = {name: (t[b] - t[a]) * 1e3
           for name, a, b in zip(PARTS, edges, edges[1:])}
    out["latency"] = (t["answered"] - t["admitted"]) * 1e3
    return out


def percentile(x: np.ndarray, pct: float) -> float | None:
    return float(np.percentile(x, pct)) if len(x) else None


def _measure(iv: np.ndarray) -> float:
    return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0


def _complement(iv: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """[lo, hi] less the merged intervals ``iv``."""
    edges = np.concatenate([[lo], np.clip(iv, lo, hi).ravel(), [hi]])
    gaps = edges.reshape(-1, 2)
    return gaps[gaps[:, 1] > gaps[:, 0]]


def _intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i, 0], b[j, 0]), min(a[i, 1], b[j, 1])
        if hi > lo:
            out.append((lo, hi))
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def in_hand(tl: Timeline, table: dict[str, np.ndarray]) -> np.ndarray:
    """Merged intervals of the window (profiler us) in which some request
    of ``table`` was admitted and not answered."""
    iv = np.stack([tl.to_us(table["admitted"]), tl.to_us(table["answered"])],
                  axis=1).reshape(-1, 2)
    return _merge(np.clip(iv, tl.w0, tl.w1))


def idle_queued(tl: Timeline, table: dict[str, np.ndarray]) -> float | None:
    """The share of the window, %, in which the device ran nothing while a
    request of ``table`` was in hand."""
    if tl.w1 <= tl.w0:
        return None
    idle = _complement(tl.busy, tl.w0, tl.w1)
    return 100.0 * _measure(_intersect(idle, in_hand(tl, table))) \
        / (tl.w1 - tl.w0)


def program_spans(batches) -> list[tuple[str, float, float]]:
    """The program's spans of ``batches``, ``perf_counter()`` seconds: per
    request its ``runtime.queue``; per batch its ``runtime.window`` and
    ``runtime.batch`` (pick-up to its last answer); per query its
    ``engine.batchmate``, ``engine.pack`` and ``engine.dispatch``."""
    out = []
    for b in batches:
        if b.window is not None:
            out.append(("runtime.window",) + tuple(b.window))
        out.append(("runtime.batch", b.picked,
                    max(r[2] for r in b.requests)))
        for rid, adm, ans in b.requests:
            out.append(("runtime.queue", adm, b.picked))
        for p, d, r in b.query_spans:
            out += [("engine.batchmate", b.t_call_start, p),
                    ("engine.pack", p, d), ("engine.dispatch", d, r)]
    return out


def _innermost(names, starts, ends, mids) -> list:
    """Per point of ``mids``, the name of the shortest interval covering
    it, else None."""
    out = [None] * len(mids)
    if not len(starts):
        return out
    order = np.argsort(ends - starts, kind="stable")
    s, e = starts[order], ends[order]
    for k, m in enumerate(mids):
        hit = np.flatnonzero((s <= m) & (e >= m))
        if len(hit):
            out[k] = names[order[hit[0]]]
    return out


def name_gaps(tl: Timeline, table: dict[str, np.ndarray], spans,
              top: int = 10) -> list[list]:
    """The window's idle time named as this module's docstring says,
    seconds, summed by name, the largest ``top``. The idle parts with a
    request of ``table`` in hand (their sum is :func:`idle_queued`'s share)
    are cut at every edge of ``spans`` and each piece named by the
    innermost span over it, else as a request in hand; the rest is no query
    in flight."""
    idle = _complement(tl.busy, tl.w0, tl.w1)
    hand = in_hand(tl, table)
    p = tl.to_us(np.asarray([(s, e) for _, s, e in spans],
                            dtype=np.float64).reshape(-1, 2))
    cuts = np.unique(p.ravel())
    pieces = []
    for s, e in _intersect(idle, hand):
        inner = cuts[np.searchsorted(cuts, s, "right"):
                     np.searchsorted(cuts, e, "left")]
        edges = np.concatenate([[s], inner, [e]])
        pieces += list(zip(edges[:-1], edges[1:]))
    pieces = np.asarray(pieces, dtype=np.float64).reshape(-1, 2)
    names = _innermost([n for n, _, _ in spans], p[:, 0], p[:, 1],
                       0.5 * (pieces[:, 0] + pieces[:, 1]))
    named: dict[str, float] = {}
    for (s, e), n in zip(pieces, names):
        label = n or "request in hand"
        named[label] = named.get(label, 0.0) + (e - s) * 1e-6
    free = _measure(_intersect(idle, _complement(hand, tl.w0, tl.w1)))
    if free > 0:
        named["no query in flight"] = free * 1e-6
    return [[n, v] for n, v in sorted(named.items(), key=lambda kv: -kv[1])
            ][:top]
