"""Where requests wait (``harness/waits.py``, ``trace_waits.py``): the
readings on hand-made spans and busy intervals whose answers are known by
hand, the clock that puts the program's stamps on the profiler's
timeline, and the tool's windows on the CPU at a small size."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import BENCH, STREAM, small_cell

from harness import trace as tracemod
from harness import waits
from harness.spec import load_module
from harness.system import Spans
from repro_torch.serve.runtime import BatchSpan

MS = 1e-3


def _batches():
    """Two batches: request 0 alone after a coalescing window; requests 1
    and 2 together, 2 behind 1. Seconds."""
    one = BatchSpan(1, (0.5 * MS, 2.0 * MS), 2.0 * MS, 2.1 * MS, 10.1 * MS,
                    [(0, 0.0, 10.2 * MS)], 2.2 * MS,
                    [(2.3 * MS, 3.0 * MS, 10.0 * MS)])
    two = BatchSpan(2, None, 10.3 * MS, 10.4 * MS, 24.1 * MS,
                    [(1, 5.0 * MS, 24.2 * MS), (2, 8.0 * MS, 24.2 * MS)],
                    10.5 * MS, [(10.6 * MS, 11.0 * MS, 17.0 * MS),
                                (17.1 * MS, 18.0 * MS, 24.0 * MS)])
    return [one, two]


def _timeline():
    """A 30 ms window on the profiler's clock (us), anchored at 0, busy in
    the requests' dispatches."""
    busy = np.array([[3000.0, 9000.0], [11500.0, 16500.0],
                     [18500.0, 23500.0]])
    return waits.Timeline(0.0, 30000.0, busy, (0.0, 0.0), [])


def test_request_table_and_waits():
    table = waits.request_table(_batches())
    assert list(table["rid"]) == [0, 1, 2]
    assert list(table["pos"]) == [0, 0, 1]
    parts = waits.waits_ms(table)
    np.testing.assert_allclose(parts["queue"], [2.0, 5.3, 2.3])
    np.testing.assert_allclose(parts["batchmate"], [0.1, 0.1, 6.6])
    np.testing.assert_allclose(parts["pack"], [0.7, 0.4, 0.9])
    np.testing.assert_allclose(parts["dispatch"], [7.0, 6.0, 6.0])
    np.testing.assert_allclose(parts["lock"], [0.1, 0.1, 0.1])
    np.testing.assert_allclose(parts["entry"], [0.1, 0.1, 0.1])
    np.testing.assert_allclose(parts["tail"], [0.1, 7.1, 0.1])
    np.testing.assert_allclose(parts["resolve"], [0.1, 0.1, 0.1])
    # the parts tile each request's time
    assert tuple(parts) == waits.PARTS + ("latency",)
    total = sum(parts[k] for k in waits.PARTS)
    np.testing.assert_allclose(total, parts["latency"])
    # 95th percentiles, numpy's linear rule: 2.3 + 0.9 x 3.0, 0.1 + 0.9 x 6.5
    assert waits.percentile(parts["queue"], 95) == pytest.approx(5.0)
    assert waits.percentile(parts["batchmate"], 95) == pytest.approx(5.95)
    assert waits.percentile(np.zeros(0), 95) is None


def test_window_batches_drop_the_warm_up():
    assert [b.batch for b in waits.window_batches(_batches(), 1)] == [2]
    assert len(waits.window_batches(_batches(), 0)) == 2


def test_idle_queued_by_hand():
    # in hand [0, 24.2] ms; idle [0, 3], [9, 11.5], [16.5, 18.5], [23.5, 30]
    tl = _timeline()
    table = waits.request_table(_batches())
    assert waits.idle_queued(tl, table) == pytest.approx(
        100.0 * (3000 + 2500 + 2000 + 700) / 30000)
    # nothing in hand: nothing queued; never over the idle share
    assert waits.idle_queued(tl, waits.request_table([])) == 0.0
    idle = 100.0 * (1 - (6000 + 5000 + 5000) / 30000)
    assert waits.idle_queued(tl, table) <= idle


def test_idle_queued_maps_through_the_anchor():
    """The same window 1 s later on the program's clock, 7 us off on the
    profiler's: the reading holds."""
    tl = _timeline()
    tl.anchor = (7.0, 1.0)
    batches = _batches()
    for b in batches:
        b.requests = [(r, a + 1.0, e + 1.0) for r, a, e in b.requests]
    got = waits.idle_queued(tl, waits.request_table(batches))
    assert got == pytest.approx(100.0 * (2993 + 2500 + 2000 + 707) / 30000)


def _named(tl, batches):
    table = waits.request_table(batches)
    got = waits.name_gaps(tl, table, waits.program_spans(batches))
    return dict(map(tuple, got)), table


def test_gaps_named_by_program_spans():
    """Idle [0, 3], [9, 11.5], [16.5, 18.5], [23.5, 30] ms, a request in
    hand over [0, 24.2]: each piece takes the innermost span over it."""
    names = {n for n, _, _ in waits.program_spans(_batches())}
    assert names == {"runtime.window", "runtime.batch", "runtime.queue",
                     "engine.batchmate", "engine.pack", "engine.dispatch"}
    tl = _timeline()
    got, table = _named(tl, _batches())
    assert got == pytest.approx({"runtime.queue": 1.8 * MS,
                                 "runtime.window": 1.5 * MS,
                                 "runtime.batch": 0.6 * MS,
                                 "engine.batchmate": 0.3 * MS,
                                 "engine.pack": 2.0 * MS,
                                 "engine.dispatch": 2.0 * MS,
                                 "no query in flight": 5.8 * MS})
    # the pieces in hand are idle_queued's share, the rest is idle too
    in_hand = sum(v for n, v in got.items() if n != "no query in flight")
    assert 100.0 * in_hand / 0.030 == pytest.approx(
        waits.idle_queued(tl, table))
    assert sum(got.values()) == pytest.approx(0.030 - 0.016)


def test_an_arrival_splits_a_gap():
    """Idle over [0, 30] and [35, 40] ms; a request arrives at 20 ms and is
    answered at 36.2, so only [0, 20] and [36.2, 40] are no query in
    flight: its queue, pick-up and own packing are named, its dispatch up
    to the device's start at 30 ms and from its end at 35, and the batch's
    end."""
    tl = waits.Timeline(0.0, 40000.0, np.array([[30000.0, 35000.0]]),
                        (0.0, 0.0), [])
    one = BatchSpan(1, None, 22.0 * MS, 22.1 * MS, 36.1 * MS,
                    [(0, 20.0 * MS, 36.2 * MS)], 22.2 * MS,
                    [(22.3 * MS, 24.0 * MS, 36.0 * MS)])
    got, table = _named(tl, [one])
    assert got == pytest.approx({"no query in flight": 23.8 * MS,
                                 "runtime.queue": 2.0 * MS,
                                 "runtime.batch": 0.4 * MS,
                                 "engine.batchmate": 0.1 * MS,
                                 "engine.pack": 1.7 * MS,
                                 "engine.dispatch": 7.0 * MS})
    assert waits.idle_queued(tl, table) == pytest.approx(100.0 * 11.2 / 40)


def test_timeline_busy_is_reduce_busy():
    """``waits.timeline`` selects the device operations as ``trace.reduce``
    does: on a CPU profile with device events put in, one clipped at the
    window's end, one a label's copy, the two busy sums agree."""
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, name, dev, s, e, annot=False):
            self.name, self.device_type = name, dev
            self.time_range = type("R", (), {"start": s, "end": e})()
            self.is_user_annotation = annot

    class Prof:
        def events(self):
            cpu, cuda = DeviceType.CPU, DeviceType.CUDA
            return [Ev(tracemod.WINDOW_LABEL, cpu, 100.0, 900.0),
                    Ev("k6", cuda, 50.0, 150.0), Ev("k6", cuda, 140.0, 300.0),
                    Ev("copy", cuda, 400.0, 450.0),
                    Ev("nksbench.query_batch", cuda, 100.0, 900.0),
                    Ev("label", cuda, 100.0, 900.0, annot=True),
                    Ev("k6", cuda, 850.0, 1000.0), Ev("late", cuda, 950.0,
                                                      990.0)]

    tl = waits.timeline(Prof(), 7.0)
    got = tracemod.reduce(Prof(), {}, (), 7.0)
    assert (tl.w0, tl.w1, tl.anchor) == (100.0, 900.0, (100.0, 7.0))
    np.testing.assert_allclose(tl.busy, [[100.0, 300.0], [400.0, 450.0],
                                         [850.0, 900.0]])
    assert got["busy_s"] == pytest.approx(waits._measure(tl.busy) * 1e-6)


def test_program_span_holds_its_aten_operators():
    """On the CPU under the benchmark's profiler, as in its traced run (the
    instrumented warm-up before the window): the engine's spans of a
    device-tier call, mapped through the window's ``(w0, t0_perf)``, hold
    the main thread's operators of each query's packing and dispatch, each
    within 0.5 ms."""
    from repro_torch.data.synthetic import random_queries, synthetic_dataset
    from repro_torch.serve.engine import NKSEngine

    torch.set_num_threads(1)
    ds = synthetic_dataset(n=8000, d=8, u=12, t=1, seed=1)
    engine = NKSEngine(ds, device="cpu", build_exact=False,
                       build_approx=False)
    queries = random_queries(ds, 3, 3, seed=2)
    spans = Spans(trace=True)
    system = load_module(BENCH / "systems" / "nks_engine.py")
    system.instrument(engine, spans)
    engine.query_batch(queries, k=2, tier="device")       # warm-up
    holder: dict = {}
    with tracemod.window(True, "cpu", holder):
        waits.stamp_clock(holder)
        engine.query_batch(queries, k=2, tier="device")
        waits.stamp_clock(holder)
    st = engine.last_batch_stats
    tl = waits.timeline(holder["prof"], holder["t0_perf"])
    assert tl.anchor == (tl.w0, holder["t0_perf"])
    with_clock = waits.timeline(holder["prof"], holder["t0_perf"],
                                holder["clock"])
    assert all(abs(e) < 500.0 for e in with_clock.anchor_error_us())
    ops = [e for e in holder["prof"].events()
           if e.name.startswith("aten::") and e.cpu_parent is not None
           and e.cpu_parent.name == "nksbench.query_batch"]
    spans_us = [(float(tl.to_us(p)), float(tl.to_us(r)))
                for p, _, r in st.query_spans]
    for p, r in spans_us:
        mine = [e for e in ops if p - 500.0 <= e.time_range.start
                and e.time_range.end <= r + 500.0]
        assert mine, "a query span holds none of its operators"
        assert abs(r - mine[-1].time_range.end) < 500.0
    for e in ops:                   # no operator of the call lies outside
        assert any(p - 500.0 <= e.time_range.start
                   and e.time_range.end <= r + 500.0 for p, r in spans_us)


def test_tool_windows_on_the_cpu():
    tool = load_module(BENCH / "trace_waits.py")
    off, on = tool._windows(small_cell(STREAM), [2**31 + 11], 2.0, [0, 1],
                            True, "cpu")
    for res in (off, on):
        assert res["failed"] == 0 and res["requests"] > 0
        assert res["p50_ms"] <= res["p95_ms"]
        assert res["coalesce_wait_ms"] >= 0.0
        assert 0.0 <= res["window_wait_share"] <= 1.0
    assert "queue_wait_ms" not in off and "idle_queued" not in off
    assert on["logged_requests"] == on["requests"]
    # the log's packing and dispatch are the phase timers' own
    assert on["pack_ms_logged"] == pytest.approx(on["pack_ms"], rel=1e-9)
    assert on["dispatch_ms_logged"] == pytest.approx(on["dispatch_ms"],
                                                     rel=1e-9)
    # the parts the check adds leave the engine lock and the call's entry,
    # which are short
    assert 0.0 <= on["untiled_ms"] < 1.0
    assert set(on["median_ms"]) == set(waits.PARTS) | {"latency"}
    assert on["queue_wait_ms"] >= on["median_ms"]["queue"]
    assert 0.0 <= on["idle_queued"] <= 100.0
    assert len(on["anchor_error_us"]) == 2
    assert abs(on["anchor_error_us"][0]) < 500.0
    # the idle time named with a request in hand is idle_queued's share;
    # with no device operation on the CPU the whole window is idle
    named = sum(v for n, v in on["idle_gaps"] if n != "no query in flight")
    window = sum(v for _, v in on["idle_gaps"])
    assert 100.0 * named / window == pytest.approx(on["idle_queued"],
                                                   rel=1e-6)
