"""Spans of the port's serving path on the CPU: the runtime's ticket stamps,
wait counters and bounded span log (``serve/runtime.py``), and the device
tier's per-query spans (``PipelineStats.query_spans``, ``serve/engine.py``),
all on ``time.perf_counter()``."""
import statistics
import time

import numpy as np
import pytest
import torch

from repro_torch.core.filters import where
from repro_torch.data.synthetic import (attach_attrs, random_queries,
                                        synthetic_dataset)
from repro_torch.serve.engine import NKSEngine
from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engine():
    ds = attach_attrs(synthetic_dataset(n=8000, d=8, u=12, t=1, seed=1),
                      seed=1)
    return NKSEngine(ds, device="cpu", build_exact=False, build_approx=False,
                     compact_min=10_000)


@pytest.fixture(scope="module")
def queries(engine):
    return random_queries(engine.dataset, 3, 12, seed=2)


def _request(q):
    return {"op": "query", "tier": "device", "k": 2, "keywords": q}


def _wait(pred, timeout=10.0):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, "condition not reached"
        time.sleep(0.001)


def _burst(rt, queries):
    """Submit in two bursts, so that batches of several queries form."""
    half = len(queries) // 2
    tickets = [rt.submit(_request(q)) for q in queries[:half]]
    time.sleep(0.02)
    tickets += [rt.submit(_request(q)) for q in queries[half:]]
    return tickets, [t.result(60) for t in tickets]


def test_ticket_stamps_ordered_and_latency_from_admission(engine, queries):
    with ServingRuntime(engine, RuntimeConfig(tier="device", k=2)) as rt:
        before = time.perf_counter()
        tickets, got = _burst(rt, queries)
        after = time.perf_counter()
    assert all(r.ok for r in got)
    assert [t.rid for t in tickets] == list(range(len(queries)))
    for t, r in zip(tickets, got):
        assert before <= t.admitted_at <= t.picked_at <= t.started_at \
            <= t.answered_at <= after
        assert r.latency_s == t.answered_at - t.admitted_at
    # RuntimeStats.t_queue_s sums the same waits, in pick-up order
    order = sorted(tickets, key=lambda t: (t.picked_at, t.rid))
    assert rt.stats.t_queue_s == pytest.approx(
        sum(t.picked_at - t.admitted_at for t in order), rel=1e-12, abs=0)
    assert rt.stats.window_waits <= rt.stats.batches
    assert rt.stats.t_window_s >= 0.0


def test_window_wait_only_for_a_young_head(engine, queries):
    """The worker waits out the coalescing window for a head younger than
    ``batch_window_s`` and not for one that aged behind a busy engine."""
    window = 0.05
    cfg = RuntimeConfig(tier="device", k=2, batch_window_s=window,
                        span_log=8)
    with ServingRuntime(engine, cfg) as rt:
        with rt._engine_lock:           # the engine is busy elsewhere
            first = rt.submit(_request(queries[0]))
            _wait(lambda: first.picked_at is not None)
            second = rt.submit(_request(queries[1]))
            time.sleep(2 * window)      # the second's head ages
        assert first.result(60).ok and second.result(60).ok
        spans = rt.spans()
    assert rt.stats.window_waits == 1
    assert [len(s.requests) for s in spans] == [1, 1]
    young, old = spans
    assert young.window is not None and old.window is None
    assert young.window[0] - first.admitted_at < window
    assert rt.stats.t_window_s == young.window[1] - young.window[0]
    assert young.window[1] <= young.picked == first.picked_at
    assert second.picked_at - second.admitted_at >= 2 * window


def test_span_log_off_records_nothing(engine, queries):
    with ServingRuntime(engine, RuntimeConfig(tier="device", k=2)) as rt:
        assert all(r.ok for r in _burst(rt, queries[:4])[1])
        assert rt.spans() == [] and rt._spans is None
    assert rt.stats.batches > 0


def test_span_log_is_bounded(engine, queries):
    cfg = RuntimeConfig(tier="device", k=2, span_log=3)
    with ServingRuntime(engine, cfg) as rt:
        for q in queries[:7]:           # one batch each
            assert rt.submit(_request(q)).result(60).ok
        spans = rt.spans()
    assert rt.stats.batches == 7
    assert [s.batch for s in spans] == [5, 6, 7]
    assert [s.requests[0][0] for s in spans] == [4, 5, 6]


def test_batch_spans_nest_and_tile_a_request(engine, queries):
    """Each batch holds its requests and the engine's spans of its call, in
    order; a request's queue wait, batchmate wait, own packing and dispatch
    and the time from its readback to its answer add up to its latency, but
    for the pick-up before the engine call."""
    cfg = RuntimeConfig(tier="device", k=2, span_log=64)
    with ServingRuntime(engine, cfg) as rt:
        tickets, got = _burst(rt, queries)
        spans = rt.spans()
    by_rid = {t.rid: t for t in tickets}
    assert sorted(r[0] for s in spans for r in s.requests) == \
        sorted(by_rid)
    assert any(len(s.requests) > 1 for s in spans)
    for s in spans:
        assert len(s.query_spans) == len(s.requests)
        assert s.picked <= s.started <= s.t_call_start \
            <= s.query_spans[0][0]
        assert s.query_spans[-1][2] <= s.ended
        for (rid, adm, ans), (p, d, r) in zip(s.requests, s.query_spans):
            t = by_rid[rid]
            assert (adm, ans) == (t.admitted_at, t.answered_at)
            assert t.picked_at == s.picked and t.started_at == s.started
            assert s.ended <= ans
            parts = (t.picked_at - adm) + (p - s.t_call_start) \
                + (r - p) + (ans - r)
            assert parts == pytest.approx(
                ans - adm - (s.t_call_start - s.picked), abs=1e-9)


def test_ingest_ops_are_admitted_and_answered_only():
    """An ingest op is not picked into a query batch nor started by one: it
    carries its admission and answer stamps, and the queue counter sums
    the query tickets alone."""
    ds = synthetic_dataset(n=400, d=4, u=6, t=1, seed=5)
    engine = NKSEngine(ds, device="cpu", build_exact=False,
                       build_approx=False, compact_min=10_000)
    pts = np.random.default_rng(6).standard_normal((3, 4)).astype(np.float32)
    with ServingRuntime(engine, RuntimeConfig(tier="device", k=1)) as rt:
        with rt._engine_lock:
            ins = rt.submit({"op": "insert", "points": pts,
                             "keywords": [[0, 1]] * 3})
            q = rt.submit(_request([0, 1]))
        assert ins.result(60).ok and q.result(60).ok
    assert (ins.rid, q.rid) == (0, 1)
    assert ins.picked_at is None and ins.started_at is None
    assert ins.admitted_at <= ins.answered_at
    assert ins.response.latency_s == ins.answered_at - ins.admitted_at
    assert rt.stats.t_queue_s == q.picked_at - q.admitted_at


# ------------------------------------------------------------------ engine
def test_device_query_spans_sum_to_phase_timers(engine, queries):
    firsts = []
    for _ in range(5):
        engine.query_batch(queries[:3], k=2, tier="device")
        st = engine.last_batch_stats
        sp = st.query_spans
        assert len(sp) == 3
        assert st.t_call_start <= sp[0][0]
        for i, (p, d, r) in enumerate(sp):
            assert p <= d <= r
            if i:
                assert sp[i - 1][2] <= p
        assert sum(d - p for p, d, _ in sp) == st.t_pack_s
        assert sum(r - d for _, d, r in sp) == st.t_dispatch_s
        # the second query waits on the first one's whole span
        assert sp[1][0] - st.t_call_start >= sp[0][2] - sp[0][0]
        firsts.append((sp[0][0] - st.t_call_start, sp[0][1] - sp[0][0]))
    # the first query waits on no batchmate, only on the call's entry
    assert statistics.median(w for w, _ in firsts) \
        < statistics.median(p for _, p in firsts)


def test_filtered_out_query_spans_nothing(engine, queries):
    engine.query_batch(queries[:2], k=1, tier="device",
                       filter=where(("price", "<", -1.0)))
    st = engine.last_batch_stats
    assert len(st.query_spans) == 2
    assert all(p == d == r for p, d, r in st.query_spans)
    assert st.t_pack_s == st.t_dispatch_s == 0.0


def test_approx_tier_stamps_the_call_only():
    ds = synthetic_dataset(n=300, d=5, u=24, t=2, seed=0)
    engine = NKSEngine(ds, device="cpu", seed=3)
    t0 = time.perf_counter()
    engine.query_batch(random_queries(ds, 2, 2, seed=1), k=1, tier="approx")
    st = engine.last_batch_stats
    assert st.t_call_start >= t0 and st.query_spans == []
