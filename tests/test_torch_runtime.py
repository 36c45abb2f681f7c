"""The port's serving runtime on the CPU.

The counterparts of the reference's ``tests/test_runtime.py``, case for
case, with the port's engine on ``device="cpu"`` and the runtime on its
default ``"torch"`` backend (the engine's own backend; the reference's
default is its float64 ``"numpy"`` loops): coalescing parity, bounded
retries, isolation of a bad request, backpressure, deadlines, shedding
exact to approx, off-thread compaction with deferred ingest, group-committed
ingest runs, every fault site and ``health``/``close``.

On top, differentials against the reference's runtime on the same seeded
corpus: the deterministic cases (coalesced and mixed-key parity, the ingest
barrier, background compaction, the WAL crash through the runtime) answer
bit for bit per counterpart backend (port ``"numpy"`` against reference
``"numpy"``, port ``"torch"`` against the reference's Pallas backend on its
device route, in interpret mode), and a WAL root written through one
package's runtime recovers in the other.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.backend import PallasBackend
from repro.data.synthetic import synthetic_dataset as ref_synth
from repro.serve.engine import NKSEngine as RefEngine
from repro.serve.runtime import RuntimeConfig as RefConfig
from repro.serve.runtime import ServingRuntime as RefRuntime
from repro_torch.data.synthetic import random_queries, synthetic_dataset
from repro_torch.serve.engine import NKSEngine
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.runtime import (RuntimeConfig, RuntimeResponse,
                                       ServingRuntime)

torch.set_num_threads(1)


def _corpus(n=300, d=5, u=24, seed=0):
    return synthetic_dataset(n=n, d=d, u=u, t=2, seed=seed)


def _engine(ds, **kw):
    return NKSEngine(ds, device="cpu", **kw)


def _keys(candidates):
    return [c.key() for c in candidates]


def _wait(pred, timeout=5.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(0.002)


@pytest.fixture
def engine():
    return _engine(_corpus(), seed=3, compact_min=10_000)


def test_default_backend_is_the_engines_own(engine):
    """The one deliberate difference from the reference's config: the
    coalesced batches run on the engine's own torch backend (the
    reference's default is its float64 numpy loops), and answer as a direct
    ``query_batch`` with no backend named does."""
    assert RuntimeConfig().backend == "torch"
    assert RefConfig().backend == "numpy"
    queries = random_queries(engine.dataset, 2, 4, seed=11)
    direct = engine.query_batch(queries, k=2, tier="exact")
    with ServingRuntime(engine) as rt:
        got = [rt.submit({"op": "query", "keywords": q, "k": 2,
                          "tier": "exact"}).result(10) for q in queries]
    assert all(isinstance(r, RuntimeResponse) and r.ok for r in got)
    for r, want in zip(got, direct):
        assert _keys(r.payload["candidates"]) == _keys(want.candidates)


# ----------------------------------------------------------------- coalescing
def test_coalesced_batch_parity(engine):
    queries = random_queries(engine.dataset, 2, 24, seed=5)
    ref = engine.query_batch(queries, k=3, tier="exact")
    with ServingRuntime(engine, RuntimeConfig(max_batch=8,
                                              batch_window_s=0.01)) as rt:
        tickets = [rt.submit({"op": "query", "keywords": q, "k": 3,
                              "tier": "exact"}) for q in queries]
        results = [t.result(10) for t in tickets]
    assert all(r.ok for r in results)
    for got, want in zip(results, ref):
        assert _keys(got.payload["candidates"]) == _keys(want.candidates)
    assert rt.stats.batches < len(queries)          # coalescing happened
    assert rt.stats.batched_queries == len(queries)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_mixed_keys_still_parity(engine, backend):
    """Different (tier, k) buckets interleaved: each request is answered at
    its own key, bit-identical to a direct call (``query`` for the numpy
    backend, as in the reference; a batch of one on the torch backend)."""
    queries = random_queries(engine.dataset, 2, 12, seed=8)
    specs = [(q, ("exact" if i % 2 else "approx"), 1 + i % 3)
             for i, q in enumerate(queries)]
    with ServingRuntime(engine, RuntimeConfig(batch_window_s=0.005,
                                              backend=backend)) as rt:
        tickets = [rt.submit({"op": "query", "keywords": q, "k": k,
                              "tier": tier}) for q, tier, k in specs]
        results = [t.result(10) for t in tickets]
    for (q, tier, k), got in zip(specs, results):
        if backend == "numpy":
            want = engine.query([int(v) for v in q], k=k, tier=tier)
        else:
            want = engine.query_batch([q], k=k, tier=tier)[0]
        assert _keys(got.payload["candidates"]) == _keys(want.candidates)


def test_consecutive_ingest_ops_coalesce_into_one_run(tmp_path):
    """Back-to-back ingest ops at the queue head drain as one run behind a
    single WAL group-commit barrier: every ticket still acks only after the
    shared fsync, and the run counter proves the coalescing happened."""
    engine = _engine(_corpus(), seed=3, compact_min=10_000)
    engine.attach_wal(str(tmp_path / "wal"))
    rng = np.random.default_rng(4)
    batches = [(rng.standard_normal((4, engine.dataset.dim))
                .astype(np.float32), [[0, 1]] * 4) for _ in range(5)]
    with ServingRuntime(engine, RuntimeConfig(batch_window_s=0.05)) as rt:
        with rt._engine_lock:                       # stall the worker
            tickets = [rt.submit({"op": "insert", "points": pts,
                                  "keywords": kws}) for pts, kws in batches]
        results = [t.result(10) for t in tickets]
    assert all(r.ok for r in results)
    assert rt.stats.ingest_runs >= 1                # multi-op run happened
    assert rt.stats.ingest_ops == len(batches)
    st = engine.wal_stats
    assert st.group_commits >= 1
    assert st.appends == len(batches)
    # Coalescing must amortize the barrier: fewer fsyncs than acked ops.
    assert st.fsyncs < len(batches)
    engine.close()


def test_ingest_barrier_not_reordered(engine):
    """A query admitted after an insert observes it: coalescing never hoists
    a query past an earlier ingest op."""
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((5, engine.dataset.dim)).astype(np.float32)
    kws = [[0, 1]] * 5
    with ServingRuntime(engine, RuntimeConfig(batch_window_s=0.05)) as rt:
        with rt._engine_lock:                       # stall the worker
            t_q1 = rt.submit({"op": "query", "keywords": [0, 1], "k": 5,
                              "tier": "exact"})
            t_ins = rt.submit({"op": "insert", "points": pts,
                               "keywords": kws})
            t_q2 = rt.submit({"op": "query", "keywords": [0, 1], "k": 5,
                              "tier": "exact"})
        ids = t_ins.result(10).payload["ids"]
        after = t_q2.result(10)
        t_q1.result(10)
    got_ids = {i for c in after.payload["candidates"] for i in c.ids}
    # the inserted identical points dominate k=5 for their own keywords
    assert set(ids) & got_ids


# -------------------------------------------------------------------- retries
def test_transient_dispatch_retries_then_succeeds(engine):
    queries = random_queries(engine.dataset, 2, 4, seed=9)
    ref = engine.query_batch(queries, k=2, tier="exact")
    faults = FaultPlan(transient={"dispatch": (1, 2)})
    with ServingRuntime(engine, RuntimeConfig(retry_backoff_s=0.001),
                        faults=faults) as rt:
        tickets = [rt.submit({"op": "query", "keywords": q, "k": 2,
                              "tier": "exact"}) for q in queries]
        results = [t.result(10) for t in tickets]
    assert all(r.ok for r in results)
    assert rt.stats.dispatch_retries == 2           # bounded, counted
    assert faults.fired["dispatch"] == 2
    for got, want in zip(results, ref):
        assert _keys(got.payload["candidates"]) == _keys(want.candidates)


def test_retries_are_bounded(engine):
    faults = FaultPlan(transient={"dispatch": tuple(range(1, 20))})
    with ServingRuntime(engine, RuntimeConfig(max_retries=2,
                                              retry_backoff_s=0.001),
                        faults=faults) as rt:
        r = rt.submit({"op": "query", "keywords": [0, 1], "k": 1}).result(10)
    assert r.status == "error" and "3 attempts" in r.error
    assert rt.stats.dispatch_failures == 1
    assert faults.fired["dispatch"] == 3            # initial + 2 retries


def test_bad_request_isolated_from_batchmates(engine):
    with ServingRuntime(engine, RuntimeConfig(batch_window_s=0.02)) as rt:
        with rt._engine_lock:
            bad = rt.submit({"op": "query", "keywords": [99999], "k": 1})
            good = rt.submit({"op": "query", "keywords": [0, 1], "k": 1})
        rb, rg = bad.result(10), good.result(10)
    assert rb.status == "error" and "ValueError" in rb.error
    assert rg.ok
    assert rt.stats.single_fallbacks == 2 and rt.stats.errors == 1


# ------------------------------------------------------- overload + deadlines
def test_queue_overflow_rejects_immediately(engine):
    cfg = RuntimeConfig(max_queue=4, batch_window_s=0.0)
    with ServingRuntime(engine, cfg) as rt:
        with rt._engine_lock:                       # worker blocks on first
            first = rt.submit({"op": "query", "keywords": [0], "k": 1})
            _wait(lambda: len(rt._queue) == 0)      # worker picked it up
            held = [rt.submit({"op": "query", "keywords": [0], "k": 1})
                    for _ in range(4)]
            over = rt.submit({"op": "query", "keywords": [0], "k": 1})
            assert over.done()                      # rejected synchronously
            assert over.result().status == "rejected"
            assert "full" in over.result().error
        results = [t.result(10) for t in [first, *held]]
    assert all(r.ok for r in results)               # accepted work unharmed
    assert rt.stats.rejected_full == 1


def test_deadline_expires_queued_request(engine):
    with ServingRuntime(engine, RuntimeConfig(batch_window_s=0.0)) as rt:
        with rt._engine_lock:
            first = rt.submit({"op": "query", "keywords": [0], "k": 1})
            _wait(lambda: len(rt._queue) == 0)
            doomed = rt.submit({"op": "query", "keywords": [0], "k": 1},
                               deadline_s=0.01)
            time.sleep(0.05)                        # deadline passes queued
        assert first.result(10).ok
        r = doomed.result(10)
    assert r.status == "timeout"
    assert rt.stats.expired == 1


def test_overload_sheds_exact_to_approx(engine):
    queries = random_queries(engine.dataset, 2, 5, seed=4)
    ref = engine.query_batch(queries, k=2, tier="approx")
    cfg = RuntimeConfig(max_queue=8, degrade_watermark=0.5,
                        batch_window_s=0.0)
    with ServingRuntime(engine, cfg) as rt:
        with rt._engine_lock:
            first = rt.submit({"op": "query", "keywords": queries[0],
                               "k": 2, "tier": "exact"})
            _wait(lambda: len(rt._queue) == 0)
            held = [rt.submit({"op": "query", "keywords": q, "k": 2,
                               "tier": "exact"}) for q in queries]
        assert first.result(10).degraded is False   # dispatched pre-overload
        results = [t.result(10) for t in held]
    # 5 queued >= 0.5 * 8: the batch was shed to approx, and says so.
    assert all(r.ok and r.degraded and r.tier == "approx" for r in results)
    assert rt.stats.degraded_queries == len(queries)
    for got, want in zip(results, ref):
        assert _keys(got.payload["candidates"]) == _keys(want.candidates)


# ---------------------------------------------------------------- compaction
def test_background_compaction_keeps_parity(engine):
    """Cadence-triggered off-thread compaction: ingest acks never wait for
    the rebuild, the swap is atomic, and post-swap answers match a reference
    engine that compacted synchronously."""
    engine.compact_min = 60                          # small cadence
    ref = _engine(engine.dataset, seed=3, compact_min=60)
    rng = np.random.default_rng(6)
    queries = random_queries(engine.dataset, 2, 6, seed=7)
    with ServingRuntime(engine, RuntimeConfig(batch_window_s=0.0)) as rt:
        for _ in range(4):
            pts = rng.standard_normal((25, engine.dataset.dim)) \
                .astype(np.float32)
            kws = [sorted(rng.choice(24, 2, replace=False).tolist())
                   for _ in range(25)]
            assert rt.submit({"op": "insert", "points": pts,
                              "keywords": kws}).result(10).ok
            ref.insert(pts, kws)
        _wait(lambda: not rt._compacting and rt.stats.bg_compactions >= 1)
        tickets = [rt.submit({"op": "query", "keywords": q, "k": 2,
                              "tier": "exact"}) for q in queries]
        results = [t.result(10) for t in tickets]
    assert engine.corpus_generation >= 1
    want = ref.query_batch(queries, k=2, tier="exact")
    for got, w in zip(results, want):
        assert _keys(got.payload["candidates"]) == _keys(w.candidates)


def test_compaction_defers_ingest_not_queries(engine):
    """While a rebuild is in flight, ingest is parked (and acked after the
    swap); queries keep flowing against the old generation."""
    engine.compact_min = 40
    engine.compact_ratio = 0.05
    rng = np.random.default_rng(1)
    gate = threading.Event()
    orig_prepare = engine.compact_prepare

    def slow_prepare():
        gate.wait(5)
        return orig_prepare()
    engine.compact_prepare = slow_prepare
    try:
        with ServingRuntime(engine, RuntimeConfig(batch_window_s=0.0)) as rt:
            pts = rng.standard_normal((50, engine.dataset.dim)) \
                .astype(np.float32)
            kws = [[0, 1]] * 50
            assert rt.submit({"op": "insert", "points": pts,
                              "keywords": kws}).result(10).ok
            _wait(lambda: rt._compacting)           # rebuild gated open
            parked = rt.submit({"op": "insert", "points": pts[:3],
                                "keywords": kws[:3]})
            q = rt.submit({"op": "query", "keywords": [0, 1], "k": 1,
                           "tier": "exact"})
            assert q.result(10).ok                  # queries never stall
            _wait(lambda: rt.stats.deferred_ingest >= 1)
            assert not parked.done()                # ack waits for the swap
            gate.set()
            assert parked.result(10).ok             # flushed after commit
        assert rt.stats.bg_compactions == 1
        assert engine.corpus_generation == 1
    finally:
        engine.compact_prepare = orig_prepare


def test_worker_survives_empty_coalesce(engine):
    """The batch-window wait releases the lock; a deferred-ingest flush in
    that window puts an ingest op at the queue head and the barrier keeps
    everything — _gather_locked returns []. The worker must treat that as a
    spurious wakeup, not dispatch an empty batch and die."""
    with ServingRuntime(engine, RuntimeConfig(batch_window_s=0.0)) as rt:
        orig = rt._gather_locked
        calls = {"n": 0}

        def racy_gather():
            calls["n"] += 1
            if calls["n"] == 1:
                return []                       # simulate the lost race
            return orig()
        rt._gather_locked = racy_gather
        r = rt.submit({"op": "query", "keywords": [0, 1], "k": 1}).result(5)
        assert r.ok                             # worker looped, then served
        assert calls["n"] >= 2
        assert rt._worker.is_alive()


def test_compactor_survives_unexpected_exception(engine):
    """A real (non-injected) rebuild exception must not kill the compactor
    thread: the old generation keeps serving, the error is surfaced in
    stats/health, and the next churn trigger retries successfully."""
    engine.compact_min = 40
    engine.compact_ratio = 0.05
    rng = np.random.default_rng(12)
    orig_prepare = engine.compact_prepare
    state = {"boom": True}

    def buggy_prepare():
        if state["boom"]:
            state["boom"] = False
            raise ValueError("rebuild bug")
        return orig_prepare()
    engine.compact_prepare = buggy_prepare
    try:
        with ServingRuntime(engine, RuntimeConfig(batch_window_s=0.0)) as rt:
            def feed():
                pts = rng.standard_normal((50, engine.dataset.dim)) \
                    .astype(np.float32)
                return rt.submit({"op": "insert", "points": pts,
                                  "keywords": [[0, 1]] * 50}).result(10)
            assert feed().ok
            _wait(lambda: rt.stats.bg_compaction_errors == 1)
            assert rt._compactor.is_alive()     # survived the bug
            assert engine.corpus_generation == 0        # nothing swapped
            assert "ValueError" in rt.health()["last_compaction_error"]
            assert feed().ok                    # serving continues
            _wait(lambda: rt.stats.bg_compactions == 1)  # retry succeeds
        assert engine.corpus_generation == 1
    finally:
        engine.compact_prepare = orig_prepare


def test_close_drain_never_strands_deferred_ingest(engine):
    """close(drain=True) while a compaction is in flight: the worker drains
    the queue and exits, then the compactor flushes deferred ingest into a
    queue nobody serves. Those tickets must still resolve — a caller blocked
    in result() with no timeout must never hang forever."""
    engine.compact_min = 40
    engine.compact_ratio = 0.05
    rng = np.random.default_rng(15)
    gate = threading.Event()
    orig_prepare = engine.compact_prepare

    def slow_prepare():
        gate.wait(5)
        return orig_prepare()
    engine.compact_prepare = slow_prepare
    try:
        rt = ServingRuntime(engine, RuntimeConfig(batch_window_s=0.0))
        pts = rng.standard_normal((50, engine.dataset.dim)) \
            .astype(np.float32)
        assert rt.submit({"op": "insert", "points": pts,
                          "keywords": [[0, 1]] * 50}).result(10).ok
        _wait(lambda: rt._compacting)           # rebuild gated open
        parked = rt.submit({"op": "insert", "points": pts[:2],
                            "keywords": [[0, 1]] * 2})
        _wait(lambda: rt.stats.deferred_ingest >= 1)
        closer = threading.Thread(target=rt.close)
        closer.start()
        _wait(lambda: not rt._worker.is_alive())    # worker drained + exited
        gate.set()                              # now the compactor commits
        closer.join(10)
        assert not closer.is_alive()
        r = parked.result(1)                    # resolved, never stranded
        assert r.status == "rejected"           # unacked: rejection is safe
    finally:
        engine.compact_prepare = orig_prepare


def test_compaction_crash_leaves_no_torn_generation(tmp_path):
    """InjectedCrash mid-rebuild (after the compacted dataset materialises,
    before the new indices exist): nothing is swapped — the old generation
    keeps answering bit-identically — and WAL recovery replays the acked ops
    to a state matching an uninterrupted reference."""
    ds = _corpus(n=200)
    faults = FaultPlan(crash={"compact": 1})
    engine = _engine(ds, seed=3, compact_min=40, faults=faults)
    engine.attach_wal(str(tmp_path / "wal"))
    ref = _engine(ds, seed=3, compact_min=40, auto_compact=False)
    rng = np.random.default_rng(9)
    queries = random_queries(ds, 2, 6, seed=3)
    pts = rng.standard_normal((50, ds.dim)).astype(np.float32)
    kws = [sorted(rng.choice(24, 2, replace=False).tolist())
           for _ in range(50)]

    rt = ServingRuntime(engine, RuntimeConfig(batch_window_s=0.0))
    try:
        assert rt.submit({"op": "insert", "points": pts,
                          "keywords": kws}).result(10).ok   # acked
        ref.insert(pts, kws)
        _wait(lambda: rt.health()["crashed"])       # compactor died
        assert rt.stats.bg_compactions == 0
        # No torn generation: nothing swapped, old generation intact and
        # bit-identical (the engine object itself is still coherent).
        assert engine.corpus_generation == 0
        for got, want in zip(engine.query_batch(queries, k=2, tier="exact"),
                             ref.query_batch(queries, k=2, tier="exact")):
            assert _keys(got.candidates) == _keys(want.candidates)
        # Post-crash submissions are refused, not silently dropped.
        r = rt.submit({"op": "query", "keywords": [0], "k": 1}).result(10)
        assert r.status == "rejected" and "down" in r.error
    finally:
        rt.close()
    engine.close()

    # Process restart: WAL replay reaches the same acked state (the crashed
    # compaction was never logged — it never committed).
    rec = NKSEngine.recover(str(tmp_path / "wal"), device="cpu")
    assert rec.ingest.replayed_ops == 1
    for got, want in zip(rec.query_batch(queries, k=2, tier="exact"),
                         ref.query_batch(queries, k=2, tier="exact")):
        assert _keys(got.candidates) == _keys(want.candidates)
    rec.close()


def test_transient_compaction_fault_retries_on_next_trigger(engine):
    engine.compact_min = 40
    engine.compact_ratio = 0.05
    faults = FaultPlan(transient={"compact": 1})
    engine._faults = faults
    rng = np.random.default_rng(4)
    with ServingRuntime(engine, RuntimeConfig(batch_window_s=0.0),
                        faults=faults) as rt:
        def feed():
            pts = rng.standard_normal((50, engine.dataset.dim)) \
                .astype(np.float32)
            return rt.submit({"op": "insert", "points": pts,
                              "keywords": [[0, 1]] * 50}).result(10)
        assert feed().ok
        _wait(lambda: rt.stats.bg_compaction_faults == 1)
        assert engine.corpus_generation == 0        # rebuild failed, no swap
        assert feed().ok                            # serving continues
        _wait(lambda: rt.stats.bg_compactions == 1)  # next trigger succeeds
    assert engine.corpus_generation == 1


# ------------------------------------------------------------- wal_ack crash
def test_wal_ack_crash_through_runtime(tmp_path):
    """Kill between WAL append and ack, driven through the runtime: the
    caller sees ``crashed`` (no ack), recovery applies the durable op, and
    every op acked before the crash survives."""
    ds = _corpus(n=150)
    faults = FaultPlan(crash={"wal_ack": 2})
    engine = _engine(ds, seed=1, compact_min=10_000, faults=faults)
    engine.attach_wal(str(tmp_path / "wal"))
    rng = np.random.default_rng(3)
    b1 = (rng.standard_normal((6, ds.dim)).astype(np.float32), [[0, 1]] * 6)
    b2 = (rng.standard_normal((4, ds.dim)).astype(np.float32), [[2, 3]] * 4)
    queries = random_queries(ds, 2, 5, seed=6)

    rt = ServingRuntime(engine, RuntimeConfig(batch_window_s=0.0))
    try:
        acked = rt.submit({"op": "insert", "points": b1[0],
                           "keywords": b1[1]}).result(10)
        assert acked.ok                             # durable + acknowledged
        unacked = rt.submit({"op": "insert", "points": b2[0],
                             "keywords": b2[1]}).result(10)
        assert unacked.status == "crashed"          # durable, never acked
        assert rt.health()["crashed"]
    finally:
        rt.close()

    rec = NKSEngine.recover(str(tmp_path / "wal"), device="cpu")
    ref = _engine(ds, seed=1, compact_min=10_000)
    ref.insert(*b1)
    ref.insert(*b2)        # at-least-once below the ack horizon
    assert rec.ingest.replayed_ops == 2
    for tier in ("exact", "approx"):
        for got, want in zip(rec.query_batch(queries, k=2, tier=tier),
                             ref.query_batch(queries, k=2, tier=tier)):
            assert _keys(got.candidates) == _keys(want.candidates)
    # No acknowledged write lost: b1's points are all live and queryable.
    got = rec.query([0, 1], k=6, tier="exact")
    assert {i for c in got.candidates for i in c.ids} \
        .intersection(range(ds.n, ds.n + 6))
    rec.close()


# -------------------------------------------------------------------- health
def test_health_and_close_restores_engine(engine):
    was = engine.auto_compact
    rt = ServingRuntime(engine)
    h = rt.submit({"op": "health"}).result(1)
    assert h.ok and h.payload["queue_depth"] == 0
    assert h.payload["generation"] == 0
    assert h.payload["degraded"] is False
    assert h.payload["wal_attached"] is False
    assert engine.auto_compact is False             # runtime owns cadence
    rt.close()
    assert engine.auto_compact is was               # returned on close


# ------------------------------------------------ against the reference's
# Counterpart backends: port "numpy" is the reference's "numpy"; port "torch"
# is the reference's Pallas backend on the device route (interpret mode).
PAIRS = {"numpy": "numpy",
         "torch": lambda: PallasBackend(route="device", interpret=True)}


def _pair(kind, n=300, **kw):
    """The same seeded corpus in both packages, an engine over each, and
    the two runtime configs of one counterpart backend pair."""
    opts = dict(n=n, d=5, u=24, t=2, seed=0)
    port = _engine(synthetic_dataset(**opts), seed=3, **kw)
    ref = RefEngine(ref_synth(**opts), seed=3, **kw)
    theirs = PAIRS[kind]() if callable(PAIRS[kind]) else PAIRS[kind]
    return port, ref, kind, theirs


def _serve(runtime, requests, stall=False):
    """Submit ``requests`` to ``runtime`` (with its worker stalled behind
    the engine lock while they are admitted, when ``stall``) and return
    the responses in order."""
    if stall:
        with runtime._engine_lock:
            tickets = [runtime.submit(r) for r in requests]
    else:
        tickets = [runtime.submit(r) for r in requests]
    return [t.result(60) for t in tickets]


def _answers(responses):
    return [(r.status, r.tier, r.degraded,
             _keys(r.payload["candidates"]) if r.op == "query" and r.ok
             else r.payload.get("ids")) for r in responses]


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_coalesced_and_mixed_keys_equal_reference(kind):
    """The same stream of queries at several (tier, k) keys through both
    packages' runtimes, coalesced: every answer equal, bit for bit."""
    port, ref, mine, theirs = _pair(kind, compact_min=10_000)
    queries = random_queries(port.dataset, 2, 12, seed=5)
    reqs = [{"op": "query", "keywords": q, "k": 1 + i % 3,
             "tier": "exact" if i % 2 else "approx"}
            for i, q in enumerate(queries)]
    got = {}
    for name, eng, be, Runtime, Config in (
            ("port", port, mine, ServingRuntime, RuntimeConfig),
            ("ref", ref, theirs, RefRuntime, RefConfig)):
        with Runtime(eng, Config(max_batch=4, batch_window_s=0.01,
                                 backend=be)) as rt:
            got[name] = _answers(_serve(rt, reqs, stall=True))
            assert rt.stats.batches < len(reqs)
    assert got["port"] == got["ref"]
    assert all(a[0] == "ok" for a in got["port"])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_ingest_barrier_equals_reference(kind):
    """A query, an insert and the same query again admitted together: both
    packages answer the same, the second query sees the insert, and the
    insert gets the same external ids."""
    port, ref, mine, theirs = _pair(kind, compact_min=10_000)
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((5, port.dataset.dim)).astype(np.float32)
    reqs = [{"op": "query", "keywords": [0, 1], "k": 5, "tier": "exact"},
            {"op": "insert", "points": pts, "keywords": [[0, 1]] * 5},
            {"op": "query", "keywords": [0, 1], "k": 5, "tier": "exact"}]
    got = {}
    for name, eng, be, Runtime, Config in (
            ("port", port, mine, ServingRuntime, RuntimeConfig),
            ("ref", ref, theirs, RefRuntime, RefConfig)):
        with Runtime(eng, Config(batch_window_s=0.05, backend=be)) as rt:
            got[name] = _answers(_serve(rt, reqs, stall=True))
    assert got["port"] == got["ref"]
    ids = set(got["port"][1][3])
    assert ids == set(range(300, 305))
    assert ids & {i for key in got["port"][2][3] for i in key[2]}


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_background_compaction_equals_reference(kind):
    """Inserts through both runtimes trigger the same off-thread compaction;
    afterwards both answer the same queries the same, bit for bit."""
    port, ref, mine, theirs = _pair(kind, compact_min=60)
    rng = np.random.default_rng(6)
    queries = random_queries(port.dataset, 2, 6, seed=7)
    batches = []
    for _ in range(4):
        pts = rng.standard_normal((25, 5)).astype(np.float32)
        kws = [sorted(rng.choice(24, 2, replace=False).tolist())
               for _ in range(25)]
        batches.append({"op": "insert", "points": pts, "keywords": kws})
    got = {}
    for name, eng, be, Runtime, Config in (
            ("port", port, mine, ServingRuntime, RuntimeConfig),
            ("ref", ref, theirs, RefRuntime, RefConfig)):
        with Runtime(eng, Config(batch_window_s=0.0, backend=be)) as rt:
            acks = [rt.submit(b).result(60) for b in batches]
            _wait(lambda: not rt._compacting
                  and rt.stats.bg_compactions >= 1, timeout=60)
            answers = _serve(rt, [{"op": "query", "keywords": q, "k": 2,
                                   "tier": tier} for tier in
                                  ("exact", "approx") for q in queries])
            got[name] = (_answers(acks), _answers(answers),
                         rt.stats.bg_compactions, eng.corpus_generation)
    assert got["port"] == got["ref"]
    assert got["port"][2] == 1


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_runtime_wal_recovers_across_packages(tmp_path, writer):
    """A wal_ack crash through one package's runtime: the WAL root recovers
    in both packages, which answer alike per counterpart backend, and the
    acked batch is live in both."""
    opts = dict(n=150, d=5, u=24, t=2, seed=0)
    faults = FaultPlan(crash={"wal_ack": 2})
    root = str(tmp_path / "wal")
    if writer == "port":
        live = _engine(synthetic_dataset(**opts), seed=1,
                       compact_min=10_000, faults=faults)
        Runtime, Config = ServingRuntime, RuntimeConfig
    else:
        from repro.serve.faults import FaultPlan as RefFaultPlan
        live = RefEngine(ref_synth(**opts), seed=1, compact_min=10_000,
                         faults=RefFaultPlan(crash={"wal_ack": 2}))
        Runtime, Config = RefRuntime, RefConfig
    live.attach_wal(root)
    rng = np.random.default_rng(3)
    b1 = (rng.standard_normal((6, 5)).astype(np.float32), [[0, 1]] * 6)
    b2 = (rng.standard_normal((4, 5)).astype(np.float32), [[2, 3]] * 4)
    rt = Runtime(live, Config(batch_window_s=0.0))
    try:
        assert rt.submit({"op": "insert", "points": b1[0],
                          "keywords": b1[1]}).result(10).ok
        assert rt.submit({"op": "insert", "points": b2[0],
                          "keywords": b2[1]}).result(10).status == "crashed"
    finally:
        rt.close()
    port = NKSEngine.recover(root, device="cpu")
    ref = RefEngine.recover(root)
    assert port.ingest.replayed_ops == ref.ingest.replayed_ops == 2
    np.testing.assert_array_equal(port._ext_of, ref._ext_of)
    queries = random_queries(synthetic_dataset(**opts), 2, 5, seed=6)
    pallas = PallasBackend(route="device", interpret=True)
    for tier in ("exact", "approx"):
        for mine, theirs in (("numpy", "numpy"), ("torch", pallas)):
            a = [_keys(r.candidates) for r in
                 port.query_batch(queries, k=2, tier=tier, backend=mine)]
            b = [_keys(r.candidates) for r in
                 ref.query_batch(queries, k=2, tier=tier, backend=theirs)]
            assert a == b, (tier, mine)
    got = port.query([0, 1], k=6, tier="exact")
    assert {i for c in got.candidates for i in c.ids} \
        .intersection(range(150, 156))
    port.close()
    ref.close()
