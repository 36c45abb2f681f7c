"""Fault-tolerant serving runtime: admission queue, coalesced batches,
deadlines, degradation, and off-thread compaction.

``launch/serve.py``'s synchronous loop answers one request at a time and
stalls everything for the O(N) compaction rebuild. This runtime is the
production shape sitting between a frontend and :class:`NKSEngine`:

  * **bounded admission queue** — ``submit`` enqueues a request and returns a
    :class:`Ticket` (a future). A full queue *rejects immediately*
    (backpressure beats unbounded latency); per-request deadlines expire
    queued work before it wastes a dispatch, and an expired request gets a
    ``timeout`` response, never silence.
  * **coalescing worker** — one thread drives the engine. Queued queries
    with the same (tier, k, filter) are coalesced into a single
    ``query_batch`` call, amortising the plan stage exactly the way the
    batched pipeline amortises dispatch; a short batch window lets
    near-simultaneous arrivals merge.
  * **retry with backoff** — a transient dispatch failure retries up to
    ``max_retries`` with exponential backoff; retries are bounded, and a
    batch that keeps failing degrades to per-request execution so one
    poisoned request cannot sink its batchmates.
  * **graceful degradation** — past the ``degrade_watermark`` queue depth,
    exact-tier requests are shed to the approx tier (recorded per-response
    as ``degraded``) instead of letting the queue collapse.
  * **off-thread compaction** — the cadence-triggered rebuild runs on a
    background thread against the frozen view (``compact_prepare``), then
    swaps atomically under the engine lock (``compact_commit``). Queries
    never stall; ingest ops arriving mid-rebuild are *deferred* (admission
    order preserved) and flushed after the swap, so the prepared bulk can
    never silently drop an interleaved write.

Consistency model (weaker than the synchronous loop, standard for async
serving): an **acknowledged** write is visible to every query submitted
after the ack, and — with a WAL attached — survives process death. Ordering
between a query and a write whose ack the client has not yet seen is
unspecified (deferred ingest may land after a later-submitted query runs).

On the card the worker's coalesced batches launch the engine's join
kernels (K1, and K2 where the cost model arms the prune tier) or the
anchor-star kernel (the device tier), inserts and compactions launch K5,
all on the CUDA device's current stream, so launches from the worker and
the compactor are ordered on it. The compactor's ``compact_prepare`` reads
the engine's resident corpus (``backend._points_dev``) outside the engine
lock; nothing else replaces that buffer meanwhile: only an insert (parked
while a rebuild runs) and ``compact_commit`` (under the lock) attach rows,
and a query attaches its own generation's rows, a no-op.

Spans, on ``time.perf_counter()``: every :class:`Ticket` carries its
request id and its admission, pick-up, engine-call and answer stamps;
``RuntimeStats`` sums the queue and coalescing-window waits; and with
``RuntimeConfig.span_log`` set, a bounded log keeps one
:class:`BatchSpan` a coalesced batch, the engine's per-query spans of the
call among them (``ServingRuntime.spans``).

Fault injection (``serve.faults``) threads one deterministic
:class:`FaultPlan` through the runtime (``dispatch``), the engine
(``compact``), and the WAL (``wal_ack``); an :class:`InjectedCrash` anywhere
marks the runtime dead — every in-flight ticket resolves with status
``crashed`` and recovery happens via ``NKSEngine.recover``, exactly as a real
process death would.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from collections import deque

from repro_torch.serve.engine import NKSEngine
from repro_torch.serve.faults import (NO_FAULTS, FaultPlan, InjectedCrash,
                                     InjectedFault)


class TransientDispatchError(RuntimeError):
    """Raise-to-retry marker for genuinely transient dispatch failures."""


_RETRYABLE = (InjectedFault, TransientDispatchError)


@dataclasses.dataclass
class RuntimeConfig:
    max_queue: int = 256            # admission bound (backpressure past it)
    max_batch: int = 32             # coalesced query batch cap
    batch_window_s: float = 0.002   # wait this long to let arrivals coalesce
    default_deadline_s: float | None = None   # None = no deadline
    max_retries: int = 3            # transient dispatch retries per batch
    retry_backoff_s: float = 0.005  # base backoff (doubles per attempt)
    degrade_watermark: float = 0.75  # queue fraction past which exact sheds
    tier: str = "approx"            # default tier for requests without one
    k: int = 1                      # default top-k
    # Distance backend of the coalesced batches: "torch", the engine's own
    # backend on its device (query_batch's default), or "numpy", float64
    # loops on the host.
    backend: str = "torch"
    # Coalesced batches kept in the span log (``ServingRuntime.spans``), the
    # newest last; 0 keeps none.
    span_log: int = 0


@dataclasses.dataclass
class RuntimeStats:
    submitted: int = 0
    admitted: int = 0
    rejected_full: int = 0
    expired: int = 0
    completed: int = 0
    errors: int = 0
    crashed: int = 0
    batches: int = 0
    batched_queries: int = 0
    degraded_queries: int = 0
    dispatch_retries: int = 0
    dispatch_failures: int = 0      # batches that exhausted their retries
    single_fallbacks: int = 0       # per-request isolation runs
    ingest_ops: int = 0
    ingest_runs: int = 0            # multi-op runs group-committed together
    deferred_ingest: int = 0
    bg_compactions: int = 0
    bg_compaction_faults: int = 0
    bg_compaction_errors: int = 0   # unexpected rebuild exceptions survived
    # Waits, on time.perf_counter(): the sum over query tickets of admission
    # to pick-up, and the coalescing-window waits the worker took (their
    # sum and count).
    t_queue_s: float = 0.0
    t_window_s: float = 0.0
    window_waits: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def mean_batch(self) -> float:
        return self.batched_queries / self.batches if self.batches else 0.0


@dataclasses.dataclass
class RuntimeResponse:
    """What a :class:`Ticket` resolves to.

    ``status``: ``ok`` | ``rejected`` | ``timeout`` | ``error`` | ``crashed``.
    ``payload`` carries the op-specific result (``candidates`` for queries —
    :class:`~repro_torch.core.types.Candidate` objects, externalized ids — or the
    ingest-state dict for mutating ops). ``degraded`` marks an exact-tier
    request served at the approx tier under overload."""

    op: str
    status: str
    payload: dict = dataclasses.field(default_factory=dict)
    error: str | None = None
    degraded: bool = False
    tier: str | None = None
    latency_s: float = 0.0          # admission to resolution

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass
class BatchSpan:
    """One coalesced batch in the span log, on ``time.perf_counter()``.

    ``batch`` is its id (``RuntimeStats.batches`` at its dispatch);
    ``window`` the (start, end) of the coalescing-window wait taken before
    its pick-up, or None; ``picked``, ``started`` (engine lock held, fault
    check passed) and ``ended`` (``query_batch`` returned) its boundaries.
    ``requests`` holds (request id, admitted_at, answered_at) per ticket,
    in query order. ``t_call_start`` and ``query_spans`` are the engine's
    spans of the call (:class:`~repro_torch.serve.engine.PipelineStats`),
    children of this batch: per query (pack_start, dispatch_start,
    readback_done), filled by the device tier."""

    batch: int
    window: tuple[float, float] | None
    picked: float
    started: float
    ended: float
    requests: list[tuple[int, float, float]]
    t_call_start: float | None = None
    query_spans: list[tuple[float, float, float]] = dataclasses.field(
        default_factory=list)


class Ticket:
    """Single-use future handed back by :meth:`ServingRuntime.submit`.

    ``rid`` is the request's admission sequence number (None outside a
    runtime); ``admitted_at`` (its creation unless given), ``picked_at``
    (a query popped into a batch), ``started_at`` (its batch's engine call
    began) and ``answered_at`` (resolved) are ``time.perf_counter()``
    stamps, None where the ticket never got there (an ingest op is not
    picked or started)."""

    __slots__ = ("request", "deadline", "rid", "admitted_at", "picked_at",
                 "started_at", "answered_at", "_event", "response")

    def __init__(self, request: dict, deadline: float | None,
                 rid: int | None = None, admitted_at: float | None = None):
        self.request = request
        self.deadline = deadline
        self.rid = rid
        self.admitted_at = time.perf_counter() if admitted_at is None \
            else admitted_at
        self.picked_at: float | None = None
        self.started_at: float | None = None
        self.answered_at: float | None = None
        self._event = threading.Event()
        self.response: RuntimeResponse | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> RuntimeResponse:
        if not self._event.wait(timeout):
            raise TimeoutError("ticket not resolved within wait timeout")
        return self.response

    def _resolve(self, response: RuntimeResponse) -> None:
        self.answered_at = time.perf_counter()
        response.latency_s = self.answered_at - self.admitted_at
        self.response = response
        self._event.set()


def _filter_key(flt) -> str:
    if flt is None:
        return ""
    return json.dumps(flt, sort_keys=True) if isinstance(flt, dict) else repr(flt)


def _semantics_key(sem) -> str:
    """Canonical batch-key component for the request's flexible semantics:
    requests may only coalesce into one ``query_batch`` call when their
    m/weights/score/alpha knobs agree exactly."""
    if sem is None:
        return ""
    return json.dumps(sem, sort_keys=True) if isinstance(sem, dict) \
        else sem.canonical_key()


_INGEST_OPS = frozenset(("insert", "delete", "compact", "snapshot"))


class ServingRuntime:
    """One engine, one worker thread, one background compactor.

    The runtime takes over compaction cadence from the engine
    (``auto_compact`` is disabled while attached and restored on close):
    the same churn threshold now triggers the *background* rebuild.
    """

    def __init__(self, engine: NKSEngine, config: RuntimeConfig | None = None,
                 faults: FaultPlan | None = None):
        self.engine = engine
        self.cfg = config or RuntimeConfig()
        self.faults = faults or getattr(engine, "_faults", None) or NO_FAULTS
        self.stats = RuntimeStats()
        self._rids = itertools.count()
        self._spans: deque[BatchSpan] | None = \
            deque(maxlen=self.cfg.span_log) if self.cfg.span_log > 0 else None
        # the coalescing-window wait of the worker's last gather, if taken
        self._window: tuple[float, float] | None = None
        self._queue: deque[Ticket] = deque()
        self._deferred: list[Ticket] = []   # ingest parked during a rebuild
        self._lock = threading.Lock()           # guards queue + flags
        self._work = threading.Condition(self._lock)
        self._engine_lock = threading.Lock()    # serialises engine mutation
        self._stop = False
        self._drain = True
        self._crashed: InjectedCrash | None = None
        self._compacting = False
        self._last_compaction_error: str | None = None
        self._compact_req = threading.Event()
        self._auto_compact_was = engine.auto_compact
        engine.auto_compact = False
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="nks-runtime-worker", daemon=True)
        self._compactor = threading.Thread(target=self._compactor_loop,
                                           name="nks-runtime-compactor",
                                           daemon=True)
        self._worker.start()
        self._compactor.start()

    # -------------------------------------------------------------- frontend
    def submit(self, request: dict,
               deadline_s: float | None = None) -> Ticket:
        """Admit one request; always returns a ticket (a rejected request's
        ticket is already resolved — the caller never blocks to learn of
        backpressure)."""
        op = request.get("op", "query")
        deadline = deadline_s if deadline_s is not None \
            else request.get("deadline_s", self.cfg.default_deadline_s)
        now = time.perf_counter()
        ticket = Ticket(request, now + deadline if deadline is not None
                        else None, next(self._rids), now)
        self.stats.submitted += 1
        if op == "health":
            ticket._resolve(RuntimeResponse(op="health", status="ok",
                                            payload=self.health()))
            self.stats.completed += 1
            return ticket
        with self._lock:
            if self._crashed is not None or self._stop:
                self.stats.rejected_full += 1
                ticket._resolve(RuntimeResponse(
                    op=op, status="rejected",
                    error="runtime is down" if self._crashed is not None
                    else "runtime is shutting down"))
                return ticket
            if len(self._queue) + len(self._deferred) >= self.cfg.max_queue:
                self.stats.rejected_full += 1
                ticket._resolve(RuntimeResponse(
                    op=op, status="rejected",
                    error=f"admission queue full ({self.cfg.max_queue})"))
                return ticket
            self.stats.admitted += 1
            self._queue.append(ticket)
            self._work.notify_all()
        return ticket

    def spans(self) -> list[BatchSpan]:
        """The span log's batches, oldest first (empty with ``span_log``
        0)."""
        if self._spans is None:
            return []
        with self._lock:
            return list(self._spans)

    def health(self) -> dict:
        """Queue / generation / degradation snapshot (lock-free reads of
        monotone counters — advisory, not transactional)."""
        depth = len(self._queue)
        return {
            "queue_depth": depth,
            "deferred_ingest": len(self._deferred),
            "max_queue": self.cfg.max_queue,
            "degraded": self._overloaded(depth),
            "compaction_inflight": self._compacting,
            "last_compaction_error": self._last_compaction_error,
            "crashed": self._crashed is not None,
            "generation": self.engine.corpus_generation,
            "delta_points": self.engine.delta_points,
            "tombstones": self.engine.tombstone_count,
            "wal_attached": self.engine.wal_stats is not None,
            "stats": self.stats.as_dict(),
        }

    def close(self, timeout: float = 30.0, drain: bool = True) -> None:
        """Stop the runtime; ``drain`` processes the queue first. Restores
        the engine's auto-compaction."""
        with self._lock:
            self._stop = True
            self._drain = drain
            self._work.notify_all()
        self._compact_req.set()
        self._worker.join(timeout)
        self._compactor.join(timeout)
        self.engine.auto_compact = self._auto_compact_was
        # Unconditionally resolve whatever the threads left behind. Even a
        # draining close can strand tickets: ingest deferred behind an
        # in-flight compaction is flushed back into the queue by the
        # compactor's finally block *after* the worker has already drained
        # and exited — a caller blocked in ticket.result() with no timeout
        # would otherwise hang forever.
        self._fail_pending("rejected", "runtime is shutting down")

    def __enter__(self) -> "ServingRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- worker
    def _overloaded(self, depth: int) -> bool:
        return depth >= self.cfg.degrade_watermark * self.cfg.max_queue

    def _expire(self, now: float) -> None:
        """Resolve queued tickets whose deadline passed (in place)."""
        if not any(t.deadline is not None and t.deadline < now
                   for t in self._queue):
            return
        keep = deque()
        for t in self._queue:
            if t.deadline is not None and t.deadline < now:
                self.stats.expired += 1
                t._resolve(RuntimeResponse(
                    op=t.request.get("op", "query"), status="timeout",
                    error="deadline exceeded before execution"))
            else:
                keep.append(t)
        self._queue = keep

    def _worker_loop(self) -> None:
        run: list[Ticket] | None = None
        batch: list[Ticket] | None = None
        try:
            while True:
                run = batch = None
                with self._lock:
                    while not self._queue and not self._stop:
                        self._work.wait(0.05)
                        self._flush_deferred_locked()
                    if self._stop and (not self._drain or not self._queue):
                        break
                    self._expire(time.perf_counter())
                    if not self._queue:
                        continue
                    head = self._queue[0]
                    hop = head.request.get("op", "query")
                    if hop in _INGEST_OPS:
                        if self._compacting:
                            # Park it: the rebuild prepared against the
                            # frozen view; an interleaved mutation would be
                            # silently dropped by the swap.
                            self._queue.popleft()
                            self._deferred.append(head)
                            self.stats.deferred_ingest += 1
                            continue
                        # A consecutive run of ingest ops at the head shares
                        # one WAL group commit: every op's record hits the
                        # log, one fsync makes the run durable, then every
                        # ack fires. Admission order is preserved — queries
                        # behind the run still see all of it.
                        run = self._gather_ingest_locked()
                    else:
                        batch = self._gather_locked()
                if run is not None:
                    self._exec_ingest_run(run)
                elif batch:
                    self._exec_query_batch(batch, self._window)
                # else: the batch-window wait inside _gather_locked released
                # the lock and the compactor flushed deferred ingest to the
                # queue front — the ingest barrier kept everything, so there
                # is nothing to dispatch. Go around; the ingest op is now the
                # head and the next iteration serves it.
        except InjectedCrash as crash:
            # The op in flight died mid-execution: like a real process death
            # its caller gets no ack — resolve it as crashed so waiters
            # unblock, then take the whole runtime down. (A grouped ingest
            # run that crashed at its group barrier may have made records
            # durable — recovery replays them; the callers never saw an ack,
            # so at-least-once on unacknowledged writes holds, same as the
            # per-op fsync window.)
            inflight = batch if batch is not None \
                else (run if run is not None else [])
            for t in inflight:
                if not t.done():
                    self.stats.crashed += 1
                    t._resolve(RuntimeResponse(
                        op=t.request.get("op", "query"), status="crashed",
                        error=str(crash)))
            self._die(crash)

    def _flush_deferred_locked(self) -> None:
        """Re-admit parked ingest (admission order) once the swap landed."""
        if self._deferred and not self._compacting:
            self._queue.extendleft(reversed(self._deferred))
            self._deferred.clear()

    def _gather_locked(self) -> list[Ticket]:
        """Pop a coalescable run of query tickets (same tier/k/filter),
        stamping their pick-up; the window wait taken, if any, is left in
        ``self._window``."""
        head = self._queue[0]
        key = self._batch_key(head.request)
        self._window = None
        w0 = time.perf_counter()
        if len(self._queue) < self.cfg.max_batch \
                and self.cfg.batch_window_s > 0 \
                and w0 - head.admitted_at < self.cfg.batch_window_s:
            # Young head: give near-simultaneous arrivals one window to
            # coalesce before dispatching a tiny batch.
            self._work.wait(self.cfg.batch_window_s)
            self._window = (w0, time.perf_counter())
            self.stats.t_window_s += self._window[1] - w0
            self.stats.window_waits += 1
        batch, keep = [], deque()
        pending = list(self._queue)
        for i, t in enumerate(pending):
            if t.request.get("op", "query") in _INGEST_OPS:
                # Ingest barrier: a query admitted after a write must not be
                # hoisted past it — coalescing only reorders queries among
                # themselves (observationally equivalent).
                keep.extend(pending[i:])
                break
            if len(batch) < self.cfg.max_batch \
                    and self._batch_key(t.request) == key:
                batch.append(t)
            else:
                keep.append(t)
        self._queue = keep
        now = time.perf_counter()
        for t in batch:
            t.picked_at = now
            self.stats.t_queue_s += now - t.admitted_at
        return batch

    def _gather_ingest_locked(self) -> list[Ticket]:
        """Pop the consecutive ingest run at the queue head (caller holds the
        lock, head is known to be an ingest op). Capped at ``max_batch`` so a
        deep write burst cannot starve queries behind it indefinitely."""
        run: list[Ticket] = []
        while self._queue and len(run) < self.cfg.max_batch \
                and self._queue[0].request.get("op", "query") in _INGEST_OPS:
            run.append(self._queue.popleft())
        return run

    def _batch_key(self, req: dict) -> tuple:
        return (req.get("tier", self.cfg.tier), int(req.get("k", self.cfg.k)),
                _filter_key(req.get("filter")),
                _semantics_key(req.get("semantics")))

    # -------------------------------------------------------------- execution
    def _exec_query_batch(self, batch: list[Ticket],
                          window: tuple[float, float] | None = None) -> None:
        tier, k, _, _ = self._batch_key(batch[0].request)
        flt = batch[0].request.get("filter")
        sem = batch[0].request.get("semantics")
        degraded = False
        eff_tier = tier
        if tier == "exact" and self.engine.index_a is not None \
                and self._overloaded(len(self._queue) + len(batch)):
            # Load shedding: past the watermark an exact request costs more
            # than the queue can afford; the approx tier is the paper's own
            # fast path, and the response says so.
            eff_tier, degraded = "approx", True
        queries = [t.request["keywords"] for t in batch]
        self.stats.batches += 1
        self.stats.batched_queries += len(batch)
        attempt = 0
        while True:
            try:
                self.faults.check("dispatch")
                with self._engine_lock:
                    started = time.perf_counter()
                    for t in batch:
                        t.started_at = started
                    results = self.engine.query_batch(
                        queries, k=k, tier=eff_tier,
                        backend=self.cfg.backend, filter=flt,
                        semantics=sem)
                    ended = time.perf_counter()
                    st = self.engine.last_batch_stats
                break
            except _RETRYABLE as e:
                self.stats.dispatch_retries += 1
                attempt += 1
                if attempt > self.cfg.max_retries:
                    self.stats.dispatch_failures += 1
                    self._fail_batch(batch, f"dispatch failed after "
                                     f"{attempt} attempts: {e}")
                    return
                time.sleep(self.cfg.retry_backoff_s * (2 ** (attempt - 1)))
            except InjectedCrash:
                raise
            except Exception as e:
                # Not transient: isolate — one malformed request must not
                # sink its batchmates.
                if len(batch) == 1:
                    self.stats.errors += 1
                    batch[0]._resolve(RuntimeResponse(
                        op="query", status="error", tier=eff_tier,
                        error=f"{type(e).__name__}: {e}"))
                    return
                for t in batch:
                    self.stats.single_fallbacks += 1
                    self._exec_query_batch([t])
                return
        if degraded:
            self.stats.degraded_queries += len(batch)
        for t, res in zip(batch, results):
            self.stats.completed += 1
            t._resolve(RuntimeResponse(
                op="query", status="ok", tier=eff_tier, degraded=degraded,
                payload={"candidates": res.candidates}))
        if self._spans is not None:
            span = BatchSpan(
                self.stats.batches, window, batch[0].picked_at,
                batch[0].started_at, ended,
                [(t.rid, t.admitted_at, t.answered_at) for t in batch],
                st.t_call_start, st.query_spans)
            with self._lock:
                self._spans.append(span)

    def _apply_ingest(self, req: dict) -> RuntimeResponse:
        """Apply one ingest op (caller holds the engine lock — and, for
        grouped runs, the engine's ``ingest_group`` scope). Builds the
        response but does NOT resolve it: inside a group the ack must wait
        for the group's durability barrier. A failed op never reached its
        WAL append (validation precedes mutation), so rejecting it inside a
        group leaves the group's durable record set exactly the applied ops."""
        op = req.get("op")
        try:
            if op == "insert":
                ids = self.engine.insert(
                    req["points"], req["keywords"],
                    attrs=req.get("attrs"), tenant=req.get("tenant"))
                payload = {"ids": [int(i) for i in ids]}
            elif op == "delete":
                payload = {"deleted": self.engine.delete(req["ids"])}
            elif op == "compact":
                payload = {"compacted": self.engine.compact()}
            elif op == "snapshot":
                payload = {"snapshot": self.engine.snapshot()}
            else:
                raise ValueError(f"unknown ingest op {op!r}")
            payload.update(generation=self.engine.corpus_generation,
                           delta_points=self.engine.delta_points,
                           tombstones=self.engine.tombstone_count,
                           compactions=self.engine.ingest.compactions)
        except InjectedCrash:
            raise
        except Exception as e:
            return RuntimeResponse(op=op, status="error",
                                   error=f"{type(e).__name__}: {e}")
        return RuntimeResponse(op=op, status="ok", payload=payload)

    def _exec_ingest_run(self, run: list[Ticket]) -> None:
        """Execute a consecutive ingest run under one WAL group commit.

        Every op in the run appends its WAL record with the fsync deferred;
        the ``ingest_group`` exit issues one barrier covering all of them,
        and only then do the acks fire — fsync-before-ack at run
        granularity. A run of one degrades to exactly the old per-op path
        (``ingest_group`` around a single append syncs once)."""
        resolved: list[tuple[Ticket, RuntimeResponse]] = []
        with self._engine_lock:
            with self.engine.ingest_group():
                for t in run:
                    resolved.append((t, self._apply_ingest(t.request)))
            # the group barrier has returned: every applied op is durable
        if len(run) > 1:
            self.stats.ingest_runs += 1
        for ticket, resp in resolved:
            if resp.ok:
                self.stats.ingest_ops += 1
                self.stats.completed += 1
            else:
                self.stats.errors += 1
            ticket._resolve(resp)
        self._maybe_trigger_compaction()

    # ------------------------------------------------------------- compaction
    def _maybe_trigger_compaction(self) -> None:
        eng = self.engine
        if self._compacting or eng._view is None:
            return
        if eng._view.n_tombstones >= eng._view.n:
            return
        churn = eng.delta_points + eng.tombstone_count
        if churn >= max(eng.compact_min, eng.compact_ratio * eng._bulk.n):
            with self._lock:
                self._compacting = True
            self._compact_req.set()

    def _compactor_loop(self) -> None:
        while True:
            self._compact_req.wait()
            self._compact_req.clear()
            if self._stop:
                return
            try:
                prep = self.engine.compact_prepare()
                with self._engine_lock:
                    self.engine.compact_commit(prep)
                self.stats.bg_compactions += 1
            except InjectedFault:
                # Transient rebuild failure: the old generation is fully
                # intact (nothing swapped); the next churn trigger retries.
                self.stats.bg_compaction_faults += 1
            except InjectedCrash as crash:
                self._die(crash)
                return
            except Exception as e:
                # A real rebuild bug (stale-compaction race, OOM, a
                # build_index defect) must not kill the compactor thread:
                # nothing swapped, the old generation keeps serving, and the
                # next churn trigger retries. Surface it in stats/health so
                # it cannot fail silently.
                self.stats.bg_compaction_errors += 1
                self._last_compaction_error = f"{type(e).__name__}: {e}"
            finally:
                with self._lock:
                    self._compacting = False
                    self._flush_deferred_locked()
                    self._work.notify_all()

    # ------------------------------------------------------------------ death
    def _die(self, crash: InjectedCrash) -> None:
        """Simulated process death: resolve everything as crashed, stop."""
        with self._lock:
            self._crashed = crash
            self._stop = True
            self._work.notify_all()
        self._compact_req.set()
        self._fail_pending("crashed", str(crash))

    def _fail_pending(self, status: str, message: str) -> None:
        with self._lock:
            pending = list(self._queue) + self._deferred
            self._queue.clear()
            self._deferred.clear()
        for t in pending:
            if not t.done():
                self.stats.crashed += 1 if status == "crashed" else 0
                t._resolve(RuntimeResponse(
                    op=t.request.get("op", "query"), status=status,
                    error=message))

    def _fail_batch(self, batch: list[Ticket], message: str) -> None:
        for t in batch:
            self.stats.errors += 1
            t._resolve(RuntimeResponse(op="query", status="error",
                                       error=message))
