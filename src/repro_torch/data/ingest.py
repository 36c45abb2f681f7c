"""Document-to-corpus ingestion: a job-queue worker pipeline feeding the
streaming plane.

The paper's real workloads start from raw documents (Flickr images tagged
with user keywords), not from pre-built ``KeywordDataset`` arrays. This
module is the missing front half: documents enter a persistent
:class:`JobStore`, state-machine workers (:class:`IngestWorker`) pull them
through an extract/embed stage and batch-insert the results into a live
:class:`~repro_torch.serve.engine.NKSEngine` (directly, or through the serving
runtime so pipeline inserts coalesce with launcher ingests).

Job lifecycle (every transition is journaled, fsync'd, and replayable)::

    pending --claim--> claimed --embed--> embedded --intent--> inserted
       ^                  |                  |                    |
       |   (lease expiry / retryable error, attempts < max)      ack
       +------------------+------------------+------------+      |
       |                                                  |      v
       +--[attempts exhausted]--> failed                 done <--+

  * **claim** is lease-based: a worker that dies mid-batch loses its lease
    and the jobs are reclaimed by any live worker (``claim`` lazily releases
    expired leases). Each claim counts one attempt; a job whose attempts
    exhaust ``max_attempts`` lands in terminal ``failed``.
  * **retry** is backoff-scheduled: a released job becomes claimable again
    at ``now + backoff_s * 2^(attempts-1)``.
  * **insert** is exactly-once via a durable *intent*: before touching the
    engine the worker journals an intent carrying the engine's
    ``next_external_id`` horizon (sampled inside the store lock, atomically
    with the fence check), inserts the whole batch as one op inside
    ``NKSEngine.ingest_group()`` (one WAL fsync barrier for the batch), and
    acks only after the barrier. The open intent doubles as the insert
    mutex — at most one batch is ever in flight, so recovery can decide
    "did the batch land?" by comparing the recovered engine's external-id
    horizon against the intent: covered => ack without re-inserting
    (exactly-once above the ack horizon); not covered => the jobs revert to
    ``pending`` and are re-embedded/re-inserted (at-least-once below it).
    The embedder is deterministic, so a re-run produces bit-identical
    points.

Crash sites (``serve.faults`` points, armed by the fault suite):
``claim`` / ``embed`` / ``insert`` / ``ack`` — one per state-machine window,
each exercising a different recovery path above.

Determinism: the clock is injectable (leases, backoff), workers expose a
single-cycle :meth:`IngestWorker.step`, and the default
:class:`ProjectionEmbedder` is a pure function of the document payload —
the test suite drives arbitrary interleavings of worker progress and
crashes and asserts the final corpus is permutation-identical to a no-fault
build over the same documents.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.types import KeywordDataset, make_dataset, merge_tenants
from repro_torch.serve.faults import NO_FAULTS, FaultPlan, InjectedCrash

# ------------------------------------------------------------------ documents

#: Job states (the journal speaks these strings; keep them stable).
PENDING = "pending"
CLAIMED = "claimed"
EMBEDDED = "embedded"
INSERTED = "inserted"
DONE = "done"
FAILED = "failed"

_TERMINAL = (DONE, FAILED)
_LEGAL = {
    (PENDING, CLAIMED),
    (CLAIMED, EMBEDDED),
    (EMBEDDED, INSERTED),
    (INSERTED, DONE),
    # retry / lease-reclaim paths back to pending:
    (CLAIMED, PENDING), (EMBEDDED, PENDING), (INSERTED, PENDING),
    # attempt exhaustion from any in-flight state:
    (CLAIMED, FAILED), (EMBEDDED, FAILED), (INSERTED, FAILED),
}


class InvalidTransition(RuntimeError):
    """An illegal job state transition (or wrong-owner mutation)."""


class LeaseLost(InvalidTransition):
    """The worker's lease on a job was reclaimed — its staged work is void."""


class IntentBusy(RuntimeError):
    """Another batch's insert intent is open (the insert stage is a
    lease-guarded mutex: one batch in flight at a time)."""

    def __init__(self, intent_id: int, expired: bool):
        super().__init__(f"intent {intent_id} open "
                         f"({'expired' if expired else 'live'})")
        self.intent_id = intent_id
        self.expired = expired


class SinkIndeterminate(RuntimeError):
    """The sink cannot say whether the batch landed (the runtime crashed
    mid-run, or its ticket never reached a terminal status). The worker must
    NOT resolve the intent from the current horizon — the op may still land
    later, and releasing the jobs now would retry a batch that also lands,
    duplicating it. Leave the intent open; lease expiry (or
    ``IngestPipeline.recover`` after a restart) reconciles from a horizon
    that post-dates the op's last possible execution instant."""


def flickr_like_documents(n: int, d_raw: int = 32, u: int = 30, t: int = 3, *,
                          n_clusters: int = 12, zipf_a: float = 1.3,
                          affinity: float = 0.7, seed: int = 0,
                          tenants: Sequence[str] | None = None,
                          with_attrs: bool = True
                          ) -> tuple[list[dict], list[str]]:
    """Raw documents with ``flickr_like`` statistics, plus the tag vocabulary.

    Each document is a JSON-serializable dict — the form the :class:`JobStore`
    journals — carrying a raw feature payload (``d_raw``-dim histogram, drawn
    from a Gaussian mixture), ``t``-ish Zipf-popular tag *strings* with
    cluster affinity, optional ``attrs`` (price/category) and an optional
    ``tenant``. The embedder projects payloads down to index points and maps
    tags through the returned vocabulary, so a corpus built from these
    documents has the same shape as :func:`flickr_like_dataset`.
    """
    rng = np.random.default_rng(seed)
    vocab = [f"tag{i:03d}" for i in range(u)]
    centers = rng.uniform(0.0, 255.0, size=(n_clusters, d_raw))
    scales = rng.uniform(4.0, 24.0, size=(n_clusters, 1))
    assign = rng.integers(0, n_clusters, size=n)
    payloads = centers[assign] + rng.standard_normal((n, d_raw)) * scales[assign]

    ranks = np.arange(1, u + 1, dtype=np.float64)
    pop = ranks ** (-zipf_a)
    pop /= pop.sum()
    pool_size = max(t * 4, 16)
    pools = np.stack([rng.choice(u, size=pool_size, replace=False, p=pop)
                      for _ in range(n_clusters)])

    docs = []
    for i in range(n):
        n_aff = int(round(t * affinity))
        pool = pools[assign[i]]
        aff = rng.choice(pool, size=min(n_aff, len(pool)), replace=False)
        glob = rng.choice(u, size=t - len(aff), replace=True, p=pop)
        tags = sorted({vocab[v] for v in np.concatenate([aff, glob])})
        doc = {
            "doc_id": f"doc-{i:06d}",
            "payload": np.asarray(payloads[i], np.float32).tolist(),
            "tags": tags,
        }
        if with_attrs:
            doc["attrs"] = {
                "price": float(rng.uniform(0.0, 100.0)),
                "category": int(rng.integers(0, 8)),
            }
        if tenants:
            doc["tenant"] = str(tenants[int(rng.integers(0, len(tenants)))])
        docs.append(doc)
    return docs, vocab


@dataclasses.dataclass(frozen=True)
class IngestRecord:
    """One embedded document: what the insert stage commits to the engine.
    ``keywords`` are vocabulary (tenant-*local* on a namespaced corpus) ids —
    the sink resolves them to global dictionary slots, same convention as
    ``launch/serve.py`` inserts."""

    doc_id: str
    point: np.ndarray
    keywords: list[int]
    attrs: dict | None
    tenant: str | None


class ProjectionEmbedder:
    """Deterministic extract/embed stage: a fixed seeded random projection of
    the raw payload plus a tag-string -> vocabulary-id lookup.

    Determinism is a pipeline correctness requirement, not a convenience: a
    job reclaimed after a worker crash is re-embedded from its document, and
    the exactly-once story needs that re-run to produce bit-identical
    points. ``extract`` is a pure function of the document.
    """

    def __init__(self, d_out: int, vocab: Sequence[str], *, d_raw: int,
                 seed: int = 0):
        self.d_out = int(d_out)
        self.d_raw = int(d_raw)
        self.vocab = {tag: i for i, tag in enumerate(vocab)}
        rng = np.random.default_rng(seed)
        self._w = (rng.standard_normal((self.d_raw, self.d_out))
                   / np.sqrt(self.d_raw)).astype(np.float32)

    def _point(self, payload: np.ndarray) -> np.ndarray:
        return payload @ self._w

    def extract(self, doc: dict) -> IngestRecord:
        payload = np.asarray(doc["payload"], dtype=np.float32)
        if payload.shape != (self.d_raw,):
            raise ValueError(f"payload must be ({self.d_raw},), "
                             f"got {payload.shape}")
        tags = doc.get("tags") or ()
        try:
            kws = sorted({self.vocab[tag] for tag in tags})
        except KeyError as e:
            raise ValueError(f"unknown tag {e.args[0]!r} in "
                             f"{doc.get('doc_id')!r}") from None
        if not kws:
            raise ValueError(f"document {doc.get('doc_id')!r} has no tags")
        return IngestRecord(doc_id=str(doc["doc_id"]),
                            point=self._point(payload),
                            keywords=kws, attrs=doc.get("attrs"),
                            tenant=doc.get("tenant"))


class ModelEmbedder(ProjectionEmbedder):
    """Model-backed embed stage: payloads run through an ``embed_fn``
    ((B, d_raw) -> (B, d_out) features — e.g. a partial over
    ``repro_torch.models.api.model_api(cfg).embed`` with trained params)
    instead of the fixed projection. The tag/attrs/tenant handling is
    inherited. The callable must be deterministic for the recovery story to
    hold: on the card that means one batch shape every call (``extract``
    embeds one document at a time) and no kernel whose result depends on
    scheduling. It runs on the pipeline's worker threads, and
    ``torch.inference_mode`` is per thread: an ``embed_fn`` over a model
    enters it itself."""

    def __init__(self, embed_fn: Callable[[np.ndarray], np.ndarray],
                 d_out: int, vocab: Sequence[str], *, d_raw: int):
        super().__init__(d_out, vocab, d_raw=d_raw)
        self._embed_fn = embed_fn

    def _point(self, payload: np.ndarray) -> np.ndarray:
        out = np.asarray(self._embed_fn(payload[None, :]), np.float32)[0]
        if out.shape != (self.d_out,):
            raise ValueError(f"embed_fn returned {out.shape}, "
                             f"expected ({self.d_out},)")
        return out


def corpus_from_documents(docs: Sequence[dict], embedder
                          ) -> tuple[KeywordDataset, list[str]]:
    """Build a frozen corpus from documents — the *static reference* the
    pipeline's end-to-end differential compares against.

    Returns ``(dataset, doc_ids)`` with ``doc_ids[i]`` naming row ``i``.
    Tenant-tagged documents pack through ``merge_tenants`` (sorted tenant
    order, so the namespace layout is deterministic); row order is then
    by-tenant, not document order — which is why differentials compare
    doc-id-canonicalized answer sets, never raw external ids.
    """
    recs = [embedder.extract(d) for d in docs]
    u = len(embedder.vocab)
    if any(r.tenant is not None for r in recs):
        if not all(r.tenant is not None for r in recs):
            raise ValueError("mixed tenant-tagged and untagged documents")
        corpora: dict[str, dict] = {}
        order: list[str] = []
        for name in sorted({r.tenant for r in recs}):
            sub = [r for r in recs if r.tenant == name]
            order.extend(r.doc_id for r in sub)
            corpora[name] = {
                "points": np.stack([r.point for r in sub]),
                "keywords": [r.keywords for r in sub],
                "n_keywords": u,
                "attrs": _attr_columns(sub),
            }
        return merge_tenants(corpora), order
    ds = make_dataset(np.stack([r.point for r in recs]),
                      [r.keywords for r in recs], n_keywords=u,
                      attrs=_attr_columns(recs))
    return ds, [r.doc_id for r in recs]


def _attr_columns(recs: Sequence[IngestRecord]) -> dict | None:
    """Per-record attrs dicts -> columnar arrays (None when unattributed)."""
    if recs[0].attrs is None:
        if any(r.attrs is not None for r in recs):
            raise ValueError("mixed attributed and unattributed documents")
        return None
    names = sorted(recs[0].attrs)
    return {name: np.asarray([r.attrs[name] for r in recs])
            for name in names}


# ------------------------------------------------------------------ job store
@dataclasses.dataclass
class Job:
    """One document's journey through the pipeline. Mutated only by the
    owning :class:`JobStore` — treat instances handed out by ``claim`` as
    read-only snapshots."""

    job_id: int
    doc: dict
    state: str = PENDING
    attempts: int = 0
    not_before: float = 0.0
    lease_until: float = 0.0
    worker: str | None = None
    error: str | None = None
    ext_id: int | None = None


@dataclasses.dataclass
class Intent:
    """A durable insert intent: the batch's jobs plus the engine external-id
    horizon recorded *before* the insert ran. Recovery compares the horizon
    against the recovered engine to decide applied-vs-reverted."""

    intent_id: int
    worker: str
    job_ids: list[int]
    first_ext: int
    lease_until: float

    @property
    def count(self) -> int:
        return len(self.job_ids)


@dataclasses.dataclass
class StoreStats:
    """Lifetime counters (rebuilt from the journal on open)."""

    added: int = 0
    claims: int = 0          # claim batches handed out
    claimed_jobs: int = 0
    reclaims: int = 0        # jobs yanked off an expired lease
    retries: int = 0         # jobs released back to pending (any reason)
    exhausted: int = 0       # jobs that hit terminal failed
    intents: int = 0
    acked_jobs: int = 0


class JobStore:
    """Persistent job queue: an append-only JSONL journal of state
    transitions, replayed on open. Thread-safe; the clock is injectable so
    the test suite owns lease expiry and backoff deterministically.

    Durability: with ``sync=True`` (default) every journal append is
    fsync'd before the call returns — the ``intent`` record in particular
    must hit disk before the engine insert it fences. A torn tail (crash
    mid-append) is truncated on open, mirroring the engine WAL's recovery
    contract.
    """

    def __init__(self, path: str, *, lease_s: float = 30.0,
                 max_attempts: int = 5, backoff_s: float = 0.05,
                 sync: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.path = str(path)
        self.lease_s = float(lease_s)
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self._sync = bool(sync)
        self.clock = clock
        self.jobs: dict[int, Job] = {}
        self.stats = StoreStats()
        self._intent: Intent | None = None
        self._next_job = 0
        self._next_intent = 0
        self._lock = threading.RLock()
        self._replay()
        self._f = open(self.path, "ab")

    # ------------------------------------------------------------- journal
    def _replay(self) -> None:
        if not os.path.exists(self.path):
            return
        good = 0
        with open(self.path, "rb") as f:
            blob = f.read()
        # Only newline-terminated lines are candidates: a record's append is
        # one write of json+"\n", so a tail without its newline is torn even
        # if the JSON happens to parse.
        for line in blob.split(b"\n")[:-1]:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break               # torn tail: crash mid-append
            self._apply(rec)
            good += len(line) + 1
        if good < len(blob):
            with open(self.path, "rb+") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())

    def _apply(self, rec: dict) -> None:
        """Re-apply one journaled transition (already validated when it was
        written — replay trusts the history)."""
        t = rec["t"]
        if t == "add":
            jid = int(rec["id"])
            self.jobs[jid] = Job(job_id=jid, doc=rec["doc"],
                                 not_before=float(rec.get("not_before", 0.0)))
            self._next_job = max(self._next_job, jid + 1)
            self.stats.added += 1
        elif t == "claim":
            for jid in rec["ids"]:
                j = self.jobs[jid]
                j.state, j.worker = CLAIMED, rec["worker"]
                j.attempts += 1
                j.lease_until = float(rec["lease_until"])
            self.stats.claims += 1
            self.stats.claimed_jobs += len(rec["ids"])
        elif t == "embed":
            for jid in rec["ids"]:
                j = self.jobs[jid]
                j.state = EMBEDDED
                j.lease_until = float(rec["lease_until"])
        elif t == "release":
            for entry in rec["retry"]:
                # per-job [jid, not_before] pairs; bare ids (legacy records)
                # fall back to the record-level value
                jid, nb = entry if isinstance(entry, list) \
                    else (entry, rec["not_before"])
                j = self.jobs[jid]
                j.state, j.worker = PENDING, None
                j.not_before = float(nb)
                j.error = rec.get("error")
            for jid in rec["failed"]:
                j = self.jobs[jid]
                j.state, j.worker = FAILED, None
                j.error = rec.get("error")
            if rec.get("reason") == "lease":
                self.stats.reclaims += len(rec["retry"]) + len(rec["failed"])
            self.stats.retries += len(rec["retry"])
            self.stats.exhausted += len(rec["failed"])
        elif t == "intent":
            iid = int(rec["intent"])
            self._intent = Intent(intent_id=iid, worker=rec["worker"],
                                  job_ids=[int(i) for i in rec["ids"]],
                                  first_ext=int(rec["first_ext"]),
                                  lease_until=float(rec["lease_until"]))
            for jid in self._intent.job_ids:
                j = self.jobs[jid]
                j.state = INSERTED
                j.lease_until = self._intent.lease_until
            self._next_intent = max(self._next_intent, iid + 1)
            self.stats.intents += 1
        elif t == "ack":
            it = self._intent
            for jid, ext in zip(it.job_ids, rec["ext"]):
                j = self.jobs[jid]
                j.state, j.worker, j.ext_id = DONE, None, int(ext)
            self.stats.acked_jobs += len(it.job_ids)
            self._intent = None
        else:
            raise IOError(f"unknown journal record type {t!r}")

    def _log(self, rec: dict) -> None:
        self._f.write(json.dumps(rec).encode() + b"\n")
        self._f.flush()
        if self._sync:
            os.fsync(self._f.fileno())

    # ------------------------------------------------------------ lifecycle
    def _transition(self, job: Job, new: str) -> None:
        if (job.state, new) not in _LEGAL:
            raise InvalidTransition(
                f"job {job.job_id}: illegal transition "
                f"{job.state!r} -> {new!r}")
        job.state = new

    def _owned(self, worker: str, job_ids: Sequence[int],
               states: tuple) -> list[Job]:
        out = []
        for jid in job_ids:
            j = self.jobs[int(jid)]
            if j.worker != worker or j.state not in states:
                raise LeaseLost(
                    f"job {j.job_id}: owned by {j.worker!r} in state "
                    f"{j.state!r}, not by {worker!r} in {states}")
            out.append(j)
        return out

    def add(self, docs: Sequence[dict], *,
            not_before: Sequence[float] | None = None) -> list[int]:
        """Enqueue documents; returns their job ids. Durable on return.
        ``not_before`` (clock timestamps, one per doc) schedules arrivals —
        a job is invisible to ``claim`` until its instant passes, which lets
        a bench materialise a Poisson arrival process up front."""
        with self._lock:
            ids = []
            for i, doc in enumerate(docs):
                jid = self._next_job
                self._next_job += 1
                nb = float(not_before[i]) if not_before is not None else 0.0
                self.jobs[jid] = Job(job_id=jid, doc=doc, not_before=nb)
                rec = {"t": "add", "id": jid, "doc": doc}
                if nb:
                    rec["not_before"] = nb
                self._f.write(json.dumps(rec).encode() + b"\n")
                ids.append(jid)
                self.stats.added += 1
            self._f.flush()
            if self._sync:
                os.fsync(self._f.fileno())
            return ids

    def _reap_expired(self, now: float) -> None:
        """Release every expired lease (the dead-worker reclaim path)."""
        expired = [j for j in self.jobs.values()
                   if j.state in (CLAIMED, EMBEDDED) and j.lease_until <= now]
        if expired:
            self._release_jobs(expired, error="lease expired", reason="lease",
                              now=now, immediate=True)

    def claim(self, worker: str, limit: int = 16) -> list[Job]:
        """Claim up to ``limit`` ready jobs under a fresh lease. Reclaims
        expired leases first, so a dead worker's jobs re-enter circulation
        on the next live claim."""
        with self._lock:
            now = self.clock()
            self._reap_expired(now)
            ready = sorted(
                (j for j in self.jobs.values()
                 if j.state == PENDING and j.not_before <= now),
                key=lambda j: j.job_id)[:max(int(limit), 0)]
            if not ready:
                return []
            lease_until = now + self.lease_s
            for j in ready:
                self._transition(j, CLAIMED)
                j.worker = worker
                j.attempts += 1
                j.lease_until = lease_until
            self._log({"t": "claim", "ids": [j.job_id for j in ready],
                       "worker": worker, "lease_until": lease_until})
            self.stats.claims += 1
            self.stats.claimed_jobs += len(ready)
            return ready

    def mark_embedded(self, worker: str, job_ids: Sequence[int]) -> None:
        """claimed -> embedded (owner-checked); renews the lease."""
        with self._lock:
            jobs = self._owned(worker, job_ids, (CLAIMED,))
            lease_until = self.clock() + self.lease_s
            for j in jobs:
                self._transition(j, EMBEDDED)
                j.lease_until = lease_until
            self._log({"t": "embed", "ids": [j.job_id for j in jobs],
                       "lease_until": lease_until})

    def release(self, worker: str, job_ids: Sequence[int], *,
                error: str) -> None:
        """Give up owned jobs after a retryable failure: back to ``pending``
        at the backoff schedule, or terminal ``failed`` once attempts are
        exhausted."""
        with self._lock:
            jobs = self._owned(worker, job_ids, (CLAIMED, EMBEDDED))
            self._release_jobs(jobs, error=error, reason="error",
                              now=self.clock())

    def _release_jobs(self, jobs: list[Job], *, error: str, reason: str,
                      now: float, immediate: bool = False) -> None:
        retry, failed = [], []
        for j in jobs:
            if j.attempts >= self.max_attempts:
                self._transition(j, FAILED)
                j.error = f"{error} (attempts exhausted: {j.attempts})"
                j.worker = None
                failed.append(j.job_id)
            else:
                self._transition(j, PENDING)
                j.worker = None
                j.error = error
                j.not_before = now if immediate else \
                    now + self.backoff_s * (2.0 ** max(j.attempts - 1, 0))
                retry.append(j.job_id)
        self._log({"t": "release",
                   "retry": [[i, self.jobs[i].not_before] for i in retry],
                   "failed": failed, "error": error, "reason": reason})
        if reason == "lease":
            self.stats.reclaims += len(jobs)
        self.stats.retries += len(retry)
        self.stats.exhausted += len(failed)

    # ---------------------------------------------------------- insert fence
    def open_intent(self) -> Intent | None:
        with self._lock:
            return self._intent

    def record_intent(self, worker: str, job_ids: Sequence[int], *,
                      horizon) -> int:
        """embedded -> inserted, fenced: raises :class:`IntentBusy` while
        another intent is open (live or expired — an expired one must be
        explicitly resolved via ack/release first, because resolving it
        needs the *engine's* id horizon, which the store cannot see).

        ``horizon`` is the engine's ``next_external_id`` — pass the sink
        (anything with a ``next_external_id`` property) or a callable, NOT a
        pre-read integer: the value is sampled *inside* the store lock,
        after the fence check, so no other batch can complete an
        intent->insert->ack cycle between the read and the fence. A stale
        pre-read horizon would let reconciliation mistake the other batch's
        ids for this one's and ack a batch that never landed. (A plain int
        is still accepted for single-threaded unit tests.)"""
        with self._lock:
            if self._intent is not None:
                raise IntentBusy(self._intent.intent_id,
                                 self._intent.lease_until <= self.clock())
            jobs = self._owned(worker, job_ids, (EMBEDDED,))
            if hasattr(horizon, "next_external_id"):
                first_ext = int(horizon.next_external_id)
            elif callable(horizon):
                first_ext = int(horizon())
            else:
                first_ext = int(horizon)
            iid = self._next_intent
            self._next_intent += 1
            lease_until = self.clock() + self.lease_s
            for j in jobs:
                self._transition(j, INSERTED)
                j.lease_until = lease_until
            self._intent = Intent(intent_id=iid, worker=worker,
                                  job_ids=[j.job_id for j in jobs],
                                  first_ext=int(first_ext),
                                  lease_until=lease_until)
            self._log({"t": "intent", "intent": iid,
                       "ids": self._intent.job_ids, "worker": worker,
                       "first_ext": int(first_ext),
                       "lease_until": lease_until})
            self.stats.intents += 1
            return iid

    def _take_intent(self, intent_id: int) -> Intent:
        if self._intent is None or self._intent.intent_id != int(intent_id):
            raise InvalidTransition(
                f"intent {intent_id} is not the open intent "
                f"({self._intent.intent_id if self._intent else None})")
        return self._intent

    def ack_intent(self, intent_id: int, ext_ids: Sequence[int]) -> None:
        """inserted -> done: the batch is durably in the engine (the caller
        observed the WAL barrier, or reconciliation proved the horizon)."""
        with self._lock:
            it = self._take_intent(intent_id)
            if len(ext_ids) != it.count:
                raise InvalidTransition(
                    f"intent {intent_id}: {len(ext_ids)} ext ids for "
                    f"{it.count} jobs")
            for jid, ext in zip(it.job_ids, ext_ids):
                j = self.jobs[jid]
                self._transition(j, DONE)
                j.worker, j.ext_id = None, int(ext)
            self._log({"t": "ack", "intent": intent_id,
                       "ext": [int(e) for e in ext_ids]})
            self.stats.acked_jobs += it.count
            self._intent = None

    def release_intent(self, intent_id: int, *, error: str) -> None:
        """inserted -> pending/failed: the batch provably did NOT land."""
        with self._lock:
            it = self._take_intent(intent_id)
            self._intent = None
            self._release_jobs([self.jobs[i] for i in it.job_ids],
                              error=error, reason="error", now=self.clock())

    # ------------------------------------------------------------- inspection
    def counts(self) -> dict[str, int]:
        out = {s: 0 for s in (PENDING, CLAIMED, EMBEDDED, INSERTED, DONE,
                              FAILED)}
        with self._lock:
            for j in self.jobs.values():
                out[j.state] += 1
        return out

    def drained(self) -> bool:
        with self._lock:
            return all(j.state in _TERMINAL for j in self.jobs.values())

    def next_ready_at(self) -> float | None:
        """Earliest instant any non-terminal job becomes claimable (lease
        expiry or backoff), or None when drained — what a poll loop should
        sleep toward."""
        with self._lock:
            times = [j.not_before if j.state == PENDING else j.lease_until
                     for j in self.jobs.values() if j.state not in _TERMINAL]
            if self._intent is not None:
                times.append(self._intent.lease_until)
            return min(times) if times else None

    def ext_map(self) -> dict[int, str]:
        """external id -> doc_id over completed jobs (the differential's
        id-translation table)."""
        with self._lock:
            return {j.ext_id: str(j.doc["doc_id"])
                    for j in self.jobs.values() if j.state == DONE}

    def close(self) -> None:
        self._f.close()


# -------------------------------------------------------------------- sinks
class EngineSink:
    """Direct engine target: each batch is one atomic ``insert`` inside an
    ``ingest_group()`` scope — one WAL fsync barrier per batch, ack only
    after the barrier (``insert`` returns post-sync)."""

    def __init__(self, engine):
        self.engine = engine

    @property
    def next_external_id(self) -> int:
        return self.engine.next_external_id

    @property
    def dataset(self):
        return self.engine.dataset

    def insert(self, points, keywords, attrs, tenant) -> list[int]:
        with self.engine.ingest_group():
            ext = self.engine.insert(points, keywords, attrs=attrs,
                                     tenant=tenant)
        return [int(e) for e in ext]


class RuntimeSink:
    """Serving-runtime target: batches ride the admission queue as insert
    ops, so pipeline ingest coalesces with launcher ingests into shared WAL
    group commits (the runtime acks only after the run's barrier).

    ``insert`` never abandons an op that could still execute: the op is
    submitted with ``timeout_s`` as its admission deadline and the ticket is
    awaited to a *terminal* status (executed, expired-before-dispatch,
    rejected, or crashed). Giving up on a still-queued op would break
    exactly-once — the worker would reconcile against an unmoved horizon,
    release the intent and retry, and then the original op would land too,
    inserting the batch twice. Terminal non-ok statuses split two ways:
    ``timeout``/``rejected``/``error`` mean the op provably never mutated
    the engine (a plain raise — the worker's reconcile path reverts and
    retries), while ``crashed`` (or a ticket the runtime never resolved
    within the grace window) raises :class:`SinkIndeterminate` — the op's
    durability is unknowable here, so the intent must stay open."""

    def __init__(self, runtime, *, timeout_s: float = 30.0,
                 grace_s: float = 30.0):
        self.runtime = runtime
        self.timeout_s = float(timeout_s)
        self.grace_s = float(grace_s)

    @property
    def next_external_id(self) -> int:
        return self.runtime.engine.next_external_id

    @property
    def dataset(self):
        return self.runtime.engine.dataset

    def insert(self, points, keywords, attrs, tenant) -> list[int]:
        ticket = self.runtime.submit({"op": "insert", "points": points,
                                      "keywords": keywords, "attrs": attrs,
                                      "tenant": tenant},
                                     deadline_s=self.timeout_s)
        # The admission deadline bounds the queued wait (the runtime expires
        # an undispatched op with status "timeout"), so a terminal status
        # normally arrives within timeout_s plus one dispatch. The grace
        # backstop only trips on a wedged runtime — and then the op's fate
        # is genuinely unknowable, which is exactly what SinkIndeterminate
        # tells the worker.
        try:
            resp = ticket.result(timeout=self.timeout_s + self.grace_s)
        except TimeoutError:
            raise SinkIndeterminate(
                f"insert ticket unresolved after "
                f"{self.timeout_s + self.grace_s:.1f}s") from None
        if resp.status == "crashed":
            raise SinkIndeterminate(f"runtime crashed mid-run: {resp.error}")
        if resp.status != "ok":
            raise RuntimeError(f"runtime insert {resp.status}: {resp.error}")
        return [int(i) for i in resp.payload["ids"]]


def _as_sink(target):
    if isinstance(target, (EngineSink, RuntimeSink)):
        return target
    if hasattr(target, "submit"):
        return RuntimeSink(target)
    return EngineSink(target)


def reconcile_intent(store: JobStore, sink, intent: Intent, *,
                     error: str) -> str:
    """Resolve an open intent against the engine's external-id horizon.

    The intent fence guarantees at most one insert was in flight, and the
    engine assigns external ids strictly sequentially — so the recovered
    horizon either never moved past ``first_ext`` (the batch missed the WAL:
    release for retry) or covers the whole batch (it landed: ack with the
    sequential ids, without re-inserting). Returns ``"applied"`` or
    ``"reverted"``.
    """
    if sink.next_external_id >= intent.first_ext + intent.count:
        store.ack_intent(intent.intent_id,
                         list(range(intent.first_ext,
                                    intent.first_ext + intent.count)))
        return "applied"
    store.release_intent(intent.intent_id, error=error)
    return "reverted"


# ------------------------------------------------------------------- workers
@dataclasses.dataclass
class WorkerStats:
    steps: int = 0
    batches_inserted: int = 0
    docs_inserted: int = 0
    embed_failures: int = 0
    transient_faults: int = 0
    sink_indeterminate: int = 0
    intent_busy: int = 0
    lease_lost: int = 0
    reconciled_applied: int = 0
    reconciled_reverted: int = 0


class IngestWorker:
    """One claim -> embed -> insert -> ack cycle per :meth:`step`.

    ``step`` returns False when no work was available (the caller decides
    whether to sleep or advance a fake clock). An :class:`InjectedCrash`
    from any fault point propagates — the worker is "dead" and must not
    clean up (no lease release, no intent resolution); the lease/intent
    expiry machinery recovers its work, exactly as it would for a worker
    *process* killed mid-batch.
    """

    def __init__(self, name: str, store: JobStore, target, embedder, *,
                 batch_docs: int = 16, faults: FaultPlan = NO_FAULTS,
                 clock: Callable[[], float] | None = None):
        self.name = str(name)
        self.store = store
        self.sink = _as_sink(target)
        self.embedder = embedder
        self.batch_docs = int(batch_docs)
        self.faults = faults
        self.clock = clock if clock is not None else store.clock
        self.stats = WorkerStats()
        self._staged: "list[tuple[Job, IngestRecord]] | None" = None

    def step(self) -> bool:
        """Run one unit of work; returns whether any progress was made.
        ``False`` also covers "waiting on another batch's insert fence" —
        callers should treat it as idle (sleep, or advance a fake clock so
        a dead fence-holder's lease can expire)."""
        self.stats.steps += 1
        if self._staged is None and not self._claim_and_embed():
            return self._reconcile_expired_intent()
        if self._staged is None:
            return True                 # progressed without staging a batch
        return self._insert_staged()

    def _reconcile_expired_intent(self) -> bool:
        """With nothing claimable and nothing staged, an *expired* open
        intent may still need resolving — a dead fence-holder's, or this
        worker's own after a :class:`SinkIndeterminate` on the final batch.
        Without this the store could never drain: the intent's jobs are
        neither terminal nor claimable."""
        it = self.store.open_intent()
        if it is None or it.lease_until > self.clock():
            return False
        try:
            outcome = reconcile_intent(self.store, self.sink, it,
                                       error="intent lease expired")
        except InvalidTransition:
            return True                 # another worker resolved it first
        if outcome == "applied":
            self.stats.reconciled_applied += 1
        else:
            self.stats.reconciled_reverted += 1
        return True

    def _claim_and_embed(self) -> bool:
        jobs = self.store.claim(self.name, limit=self.batch_docs)
        if not jobs:
            return False
        try:
            # Crash site "claim": the batch is leased, nothing embedded —
            # death here is recovered purely by lease expiry.
            self.faults.check("claim")
            staged, bad = [], []
            for j in jobs:
                try:
                    staged.append((j, self.embedder.extract(j.doc)))
                except InjectedCrash:
                    raise
                except Exception as e:
                    bad.append((j, f"{type(e).__name__}: {e}"))
            # Crash site "embed": records exist in worker memory only; the
            # journal still says "claimed" — recovery re-embeds after the
            # lease expires (deterministic embedder => identical records).
            self.faults.check("embed")
        except InjectedCrash:
            raise
        except Exception as e:          # transient (InjectedFault et al.)
            self.stats.transient_faults += 1
            self._release_quietly([j.job_id for j in jobs],
                                  f"{type(e).__name__}: {e}")
            return True
        if bad:
            self.stats.embed_failures += len(bad)
            self._release_quietly([j.job_id for j, _ in bad],
                                  "; ".join(err for _, err in bad))
        if not staged:
            return True
        try:
            self.store.mark_embedded(self.name, [j.job_id for j, _ in staged])
        except LeaseLost:
            self.stats.lease_lost += 1
            return True
        self._staged = staged
        return True

    def _release_quietly(self, job_ids: list[int], error: str) -> None:
        try:
            self.store.release(self.name, job_ids, error=error)
        except LeaseLost:
            self.stats.lease_lost += 1

    def _insert_staged(self) -> bool:
        jobs = [j for j, _ in self._staged]
        recs = [r for _, r in self._staged]
        store = self.store
        it = store.open_intent()
        if it is not None:
            if it.lease_until > self.clock():
                # A live batch holds the insert fence; keep ours staged and
                # report idle — if the holder is dead, its lease must be
                # allowed to expire before anyone can move.
                self.stats.intent_busy += 1
                return False
            outcome = reconcile_intent(store, self.sink, it,
                                       error="intent lease expired")
            if outcome == "applied":
                self.stats.reconciled_applied += 1
            else:
                self.stats.reconciled_reverted += 1
        try:
            # The horizon is sampled by the store inside its lock, after the
            # fence check — atomic with the intent, so another batch's full
            # intent->insert->ack cycle cannot slip between read and fence.
            intent = store.record_intent(
                self.name, [j.job_id for j in jobs], horizon=self.sink)
        except IntentBusy:              # lost the fence race; stay staged
            self.stats.intent_busy += 1
            return False
        except LeaseLost:
            self.stats.lease_lost += 1
            self._staged = None
            return True
        try:
            # Crash site "insert": the intent is durable, the engine was
            # never touched — recovery reverts the intent (horizon short).
            self.faults.check("insert")
            ext = self.sink.insert(*self._assemble(recs))
            # Crash site "ack": the batch is past its WAL barrier but the
            # job store never heard — recovery acks from the horizon
            # without re-inserting (exactly-once above the barrier).
            self.faults.check("ack")
        except InjectedCrash:
            raise                       # dead worker: leave the intent open
        except SinkIndeterminate:
            # The sink lost track of the batch (runtime crashed mid-run, or
            # its ticket never went terminal). Reconciling now against the
            # current horizon could release a batch that still lands —
            # duplicating it — so behave like a dead worker: leave the
            # intent open and let lease expiry (or pipeline recovery)
            # reconcile once the op can no longer be in flight.
            self.stats.sink_indeterminate += 1
            self._staged = None
            return True
        except Exception as e:
            # Transient failure somewhere around the insert: decide from
            # the horizon whether it actually landed, exactly like a
            # post-crash recovery would.
            self.stats.transient_faults += 1
            outcome = reconcile_intent(store, self.sink, store.open_intent(),
                                       error=f"{type(e).__name__}: {e}")
            if outcome == "applied":
                self.stats.reconciled_applied += 1
            else:
                self.stats.reconciled_reverted += 1
            self._staged = None
            return True
        store.ack_intent(intent, ext)
        self._staged = None
        self.stats.batches_inserted += 1
        self.stats.docs_inserted += len(jobs)
        return True

    def _assemble(self, recs: list[IngestRecord]):
        """Records -> one engine batch (points, global keywords, attr
        columns, tenant ids). Tenant-local keywords resolve through the
        corpus namespace, per-point — mixed-tenant batches are fine."""
        ds = self.sink.dataset
        points = np.stack([r.point for r in recs]).astype(np.float32)
        ns = ds.tenants
        if ns is not None:
            keywords = [ns.resolve(r.tenant, r.keywords) for r in recs]
            tenant = np.asarray([ns.id_of(r.tenant) for r in recs],
                                dtype=np.int32)
        else:
            keywords = [r.keywords for r in recs]
            tenant = None
        attrs = _attr_columns(recs) if ds.attrs else None
        return points, keywords, attrs, tenant


# ------------------------------------------------------------------ pipeline
class IngestPipeline:
    """Orchestrates N workers over one store and one sink.

    ``target`` is an :class:`~repro_torch.serve.engine.NKSEngine` (direct,
    one WAL group commit per batch) or a
    :class:`~repro_torch.serve.runtime.ServingRuntime` (batches ride the
    admission queue and coalesce with other ingest). Call :meth:`recover`
    once before starting workers when reopening a store after process
    death; then either drive ``pipeline.workers[i].step()`` manually
    (deterministic tests) or :meth:`run` the thread-per-worker loop.
    """

    def __init__(self, store: JobStore, target, embedder, *,
                 workers: int = 2, batch_docs: int = 16,
                 faults: FaultPlan = NO_FAULTS,
                 poll_s: float = 0.002):
        self.store = store
        self.sink = _as_sink(target)
        self.embedder = embedder
        self.poll_s = float(poll_s)
        self.workers = [
            IngestWorker(f"w{i}", store, self.sink, embedder,
                         batch_docs=batch_docs, faults=faults)
            for i in range(int(workers))]
        self.dead: list[str] = []
        self._stop = False

    def recover(self) -> str | None:
        """Startup reconciliation: resolve the open intent left by a dead
        *process* (lease ignored — nothing can still be in flight). Returns
        ``"applied"``, ``"reverted"``, or None when the store is clean.
        Must run before any worker starts."""
        it = self.store.open_intent()
        if it is None:
            return None
        return reconcile_intent(self.store, self.sink, it,
                                error="recovered open intent")

    def _worker_loop(self, worker: IngestWorker, done: threading.Event
                     ) -> None:
        try:
            while not self._stop:
                if self.store.drained():
                    return
                try:
                    progressed = worker.step()
                except InjectedCrash:
                    self.dead.append(worker.name)
                    return
                if not progressed:
                    time.sleep(self.poll_s)
        finally:
            done.set()

    def run(self, *, timeout_s: float = 60.0) -> dict:
        """Thread-per-worker drain loop. Returns a report; ``drained`` is
        False when the store still holds live jobs at the deadline (e.g.
        every worker crashed)."""
        t0 = time.monotonic()
        deadline = t0 + float(timeout_s)
        events = [threading.Event() for _ in self.workers]
        threads = [threading.Thread(target=self._worker_loop, args=(w, ev),
                                    daemon=True)
                   for w, ev in zip(self.workers, events)]
        for t in threads:
            t.start()
        try:
            while time.monotonic() < deadline:
                if all(ev.is_set() for ev in events):
                    break
                if self.store.drained():
                    break
                time.sleep(self.poll_s)
        finally:
            self._stop = True
            for t in threads:
                t.join(timeout=max(deadline - time.monotonic(), 1.0))
        wall = time.monotonic() - t0
        counts = self.store.counts()
        st = self.store.stats
        return {
            "drained": self.store.drained(),
            "wall_s": wall,
            "docs_done": counts[DONE],
            "docs_failed": counts[FAILED],
            "docs_per_s": counts[DONE] / wall if wall > 0 else 0.0,
            "counts": counts,
            "retries": st.retries,
            "reclaims": st.reclaims,
            "exhausted": st.exhausted,
            "dead_workers": list(self.dead),
            "workers": {w.name: dataclasses.asdict(w.stats)
                        for w in self.workers},
        }
