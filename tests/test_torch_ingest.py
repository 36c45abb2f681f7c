"""The port's document ingest pipeline on the CPU.

The counterparts of the reference's ``tests/test_ingest_pipeline.py``, case
for case, with the port's engine on ``device="cpu"``: the job state machine
under a fake clock, journal replay and torn tails, leases, retries and
backoff, the insert fence and its horizon, crash-at-each-site recovery
differentials against a fresh static build, the threaded pipeline under a
fault plan, and the runtime sink's contract.

On top, against the reference's ``data/ingest.py``: its documents and
projected points bit for bit, the static corpus, a journal written by one
package's ``JobStore`` under a fake clock equal to the other's byte for
byte and replaying in it, the reference's random crash interleavings
driven through both packages in lockstep as a differential (store counts,
job states, attempts, ``not_before``, ``ext_map`` and the final corpora
equal; where the reference drains, the corpus equals the static build),
and the reference's known fault pinned: a permanent error retried as if it
were transient.
"""
from __future__ import annotations

import os
import tempfile
from collections import Counter

import numpy as np
import pytest

import torch

from repro.data import ingest as ref_ingest
from repro.serve.engine import NKSEngine as RefEngine
from repro.serve import faults as ref_faults
from repro_torch.data import ingest as port_ingest
from repro_torch.data.ingest import (
    CLAIMED, DONE, EMBEDDED, FAILED, INSERTED, PENDING,
    IngestPipeline, IngestWorker, IntentBusy, InvalidTransition,
    JobStore, LeaseLost, ProjectionEmbedder, RuntimeSink, SinkIndeterminate,
    corpus_from_documents, flickr_like_documents,
)
from repro_torch.data.synthetic import random_queries
from repro_torch.serve import faults as port_faults
from repro_torch.serve.engine import NKSEngine
from repro_torch.serve.faults import FaultPlan, InjectedCrash

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                   # pragma: no cover
    HAVE_HYPOTHESIS = False

torch.set_num_threads(1)
D_RAW, D_OUT, U = 16, 6, 20
SITES = ("claim", "embed", "insert", "ack")


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


def _docs(n, *, tenants=None, seed=1):
    return flickr_like_documents(n, d_raw=D_RAW, u=U, t=3, seed=seed,
                                 tenants=tenants)


def _embedder(seed=2):
    vocab = [f"tag{i:03d}" for i in range(U)]
    return ProjectionEmbedder(D_OUT, vocab, d_raw=D_RAW, seed=seed)


def _engine(ds, **kw):
    kw.setdefault("compact_min", 10_000)
    return NKSEngine(ds, m=2, n_scales=4, seed=0, device="cpu", **kw)


def _store(path, clk, **kw):
    kw.setdefault("lease_s", 10.0)
    kw.setdefault("backoff_s", 0.5)
    return JobStore(str(path), clock=clk, **kw)


def _drive(worker, store, clk, *, limit=500):
    """Step one worker until the store drains, advancing the fake clock
    whenever no work is claimable (backoff / lease windows)."""
    for _ in range(limit):
        if store.drained():
            return
        if not worker.step():
            clk.advance(5.0)
    raise AssertionError(f"not drained after {limit} steps: "
                         f"{store.counts()}")


# ----------------------------------------------------- differential helpers
def _cases(ref_ds, *, tenanted, seed=9):
    """Query/filter cases: unfiltered global-id queries plus (on tenanted
    corpora) tenant-scoped local-id queries with an attribute predicate."""
    cases = [(q, None) for q in random_queries(ref_ds, 2, 8, seed=seed)]
    if tenanted:
        cases += [([0, 1], {"tenant": "a"}), ([1, 2], {"tenant": "a"}),
                  ([0, 2], {"tenant": "b",
                            "where": [["price", "<", 60.0]]})]
    return cases


def _canon_answers(engine, cases, ext2doc, *, k=2):
    ext = np.asarray(engine._ext_of)
    out = []
    for q, flt in cases:
        res = engine.query(q, k=k, tier="exact", filter=flt)
        out.append([(float(c.diameter),
                     tuple(sorted(ext2doc[int(ext[i])] for i in c.ids)))
                    for c in res.candidates])
    return out


def _assert_equivalent(got, want):
    """Exact-tier answers modulo legitimate equal-diameter ties: diameter
    lists must be identical; doc-id sets must match at every rank whose
    diameter is unique in the answer and strictly inside the top-k cut."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        da, db = [x[0] for x in a], [x[0] for x in b]
        assert da == db, (da, db)
        cnt = Counter(da)
        cutoff = da[-1] if da else None
        for (d1, ids1), (_, ids2) in zip(a, b):
            if cnt[d1] == 1 and d1 != cutoff:
                assert ids1 == ids2, (d1, ids1, ids2)


def _assert_corpus_matches(engine, ext2doc, docs_by_id, emb, expected_ids):
    """The no-lost-no-dup invariant plus per-row bitwise identity: every
    expected document is in the engine exactly once, and its point row,
    keyword set, attrs, and tenant are exactly what the embedder says."""
    ext = [int(e) for e in np.asarray(engine._ext_of)]
    assert len(ext) == len(set(ext)), "duplicate external ids"
    got_docs = [ext2doc[e] for e in ext]
    assert sorted(got_docs) == sorted(expected_ids)   # no lost, no dup
    ds = engine.dataset
    ns = ds.tenants
    pts = np.asarray(ds.points)
    for row, doc_id in enumerate(got_docs):
        rec = emb.extract(docs_by_id[doc_id])
        np.testing.assert_array_equal(pts[row], rec.point)
        want_kws = (ns.resolve(rec.tenant, rec.keywords) if ns is not None
                    else rec.keywords)
        assert sorted(int(v) for v in ds.kw.row(row)) == sorted(want_kws)
        if rec.attrs is not None:
            for name, val in rec.attrs.items():
                assert ds.attr_column(name)[row] == val
        if ns is not None:
            assert int(ds.tenant_ids[row]) == ns.id_of(rec.tenant)


def _setting(docs, n_seed, emb):
    """Split docs into a seed corpus (engine build) and a job stream, and
    return the static reference built over *all* docs."""
    seed_ds, seed_ids = corpus_from_documents(docs[:n_seed], emb)
    ref_ds, ref_ids = corpus_from_documents(docs, emb)
    return seed_ds, seed_ids, ref_ds, {i: d for i, d in enumerate(ref_ids)}


# ------------------------------------------------------------ embedder layer
def test_embedder_deterministic_and_validates():
    docs, vocab = _docs(5, seed=4)
    emb = _embedder()
    r1, r2 = emb.extract(docs[0]), emb.extract(docs[0])
    np.testing.assert_array_equal(r1.point, r2.point)   # bitwise
    assert r1.keywords == r2.keywords and r1.point.dtype == np.float32
    assert r1.keywords == sorted(set(r1.keywords))
    with pytest.raises(ValueError, match="unknown tag"):
        emb.extract({"doc_id": "x", "payload": docs[0]["payload"],
                     "tags": ["not-a-tag"]})
    with pytest.raises(ValueError, match="no tags"):
        emb.extract({"doc_id": "x", "payload": docs[0]["payload"],
                     "tags": []})
    with pytest.raises(ValueError, match="payload"):
        emb.extract({"doc_id": "x", "payload": [1.0, 2.0], "tags": ["tag001"]})


def test_flickr_like_documents_and_static_corpus():
    docs, vocab = _docs(40, tenants=("a", "b"), seed=3)
    assert len(vocab) == U and len(docs) == 40
    assert all(set(d) == {"doc_id", "payload", "tags", "attrs", "tenant"}
               for d in docs)
    assert {d["tenant"] for d in docs} <= {"a", "b"}
    ds, doc_ids = corpus_from_documents(docs, _embedder())
    assert ds.n == 40 and ds.dim == D_OUT
    assert ds.n_keywords == 2 * U                 # private per-tenant slots
    assert ds.tenants is not None and list(ds.tenants.names) == ["a", "b"]
    assert set(doc_ids) == {d["doc_id"] for d in docs}
    assert set(ds.attrs) == {"category", "price"}
    # mixed tenanted/untenanted input is rejected
    broken = [dict(docs[0]), dict(docs[1])]
    del broken[0]["tenant"]
    with pytest.raises(ValueError, match="mixed tenant"):
        corpus_from_documents(broken, _embedder())


# ------------------------------------------------------------- job store fsm
def test_jobstore_lifecycle_happy_path(tmp_path):
    clk = FakeClock()
    store = _store(tmp_path / "j.jsonl", clk)
    docs, _ = _docs(5, seed=2)
    ids = store.add(docs)
    assert store.counts()[PENDING] == 5 and not store.drained()

    jobs = store.claim("w0", limit=3)
    assert [j.job_id for j in jobs] == ids[:3]
    assert all(j.state == CLAIMED and j.attempts == 1 for j in jobs)
    store.mark_embedded("w0", [j.job_id for j in jobs])
    assert store.counts()[EMBEDDED] == 3

    intent = store.record_intent("w0", [j.job_id for j in jobs],
                                 horizon=100)
    assert store.counts()[INSERTED] == 3
    store.ack_intent(intent, [100, 101, 102])
    assert store.counts() == {PENDING: 2, CLAIMED: 0, EMBEDDED: 0,
                              INSERTED: 0, DONE: 3, FAILED: 0}
    assert store.open_intent() is None
    assert store.ext_map() == {100 + i: docs[i]["doc_id"] for i in range(3)}
    store.close()


def test_jobstore_illegal_edges(tmp_path):
    clk = FakeClock()
    store = _store(tmp_path / "j.jsonl", clk)
    docs, _ = _docs(4, seed=2)
    ids = store.add(docs)
    jobs = store.claim("w0", limit=2)
    jids = [j.job_id for j in jobs]

    # wrong owner / wrong state => LeaseLost
    with pytest.raises(LeaseLost):
        store.mark_embedded("w1", jids)
    with pytest.raises(LeaseLost):
        store.record_intent("w0", jids, horizon=0)     # still claimed
    store.mark_embedded("w0", jids)
    with pytest.raises(LeaseLost):
        store.mark_embedded("w0", jids)                # already embedded

    # the intent fence admits one batch at a time
    i0 = store.record_intent("w0", jids, horizon=7)
    more = store.claim("w1", limit=2)
    store.mark_embedded("w1", [j.job_id for j in more])
    with pytest.raises(IntentBusy):
        store.record_intent("w1", [j.job_id for j in more], horizon=9)
    with pytest.raises(InvalidTransition):
        store.ack_intent(i0 + 5, [7, 8])               # not the open intent
    with pytest.raises(InvalidTransition):
        store.ack_intent(i0, [7])                      # wrong cardinality
    store.ack_intent(i0, [7, 8])
    with pytest.raises(InvalidTransition):
        store.ack_intent(i0, [7, 8])                   # already resolved
    # pending jobs are not releasable by a non-owner
    with pytest.raises(LeaseLost):
        store.release("w0", [ids[3]], error="nope")
    store.close()


def test_journal_replay_roundtrip(tmp_path):
    clk = FakeClock()
    path = tmp_path / "j.jsonl"
    store = _store(path, clk, max_attempts=4)
    docs, _ = _docs(6, seed=5)
    store.add(docs)
    jobs = store.claim("w0", limit=4)
    store.mark_embedded("w0", [j.job_id for j in jobs[:3]])
    store.release("w0", [jobs[3].job_id], error="transient")
    intent = store.record_intent("w0", [j.job_id for j in jobs[:3]],
                                 horizon=50)
    store.ack_intent(intent, [50, 51, 52])
    jobs2 = store.claim("w1", limit=1)       # claims job 4 (pending, ready)
    snap = {j.job_id: (j.state, j.attempts, j.worker, j.not_before,
                       j.lease_until, j.ext_id)
            for j in store.jobs.values()}
    counts, stats = store.counts(), dataclasses_dict(store.stats)

    re = _store(path, clk, max_attempts=4)
    assert {j.job_id: (j.state, j.attempts, j.worker, j.not_before,
                       j.lease_until, j.ext_id)
            for j in re.jobs.values()} == snap
    assert re.counts() == counts
    assert dataclasses_dict(re.stats) == stats
    assert re.open_intent() is None
    # the reopened store keeps allocating fresh ids past the journal's
    new = re.add([docs[0] | {"doc_id": "doc-new"}])
    assert new[0] == max(snap) + 1
    store.close()
    re.close()
    assert jobs2[0].state == CLAIMED


def dataclasses_dict(dc):
    import dataclasses
    return dataclasses.asdict(dc)


def test_journal_torn_tail_truncated(tmp_path):
    clk = FakeClock()
    path = tmp_path / "j.jsonl"
    store = _store(path, clk)
    docs, _ = _docs(3, seed=5)
    store.add(docs)
    store.claim("w0", limit=2)
    store.close()
    size = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(b'{"t": "claim", "ids": [2], "worker": "w1", "lease')
    re = _store(path, clk)                   # torn record dropped
    assert os.path.getsize(path) == size
    assert re.counts()[CLAIMED] == 2 and re.counts()[PENDING] == 1
    # a parse-clean tail without its newline is torn too
    re.close()
    with open(path, "rb+") as f:
        f.seek(0, 2)
        f.write(b'{"t": "release", "retry": [0], "failed": [],'
                b' "error": "x", "reason": "error", "not_before": 0.0}')
    re2 = _store(path, clk)
    assert os.path.getsize(path) == size
    assert re2.counts()[CLAIMED] == 2
    re2.close()


def test_release_replay_preserves_per_job_backoff(tmp_path):
    """One release record covering jobs with different attempt counts must
    replay each job's own backoff instant, not a shared maximum — the
    reopened store's retry schedule is identical to the one that wrote the
    journal."""
    clk = FakeClock()
    path = tmp_path / "j.jsonl"
    store = _store(path, clk, backoff_s=1.0, max_attempts=10)
    docs, _ = _docs(2, seed=21)
    store.add(docs)
    store.claim("w0", limit=1)                 # job 0, attempt 1
    store.release("w0", [0], error="flaky")
    clk.advance(100.0)
    jobs = store.claim("w0", limit=2)          # job 0 attempt 2, job 1 attempt 1
    assert [j.attempts for j in jobs] == [2, 1]
    store.release("w0", [0, 1], error="flaky")  # one record, two backoffs
    nb = {j.job_id: j.not_before for j in store.jobs.values()}
    assert nb[0] == pytest.approx(clk() + 2.0)  # 1.0 * 2^(2-1)
    assert nb[1] == pytest.approx(clk() + 1.0)  # 1.0 * 2^(1-1)

    re = _store(path, clk, backoff_s=1.0, max_attempts=10)
    assert {j.job_id: j.not_before for j in re.jobs.values()} == nb
    store.close()
    re.close()


def test_record_intent_samples_horizon_under_the_fence(tmp_path):
    """The insert horizon is read inside the store lock, after the fence
    check — a concurrent batch can no longer complete a full
    intent->insert->ack cycle between a caller's pre-read and its fence
    (the stale-first_ext race), and a busy fence never samples at all."""
    clk = FakeClock()
    store = _store(tmp_path / "j.jsonl", clk)
    docs, _ = _docs(4, seed=23)
    store.add(docs)
    jobs = store.claim("w0", limit=2)
    jids = [j.job_id for j in jobs]
    store.mark_embedded("w0", jids)
    seen = []

    def horizon():
        assert store._lock._is_owned()         # atomic with the fence
        assert store._intent is None           # sampled after the busy check
        seen.append(1)
        return 42

    i0 = store.record_intent("w0", jids, horizon=horizon)
    assert store.open_intent().first_ext == 42 and seen == [1]

    more = store.claim("w1", limit=2)
    store.mark_embedded("w1", [j.job_id for j in more])

    def poisoned():
        raise AssertionError("horizon sampled despite a busy fence")

    with pytest.raises(IntentBusy):
        store.record_intent("w1", [j.job_id for j in more], horizon=poisoned)
    store.ack_intent(i0, [42, 43])

    # the sink protocol (an object with next_external_id) is accepted too
    class Sink:
        next_external_id = 7

    i1 = store.record_intent("w1", [j.job_id for j in more], horizon=Sink())
    assert store.open_intent().first_ext == 7
    store.ack_intent(i1, [7, 8])
    store.close()


def test_record_intent_refreshes_job_leases(tmp_path):
    """record_intent renews the jobs' leases alongside the intent's, so
    next_ready_at() reports the intent window, not the stale embed-stage
    lease — and the refresh survives journal replay."""
    clk = FakeClock()
    path = tmp_path / "j.jsonl"
    store = _store(path, clk, lease_s=10.0)
    docs, _ = _docs(2, seed=22)
    store.add(docs)
    jobs = store.claim("w0", limit=2)
    store.mark_embedded("w0", [j.job_id for j in jobs])
    clk.advance(6.0)                           # embed lease has 4s left
    store.record_intent("w0", [j.job_id for j in jobs], horizon=0)
    want = clk() + 10.0
    assert all(store.jobs[j.job_id].lease_until == want for j in jobs)
    assert store.next_ready_at() == want       # not the stale embed lease

    re = _store(path, clk, lease_s=10.0)       # replay mirrors the refresh
    assert all(re.jobs[j.job_id].lease_until == want for j in jobs)
    assert re.next_ready_at() == want
    store.close()
    re.close()


def test_lease_expiry_reclaim_and_lease_lost(tmp_path):
    clk = FakeClock()
    store = _store(tmp_path / "j.jsonl", clk, lease_s=10.0, max_attempts=5)
    docs, _ = _docs(4, seed=6)
    store.add(docs)
    dead = store.claim("w-dead", limit=4)
    assert store.claim("w-live", limit=4) == []       # lease held
    clk.advance(10.1)                                 # w-dead "died"
    alive = store.claim("w-live", limit=4)
    assert [j.job_id for j in alive] == [j.job_id for j in dead]
    assert all(j.worker == "w-live" and j.attempts == 2 for j in alive)
    assert store.stats.reclaims == 4
    # the zombie's writes bounce: its lease is gone
    with pytest.raises(LeaseLost):
        store.mark_embedded("w-dead", [j.job_id for j in dead])
    with pytest.raises(LeaseLost):
        store.release("w-dead", [dead[0].job_id], error="late")
    store.close()


def test_retry_backoff_schedule_and_exhaustion(tmp_path):
    clk = FakeClock()
    store = _store(tmp_path / "j.jsonl", clk, max_attempts=3, backoff_s=1.0)
    docs, _ = _docs(1, seed=7)
    store.add(docs)
    last_ready = 0.0
    for attempt in range(1, 4):
        jobs = store.claim("w0", limit=1)
        assert jobs and jobs[0].attempts == attempt
        if attempt < 3:
            store.release("w0", [0], error="flaky")
            j = store.jobs[0]
            assert j.state == PENDING
            # exponential: now + 1.0 * 2^(attempts-1)
            assert j.not_before == pytest.approx(
                clk() + 1.0 * 2.0 ** (attempt - 1))
            assert store.claim("w0", limit=1) == []   # backoff holds
            assert j.not_before > last_ready
            last_ready = j.not_before
            clk.advance(100.0)
        else:
            store.release("w0", [0], error="flaky")
    j = store.jobs[0]
    assert j.state == FAILED and "exhausted" in j.error
    assert store.stats.exhausted == 1 and store.drained()
    assert store.claim("w0", limit=1) == []           # terminal
    store.close()


def test_poison_doc_fails_without_blocking_batch(tmp_path):
    """A document the embedder rejects burns its own attempts to terminal
    ``failed``; the rest of its batch lands normally."""
    clk = FakeClock()
    docs, _ = _docs(10, seed=8)
    docs[4]["tags"] = ["never-a-tag"]
    emb = _embedder()
    seed_ds, seed_ids, _, _ = _setting(_docs(8, seed=9)[0], 8, emb)
    store = _store(tmp_path / "j.jsonl", clk, max_attempts=3)
    store.add(docs)
    eng = _engine(seed_ds)
    w = IngestWorker("w0", store, eng, emb, batch_docs=4)
    _drive(w, store, clk)
    counts = store.counts()
    assert counts[DONE] == 9 and counts[FAILED] == 1
    assert store.jobs[4].state == FAILED
    assert "unknown tag" in store.jobs[4].error
    assert w.stats.embed_failures == 3                # one per attempt
    assert eng.dataset.n == seed_ds.n + 9
    eng.close()


# --------------------------------------------------- end-to-end differential
def test_worker_end_to_end_differential(tmp_path):
    """Pipeline-ingested engine answers filtered multi-tenant queries
    equivalently to a fresh static engine over the same documents, the
    corpus is row-for-row bitwise faithful to the embedder, and each batch
    costs exactly one WAL fsync (the group-commit barrier)."""
    docs, _ = _docs(80, tenants=("a", "b"), seed=1)
    emb = _embedder()
    seed_ds, seed_ids, ref_ds, ref_table = _setting(docs, 20, emb)
    clk = FakeClock()
    store = _store(tmp_path / "j.jsonl", clk)
    store.add(docs[20:])
    eng = _engine(seed_ds)
    eng.attach_wal(str(tmp_path / "wal"))
    f0 = eng.wal_stats.fsyncs
    w = IngestWorker("w0", store, eng, emb, batch_docs=8)
    _drive(w, store, clk)
    assert store.counts()[DONE] == 60
    assert eng.wal_stats.fsyncs - f0 == w.stats.batches_inserted

    ext2doc = {i: d for i, d in enumerate(seed_ids)}
    ext2doc.update(store.ext_map())
    docs_by_id = {d["doc_id"]: d for d in docs}
    _assert_corpus_matches(eng, ext2doc, docs_by_id, emb,
                           [d["doc_id"] for d in docs])
    ref = _engine(ref_ds)
    cases = _cases(ref_ds, tenanted=True)
    _assert_equivalent(_canon_answers(eng, cases, ext2doc),
                       _canon_answers(ref, cases, ref_table))
    eng.close()
    store.close()


def test_transient_faults_reconcile_in_process(tmp_path):
    """An ``InjectedFault`` (retryable error, not a death) around the insert
    window resolves through the same horizon reconciliation as recovery:
    before the engine touched the batch => reverted + retried; after the
    barrier => acked exactly-once, no duplicate points."""
    docs, _ = _docs(30, seed=11)
    emb = _embedder()
    seed_ds, seed_ids, ref_ds, ref_table = _setting(docs, 10, emb)
    for site, field in (("insert", "reconciled_reverted"),
                        ("ack", "reconciled_applied")):
        clk = FakeClock()
        store = _store(tmp_path / f"j-{site}.jsonl", clk, max_attempts=5)
        store.add(docs[10:])
        eng = _engine(seed_ds)
        faults = FaultPlan(transient={site: 2})
        w = IngestWorker("w0", store, eng, emb, batch_docs=5, faults=faults)
        _drive(w, store, clk)
        assert faults.fired[site] == 1
        assert getattr(w.stats, field) == 1
        assert store.counts()[DONE] == 20 and store.counts()[FAILED] == 0
        assert eng.dataset.n == ref_ds.n              # no lost, no dup
        ext2doc = {i: d for i, d in enumerate(seed_ids)}
        ext2doc.update(store.ext_map())
        _assert_corpus_matches(eng, ext2doc, {d["doc_id"]: d for d in docs},
                               emb, [d["doc_id"] for d in docs])
        eng.close()
        store.close()


EXPECTED_RECOVERY = {"claim": None, "embed": None,
                     "insert": "reverted", "ack": "applied"}


@pytest.mark.parametrize("site", SITES)
def test_crash_site_recovery_differential(tmp_path, site):
    """Kill the worker at each crash site mid-run, then recover the whole
    process: engine from its WAL, job store from its journal, pipeline
    startup reconciliation for the open intent. The drained corpus must be
    indistinguishable from a no-fault build — at-least-once below the ack
    horizon, exactly-once above it."""
    docs, _ = _docs(70, tenants=("a", "b"), seed=13)
    emb = _embedder()
    seed_ds, seed_ids, ref_ds, ref_table = _setting(docs, 22, emb)
    clk = FakeClock()
    jpath, wroot = str(tmp_path / "j.jsonl"), str(tmp_path / "wal")
    store = _store(jpath, clk, lease_s=10.0)
    store.add(docs[22:])
    eng = _engine(seed_ds)
    eng.attach_wal(wroot)

    faults = FaultPlan(crash={site: 2})    # survive batch 1, die in batch 2
    w = IngestWorker("w0", store, eng, emb, batch_docs=8, faults=faults)
    with pytest.raises(InjectedCrash):
        for _ in range(100):
            if not w.step():
                clk.advance(1.0)
    assert faults.fired[site] == 1
    # The dead worker cleaned up nothing: its claim (and for insert/ack its
    # open intent) is still on the books. Simulated process death: abandon
    # both objects un-closed and rebuild from disk.
    n_before = int(eng.dataset.n)

    eng2 = NKSEngine.recover(wroot, device="cpu")
    assert int(eng2.dataset.n) == n_before            # WAL lost nothing
    store2 = _store(jpath, clk, lease_s=10.0)
    pipe = IngestPipeline(store2, eng2, emb, workers=1, batch_docs=8)
    assert pipe.recover() == EXPECTED_RECOVERY[site]
    assert pipe.recover() is None                     # idempotent
    if site == "ack":
        # the crashed batch was past its barrier: acked from the horizon,
        # not re-inserted
        assert store2.counts()[DONE] >= 16
    clk.advance(30.0)                                 # expire dead leases
    _drive(pipe.workers[0], store2, clk)

    counts = store2.counts()
    assert counts[FAILED] == 0 and counts[DONE] == 48
    ext2doc = {i: d for i, d in enumerate(seed_ids)}
    ext2doc.update(store2.ext_map())
    docs_by_id = {d["doc_id"]: d for d in docs}
    _assert_corpus_matches(eng2, ext2doc, docs_by_id, emb,
                           [d["doc_id"] for d in docs])
    ref = _engine(ref_ds)
    cases = _cases(ref_ds, tenanted=True)
    _assert_equivalent(_canon_answers(eng2, cases, ext2doc),
                       _canon_answers(ref, cases, ref_table))
    # ... and the *recovered* state itself recovers: one more round-trip
    eng2.close()
    eng3 = NKSEngine.recover(wroot, device="cpu")
    _assert_equivalent(_canon_answers(eng3, cases, ext2doc),
                       _canon_answers(ref, cases, ref_table))
    eng3.close()
    store2.close()


def test_threaded_pipeline_with_fault_plan(tmp_path):
    """Six workers race the queue while a shared fault plan kills four of
    them, one per crash site, mid-run (real clock, short leases). The
    survivors drain the store and the corpus still matches the static
    reference exactly."""
    docs, _ = _docs(90, tenants=("a", "b"), seed=17)
    emb = _embedder()
    seed_ds, seed_ids, ref_ds, ref_table = _setting(docs, 26, emb)
    store = JobStore(str(tmp_path / "j.jsonl"), lease_s=0.3,
                     backoff_s=0.01, max_attempts=10)
    store.add(docs[26:])
    eng = _engine(seed_ds)
    eng.attach_wal(str(tmp_path / "wal"))
    faults = FaultPlan(crash={"claim": 3, "embed": 5, "insert": 7, "ack": 9})
    pipe = IngestPipeline(store, eng, emb, workers=6, batch_docs=6,
                          faults=faults)
    report = pipe.run(timeout_s=60.0)
    assert report["drained"], report
    assert sorted(faults.fired) == sorted(SITES)      # all four deaths fired
    assert len(report["dead_workers"]) == 4
    assert report["docs_failed"] == 0
    assert report["docs_done"] == 64
    assert report["docs_per_s"] > 0

    ext2doc = {i: d for i, d in enumerate(seed_ids)}
    ext2doc.update(store.ext_map())
    _assert_corpus_matches(eng, ext2doc, {d["doc_id"]: d for d in docs},
                           emb, [d["doc_id"] for d in docs])
    ref = _engine(ref_ds)
    cases = _cases(ref_ds, tenanted=True)
    _assert_equivalent(_canon_answers(eng, cases, ext2doc),
                       _canon_answers(ref, cases, ref_table))
    eng.close()
    store.close()


def test_runtime_sink_coalesces_with_admission_queue(tmp_path):
    """Targeting the serving runtime instead of a bare engine: batches ride
    the admission queue as insert ops and coalesce into grouped ingest runs
    exactly like launcher ingests, and the drained corpus matches."""
    from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime

    docs, _ = _docs(50, seed=19)
    emb = _embedder()
    seed_ds, seed_ids, ref_ds, ref_table = _setting(docs, 14, emb)
    store = JobStore(str(tmp_path / "j.jsonl"), lease_s=5.0, backoff_s=0.01)
    store.add(docs[14:])
    eng = _engine(seed_ds)
    eng.attach_wal(str(tmp_path / "wal"))
    with ServingRuntime(eng, RuntimeConfig(batch_window_s=0.002)) as rt:
        pipe = IngestPipeline(store, rt, emb, workers=3, batch_docs=6)
        report = pipe.run(timeout_s=60.0)
        assert report["drained"], report
        assert rt.stats.ingest_ops >= 6               # went through the queue
    assert store.counts()[DONE] == 36
    ext2doc = {i: d for i, d in enumerate(seed_ids)}
    ext2doc.update(store.ext_map())
    _assert_corpus_matches(eng, ext2doc, {d["doc_id"]: d for d in docs},
                           emb, [d["doc_id"] for d in docs])
    ref = _engine(ref_ds)
    cases = _cases(ref_ds, tenanted=False)
    _assert_equivalent(_canon_answers(eng, cases, ext2doc),
                       _canon_answers(ref, cases, ref_table))
    eng.close()
    store.close()


class _StubRuntime:
    """Runtime double: the first submit swallows its op (an unresolved
    ticket — the op is stuck inside the runtime); later submits execute
    immediately against the real engine. ``land_lost`` applies the stuck op
    after the fact — the late-landing execution the sink/worker pair must
    survive without duplicating the batch."""

    def __init__(self, engine):
        self.engine = engine
        self.lost = None
        self.deadlines = []

    def _apply(self, req):
        with self.engine.ingest_group():
            ids = self.engine.insert(req["points"], req["keywords"],
                                     attrs=req.get("attrs"),
                                     tenant=req.get("tenant"))
        return [int(i) for i in ids]

    def submit(self, request, deadline_s=None):
        from repro_torch.serve.runtime import RuntimeResponse, Ticket
        self.deadlines.append(deadline_s)
        t = Ticket(request, None)
        if self.lost is None:
            self.lost = request                # black hole: never resolves
            return t
        t._resolve(RuntimeResponse(op="insert", status="ok",
                                   payload={"ids": self._apply(request)}))
        return t

    def land_lost(self):
        self._apply(self.lost)


def test_runtime_sink_terminal_status_contract():
    """insert() submits with an admission deadline and waits the ticket to a
    terminal status, then classifies it: ok returns ids;
    timeout/rejected/error raise plainly (the op provably never mutated the
    engine — safe to reconcile immediately); crashed, or a ticket that never
    resolves, raise SinkIndeterminate (fate unknown — the intent must stay
    open). Giving up on a still-queued op is no longer possible, which is
    what made the duplicate-insert race reachable."""
    from repro_torch.serve.runtime import RuntimeResponse, Ticket

    class OneShot:
        engine = None

        def __init__(self, resp):
            self.resp = resp
            self.deadline = "unset"

        def submit(self, request, deadline_s=None):
            self.deadline = deadline_s
            t = Ticket(request, None)
            if self.resp is not None:
                t._resolve(self.resp)
            return t

    pts = np.zeros((1, D_OUT), np.float32)
    rt = OneShot(RuntimeResponse(op="insert", status="ok",
                                 payload={"ids": [5]}))
    assert RuntimeSink(rt, timeout_s=0.4).insert(pts, [[0]], None, None) == [5]
    assert rt.deadline == pytest.approx(0.4)   # admission deadline attached

    for status in ("timeout", "rejected", "error"):
        rt = OneShot(RuntimeResponse(op="insert", status=status, error="x"))
        with pytest.raises(RuntimeError, match=status) as ei:
            RuntimeSink(rt, timeout_s=0.4).insert(pts, [[0]], None, None)
        assert type(ei.value) is RuntimeError  # NOT indeterminate

    rt = OneShot(RuntimeResponse(op="insert", status="crashed", error="boom"))
    with pytest.raises(SinkIndeterminate):
        RuntimeSink(rt, timeout_s=0.4).insert(pts, [[0]], None, None)

    rt = OneShot(None)                         # ticket never resolves
    with pytest.raises(SinkIndeterminate):
        RuntimeSink(rt, timeout_s=0.01, grace_s=0.02).insert(
            pts, [[0]], None, None)


def test_lost_insert_op_cannot_duplicate_batch(tmp_path):
    """The duplicate-insert race, end to end: the runtime holds an insert op
    past the sink's patience, the op lands *late*, and the batch must still
    end up in the corpus exactly once. The sink raises SinkIndeterminate,
    the worker leaves the intent open (no early release, so no retry racing
    the in-flight op), and the expired-lease reconciliation acks the batch
    from the moved horizon instead of re-inserting it."""
    docs, _ = _docs(14, seed=27)
    emb = _embedder()
    seed_ds, seed_ids, _, _ = _setting(docs, 6, emb)
    clk = FakeClock()
    store = _store(tmp_path / "j.jsonl", clk, lease_s=10.0)
    store.add(docs[6:])
    eng = _engine(seed_ds)
    rt = _StubRuntime(eng)
    sink = RuntimeSink(rt, timeout_s=0.01, grace_s=0.02)
    w = IngestWorker("w0", store, sink, emb, batch_docs=4, clock=clk)

    assert w.step()                            # batch 1: op swallowed
    assert w.stats.sink_indeterminate == 1
    assert rt.deadlines[0] == pytest.approx(0.01)
    assert store.open_intent() is not None     # intent stays open; jobs are
    assert store.counts()[INSERTED] == 4       # NOT released for a retry

    rt.land_lost()                             # the stuck op executes late
    assert not w.step()                        # batch 2 staged; fence live
    assert w.stats.intent_busy == 1
    clk.advance(10.1)                          # intent lease expires
    _drive(w, store, clk)
    assert w.stats.reconciled_applied == 1     # batch 1 acked, not re-run
    assert store.counts()[DONE] == 8 and store.counts()[FAILED] == 0

    ext2doc = {i: d for i, d in enumerate(seed_ids)}
    ext2doc.update(store.ext_map())
    _assert_corpus_matches(eng, ext2doc, {d["doc_id"]: d for d in docs},
                           emb, [d["doc_id"] for d in docs])
    eng.close()
    store.close()


@pytest.mark.parametrize("lands", [True, False])
def test_indeterminate_final_batch_reconciles_without_new_work(tmp_path,
                                                               lands):
    """A SinkIndeterminate on the *last* batch leaves the intent open with
    nothing left to claim; the worker's idle path must still reconcile it
    after lease expiry (applied if the stuck op landed late, reverted and
    retried if it never did) or the store would never drain."""
    docs, _ = _docs(10, seed=29)
    emb = _embedder()
    seed_ds, seed_ids, _, _ = _setting(docs, 6, emb)
    clk = FakeClock()
    store = _store(tmp_path / "j.jsonl", clk, lease_s=10.0)
    store.add(docs[6:])
    eng = _engine(seed_ds)
    rt = _StubRuntime(eng)
    w = IngestWorker("w0", store,
                     RuntimeSink(rt, timeout_s=0.01, grace_s=0.02),
                     emb, batch_docs=4, clock=clk)

    assert w.step()                            # the only batch: op swallowed
    assert w.stats.sink_indeterminate == 1
    assert not w.step()                        # nothing claimable, fence live
    if lands:
        rt.land_lost()
    clk.advance(10.1)                          # intent lease expires
    _drive(w, store, clk)
    assert store.counts()[DONE] == 4 and store.counts()[FAILED] == 0
    if lands:
        assert w.stats.reconciled_applied == 1
    else:
        assert w.stats.reconciled_reverted == 1 and store.stats.retries == 4

    ext2doc = {i: d for i, d in enumerate(seed_ids)}
    ext2doc.update(store.ext_map())
    _assert_corpus_matches(eng, ext2doc, {d["doc_id"]: d for d in docs},
                           emb, [d["doc_id"] for d in docs])
    eng.close()
    store.close()


# ------------------------------------------------ against the reference's
@pytest.mark.parametrize("kw", [
    dict(n=40, d_raw=D_RAW, u=U, t=3, seed=3, tenants=("a", "b")),
    dict(n=25, d_raw=256, u=300, t=11, seed=11, with_attrs=False),
    dict(n=30, d_raw=8, u=24, t=2, seed=0, tenants=("t0", "t1", "t2"))])
def test_documents_points_and_corpus_equal_reference(kw):
    """``flickr_like_documents``, ``ProjectionEmbedder`` and
    ``corpus_from_documents`` give the reference's documents, points and
    static corpus bit for bit."""
    n = kw.pop("n")
    docs, vocab = flickr_like_documents(n, **kw)
    rdocs, rvocab = ref_ingest.flickr_like_documents(n, **kw)
    assert docs == rdocs and vocab == rvocab
    emb = ProjectionEmbedder(D_OUT, vocab, d_raw=kw["d_raw"], seed=2)
    remb = ref_ingest.ProjectionEmbedder(D_OUT, rvocab, d_raw=kw["d_raw"],
                                         seed=2)
    for doc in docs:
        a, b = emb.extract(doc), remb.extract(doc)
        assert a.point.dtype == b.point.dtype == np.float32
        np.testing.assert_array_equal(a.point, b.point)
        assert (a.doc_id, a.keywords, a.attrs, a.tenant) \
            == (b.doc_id, b.keywords, b.attrs, b.tenant)
    ds, ids = corpus_from_documents(docs, emb)
    rds, rids = ref_ingest.corpus_from_documents(docs, remb)
    assert ids == rids and ds.n == rds.n and ds.n_keywords == rds.n_keywords
    np.testing.assert_array_equal(np.asarray(ds.points),
                                  np.asarray(rds.points))
    for row in range(ds.n):
        np.testing.assert_array_equal(ds.kw.row(row), rds.kw.row(row))
    assert sorted(ds.attrs or {}) == sorted(rds.attrs or {})
    for name in ds.attrs or {}:
        np.testing.assert_array_equal(ds.attr_column(name),
                                      rds.attr_column(name))
    if ds.tenants is not None:
        assert list(ds.tenants.names) == list(rds.tenants.names)
        np.testing.assert_array_equal(ds.tenant_ids, rds.tenant_ids)


def test_model_embedder_equals_reference():
    """``ModelEmbedder`` runs its ``embed_fn`` one document at a time and
    keeps the tags, attributes and tenant as the reference's does."""
    docs, vocab = _docs(6, tenants=("a", "b"), seed=4)
    w = np.random.default_rng(1).standard_normal((D_RAW, D_OUT)) \
        .astype(np.float32)
    shapes = []

    def embed_fn(x):
        shapes.append(x.shape)
        return np.tanh(x @ w)

    mine = port_ingest.ModelEmbedder(embed_fn, D_OUT, vocab, d_raw=D_RAW)
    theirs = ref_ingest.ModelEmbedder(embed_fn, D_OUT, vocab, d_raw=D_RAW)
    for doc in docs:
        a, b = mine.extract(doc), theirs.extract(doc)
        np.testing.assert_array_equal(a.point, b.point)
        assert (a.keywords, a.attrs, a.tenant) \
            == (b.keywords, b.attrs, b.tenant)
    assert set(shapes) == {(1, D_RAW)}
    with pytest.raises(ValueError, match="embed_fn returned"):
        port_ingest.ModelEmbedder(lambda x: x, D_OUT, vocab,
                                  d_raw=D_RAW).extract(docs[0])


def _journal_script(pkg, path, clk):
    """Every kind of journal record under a fake clock: adds (one with a
    scheduled arrival), claims, embeds, an error release, an intent and its
    ack, a lease reclaim, an intent released, attempts exhausted."""
    store = pkg.JobStore(str(path), lease_s=10.0, backoff_s=0.5,
                         max_attempts=2, clock=clk)
    docs, _ = pkg.flickr_like_documents(7, d_raw=D_RAW, u=U, t=3, seed=5,
                                        tenants=("a", "b"))
    store.add(docs[:6])
    store.add(docs[6:], not_before=[clk() + 3.0])
    jobs = store.claim("w0", limit=4)
    store.mark_embedded("w0", [j.job_id for j in jobs[:3]])
    store.release("w0", [jobs[3].job_id], error="transient")
    i0 = store.record_intent("w0", [j.job_id for j in jobs[:3]], horizon=50)
    store.ack_intent(i0, [50, 51, 52])
    clk.advance(4.0)
    store.claim("w-dead", limit=2)
    clk.advance(10.5)
    more = store.claim("w1", limit=3)            # reaps the dead lease
    store.mark_embedded("w1", [j.job_id for j in more])
    i1 = store.record_intent("w1", [j.job_id for j in more], horizon=53)
    store.release_intent(i1, error="did not land")
    clk.advance(100.0)
    last = store.claim("w1", limit=5)
    store.release("w1", [j.job_id for j in last], error="permanent")
    store.close()
    return store


def _state(store):
    return ({j.job_id: (j.state, j.attempts, j.worker, j.not_before,
                        j.lease_until, j.error, j.ext_id, j.doc)
             for j in store.jobs.values()},
            store.counts(), store.stats.__dict__.copy(), store.ext_map(),
            store.next_ready_at())


def test_journal_bytes_equal_reference_and_replay_across(tmp_path):
    """The same transitions journaled by both packages' stores under a fake
    clock give the same file byte for byte, and the live stores agree; each
    package reopens either journal into the same jobs, counts and stats."""
    clk_p, clk_r = FakeClock(), FakeClock()
    port = _journal_script(port_ingest, tmp_path / "port.jsonl", clk_p)
    ref = _journal_script(ref_ingest, tmp_path / "ref.jsonl", clk_r)
    blob = (tmp_path / "port.jsonl").read_bytes()
    assert blob == (tmp_path / "ref.jsonl").read_bytes()
    assert b'"t": "release"' in blob and b'"reason": "lease"' in blob
    assert _state(port) == _state(ref)
    assert port.counts()[FAILED] > 0 and port.stats.reclaims == 2
    replays = []
    for writer in ("port", "ref"):
        for pkg in (port_ingest, ref_ingest):
            re = pkg.JobStore(str(tmp_path / f"{writer}.jsonl"),
                              lease_s=10.0, backoff_s=0.5, max_attempts=2,
                              clock=clk_p)
            replays.append(_state(re))
            re.close()
    assert all(r == replays[0] for r in replays[1:])
    assert replays[0][1] == port.counts()


class _Side:
    """One package's half of a lockstep differential: its own classes, a
    store under its own fake clock, an engine over the seed corpus and the
    live workers."""

    def __init__(self, pkg, faults, engine_cls, root, docs, n_seed, **store):
        self.pkg, self.faults, self.engine_cls = pkg, faults, engine_cls
        self.emb = pkg.ProjectionEmbedder(
            D_OUT, [f"tag{i:03d}" for i in range(U)], d_raw=D_RAW, seed=2)
        self.seed_ds, self.seed_ids = pkg.corpus_from_documents(
            docs[:n_seed], self.emb)
        self.clk = FakeClock()
        self.store = pkg.JobStore(os.path.join(root, "j.jsonl"),
                                  clock=self.clk, **store)
        self.store.add(docs[n_seed:])
        kw = dict(m=2, n_scales=4, seed=0, compact_min=10_000)
        if engine_cls is NKSEngine:
            kw["device"] = "cpu"
        self.eng = engine_cls(self.seed_ds, **kw)
        self.workers = []

    def spawn(self, name, crash, batch):
        plan = self.faults.FaultPlan(crash=crash) if crash \
            else self.faults.FaultPlan()
        self.workers.append(self.pkg.IngestWorker(
            name, self.store, self.eng, self.emb, batch_docs=batch,
            faults=plan))

    def step(self, i):
        """One step of worker ``i``: "progress", "idle" (the clock then
        advances as the reference's test does) or "crash" (the worker
        dies)."""
        w = self.workers[i]
        try:
            if w.step():
                return "progress"
        except self.faults.InjectedCrash:
            self.workers.remove(w)
            return "crash"
        self.clk.advance(5.0)
        return "idle"

    def state(self):
        pts = np.asarray(self.eng.dataset.points)
        ext = [int(e) for e in np.asarray(self.eng._ext_of)]
        rows = [(e, tuple(pts[r].tolist()),
                 tuple(sorted(int(v) for v in self.eng.dataset.kw.row(r))))
                for r, e in enumerate(ext)]
        return _state(self.store), self.clk(), rows, \
            [dataclasses_dict(w.stats) for w in self.workers]


def _lockstep(sides, i, record):
    got = [side.step(i) for side in sides]
    assert got[0] == got[1], got
    record.append(got[0])
    return got[0]


def _drain_lockstep(sides, limit, record):
    """The reference's final drain (a fresh clean worker), in lockstep."""
    for side in sides:
        side.workers = []
        side.spawn("w-final", None, 4)
    for _ in range(limit):
        drained = [side.store.drained() for side in sides]
        assert drained[0] == drained[1]
        if drained[0]:
            return True
        _lockstep(sides, 0, record)
    return False


if HAVE_HYPOTHESIS:

    @settings(deadline=None, max_examples=25, derandomize=True,
              database=None)
    @given(st.data())
    def test_random_crash_interleavings_match_reference(data):
        """The reference's random interleavings of worker progress, clock
        advances and crashes at random sites, drawn once and driven through
        both packages in lockstep (every step's outcome equal): the stores'
        counts, job states, attempts, ``not_before``, errors and
        ``ext_map``, and the final corpora, are equal. Where the reference
        drains with nothing failed, both corpora are permutation-identical,
        per document bit for bit, to the no-fault build. Nothing is drawn
        to avoid the reference's known non-converging case (its
        ``_drive`` then runs out of steps, here as there)."""
        n_docs = data.draw(st.integers(8, 24), label="n_docs")
        docs, _ = _docs(n_docs + 6, tenants=("a", "b"),
                        seed=data.draw(st.integers(0, 50), label="seed"))
        crashes = data.draw(
            st.lists(st.sampled_from(SITES), max_size=4), label="crashes")
        hits = [data.draw(st.integers(1, 3), label=f"hit-{i}")
                for i in range(len(crashes))]
        roots = [tempfile.mkdtemp(prefix="ingest-diff-") for _ in range(2)]
        opts = dict(lease_s=10.0, backoff_s=0.5, max_attempts=50)
        sides = [_Side(port_ingest, port_faults, NKSEngine, roots[0], docs,
                       6, **opts),
                 _Side(ref_ingest, ref_faults, RefEngine, roots[1], docs, 6,
                       **opts)]
        record: list[str] = []
        spawned = 0

        def spawn():
            nonlocal spawned
            crash = {crashes[spawned]: hits[spawned]} \
                if spawned < len(crashes) else None
            batch = data.draw(st.integers(2, 7), label=f"batch-{spawned}")
            for side in sides:
                side.spawn(f"w{spawned}", crash, batch)
            spawned += 1

        try:
            spawn()
            for _ in range(60 * (n_docs + 4)):
                drained = [side.store.drained() for side in sides]
                assert drained[0] == drained[1]
                if drained[0]:
                    break
                act = data.draw(st.integers(0, 6))
                if act == 0 and len(sides[0].workers) < 4:
                    spawn()
                    continue
                if act == 1:
                    dt = data.draw(st.sampled_from([0.5, 5.0, 20.0]))
                    for side in sides:
                        side.clk.advance(dt)
                    continue
                if not sides[0].workers:
                    spawn()
                i = data.draw(st.integers(0, len(sides[0].workers) - 1))
                _lockstep(sides, i, record)
            else:
                _drain_lockstep(sides, 80 * (n_docs + 4), record)
            drained = sides[1].store.drained()
            if not drained:
                drained = _drain_lockstep(sides, 80 * (n_docs + 4), record)
            assert sides[0].state() == sides[1].state()
            if drained and sides[1].store.counts()[FAILED] == 0:
                for side in sides:
                    ext2doc = {i: d for i, d in enumerate(side.seed_ids)}
                    ext2doc.update(side.store.ext_map())
                    _assert_corpus_matches(
                        side.eng, ext2doc, {d["doc_id"]: d for d in docs},
                        side.emb, [d["doc_id"] for d in docs])
        finally:
            for side in sides:
                side.eng.close()
                side.store.close()


def test_unknown_tenant_is_retried_as_transient_as_in_reference(tmp_path):
    """The reference's known fault, kept on purpose: when the seed corpus
    holds only tenant ``b``, a streamed batch holding a document of tenant
    ``a`` raises ``KeyError`` when it is assembled, the worker treats it as
    transient (reconciles the intent as reverted and re-queues the jobs
    with exponential backoff) and, with ``max_attempts=50``, the backoff
    outruns any step budget. Both packages end in the same state: the
    batch's jobs pending, the same error, attempts and ``not_before``."""
    docs, _ = _docs(40, tenants=("a", "b"), seed=7)
    seed = [d for d in docs if d["tenant"] == "b"][:6]
    a_doc = next(d for d in docs if d["tenant"] == "a")
    b_docs = [d for d in docs if d["tenant"] == "b"][6:9]
    stream = b_docs + [a_doc]
    sides = []
    for pkg, faults, cls in ((port_ingest, port_faults, NKSEngine),
                             (ref_ingest, ref_faults, RefEngine)):
        root = tmp_path / cls.__module__
        root.mkdir()
        side = _Side(pkg, faults, cls, str(root), seed + stream, len(seed),
                     lease_s=10.0, backoff_s=0.5, max_attempts=50)
        side.spawn("w0", None, 4)
        sides.append(side)
    record: list[str] = []
    for _ in range(200):
        _lockstep(sides, 0, record)
    states = [side.state() for side in sides]
    assert states[0] == states[1]
    jobs = sides[0].store.jobs
    assert not sides[0].store.drained()
    assert {j.state for j in jobs.values()} == {PENDING}
    want = "KeyError: \"unknown tenant 'a' (known: ['b'])\""
    assert all(j.error == want for j in jobs.values())
    # 11 claims in 200 steps of the fake clock (5.0 an idle step), the whole
    # batch each time; the 11th release put the jobs 0.5 * 2^10 ahead
    assert {j.attempts for j in jobs.values()} == {11}
    assert {j.not_before for j in jobs.values()} == {2052.0}
    assert sides[0].clk() == 1945.0 and record.count("progress") == 11
    assert sides[0].store.stats.retries == 44
    assert sides[0].eng.dataset.n == len(seed)       # nothing landed
    for side in sides:
        side.eng.close()
        side.store.close()


def _slow_insert_run(pkg, engine_cls, root):
    """Worker A records its intent and submits its batch; before the batch
    lands, the intent's lease runs out and worker B, finding it expired,
    reconciles it against the unmoved horizon: reverted, A's jobs pending
    again. Then A's insert lands and its ack finds no open intent. Returns
    what each step saw and the end state after a clean drain."""
    docs, _ = _docs(20, seed=31)
    emb = pkg.ProjectionEmbedder(D_OUT, [f"tag{i:03d}" for i in range(U)],
                                 d_raw=D_RAW, seed=2)
    seed_ds, _ = pkg.corpus_from_documents(docs[:6], emb)
    kw = dict(m=2, n_scales=4, seed=0, compact_min=10_000)
    if engine_cls is NKSEngine:
        kw["device"] = "cpu"
    eng = engine_cls(seed_ds, **kw)
    clk = FakeClock()
    store = pkg.JobStore(os.path.join(root, "j.jsonl"), lease_s=10.0,
                         backoff_s=0.5, clock=clk)
    store.add(docs[6:])
    seen = []
    b = pkg.IngestWorker("b", store, eng, emb, batch_docs=4)

    class SlowSink(pkg.EngineSink):
        """The insert is slow: the lease ends and B steps before it lands."""

        def insert(self, points, keywords, attrs, tenant):
            clk.advance(10.5)
            seen.append(("b", b.step(), b.step()))     # stage, then insert
            return super().insert(points, keywords, attrs, tenant)

    a = pkg.IngestWorker("a", store, SlowSink(eng), emb, batch_docs=4)
    with pytest.raises(pkg.InvalidTransition) as err:
        a.step()
    seen.append(("a", str(err.value)))
    final = pkg.IngestWorker("final", store, eng, emb, batch_docs=4)
    _drive(final, store, clk)
    ext = [int(e) for e in np.asarray(eng._ext_of)]
    state = (_state(store), seen, dataclasses_dict(b.stats),
             dataclasses_dict(final.stats), ext,
             np.asarray(eng.dataset.points).tolist())
    eng.close()
    store.close()
    return state, docs


def test_insert_outlasting_its_intent_lease_lands_twice_as_in_reference(
        tmp_path):
    """The reference's exactly-once insert holds only while an insert lands
    within its intent's lease: a worker that finds the lease expired
    reconciles against a horizon the in-flight batch has not moved yet,
    reverts it, and the batch, which then lands, is inserted again on the
    retry; the slow worker's ack raises ``InvalidTransition``. Kept by the
    port on purpose; both packages end in the same state."""
    states = []
    for pkg, cls in ((port_ingest, NKSEngine), (ref_ingest, RefEngine)):
        root = tmp_path / cls.__module__
        root.mkdir()
        states.append(_slow_insert_run(pkg, cls, str(root)))
    (mine, _), (theirs, _) = states
    assert mine == theirs
    store_state, seen, b_stats, _, ext, _ = mine
    assert seen[0] == ("b", True, True)
    assert b_stats["reconciled_reverted"] == 1
    assert seen[1][1] == "intent 0 is not the open intent (None)"
    assert store_state[1][DONE] == 14 and store_state[3] != {}
    # A's batch (4 documents) landed twice: 14 documents, 18 rows inserted
    assert len(ext) == 6 + 14 + 4
