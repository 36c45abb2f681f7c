"""The port's write-ahead log, snapshots and recovery, on the CPU.

The counterparts of the reference's ``tests/test_wal.py`` and
``tests/test_snapshot.py``, case for case, at the same fault points, with
the port's engine on ``device="cpu"``: WAL framing, torn tails and mid-file
corruption, recovery parity after a mixed op sequence, the kill window
between the fsync and the ack, group commit (fsyncs counted per group, a
crash at the barrier), recovery after a torn tail, log rolling and its GC,
attributes and tenants through recovery, and the snapshot round trip. On
top: the log's bytes equal the reference's for the same records, and one op
sequence written by either package recovers in the other into an engine
that answers as the uninterrupted one does (port numpy ≡ reference numpy,
port torch ≡ reference Pallas on the device route).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core.backend import PallasBackend
from repro.data.synthetic import attach_attrs as ref_attach_attrs
from repro.data.synthetic import synthetic_dataset as ref_synth
from repro.serve import wal as ref_wal
from repro.serve.engine import NKSEngine as RefEngine
from repro_torch.core import brute_force, promish_e
from repro_torch.core.index import build_index
from repro_torch.data.synthetic import (attach_attrs, random_queries,
                                        synthetic_dataset, synthetic_tenants)
from repro_torch.serve import wal as walmod
from repro_torch.serve.engine import NKSEngine
from repro_torch.serve.faults import FaultPlan, InjectedCrash

torch.set_num_threads(1)


def _corpus(n=260, d=6, u=24, seed=3):
    return synthetic_dataset(n=n, d=d, u=u, t=2, seed=seed)


def _engine(ds, **kw):
    return NKSEngine(ds, device="cpu", **kw)


def _stream(rng, n_batches, batch, d, u):
    out = []
    for _ in range(n_batches):
        pts = rng.standard_normal((batch, d)).astype(np.float32)
        kws = [sorted(rng.choice(u, size=2, replace=False).tolist())
               for _ in range(batch)]
        out.append((pts, kws))
    return out


def _answers(engine, queries, k=2, backend="torch"):
    out = []
    for tier in ("exact", "approx"):
        for r in engine.query_batch(queries, k=k, tier=tier, backend=backend):
            out.append([c.key() for c in r.candidates])
    return out


# ------------------------------------------------------------------- framing
def test_wal_roundtrip_and_stats(tmp_path):
    path = str(tmp_path / "w.log")
    log = walmod.WriteAheadLog(path)
    recs = [{"op": "insert", "i": i, "blob": "x" * i} for i in range(7)]
    for r in recs:
        log.append(r)
    log.close()
    stats = walmod.WalStats()
    assert list(walmod.WriteAheadLog.replay(path, stats)) == recs
    assert stats.replayed == 7 and not stats.torn_tail
    assert log.stats.appends == 7 and log.stats.fsyncs == 7


def test_wal_bytes_equal_reference(tmp_path):
    """The same records framed by both packages give the same file, and
    each replays the other's."""
    rng = np.random.default_rng(0)
    recs = [{"op": "insert",
             "points": walmod.encode_array(
                 rng.standard_normal((3, 4)).astype(np.float32)),
             "tenant": walmod.encode_array(np.array([1, 0, 1], np.int32))},
            {"op": "delete", "ids": [1, 2]}, {"op": "compact",
                                              "generation": 1}]
    for pkg, name in ((walmod, "port.log"), (ref_wal, "ref.log")):
        log = pkg.WriteAheadLog(str(tmp_path / name))
        for r in recs:
            log.append(r)
        log.close()
    port, ref = (open(tmp_path / n, "rb").read()
                 for n in ("port.log", "ref.log"))
    assert port == ref
    assert list(ref_wal.WriteAheadLog.replay(str(tmp_path / "port.log"))) \
        == list(walmod.WriteAheadLog.replay(str(tmp_path / "ref.log"))) \
        == recs
    a = rng.standard_normal((2, 5))
    np.testing.assert_array_equal(walmod.decode_array(ref_wal.encode_array(a)),
                                  a)


def test_wal_torn_tail_stops_cleanly(tmp_path):
    path = str(tmp_path / "w.log")
    log = walmod.WriteAheadLog(path)
    for i in range(3):
        log.append({"i": i})
    log.close()
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-5])        # crash mid-append of record 2
    stats = walmod.WalStats()
    assert [r["i"] for r in walmod.WriteAheadLog.replay(path, stats)] == [0, 1]
    assert stats.torn_tail


def test_wal_midfile_corruption_raises(tmp_path):
    path = str(tmp_path / "w.log")
    log = walmod.WriteAheadLog(path)
    for i in range(3):
        log.append({"i": i, "pad": "p" * 50})
    log.close()
    blob = bytearray(open(path, "rb").read())
    blob[12] ^= 0xFF                          # inside record 0's payload
    open(path, "wb").write(bytes(blob))
    with pytest.raises(walmod.TornRecordError):
        list(walmod.WriteAheadLog.replay(path))


# ------------------------------------------------------------------ recovery
def test_recovery_parity_bit_identical(tmp_path):
    """Crash after a mixed acked op sequence (inserts, deletes, logged
    auto-compactions): the recovered engine answers bit-identically to an
    uninterrupted one on both tiers and both backends, and keeps doing so
    as the stream continues after recovery."""
    ds = _corpus()
    rng = np.random.default_rng(11)
    stream = _stream(rng, 6, 30, ds.dim, ds.n_keywords)
    queries = random_queries(ds, 2, 6, seed=13)

    wal_eng = _engine(ds, seed=5, compact_min=70, compact_ratio=0.05)
    wal_eng.attach_wal(str(tmp_path / "wal"))
    ref_eng = _engine(ds, seed=5, compact_min=70, compact_ratio=0.05)
    acked = []
    for i, (pts, kws) in enumerate(stream):
        ids = wal_eng.insert(pts, kws)
        acked.append(("insert", pts, kws, ids))
        if i % 2:
            dead = [int(ids[0]), int(ids[-1])]
            wal_eng.delete(dead)
            acked.append(("delete", dead))
    assert wal_eng.ingest.compactions >= 1      # cadence actually exercised
    assert wal_eng.wal_stats.appends == wal_eng.ingest.wal_appends
    wal_eng.close()                             # simulated process death

    rec = NKSEngine.recover(str(tmp_path / "wal"), device="cpu")
    for op in acked:
        if op[0] == "insert":
            np.testing.assert_array_equal(ref_eng.insert(op[1], op[2]),
                                          op[3])
        else:
            ref_eng.delete(op[1])
    assert rec.ingest.replayed_ops == len(acked) + rec.ingest.compactions
    assert rec.corpus_generation == ref_eng.corpus_generation
    for backend in ("torch", "numpy"):
        assert _answers(rec, queries, backend=backend) == \
            _answers(ref_eng, queries, backend=backend)

    pts, kws = _stream(rng, 1, 25, ds.dim, ds.n_keywords)[0]
    np.testing.assert_array_equal(rec.insert(pts, kws),
                                  ref_eng.insert(pts, kws))
    assert _answers(rec, queries) == _answers(ref_eng, queries)
    rec.close()


def test_kill_between_append_and_ack(tmp_path):
    """The wal_ack crash window: the op is durable but never acknowledged.
    Recovery applies it (at-least-once below the ack horizon) and every
    acknowledged op survives."""
    ds = _corpus(n=150)
    rng = np.random.default_rng(7)
    stream = _stream(rng, 4, 10, ds.dim, ds.n_keywords)
    queries = random_queries(ds, 2, 5, seed=1)

    faults = FaultPlan(crash={"wal_ack": 3})
    eng = _engine(ds, seed=2, compact_min=10_000)
    eng.attach_wal(str(tmp_path / "wal"), faults=faults)
    eng.insert(*stream[0])
    eng.insert(*stream[1])
    with pytest.raises(InjectedCrash):
        eng.insert(*stream[2])                 # durable, never acked
    assert faults.fired["wal_ack"] == 1

    rec = NKSEngine.recover(str(tmp_path / "wal"), device="cpu")
    ref = _engine(ds, seed=2, compact_min=10_000)
    for pts, kws in stream[:3]:
        ref.insert(pts, kws)
    assert rec.ingest.replayed_ops == 3
    assert _answers(rec, queries) == _answers(ref, queries)
    assert rec.next_external_id >= ds.n + len(stream[0][0]) \
        + len(stream[1][0])
    rec.close()


def test_compact_crash_leaves_old_generation(tmp_path):
    """The ``compact`` fault point fires mid-rebuild, after the compacted
    dataset exists: the engine still serves the old generation, and
    recovery replays the ops acknowledged before it."""
    ds = _corpus(n=150)
    rng = np.random.default_rng(5)
    stream = _stream(rng, 2, 10, ds.dim, ds.n_keywords)
    queries = random_queries(ds, 2, 5, seed=6)
    faults = FaultPlan(crash={"compact": 1})
    eng = _engine(ds, seed=2, compact_min=10_000, faults=faults)
    eng.attach_wal(str(tmp_path / "wal"))
    for pts, kws in stream:
        eng.insert(pts, kws)
    before = _answers(eng, queries)
    with pytest.raises(InjectedCrash):
        eng.compact()
    assert faults.fired["compact"] == 1 and eng.corpus_generation == 0
    assert eng.delta_points == 20 and _answers(eng, queries) == before
    rec = NKSEngine.recover(str(tmp_path / "wal"), device="cpu")
    assert rec.ingest.replayed_ops == 2 and rec.corpus_generation == 0
    assert _answers(rec, queries) == before


# -------------------------------------------------------------- group commit
def test_group_commit_one_fsync_per_group(tmp_path):
    ds = _corpus(n=150)
    rng = np.random.default_rng(9)
    stream = _stream(rng, 5, 8, ds.dim, ds.n_keywords)
    queries = random_queries(ds, 2, 5, seed=2)

    eng = _engine(ds, seed=2, compact_min=10_000)
    eng.attach_wal(str(tmp_path / "wal"))
    f0 = eng.wal_stats.fsyncs
    with eng.ingest_group():
        for pts, kws in stream:
            eng.insert(pts, kws)
    st = eng.wal_stats
    assert st.fsyncs - f0 == 1                 # the group barrier, nothing else
    assert st.group_commits == 1
    assert st.group_committed == len(stream)
    assert st.group_commit_batch == float(len(stream))
    tail = _stream(rng, 1, 4, ds.dim, ds.n_keywords)[0]
    with eng.ingest_group():
        with eng.ingest_group():
            eng.insert(*tail)
        assert eng.wal_stats.group_commits == 1    # inner exit: no barrier yet
    assert eng.wal_stats.group_commits == 2
    eng.close()

    rec = NKSEngine.recover(str(tmp_path / "wal"), device="cpu")
    ref = _engine(ds, seed=2, compact_min=10_000)
    for pts, kws in stream + [tail]:
        ref.insert(pts, kws)
    assert rec.ingest.replayed_ops == len(stream) + 1
    assert _answers(rec, queries) == _answers(ref, queries)
    rec.close()


def _tenant_corpus():
    return attach_attrs(synthetic_tenants({"a": 70, "b": 50}, d=5, u=15,
                                          t=2, seed=6), seed=6)


def _tenant_batches(ds, rng):
    out = []
    for tenant in ("a", "b", "a"):
        pts = rng.standard_normal((6, ds.dim)).astype(np.float32)
        kws = [ds.tenants.resolve(tenant, sorted(rng.choice(15, 2,
                                                            replace=False)))
               for _ in range(6)]
        attrs = {"price": rng.uniform(0, 100, 6),
                 "category": rng.integers(0, 5, 6)}
        out.append((tenant, pts, kws, attrs))
    return out


@pytest.mark.parametrize("kind", ["plain", "attrs-tenants"])
def test_group_commit_crash_at_barrier(tmp_path, kind):
    """A crash at the group's fsync barrier: every record in the group is
    durable but none was acknowledged — recovery replays them all, with
    the attribute columns and tenant ids bit for bit."""
    rng = np.random.default_rng(13 if kind == "plain" else 21)
    if kind == "plain":
        ds = _corpus(n=150)
        batches = [(None, pts, kws, None)
                   for pts, kws in _stream(rng, 3, 6, ds.dim, ds.n_keywords)]
    else:
        ds = _tenant_corpus()
        batches = _tenant_batches(ds, rng)
    faults = FaultPlan(crash={"wal_ack": 1})
    eng = _engine(ds, seed=4, compact_min=10_000)
    eng.attach_wal(str(tmp_path / "wal"), faults=faults)
    with pytest.raises(InjectedCrash):
        with eng.ingest_group():
            for tenant, pts, kws, attrs in batches:
                eng.insert(pts, kws, attrs=attrs, tenant=tenant)
    assert faults.fired["wal_ack"] == 1
    assert eng.wal_stats.fsyncs == 1           # the barrier ran before the kill

    rec = NKSEngine.recover(str(tmp_path / "wal"), device="cpu")
    ref = _engine(ds, seed=4, compact_min=10_000)
    for tenant, pts, kws, attrs in batches:
        ref.insert(pts, kws, attrs=attrs, tenant=tenant)
    assert rec.ingest.replayed_ops == len(batches)
    np.testing.assert_array_equal(rec.dataset.points, ref.dataset.points)
    if kind == "plain":
        queries = random_queries(ds, 2, 5, seed=3)
        assert _answers(rec, queries) == _answers(ref, queries)
        return
    for col in ("price", "category"):
        np.testing.assert_array_equal(rec.dataset.attr_column(col),
                                      ref.dataset.attr_column(col))
    np.testing.assert_array_equal(rec.dataset.tenant_ids,
                                  ref.dataset.tenant_ids)
    for flt in ({"tenant": "a", "where": [["price", "<", 60.0]]},
                {"tenant": "b"},
                {"tenant": "a", "where": [["category", "in", [0, 1, 2]]]}):
        got = rec.query([0, 1], k=3, tier="exact", filter=flt)
        want = ref.query([0, 1], k=3, tier="exact", filter=flt)
        assert [c.key() for c in got.candidates] == \
            [c.key() for c in want.candidates]
    rec.close()


def test_recover_append_recover_after_torn_tail(tmp_path):
    """Crash mid-append, recover, keep writing, crash again: the first
    recovery truncates the torn tail before reopening the segment, so the
    second recovery finds no mid-file CRC mismatch."""
    ds = _corpus(n=150)
    rng = np.random.default_rng(17)
    stream = _stream(rng, 3, 8, ds.dim, ds.n_keywords)
    queries = random_queries(ds, 2, 5, seed=4)
    root = str(tmp_path / "wal")

    eng = _engine(ds, seed=6, compact_min=10_000)
    eng.attach_wal(root)
    eng.insert(*stream[0])
    eng.insert(*stream[1])
    eng.close()
    path = walmod.wal_path(root, 0)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-5])

    rec1 = NKSEngine.recover(root, device="cpu")
    assert rec1.ingest.replayed_ops == 1
    assert rec1.wal_stats.torn_tail
    tail = os.path.getsize(path)
    rec1.insert(*stream[2])
    assert os.path.getsize(path) > tail
    rec1.close()

    rec2 = NKSEngine.recover(root, device="cpu")
    assert rec2.ingest.replayed_ops == 2
    ref = _engine(ds, seed=6, compact_min=10_000)
    ref.insert(*stream[0])
    ref.insert(*stream[2])
    assert _answers(rec2, queries) == _answers(ref, queries)
    rec2.close()


def test_snapshot_rolls_log_and_gcs(tmp_path):
    ds = _corpus(n=120)
    rng = np.random.default_rng(3)
    stream = _stream(rng, 5, 12, ds.dim, ds.n_keywords)
    queries = random_queries(ds, 2, 5, seed=2)
    root = str(tmp_path / "wal")

    eng = _engine(ds, seed=9, compact_min=10_000)
    ref = _engine(ds, seed=9, compact_min=10_000)
    eng.attach_wal(root)
    for pts, kws in stream[:3]:
        eng.insert(pts, kws)
        ref.insert(pts, kws)
    snap = eng.snapshot()
    assert eng.ingest.snapshots == 1
    for pts, kws in stream[3:]:
        eng.insert(pts, kws)
        ref.insert(pts, kws)
    eng.close()

    assert walmod.read_manifest(root)["epoch"] == 1
    assert not os.path.exists(walmod.snap_dir(root, 0))
    assert not os.path.exists(walmod.wal_path(root, 0))
    assert os.path.isdir(snap)

    rec = NKSEngine.recover(root, device="cpu")
    assert rec.ingest.replayed_ops == 2
    assert _answers(rec, queries) == _answers(ref, queries)
    rec.close()


def test_recovery_preserves_attrs_and_tenants(tmp_path):
    ds = _tenant_corpus()
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((8, ds.dim)).astype(np.float32)
    kws = [ds.tenants.resolve("a", [0, 1]) for _ in range(8)]
    attrs = {"price": rng.uniform(0, 100, 8),
             "category": rng.integers(0, 5, 8)}
    flt = {"tenant": "a", "where": [["price", "<", 200]]}

    eng = _engine(ds, seed=4, compact_min=10_000)
    eng.attach_wal(str(tmp_path / "wal"))
    eng.insert(pts, kws, attrs=attrs, tenant="a")
    ref = _engine(ds, seed=4, compact_min=10_000)
    ref.insert(pts, kws, attrs=attrs, tenant="a")
    eng.close()

    rec = NKSEngine.recover(str(tmp_path / "wal"), device="cpu")
    for tier in ("exact", "device"):
        got = rec.query([0, 1], k=3, tier=tier, filter=flt)
        want = ref.query([0, 1], k=3, tier=tier, filter=flt)
        assert [c.key() for c in got.candidates] == \
            [c.key() for c in want.candidates]
    rec.close()


def test_attach_wal_requires_clean_start(tmp_path):
    ds = _corpus(n=100)
    eng = _engine(ds, seed=1)
    eng.attach_wal(str(tmp_path / "wal"))
    with pytest.raises(RuntimeError):
        eng.attach_wal(str(tmp_path / "other"))
    eng.close()
    with pytest.raises(RuntimeError, match="requires an attached WAL"):
        _engine(ds, seed=1).snapshot()


# ------------------------------------------------------------------ snapshots
def _roundtrip(tmp_path, ds, idx, **load_kw):
    snap = str(tmp_path / "snap")
    walmod.save_snapshot(snap, dataset=ds, index_e=idx, index_a=None,
                         build_params={"m": 2}, engine_meta={"next_ext": ds.n})
    return walmod.load_snapshot(snap, **load_kw)


def test_snapshot_roundtrip_query_equivalence(tmp_path):
    ds = synthetic_dataset(n=400, d=8, u=20, t=2, seed=3)
    idx = build_index(ds, m=2, n_scales=4, exact=True, seed=1)
    out = _roundtrip(tmp_path, ds, idx, mmap=True)
    ds2, idx2 = out["dataset"], out["index_e"]
    assert out["index_a"] is None
    assert out["build_params"] == {"m": 2}
    assert out["engine"]["next_ext"] == ds.n
    np.testing.assert_array_equal(np.asarray(ds2.points), ds.points)
    for query in random_queries(ds, 3, 4, seed=7):
        mem = promish_e.search(ds, idx, query, k=2)
        dsk = promish_e.search(ds2, idx2, query, k=2)
        truth = brute_force.search(ds, query, k=2)
        assert [c.key() for c in dsk.items] == [c.key() for c in mem.items]
        np.testing.assert_allclose([c.diameter for c in dsk.items],
                                   [c.diameter for c in truth.items],
                                   rtol=1e-4)


def test_snapshot_is_mmapped_and_opens_in_reference(tmp_path):
    ds = synthetic_dataset(n=100, d=4, u=10, t=1, seed=0)
    idx = build_index(ds, m=2, n_scales=3, exact=False, seed=0)
    snap = str(tmp_path / "snap")
    walmod.save_snapshot(snap, dataset=ds, index_e=None, index_a=idx,
                         build_params={}, engine_meta={})
    out = walmod.load_snapshot(snap, mmap=True)
    assert isinstance(out["dataset"].points, np.memmap)
    assert isinstance(out["index_a"].structures[0].table.values, np.memmap)
    theirs = ref_wal.load_snapshot(snap, verify=True)
    for a, b in zip(out["index_a"].structures, theirs["index_a"].structures):
        np.testing.assert_array_equal(a.table.values, b.table.values)
        np.testing.assert_array_equal(a.khb.offsets, b.khb.offsets)


def test_snapshot_preserves_attrs_and_tenants(tmp_path):
    ds = attach_attrs(synthetic_tenants({"a": 60, "b": 40}, d=4, u=12, t=2,
                                        seed=5), seed=5)
    idx = build_index(ds, m=2, n_scales=3, exact=True, seed=1)
    ds2 = _roundtrip(tmp_path, ds, idx)["dataset"]
    assert set(ds2.attrs) == set(ds.attrs)
    for name in ds.attrs:
        np.testing.assert_array_equal(np.asarray(ds2.attrs[name]),
                                      np.asarray(ds.attrs[name]))
    np.testing.assert_array_equal(np.asarray(ds2.tenant_of), ds.tenant_of)
    assert ds2.tenants.names == ds.tenants.names
    np.testing.assert_array_equal(np.asarray(ds2.tenants.kw_offsets),
                                  ds.tenants.kw_offsets)


def test_snapshot_detects_corruption(tmp_path):
    ds = synthetic_dataset(n=80, d=4, u=10, t=1, seed=2)
    idx = build_index(ds, m=2, n_scales=3, exact=True, seed=0)
    snap = str(tmp_path / "snap")
    walmod.save_snapshot(snap, dataset=ds, index_e=idx, index_a=None,
                         build_params={}, engine_meta={})
    with open(os.path.join(snap, "meta.json")) as f:
        leaf = sorted(json.load(f)["leaves"])[0]
    path = os.path.join(snap, leaf + ".npy")
    blob = bytearray(open(path, "rb").read())
    blob[-8] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        walmod.load_snapshot(snap, verify=True)


def test_snapshot_write_is_atomic(tmp_path):
    ds = synthetic_dataset(n=60, d=4, u=10, t=1, seed=1)
    idx = build_index(ds, m=2, n_scales=3, exact=True, seed=0)
    snap = str(tmp_path / "snap")
    walmod.save_snapshot(snap, dataset=ds, index_e=idx, index_a=None,
                         build_params={"gen": 1}, engine_meta={})
    walmod.save_snapshot(snap, dataset=ds, index_e=idx, index_a=None,
                         build_params={"gen": 2}, engine_meta={})
    assert walmod.load_snapshot(snap)["build_params"] == {"gen": 2}
    assert [d for d in os.listdir(tmp_path)
            if d.startswith(".tmp-snap-")] == []


# ------------------------------------------------- across the two packages
def _drive(eng, ds, seed):
    """One op sequence: attributed inserts, a snapshot, a group, deletes
    (bulk and delta), a compaction, more inserts."""
    rng = np.random.default_rng(seed)

    def batch(n):
        pts = rng.standard_normal((n, ds.dim)).astype(np.float32) * 30
        kws = [sorted(rng.choice(ds.n_keywords, size=2,
                                 replace=False).tolist()) for _ in range(n)]
        attrs = {"price": rng.uniform(0.0, 100.0, size=n),
                 "category": rng.integers(0, 8, size=n)}
        return pts, kws, attrs

    for _ in range(2):
        pts, kws, attrs = batch(15)
        eng.insert(pts, kws, attrs=attrs)
    eng.snapshot()
    with eng.ingest_group():
        for _ in range(2):
            pts, kws, attrs = batch(10)
            eng.insert(pts, kws, attrs=attrs)
    eng.delete([3, 7, ds.n + 31, ds.n + 40])
    eng.compact()
    pts, kws, attrs = batch(12)
    eng.insert(pts, kws, attrs=attrs)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_recovery_across_packages(tmp_path, writer):
    """An op sequence logged by one package recovers in the other; both
    recovered engines answer as the uninterrupted writer does, per
    counterpart backend, unfiltered and filtered."""
    kw = dict(n=300, d=8, u=12, t=2, seed=7)
    rds = ref_attach_attrs(ref_synth(**kw), seed=1)
    tds = attach_attrs(synthetic_dataset(**kw), seed=1)
    root = str(tmp_path / "wal")
    opts = dict(seed=0, auto_compact=False)
    live = RefEngine(rds, **opts) if writer == "ref" else _engine(tds, **opts)
    live.attach_wal(root)
    _drive(live, rds, 9)
    live.close()
    port = NKSEngine.recover(root, device="cpu")
    ref = RefEngine.recover(root)
    assert port.ingest.replayed_ops == ref.ingest.replayed_ops == 5
    assert port.ingest.as_dict() == ref.ingest.as_dict()
    np.testing.assert_array_equal(port._ext_of, ref._ext_of)
    queries = random_queries(tds, 2, 6, seed=3)
    pallas = PallasBackend(route="device", interpret=True)
    for flt in (None, {"where": [["price", "<", 50.0]]}):
        for tier in ("exact", "approx"):
            for mine, theirs in (("numpy", "numpy"), ("torch", pallas)):
                want = [[c.key() for c in r.candidates]
                        for r in live.query_batch(queries, k=2, tier=tier,
                                                  backend=theirs
                                                  if writer == "ref"
                                                  else mine, filter=flt)]
                for eng, be in ((port, mine), (ref, theirs)):
                    got = eng.query_batch(queries, k=2, tier=tier,
                                          backend=be, filter=flt)
                    assert [[c.key() for c in r.candidates]
                            for r in got] == want, (tier, mine, flt)


def test_recover_without_card_or_device_raises(tmp_path, monkeypatch):
    eng = _engine(_corpus(n=80), seed=1)
    eng.attach_wal(str(tmp_path / "wal"))
    eng.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NKSEngine.recover(str(tmp_path / "wal"))
