"""The port's out-of-core store and bucket synopses against the reference,
on the CPU.

The cases of the reference's ``tests/test_store.py`` through both packages
on the same seeded corpora (``synthetic_dataset(n=300, d=8, u=12, t=2,
seed=7)`` with ``attach_attrs``, and ``synthetic_tenants``):

  * the synopses (counts, radii, attribute and tenant ranges) of the port's
    host build and of its device build (``device="cpu"``: K5's plain
    version) equal the reference's ``build_synopsis`` bit for bit, per scale
    and flavour;
  * ``build_store`` writes the reference's ``meta.json`` exactly: leaves,
    shapes, dtypes and sha256;
  * each package's ``from_store`` opens the other's store, and the answers
    pair as everywhere in the port (port numpy ≡ reference numpy, port
    torch ≡ reference Pallas on the device route) across both tiers, the
    filters, the tenants and an insert/delete/compact interleaving;
  * zone pruning and the radius substitution fire, their counters equal
    the reference's, and the answers equal those with both prunes off;
  * ``resident_budget_bytes`` reaches the backend's cache, cold reads on
    the numpy backend equal the reference's, a damaged store raises
    ``IOError``, and with no card and no ``device`` the entry points raise.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import store as ref_store
from repro.core.backend import PallasBackend
from repro.core.index import build_index as ref_build_index
from repro.data.synthetic import attach_attrs as ref_attach_attrs
from repro.data.synthetic import random_queries as ref_queries
from repro.data.synthetic import synthetic_dataset as ref_synth
from repro.data.synthetic import synthetic_tenants as ref_tenants
from repro.serve.engine import NKSEngine as RefEngine
from repro_torch.core import store
from repro_torch.core.index import build_index
from repro_torch.core.index_build import build_indices
from repro_torch.core.types import make_dataset
from repro_torch.data.synthetic import (attach_attrs, synthetic_dataset,
                                        synthetic_tenants)
from repro_torch.serve.engine import NKSEngine

torch.set_num_threads(1)

BUILD = dict(m=2, n_scales=5, seed=0)
CORPUS = dict(n=300, d=8, u=12, t=2, seed=7)
TENANTS = ({"acme": 150, "globex": 120}, dict(d=6, u=10, t=2, seed=5))


def _keys(results):
    return [[c.key() for c in r.candidates] for r in results]


def _answers(engine, queries, backend, k=2, **kw):
    """Candidate keys across both tiers — the bit-parity fingerprint."""
    return [_keys(engine.query_batch(queries, k=k, tier=tier,
                                     backend=backend, **kw))
            for tier in ("exact", "approx")]


def _pallas():
    return PallasBackend(route="device", interpret=True)


def _pairs(port, ref, queries, **kw):
    """Port numpy against reference numpy, port torch against the
    reference's Pallas backend on the device route."""
    assert _answers(port, queries, "numpy", **kw) == \
        _answers(ref, queries, "numpy", **kw)
    assert _answers(port, queries, "torch", **kw) == \
        _answers(ref, queries, _pallas(), **kw)


@pytest.fixture(scope="module")
def corpora():
    return (ref_attach_attrs(ref_synth(**CORPUS), seed=1),
            attach_attrs(synthetic_dataset(**CORPUS), seed=1))


@pytest.fixture(scope="module")
def tenant_corpora():
    sizes, kw = TENANTS
    return ref_tenants(sizes, **kw), synthetic_tenants(sizes, **kw)


@pytest.fixture(scope="module")
def roots(corpora, tmp_path_factory):
    """The same corpus's store as each package writes it."""
    rds, tds = corpora
    base = tmp_path_factory.mktemp("stores")
    ref_root, port_root = str(base / "ref"), str(base / "port")
    ref_store.build_store(ref_root, rds, **BUILD)
    store.build_store(port_root, tds, device="cpu", **BUILD)
    return {"ref": ref_root, "port": port_root}


@pytest.fixture(scope="module")
def queries(corpora):
    rds, _ = corpora
    return ref_queries(rds, 2, 6, seed=3) + ref_queries(rds, 3, 4, seed=4)


def _syn_equal(mine, theirs):
    assert (mine is None) == (theirs is None)
    for f in ("counts", "radius", "tenant_min", "tenant_max"):
        a, b = getattr(mine, f), getattr(theirs, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b)
    for f in ("attr_min", "attr_max"):
        a, b = getattr(mine, f), getattr(theirs, f)
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].dtype == b[name].dtype
            np.testing.assert_array_equal(a[name], b[name])


# ------------------------------------------------------------------ synopses
@pytest.mark.parametrize("build", ["host", "device"])
@pytest.mark.parametrize("kind", ["attrs", "tenants"])
def test_synopses_equal_reference(corpora, tenant_corpora, kind, build):
    rds, tds = corpora if kind == "attrs" else tenant_corpora
    if build == "device":
        port = build_indices(tds, torch.from_numpy(tds.points),
                             synopsis=True, **BUILD)
    else:
        port = [build_index(tds, exact=e, synopsis=True, **BUILD)
                for e in (True, False)]
    for exact, mine in zip((True, False), port):
        ref = ref_build_index(rds, exact=exact, synopsis=True, **BUILD)
        for a, b in zip(mine.structures, ref.structures):
            _syn_equal(a.synopsis, b.synopsis)
            assert a.nbytes() == b.nbytes()
    assert build_index(tds, **BUILD).structures[0].synopsis is None


# --------------------------------------------------------------- the layout
@pytest.mark.parametrize("kind", ["attrs", "tenants"])
def test_store_meta_equals_reference(corpora, tenant_corpora, tmp_path,
                                     kind):
    rds, tds = corpora if kind == "attrs" else tenant_corpora
    ref_store.build_store(str(tmp_path / "ref"), rds, **BUILD)
    store.build_store(str(tmp_path / "port"), tds, device="cpu", **BUILD)
    metas = [json.loads((tmp_path / w / "meta.json").read_text())
             for w in ("ref", "port")]
    assert metas[1] == metas[0]
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))
    assert store.store_nbytes(str(tmp_path / "port")) == \
        ref_store.store_nbytes(str(tmp_path / "ref"))


def test_store_roundtrip_mmap_layout(corpora, roots):
    _, tds = corpora
    st = store.load_store(roots["port"], mmap=True)
    assert isinstance(st["dataset"].points, np.memmap)
    np.testing.assert_array_equal(np.asarray(st["dataset"].points),
                                  tds.points)
    np.testing.assert_array_equal(np.asarray(st["dataset"].attrs["price"]),
                                  tds.attrs["price"])
    for flavour in ("index_e", "index_a"):
        for hi in st[flavour].structures:
            assert isinstance(hi.table.values, np.memmap)
            # synopses load resident: the planner reads them per bucket
            assert not isinstance(hi.synopsis.radius, np.memmap)
            assert len(hi.synopsis.radius) == hi.n_buckets
    assert st["build_params"]["synopsis"] is True
    store.load_store(roots["port"], mmap=False, verify=True)


# ----------------------------------------------------- answers across stores
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_from_store_answers_across_packages(corpora, roots, queries,
                                            writer):
    """Each package opens the store the other (or it) wrote; answers pair
    unfiltered and under three filters, and equal a RAM engine's."""
    _, tds = corpora
    port = NKSEngine.from_store(roots[writer], device="cpu")
    ref = RefEngine.from_store(roots[writer])
    assert isinstance(port.dataset.points, np.memmap)
    for flt in (None, {"where": [["price", "<", 30.0]]},
                {"where": [["price", "<", 5.0]]},
                {"where": [["category", "==", 3]]}):
        _pairs(port, ref, queries, filter=flt)
    ram = NKSEngine(tds, synopsis=True, device="cpu", **BUILD)
    assert _answers(port, queries, "torch") == \
        _answers(ram, queries, "torch")


def test_from_store_tenants_across_packages(tenant_corpora, tmp_path):
    rds, tds = tenant_corpora
    roots = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    ref_store.build_store(roots["ref"], rds, **BUILD)
    store.build_store(roots["port"], tds, device="cpu", **BUILD)
    queries = [[0, 1], [1, 2], [0, 3]]
    for writer, reader in (("ref", "port"), ("port", "ref")):
        port = NKSEngine.from_store(roots[writer], device="cpu")
        ref = RefEngine.from_store(roots[reader])
        for tenant in ("acme", "globex"):
            for flt in ({"tenant": tenant},
                        {"tenant": tenant, "where": [["price", "<", 40.0]]}):
                _pairs(port, ref, queries, filter=flt)


def test_from_store_streaming_across_packages(corpora, roots, queries):
    """Insert/delete/compact interleavings on the port opened over the
    reference's store, op for op against the reference opened over the
    port's: delta answers (where zone maps fall through for buckets with
    delta members) and a compaction that rebuilds the synopses."""
    rds, _ = corpora
    port = NKSEngine.from_store(roots["ref"], device="cpu",
                                auto_compact=False)
    ref = RefEngine.from_store(roots["port"], auto_compact=False)
    rng = np.random.default_rng(11)
    flt = {"where": [["price", "<", 50.0]]}
    for r in range(3):
        pts = rng.standard_normal((20, rds.dim)).astype(np.float32)
        kws = [sorted(rng.choice(rds.n_keywords, size=2,
                                 replace=False).tolist()) for _ in range(20)]
        attrs = {"price": rng.uniform(0.0, 100.0, size=20),
                 "category": rng.integers(0, 8, size=20)}
        assert port.insert(pts, kws, attrs=attrs).tolist() == \
            ref.insert(pts, kws, attrs=attrs).tolist()
        if r:
            dead = np.arange(rds.n + (r - 1) * 20, rds.n + (r - 1) * 20 + 5)
            assert port.delete(dead) == ref.delete(dead)
        assert _answers(port, queries, "numpy", filter=flt) == \
            _answers(ref, queries, "numpy", filter=flt)
    assert port.compact() and ref.compact()
    _pairs(port, ref, queries)
    _pairs(port, ref, queries, filter=flt)
    for index in (port.index_e, port.index_a):
        assert index.structures[0].synopsis is not None


# ------------------------------------------------------------------- prunes
def _spatial(pkg_synth, n=500, d=4, u=10, seed=5):
    """Uniform low-d corpus with a price column tracking coordinate 0: the
    random projections stay correlated with it, so zone maps prune."""
    ds = pkg_synth(n=n, d=d, u=u, t=2, seed=seed)
    return dataclasses.replace(
        ds, attrs={"price": (ds.points[:, 0] / 100.0).astype(np.float64)})


def _clustered(n_centers=30, per=8, jitter=2.0, spread=200.0, d=4, u=8,
               seed=0):
    """Tight clusters far apart: fine-scale buckets isolate a cluster, so
    their radii bound subset diameters below a live r_k."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, spread, (n_centers, d)).astype(np.float32)
    pts, kws = [], []
    for c in centers:
        for j in range(per):
            pts.append(c + rng.standard_normal(d).astype(np.float32) * jitter)
            kws.append(sorted({j % 2, int(rng.integers(2, u))}))
    return np.asarray(pts, np.float32), kws, u


@pytest.mark.parametrize("prune", ["zone", "radius"])
def test_prunes_fire_count_as_reference_and_keep_answers(prune):
    from repro.core.types import make_dataset as ref_make_dataset
    if prune == "zone":
        rds, tds = _spatial(ref_synth), _spatial(synthetic_dataset)
        build, queries, k = BUILD, ref_queries(rds, 2, 6, seed=2), 2
        kw = {"filter": {"where": [["price", "<", 25.0]]}}
        counter = "buckets_pruned_zonemap"
    else:
        pts, kws, u = _clustered()
        rds = ref_make_dataset(pts, kws, n_keywords=u)
        tds = make_dataset(pts, kws, n_keywords=u)
        build, queries, k, kw = dict(m=2, n_scales=8, seed=0, w0=0.5), \
            [[0, 1]] * 4, 2, {}
        counter = "buckets_pruned_radius"
    plain = NKSEngine(tds, synopsis=False, device="cpu", **build)
    port = NKSEngine(tds, synopsis=True, device="cpu", **build)
    ref = RefEngine(rds, synopsis=True, **build)
    fired = 0
    for tier in ("exact", "approx"):
        for mine, theirs in (("numpy", "numpy"), ("torch", _pallas())):
            got = _keys(port.query_batch(queries, k=k, tier=tier,
                                         backend=mine, **kw))
            n = getattr(port.last_batch_stats, counter)
            assert got == _keys(ref.query_batch(queries, k=k, tier=tier,
                                                backend=theirs, **kw))
            assert n == getattr(ref.last_batch_stats, counter)
            assert port.last_batch_stats.tiering[counter] == n
            assert got == _keys(plain.query_batch(queries, k=k, tier=tier,
                                                  backend=mine, **kw))
            assert getattr(plain.last_batch_stats, counter) == 0
            fired += n
    assert fired > 0


def test_zone_prune_erodes_under_delta_and_recovers():
    """A bucket holding delta members is never zone-rejected (its synopsis
    speaks for the bulk only): inserts into rejected buckets sag the
    counter, answers stay those of the synopsis-off twin, and compaction
    rebuilds the synopses — as in the reference."""
    ds = _spatial(synthetic_dataset)
    synop = NKSEngine(ds, synopsis=True, auto_compact=False, device="cpu",
                      **BUILD)
    plain = NKSEngine(ds, auto_compact=False, device="cpu", **BUILD)
    queries = ref_queries(_spatial(ref_synth), 2, 6, seed=2)
    flt = {"where": [["price", "<", 25.0]]}

    def pruned(eng):
        total = 0
        for tier in ("exact", "approx"):
            eng.query_batch(queries, k=2, tier=tier, filter=flt)
            total += eng.last_batch_stats.buckets_pruned_zonemap
        return total

    clean = pruned(synop)
    assert clean > 0 and pruned(plain) == 0
    hot = np.flatnonzero(ds.points[:, 0] >= 2500.0)
    picks = np.random.default_rng(8).choice(hot, size=60, replace=False)
    pts = ds.points[picks]
    kws = [ds.kw.row(int(i)).tolist() for i in picks]
    attrs = {"price": (pts[:, 0] / 100.0).astype(np.float64)}
    for eng in (synop, plain):
        eng.insert(pts, kws, attrs=attrs)
    assert pruned(synop) < clean
    assert _answers(synop, queries, "torch", filter=flt) == \
        _answers(plain, queries, "torch", filter=flt)
    assert synop.compact() and plain.compact()
    assert pruned(synop) > 0
    assert _answers(synop, queries, "torch", filter=flt) == \
        _answers(plain, queries, "torch", filter=flt)


# ------------------------------------------------------------ tiers, budget
def test_resident_budget_reaches_backend(corpora, roots):
    _, tds = corpora
    budget = max(1, tds.points.nbytes // 4)
    eng = NKSEngine.from_store(roots["port"], device="cpu",
                               resident_budget_bytes=budget)
    assert eng.resident_budget_bytes == budget
    assert eng.backend.cache_bytes == budget
    assert NKSEngine.from_store(roots["port"], device="cpu") \
        .backend.cache_bytes == 128 << 20


def test_cold_reads_equal_reference(corpora, roots):
    rds, _ = corpora
    queries = ref_queries(rds, 2, 4, seed=9)
    port = NKSEngine.from_store(roots["port"], device="cpu")
    ref = RefEngine.from_store(roots["ref"])
    for tier in ("exact", "approx"):
        port.query_batch(queries, k=2, tier=tier, backend="numpy")
        ref.query_batch(queries, k=2, tier=tier, backend="numpy")
        got = port.last_batch_stats.tiering
        assert got == ref.last_batch_stats.tiering
        assert got["cold_bytes_read"] > 0 or tier == "approx"
    # a resident corpus reads nothing cold
    ram = NKSEngine(_port_ds(rds), device="cpu", **BUILD)
    ram.query_batch(queries, k=2, tier="exact", backend="numpy")
    assert ram.last_batch_stats.cold_bytes_read == 0


def _port_ds(ds):
    return make_dataset(ds.points, [ds.kw.row(i).tolist()
                                    for i in range(ds.n)],
                        n_keywords=ds.n_keywords)


# --------------------------------------------------------------- corruption
def _damage_truncate(root, tds):
    path = f"{root}/points.npy"
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _damage_shape(root, tds):
    np.save(f"{root}/points.npy", tds.points[: tds.n // 2])


def _damage_missing(root, tds):
    os.remove(f"{root}/kw.values.npy")


def _damage_payload(root, tds):
    path = f"{root}/points.npy"
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - 8)
        f.write(b"\xff" * 8)


@pytest.mark.parametrize("damage,match,verify", [
    (_damage_truncate, None, False),
    (_damage_shape, "truncated or tampered", False),
    (_damage_missing, "unreadable", False),
    (_damage_payload, "checksum", True),
], ids=["truncated", "tampered-shape", "missing", "bad-checksum"])
def test_damaged_store_raises(corpora, tmp_path, damage, match, verify):
    _, tds = corpora
    root = str(tmp_path / "tree")
    store.build_store(root, tds, device="cpu", **BUILD)
    damage(root, tds)
    with pytest.raises(IOError, match=match):
        NKSEngine.from_store(root, device="cpu", mmap=not verify,
                             verify=verify)


def test_no_card_and_no_device_raises(roots, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NKSEngine.from_store(roots["port"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.build_store(str(tmp_path / "x"),
                          store.load_store(roots["port"])["dataset"])
