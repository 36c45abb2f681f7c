"""The port's filtered and tenant-scoped serving against the reference, on
the CPU.

The cases of the reference's ``tests/test_filtered.py``, driven through both
packages on the same seeded corpora (n=300, d=8) at selectivities 1.0, 0.5,
0.1, 0.01 and 0.0. Answers must be identical — ids and bitwise-equal float64
diameters — per backend pair: the port's numpy backend against the
reference's, the port's torch backend (``device="cpu"``: the kernels' plain
versions) in fold mode and in eligible-dense mode, with the prune tier on and
off, against the reference's Pallas backend pinned to the device route. Both
device backends settle every candidate in float64 after an fp32 pruning
filter, so fp32 rounding never reaches an answer. The device tier must
answer as the reference's does (ids equal, diameters within the fp32 band of
``core.distributed.diameter_band``) and name only eligible points. Also: the
eligibility fold's transfer contract (no new device-to-host bytes), filtered
streaming op for op against the reference engine, tenant scoping and its
namespace errors, and the filter grammar. The reference engine is handed
each filter in its JSON form (it takes its own ``Filter`` class or that).
"""
import json

import numpy as np
import pytest
import torch

from repro.core.backend import PallasBackend
from repro.data.synthetic import attach_attrs as ref_attach_attrs
from repro.data.synthetic import random_queries as ref_queries
from repro.data.synthetic import synthetic_attrs as ref_synthetic_attrs
from repro.data.synthetic import synthetic_dataset as ref_synth
from repro.data.synthetic import synthetic_tenants as ref_synthetic_tenants
from repro.serve.engine import NKSEngine as RefEngine
from repro_torch.core import backend as tbackend
from repro_torch.core.backend import NumpyBackend, TorchBackend
from repro_torch.core.device_plane import pack_groups
from repro_torch.core.distributed import diameter_band
from repro_torch.core.filters import Clause, Filter, where
from repro_torch.core.subset_search import unpack_join_mask
from repro_torch.core.types import make_dataset
from repro_torch.data.synthetic import (attach_attrs, synthetic_attrs,
                                        synthetic_dataset, synthetic_tenants)
from repro_torch.serve.engine import NKSEngine

torch.set_num_threads(1)

SELECTIVITIES = (1.0, 0.5, 0.1, 0.01, 0.0)


def _cands(results):
    return [[(c.ids, c.diameter) for c in r.candidates] for r in results]


def _price(sel):
    return where(("price", "<", 100.0 * sel))


@pytest.fixture(scope="module")
def corpora():
    kw = dict(n=300, d=8, u=12, t=2, seed=7)
    return (ref_attach_attrs(ref_synth(**kw), seed=1),
            attach_attrs(synthetic_dataset(**kw), seed=1))


@pytest.fixture(scope="module")
def engines(corpora):
    rds, tds = corpora
    return (RefEngine(rds, m=2, n_scales=5, seed=0),
            NKSEngine(tds, m=2, n_scales=5, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def queries(corpora):
    rds, _ = corpora
    return ref_queries(rds, 2, 6, seed=3) + ref_queries(rds, 3, 4, seed=4)


def test_attribute_generators_match_reference(corpora):
    rds, tds = corpora
    np.testing.assert_array_equal(tds.points, rds.points)
    assert sorted(tds.attrs) == sorted(rds.attrs)
    for name in rds.attrs:
        assert tds.attrs[name].dtype == rds.attrs[name].dtype
        np.testing.assert_array_equal(tds.attrs[name], rds.attrs[name])
    for name, col in synthetic_attrs(50, seed=4).items():
        np.testing.assert_array_equal(col, ref_synthetic_attrs(50, seed=4)[name])
    mt, rmt = (gen({"acme": 30, "globex": 40}, d=4, u=6, t=2, seed=2)
               for gen in (synthetic_tenants, ref_synthetic_tenants))
    np.testing.assert_array_equal(mt.points, rmt.points)
    np.testing.assert_array_equal(mt.tenant_of, rmt.tenant_of)
    np.testing.assert_array_equal(mt.kw.values, rmt.kw.values)
    np.testing.assert_array_equal(mt.tenants.kw_offsets,
                                  rmt.tenants.kw_offsets)
    assert mt.tenants.names == rmt.tenants.names


@pytest.mark.parametrize("tier", ["exact", "approx"])
@pytest.mark.parametrize("sel", SELECTIVITIES)
def test_numpy_backend_matches_reference(engines, corpora, queries, sel,
                                         tier):
    ref_engine, engine = engines
    flt = _price(sel)
    want = ref_engine.query_batch(queries, k=2, tier=tier, backend="numpy",
                                  filter=flt.as_json())
    got = engine.query_batch(queries, k=2, tier=tier, backend="numpy",
                             filter=flt)
    assert _cands(got) == _cands(want)
    eligible = flt.evaluate(corpora[1])
    for r in got:
        for c in r.candidates:
            assert eligible[list(c.ids)].all()
    st, rst = engine.last_batch_stats, ref_engine.last_batch_stats
    assert st.eligible_points == rst.eligible_points == int(eligible.sum())
    assert st.filter_selectivity == rst.filter_selectivity
    assert st.filtered_subsets == rst.filtered_subsets
    assert [s.filtered_subsets for s in st.scales] == \
        [s.filtered_subsets for s in rst.scales]
    if sel < 1.0:
        assert st.filtered_subsets > 0
    if sel == 0.0:
        assert all(r.candidates == [] for r in got)


class _EligSpy:
    """Records, per ``kernels.ops`` join entry point the backend calls,
    whether it was handed eligibility words."""

    def __init__(self, monkeypatch):
        self.calls = {"masked": [], "counts": []}
        for key, name in (("masked", "pairwise_l2_join_batched_masked"),
                          ("counts", "pairwise_l2_join_batched_counts")):
            fn = getattr(tbackend.ops, name)

            def spy(x, lengths, r, elig=None, _fn=fn, _key=key, **kw):
                self.calls[_key].append(elig is not None)
                return _fn(x, lengths, r, elig, **kw)
            monkeypatch.setattr(tbackend.ops, name, spy)


@pytest.mark.parametrize("prune", ["off", "on"])
@pytest.mark.parametrize("mode", ["fold", "dense"])
@pytest.mark.parametrize("sel", SELECTIVITIES)
def test_torch_backend_matches_pallas(engines, queries, sel, mode, prune,
                                      monkeypatch):
    """Fold mode (eligibility words into full-width tiles) and eligible-dense
    packing, forced by the threshold, with and without the bf16 prune tier:
    bit for bit the reference's Pallas backend on the device route."""
    ref_engine, engine = engines
    flt = _price(sel)
    threshold = 0.0 if mode == "fold" else 1.01
    spy = _EligSpy(monkeypatch)
    dispatched = {"fold": 0, "dense": 0}
    for tier in ("exact", "approx"):
        want = ref_engine.query_batch(
            queries, k=2, tier=tier, filter=flt.as_json(),
            backend=PallasBackend(route="device", prune_tier=prune))
        got = engine.query_batch(
            queries, k=2, tier=tier, filter=flt,
            backend=TorchBackend(device="cpu", route="device",
                                 prune_tier=prune,
                                 elig_pack_threshold=threshold))
        assert _cands(got) == _cands(want), tier
        assert engine.last_batch_stats.filtered_subsets == \
            ref_engine.last_batch_stats.filtered_subsets
        for m in dispatched:
            dispatched[m] += \
                engine.last_batch_stats.filtering[f"{m}_dispatches"]
    # every filtered device dispatch is counted under the forced mode
    other = "dense" if mode == "fold" else "fold"
    assert dispatched[other] == 0
    assert (dispatched[mode] > 0) == bool(spy.calls["masked"]
                                          or spy.calls["counts"])
    if sel >= 0.1:
        assert spy.calls["masked"], "no masked join was dispatched"
    # fold mode hands K1 (and K2) the words; dense packing never does
    assert set(spy.calls["masked"]) <= {mode == "fold"}
    assert set(spy.calls["counts"]) <= {mode == "fold"}
    if prune == "on" and sel >= 0.1:
        assert spy.calls["counts"]


def test_engine_torch_backend_matches_reference(engines, queries):
    """The engine's own backend (cost-model routing) under a filter, and a
    filter given in its JSON form."""
    ref_engine, engine = engines
    spec = {"where": [["price", "<", 60.0], ["category", "in", [0, 1, 3]]]}
    for tier in ("exact", "approx"):
        want = ref_engine.query_batch(queries, k=2, tier=tier, filter=spec,
                                      backend=PallasBackend(route="device"))
        assert _cands(engine.query_batch(queries, k=2, tier=tier,
                                         filter=spec)) == _cands(want)


def test_single_query_path_matches_batch(engines, queries):
    ref_engine, engine = engines
    flt = where(("price", "between", (20.0, 70.0)),
                ("category", "in", [0, 1, 2, 3, 4]))
    for tier in ("exact", "approx"):
        # the per-query path runs the batched pipeline on the numpy backend
        batch = engine.query_batch(queries[:4], k=2, tier=tier, filter=flt,
                                   backend="numpy")
        for q, want in zip(queries[:4], batch):
            got = engine.query(q, k=2, tier=tier, filter=flt)
            assert [(c.ids, c.diameter) for c in got.candidates] == \
                [(c.ids, c.diameter) for c in want.candidates]
            assert _cands([got]) == _cands(
                [ref_engine.query(q, k=2, tier=tier, filter=flt.as_json())])


def test_device_tier_respects_filter(engines, corpora, queries):
    ref_engine, engine = engines
    flt = where(("price", "<", 40.0))
    eligible = flt.evaluate(corpora[1])
    got = engine.query_batch(queries, k=2, tier="device", filter=flt)
    want = ref_engine.query_batch(queries, k=2, tier="device",
                                  filter=flt.as_json())
    for q, g, w in zip(queries, got, want):
        pg = pack_groups(engine.dataset, q, eligible=eligible)
        band = diameter_band(pg.groups, pg.mask)
        assert [c.ids for c in g.candidates] == [c.ids for c in w.candidates]
        for cg, cw in zip(g.candidates, w.candidates):
            assert eligible[list(cg.ids)].all()
            assert abs(cg.diameter - cw.diameter) \
                <= 1e-5 * abs(cw.diameter) + band
    assert engine.last_batch_stats.eligible_points == int(eligible.sum())
    single = engine.query(queries[0], k=2, tier="device", filter=flt)
    assert _cands([single]) == _cands(got[:1])
    # 0% selectivity: the dispatch is skipped, results empty
    zero = engine.query_batch(queries[:2], k=1, tier="device",
                              filter=where(("price", "<", -1.0)))
    assert all(r.candidates == [] for r in zero)


def test_pack_groups_eligibility_matches_reference(corpora, queries):
    from repro.core.device_plane import pack_groups as ref_pack_groups
    rds, tds = corpora
    eligible = where(("price", "<", 30.0)).evaluate(tds)
    for q in queries[:4]:
        got = pack_groups(tds, q, eligible=eligible)
        want = ref_pack_groups(rds, q, eligible=eligible)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- device fold
@pytest.mark.parametrize("prune", ["off", "on"])
def test_eligibility_fold_no_new_d2h(prune):
    """The transfer contract at the backend: folding eligibility changes zero
    device-to-host bytes (the mask rides the existing packed layout), a
    filtered repeat of a cached dispatch ships only radii and eligibility
    words, and the folded mask equals the AND of the unfiltered mask with
    the eligibility of both endpoints."""
    rng = np.random.default_rng(0)
    points = rng.standard_normal((500, 10)).astype(np.float32)
    sizes = [40, 37, 20, 9, 64]
    id_lists = [np.sort(rng.choice(500, n, replace=False)).astype(np.int64)
                for n in sizes]
    radii = [2.5, 3.0, 2.0, float("inf"), 2.8]
    keys = [ids.tobytes() for ids in id_lists]
    eligible = rng.random(500) < 0.4

    be = TorchBackend(device="cpu", route="device", prune_tier=prune,
                      elig_pack_threshold=0.0)
    plain = be.self_join_blocks(points, id_lists, radii, keys=keys)
    h2d0, d2h0 = be.stats.h2d_bytes, be.stats.d2h_bytes
    assert d2h0 > 0
    filt = be.self_join_blocks(points, id_lists, radii, keys=keys,
                               eligible=eligible)
    h2d1 = be.stats.h2d_bytes - h2d0
    d2h1 = be.stats.d2h_bytes - d2h0
    if prune == "off":
        assert d2h1 == d2h0, "eligibility fold added D2H traffic"
    else:
        # eligibility prunes more subsets on the coarse tier: never more
        assert d2h1 <= d2h0
    assert 0 < h2d1 < h2d0
    assert be.stats.cache_hits > 0
    assert be.stats.elig_fold_dispatches > 0
    assert be.stats.elig_dense_dispatches == 0

    for i, (p, f) in enumerate(zip(plain, filt)):
        el = eligible[id_lists[i]]
        assert f.n_eligible == int(el.sum()) and f.rows is None
        if p.mask is None and not np.isfinite(radii[i]):
            assert f.mask is None
            assert f.join_count == f.n_eligible ** 2
            continue
        adj = unpack_join_mask(p.mask, p.n).astype(bool) if p.mask is not None \
            else np.eye(p.n, dtype=bool)
        ref = adj & el[:, None] & el[None, :]
        if f.mask is None:                 # proved empty by the coarse tier
            assert f.join_count <= f.n_eligible
            assert int(ref.sum()) == int(np.diag(ref).sum())
            continue
        np.testing.assert_array_equal(
            unpack_join_mask(f.mask, f.n).astype(bool), ref,
            err_msg=f"subset {i}")
        assert f.join_count == int(ref.sum())


def test_eligible_dense_blocks_carry_row_maps():
    rng = np.random.default_rng(2)
    points = rng.standard_normal((300, 6)).astype(np.float32)
    id_lists = [np.sort(rng.choice(300, n, replace=False)).astype(np.int64)
                for n in (50, 33)]
    eligible = rng.random(300) < 0.1
    be = TorchBackend(device="cpu", route="device", prune_tier="off")
    blocks = be.self_join_blocks(points, id_lists, [3.0, 2.5],
                                 eligible=eligible)
    full = NumpyBackend().self_join_blocks(points, id_lists, [3.0, 2.5],
                                           eligible=eligible)
    assert (be.stats.elig_dense_dispatches, be.stats.elig_fold_dispatches) \
        == (be.stats.dispatches, 0)
    for ids, b, nb in zip(id_lists, blocks, full):
        rows = np.flatnonzero(eligible[ids])
        np.testing.assert_array_equal(b.rows, rows)
        assert b.n == len(ids) and b.n_eligible == len(rows)
        assert b.mask.shape == (len(rows), (len(rows) + 31) // 32)
        # the packed adjacency is the eligible rows' own join
        adj = unpack_join_mask(b.mask, len(rows)).astype(bool)
        sub = nb.dist[np.ix_(rows, rows)] <= 3.0 + b.slack
        assert (adj >= (nb.dist[np.ix_(rows, rows)] <= 2.0)).all()
        assert (adj <= sub).all()


def test_numpy_backend_eligible_counts():
    rng = np.random.default_rng(1)
    points = rng.standard_normal((60, 4))
    ids = np.arange(30, dtype=np.int64)
    eligible = np.zeros(60, dtype=bool)
    eligible[::3] = True
    (block,) = NumpyBackend().self_join_blocks(points, [ids], [2.0],
                                               eligible=eligible)
    el = eligible[ids]
    dist = np.sqrt(((points[ids][:, None] - points[ids][None, :]) ** 2
                    ).sum(-1))
    assert block.join_count == \
        int(((dist <= 2.0) & el[:, None] & el[None, :]).sum())
    assert block.n_eligible == int(el.sum())


# ----------------------------------------------------------------- streaming
def _streaming_rig(seed):
    base = ref_attach_attrs(ref_synth(n=260, d=6, u=12, t=2, seed=seed),
                            seed=seed + 1)
    pool = ref_synth(n=120, d=6, u=12, t=2, seed=seed + 2)
    pattrs = ref_synthetic_attrs(120, seed=seed + 3)
    return base, pool, pattrs


def _port(ds):
    return make_dataset(ds.points, [ds.kw.row(i).tolist()
                                    for i in range(ds.n)],
                        n_keywords=ds.n_keywords, attrs=ds.attrs)


def test_streaming_filtered_parity_interleaved():
    """Filtered queries over insert/delete/compact interleavings: the port's
    engine answers as the reference's does, op for op, per backend pair."""
    base, pool, pattrs = _streaming_rig(seed=21)
    probe = RefEngine(base, m=2, n_scales=5, seed=0, build_approx=False)
    pinned = dict(m=2, n_scales=5, seed=0, w0=probe.index_e.w0,
                  n_buckets=probe.index_e.structures[0].n_buckets)
    ref = RefEngine(base, auto_compact=False, **pinned)
    eng = NKSEngine(_port(base), auto_compact=False, device="cpu", **pinned)
    queries = ref_queries(base, 2, 6, seed=9)
    flt = where(("price", "<", 55.0))

    def check(tag):
        for tier in ("exact", "approx"):
            for mine, theirs in (("numpy", "numpy"),
                                 ("torch", PallasBackend(route="device"))):
                got = eng.query_batch(queries, k=2, tier=tier, backend=mine,
                                      filter=flt)
                want = ref.query_batch(queries, k=2, tier=tier,
                                       backend=theirs, filter=flt.as_json())
                assert _cands(got) == _cands(want), (tag, tier, mine)
            assert eng.last_batch_stats.eligible_points == \
                ref.last_batch_stats.eligible_points

    def ingest(lo, hi):
        kws = [pool.kw.row(i).tolist() for i in range(lo, hi)]
        attrs = {k: v[lo:hi] for k, v in pattrs.items()}
        assert eng.insert(pool.points[lo:hi], kws, attrs=attrs).tolist() == \
            ref.insert(pool.points[lo:hi], kws, attrs=attrs).tolist()

    check("static")
    ingest(0, 40)
    check("insert")
    for e in (eng, ref):
        e.delete([3, 17, 270])
    check("delete")
    assert eng.compact() and ref.compact()
    for name in base.attrs:
        np.testing.assert_array_equal(eng.dataset.attrs[name],
                                      ref.dataset.attrs[name])
    check("compact")
    ingest(40, 80)
    for e in (eng, ref):
        e.delete([8, 300])
    check("post-compact churn")


def test_streaming_attr_schema_validation():
    base, pool, pattrs = _streaming_rig(seed=5)
    eng = NKSEngine(_port(base), m=2, n_scales=3, seed=0, auto_compact=False,
                    device="cpu")
    pts = pool.points[:4]
    kws = [pool.kw.row(i).tolist() for i in range(4)]
    with pytest.raises(ValueError, match="schema"):
        eng.insert(pts, kws)                      # missing attrs
    with pytest.raises(ValueError, match="schema"):
        eng.insert(pts, kws, attrs={"price": pattrs["price"][:4]})
    with pytest.raises(ValueError, match="must be"):
        eng.insert(pts, kws, attrs={"price": pattrs["price"][:3],
                                    "category": pattrs["category"][:4]})
    assert eng.delta_points == 0, "rejected batches must not mutate"
    with pytest.raises(ValueError, match="tenant"):
        eng.insert(pts, kws, attrs={k: v[:4] for k, v in pattrs.items()},
                   tenant="acme")
    eng.insert(pts, kws, attrs={k: v[:4] for k, v in pattrs.items()})
    assert eng.compact()
    assert eng.dataset.attrs["price"].shape == (base.n + 4,)
    np.testing.assert_allclose(eng.dataset.attrs["price"][-4:],
                               pattrs["price"][:4])


# -------------------------------------------------------------- multi-tenant
def test_tenant_scoping_matches_reference_and_isolates():
    spec = ({"acme": 140, "globex": 160}, )
    kw = dict(d=6, u=10, t=2, seed=5)
    rmt = ref_synthetic_tenants(*spec, **kw)
    mt = synthetic_tenants(*spec, **kw)
    ref = RefEngine(rmt, m=2, n_scales=5, seed=0)
    eng = NKSEngine(mt, m=2, n_scales=5, seed=0, device="cpu")
    for tname in ("acme", "globex"):
        tid = mt.tenants.id_of(tname)
        flt = Filter(tenant=tname)
        qs = [[0, 3], [1, 2, 4]]
        for tier, mine, theirs in (
                ("exact", "numpy", "numpy"), ("approx", "numpy", "numpy"),
                ("exact", "torch", PallasBackend(route="device")),
                ("approx", "torch", PallasBackend(route="device"))):
            got = eng.query_batch(qs, k=2, tier=tier, backend=mine,
                                  filter=flt)
            assert _cands(got) == _cands(ref.query_batch(
                qs, k=2, tier=tier, backend=theirs, filter=flt.as_json())), \
                (tname, tier, mine)
            assert [r.query for r in got] == qs     # tenant-local echo
            for r in got:
                for c in r.candidates:
                    assert (mt.tenant_of[list(c.ids)] == tid).all(), \
                        f"tenant isolation violated: {tname} got {c.ids}"
        dev = eng.query_batch(qs, k=2, tier="device", filter=flt)
        for r in dev:
            for c in r.candidates:
                assert (mt.tenant_of[list(c.ids)] == tid).all()


def test_tenant_namespace_resolution_and_validation():
    mt = synthetic_tenants({"acme": 60, "globex": 60}, d=4, u=6, t=2, seed=2)
    eng = NKSEngine(mt, m=2, n_scales=3, seed=0, device="cpu")
    ns = mt.tenants
    assert ns.resolve("globex", [0, 5]) == [6, 11]
    with pytest.raises(ValueError, match="outside tenant"):
        ns.resolve("acme", [6])
    with pytest.raises(KeyError, match="unknown tenant"):
        eng.query_batch([[0]], tier="exact", filter=Filter(tenant="nobody"))
    with pytest.raises(KeyError, match="out of range"):
        ns.id_of(5)
    # a tenant-scoped query cannot escape its dictionary even with ids that
    # are valid globally
    with pytest.raises(ValueError, match="outside tenant"):
        eng.query_batch([[7]], tier="exact", filter=Filter(tenant="acme"))
    flt = where(("price", "<", 70.0), tenant="acme")
    r = eng.query_batch([[0, 1]], k=1, tier="exact", filter=flt)[0]
    elig = flt.evaluate(mt)
    assert r.candidates
    for c in r.candidates:
        assert elig[list(c.ids)].all()


def test_tenant_streaming_insert_and_query():
    kw = dict(d=4, u=6, t=2, seed=3)
    spec = {"acme": 80, "globex": 80}
    ref = RefEngine(ref_synthetic_tenants(spec, **kw), m=2, n_scales=4,
                    seed=0, auto_compact=False)
    mt = synthetic_tenants(spec, **kw)
    eng = NKSEngine(mt, m=2, n_scales=4, seed=0, auto_compact=False,
                    device="cpu")
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 10_000, (5, 4)).astype(np.float32)
    kws = [mt.tenants.resolve("acme", [i % 6]) for i in range(5)]
    attrs = {"price": np.full(5, 1.0), "category": np.zeros(5, np.int64)}
    for e in (eng, ref):
        e.insert(pts, kws, attrs=attrs, tenant="acme")
        e.insert(pts[:2], kws[:2], attrs={k: v[:2] for k, v in attrs.items()},
                 tenant=np.array(["globex", "acme"]))
    flt = Filter(tenant="acme")
    got = eng.query_batch([[0], [1, 2]], k=3, tier="exact", backend="numpy",
                          filter=flt)
    assert _cands(got) == _cands(ref.query_batch(
        [[0], [1, 2]], k=3, tier="exact", backend="numpy",
        filter=flt.as_json()))
    tid = mt.tenants.id_of("acme")
    np.testing.assert_array_equal(eng.dataset.tenant_ids,
                                  ref.dataset.tenant_ids)
    for r in got:
        for c in r.candidates:
            assert (eng.dataset.tenant_ids[list(c.ids)] == tid).all()
    with pytest.raises(ValueError, match="tenant"):
        eng.insert(pts, kws, attrs=attrs)
    assert eng.compact()
    np.testing.assert_array_equal(eng.dataset.tenant_of[-7:],
                                  [tid] * 5 + [mt.tenants.id_of("globex"),
                                               tid])


# ----------------------------------------------------------- filter grammar
def test_filter_grammar_and_json_roundtrip():
    flt = where(("price", "<", 50.0), ("category", "in", [2, 1, 2]),
                ("price", ">=", 5.0), tenant="acme")
    spec = flt.as_json()
    back = Filter.from_json(json.loads(json.dumps(spec)))
    assert back == flt
    assert Filter.coerce(None) is None
    assert Filter.coerce(Filter()) is None          # empty filter == None
    assert Filter.coerce({"where": [["price", "<", 1]]})

    with pytest.raises(ValueError, match="unknown predicate op"):
        Clause("price", "~", 3)
    with pytest.raises(ValueError, match="value list"):
        Clause("price", "in", 3)
    with pytest.raises(ValueError, match="lo, hi"):
        Clause("price", "between", [1])
    with pytest.raises(ValueError, match="unknown filter keys"):
        Filter.from_json({"tenant": "a", "wher": []})
    with pytest.raises(ValueError, match="attr, op, value"):
        Filter.from_json({"where": [["price", "<"]]})


def test_filter_evaluate_errors(corpora):
    _, tds = corpora
    with pytest.raises(KeyError, match="unknown attribute"):
        where(("nope", "<", 1)).evaluate(tds)
    strcorp = make_dataset(
        np.zeros((4, 2), np.float32), [[0]] * 4, n_keywords=1,
        attrs={"label": np.array(["a", "b", "a", "c"])})
    with pytest.raises(ValueError, match="non-numeric"):
        where(("label", "<", "b")).evaluate(strcorp)
    np.testing.assert_array_equal(
        where(("label", "==", "a")).evaluate(strcorp), [1, 0, 1, 0])
    np.testing.assert_array_equal(
        where(("label", "in", ["b", "c"])).evaluate(strcorp), [0, 1, 0, 1])
    with pytest.raises(ValueError, match="no tenant column"):
        Filter(tenant="acme").evaluate(tds)
    bare = synthetic_dataset(n=10, d=2, u=3, t=1, seed=0)
    with pytest.raises(KeyError, match="unknown attribute"):
        where(("price", "<", 1)).evaluate(bare)
    with pytest.raises(ValueError, match="must be"):
        make_dataset(np.zeros((3, 2)), [[0]] * 3, attrs={"p": np.zeros(2)})


def test_filter_evaluate_ops_match_reference(corpora):
    from repro.core.filters import where as ref_where
    rds, tds = corpora
    price, cat = tds.attrs["price"], tds.attrs["category"]
    cases = [
        ((("price", "<", 30.0),), price < 30.0),
        ((("price", ">=", 30.0),), price >= 30.0),
        ((("category", "==", 3),), cat == 3),
        ((("category", "!=", 3),), cat != 3),
        ((("category", "in", [1, 4]),), np.isin(cat, [1, 4])),
        ((("price", "between", (10.0, 20.0)),),
         (price >= 10.0) & (price <= 20.0)),
        ((("price", "<", 50.0), ("category", "==", 0)),
         (price < 50.0) & (cat == 0)),
    ]
    for clauses, want in cases:
        flt = where(*clauses)
        np.testing.assert_array_equal(flt.evaluate(tds), want)
        np.testing.assert_array_equal(ref_where(*clauses).evaluate(rds), want)
        assert flt.selectivity(tds) == ref_where(*clauses).selectivity(rds)


def test_semantics_is_not_ported(engines, queries):
    """Semantics under a filter match the reference (the name is historical:
    the test once held that the port refused ``semantics=``, and keeps its
    name so that its record carries on). ``query_batch`` and ``query`` with
    ``semantics=`` under a price filter answer as the reference engine does
    (the numpy backends bit for bit; ``tests/test_torch_semantics.py`` holds
    the rest)."""
    ref_engine, engine = engines
    sem = {"m": 1}
    flt = _price(0.5)
    for tier in ("exact", "approx"):
        want = ref_engine.query_batch(queries[:2], k=2, tier=tier,
                                      backend="numpy", filter=flt.as_json(),
                                      semantics=sem)
        got = engine.query_batch(queries[:2], k=2, tier=tier,
                                 backend="numpy", filter=flt, semantics=sem)
        assert _cands(got) == _cands(want), tier
        one = engine.query(queries[0], k=2, tier=tier, filter=flt,
                           semantics=sem)
        assert _cands([one]) == _cands(want[:1]), tier
