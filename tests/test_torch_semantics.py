"""The port's flexible query semantics against the reference, on the CPU.

The cases of the reference's ``tests/test_semantics.py`` that need no
runtime or launcher, driven through both packages on the same seeded
corpora (n <= 150, so the exponential ``brute_force.search_flex`` oracle
stays cheap): the semantics and queue primitives; the per-query searches
(``promish_e``/``promish_a`` with ``semantics=``) bit for bit the
reference's and, in the exact tier, the oracle's answer; and the engine's
``query_batch(semantics=...)`` in both tiers, unfiltered, under a price
filter and under a tenant, bit for bit the reference's counterpart backend
(the port's numpy backend against the reference's, the port's torch backend
— the kernels' plain versions on the CPU — against the reference's Pallas
backend, with the prune tier off, on in bf16 and on in int8). Degenerate
semantics must give the classic answer bit for bit on every route, and the
device tier refuses the rest.
"""
import math

import numpy as np
import pytest
import torch

from repro.core import brute_force as ref_bf
from repro.core import promish_a as ref_pa
from repro.core import promish_e as ref_pe
from repro.core import semantics as ref_sem
from repro.core.backend import PallasBackend
from repro.core.index import build_index as ref_build_index
from repro.core.types import make_dataset as ref_make_dataset
from repro.data.synthetic import synthetic_tenants as ref_synthetic_tenants
from repro.serve.engine import NKSEngine as RefEngine
from repro_torch.core import brute_force, promish_a, promish_e
from repro_torch.core.backend import TorchBackend
from repro_torch.core.filters import Filter, where
from repro_torch.core.index import build_index
from repro_torch.core.semantics import (MAX_SUBQUERIES, QuerySemantics,
                                        parse_weighted_keywords,
                                        weighted_pair_sq)
from repro_torch.core.types import Candidate, ScoredTopK, TopK, make_dataset
from repro_torch.data.synthetic import synthetic_attrs, synthetic_tenants
from repro_torch.serve.engine import NKSEngine

torch.set_num_threads(1)


def _raw(seed, n=90, d=4, u=10):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1000, (n, d)).astype(np.float32)
    kws = [rng.choice(u, size=rng.integers(1, 4), replace=False).tolist()
           for _ in range(n)]
    return pts, kws, u


def _pair(seed, **kw):
    pts, kws, u = _raw(seed, **kw)
    return (ref_make_dataset(pts, kws, n_keywords=u),
            make_dataset(pts, kws, n_keywords=u))


def _queries(ds, n_queries, qlen, seed):
    rng = np.random.default_rng(seed)
    populated = np.flatnonzero(np.diff(ds.ikp.offsets) > 0)
    return [sorted(rng.choice(populated, size=qlen, replace=False).tolist())
            for _ in range(n_queries)]


def _variants(query):
    q = list(query)
    return [
        {"m": max(1, len(q) - 1)},
        {"m": 1},
        {"weights": {q[0]: 3.0, q[-1]: 1.5}},
        {"m": max(1, len(q) - 1), "weights": {q[0]: 2.0}},
        {"m": 1, "score": True, "alpha": 0.5},
        {"score": True},
    ]


def _full(items):
    return [(c.ids, c.diameter, c.score) for c in items]


def _cands(results):
    return [_full(r.candidates) for r in results]


# --------------------------------------------------------------- primitives
def test_semantics_validation_errors():
    with pytest.raises(ValueError, match="weight"):
        QuerySemantics(weights={3: 0.5})
    with pytest.raises(ValueError, match="weight"):
        QuerySemantics.coerce({"weights": {"3": float("nan")}})
    with pytest.raises(ValueError, match="m must be"):
        QuerySemantics(m=0)
    with pytest.raises(ValueError, match="m must be"):
        QuerySemantics(m=True)
    with pytest.raises(ValueError, match="alpha"):
        QuerySemantics(alpha=0.0)
    with pytest.raises(ValueError, match="unknown semantics key"):
        QuerySemantics.coerce({"mm": 2})
    with pytest.raises(ValueError, match="dict or QuerySemantics"):
        QuerySemantics.coerce([2])
    with pytest.raises(ValueError, match="exceeds"):
        QuerySemantics(m=5).trivial_for([1, 2])
    with pytest.raises(ValueError, match="cap"):
        QuerySemantics(m=1).expand_subqueries(list(range(12)))
    assert MAX_SUBQUERIES == ref_sem.MAX_SUBQUERIES == 512


@pytest.mark.parametrize("raw", [
    None, {}, {"m": 2}, {"m": 2, "weights": {"7": 4}, "score": True},
    {"weights": {3: 2.0, 7: 4.0}}, {"weights": {7: 4.0, 3: 2.0}},
    {"score": True, "alpha": 0.5}, {"m": 1, "alpha": 2.0}])
def test_coerce_and_canonical_key_match_reference(raw):
    got, want = QuerySemantics.coerce(raw), ref_sem.QuerySemantics.coerce(raw)
    if raw is None:
        assert got is None and want is None
        return
    assert (got.m, got.weights, got.score, got.alpha) == \
        (want.m, want.weights, want.score, want.alpha)
    assert got.canonical_key() == want.canonical_key()
    assert QuerySemantics.coerce(got) is got


def test_trivial_for_and_expand_subqueries_match_reference():
    for raw in ({}, {"m": 3}, {"m": 2}, {"m": 1}, {"weights": {9: 4.0}},
                {"weights": {1: 2.0}}, {"weights": {1: 1.0}},
                {"score": True}):
        for q in ([1, 2, 3], [3, 1], [1, 2, 3, 4]):
            if raw.get("m", 0) > len(q):
                continue
            got = QuerySemantics.coerce(raw)
            want = ref_sem.QuerySemantics.coerce(raw)
            assert got.trivial_for(q) == want.trivial_for(q), (raw, q)
            assert got.expand_subqueries(q) == want.expand_subqueries(q)
    subs = QuerySemantics(m=1).expand_subqueries([1, 2, 3])
    assert subs[0] == [1, 2, 3] and len(subs) == 7


@pytest.mark.parametrize("raw", [
    ["3", "7^4", 12, "5^1.5"], [1, 2], ["7^4", "7^2"], ["0^1", "11"],
    [np.int64(4), "9^2.25"]])
def test_parse_weighted_keywords_follows_reference_grammar(raw):
    assert parse_weighted_keywords(raw) == \
        ref_sem.parse_weighted_keywords(raw)


@pytest.mark.parametrize("bad", [["x^2"], ["3^"], ["^2"]])
def test_parse_weighted_keywords_rejects_like_reference(bad):
    with pytest.raises(ValueError):
        ref_sem.parse_weighted_keywords(bad)
    with pytest.raises(ValueError):
        parse_weighted_keywords(bad)


def test_resolve_keywords_and_weight_vector_match_reference():
    rds, tds = _pair(0)
    sem = QuerySemantics(m=1, weights={3: 2.0})
    assert sem.resolve_keywords(lambda kw: kw + 100).weights == {103: 2.0}
    assert QuerySemantics(m=2).resolve_keywords(lambda kw: kw + 1).m == 2
    for raw in ({"weights": {3: 2.0, 5: 3.5}}, {"weights": {9: 1.0}}):
        got = QuerySemantics.coerce(raw).weight_vector(tds, [3, 5, 9])
        want = ref_sem.QuerySemantics.coerce(raw).weight_vector(rds,
                                                                [3, 5, 9])
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    d2 = np.arange(9, dtype=np.float64).reshape(3, 3)
    w = np.array([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(weighted_pair_sq(d2, w),
                                  ref_sem.weighted_pair_sq(d2, w))


def test_topk_tie_open_admits_equal_cost():
    strict, open_ = TopK(2), TopK(2, tie_open=True)
    for pq in (strict, open_):
        pq.offer(Candidate(ids=(5,), diameter=0.0))
        pq.offer(Candidate(ids=(9,), diameter=0.0))
    assert strict.kth_diameter() == 0.0
    assert open_.kth_diameter() == math.nextafter(0.0, math.inf)
    open_.offer(Candidate(ids=(2,), diameter=0.0))
    assert [c.ids for c in open_.items] == [(2,), (5,)]
    assert Candidate(ids=(1,), diameter=1.0).score is None


def test_scored_topk_ranks_by_score_and_bounds_cost():
    def cov(ids):
        return float(len(ids))
    pq = ScoredTopK(2, total_weight=3.0, alpha=1.0, coverage=cov)
    assert pq.kth_diameter() == float("inf")
    pq.offer(Candidate(ids=(1, 2, 3), diameter=2.0))   # score 1.0
    pq.offer(Candidate(ids=(4,), diameter=0.0))        # score 1.0
    pq.offer(Candidate(ids=(5, 6), diameter=0.5))      # score 4/3
    items = pq.items
    assert [c.ids for c in items] == [(5, 6), (4,)]
    assert items[0].score == pytest.approx(2.0 / 1.5)
    assert pq.kth_diameter() == math.nextafter(2.0, math.inf)
    assert not pq.offer(Candidate(ids=(5, 6), diameter=0.5))   # dedup


def test_weighted_set_cost_matches_manual_and_reference():
    rds, tds = _pair(0)
    wvec = np.ones(tds.n)
    wvec[[3, 7]] = [2.0, 3.0]
    ids = [3, 7, 11]
    pts = tds.points[np.asarray(ids)].astype(np.float64)
    diff = pts[:, None] - pts[None, :]
    d2 = (diff * diff).sum(-1)
    want = float(np.sqrt(weighted_pair_sq(d2, wvec[np.asarray(ids)]).max()))
    assert brute_force.weighted_set_cost(ids, tds, wvec) == want
    assert brute_force.weighted_set_cost(ids, tds, wvec) == \
        ref_bf.weighted_set_cost(ids, rds, wvec)
    assert brute_force.weighted_set_cost([5], tds, wvec) == 0.0


# ------------------------------------------------- per-query search parity
@pytest.mark.parametrize("seed", [1, 2])
def test_promish_e_flex_matches_reference_and_oracle(seed):
    """Exact tier, every variant: bit for bit the reference's ProMiSH-E, and
    the oracle's ids with costs (and scores) to 1e-9."""
    rds, tds = _pair(seed)
    ridx = ref_build_index(rds, m=2, n_scales=4, exact=True, seed=seed)
    idx = build_index(tds, m=2, n_scales=4, exact=True, seed=seed)
    for query in _queries(tds, 2, 3, seed + 50):
        for var in _variants(query):
            got = promish_e.search(tds, idx, query, k=2, semantics=var).items
            want = ref_pe.search(rds, ridx, query, k=2, semantics=var).items
            assert _full(got) == _full(want), var
            oracle = brute_force.search_flex(tds, query, k=2, semantics=var)
            assert [c.ids for c in got] == [c.ids for c in oracle], var
            np.testing.assert_allclose([c.diameter for c in got],
                                       [c.diameter for c in oracle],
                                       rtol=1e-9)
            if QuerySemantics.coerce(var).score:
                np.testing.assert_allclose([c.score for c in got],
                                           [c.score for c in oracle],
                                           rtol=1e-9)


def test_promish_a_flex_matches_reference_and_is_feasible():
    seed = 3
    rds, tds = _pair(seed)
    ridx = ref_build_index(rds, m=2, n_scales=4, exact=False, seed=seed)
    idx = build_index(tds, m=2, n_scales=4, exact=False, seed=seed)
    for query in _queries(tds, 2, 3, seed + 50):
        for var in _variants(query):
            sem = QuerySemantics.coerce(var)
            got = promish_a.search(tds, idx, query, k=2, semantics=sem).items
            want = ref_pa.search(rds, ridx, query, k=2, semantics=var).items
            assert _full(got) == _full(want), var
            wvec = sem.weight_vector(tds, query)
            universe = set(brute_force.enumerate_candidates_flex(
                tds, sorted(query), sem))
            for c in got:
                assert c.ids in universe, var
                np.testing.assert_allclose(
                    c.diameter,
                    brute_force.weighted_set_cost(c.ids, tds, wvec),
                    rtol=1e-9)


def test_degenerate_semantics_bit_identical_per_query():
    seed = 4
    _, tds = _pair(seed)
    degenerate = [None, {"m": 3}, {"weights": {0: 1.0}},
                  {"m": 3, "weights": {999: 7.0}, "alpha": 2.0}]
    for exact, mod in ((True, promish_e), (False, promish_a)):
        idx = build_index(tds, m=2, n_scales=4, exact=exact, seed=seed)
        for query in _queries(tds, 2, 3, seed + 60):
            base = _full(mod.search(tds, idx, query, k=2).items)
            for var in degenerate:
                got = mod.search(tds, idx, query, k=2, semantics=var).items
                assert _full(got) == base, var


# ------------------------------------------------------------ engine parity
def _scoped_corpora():
    """(ref dataset, port dataset) with price/category columns, and the
    tenant corpora."""
    pts, kws, u = _raw(5, n=150, d=4, u=10)
    attrs = synthetic_attrs(len(pts), seed=1)
    rds = ref_make_dataset(pts, kws, n_keywords=u, attrs=attrs)
    tds = make_dataset(pts, kws, n_keywords=u, attrs=attrs)
    spec = ({"acme": 70, "globex": 80},)
    kw = dict(d=4, u=8, t=2, seed=5)
    return rds, tds, ref_synthetic_tenants(*spec, **kw), \
        synthetic_tenants(*spec, **kw)


@pytest.fixture(scope="module")
def scoped():
    rds, tds, rmt, mt = _scoped_corpora()
    return {
        "none": (rds, tds, RefEngine(rds, m=2, n_scales=4, seed=5),
                 NKSEngine(tds, m=2, n_scales=4, seed=5, device="cpu"),
                 None),
        "price": (rds, tds, None, None, where(("price", "<", 60.0))),
        "tenant": (rmt, mt, RefEngine(rmt, m=2, n_scales=4, seed=5),
                   NKSEngine(mt, m=2, n_scales=4, seed=5, device="cpu"),
                   Filter(tenant="globex")),
    }


def _scope(scoped, name):
    rds, tds, ref_engine, engine, flt = scoped[name]
    if ref_engine is None:
        _, _, ref_engine, engine, _ = scoped["none"]
    if name == "tenant":
        queries = [[0, 3, 5], [1, 2, 4], [2, 6, 7]]
    else:
        queries = _queries(tds, 3, 3, 77)
    return rds, tds, ref_engine, engine, flt, queries


@pytest.mark.parametrize("tier", ["exact", "approx"])
@pytest.mark.parametrize("scope", ["none", "price", "tenant"])
def test_engine_flex_matches_reference_backends(scoped, scope, tier):
    """Every variant, bit for bit: port numpy == reference numpy, port torch
    (default route; forced onto the device with the prune tier in bf16 and
    in int8) == reference Pallas on the device route."""
    _, _, ref_engine, engine, flt, queries = _scope(scoped, scope)
    rflt = None if flt is None else flt.as_json()
    for var in _variants(queries[0]):
        want_np = _cands(ref_engine.query_batch(
            queries, k=2, tier=tier, backend="numpy", filter=rflt,
            semantics=var))
        want_dev = _cands(ref_engine.query_batch(
            queries, k=2, tier=tier, backend=PallasBackend(route="device"),
            filter=rflt, semantics=var))
        assert _cands(engine.query_batch(
            queries, k=2, tier=tier, backend="numpy", filter=flt,
            semantics=var)) == want_np, var
        assert _cands(engine.query_batch(
            queries, k=2, tier=tier, filter=flt, semantics=var)) == \
            want_dev, var
        for dtype in ("bf16", "int8"):
            be = TorchBackend(device="cpu", route="device", prune_tier="on",
                              prune_dtype=dtype)
            assert _cands(engine.query_batch(
                queries, k=2, tier=tier, backend=be, filter=flt,
                semantics=var)) == want_dev, (var, dtype)
        assert engine.last_batch_stats.subqueries == \
            ref_engine.last_batch_stats.subqueries


@pytest.mark.parametrize("scope", ["none", "price"])
def test_engine_flex_matches_oracle(scoped, scope):
    """The exact tier answers as ``search_flex`` over the (filtered)
    corpus: ids equal, costs and scores to 1e-9."""
    _, tds, _, engine, flt, queries = _scope(scoped, scope)
    eligible = None if flt is None else flt.evaluate(tds)
    for var in _variants(queries[0]):
        sem = QuerySemantics.coerce(var)
        res = engine.query_batch(queries, k=2, tier="exact", backend="numpy",
                                 filter=flt, semantics=sem)
        for q, r in zip(queries, res):
            want = brute_force.search_flex(tds, q, k=2, semantics=sem,
                                           eligible=eligible)
            assert [c.ids for c in r.candidates] == [c.ids for c in want]
            np.testing.assert_allclose([c.diameter for c in r.candidates],
                                       [c.diameter for c in want], rtol=1e-9)
            if sem.score:
                np.testing.assert_allclose(
                    [c.score for c in r.candidates],
                    [c.score for c in want], rtol=1e-9)


def test_engine_tenant_weights_resolve_through_namespace(scoped):
    """Under a tenant, weight keys are tenant-local like the query's
    keywords: the answers equal an unscoped search over the resolved global
    keywords and weights restricted to the tenant's points."""
    _, mt, _, engine, flt, queries = _scope(scoped, "tenant")
    ns = mt.tenants
    for q in queries:
        local = {"weights": {q[0]: 3.0}, "m": 2}
        got = engine.query_batch([q], k=2, tier="exact", backend="numpy",
                                 filter=flt, semantics=local)[0]
        glob = ns.resolve("globex", q)
        want = brute_force.search_flex(
            mt, glob, k=2, semantics={"weights": {glob[0]: 3.0}, "m": 2},
            eligible=flt.evaluate(mt))
        assert got.query == q
        assert [c.ids for c in got.candidates] == [c.ids for c in want]


@pytest.mark.parametrize("tier", ["exact", "approx"])
def test_engine_degenerate_bit_identical_per_route(scoped, tier):
    _, _, _, engine, _, queries = _scope(scoped, "none")
    for backend in ("numpy", "torch"):
        base = _cands(engine.query_batch(queries, k=2, tier=tier,
                                         backend=backend))
        for var in ({"m": 3, "weights": {0: 1.0}}, {"weights": {}},
                    {"m": 3}):
            assert _cands(engine.query_batch(
                queries, k=2, tier=tier, backend=backend,
                semantics=var)) == base, (backend, var)
        assert engine.last_batch_stats.subqueries == len(queries)


def test_engine_query_flex_is_its_batch_of_one(scoped):
    _, _, _, engine, _, queries = _scope(scoped, "none")
    for tier in ("exact", "approx"):
        for var in ({"m": 1, "score": True}, {"weights": {queries[0][0]: 2}}):
            one = engine.query(queries[0], k=2, tier=tier, semantics=var)
            batch = engine.query_batch(queries[:1], k=2, tier=tier,
                                       backend="numpy", semantics=var)
            assert _full(one.candidates) == _cands(batch)[0]
    res = engine.query(queries[0], k=2, tier="exact",
                       semantics={"m": 1, "score": True})
    scores = [c.score for c in res.candidates]
    assert scores and scores == sorted(scores, reverse=True)
    engine.query_batch([queries[0]], k=1, tier="exact", backend="numpy",
                       semantics={"m": 2})
    assert engine.last_batch_stats.subqueries == 4
    engine.query_batch([queries[0]], k=1, tier="exact", backend="numpy")
    assert engine.last_batch_stats.subqueries == 1


def test_engine_device_tier_rejects_flex(scoped):
    _, _, _, engine, _, queries = _scope(scoped, "none")
    q = queries[0][:2]
    with pytest.raises(ValueError, match="device tier"):
        engine.query(q, tier="device", semantics={"m": 1})
    with pytest.raises(ValueError, match="device tier"):
        engine.query_batch([q], tier="device", semantics={"score": True})
    with pytest.raises(ValueError, match="device tier"):
        engine.query_batch([q], tier="device",
                           semantics={"weights": {q[0]: 2.0}})
    # degenerate semantics on the device tier are the classic path
    want = [c.ids for c in engine.query(q, tier="device").candidates]
    got = engine.query(q, tier="device", semantics={"m": 2})
    assert [c.ids for c in got.candidates] == want


def test_engine_built_without_an_index_raises_on_its_tier():
    rds, tds = _pair(10)
    ref = RefEngine(rds, m=2, n_scales=4, build_exact=False, seed=10)
    eng = NKSEngine(tds, m=2, n_scales=4, build_exact=False, seed=10,
                    device="cpu")
    assert eng.index_e is None and eng.index_a is not None
    query = _queries(tds, 1, 3, 6)[0]
    sem = QuerySemantics(m=2)
    got = eng.query(query, k=2, tier="approx", semantics=sem)
    assert _full(got.candidates) == _full(
        ref.query(query, k=2, tier="approx", semantics={"m": 2}).candidates)
    universe = set(brute_force.enumerate_candidates_flex(tds, query, sem))
    assert all(c.ids in universe for c in got.candidates)
    for call in (lambda: eng.query(query, tier="exact"),
                 lambda: eng.query_batch([query], tier="exact")):
        with pytest.raises(ValueError, match="without the 'exact' index"):
            call()
    only_e = NKSEngine(tds, m=2, n_scales=4, build_approx=False, seed=10,
                       device="cpu")
    assert only_e.index_a is None
    with pytest.raises(ValueError, match="without the 'approx' index"):
        only_e.query_batch([query], tier="approx")
    with pytest.raises(ValueError, match="without the 'approx' index"):
        only_e.query(query, tier="approx")
    # a streaming insert and a compaction keep the missing index missing
    only_e.insert(tds.points[:3] + 1.0, [[0], [1], [2]])
    assert set(only_e._deltas) == {"e"}
    only_e.compact()
    assert only_e.index_a is None and only_e.index_e is not None
