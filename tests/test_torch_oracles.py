"""The port's oracles, host models and backend knobs against the reference,
on the CPU.

* ``core.brute_force`` (``search``, ``search_filtered``,
  ``count_candidates``, ``weighted_set_cost``, ``enumerate_candidates_flex``,
  ``search_flex``), ``core.baseline_tree`` (the virtual bR*-tree baseline
  and its space model) and ``core.theory`` (the §VI/§VII models) give the
  reference's outputs, bit for bit, on the same seeded corpora (n <= 150:
  the oracles are exponential in the query length).
* ``configs.promish_default`` holds the reference's values.
* ``TorchBackend``'s knobs (``quantum``, ``n_classes``, ``max_block_bytes``,
  ``cache_bytes``, ``prune_eps``, ``bin_strategy``, ``prune_dtype``) validate
  as ``PallasBackend``'s do, and none of them changes an answer:
  ``bin_strategy="pow2"`` answers as ``"quantile"``, and the prune tier forced
  on in int8 gives the same blocks as in bf16 and as with the tier off (the
  reference's ``tests/test_cascade.py`` case, on the port's backend).
* The reference's own two backends split an exact float64 tie on a small
  corpus (numpy scores through the norms identity, the device route through
  coordinate differences); the port keeps that split on purpose: its numpy
  backend answers as the reference's numpy backend, its torch backend as the
  reference's Pallas backend, and the two answers differ.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import promish_default as ref_cfg
from repro.core import baseline_tree as ref_bt
from repro.core import brute_force as ref_bf
from repro.core import theory as ref_theory
from repro.core.backend import PallasBackend
from repro.core.semantics import QuerySemantics as RefSemantics
from repro.core.types import make_dataset as ref_make_dataset
from repro.serve.engine import NKSEngine as RefEngine
from repro_torch.configs import promish_default as cfg
from repro_torch.core import baseline_tree, brute_force, theory
from repro_torch.core.backend import TorchBackend
from repro_torch.core.filters import Filter, where
from repro_torch.core.semantics import QuerySemantics
from repro_torch.core.types import make_dataset
from repro_torch.data.synthetic import synthetic_attrs
from repro_torch.serve.engine import NKSEngine

torch.set_num_threads(1)


def _pair(seed, n=120, d=4, u=10, attrs=False):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1000, (n, d)).astype(np.float32)
    kws = [rng.choice(u, size=rng.integers(1, 4), replace=False).tolist()
           for _ in range(n)]
    a = synthetic_attrs(n, seed=seed) if attrs else None
    return (ref_make_dataset(pts, kws, n_keywords=u, attrs=a),
            make_dataset(pts, kws, n_keywords=u, attrs=a))


def _items(pq_or_list):
    items = pq_or_list.items if hasattr(pq_or_list, "items") \
        and not isinstance(pq_or_list, list) else pq_or_list
    return [(c.ids, c.diameter, c.score) for c in items]


QUERIES = [[0, 3], [1, 2, 5], [4, 6, 7], [2, 8, 9]]


# ------------------------------------------------------------- brute force
@pytest.mark.parametrize("seed", [0, 1])
def test_brute_force_search_and_counts_match_reference(seed):
    rds, tds = _pair(seed, attrs=True)
    el = tds.attrs["price"] < 50.0
    for q in QUERIES:
        for k in (1, 3):
            assert _items(brute_force.search(tds, q, k=k)) == \
                _items(ref_bf.search(rds, q, k=k))
            assert _items(brute_force.search(tds, q, k=k, eligible=el)) == \
                _items(ref_bf.search(rds, q, k=k, eligible=el))
        assert brute_force.count_candidates(tds, q) == \
            ref_bf.count_candidates(rds, q)
        assert list(brute_force.enumerate_candidates(tds, q, eligible=el)) \
            == list(ref_bf.enumerate_candidates(rds, q, eligible=el))
        assert brute_force.set_diameter(q, tds) == \
            ref_bf.set_diameter(q, rds)
    flt = where(("price", "<", 30.0))
    assert _items(brute_force.search_filtered(tds, [1, 2], flt, k=2)) == \
        _items(ref_bf.search_filtered(rds, [1, 2], flt.as_json(), k=2))
    with pytest.raises(ValueError, match="infeasible"):
        brute_force.search(tds, [0, 1, 2], max_tuples=10)


@pytest.mark.parametrize("raw", [None, {"m": 1}, {"m": 2},
                                 {"weights": {1: 3.0, 5: 1.5}},
                                 {"m": 2, "score": True, "alpha": 0.5},
                                 {"score": True}])
def test_search_flex_matches_reference(raw):
    rds, tds = _pair(2, attrs=True)
    el = tds.attrs["price"] < 60.0
    for q in QUERIES[1:]:
        sem, rsem = QuerySemantics.coerce(raw), RefSemantics.coerce(raw)
        for eligible in (None, el):
            got = brute_force.search_flex(tds, q, k=3, semantics=sem,
                                          eligible=eligible)
            want = ref_bf.search_flex(rds, q, k=3, semantics=rsem,
                                      eligible=eligible)
            assert _items(got) == _items(want), (raw, q)
        if sem is not None:
            assert list(brute_force.enumerate_candidates_flex(tds, q, sem)) \
                == list(ref_bf.enumerate_candidates_flex(rds, q, rsem))
            w = sem.weight_vector(tds, q)
            for ids in list(brute_force.enumerate_candidates_flex(
                    tds, q, sem))[:20]:
                assert brute_force.weighted_set_cost(ids, tds, w) == \
                    ref_bf.weighted_set_cost(ids, rds, w)


def test_search_filtered_tenant_matches_reference():
    from repro.data.synthetic import synthetic_tenants as ref_tenants
    from repro_torch.data.synthetic import synthetic_tenants
    spec = ({"acme": 60, "globex": 70},)
    kw = dict(d=4, u=6, t=2, seed=3)
    rmt, mt = ref_tenants(*spec, **kw), synthetic_tenants(*spec, **kw)
    for q in ([0, 3], [1, 2, 4]):
        flt = Filter(tenant="acme")
        assert _items(brute_force.search_filtered(mt, q, flt, k=2)) == \
            _items(ref_bf.search_filtered(rmt, q, flt.as_json(), k=2))


# ----------------------------------------------------- baseline and theory
@pytest.mark.parametrize("seed,leaf,fanout", [(0, 8, 4), (1, 16, 3),
                                              (2, 1000, 100)])
def test_baseline_tree_matches_reference(seed, leaf, fanout):
    rds, tds = _pair(seed, n=150)
    got = baseline_tree.VirtualBRTree(tds, leaf_size=leaf, fanout=fanout)
    want = ref_bt.VirtualBRTree(rds, leaf_size=leaf, fanout=fanout)
    assert got.nbytes() == want.nbytes()
    for q in QUERIES:
        assert got.initial_estimate(q) == want.initial_estimate(q)
        for k, budget in ((1, 2_000_000), (2, 2_000_000), (2, 5)):
            pq, timed_out, pops = got.search(q, k=k, budget=budget)
            rpq, rtimed_out, rpops = want.search(q, k=k, budget=budget)
            assert (_items(pq), timed_out, pops) == \
                (_items(rpq), rtimed_out, rpops)
    for args in ((10_000, 64, 5_661, 3), (1_000_000, 8, 24_874, 9, 11)):
        assert baseline_tree.space_cost_model(*args) == \
            ref_bt.space_cost_model(*args)


def test_theory_matches_reference():
    rds, tds = _pair(4, n=80)
    np.testing.assert_array_equal(theory.keyword_pmf(tds),
                                  ref_theory.keyword_pmf(rds))
    for q in ([0, 3], [1, 2, 5]):
        assert theory.total_candidates(tds, q) == \
            ref_theory.total_candidates(rds, q)
        for got, want in zip(theory.candidate_diameter_pmf(tds, q, bins=20),
                             ref_theory.candidate_diameter_pmf(rds, q,
                                                               bins=20)):
            np.testing.assert_array_equal(got, want)
        sampled = (theory.candidate_diameter_pmf(tds, q, max_candidates=50),
                   ref_theory.candidate_diameter_pmf(rds, q,
                                                     max_candidates=50))
        for got, want in zip(*sampled):
            np.testing.assert_array_equal(got, want)
        assert theory.expected_explored(tds, q, m=2, width=300.0,
                                        n_vectors=64) == \
            ref_theory.expected_explored(rds, q, m=2, width=300.0,
                                         n_vectors=64)
        assert theory.approximation_ratio_bound(tds, q, m=2, width=300.0,
                                                n_vectors=64) == \
            ref_theory.approximation_ratio_bound(rds, q, m=2, width=300.0,
                                                 n_vectors=64)
    pts = tds.points[:5]
    for overlapping in (False, True):
        assert theory.containment_probability(pts, 500.0, 256,
                                              overlapping) == \
            ref_theory.containment_probability(pts, 500.0, 256, overlapping)
    diams = np.array([1.0, 2.0, 2.0, 3.0])
    assert theory.retrieval_probability(diams, lambda r: 0.5 / r, 2, 1.0,
                                        2.5) == \
        ref_theory.retrieval_probability(diams, lambda r: 0.5 / r, 2, 1.0,
                                         2.5)


def test_promish_default_matches_reference():
    assert dataclasses.asdict(cfg.PAPER_DEFAULT) == \
        dataclasses.asdict(ref_cfg.PAPER_DEFAULT)
    assert cfg.PAPER_REAL_DATASETS == ref_cfg.PAPER_REAL_DATASETS
    assert cfg.PAPER_SYNTH == ref_cfg.PAPER_SYNTH
    assert dataclasses.asdict(cfg.PromishConfig(m=3, seed=2)) == \
        dataclasses.asdict(ref_cfg.PromishConfig(m=3, seed=2))


# ------------------------------------------------------------ backend knobs
@pytest.mark.parametrize("kw,match", [
    ({"bin_strategy": "log"}, "bin_strategy"),
    ({"route": "host"}, "route"),
    ({"prune_tier": "maybe"}, "prune_tier"),
    ({"prune_dtype": "fp8"}, "prune_dtype")])
def test_backend_knobs_validate_like_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        PallasBackend(**kw)
    with pytest.raises(ValueError, match=match):
        TorchBackend(device="cpu", **kw)


def test_backend_knobs_defaults_match_reference():
    got, want = TorchBackend(device="cpu"), PallasBackend()
    for name in ("quantum", "max_block_bytes", "cache_bytes", "bin_strategy",
                 "n_classes", "route", "prune_tier", "prune_dtype",
                 "prune_eps", "elig_pack_threshold"):
        assert getattr(got, name) == getattr(want, name), name


def _mk(seed=0, n=400, d=6, sizes=(40, 37, 20, 9, 64, 12, 33)):
    rng = np.random.default_rng(seed)
    points = rng.standard_normal((n, d))
    id_lists = [np.sort(rng.choice(n, s, replace=False)).astype(np.int64)
                for s in sizes]
    radii = [float(r) for r in rng.uniform(1.5, 3.0, len(sizes))]
    keys = [ids.tobytes() for ids in id_lists]
    return points, id_lists, radii, keys


def _blocks_equal(got, want):
    for i, (y, x) in enumerate(zip(got, want)):
        assert (y.n, y.slack, y.join_count) == (x.n, x.slack, x.join_count), i
        if x.mask is None or y.mask is None:
            assert y.mask is None and x.mask is None, i
        else:
            np.testing.assert_array_equal(y.mask, x.mask, err_msg=str(i))


@pytest.mark.parametrize("knobs", [
    {"bin_strategy": "pow2"}, {"quantum": 1}, {"quantum": 32},
    {"n_classes": 1}, {"max_block_bytes": 1 << 14}, {"cache_bytes": 0},
    {"prune_tier": "on", "prune_eps": 0.5}])
def test_backend_knobs_leave_blocks_unchanged(knobs):
    """Every knob only reshapes the dispatches: the blocks equal the
    default backend's bit for bit."""
    points, id_lists, radii, keys = _mk(seed=3)
    want = TorchBackend(device="cpu", route="device").self_join_blocks(
        points, id_lists, radii, keys=keys)
    be = TorchBackend(device="cpu", route="device", **knobs)
    got = be.self_join_blocks(points, id_lists, radii, keys=keys)
    if knobs.get("prune_tier") == "on":
        for y, x in zip(got, want):        # a pruned block carries no mask
            assert y.mask is None or np.array_equal(y.mask, x.mask)
    else:
        _blocks_equal(got, want)
    if "max_block_bytes" in knobs:
        assert be.stats.dispatches > 1
    if "bin_strategy" in knobs:
        assert all(p & (p - 1) == 0 for p in be.stats.bin_points)


def _boundary_corpus(seed=7, n_subsets=5, d=8, r=2.0):
    """Subsets whose pair distances straddle r at +/- a few bf16 ulps: the
    adversarial regime for the coarse tier."""
    rng = np.random.default_rng(seed)
    points, id_lists = [], []
    for _ in range(n_subsets):
        base = rng.uniform(-1, 1, d)
        base /= np.linalg.norm(base)
        anchor = rng.uniform(-r, r, d)
        rows = [anchor]
        for k in range(-6, 7, 2):
            rows.append(anchor + base * (r * (1.0 + k * 2.0 ** -9)))
        start = len(points)
        points.extend(rows)
        id_lists.append(np.arange(start, start + len(rows), dtype=np.int64))
    return (np.asarray(points), id_lists, [r] * n_subsets,
            [ids.tobytes() for ids in id_lists])


@pytest.mark.parametrize("prune_dtype", ["bf16", "int8"])
def test_prune_tier_forced_on_bit_identical(prune_dtype):
    """The reference's cascade case on the port's backend: the prune tier
    forced on in either dtype gives the blocks of the tier off, a pruned
    subset only where the fp32 join is provably empty."""
    points, id_lists, radii, keys = _boundary_corpus()
    off = TorchBackend(device="cpu", route="device", prune_tier="off")
    on = TorchBackend(device="cpu", route="device", prune_tier="on",
                      prune_dtype=prune_dtype)
    want = off.self_join_blocks(points, id_lists, radii, keys=keys)
    got = on.self_join_blocks(points, id_lists, radii, keys=keys)
    assert on.stats.prune_tier_dispatches > 0
    for i, (y, x) in enumerate(zip(got, want)):
        assert y.n == x.n and y.slack == x.slack, f"subset {i}"
        if y.mask is None:
            n_live = y.n if y.n_eligible is None else y.n_eligible
            assert y.join_count <= n_live and x.join_count <= n_live
        else:
            np.testing.assert_array_equal(y.mask, x.mask,
                                          err_msg=f"subset {i}")


def test_prune_int8_and_bf16_blocks_identical():
    points, id_lists, radii, keys = _mk(seed=11)
    blocks = [TorchBackend(device="cpu", route="device", prune_tier="on",
                           prune_dtype=dt).self_join_blocks(
                               points, id_lists, radii, keys=keys)
              for dt in ("bf16", "int8")]
    _blocks_equal(*blocks)


@pytest.mark.parametrize("tier", ["exact", "approx"])
def test_engine_answers_equal_across_knobs(tier):
    rds, tds = _pair(6, n=150)
    ref = RefEngine(rds, m=2, n_scales=4, seed=6)
    eng = NKSEngine(tds, m=2, n_scales=4, seed=6, device="cpu")
    qs = [[0, 3], [1, 2, 5], [4, 6, 7]]
    want = [_items(r.candidates) for r in ref.query_batch(
        qs, k=2, tier=tier, backend=PallasBackend(route="device",
                                                  bin_strategy="pow2"))]
    for knobs in ({"bin_strategy": "pow2"}, {"bin_strategy": "quantile"},
                  {"prune_tier": "on", "prune_dtype": "int8"}):
        be = TorchBackend(device="cpu", route="device", **knobs)
        got = [_items(r.candidates) for r in eng.query_batch(
            qs, k=2, tier=tier, backend=be)]
        assert got == want, knobs


# -------------------------------------------------- the reference's tie split
def _tie_corpus():
    """Two translated copies of one pair (keywords 0 and 1; the translation
    exact in fp32, so coordinate differences tie exactly) among 200 filler
    points of other keywords, d=64. Through the norms identity the two
    copies round apart; through coordinate differences they tie."""
    rng = np.random.default_rng(10)
    d = 64
    p = rng.uniform(1100, 1400, d).astype(np.float32)
    q = (p + rng.uniform(-20, 20, d)).astype(np.float32)
    t = (np.round(rng.uniform(0, 500, d) * 8192) / 8192).astype(np.float32)
    pts = np.concatenate([np.stack([p, q, p + t, q + t]),
                          rng.uniform(-1000, 1000, (200, d))]) \
        .astype(np.float32)
    kws = [[0], [1], [0], [1]] + [[int(k)] for k in rng.integers(2, 10, 200)]
    return pts, kws


@pytest.mark.parametrize("tier", ["exact", "approx"])
def test_reference_backends_tie_split_is_kept(tier):
    pts, kws = _tie_corpus()
    assert np.array_equal(pts[2] - pts[0], pts[3] - pts[1])
    ref = RefEngine(ref_make_dataset(pts, kws, n_keywords=10), m=2,
                    n_scales=5, seed=0)
    eng = NKSEngine(make_dataset(pts, kws, n_keywords=10), m=2, n_scales=5,
                    seed=0, device="cpu")
    q = [[0, 1]]
    ref_np = _items(ref.query_batch(q, k=1, tier=tier,
                                    backend="numpy")[0].candidates)
    ref_dev = _items(ref.query_batch(
        q, k=1, tier=tier,
        backend=PallasBackend(route="device"))[0].candidates)
    assert ref_np != ref_dev, "the corpus no longer splits the reference"
    assert {ref_np[0][0], ref_dev[0][0]} == {(0, 1), (2, 3)}
    assert _items(eng.query_batch(q, k=1, tier=tier,
                                  backend="numpy")[0].candidates) == ref_np
    for be in ("torch", TorchBackend(device="cpu", route="device"),
               TorchBackend(device="cpu", route="device", prune_tier="on",
                            prune_dtype="int8")):
        assert _items(eng.query_batch(q, k=1, tier=tier,
                                      backend=be)[0].candidates) == ref_dev
