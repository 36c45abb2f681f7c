"""The port's serving slice against the reference package, on the CPU.

Same seeded corpora and queries through both packages: the generators and
the index build must agree bit for bit, and ``query_batch`` in both tiers
must return *identical* candidates (ids and bitwise-equal float64 diameters)
— the port's numpy backend against the reference's, the port's torch backend
(``device="cpu"``: the kernels' plain versions) against the reference's
Pallas backend. Both device backends settle every candidate in float64 after
an fp32 pruning filter, so their results are bitwise the same whatever the
fp32 masks' rounding. (The numpy backends score candidates through the
norms identity instead, so against them the device backends agree on ids and
to 1e-9 in diameter, as the reference's own tests hold them.)
"""
import numpy as np
import pytest
import torch

from repro.core.backend import PallasBackend
from repro.data.flickr_like import flickr_like_dataset as ref_flickr
from repro.data.synthetic import random_queries as ref_queries
from repro.data.synthetic import synthetic_dataset as ref_synth
from repro.serve.engine import NKSEngine as RefEngine
from repro_torch.core import backend as tbackend
from repro_torch.core.backend import (DispatchCostModel, NumpyBackend,
                                      TorchBackend)
from repro_torch.core.carry import index_to_arrays
from repro_torch.core.index import build_index
from repro_torch.core.subset_search import unpack_join_mask
from repro_torch.data.flickr_like import flickr_like_dataset
from repro_torch.data.synthetic import random_queries, synthetic_dataset
from repro_torch.serve.engine import NKSEngine

torch.set_num_threads(1)

CORPORA = {
    "synth": (ref_synth, synthetic_dataset,
              dict(n=900, d=8, u=24, t=2, seed=1)),
    "flickr": (ref_flickr, flickr_like_dataset,
               dict(n=1200, d=16, u=60, t=4, seed=2)),
}

# route="auto" with an absurdly expensive device: every bin goes to the host
# path (the prune tier stays off on a "cpu" model).
HOST_WINS = DispatchCostModel(platform="cpu", d=0, dev_fixed_s=10.0,
                              dev_cell_s=1.0, prune_cell_s=1.0,
                              host_fixed_s=1e-9, host_cell_s=1e-12)


def _cands(results):
    return [[(c.ids, c.diameter) for c in r.candidates] for r in results]


@pytest.fixture(scope="module", params=sorted(CORPORA))
def pair(request):
    ref_gen, gen, kw = CORPORA[request.param]
    rds, tds = ref_gen(**kw), gen(**kw)
    ref_engine = RefEngine(rds, m=2, n_scales=5, seed=0)
    engine = NKSEngine(tds, m=2, n_scales=5, seed=0, device="cpu")
    queries = ref_queries(rds, 3, 10, seed=5) + ref_queries(rds, 2, 4, seed=6)
    return rds, tds, ref_engine, engine, queries


def test_generators_and_queries_match(pair):
    rds, tds, _, _, queries = pair
    np.testing.assert_array_equal(tds.points, rds.points)
    for a, b in ((tds.kw, rds.kw), (tds.ikp, rds.ikp)):
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.values, b.values)
    assert tds.n_keywords == rds.n_keywords
    assert random_queries(tds, 3, 10, seed=5) == queries[:10]


@pytest.mark.parametrize("exact", [True, False])
def test_index_build_matches(pair, exact):
    _, tds, ref_engine, engine, _ = pair
    want = ref_engine.index_e if exact else ref_engine.index_a
    got = engine.index_e if exact else engine.index_a
    assert (got.w0, got.p_max, got.n_scales, got.exact) == \
        (want.w0, want.p_max, want.n_scales, want.exact)
    np.testing.assert_array_equal(got.z, want.z)
    for hg, hw in zip(got.structures, want.structures):
        assert (hg.width, hg.n_buckets) == (hw.width, hw.n_buckets)
        for a, b in ((hg.table, hw.table), (hg.khb, hw.khb)):
            np.testing.assert_array_equal(a.offsets, b.offsets)
            np.testing.assert_array_equal(a.values, b.values)


@pytest.mark.parametrize("tier", ["exact", "approx"])
def test_query_batch_identical_to_reference(pair, tier):
    _, _, ref_engine, engine, queries = pair
    ref_np = _cands(ref_engine.query_batch(queries, k=2, tier=tier,
                                           backend="numpy"))
    ref_dev = _cands(ref_engine.query_batch(
        queries, k=2, tier=tier, backend=PallasBackend(route="device")))
    assert _cands(engine.query_batch(queries, k=2, tier=tier,
                                     backend="numpy")) == ref_np
    got = _cands(engine.query_batch(queries, k=2, tier=tier))
    assert got == ref_dev
    forced = _cands(engine.query_batch(
        queries, k=2, tier=tier,
        backend=TorchBackend(device="cpu", route="device")))
    assert forced == ref_dev
    # device vs numpy backends: same ids, diameters to 1e-9
    for g, w in zip(got, ref_np):
        assert [ids for ids, _ in g] == [ids for ids, _ in w]
        np.testing.assert_allclose([x for _, x in g], [x for _, x in w],
                                   rtol=1e-9)


@pytest.mark.parametrize("tier", ["exact", "approx"])
def test_prune_tier_armed_identical(pair, tier):
    _, _, ref_engine, engine, queries = pair
    want = _cands(ref_engine.query_batch(
        queries, k=2, tier=tier,
        backend=PallasBackend(route="device", prune_tier="on")))
    be = TorchBackend(device="cpu", route="device", prune_tier="on")
    assert _cands(engine.query_batch(queries, k=2, tier=tier,
                                     backend=be)) == want
    if tier == "exact":
        assert be.stats.prune_tier_dispatches > 0
        assert engine.last_batch_stats.prune_tier_dispatches > 0


def test_host_route_invisible(pair):
    _, _, _, engine, queries = pair
    dev = TorchBackend(device="cpu", route="device")
    host = TorchBackend(device="cpu", cost_model=HOST_WINS)
    a = _cands(engine.query_batch(queries, k=2, tier="exact", backend=dev))
    b = _cands(engine.query_batch(queries, k=2, tier="exact", backend=host))
    assert a == b
    assert host.stats.host_routed_dispatches > 0
    assert dev.stats.host_routed_dispatches == 0


@pytest.mark.parametrize("tier", ["exact", "approx"])
def test_per_query_search_matches(pair, tier):
    _, _, ref_engine, engine, queries = pair
    for q in queries[:6]:
        want = ref_engine.query(q, k=2, tier=tier)
        got = engine.query(q, k=2, tier=tier)
        assert [(c.ids, c.diameter) for c in got.candidates] == \
            [(c.ids, c.diameter) for c in want.candidates]


def test_engine_carried_across_answers_the_same(pair):
    """An engine rebuilt from the arrays of a reference engine (corpus and
    both indices, read off its objects) answers as the reference does."""
    rds, _, ref_engine, _, queries = pair

    def arrays(ix):
        return dict(z=ix.z, p_max=ix.p_max, n_scales=ix.n_scales,
                    exact=ix.exact,
                    scales=[dict(width=h.width, n_buckets=h.n_buckets,
                                 table_offsets=h.table.offsets,
                                 table_values=h.table.values,
                                 khb_offsets=h.khb.offsets,
                                 khb_values=h.khb.values)
                            for h in ix.structures])

    carried = NKSEngine.from_arrays(
        rds.points, rds.kw.offsets, rds.kw.values, rds.n_keywords,
        index_e=arrays(ref_engine.index_e),
        index_a=arrays(ref_engine.index_a), device="cpu")
    np.testing.assert_array_equal(carried.dataset.ikp.values, rds.ikp.values)
    for tier in ("exact", "approx"):
        want = _cands(ref_engine.query_batch(
            queries, k=2, tier=tier, backend=PallasBackend(route="device")))
        assert _cands(carried.query_batch(queries, k=2, tier=tier)) == want
        assert _cands(carried.query_batch(queries, k=2, tier=tier,
                                          backend="numpy")) == \
            _cands(ref_engine.query_batch(queries, k=2, tier=tier,
                                          backend="numpy"))


def test_index_round_trips_through_arrays(pair):
    _, tds, _, engine, queries = pair
    again = NKSEngine.from_arrays(
        tds.points, tds.kw.offsets, tds.kw.values, tds.n_keywords,
        index_e=index_to_arrays(engine.index_e),
        index_a=index_to_arrays(engine.index_a), device="cpu")
    assert _cands(again.query_batch(queries, k=1, tier="exact")) == \
        _cands(engine.query_batch(queries, k=1, tier="exact"))


# ---------------------------------------------------------- backend level
def _subsets(seed=0, n=400, d=6, sizes=(40, 37, 20, 9, 64, 12, 33, 1)):
    rng = np.random.default_rng(seed)
    points = (rng.standard_normal((n, d)) * 30).astype(np.float32)
    id_lists = [np.sort(rng.choice(n, s, replace=False)).astype(np.int64)
                for s in sizes]
    radii = [float(r) for r in rng.uniform(45.0, 90.0, len(sizes))]
    return points, id_lists, radii


def test_slack_bitwise_equal_to_reference():
    points, id_lists, _ = _subsets(seed=3)
    be = TorchBackend(device="cpu")
    be.attach(points)
    for ids in id_lists:
        assert be._slack(ids, points.shape[1]) == \
            PallasBackend._slack(points[ids])


def test_blocks_keep_the_pruning_contract():
    """Every true pair at radius r is in the block's mask; any extra pair
    lies within twice the slack of r. The prune tier only drops subsets
    whose fp32 join is empty off the diagonal."""
    points, id_lists, radii = _subsets(seed=4)
    keys = [ids.tobytes() for ids in id_lists]
    for prune in ("off", "on"):
        be = TorchBackend(device="cpu", route="device", prune_tier=prune)
        blocks = be.self_join_blocks(points, id_lists, radii, keys=keys)
        for i, (y, ids) in enumerate(zip(blocks, id_lists)):
            pts = points[ids].astype(np.float64)
            dist = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
            exact = dist <= radii[i]
            assert y.n == len(ids) and y.rescore
            if y.mask is None:                       # pruned: join empty
                assert prune == "on"
                assert exact.sum() == len(ids) and y.join_count <= y.n
                continue
            got = unpack_join_mask(y.mask, y.n).astype(bool)
            assert (got | ~exact).all(), f"subset {i}: dropped pair"
            extra = got & ~exact
            if extra.any():
                assert dist[extra].min() <= radii[i] + 2 * y.slack + 1e-6
            assert y.join_count == int(got.sum())
        assert be.stats.dispatches > 0
        # a repeated call hits the device-tile cache
        hits = be.stats.cache_hits
        be.self_join_blocks(points, id_lists, radii, keys=keys)
        assert be.stats.cache_hits > hits


def test_backend_pairwise_matches_numpy():
    points, id_lists, _ = _subsets(seed=5)
    a, b = points[id_lists[0]], points[id_lists[4]]
    got = TorchBackend(device="cpu").pairwise(a, b)
    want = NumpyBackend().pairwise(a, b)
    # fp32 identity error is absolute in the squared distance (the slack
    # bound), so compare squares
    norm2 = (points.astype(np.float64) ** 2).sum(-1).max()
    np.testing.assert_allclose(got ** 2, want ** 2, rtol=0,
                               atol=(64 + 4 * a.shape[1]) * 2.0 ** -23 * norm2)


def test_no_card_no_silent_host_path(monkeypatch):
    """Without CUDA, entry points refuse to pick the host on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = synthetic_dataset(n=50, d=4, u=6, t=2, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NKSEngine(ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbackend.calibrate_cost_model(4, None)


def test_unknown_backend_and_tier_rejected():
    ds = synthetic_dataset(n=60, d=4, u=6, t=2, seed=0)
    engine = NKSEngine(ds, device="cpu")
    with pytest.raises(ValueError):
        engine.query_batch([[0, 1]], backend="pallas")
    with pytest.raises(ValueError):
        engine.query_batch([[0, 1]], tier="nope")
    with pytest.raises(ValueError):
        engine.query([0, 1], tier="nope")
    with pytest.raises(ValueError):
        engine.query_batch([[0, 99]])
    # the device tier is served now (tests/test_torch_device_tier.py)
    assert len(engine.query_batch([[0, 1]], tier="device")) == 1
    assert engine.query_batch([], tier="exact") == []


def test_build_index_deterministic():
    ds = synthetic_dataset(n=200, d=5, u=10, t=2, seed=4)
    a, b = build_index(ds, seed=3), build_index(ds, seed=3)
    np.testing.assert_array_equal(a.z, b.z)
    np.testing.assert_array_equal(a.structures[2].table.values,
                                  b.structures[2].table.values)
