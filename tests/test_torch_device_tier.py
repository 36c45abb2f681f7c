"""The port's anchor-star device tier against the reference package, on the
CPU.

Same seeded inputs through both packages: K6's plain version
(``kernels.ref.tuple_diameters``) against the reference's Pallas kernel in
interpret mode and its jnp reference; ``pack_groups`` and the device-side
gather against the reference's host packing; ``nks_anchor_topk`` and the
engine's ``tier="device"`` against the reference's. Candidate ids must be
identical; diameters agree within ``rtol 1e-5`` plus the fp32 band of the
norms identity, ``sqrt((64 + 4d) eps32 max|x - c|^2)`` over the centred
points (``core.distributed.diameter_band``): the two packages sum the same
fp32 products in different orders, and a diameter may be 0, so no bare
relative tolerance is used.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import brute_force
from repro.core.device_plane import pack_groups as ref_pack_groups
from repro.core.distributed import nks_anchor_topk as ref_nks_anchor_topk
from repro.data.flickr_like import flickr_like_dataset as ref_flickr
from repro.data.synthetic import random_queries as ref_queries
from repro.data.synthetic import synthetic_dataset as ref_synth
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.serve.engine import NKSEngine as RefEngine
from repro_torch.core.device_plane import (gather_groups, pack_group_ids,
                                           pack_groups)
from repro_torch.core.distributed import diameter_band, nks_anchor_topk
from repro_torch.core.types import make_dataset
from repro_torch.data.flickr_like import flickr_like_dataset
from repro_torch.data.synthetic import synthetic_dataset
from repro_torch.kernels import ops
from repro_torch.serve.engine import NKSEngine

torch.set_num_threads(1)

_EPS32 = float(np.finfo(np.float32).eps)

# The corpora of test_torch_engine.py.
CORPORA = {
    "synth": (ref_synth, synthetic_dataset,
              dict(n=900, d=8, u=24, t=2, seed=1)),
    "flickr": (ref_flickr, flickr_like_dataset,
               dict(n=1200, d=16, u=60, t=4, seed=2)),
}


def _band(ds, query) -> float:
    pg = pack_groups(ds, query)
    return diameter_band(pg.groups, pg.mask)


def _tuple_band(x: np.ndarray) -> np.ndarray:
    """(T,) band of the norms identity over each tuple's own points."""
    norm2 = (x.astype(np.float64) ** 2).sum(-1).max(-1)
    return np.sqrt((64.0 + 4.0 * x.shape[-1]) * _EPS32 * norm2)


@pytest.mark.parametrize("d", [3, 16, 64])
@pytest.mark.parametrize("q", range(1, 10))
def test_tuple_diameters_plain_matches_reference(q, d):
    rng = np.random.default_rng(q * 100 + d)
    for t in (1, 37, 131):          # off the reference's 128 and K6's 8 blocks
        x = (rng.standard_normal((t, q, d)) * 50
             + rng.uniform(-100, 100, (t, 1, d))).astype(np.float32)
        got = ops.tuple_diameters(torch.from_numpy(x)).numpy()
        assert got.shape == (t,) and got.dtype == np.float32
        tol = 1e-5 * np.abs(got) + _tuple_band(x)
        for want in (ref_ops.tuple_diameters(jnp.asarray(x), interpret=True),
                     ref_kernels.tuple_diameters_ref(jnp.asarray(x))):
            assert (np.abs(got - np.asarray(want)) <= tol).all()
        # float64 truth by coordinate differences
        x64 = x.astype(np.float64)
        truth = np.sqrt(((x64[:, :, None] - x64[:, None, :]) ** 2)
                        .sum(-1).max(axis=(1, 2)))
        assert (np.abs(got - truth) <= tol).all()
        if q < 9:
            # padding by repeating a member keeps the diameter
            xp = np.concatenate([x, np.repeat(x[:, -1:], 9 - q, axis=1)], 1)
            padded = ops.tuple_diameters(torch.from_numpy(xp)).numpy()
            assert (np.abs(padded - got) <= _tuple_band(x)).all()


@pytest.fixture(scope="module", params=sorted(CORPORA))
def pair(request):
    ref_gen, gen, kw = CORPORA[request.param]
    rds, tds = ref_gen(**kw), gen(**kw)
    queries = ref_queries(rds, 3, 8, seed=5) + ref_queries(rds, 2, 3, seed=6) \
        + ref_queries(rds, 5, 3, seed=7)
    return rds, tds, queries


def test_pack_groups_matches_reference(pair):
    rds, tds, queries = pair
    for query in queries:
        want = ref_pack_groups(rds, query)
        got = pack_groups(tds, query)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got.ids.dtype == np.int32 and got.groups.dtype == np.float32
        assert (got.truncated, got.group_sizes) == (want.truncated,
                                                    want.group_sizes)
        assert got.ids.shape[1] % 128 == 0
        ids_only = pack_group_ids(tds, query)
        assert ids_only.groups is None
        np.testing.assert_array_equal(ids_only.mask, got.mask)
        np.testing.assert_array_equal(ids_only.ids, got.ids)


def test_pack_groups_truncation_matches_reference(pair):
    rds, tds, queries = pair
    query = max(queries, key=lambda q: max(len(rds.points_with(v))
                                           for v in q))
    for r_max in (4, 7, 1000):
        want = ref_pack_groups(rds, query, r_max=r_max)
        got = pack_groups(tds, query, r_max=r_max)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert (got.truncated, got.group_sizes) == (want.truncated,
                                                    want.group_sizes)
    assert got.truncated == 0
    assert pack_groups(tds, query, r_max=4).truncated > 0
    with pytest.raises(ValueError, match="truncated"):
        pack_groups(tds, query, r_max=4, strict=True)
    with pytest.raises(ValueError, match="truncated"):
        ref_pack_groups(rds, query, r_max=4, strict=True)


def test_device_gather_matches_host_pack(pair):
    _, tds, queries = pair
    points = torch.from_numpy(tds.points)
    for query in queries:
        pg = pack_groups(tds, query)
        got = gather_groups(points, torch.from_numpy(pg.mask),
                            torch.from_numpy(pg.ids))
        np.testing.assert_array_equal(got.numpy(), pg.groups)


def _anchor_both(rds, tds, query, k, **kw):
    rg, rm, ri = ref_pack_groups(rds, query)
    want_d, want_c = ref_nks_anchor_topk(jnp.asarray(rg), jnp.asarray(rm),
                                         jnp.asarray(ri), k)
    pg = pack_groups(tds, query)
    got_d, got_c = nks_anchor_topk(*(torch.from_numpy(a) for a in pg), k, **kw)
    return (np.asarray(want_d), np.asarray(want_c), got_d.numpy(),
            got_c.numpy(), diameter_band(pg.groups, pg.mask))


@pytest.mark.parametrize("k", [1, 5])
def test_nks_anchor_topk_matches_reference(pair, k):
    rds, tds, queries = pair
    for query in queries:
        want_d, want_c, got_d, got_c, band = _anchor_both(rds, tds, query, k)
        np.testing.assert_array_equal(got_c, want_c)
        assert got_c.dtype == np.int32 and got_d.dtype == np.float32
        fin = np.isfinite(want_d)
        np.testing.assert_array_equal(np.isfinite(got_d), fin)
        assert (np.abs(got_d[fin] - want_d[fin])
                <= 1e-5 * np.abs(want_d[fin]) + band).all()
        assert (np.diff(got_d[fin]) >= 0).all()


def test_nks_anchor_topk_chunked_matches_unchunked(pair):
    _, tds, queries = pair
    for query in queries:
        pg = pack_groups(tds, query)
        args = [torch.from_numpy(a) for a in pg]
        whole_d, whole_c = nks_anchor_topk(*args, 5)
        r = pg.ids.shape[1]
        for rows in (1, 7, 100):
            d, c = nks_anchor_topk(*args, 5, block_bytes=4 * r * rows)
            np.testing.assert_array_equal(c.numpy(), whole_c.numpy())
            fin = np.isfinite(whole_d.numpy())
            assert (np.abs(d.numpy()[fin] - whole_d.numpy()[fin])
                    <= diameter_band(pg.groups, pg.mask)).all()


@pytest.fixture(scope="module")
def engines(pair):
    rds, tds, queries = pair
    return (RefEngine(rds, m=2, n_scales=5, seed=0),
            NKSEngine(tds, m=2, n_scales=5, seed=0, device="cpu"), queries)


def _assert_same_candidates(got, want, bands):
    assert len(got) == len(want)
    for g, w, band in zip(got, want, bands):
        assert g.tier == w.tier == "device" and g.query == w.query
        assert [c.ids for c in g.candidates] == [c.ids for c in w.candidates]
        for cg, cw in zip(g.candidates, w.candidates):
            assert abs(cg.diameter - cw.diameter) \
                <= 1e-5 * abs(cw.diameter) + band


@pytest.mark.parametrize("k", [1, 3])
def test_engine_device_tier_matches_reference(engines, k):
    ref_engine, engine, queries = engines
    bands = [_band(engine.dataset, q) for q in queries]
    want = ref_engine.query_batch(queries, k=k, tier="device")
    got = engine.query_batch(queries, k=k, tier="device")
    _assert_same_candidates(got, want, bands)
    st = engine.last_batch_stats
    assert (st.tier, st.backend, st.batch_size) == ("device", "anchor",
                                                   len(queries))
    assert st.shard_dispatches == [len(queries)]
    assert st.t_pack_s > 0 and st.t_dispatch_s > 0
    assert st.h2d_bytes > 0 and st.d2h_bytes > 0
    assert len({r.latency_s for r in got}) == 1
    singles = [engine.query(q, k=k, tier="device") for q in queries]
    _assert_same_candidates(
        singles, [ref_engine.query(q, k=k, tier="device") for q in queries],
        bands)
    assert [[(c.ids, c.diameter) for c in r.candidates] for r in singles] \
        == [[(c.ids, c.diameter) for c in r.candidates] for r in got]


def test_engine_device_tier_anchor_is_first_keyword(engines):
    """The anchors are the first keyword as given, not the rarest: reordering
    a query changes the candidates in both packages alike."""
    ref_engine, engine, queries = engines
    for query in queries[:4]:
        for order in (query, query[::-1]):
            band = _band(engine.dataset, order)
            _assert_same_candidates(
                [engine.query(order, k=2, tier="device")],
                [ref_engine.query(order, k=2, tier="device")], [band])


def test_engine_device_tier_refuses_bad_input(engines):
    _, engine, _ = engines
    with pytest.raises(ValueError):
        engine.query_batch([[0, 1]], tier="nope")
    with pytest.raises(ValueError, match="dictionary"):
        engine.query_batch([[0, engine.dataset.n_keywords]], tier="device")
    with pytest.raises(ValueError, match="dictionary"):
        engine.query([-1, 0], tier="device")


def test_device_tier_within_2x_of_brute_force():
    """The triangle-inequality guarantee, on the corpus of the reference's
    own device-tier test: opt - band <= device <= 2 opt + band."""
    kw = dict(n=1_500, d=16, u=30, t=3, n_clusters=10, seed=4)
    rds, tds = ref_flickr(**kw), flickr_like_dataset(**kw)
    engine = NKSEngine(tds, m=2, n_scales=5, seed=0, device="cpu")
    for query in ref_queries(rds, 3, 6, seed=2):
        res = engine.query(query, k=1, tier="device")
        opt = brute_force.search(rds, query, k=1).items[0].diameter
        band = _band(tds, query)
        assert res.candidates, f"no device-tier result for {query}"
        got = res.candidates[0].diameter
        assert opt - band <= got <= 2.0 * opt + band


def _tiny_corpus():
    """12 points; keyword 0 tags three, keyword 3 tags none."""
    rng = np.random.default_rng(3)
    points = rng.uniform(0, 50, (12, 4)).astype(np.float32)
    keywords = [[0, 1] if i < 3 else [1, 2] if i % 2 else [2]
                for i in range(12)]
    return points, keywords


def test_empty_group_and_few_anchors_match_reference():
    from repro.core.types import make_dataset as ref_make_dataset
    points, keywords = _tiny_corpus()
    tds = make_dataset(points, keywords, n_keywords=4)
    rds = ref_make_dataset(points, keywords, n_keywords=4)
    engine = NKSEngine(tds, m=2, n_scales=3, seed=0, device="cpu")
    ref_engine = RefEngine(rds, m=2, n_scales=3, seed=0)
    # an empty keyword: no candidate at all, whichever position it takes
    for query in ([0, 3], [3, 1], [2, 3, 1], [3]):
        got = engine.query(query, k=2, tier="device")
        assert got.candidates == []
        assert ref_engine.query(query, k=2, tier="device").candidates == []
        pg = pack_groups(tds, query)
        assert pg.ids.shape[1] == 128 and not pg.mask[query.index(3)].any()
    # k above the valid anchors: three anchors of keyword 0, three answers
    for query in ([0, 2], [0, 1, 2], [0]):
        got = engine.query_batch([query], k=10, tier="device")
        want = ref_engine.query_batch([query], k=10, tier="device")
        band = _band(tds, query)
        assert len(got[0].candidates) == 3
        _assert_same_candidates(got, want, [band])
    # one keyword: every anchor alone, diameter 0 up to the band
    band = _band(tds, [0])
    assert all(c.diameter <= band and len(c.ids) == 1
               for c in engine.query([0], k=3, tier="device").candidates)
