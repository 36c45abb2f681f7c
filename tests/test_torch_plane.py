"""The port's serving plane (``core.device_plane.DevicePlane``) on the CPU.

In process: an 8-shard plane whose shards are all ``cpu`` against the
port's single device, bit for bit — the sharded masked join and the bf16
and int8 prune counts (with zero-length subsets and eligibility words),
``TorchBackend(plane=)`` blocks across uneven bins (thin bins and the
budget's demotion to one device, on 8 and 4 shards), and the engine's exact,
approx, filtered and flexible-semantics answers. The device tier on the
plane gives the single device's ids, and diameters within rtol 1e-5 plus
the fp32 band of ``core.distributed.diameter_band``: on the CPU each
shard's plain version multiplies its own slice of anchors, whose product
may round otherwise than the whole one (on the card the kernel's rows are
the same bits; ``tests/test_torch_cuda.py -k plane``). ``balance_order``
and ``shard_cells`` equal the reference's; the reference's one-shard plane
(the default single CPU device of ``jax``) equals the port's one-shard
plane on joins, engine answers and the per-shard counters.

In a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(the device count is fixed at ``jax``'s first use), this file's
``__main__`` holds the reference's 8-shard plane against the port's:
identical masks, counts, engine answers and per-shard counters
(``sharded_dispatches``, ``shard_dispatches``, ``shard_valid_cells``,
``shard_total_cells``), and ``distributed_nks_topk`` with equal ids and
diameters within rtol 1e-5 plus the band (``tests/test_torch_anchor_star.py``'s
tolerance).
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro.core.backend import PallasBackend
from repro.core.device_plane import DevicePlane as RefPlane
from repro.core.device_plane import balance_order as ref_balance_order
from repro.data.synthetic import attach_attrs as ref_attach_attrs
from repro.data.synthetic import random_queries as ref_queries
from repro.data.synthetic import synthetic_dataset as ref_synth
from repro.kernels import ops as ref_ops
from repro.serve.engine import NKSEngine as RefEngine
from repro_torch.core import distributed
from repro_torch.core.backend import TorchBackend
from repro_torch.core.device_plane import (DevicePlane, balance_order,
                                           get_plane, pack_groups,
                                           replicated_topk_merge)
from repro_torch.core.filters import where
from repro_torch.core.subset_search import pack_join_mask
from repro_torch.data.synthetic import (attach_attrs, random_queries,
                                        synthetic_dataset)
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_local_mesh, make_serving_mesh
from repro_torch.serve.engine import NKSEngine

torch.set_num_threads(1)

PLANE = DevicePlane(make_local_mesh(8, device="cpu"))
SIZES = [40, 44, 37, 41, 39, 45, 42, 38, 40, 43,     # class 64: sharded
         9, 11, 10]                                   # class 16: one device
RADII = [2.5] * 10 + [3.0, float("inf"), 2.0]


def _cands(results):
    return [[(c.ids, c.diameter, c.score) for c in r.candidates]
            for r in results]


def _tile(seed: int, s: int = 16, p: int = 64, d: int = 8):
    """A packed (S, P, d) tile with a zero-length subset, an all-empty slab
    (shard 4's), radii and eligibility words."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, p, d)).astype(np.float32)
    lengths = rng.integers(1, p + 1, s).astype(np.int32)
    lengths[3] = 0
    lengths[8:10] = 0
    x[np.arange(p)[None, :] >= lengths[:, None]] = 0.0
    r = rng.uniform(0.5, 4.0, s).astype(np.float32)
    r[5] = 0.0
    el = rng.random((s, p)) < 0.6
    return x, lengths, r, pack_join_mask(el).view(np.int32)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("fold", [False, True])
def test_sharded_join_bit_for_bit(fold):
    x, lengths, r, words = _tile(0)
    args = _t(x, lengths, r, words if fold else None)
    m8, c8 = PLANE.join_batched_masked(*args)
    m1, c1 = ops.pairwise_l2_join_batched_masked(*args)
    assert torch.equal(m8, m1) and torch.equal(c8, c1)
    assert not m8[3].any() and not m8[8:10].any() and int(c8[8]) == 0


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("fold", [False, True])
def test_sharded_counts_bit_for_bit(dtype, fold):
    x, lengths, r, words = _tile(1)
    args = _t(x, lengths, r * 1.5, words if fold else None)
    got = PLANE.join_batched_counts(*args, dtype=dtype)
    assert torch.equal(got, ops.pairwise_l2_join_batched_counts(
        *args, dtype=dtype))


def test_plane_refuses_uneven_slabs_and_mixed_devices():
    x, lengths, r, _ = _tile(2, s=12)
    with pytest.raises(ValueError, match="n_shards"):
        PLANE.join_batched_masked(*_t(x, lengths, r))
    with pytest.raises(ValueError, match="R % n_shards"):
        PLANE.nks_topk(torch.zeros((2, 12, 3)),
                       torch.ones((2, 12), dtype=torch.bool),
                       torch.zeros((2, 12), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        DevicePlane(["cpu", "cuda:0"])


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_balance_order_and_shard_cells_match_reference(n_shards, seed):
    rng = np.random.default_rng(seed)
    s = n_shards * int(rng.integers(1, 9))
    lengths = rng.integers(0, 300, s)
    lengths[: s // 3] = np.sort(lengths[: s // 3])[::-1]   # near-sorted run
    perm = balance_order(lengths, n_shards)
    np.testing.assert_array_equal(perm, ref_balance_order(lengths, n_shards))
    assert sorted(perm.tolist()) == list(range(s))
    plane = DevicePlane(make_local_mesh(n_shards, device="cpu"))
    fake = types.SimpleNamespace(n_shards=n_shards)
    assert plane.shard_cells(lengths[perm], 320) \
        == RefPlane.shard_cells(fake, lengths[perm], 320)


def test_get_plane_resolution(monkeypatch):
    assert get_plane(PLANE) is PLANE
    assert get_plane(["cpu", "cpu"]).n_shards == 2
    monkeypatch.setenv("REPRO_MESH_OVERRIDE", "4,1")
    assert get_plane("auto", device="cpu").devices \
        == (torch.device("cpu"),) * 4
    assert get_plane(None, device="cpu").n_shards == 4
    assert make_serving_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    monkeypatch.delenv("REPRO_MESH_OVERRIDE")
    assert get_plane("auto", device="cpu").n_shards == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_serving_mesh(8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_plane("auto")
    plane = get_plane(["cpu"] * 3)
    assert plane.shard_pad(7) == 9 and plane.device == torch.device("cpu")


def _blocks_equal(got, want):
    for i, (x, y) in enumerate(zip(want, got)):
        assert (x.n, x.join_count, x.slack, x.n_eligible) \
            == (y.n, y.join_count, y.slack, y.n_eligible), f"subset {i}"
        if x.mask is None:
            assert y.mask is None, f"subset {i}"
        else:
            np.testing.assert_array_equal(y.mask, x.mask,
                                          err_msg=f"subset {i}")


def _bins(seed: int):
    rng = np.random.default_rng(seed)
    points = rng.standard_normal((600, 10))
    id_lists = [np.sort(rng.choice(600, n, replace=False)).astype(np.int64)
                for n in SIZES]
    return rng, points, id_lists, [ids.tobytes() for ids in id_lists]


@pytest.mark.parametrize("n_shards", [8, 4])
@pytest.mark.parametrize("prune", [("off", "bf16"), ("on", "bf16"),
                                   ("on", "int8")])
@pytest.mark.parametrize("filtered", [False, True])
def test_backend_plane_blocks_bit_for_bit(n_shards, prune, filtered):
    """Uneven bins: the class of 10 subsets shards, the class of 3 stays on
    one device, an infinite radius skips the device; the cached tile gives
    the same blocks, and so does a tight budget that chunks the bins and
    demotes those whose shard-rounded tile would exceed it."""
    plane = PLANE if n_shards == 8 \
        else DevicePlane(make_local_mesh(n_shards, device="cpu"))
    rng, points, id_lists, keys = _bins(1)
    eligible = rng.random(600) < 0.5 if filtered else None
    kw = dict(route="device", bin_strategy="pow2", prune_tier=prune[0],
              prune_dtype=prune[1])
    single = TorchBackend(device="cpu", **kw)
    want = single.self_join_blocks(points, id_lists, RADII, keys=keys,
                                   eligible=eligible)
    shard = TorchBackend(plane=plane, **kw)
    assert shard.device == torch.device("cpu")
    got = shard.self_join_blocks(points, id_lists, RADII, keys=keys,
                                 eligible=eligible)
    _blocks_equal(got, want)
    st = shard.stats
    assert st.sharded_dispatches == 1 and st.dispatches == 2
    assert st.shard_dispatches == [2] + [1] * (n_shards - 1)
    assert all(0.0 <= v / t <= 1.0 for v, t in zip(st.shard_valid_cells,
                                                    st.shard_total_cells))
    if prune[0] == "off":
        assert 0.0 < st.t_collective_s <= st.t_dispatch_s
    again = shard.self_join_blocks(points, id_lists, RADII, keys=keys,
                                   eligible=eligible)
    _blocks_equal(again, want)
    assert shard.stats.cache_hits > 0
    tight = TorchBackend(plane=plane, max_block_bytes=64 << 10, **kw)
    _blocks_equal(tight.self_join_blocks(points, id_lists, RADII, keys=keys,
                                         eligible=eligible), want)
    assert tight.stats.dispatches > tight.stats.sharded_dispatches


def test_backend_budget_demotes_a_bin_to_one_device():
    """A bin whose smallest shard-rounded tile exceeds ``max_block_bytes``
    dispatches on one device at its exact size, as in the reference: on a
    3-shard plane a chunk of 8 subsets of class 64 fits at S=8 (32,768
    cells) but not at the shard multiple S=9 (36,864) under a budget of
    34,000 cells."""
    _, points, id_lists, keys = _bins(2)
    ids, radii, keys = id_lists[:10], RADII[:10], keys[:10]
    kw = dict(route="device", bin_strategy="pow2", max_block_bytes=136_000)
    want = TorchBackend(device="cpu", **kw).self_join_blocks(
        points, ids, radii, keys=keys)
    be = TorchBackend(plane=DevicePlane(make_local_mesh(3, device="cpu")),
                      **kw)
    _blocks_equal(be.self_join_blocks(points, ids, radii, keys=keys), want)
    assert be.stats.dispatches == 2 and be.stats.sharded_dispatches == 0
    assert be.stats.shard_dispatches == [2, 0, 0]
    assert be.stats.shard_total_cells == [2 * 8 * 64 * 64, 0, 0]
    with pytest.raises(ValueError, match="first device"):
        TorchBackend(plane=DevicePlane(make_local_mesh(2, device="cpu")),
                     device="cuda")


@pytest.fixture(scope="module")
def engines():
    ds = attach_attrs(synthetic_dataset(n=500, d=8, u=20, t=2, seed=3),
                      seed=9)
    one = NKSEngine(ds, m=2, n_scales=5, seed=0, device="cpu")
    eight = NKSEngine(ds, m=2, n_scales=5, seed=0, mesh=PLANE)
    queries = random_queries(ds, 2, 12, seed=5) \
        + random_queries(ds, 3, 12, seed=6)
    return ds, one, eight, queries


ROUTES = {"default": {}, "forced": dict(route="device"),
          "forced-prune": dict(route="device", prune_tier="on"),
          "forced-int8": dict(route="device", prune_tier="on",
                              prune_dtype="int8")}
FILTERS = {"none": None, "price<55": where(("price", "<", 55.0)),
           "thin": where(("price", "<", 8.0), ("category", "in", [0, 1, 2])),
           "empty": where(("price", "<", -1.0))}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("flt", sorted(FILTERS))
@pytest.mark.parametrize("tier", ["exact", "approx"])
def test_engine_plane_answers_bit_for_bit(engines, tier, flt, route):
    _, one, eight, queries = engines
    kw = ROUTES[route]
    b1 = TorchBackend(device="cpu", **kw) if kw else "torch"
    b8 = TorchBackend(plane=PLANE, **kw) if kw else "torch"
    want = one.query_batch(queries, k=2, tier=tier, backend=b1,
                           filter=FILTERS[flt])
    got = eight.query_batch(queries, k=2, tier=tier, backend=b8,
                            filter=FILTERS[flt])
    assert _cands(got) == _cands(want)
    st = eight.last_batch_stats
    if kw and st.device_dispatches:
        assert len(st.shard_dispatches) == 8
        assert all(0.0 <= u <= 1.0 for u in st.shard_utilisation)
        assert st.sharding["shard_dispatches"] == st.shard_dispatches
    if kw and tier == "exact" and flt == "none":
        assert st.sharded_dispatches > 0
        assert sum(st.shard_dispatches[1:]) > 0
        assert 0.0 < st.t_collective_s <= st.t_dispatch_s


@pytest.mark.parametrize("sem", [{"m": 2}, {"weights": {0: 2.5}},
                                 {"m": 2, "score": True}])
@pytest.mark.parametrize("tier", ["exact", "approx"])
def test_engine_plane_semantics_bit_for_bit(engines, tier, sem):
    _, one, eight, queries = engines
    qs = queries[12:]
    want = one.query_batch(qs, k=2, tier=tier,
                           backend=TorchBackend(device="cpu",
                                                route="device"),
                           semantics=sem)
    got = eight.query_batch(qs, k=2, tier=tier,
                            backend=TorchBackend(plane=PLANE,
                                                 route="device"),
                            semantics=sem)
    assert _cands(got) == _cands(want)


def test_device_tier_on_plane(engines):
    """The sharded anchor-star search: the single device's ids, diameters
    within rtol 1e-5 plus the band; K6's plain version once a shard;
    sharded accounting."""
    ds, one, eight, queries = engines
    qs = queries[12:]
    want = one.query_batch(qs, k=3, tier="device")
    got = eight.query_batch(qs, k=3, tier="device")
    for q, g, w in zip(qs, got, want):
        pg = pack_groups(ds, q)
        band = distributed.diameter_band(pg.groups, pg.mask)
        assert [c.ids for c in g.candidates] == [c.ids for c in w.candidates]
        for cg, cw in zip(g.candidates, w.candidates):
            assert abs(cg.diameter - cw.diameter) \
                <= 1e-5 * abs(cw.diameter) + band
    st = eight.last_batch_stats
    assert st.backend == "device-plane" and st.tier == "device"
    assert st.shard_dispatches == [len(qs)] * 8
    assert st.sharded_dispatches == len(qs)
    assert 0.0 < st.t_collective_s <= st.t_dispatch_s
    assert one.last_batch_stats.shard_dispatches == [len(qs)]
    single = eight.query(qs[0], k=3, tier="device")
    assert [c.ids for c in single.candidates] \
        == [c.ids for c in got[0].candidates]


def test_engine_mesh_auto_recover_and_store(tmp_path, monkeypatch, engines):
    """``mesh="auto"`` takes ``REPRO_MESH_OVERRIDE``; ``recover(mesh=)`` and
    ``from_store(mesh=)`` attach the plane and answer as the single
    device."""
    from repro_torch.core.store import build_store
    ds, one, _, queries = engines
    monkeypatch.setenv("REPRO_MESH_OVERRIDE", "4,1")
    auto = NKSEngine(ds, m=2, n_scales=5, seed=0, device="cpu", mesh="auto",
                     _indices=(one.index_e, one.index_a))
    assert auto.plane.n_shards == 4 and auto.device == torch.device("cpu")
    monkeypatch.delenv("REPRO_MESH_OVERRIDE")
    want = _cands(one.query_batch(queries, k=2, tier="exact",
                                  backend=TorchBackend(device="cpu",
                                                       route="device")))
    assert _cands(auto.query_batch(
        queries, k=2, tier="exact",
        backend=TorchBackend(plane=auto.plane, route="device"))) == want
    build_store(str(tmp_path / "store"), ds, m=2, n_scales=5, seed=0,
                device="cpu")
    st = NKSEngine.from_store(str(tmp_path / "store"), mesh=PLANE)
    assert st.plane is PLANE
    assert _cands(st.query_batch(queries, k=2, tier="exact")) \
        == _cands(one.query_batch(queries, k=2, tier="exact"))
    eng = NKSEngine(ds, m=2, n_scales=5, seed=0, device="cpu",
                    _indices=(one.index_e, one.index_a))
    eng.attach_wal(str(tmp_path / "wal"))
    eng.insert(ds.points[:5] + 0.25, [ds.kw.row(i) for i in range(5)],
               attrs={k: v[:5] for k, v in ds.attrs.items()})
    rec = NKSEngine.recover(str(tmp_path / "wal"), mesh=PLANE)
    assert rec.plane is PLANE and rec.backend.plane is PLANE
    assert _cands(rec.query_batch(queries, k=2, tier="exact")) \
        == _cands(eng.query_batch(queries, k=2, tier="exact"))
    with pytest.raises(ValueError, match="first device"):
        NKSEngine(ds, device="cuda", mesh=PLANE)


def test_replicated_topk_merge_tie_rule():
    """Ties go to the lower shard, then the lower local index."""
    d = [torch.tensor([1.0, 2.0]), torch.tensor([1.0, 1.0]),
         torch.tensor([0.5, torch.inf])]
    c = [torch.tensor([[0], [1]]), torch.tensor([[2], [3]]),
         torch.tensor([[4], [5]])]
    dm, cm = replicated_topk_merge(d, c, 4)
    assert dm.tolist() == [0.5, 1.0, 1.0, 1.0]
    assert cm[:, 0].tolist() == [4, 0, 2, 3]


@pytest.mark.parametrize("d", [3, 16])
def test_anchor_range_rows_equal_whole_call(d):
    """The plain version over anchor ranges (one aligned to 128, one off a
    128 boundary, the tail, one whose anchors are all masked): on small
    integer coordinates, where every fp32 sum is exact, each range's rows
    equal the same rows of the whole call bit for bit; on random
    coordinates the neighbours are equal and the values within the band."""
    gen = torch.Generator().manual_seed(d)
    q, r = 4, 600
    ints = torch.randint(-3, 4, (q, r, d), generator=gen).float()
    rand = torch.randn((q, r, d), generator=gen) * 20
    mask = torch.rand((q, r), generator=gen) < 0.8
    mask[0, 300:420] = False
    ranges = [(0, 256), (150, 200), (r - 9, 9), (310, 100), (0, 0)]
    for groups in (ints, distributed.centred(rand, mask)):
        whole = ops.anchor_star(groups, mask)
        band = distributed.diameter_band(groups.numpy(), mask.numpy())
        for a0, count in ranges:
            got = ops.anchor_star(groups, mask, anchor_range=(a0, count))
            assert [t.shape[0] for t in got] == [count] * 3
            assert torch.equal(got[0][:, 0].long(),
                               torch.arange(a0, a0 + count))
            part = [w[a0:a0 + count] for w in whole]
            if groups is ints:
                for g, w in zip(got, part):
                    assert torch.equal(g, w)
            else:
                assert torch.equal(got[0], part[0])
                assert bool(((got[2] - part[2]).abs() <= band).all())
        if groups is ints:
            assert not mask[0, 310:410].any()
    with pytest.raises(ValueError, match="anchor range"):
        ref.anchor_star(ints, mask, anchor_range=(r - 4, 5))


def test_distributed_nks_topk_matches_one_device():
    gen = torch.Generator().manual_seed(7)
    q, r, d = 3, 256, 6
    groups = torch.randn((q, r, d), generator=gen) * 10 + 30
    mask = torch.rand((q, r), generator=gen) < 0.7
    ids = torch.arange(q * r, dtype=torch.int32).view(q, r)
    d1, c1 = distributed.nks_anchor_topk(groups, mask, ids, 5)
    d8, c8 = distributed.distributed_nks_topk(["cpu"] * 8, groups, mask,
                                              ids, 5)
    assert distributed.distributed_nks_topk(
        ["cpu"] * 8, groups, mask, ids, 5)[1].shape == c8.shape
    assert torch.equal(c8, c1)
    band = distributed.diameter_band(groups.numpy(), mask.numpy())
    assert bool(((d8 - d1).abs() <= 1e-5 * d1.abs() + band).all())
    # every shard scores the whole groups: a range's search is the rows of
    # the whole one
    dr, cr = distributed.nks_anchor_topk(groups, mask, ids, r,
                                         anchor_range=(32, 32))
    assert dr.shape == (32,)
    assert bool(((cr[:, 0] >= 32) & (cr[:, 0] < 64)).all())


# --------------------------------------------- against the reference's plane
def _ref_pair(n_shards: int):
    from repro.launch.mesh import make_local_mesh as ref_local_mesh
    from repro.launch.mesh import make_serving_mesh as ref_serving_mesh
    mesh = ref_local_mesh(data=1, model=1) if n_shards == 1 \
        else ref_serving_mesh(data=n_shards)
    return RefPlane(mesh), DevicePlane(make_local_mesh(n_shards,
                                                       device="cpu"))


def _ref_engines(n_shards: int):
    rds = ref_attach_attrs(ref_synth(n=500, d=8, u=20, t=2, seed=3), seed=9)
    tds = attach_attrs(synthetic_dataset(n=500, d=8, u=20, t=2, seed=3),
                       seed=9)
    rplane, tplane = _ref_pair(n_shards)
    reng = RefEngine(rds, m=2, n_scales=5, seed=0, mesh=rplane)
    teng = NKSEngine(tds, m=2, n_scales=5, seed=0, mesh=tplane)
    queries = ref_queries(rds, 2, 12, seed=5) + ref_queries(rds, 3, 12,
                                                            seed=6)
    return rds, reng, teng, rplane, tplane, queries


SHARD_COUNTERS = ("sharded_dispatches", "shard_dispatches",
                  "shard_valid_cells", "shard_total_cells")


def check_against_reference(n_shards: int) -> None:
    """The reference's ``n_shards`` plane against the port's, on the same
    seeded inputs: the sharded joins and counts identical; engine answers
    identical per route (reference pallas, port torch, both pinned to the
    device, with and without the prune tier, under a filter) with equal
    per-shard counters; the device tier's ids equal and diameters within
    rtol 1e-5 plus the band."""
    import jax.numpy as jnp
    from repro.core.distributed import distributed_nks_topk as ref_dnks
    rds, reng, teng, rplane, tplane, queries = _ref_engines(n_shards)
    x, lengths, r, words = _tile(0)
    m_r, c_r = rplane.join_batched_masked(x, lengths, r)
    m_t, c_t = tplane.join_batched_masked(*_t(x, lengths, r))
    np.testing.assert_array_equal(np.asarray(m_r).view(np.int32), m_t)
    np.testing.assert_array_equal(np.asarray(c_r), c_t)
    m_r, c_r = rplane.join_batched_masked(x, lengths, r,
                                          words.view(np.uint32))
    m_t, c_t = tplane.join_batched_masked(*_t(x, lengths, r, words))
    np.testing.assert_array_equal(np.asarray(m_r).view(np.int32), m_t)
    np.testing.assert_array_equal(np.asarray(c_r), c_t)
    for dtype in ("bf16", "int8"):
        for w in (None, words):
            want = rplane.join_batched_counts(
                x, lengths, r * 1.5, None if w is None else w.view(np.uint32),
                dtype=dtype)
            got = tplane.join_batched_counts(*_t(x, lengths, r * 1.5, w),
                                             dtype=dtype)
            np.testing.assert_array_equal(np.asarray(want), got)
    # Routes with the prune tier off: on a plane the reference's survivor
    # sub-dispatch (``jnp.take`` of a sharded tile) raises
    # ``ShardingTypeError`` under this jax, so its prune tier cannot run
    # there; the port's prune tier on the plane is held to its single
    # device above.
    for kw, flt in ((dict(route="device", prune_tier="off"), None),
                    (dict(route="device", prune_tier="off",
                          bin_strategy="pow2"), None),
                    (dict(route="device", prune_tier="off"),
                     ("price", "<", 55.0))):
        rb = PallasBackend(plane=rplane, **kw)
        tb = TorchBackend(plane=tplane, **kw)
        for tier in ("exact", "approx"):
            want = reng.query_batch(queries, k=2, tier=tier, backend=rb,
                                    filter=None if flt is None
                                    else where(flt).as_json())
            got = teng.query_batch(queries, k=2, tier=tier, backend=tb,
                                   filter=None if flt is None
                                   else where(flt))
            assert _cands(got) == _cands(want), (kw, flt, tier)
            rs, ts = reng.last_batch_stats, teng.last_batch_stats
            for f in SHARD_COUNTERS:
                assert getattr(ts, f) == getattr(rs, f), (f, kw, tier)
            assert ts.shard_utilisation == rs.shard_utilisation
            assert ts.total_dispatches == rs.total_dispatches
        for f in SHARD_COUNTERS:
            assert getattr(tb.stats, f) == getattr(rb.stats, f), (f, kw)
    for query in queries[12:16]:
        pg = tplane.pack_groups(teng.dataset, query)
        rpg = rplane.pack_groups(rds, query)
        np.testing.assert_array_equal(pg.groups, rpg.groups)
        d_r, c_r = ref_dnks(rplane.mesh, jnp.asarray(rpg.groups),
                            jnp.asarray(rpg.mask), jnp.asarray(rpg.ids), 3)
        d_t, c_t = distributed.distributed_nks_topk(
            tplane, *(torch.from_numpy(a) for a in pg), 3)
        d_r, c_r = np.asarray(d_r), np.asarray(c_r)
        live = np.isfinite(d_r)
        np.testing.assert_array_equal(np.isfinite(d_t.numpy()), live)
        np.testing.assert_array_equal(c_t.numpy()[live], c_r[live])
        band = distributed.diameter_band(pg.groups, pg.mask)
        assert (np.abs(d_t.numpy()[live] - d_r[live])
                <= 1e-5 * np.abs(d_r[live]) + band).all()
    want = reng.query_batch(queries[12:], k=2, tier="device")
    got = teng.query_batch(queries[12:], k=2, tier="device")
    for a, b in zip(want, got):
        assert [c.ids for c in a.candidates] == [c.ids for c in b.candidates]
    rs, ts = reng.last_batch_stats, teng.last_batch_stats
    assert (ts.backend, ts.shard_dispatches, ts.sharded_dispatches) \
        == (rs.backend, rs.shard_dispatches, rs.sharded_dispatches)


def test_reference_one_shard_plane_matches_port():
    """The reference's ``DevicePlane(make_local_mesh(1, 1))`` against the
    port's one-shard plane (the default single CPU device of ``jax``)."""
    check_against_reference(1)
    rplane, tplane = _ref_pair(1)
    assert rplane.shard_pad(5) == tplane.shard_pad(5) == 5


@pytest.mark.timeout(600)
def test_reference_eight_shard_plane_matches_port():
    """This file's ``__main__`` in a subprocess with 8 forced host devices:
    the reference's 8-shard plane against the port's."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.run([sys.executable, __file__], env=env,
                          capture_output=True, text=True, timeout=580)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\n" \
        f"stderr:\n{proc.stderr[-4000:]}"
    assert "ALL PLANE OK" in proc.stdout


if __name__ == "__main__":
    import jax
    assert jax.local_device_count() == 8, jax.local_device_count()
    check_against_reference(8)
    print("ALL PLANE OK")
