"""The port's index build on the device against the reference, on the CPU.

K5's plain version (``kernels.ref.project_and_bin``, what ``ops`` runs for a
CPU tensor) against the reference's Pallas kernel in interpret mode and its
plain version: projections to rtol 1e-5 / atol 1e-4 (fp32 sums in another
order), bins at most 1 apart and apart only where the scaled value lies
within the build's settlement margin of an integer. The int64 signature hash
and the torch CSR assembly against their numpy counterparts, exactly. Then
the whole build route the engine runs (``core.index_build.build_indices``,
``device="cpu"``) against the reference's ``build_index``, array for array
and bit for bit — including on a corpus crafted so that many projections
sit on bin edges, where the host settlement is what keeps the index the
reference's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.index import build_index as ref_build_index
from repro.core.types import make_dataset as ref_make_dataset
from repro.data.flickr_like import flickr_like_dataset as ref_flickr
from repro.data.synthetic import random_queries as ref_queries
from repro.data.synthetic import synthetic_dataset as ref_synth
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.serve.engine import NKSEngine as RefEngine
from repro_torch import NKSEngine
from repro_torch.core import index_build as ib
from repro_torch.core import projection as proj
from repro_torch.core import signatures as sig
from repro_torch.core.index import PromishIndex, build_index
from repro_torch.core.types import make_dataset
from repro_torch.kernels import ops
from repro_torch.utils.csr import csr_from_pairs, csr_from_pairs_torch

torch.set_num_threads(1)


def assert_index_equal(got, want):
    """Every array of two indices equal, dtypes included."""
    assert (got.w0, got.p_max, got.n_scales, got.exact) == \
        (want.w0, want.p_max, want.n_scales, want.exact)
    np.testing.assert_array_equal(got.z, want.z)
    assert len(got.structures) == len(want.structures)
    for a, b in zip(got.structures, want.structures):
        assert (a.scale, a.width, a.n_buckets) == (b.scale, b.width,
                                                   b.n_buckets)
        for x, y in ((a.table, b.table), (a.khb, b.khb)):
            for u, v in ((x.offsets, y.offsets), (x.values, y.values)):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


# ------------------------------------------------------------------- K5
@pytest.mark.parametrize("n,d,m", [(16, 8, 2), (300, 33, 2), (128, 64, 4),
                                   (70, 16, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_and_bin_plain_matches_reference(n, d, m, dtype):
    rng = np.random.default_rng(n + d)
    x = (rng.random((n, d), dtype=np.float32) * 1000).astype(np.float32)
    z = rng.standard_normal((m, d)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    w, c = 37.5, 1 << 20
    tdt = getattr(torch, dtype)
    xt, zt = torch.from_numpy(x).to(tdt), torch.from_numpy(z).to(tdt)
    # both packages see the same rounded inputs
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    zj = jnp.asarray(zt.float().numpy()).astype(getattr(jnp, dtype))
    h1, h2, p = (a.numpy() for a in ops.project_and_bin(xt, zt, w, c))
    assert h1.dtype == h2.dtype == np.int32 and p.dtype == np.float32
    assert h1.shape == h2.shape == p.shape == (n, m)
    margin = ib.margin_scale(xt.float())[:, None].numpy() / np.float32(w)
    inv_w, half_w, _ = (np.float32(v) for v in ib.bin_constants(w, c))
    for want in (ref_ops.project_and_bin(xj, zj, w, c, bn=64,
                                         interpret=True),
                 ref_ref.project_and_bin_ref(xj, zj, w, c)):
        wh1, wh2, wp = (np.asarray(a) for a in want)
        np.testing.assert_allclose(p, wp, rtol=1e-5, atol=1e-4)
        for got, exp, v in ((h1, wh1, p * inv_w),
                            (h2, wh2, (p - half_w) * inv_w)):
            off = got != exp
            assert np.abs(got.astype(np.int64) - exp).max() <= 1
            near = np.abs(v - np.round(v)) <= margin + 8 * 2.0 ** -24 \
                * (np.abs(v) + 1)
            assert not (off & ~near).any()


def test_project_and_bin_rounding_points():
    """h1 multiplies by fp32(1/w) (the TPU kernel's form, not numpy's
    divide), h2 subtracts fp32(w/2) and adds C in fp32 after the floor."""
    w, c = 0.1, 1 << 20
    z = torch.ones((1, 1))
    x = torch.tensor([[0.3], [-0.7], [2.5]], dtype=torch.float32)
    h1, h2, p = ops.project_and_bin(x, z, w, c)
    inv_w = np.float32(1.0 / w)
    want1 = np.floor(x.numpy() * inv_w).astype(np.int32)
    want2 = (np.floor((x.numpy() - np.float32(w / 2)) * inv_w)
             + np.float32(c)).astype(np.int32)
    np.testing.assert_array_equal(h1.numpy(), want1)
    np.testing.assert_array_equal(h2.numpy(), want2)
    np.testing.assert_array_equal(p.numpy(), x.numpy())


# ------------------------------------------------------- hashing and CSRs
@pytest.mark.parametrize("m", [1, 2, 3, 8])
def test_int64_hash_matches_uint64(m):
    rng = np.random.default_rng(m)
    keys = rng.integers(-(1 << 62), 1 << 62, (2000, m), dtype=np.int64)
    keys[:50] = rng.integers(-40, 40, (50, m))
    keys[50] = np.iinfo(np.int64).min
    keys[51] = np.iinfo(np.int64).max
    for nb in (1, 64, 100, 12_289, 1 << 20, (1 << 31) - 1, 1 << 40):
        np.testing.assert_array_equal(
            sig.hash_signatures_torch(torch.from_numpy(keys), nb).numpy(),
            sig.hash_signatures(keys, nb))
    h1 = keys[:, :m] // 4
    h2 = keys[::-1, :m] // 4 + proj.DEFAULT_C
    keys2 = np.stack([h1, h2], axis=-1)
    np.testing.assert_array_equal(
        sig.bucket_ids_overlapping_torch(torch.from_numpy(h1),
                                         torch.from_numpy(h2), 4096).numpy(),
        sig.bucket_ids_overlapping(keys2, 4096))
    with pytest.raises(ValueError, match="2\\^31"):
        sig.hash_signatures_torch(torch.from_numpy(keys), (1 << 31) + 1)


@pytest.mark.parametrize("nb", [3, 1000, 12_289, 65_521, 999_983,
                                (1 << 31) - 1])
def test_int64_hash_any_modulus_matches_uint64(nb):
    """Moduli that are not powers of two, on 10^5 random signatures."""
    rng = np.random.default_rng(nb)
    keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                        (100_000, 2), dtype=np.int64)
    np.testing.assert_array_equal(
        sig.hash_signatures_torch(torch.from_numpy(keys), nb).numpy(),
        sig.hash_signatures(keys, nb))


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("n_pairs,n_rows", [(0, 5), (1, 1), (3000, 40),
                                            (500, 4000)])
def test_torch_csr_from_pairs_matches_numpy(dedup, n_pairs, n_rows):
    rng = np.random.default_rng(n_pairs + n_rows)
    rows = rng.integers(0, n_rows, n_pairs).astype(np.int64)
    vals = rng.integers(0, 50, n_pairs).astype(np.int32)
    want = csr_from_pairs(rows, vals, n_rows, dedup=dedup)
    off, got = csr_from_pairs_torch(torch.from_numpy(rows),
                                    torch.from_numpy(vals), n_rows,
                                    dedup=dedup)
    assert off.dtype == torch.int64 and got.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(), want.offsets)
    np.testing.assert_array_equal(got.numpy(), want.values)
    if n_rows > n_pairs:
        assert (np.diff(want.offsets) == 0).any()      # empty rows covered


# ----------------------------------------------------------- the build
CORPORA = {
    "synth": (ref_synth, dict(n=900, d=64, u=24, t=2, seed=1)),
    "flickr": (ref_flickr, dict(n=1500, d=64, u=80, t=5, seed=2)),
    "flickr-d2304": (ref_flickr, dict(n=120, d=2304, u=30, t=3, seed=4)),
}


def _port_dataset(rds):
    return make_dataset(rds.points, [rds.kw.row(i).tolist()
                                     for i in range(rds.n)],
                        n_keywords=rds.n_keywords)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("m", [2, 3, 4])
def test_card_build_route_matches_reference(corpus, m):
    gen, kw = CORPORA[corpus]
    rds = gen(**kw)
    tds = _port_dataset(rds)
    st = ib.BuildStats()
    got_e, got_a = ib.build_indices(tds, torch.from_numpy(tds.points), m=m,
                                    stats=st)
    assert st.k5_launches == 5 and len(st.settled) == 5
    for got, exact in ((got_e, True), (got_a, False)):
        want = ref_build_index(rds, m=m, n_scales=5, exact=exact, seed=0)
        assert_index_equal(got, want)
        assert_index_equal(build_index(tds, m=m, exact=exact), want)


@pytest.mark.parametrize("n_buckets", [1 << 12, 1000, 12_289])
def test_card_build_route_pinned_geometry(n_buckets):
    """w0 and n_buckets pinned (the streaming engine's compaction build),
    with table sizes that are and are not powers of two."""
    rds = ref_flickr(n=800, d=64, u=40, t=4, seed=6)
    tds = _port_dataset(rds)
    pinned = dict(m=2, n_scales=4, seed=3, w0=3.75, n_buckets=n_buckets)
    got = ib.build_indices(tds, torch.from_numpy(tds.points), **pinned)
    for index, exact in zip(got, (True, False)):
        assert_index_equal(index, ref_build_index(rds, exact=exact, **pinned))


def test_engine_with_table_size_not_a_power_of_two_matches_reference():
    """``NKSEngine(ds, n_buckets=1000)`` builds and serves as the
    reference's engine does with the same table size."""
    rds = ref_synth(n=600, d=8, u=20, t=2, seed=4)
    tds = _port_dataset(rds)
    ref_engine = RefEngine(rds, n_buckets=1000)
    engine = NKSEngine(tds, n_buckets=1000, device="cpu")
    for got, want in ((engine.index_e, ref_engine.index_e),
                      (engine.index_a, ref_engine.index_a)):
        assert_index_equal(got, want)
    queries = ref_queries(rds, 2, 6, seed=1)
    for tier in ("exact", "approx"):
        got = engine.query_batch(queries, k=2, tier=tier, backend="numpy")
        want = ref_engine.query_batch(queries, k=2, tier=tier,
                                      backend="numpy")
        assert [[(c.ids, c.diameter) for c in r.candidates] for r in got] \
            == [[(c.ids, c.diameter) for c in r.candidates] for r in want]


def test_engine_builds_through_the_card_route():
    rds = ref_synth(n=600, d=16, u=20, t=2, seed=9)
    engine = NKSEngine(_port_dataset(rds), device="cpu")
    assert engine.build_stats.k5_launches == 5
    for index, exact in ((engine.index_e, True), (engine.index_a, False)):
        assert_index_equal(index, ref_build_index(rds, exact=exact))


def _edge_corpus(n=2000, d=64, picks=400, seed=3):
    """A flickr-like corpus with ``picks`` interior points moved along z_0 so
    that their first projection lands on a bin edge of scale 0 (the span,
    and so w0, is unchanged: only points away from both projections'
    extremes move)."""
    rds = ref_flickr(n=n, d=d, u=50, t=3, seed=seed)
    z = proj.sample_unit_vectors(np.random.default_rng(0), 2, d)
    p = proj.project(rds.points, z)
    w0 = proj.projection_span(p) / 32
    inner = np.ones(n, dtype=bool)
    for j in range(2):
        inner &= (p[:, j] > p[:, j].min() + 2 * w0) \
            & (p[:, j] < p[:, j].max() - 2 * w0)
    pick = np.random.default_rng(seed).choice(np.flatnonzero(inner), picks,
                                              replace=False)
    pts = rds.points.astype(np.float64)
    k = np.round(p[pick, 0] / w0)
    pts[pick] += (k * w0 - p[pick, 0])[:, None] * z[0][None, :]
    pts = pts.astype(np.float32)
    kws = [rds.kw.row(i).tolist() for i in range(n)]
    return (ref_make_dataset(pts, kws, n_keywords=rds.n_keywords),
            make_dataset(pts, kws, n_keywords=rds.n_keywords))


def test_settlement_keeps_the_reference_index_on_bin_edges():
    rds, tds = _edge_corpus()
    x = torch.from_numpy(tds.points)
    st = ib.BuildStats()
    got_e, got_a = ib.build_indices(tds, x, stats=st)
    assert st.settled[0] >= 400          # every crafted entry is settled
    assert_index_equal(got_e, ref_build_index(rds, exact=True))
    assert_index_equal(got_a, ref_build_index(rds, exact=False))

    # The same assembly fed K5's raw keys (no settlement) builds another
    # index: the multiply by fp32(1/w) floors some edge entries apart from
    # numpy's divide.
    z = torch.from_numpy(got_e.z)
    kw = (torch.from_numpy(tds.kw.offsets), torch.from_numpy(tds.kw.values))
    raw = []
    for s in range(got_e.n_scales):
        w = got_e.w0 * 2.0 ** s
        h1, h2, _ = ops.project_and_bin(x, z, w, proj.DEFAULT_C)
        raw.append(ib._assemble_scale(tds, h1.long(), h2.long(), s, w,
                                      got_e.structures[0].n_buckets, kw,
                                      ib.BuildStats()))
    raw_e = PromishIndex(z=got_e.z, w0=got_e.w0, n_scales=got_e.n_scales,
                         exact=True, structures=tuple(r[0] for r in raw),
                         p_max=got_e.p_max)
    with pytest.raises(AssertionError):
        assert_index_equal(raw_e, got_e)
