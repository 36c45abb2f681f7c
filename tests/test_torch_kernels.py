"""The port's threshold-join ops against the reference package's, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; these tests hold those against the reference lowerings (``impl="xla"``
and, on one small case each, the Pallas program in interpret mode) on the
same seeded numpy inputs. Tolerance: masks must be identical except on cells
whose float64 squared distance lies within the fp32 error band of the
threshold, ``|d^2 - r^2| <= (64 + 4d) * eps32 * max|x|^2`` (the bound behind
the backend's slack); counts may differ by no more than the number of such
cells. The kernels themselves run only on the card: ``test_torch_cuda.py``
holds them against these plain versions there, and ``chip_smoke.py`` does
so at the serving path's shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.subset_search import pack_join_mask as ref_pack_join_mask
from repro.kernels import ops as jops
from repro_torch.kernels import ops, pairwise_l2, ref

torch.set_num_threads(1)

_EPS32 = float(np.finfo(np.float32).eps)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _band(x, lens, radii, elig_dense=None):
    """Per subset: (exact float64 join, boundary-band cells) on the live
    square, for finite radii (an infinite radius has no band)."""
    s, p, d = x.shape
    out = []
    for si in range(s):
        n = int(lens[si])
        pts = x[si].astype(np.float64)
        d2 = ((pts[:, None] - pts[None, :]) ** 2).sum(-1)
        live = np.arange(p) < n
        if elig_dense is not None:
            live &= elig_dense[si]
        sq_live = live[:, None] & live[None, :]
        r2 = float(np.float32(radii[si])) ** 2
        norm2 = (pts[:n] ** 2).sum(-1).max() if n else 0.0
        tol = (64.0 + 4.0 * d) * _EPS32 * norm2
        band = sq_live & (np.abs(d2 - r2) <= tol) if np.isfinite(r2) \
            else np.zeros_like(sq_live)
        out.append((sq_live & (d2 <= r2), band))
    return out


def _unpack(words, p):
    w = np.ascontiguousarray(words).view(np.uint32)
    cols = np.arange(p)
    return ((w[..., cols // 32] >> (cols % 32).astype(np.uint32)) & 1) \
        .astype(bool)


def _assert_mask_close(m_got, c_got, m_want, c_want, bands, p):
    got, want = _unpack(m_got, p), _unpack(m_want, p)
    for si, (_, band) in enumerate(bands):
        off = got[si] != want[si]
        assert not (off & ~band).any(), f"subset {si}: mask differs off-band"
        assert abs(int(c_got[si]) - int(c_want[si])) <= int(band.sum()), \
            f"subset {si}: counts {c_got[si]} vs {c_want[si]}"
        assert int(c_got[si]) == int(got[si].sum()), f"subset {si}"


def _case(s, p, d, seed, scale=100.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, scale, (s, p, d)).astype(np.float32)
    lens = rng.integers(0, p + 1, size=s).astype(np.int32)
    lens[0] = p
    lens[-1] = 0                                     # empty subset
    if s > 2:
        lens[1] = 1                                  # single point
    radii = rng.uniform(0, 1.5 * scale, size=s).astype(np.float32)
    radii[min(2, s - 1)] = np.inf
    el = rng.random((s, p)) < 0.5
    return x, lens, radii, el


CASES = [(3, 10, 8), (5, 37, 9), (4, 64, 16), (3, 130, 5), (2, 200, 33),
         (9, 7, 33)]


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("s,p,d", CASES)
def test_join_batched_masked_matches_xla(s, p, d, fold):
    x, lens, radii, el = _case(s, p, d, seed=s * 100 + p + d)
    elig = ref_pack_join_mask(el.reshape(-1, p)).reshape(s, -1) if fold \
        else None
    m_j, c_j = jops.pairwise_l2_join_batched_masked(
        jnp.asarray(x), lens, radii,
        None if elig is None else jnp.asarray(elig), impl="xla")
    m_t, c_t = ops.pairwise_l2_join_batched_masked(
        _t(x), _t(lens), _t(radii),
        None if elig is None else _t(elig.view(np.int32)))
    assert m_t.dtype == torch.int32 and tuple(m_t.shape) == (s, p, (p + 31) // 32)
    assert c_t.dtype == torch.int32 and tuple(c_t.shape) == (s,)
    bands = _band(x, lens, radii, el if fold else None)
    _assert_mask_close(m_t.numpy(), c_t.numpy(), np.asarray(m_j),
                       np.asarray(c_j), bands, p)
    # the exact float64 join is inside the band too
    got = _unpack(m_t.numpy(), p)
    for si, (exact, band) in enumerate(bands):
        assert not ((got[si] != exact) & ~band).any(), f"subset {si}"


def test_join_batched_masked_matches_pallas_interpret():
    """One small case against the Pallas program itself (interpret mode),
    with padding, a zero-length and a one-point subset, r = inf and the
    eligibility fold."""
    s, p, d = 4, 37, 6
    x, lens, radii, el = _case(s, p, d, seed=9, scale=50.0)
    elig = ref_pack_join_mask(el.reshape(-1, p)).reshape(s, -1)
    m_j, c_j = jops.pairwise_l2_join_batched_masked(
        jnp.asarray(x), lens, radii, jnp.asarray(elig), bm=16, bn=32,
        impl="pallas", interpret=True)
    m_t, c_t = ops.pairwise_l2_join_batched_masked(
        _t(x), _t(lens), _t(radii), _t(elig.view(np.int32)))
    _assert_mask_close(m_t.numpy(), c_t.numpy(), np.asarray(m_j),
                       np.asarray(c_j), _band(x, lens, radii, el), p)


def test_join_batched_masked_sq_block():
    """``with_sq``: the dense block matches the reference's (fmax outside
    the valid square) and every mask bit thresholds it."""
    s, p, d = 4, 21, 6
    x, lens, radii, _ = _case(s, p, d, seed=3, scale=50.0)
    _, _, sq_j = jops.pairwise_l2_join_batched_masked(
        jnp.asarray(x), lens, radii, impl="xla", with_sq=True)
    m_t, c_t, sq_t = ops.pairwise_l2_join_batched_masked(
        _t(x), _t(lens), _t(radii), with_sq=True)
    sq_j, sq_t = np.asarray(sq_j), sq_t.numpy()
    fmax = np.finfo(np.float32).max
    scale = (x.astype(np.float64) ** 2).sum(-1).max()
    np.testing.assert_allclose(sq_t, sq_j, rtol=0,
                               atol=(64 + 4 * d) * _EPS32 * scale)
    assert ((sq_t == fmax) == (sq_j == fmax)).all()
    got = _unpack(m_t.numpy(), p)
    for si in range(s):
        dense = sq_t[si] <= np.float32(radii[si]) ** 2
        np.testing.assert_array_equal(got[si], dense & (sq_t[si] != fmax))
        assert int(c_t[si]) == int(got[si].sum())


def test_pack_bits_matches_reference_layout():
    rng = np.random.default_rng(1)
    for n in (1, 31, 32, 33, 70):
        adj = rng.random((5, n)) < 0.5
        adj[0] = True                                # bit 31 set: sign bit
        want = ref_pack_join_mask(adj)
        got = ref.pack_bits(torch.from_numpy(adj))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        np.testing.assert_array_equal(ref.unpack_bits(got, n).numpy(), adj)


# ------------------------------------------------------------- prune tier (K2)
COUNT_CASES = [(4, 37, 8), (6, 64, 16), (3, 130, 5)]


def _coarse_radii(x, radii):
    norms = np.sqrt((x.astype(np.float64) ** 2).sum(-1)).max()
    return ((radii + 2 * 2.0 ** -8 * norms) * 1.05).astype(np.float32)


@pytest.mark.parametrize("s,p,d", COUNT_CASES)
def test_join_batched_counts_match_reference_bf16(s, p, d):
    """The reference's counts-superset cases: the port's bf16 counts equal
    the reference's bf16 counts and are never below the float64 join at the
    base radius."""
    rng = np.random.default_rng(s * 10 + p + d)
    x = rng.uniform(-20, 20, (s, p, d)).astype(np.float32)
    lens = rng.integers(1, p + 1, size=s).astype(np.int32)
    lens[-1] = 0
    radii = rng.uniform(1.0, 25.0, size=s).astype(np.float32)
    rc = _coarse_radii(x, radii)
    want = np.asarray(jops.pairwise_l2_join_batched_counts(
        jnp.asarray(x), lens, rc, dtype="bf16", impl="xla"))
    got = ops.pairwise_l2_join_batched_counts(_t(x), _t(lens), _t(rc)).numpy()
    np.testing.assert_array_equal(got, want)
    for si, (exact, _) in enumerate(_band(x, lens, radii)):
        assert got[si] >= int(exact.sum()), f"subset {si}"


def test_join_batched_counts_match_pallas_interpret():
    rng = np.random.default_rng(11)
    s, p, d = 5, 70, 12
    x = rng.uniform(-10, 10, (s, p, d)).astype(np.float32)
    lens = np.array([70, 33, 16, 1, 0], np.int32)
    radii = np.array([8.0, np.inf, 4.0, 1.0, 2.0], np.float32)
    want = np.asarray(jops.pairwise_l2_join_batched_counts(
        jnp.asarray(x), lens, radii, dtype="bf16", bm=32, bn=32,
        impl="pallas", interpret=True))
    got = ops.pairwise_l2_join_batched_counts(_t(x), _t(lens), _t(radii))
    np.testing.assert_array_equal(got.numpy(), want)


def test_join_batched_counts_edge_lengths_and_radii():
    """Lengths of 0, 1 and P, and infinite radii: counts equal the
    reference's bf16 counts, cover the whole live square at r=inf and are 0
    for an empty subset."""
    rng = np.random.default_rng(13)
    s, p, d = 5, 45, 7
    x = rng.uniform(-5, 5, (s, p, d)).astype(np.float32)
    lens = np.array([45, 1, 0, 20, 45], np.int32)
    radii = np.array([np.inf, 0.5, np.inf, 2.0, 4.0], np.float32)
    want = np.asarray(jops.pairwise_l2_join_batched_counts(
        jnp.asarray(x), lens, radii, dtype="bf16", impl="xla"))
    got = ops.pairwise_l2_join_batched_counts(
        _t(x), _t(lens), _t(radii)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == p * p and got[1] == 1 and got[2] == 0


def test_join_batched_counts_adversarial_boundary():
    """Pairs within r*(1 +/- k*2^-9) of the threshold: the coarse count at
    the widened radius never misses a pair at true distance <= r."""
    d = 8
    for seed, r in ((0, 1.0), (1, 7.3), (2, 123.0)):
        rng = np.random.default_rng(seed)
        base = rng.uniform(-1, 1, d)
        base /= np.linalg.norm(base)
        pts = [rng.uniform(-r, r, d).astype(np.float32)]
        for k in (-4, -1, 0, 1, 4):
            delta = r * (1.0 + k * 2.0 ** -9)
            pts.append((pts[0] + base * delta).astype(np.float32))
        x = np.stack(pts)[None].astype(np.float32)
        lens = np.array([x.shape[1]], np.int32)
        pf = x[0].astype(np.float64)
        d2 = ((pf[:, None] - pf[None, :]) ** 2).sum(-1)
        exact = int((np.sqrt(d2) <= r).sum())
        norms = np.sqrt((pf ** 2).sum(-1)).max()
        rc = np.array([(r + 2 * 2.0 ** -8 * norms) * 1.05], np.float32)
        got = int(ops.pairwise_l2_join_batched_counts(
            _t(x), _t(lens), _t(rc))[0])
        assert got >= exact, f"seed={seed} r={r}: {got} < {exact}"


@pytest.mark.parametrize("s,p,d", COUNT_CASES)
def test_join_batched_counts_eligibility_matches_reference(s, p, d):
    """K2 with eligibility words: the port's bf16 counts equal the
    reference's (its dense eligibility row built from the same words) and
    are never below the float64 eligible-pair join at the base radius — the
    coarse tier stays a superset of K1's eligible counts."""
    rng = np.random.default_rng(s * 7 + p + d)
    x = rng.uniform(-20, 20, (s, p, d)).astype(np.float32)
    lens = rng.integers(1, p + 1, size=s).astype(np.int32)
    lens[-1] = 0
    radii = rng.uniform(1.0, 25.0, size=s).astype(np.float32)
    el = rng.random((s, p)) < 0.4
    elig = ref_pack_join_mask(el.reshape(-1, p)).reshape(s, -1)
    rc = _coarse_radii(x, radii)
    want = np.asarray(jops.pairwise_l2_join_batched_counts(
        jnp.asarray(x), lens, rc, jnp.asarray(elig), dtype="bf16",
        impl="xla"))
    got = ops.pairwise_l2_join_batched_counts(
        _t(x), _t(lens), _t(rc), _t(elig.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)
    _, c_fp32 = ops.pairwise_l2_join_batched_masked(
        _t(x), _t(lens), _t(radii), _t(elig.view(np.int32)))
    for si, (exact, _) in enumerate(_band(x, lens, radii, el)):
        assert got[si] >= int(exact.sum()), f"subset {si}"
        assert got[si] >= int(c_fp32[si]), f"subset {si}"
    unfiltered = ops.pairwise_l2_join_batched_counts(
        _t(x), _t(lens), _t(rc)).numpy()
    assert (got <= unfiltered).all()


# ------------------------------------------------ dense self-join tiles (K4)
@pytest.mark.parametrize("s,p,d,bm", [(3, 10, 8, 16), (5, 37, 9, 16),
                                      (2, 200, 12, 128), (9, 7, 33, 128)])
def test_join_batched_dense_matches_pallas_interpret(s, p, d, bm):
    """K4's plain version against the reference's Pallas program (interpret
    mode) on the reference's own cases: sq to rtol 1e-4 / atol 0.5 (fp32
    sums in another order), the caller's tile grid, and per-subset join
    sizes equal."""
    rng = np.random.default_rng(s * 100 + p)
    x = rng.uniform(0, 100, (s, p, d)).astype(np.float32)
    lens = rng.integers(1, p + 1, size=s).astype(np.int32)
    radii = rng.uniform(0, 150, size=s).astype(np.float32)
    radii[0] = np.inf
    sq_j, cnt_j = jops.pairwise_l2_join_batched(
        jnp.asarray(x), jnp.asarray(lens), jnp.asarray(radii), bm=bm, bn=bm,
        interpret=True)
    sq_t, cnt_t = ops.pairwise_l2_join_batched(_t(x), _t(lens), _t(radii),
                                               bm=bm, bn=bm)
    assert sq_t.dtype == torch.float32 and tuple(sq_t.shape) == (s, p, p)
    assert cnt_t.dtype == torch.int32
    assert tuple(cnt_t.shape) == np.asarray(cnt_j).shape
    np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j), rtol=1e-4,
                               atol=0.5)
    np.testing.assert_array_equal(cnt_t.numpy().sum(axis=(1, 2)),
                                  np.asarray(cnt_j).sum(axis=(1, 2)))
    assert int(cnt_t[0].sum()) == int(lens[0]) ** 2      # r = inf


def test_join_batched_dense_masks_padding():
    """The reference's padding case: rows/cols past each subset's length
    are fmax and never counted; a scalar radius serves every subset."""
    x = np.ones((2, 8, 4), np.float32)
    lens = np.array([3, 0], np.int32)
    sq, cnt = ops.pairwise_l2_join_batched(_t(x), _t(lens), 1.0, bm=8, bn=8)
    sq_j, cnt_j = jops.pairwise_l2_join_batched(
        jnp.asarray(x), jnp.asarray(lens), 1.0, bm=8, bn=8, interpret=True)
    sq = sq.numpy()
    fmax = np.finfo(np.float32).max
    assert np.all(sq[0, :3, :3] == 0.0)
    assert np.all(sq[0, 3:, :] == fmax) and np.all(sq[0, :, 3:] == fmax)
    assert np.all(sq[1] == fmax)
    np.testing.assert_array_equal(sq, np.asarray(sq_j))
    assert cnt.sum(dim=(1, 2)).tolist() == [9, 0]
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))


@pytest.mark.parametrize("bm,bn", [(8, 8), (16, 48), (5, 3), (128, 128)])
def test_join_batched_dense_tile_counts(bm, bn):
    """Per-tile counts are the joined cells of each bm x bn tile of the
    plain version's own sq block, for tiles that do and do not divide a
    32-column mask word."""
    rng = np.random.default_rng(bm * 31 + bn)
    s, p, d = 3, 70, 6
    x = rng.uniform(0, 20, (s, p, d)).astype(np.float32)
    lens = np.array([70, 41, 1], np.int32)
    radii = np.array([15.0, np.inf, 3.0], np.float32)
    sq, cnt = ops.pairwise_l2_join_batched(_t(x), _t(lens), _t(radii),
                                           bm=bm, bn=bn)
    sq = sq.numpy()
    fmax = np.finfo(np.float32).max
    gm, gn = -(-p // bm), -(-p // bn)
    assert tuple(cnt.shape) == (s, gm, gn)
    for si in range(s):
        joined = (sq[si] <= np.float32(radii[si]) ** 2) & (sq[si] != fmax)
        pad = np.zeros((gm * bm, gn * bn), bool)
        pad[:p, :p] = joined
        want = pad.reshape(gm, bm, gn, bn).sum(axis=(1, 3))
        np.testing.assert_array_equal(cnt[si].numpy(), want)


# ---------------------------------------------------------- single join (K3)
@pytest.mark.parametrize("bm,bn", [(128, 128), (16, 48), (1, 1)])
@pytest.mark.parametrize("m,n,d", [(8, 8, 4), (130, 70, 33), (257, 129, 64),
                                   (64, 300, 8)])
def test_pairwise_join_matches_reference(m, n, d, bm, bn):
    """sq within the fp32 band of the reference's, and per-tile counts on
    the reference's own (bm, bn) grid, equal but for the band cells of each
    tile."""
    rng = np.random.default_rng(m + n + d)
    a = rng.standard_normal((m, d)).astype(np.float32) * 10
    b = rng.standard_normal((n, d)).astype(np.float32) * 10
    r = 40.0
    sq_j, cnt_j = jops.pairwise_l2_join(jnp.asarray(a), jnp.asarray(b), r,
                                        bm=bm, bn=bn, interpret=True)
    sq_t, cnt_t = ops.pairwise_l2_join(_t(a), _t(b), r, bm=bm, bn=bn)
    scale = max((a.astype(np.float64) ** 2).sum(-1).max(),
                (b.astype(np.float64) ** 2).sum(-1).max())
    tol = (64 + 4 * d) * _EPS32 * scale
    np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j), rtol=0,
                               atol=tol)
    cnt_j = np.asarray(cnt_j).astype(np.int64)
    assert tuple(cnt_t.shape) == cnt_j.shape == (-(-m // bm), -(-n // bn))
    d2 = ((a.astype(np.float64)[:, None] - b[None].astype(np.float64)) ** 2
          ).sum(-1)
    gm, gn = cnt_j.shape
    pad = np.zeros((gm * bm, gn * bn), np.int64)
    pad[:m, :n] = np.abs(d2 - np.float32(r) ** 2) <= tol
    band = pad.reshape(gm, bm, gn, bn).sum(axis=(1, 3))
    assert (np.abs(cnt_t.numpy() - cnt_j) <= band).all()
    assert int(cnt_t.sum()) == int((sq_t.numpy() <= np.float32(r) ** 2).sum())


# ------------------------------------------------------- int8 prune arm (K2i)
INT8_CASES = [(4, 37, 8), (6, 64, 16), (3, 130, 5), (2, 65, 17),
              (5, 128, 64), (3, 70, 129), (9, 7, 33)]


def _int8_want(x, lens, radii, el=None):
    return np.asarray(jops._xla_join_batched_counts(
        jnp.asarray(x), jnp.asarray(lens), jnp.asarray(radii),
        None if el is None else jnp.asarray(el), "int8"))


@pytest.mark.parametrize("elig", [False, True])
@pytest.mark.parametrize("s,p,d", INT8_CASES)
def test_join_batched_counts_match_reference_int8(s, p, d, elig):
    """The plain twin of K2i equals the reference's int8 lowering
    (``_xla_join_batched_counts(dtype="int8")``) exactly — every integer
    step is exact and the fp32 scale and threshold round once an operation
    on both sides — with and without eligibility words (the reference's
    dense row built from the same bits), on padded rows of random values
    (the scale is taken over the whole padded block), edge lengths and an
    infinite radius. Counts never fall below the fp32 join's at the same
    radius (K1's plain version) nor the float64 join's."""
    x, lens, radii, el = _case(s, p, d, seed=s * 31 + p + d)
    x -= 50.0                                        # both signs
    el = el if elig else None
    words = None if el is None else ref.pack_bits(_t(el))
    want = _int8_want(x, lens, radii, el)
    got = ops.pairwise_l2_join_batched_counts(
        _t(x), _t(lens), _t(radii), words, dtype="int8").numpy()
    np.testing.assert_array_equal(got, want)
    _, c_fp32 = ops.pairwise_l2_join_batched_masked(
        _t(x), _t(lens), _t(radii), words)
    assert (got >= c_fp32.numpy()).all()
    for si, (exact, _) in enumerate(_band(x, lens, radii, el)):
        assert got[si] >= int(exact.sum()), f"subset {si}"


def test_join_batched_counts_int8_edge_subsets():
    """All-zero subsets (the 1e-30 floor of the scale), single points,
    empty subsets, zero and infinite radii, integer coordinates that
    quantise onto exact ties (x * scale on a half level): the twin equals
    the reference bit for bit."""
    s, p, d = 6, 40, 9
    rng = np.random.default_rng(5)
    x = np.round(rng.uniform(-4, 4, (s, p, d))).astype(np.float32)
    x[0] = 0.0
    x[3, :, 0] = 127.0                      # scale 1: integers stay put
    x[3, ::2, 1] = 0.5                      # half levels: round to even
    x[3, 1::2, 1] = 1.5
    lens = np.array([40, 1, 0, 40, 17, 40], np.int32)
    radii = np.array([1.0, 0.0, 3.0, 0.0, np.inf, 2.5], np.float32)
    want = _int8_want(x, lens, radii)
    got = ops.pairwise_l2_join_batched_counts(
        _t(x), _t(lens), _t(radii), dtype="int8").numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 40 * 40 and got[1] == 1 and got[2] == 0
    assert got[4] == 17 * 17


@pytest.mark.parametrize("seed,r", [(0, 1.0), (1, 7.3), (2, 123.0)])
def test_join_batched_counts_int8_adversarial_boundary(seed, r):
    """Pairs within r*(1 +/- k*2^-9) of the threshold, also scaled up to
    the order of 1e4 (coordinates the int8 levels resolve coarsely): the
    int8 count at the unwidened radius equals the reference's and never
    misses a pair at true distance <= r."""
    d = 8
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, d)
    base /= np.linalg.norm(base)
    pts = [rng.uniform(-r, r, d).astype(np.float32)]
    for k in (-4, -1, 0, 1, 4):
        pts.append((pts[0] + base * r * (1.0 + k * 2.0 ** -9))
                   .astype(np.float32))
    x = np.stack(pts)[None].astype(np.float32)
    x = np.concatenate([x, x * np.float32(100.0)])
    lens = np.array([x.shape[1]] * 2, np.int32)
    radii = np.array([r, r * 100.0], np.float32)
    got = ops.pairwise_l2_join_batched_counts(
        _t(x), _t(lens), _t(radii), dtype="int8").numpy()
    np.testing.assert_array_equal(got, _int8_want(x, lens, radii))
    for si in range(2):
        pf = x[si].astype(np.float64)
        d2 = ((pf[:, None] - pf[None, :]) ** 2).sum(-1)
        exact = int((d2 <= float(radii[si]) ** 2).sum())
        assert got[si] >= exact, f"subset {si}: {got[si]} < {exact}"


def test_int8_scale_threshold_rounds_once_per_operation():
    """The threshold is fp32 with one rounding an operation: r * scale and
    + sqrt(d) rounded apart (no fused multiply-add), as the reference's
    lowering on the CPU computes it."""
    maxabs = torch.tensor([3.0, 1e-31, 0.7], dtype=torch.float32)
    r = torch.tensor([2.0, 0.0, 0.123], dtype=torch.float32)
    scale = ref.int8_scale(maxabs)
    thr = ref.int8_threshold(scale, r, 17)
    f = np.float32
    for i in range(3):
        sc = f(127.0) / max(f(maxabs[i]), f(1e-30))
        rq = f(f(r[i]) * sc) + f(np.sqrt(f(17)))
        assert float(scale[i]) == float(sc)
        assert int(thr[i]) == int(f(np.ceil(f(rq * rq))) + f(1.0))
    big = ref.int8_threshold(scale, torch.full((3,), np.inf), 4)
    assert (big == 2 ** 31 - 1).all()


@pytest.mark.parametrize("d", [1, 31, 32, 33, 64, 96, 127, 128, 130, 2304])
def test_int8_layout_pitch_and_strides(d):
    """K2i's scratch: the int8 rows' pitch is d rounded up to whole 32-byte
    ``wgmma`` k-steps (never to 128), so the tensor map's row stride is a
    multiple of 16 bytes; the norms' row stride is P rounded up to 4 ints
    (16 bytes); the norms start on a 16-byte boundary after the int8 block."""
    for s, p in ((1, 1), (3, 97), (8, 2880), (300, 130)):
        pitch, pn, q_bytes = pairwise_l2.int8_layout(s, p, d)
        assert pitch % pairwise_l2.INT8_K_STEP == 0 and pitch % 16 == 0
        assert d <= pitch < d + pairwise_l2.INT8_K_STEP
        assert pn % 4 == 0 and p <= pn < p + 4
        assert q_bytes == s * p * pitch and q_bytes % 16 == 0


def test_counts_refuse_unknown_dtype():
    x = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError, match="prune dtype"):
        ops.pairwise_l2_join_batched_counts(
            x, torch.ones(1, dtype=torch.int32), torch.ones(1), dtype="fp8")


# ------------------------------------------------------------ routing rules
def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: nothing falls back."""
    x = torch.zeros((2, 8, 4))
    lens = torch.full((2,), 8, dtype=torch.int32)
    r = torch.ones(2)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_l2.join_batched_masked(x, lens, r)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_l2.join_batched_prune(x, lens, r)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_l2.join_batched_prune_int8(x, lens, r)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_l2.pairwise_join(x[0], x[1])
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_l2.join_batched_tiles(x, lens, r)
    assert all(v == 0 for v in pairwise_l2.launches.values())



def test_triangle_tile_refusals():
    """K1 and K2 number the tiles of the upper triangle of each subset in
    int32: a P that makes more is refused before any launch."""
    pairwise_l2.check_triangle_tiles(2880)
    pairwise_l2.check_triangle_tiles(4_000_000)
    with pytest.raises(ValueError, match="more triangle tiles"):
        pairwise_l2.check_triangle_tiles(5_000_000)
    assert all(v == 0 for v in pairwise_l2.launches.values())
