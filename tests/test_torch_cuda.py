"""The CUDA kernels against their plain PyTorch versions, on the card.

Runs only where there is a CUDA device and nvcc (``pytest -m cuda
tests/test_torch_cuda.py`` on the H100); elsewhere it skips. It imports
nothing of JAX, so it runs on a machine without it. Tolerance of the
threshold joins, as in ``test_torch_kernels.py``: masks identical except on
cells whose float64 squared distance lies within ``(64 + 4d) * eps32 *
max|x|^2`` of ``r^2``, counts within the number of such cells, ``sq`` within
that band. Tolerance of the tuple-diameter kernel K6: rtol 1e-5 plus the
band of the norms identity over each tuple, ``sqrt((64 + 4d) eps32
max|x|^2)``. Tolerance of the fused anchor-star kernel (K6's device-tier
entry): its neighbours are compared by float64 distance to the anchor, not
by index (its dot products round otherwise than cuBLAS's, so a near tie may
name another point), within the query's band ``sqrt((64 + 4d) eps32
max|x - c|^2)`` (``core.distributed.diameter_band``); on small integer
coordinates, where every sum is exact, the index must be the lowest among
equal minima. Tolerance of the attention kernel: both versions round
q*scale and the softmax numerators to bf16 and the output once; they
normalise the numerators by different maxima (running against final), so
each numerator may round differently (2^-9 relative), and the output may
land one bf16 ulp apart: ``|kernel - plain| <= 2^-7 |plain| + 2^-8
max|v|``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.subset_search import pack_join_mask
from repro_torch.kernels import pairwise_l2, ref

_EPS32 = float(np.finfo(np.float32).eps)
CASES = [(3, 10, 8), (5, 37, 9), (4, 64, 16), (3, 130, 5), (2, 200, 33),
         (9, 7, 33), (16, 512, 64)]


def _band(x, lens, radii, el, bf16=False):
    if bf16:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    out = []
    for si in range(x.shape[0]):
        n = int(lens[si])
        pts = x[si].astype(np.float64)
        d2 = ((pts[:, None] - pts[None, :]) ** 2).sum(-1)
        live = (np.arange(x.shape[1]) < n) & el[si]
        sq_live = live[:, None] & live[None, :]
        r2 = float(np.float32(radii[si])) ** 2
        norm2 = (pts[:n] ** 2).sum(-1).max() if n else 0.0
        tol = (64.0 + 4.0 * x.shape[2]) * _EPS32 * norm2
        out.append(sq_live & (np.abs(d2 - r2) <= tol) if np.isfinite(r2)
                   else np.zeros_like(sq_live))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("s,p,d", CASES)
def test_kernels_match_plain_versions_on_card(s, p, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(p + d)
    x = rng.uniform(0, 100, (s, p, d)).astype(np.float32)
    lens = rng.integers(0, p + 1, size=s).astype(np.int32)
    lens[0], lens[-1] = p, 0
    radii = rng.uniform(0, 150, size=s).astype(np.float32)
    radii[min(2, s - 1)] = np.inf
    el = rng.random((s, p)) < 0.6
    for fold in (False, True):
        live = el if fold else np.ones_like(el)
        elig = torch.from_numpy(pack_join_mask(el).view(np.int32)).to(dev) \
            if fold else None
        args = [torch.from_numpy(a).to(dev) for a in (x, lens, radii)]
        m_k, c_k = pairwise_l2.join_batched_masked(*args, elig)
        m_p, c_p = ref.join_batched_masked(*args, elig)
        got = ref.unpack_bits(m_k, p).cpu().numpy()
        want = ref.unpack_bits(m_p, p).cpu().numpy()
        for si, band in enumerate(_band(x, lens, radii, live)):
            assert not ((got[si] != want[si]) & ~band).any(), f"subset {si}"
            assert abs(int(c_k[si]) - int(c_p[si])) <= int(band.sum())
            assert int(c_k[si]) == int(got[si].sum())
    norms = np.sqrt((x.astype(np.float64) ** 2).sum(-1)).max()
    rc = ((radii + 2 * 2.0 ** -8 * norms) * 1.05).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (x, lens, rc)]
    k_k = pairwise_l2.join_batched_prune(*args).cpu().numpy()
    k_p = ref.join_batched_counts(*args).cpu().numpy()
    for si, band in enumerate(_band(x, lens, rc, np.ones_like(el),
                                    bf16=True)):
        assert abs(int(k_k[si]) - int(k_p[si])) <= int(band.sum())
    a = torch.from_numpy(x[0]).to(dev)
    b = torch.from_numpy(x[-1]).to(dev)
    sq_k, n_k = pairwise_l2.pairwise_join(a, b, 50.0)
    sq_p, n_p = ref.pairwise_join(a, b, 50.0)
    norm2 = max((x[0].astype(np.float64) ** 2).sum(-1).max(),
                (x[-1].astype(np.float64) ** 2).sum(-1).max())
    assert float((sq_k - sq_p).abs().max()) <= (64 + 4 * d) * _EPS32 * norm2
    assert tuple(n_k.shape) == tuple(n_p.shape)
    assert int(n_k.sum()) == int((sq_k <= np.float32(50.0) ** 2).sum())


# (B, S, H, Kv, hd, causal, window): tails off the 64-row tile, windows,
# grouped-query heads, both head dims.
FLASH_CASES = [(2, 64, 2, 2, 64, True, None), (1, 200, 3, 3, 64, True, None),
               (2, 130, 4, 2, 64, False, None), (1, 300, 2, 1, 64, True, 70),
               (2, 97, 4, 4, 128, True, None), (1, 260, 36, 4, 128, True, None),
               (1, 190, 8, 2, 128, True, 64), (3, 33, 2, 1, 128, False, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", FLASH_CASES)
def test_flash_attention_matches_plain_version_on_card(b, s, h, kv, hd,
                                                       causal, window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import flash_attention as flash
    gen = torch.Generator(device="cuda").manual_seed(s * hd + h)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    before = flash.launches["flash_attention"]
    got = flash.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash.launches["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err = (got.float() - want.float()).abs()
    # 2^-7 |plain| + 2^-6 sqrt(sum_j p_j^2 v_j^2) / l: one output ulp plus
    # ~10 standard deviations of the numerators' bf16 rounding noise
    tol = ref.flash_attention_tolerance(q, k, v, want, causal=causal,
                                        window=window)
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.cuda
def test_flash_attention_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import flash_attention as flash
    ok = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros((1, 16, 2, 32), dtype=torch.bfloat16, device="cuda")
        flash.flash_attention(x, x, x)
    with pytest.raises(TypeError):
        flash.flash_attention(ok.float(), ok.float(), ok.float())
    with pytest.raises(ValueError, match="multiple"):
        kv = torch.zeros((1, 16, 3, 64), dtype=torch.bfloat16, device="cuda")
        flash.flash_attention(ok, kv, kv)


def _tuple_band(x: torch.Tensor) -> torch.Tensor:
    """(T,) band of the norms identity over each tuple's own points."""
    norm2 = (x.double() ** 2).sum(-1).amax(-1)
    return ((64.0 + 4.0 * x.shape[-1]) * _EPS32 * norm2).sqrt()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [17, 64, 2304])
@pytest.mark.parametrize("q", range(1, 10))
def test_tuple_diameters_matches_plain_version_on_card(q, d):
    """K6 against its plain version and a float64 truth, within rtol 1e-5
    plus the band of the norms identity; padding a tuple by repeating a
    member keeps K6's diameter bit for bit (its norms are its Gram
    diagonal), and a one-point tuple has diameter 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import diameter
    gen = torch.Generator(device="cuda").manual_seed(q * 10_000 + d)
    for t in (1, 31, 5000):
        x = torch.randn((t, q, d), generator=gen, device="cuda") * 50 \
            + torch.rand((t, 1, d), generator=gen, device="cuda") * 200
        before = diameter.launches["tuple_diameters"]
        got = diameter.tuple_diameters(x)
        want = ref.tuple_diameters(x)
        torch.cuda.synchronize()
        assert diameter.launches["tuple_diameters"] == before + 1
        assert got.dtype == torch.float32 and got.shape == (t,)
        band = _tuple_band(x)
        x64 = x.double()            # float64 truth (its rounding ~1e-16)
        n2 = x64.square().sum(-1)
        truth = (n2[:, :, None] + n2[:, None, :]
                 - 2.0 * x64 @ x64.transpose(1, 2)).clamp_min(0.0) \
            .amax(dim=(1, 2)).sqrt()
        for other in (want.double(), truth):
            assert bool(((got.double() - other).abs()
                         <= 1e-5 * other.abs() + band).all())
        if q == 1:
            assert bool((got == 0).all())
        else:
            padded = torch.cat([x, x[:, -1:].expand(t, 9 - q, d)], 1) \
                .contiguous()
            assert torch.equal(diameter.tuple_diameters(padded), got)


@pytest.mark.cuda
def test_tuple_diameters_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import diameter
    with pytest.raises(ValueError, match="tuples of 10"):
        diameter.tuple_diameters(torch.zeros((4, 10, 8), device="cuda"))
    with pytest.raises(ValueError, match="tuples of 0"):
        diameter.tuple_diameters(torch.zeros((4, 0, 8), device="cuda"))
    with pytest.raises(TypeError):
        diameter.tuple_diameters(torch.zeros((4, 3, 8), device="cuda",
                                             dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        diameter.tuple_diameters(torch.zeros((4, 8, 3), device="cuda")
                                 .transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        diameter.tuple_diameters(torch.zeros((4, 3, 8)))


def _query_band(groups: torch.Tensor, mask: torch.Tensor) -> float:
    """``core.distributed.diameter_band`` on the card, in float64."""
    pts = groups[mask].double()
    if not len(pts):
        return 0.0
    norm2 = (pts - pts.mean(0)).square().sum(-1).max()
    return float(((64.0 + 4.0 * groups.shape[-1]) * _EPS32 * norm2).sqrt())


def _star_query(q: int, a: int, d: int, seed: int):
    """Centred (q, a, d) groups on the card, about 85% of each group valid
    (holes among the anchors too, anchor 0 valid), the last group down to a
    few points."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    groups = torch.randn((q, a, d), generator=gen, device="cuda") * 20 \
        + torch.rand((1, 1, d), generator=gen, device="cuda") * 10
    mask = torch.rand((q, a), generator=gen, device="cuda") < 0.85
    mask[0, 0] = True
    if q > 1:
        mask[-1, 7:] = False
    groups = groups - groups[mask].mean(0)
    return groups.contiguous(), mask


def _check_star(groups, mask, got, want, band, anchor_range=None):
    """Kernel against plain version on the valid anchors (of
    ``anchor_range`` ``(a0, count)``, default all): nn[:, 0] the anchor
    itself; each neighbour within the band of the plain one's float64
    distance (index 0 at BIG where the group has no valid point); worst_nn
    and the diameters of the kernel's own tuples within the band."""
    q = groups.shape[0]
    a0, count = anchor_range or (0, groups.shape[1])
    (nn, worst, diam), (nn_p, worst_p, _) = got, want
    valid = mask[0, a0:a0 + count]
    assert nn.dtype == torch.int32 and nn.shape == nn_p.shape
    assert torch.equal(nn[:, 0], nn_p[:, 0])
    a64 = groups[0, a0:a0 + count].double()
    for j in range(1, q):
        if not bool(mask[j].any()):
            assert bool((nn[valid, j] == 0).all())
            assert bool((worst[valid] == ref.BIG).all())
            continue
        g64 = groups[j].double()
        dk = (a64 - g64[nn[:, j].long()]).norm(dim=-1)
        dp = (a64 - g64[nn_p[:, j].long()]).norm(dim=-1)
        assert bool(mask[j][nn[valid, j].long()].all())
        assert bool(((dk - dp).abs()[valid] <= band).all())
    live = valid & (worst_p < ref.BIG)
    assert bool(((worst.double().sqrt() - worst_p.double().sqrt()).abs()[live]
                 <= band).all())
    tuples = torch.stack([groups[j][nn[:, j].long()] for j in range(q)], 1)
    own = ref.tuple_diameters(tuples).double()
    assert bool(((diam.double() - own).abs()[valid]
                 <= 1e-5 * own[valid] + band).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [17, 64, 2304])
@pytest.mark.parametrize("q", range(1, 10))
def test_anchor_star_matches_plain_version_on_card(q, d):
    """The fused anchor-star kernel against ``ref.anchor_star`` at 1, 31 and
    5000 anchors: two launches (one for q = 1), within the band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import diameter
    for a in (1, 31, 5000):
        groups, mask = _star_query(q, a, d, seed=q * 10_000 + d + a)
        before = diameter.launches["anchor_star"]
        got = diameter.anchor_star(groups, mask)
        want = ref.anchor_star(groups, mask)
        torch.cuda.synchronize()
        assert diameter.launches["anchor_star"] == before + (2 if q > 1 else 1)
        _check_star(groups, mask, got, want, _query_band(groups, mask))
        if q == 1:
            assert bool((got[1] == 0).all() and (got[2] == 0).all())


def _lowest_argmin(anchors, pts, valid):
    a, p = anchors.long(), pts.long()
    sq = (a[:, None] - p[None]).square().sum(-1)
    sq = torch.where(valid[None, :], sq, torch.iinfo(torch.int64).max)
    return sq.argmin(dim=1)        # the first of equal minima


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16, 64, 200])
def test_anchor_star_exact_ties_on_card(d):
    """Small integer coordinates, on which every fp32 sum is exact: copies of
    the anchors (sq exactly 0), duplicates across column tiles and units,
    masked lower copies. The kernel's neighbour is the lowest index among
    equal minima however R is split across blocks, and its worst_nn and
    diameters equal the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import diameter
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, r = 4, 1000
    groups = torch.randint(-3, 4, (q, r, d), generator=gen, device="cuda") \
        .float()
    for j in range(1, q):
        groups[j, 600:900] = groups[j, 20:320]     # duplicates, later tiles
        groups[j, 900:950] = groups[0, 0:50]       # copies of anchors
        groups[j, 10:30] = groups[0, 0:20]         # ... and lower ones
    mask = torch.ones((q, r), dtype=torch.bool, device="cuda")
    mask[1:, 10:20] = False
    mask[0, 990:] = False
    want_nn, want_worst, want_diam = ref.anchor_star(groups, mask)
    for tiles in (0, 1, 3):
        nn, worst, diam = diameter.anchor_star(groups, mask,
                                               tiles_per_unit=tiles)
        for j in range(1, q):
            lowest = _lowest_argmin(groups[0], groups[j], mask[j])
            assert torch.equal(nn[:, j].long(), lowest)
            assert torch.equal(want_nn[:, j].long(), lowest)
        assert torch.equal(worst, want_worst)
        assert torch.equal(diam, want_diam)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [17, 64, 200])
def test_anchor_star_split_merge_matches_unsplit_on_card(d):
    """R split across blocks (one column tile a unit, three, or 24) and
    merged by atomicMin gives the same bits as the shape's own split, the
    merge being exact whatever the order; also on sparse masks, where whole
    runs of tiles and most anchor tiles are skipped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import diameter
    groups, mask = _star_query(5, 3000, d, seed=d)
    mask[-1] = mask[1]                      # a large last group here
    # sparse: anchors in three tiles, a group of a few scattered points
    sparse = mask.clone()
    sparse[0] = False
    sparse[0, 130:140] = sparse[0, 640:700] = sparse[0, 2990:] = True
    sparse[2] = False
    sparse[2, [5, 1800, 1801, 2999]] = True
    for m in (mask, sparse):
        want = diameter.anchor_star(groups, m)
        _check_star(groups, m, want, ref.anchor_star(groups, m),
                    _query_band(groups, m))
        for tiles in (1, 3, 24):
            got = diameter.anchor_star(groups, m, tiles_per_unit=tiles)
            for g, w in zip(got, want):
                assert torch.equal(g, w)


@pytest.mark.cuda
def test_anchor_star_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import diameter
    g = torch.zeros((3, 8, 4), device="cuda")
    m = torch.ones((3, 8), dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError):
        diameter.anchor_star(g.double(), m)
    with pytest.raises(TypeError):
        diameter.anchor_star(g, m.int())
    with pytest.raises(ValueError, match="contiguous"):
        diameter.anchor_star(g.transpose(1, 2).contiguous().transpose(1, 2),
                             m)
    with pytest.raises(ValueError, match="CUDA"):
        diameter.anchor_star(g.cpu(), m.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        diameter.anchor_star(g, m.cpu())
    with pytest.raises(ValueError, match="tuples of 10"):
        diameter.anchor_star(torch.zeros((10, 8, 4), device="cuda"),
                             torch.ones((10, 8), dtype=torch.bool,
                                        device="cuda"))
    with pytest.raises(ValueError, match="mask must be"):
        diameter.anchor_star(g, m[:2])
    r = diameter.MAX_R + 1
    with pytest.raises(ValueError, match="R <="):
        diameter.anchor_star(torch.zeros((1, r, 1), device="cuda"),
                             torch.ones((1, r), dtype=torch.bool,
                                        device="cuda"))


@pytest.mark.cuda
def test_device_tier_on_card_matches_cpu():
    """The anchor-star tier on the card against ``device="cpu"`` (the plain
    path end to end) on a small corpus: ids equal, diameters within the
    band; the fused kernel launches twice per query, the standalone K6
    never, and the card path reaches no plain version (both raise if
    called)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch import NKSEngine, flickr_like_dataset, random_queries
    from repro_torch.core.device_plane import pack_groups
    from repro_torch.core.distributed import diameter_band
    from repro_torch.kernels import diameter
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = flickr_like_dataset(n=3000, d=32, u=80, t=4, seed=5)
    queries = random_queries(ds, 3, 12, seed=1) \
        + random_queries(ds, 9, 6, seed=2)
    card = NKSEngine(ds, device="cuda")
    cpu = NKSEngine(ds, device="cpu")
    plain = ref.anchor_star, ref.tuple_diameters

    def refuse(*args, **kw):
        raise AssertionError("the card path reached a plain version")
    ref.anchor_star = ref.tuple_diameters = refuse
    try:
        before = dict(diameter.launches)
        got = card.query_batch(queries, k=4, tier="device")
        assert diameter.launches["anchor_star"] \
            == before["anchor_star"] + 2 * len(queries)
        assert diameter.launches["tuple_diameters"] \
            == before["tuple_diameters"]
    finally:
        ref.anchor_star, ref.tuple_diameters = plain
    want = cpu.query_batch(queries, k=4, tier="device")
    for q, g, w in zip(queries, got, want):
        pg = pack_groups(ds, q)
        band = diameter_band(pg.groups, pg.mask)
        assert [c.ids for c in g.candidates] == [c.ids for c in w.candidates]
        assert g.candidates
        for cg, cw in zip(g.candidates, w.candidates):
            assert abs(cg.diameter - cw.diameter) <= band


def _k5_margin(x, w):
    """Settlement margin of the index build for K5 against its plain
    version, in bin units: 2 gamma_d |x|_2 / w plus a few ulps."""
    from repro_torch.core import index_build
    return index_build.margin_scale(x.float())[:, None] / float(
        np.float32(w))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [33, 64, 2304])
@pytest.mark.parametrize("m", range(1, 9))
def test_project_and_bin_matches_plain_version_on_card(m, d):
    """K5 against its plain version at N not a multiple of any block: p
    within the dot-product bound 2 gamma_d |x|_2, bins equal except inside
    the settlement margin, where they may be 1 apart; bf16 input too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import project_bin
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(m * 1000 + d)
    n = 1237
    x = torch.from_numpy(rng.uniform(-500, 1000, (n, d)).astype(np.float32))
    z = rng.standard_normal((m, d)).astype(np.float32)
    z = torch.from_numpy(z / np.linalg.norm(z, axis=1, keepdims=True))
    w, c = 37.5, 1 << 20
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype).cuda()
        before = project_bin.launches["project_and_bin"]
        got = project_bin.project_and_bin(xd, z.cuda(), w, c)
        torch.cuda.synchronize()
        assert project_bin.launches["project_and_bin"] == before + 1
        want = ref.project_and_bin(xd, z.cuda(), w, c)
        margin = _k5_margin(xd, w)
        assert bool(((got[2] - want[2]).abs() <= margin * w).all())
        p = want[2]
        for g, e, v in ((got[0], want[0], p / w),
                        (got[1], want[1], (p - w / 2) / w)):
            off = g != e
            near = (v - v.round()).abs() <= margin + 8 * 2.0 ** -24 \
                * (v.abs() + 1)
            assert int((g.long() - e.long()).abs().max()) <= 1
            assert not bool((off & ~near).any())


@pytest.mark.cuda
def test_project_and_bin_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import project_bin
    x = torch.zeros((8, 16), device="cuda")
    with pytest.raises(ValueError, match="m=9"):
        project_bin.project_and_bin(x, torch.zeros((9, 16), device="cuda"),
                                    1.0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        project_bin.project_and_bin(torch.zeros((16, 8), device="cuda").T,
                                    torch.zeros((2, 16), device="cuda"),
                                    1.0, 0)
    with pytest.raises(TypeError):
        project_bin.project_and_bin(x.double(),
                                    torch.zeros((2, 16), device="cuda"),
                                    1.0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        project_bin.project_and_bin(torch.zeros((8, 16)),
                                    torch.zeros((2, 16)), 1.0, 0)


def _assert_index_equal(got, want):
    assert (got.w0, got.p_max, got.n_scales, got.exact) == \
        (want.w0, want.p_max, want.n_scales, want.exact)
    np.testing.assert_array_equal(got.z, want.z)
    for a, b in zip(got.structures, want.structures):
        assert (a.width, a.n_buckets) == (b.width, b.n_buckets)
        for x, y in ((a.table, b.table), (a.khb, b.khb)):
            for u, v in ((x.offsets, y.offsets), (x.values, y.values)):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


@pytest.mark.cuda
def test_card_build_equals_host_build():
    """The engine's build on the card (K5, settlement, hashing and CSRs on
    the card) equals the numpy host build bit for bit at n = 20,000."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch import NKSEngine, flickr_like_dataset
    from repro_torch.core.index import build_index
    from repro_torch.kernels import project_bin
    ds = flickr_like_dataset(n=20_000, d=64, u=2000, t=11, seed=3)
    before = project_bin.launches["project_and_bin"]
    engine = NKSEngine(ds, device="cuda")
    assert project_bin.launches["project_and_bin"] == before + 5
    _assert_index_equal(engine.index_e, build_index(ds, exact=True))
    _assert_index_equal(engine.index_a, build_index(ds, exact=False))


@pytest.mark.cuda
def test_streaming_on_card_matches_cpu():
    """Inserts, deletes and a compaction on the card against the same ops
    with ``device="cpu"``: identical delta bucket matrices, answers and
    compacted indices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch import NKSEngine, flickr_like_dataset, random_queries
    from repro_torch.kernels import project_bin
    ds = flickr_like_dataset(n=4000, d=64, u=300, t=5, seed=6)
    more = flickr_like_dataset(n=600, d=64, u=300, t=5, seed=7)
    queries = random_queries(ds, 3, 10, seed=2)
    engines = [NKSEngine(ds, device=dev, auto_compact=False)
               for dev in ("cuda", "cpu")]
    for lo in range(0, more.n, 200):
        batch = (more.points[lo:lo + 200],
                 [more.kw.row(i).tolist() for i in range(lo, lo + 200)])
        before = project_bin.launches["project_and_bin"]
        ids = [e.insert(*batch).tolist() for e in engines]
        assert project_bin.launches["project_and_bin"] == before + 5
        assert ids[0] == ids[1]
    for e in engines:
        e.delete([5, 17, 4001, 4300])
    card, cpu = engines
    for key in ("e", "a"):
        for s in range(5):
            np.testing.assert_array_equal(card._deltas[key].bucket_matrix(s),
                                          cpu._deltas[key].bucket_matrix(s))
    for tier in ("exact", "approx"):
        got, want = (e.query_batch(queries, k=2, tier=tier, backend="numpy")
                     for e in engines)
        assert [[(c.ids, c.diameter) for c in r.candidates] for r in got] \
            == [[(c.ids, c.diameter) for c in r.candidates] for r in want]
    assert card.compact() and cpu.compact()
    _assert_index_equal(card.index_e, cpu.index_e)
    _assert_index_equal(card.index_a, cpu.index_a)


# (S, P, d, bm, bn): tiles that divide a 32-column word, straddle one, and
# the reference's own grids.
K4_CASES = [(3, 10, 8, 16, 16), (5, 37, 9, 16, 16), (2, 200, 12, 128, 128),
            (9, 7, 33, 128, 128), (4, 130, 64, 8, 8), (3, 300, 16, 5, 48),
            (8, 700, 64, 128, 128), (2, 97, 3, 1, 1)]


def _check_join_batched_tiles(x, lens, radii, bm, bn):
    """K4 against ``ref.join_batched_dense`` on the card: sq within the fp32
    band on each live square, bitwise symmetric there and fp32 max exactly
    outside it; per-tile counts equal except by the band cells inside each
    tile (the mirrored half counted in its own orientation)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    s, p, d = x.shape
    args = [torch.from_numpy(a).to(dev) for a in (x, lens, radii)]
    before = pairwise_l2.launches["join_batched_tiles"]
    sq_k, c_k = pairwise_l2.join_batched_tiles(*args, bm=bm, bn=bn)
    sq_p, c_p = ref.join_batched_dense(*args, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert pairwise_l2.launches["join_batched_tiles"] == before + 1
    assert sq_k.shape == sq_p.shape and c_k.shape == c_p.shape
    fmax = np.finfo(np.float32).max
    sq_k, sq_p = sq_k.cpu().numpy(), sq_p.cpu().numpy()
    np.testing.assert_array_equal(sq_k == fmax, sq_p == fmax)
    gm, gn = -(-p // bm), -(-p // bn)
    for si, band in enumerate(_band(x, lens, radii, np.ones((s, p), bool))):
        n = int(lens[si])
        live = np.zeros((p, p), bool)
        live[:n, :n] = True
        assert (sq_k[si][~live] == fmax).all(), f"subset {si}"
        blk = sq_k[si, :n, :n]
        assert (blk.view(np.uint32) == blk.T.view(np.uint32)).all()
        norm2 = (x[si, :n].astype(np.float64) ** 2).sum(-1).max() if n else 0
        tol = (64 + 4 * d) * _EPS32 * norm2
        assert float(np.abs(blk - sq_p[si, :n, :n]).max(initial=0.0)) <= tol
        pad = np.zeros((gm * bm, gn * bn), np.int64)
        pad[:p, :p] = band
        band_cells = pad.reshape(gm, bm, gn, bn).sum(axis=(1, 3))
        diff = np.abs(c_k[si].cpu().numpy().astype(np.int64)
                      - c_p[si].cpu().numpy())
        assert (diff <= band_cells).all(), f"subset {si}"
        joined = np.zeros((gm * bm, gn * bn), np.int64)
        joined[:n, :n] = blk <= np.float32(radii[si]) ** 2
        np.testing.assert_array_equal(
            c_k[si].cpu().numpy(),
            joined.reshape(gm, bm, gn, bn).sum(axis=(1, 3)))
        if not np.isfinite(radii[si]):
            assert int(c_k[si].sum()) == n * n


@pytest.mark.cuda
@pytest.mark.parametrize("s,p,d,bm,bn", K4_CASES)
def test_join_batched_tiles_matches_plain_version_on_card(s, p, d, bm, bn):
    """K4 against ``ref.join_batched_dense`` (``_check_join_batched_tiles``)
    with random lengths, the first P and the last 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    rng = np.random.default_rng(s * p + bm)
    x = rng.uniform(0, 100, (s, p, d)).astype(np.float32)
    lens = rng.integers(0, p + 1, size=s).astype(np.int32)
    lens[0], lens[-1] = p, 0
    radii = rng.uniform(0, 150, size=s).astype(np.float32)
    radii[min(1, s - 1)] = np.inf
    _check_join_batched_tiles(x, lens, radii, bm, bn)


# (S, P, d, bm, bn, lengths): every subset live at L = P (dense, many
# off-diagonal tiles mirrored), bm != bn on mirrored tiles, and a batch of
# more subsets than the kernel's walk table holds (S > 128).
K4_DENSE_CASES = [(4, 384, 64, 128, 128, "full"), (3, 261, 33, 48, 16, "full"),
                  (2, 300, 8, 16, 80, "full"), (2, 517, 64, 100, 7, "0-P"),
                  (300, 40, 4, 8, 3, "random"), (2, 1000, 64, 128, 128, "full")]


@pytest.mark.cuda
@pytest.mark.parametrize("s,p,d,bm,bn,lengths", K4_DENSE_CASES)
def test_join_batched_tiles_dense_and_mirrored_on_card(s, p, d, bm, bn,
                                                       lengths):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    rng = np.random.default_rng(s + p + bn)
    x = rng.uniform(0, 100, (s, p, d)).astype(np.float32)
    if lengths == "full":
        lens = np.full(s, p, np.int32)
    elif lengths == "0-P":
        lens = np.array([0, p], np.int32)
    else:
        lens = rng.integers(0, p + 1, size=s).astype(np.int32)
    # radii near the median distance: counts neither empty nor full
    radii = (100 * np.sqrt(d / 6) * rng.uniform(0.8, 1.1, size=s)
             ).astype(np.float32)
    _check_join_batched_tiles(x, lens, radii, bm, bn)


# (M, N, d, bm, bn): tails off the 128 tile and off 4 (scalar stores),
# features off 4 (scalar staging) and past one stage, the caller's grid.
K3_CASES = [(1, 1, 1, 128, 128), (5, 3, 3, 1, 1), (130, 70, 33, 16, 48),
            (257, 259, 64, 128, 128), (300, 129, 64, 7, 5),
            (129, 131, 2304, 128, 128), (511, 257, 1, 48, 16),
            (384, 1000, 64, 128, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d,bm,bn", K3_CASES)
def test_pairwise_join_tails_on_card(m, n, d, bm, bn):
    """K3 against ``ref.pairwise_join``: sq within the fp32 band, counts on
    the caller's (bm, bn) grid equal but for each tile's band cells, and
    exactly the kernel's own sq thresholded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(m * n + d)
    a = rng.uniform(0, 100, (m, d)).astype(np.float32)
    b = rng.uniform(0, 100, (n, d)).astype(np.float32)
    r = float(100 * np.sqrt(d / 6))
    at, bt = (torch.from_numpy(v).cuda() for v in (a, b))
    before = pairwise_l2.launches["pairwise_join"]
    sq_k, n_k = pairwise_l2.pairwise_join(at, bt, r, bm=bm, bn=bn)
    sq_p, n_p = ref.pairwise_join(at, bt, r, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert pairwise_l2.launches["pairwise_join"] == before + 1
    assert n_k.shape == n_p.shape == (-(-m // bm), -(-n // bn))
    norm2 = max((a.astype(np.float64) ** 2).sum(-1).max(),
                (b.astype(np.float64) ** 2).sum(-1).max())
    tol = (64 + 4 * d) * _EPS32 * norm2
    sq_k, sq_p = sq_k.cpu().numpy(), sq_p.cpu().numpy()
    assert float(np.abs(sq_k - sq_p).max()) <= tol
    d2 = ((a.astype(np.float64)[:, None] - b[None].astype(np.float64)) ** 2
          ).sum(-1)
    gm, gn = n_p.shape

    def tiles(cells):
        pad = np.zeros((gm * bm, gn * bn), np.int64)
        pad[:m, :n] = cells
        return pad.reshape(gm, bm, gn, bn).sum(axis=(1, 3))
    r2 = np.float32(r) ** 2
    band = tiles(np.abs(d2 - float(r2)) <= tol)
    assert (np.abs(n_k.cpu().numpy() - n_p.cpu().numpy()) <= band).all()
    np.testing.assert_array_equal(n_k.cpu().numpy(), tiles(sq_k <= r2))
    _, n_inf = pairwise_l2.pairwise_join(at, bt, bm=bm, bn=bn)
    assert int(n_inf.sum()) == m * n


@pytest.mark.cuda
@pytest.mark.parametrize("s,p,d", CASES)
def test_prune_with_eligibility_matches_plain_version_on_card(s, p, d):
    """K2 with and without eligibility words against its plain version, and
    the coarse counts never below K1's eligible counts at the fp32 radius."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(s + 3 * p + d)
    x = rng.uniform(0, 100, (s, p, d)).astype(np.float32)
    lens = rng.integers(0, p + 1, size=s).astype(np.int32)
    lens[0] = p
    radii = rng.uniform(0, 150, size=s).astype(np.float32)
    el = rng.random((s, p)) < 0.3
    norms = np.sqrt((x.astype(np.float64) ** 2).sum(-1)).max()
    rc = ((radii + 2 * 2.0 ** -8 * norms) * 1.05).astype(np.float32)
    elig = torch.from_numpy(pack_join_mask(el).view(np.int32)).to(dev)
    args = [torch.from_numpy(a).to(dev) for a in (x, lens, rc)]
    for words, live in ((None, np.ones_like(el)), (elig, el)):
        k_k = pairwise_l2.join_batched_prune(*args, words).cpu().numpy()
        k_p = ref.join_batched_counts(*args, words).cpu().numpy()
        for si, band in enumerate(_band(x, lens, rc, live, bf16=True)):
            assert abs(int(k_k[si]) - int(k_p[si])) <= int(band.sum())
        _, c1 = pairwise_l2.join_batched_masked(
            args[0], args[1], torch.from_numpy(radii).to(dev), words)
        assert (k_k >= c1.cpu().numpy()).all()


@pytest.mark.cuda
def test_filtered_engine_on_card_matches_cpu():
    """Filtered exact and approx batches on the card (fold mode, eligible-
    dense packing, the prune tier forced on) against the same backend with
    ``device="cpu"``: identical answers (both settle in float64), the
    engine's default backend too; K1 launches with eligibility words and K2
    with eligibility."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch import NKSEngine, flickr_like_dataset, random_queries
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.filters import where
    from repro_torch.data.synthetic import attach_attrs
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = attach_attrs(flickr_like_dataset(n=6000, d=32, u=150, t=4, seed=4),
                      seed=1)
    queries = random_queries(ds, 3, 12, seed=3)
    card = NKSEngine(ds, device="cuda")
    cpu = NKSEngine(ds, device="cpu")
    words = {k: pairwise_l2.launches[k] for k in
             ("join_batched_masked_elig", "join_batched_prune_elig")}
    for sel in (0.5, 0.1):
        flt = where(("price", "<", 100.0 * sel))
        before = pairwise_l2.launches["join_batched_prune"]
        for tier in ("exact", "approx"):
            got = card.query_batch(
                queries, k=2, tier=tier, filter=flt,
                backend=TorchBackend(route="device", prune_tier="on"))
            if tier == "exact":     # approx at k=2 may dispatch nothing
                assert pairwise_l2.launches["join_batched_prune"] > before
            want = cpu.query_batch(
                queries, k=2, tier=tier, filter=flt,
                backend=TorchBackend(device="cpu", route="device",
                                     prune_tier="on"))
            assert [[(c.ids, c.diameter) for c in r.candidates]
                    for r in got] == \
                [[(c.ids, c.diameter) for c in r.candidates]
                 for r in want]
            default = card.query_batch(queries, k=2, tier=tier,
                                       filter=flt)
            assert [[(c.ids, c.diameter) for c in r.candidates]
                    for r in default] == \
                [[(c.ids, c.diameter) for c in r.candidates]
                 for r in got]
    for k, before in words.items():
        assert pairwise_l2.launches[k] > before, f"{k}: no launch took " \
            f"eligibility words"


# (B, S, T, H, Kv, hd, causal, window): S and T off the 64-row tile and off
# 128, T != S, B*H = 1,152 as on the embed path, hd 128 with grouped-query
# heads 36/4, windows of 1 and 1024.
FLASH_EDGE_CASES = [
    (1, 1, 1, 2, 2, 64, True, None), (1, 63, 63, 2, 1, 64, True, None),
    (1, 65, 65, 2, 2, 64, True, None), (1, 129, 129, 4, 2, 64, False, None),
    (1, 700, 700, 2, 2, 64, True, 1), (1, 700, 700, 2, 2, 64, True, 1024),
    (2, 100, 170, 4, 2, 64, True, None), (2, 170, 100, 4, 2, 64, False, None),
    (32, 64, 64, 36, 36, 64, True, None),
    (1, 129, 129, 36, 4, 128, True, None),
    (1, 700, 700, 36, 4, 128, True, 1024),
    (2, 65, 129, 4, 4, 128, True, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window", FLASH_EDGE_CASES)
def test_flash_attention_edge_shapes_on_card(b, s, t, h, kv, hd, causal,
                                             window):
    """K7 against its plain version where tiles, batches and heads have
    edges: every element within ``ref.flash_attention_tolerance``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import flash_attention as flash
    gen = torch.Generator(device="cuda").manual_seed(b * s + t + hd)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    got = flash.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = ref.flash_attention_tolerance(q, k, v, want, causal=causal,
                                        window=window)
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got.float()).all())
    assert bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("with_sq", [False, True])
def test_masked_join_triangle_on_card(fold, with_sq):
    """K1 computes the upper triangle of tiles and mirrors it: the mask is
    symmetric bit for bit, equals the plain version's off the fp32 band
    (counts within it), holds no bit past a subset's length or on an
    ineligible point, and with ``with_sq`` both halves of sq are written
    (fp32-max outside the valid square)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lengths = [0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 200]
    s, p, d = len(lengths), 200, 64
    rng = np.random.default_rng(17 + fold + 2 * with_sq)
    x = rng.uniform(0, 10, (s, p, d)).astype(np.float32)
    lens = np.array(lengths, dtype=np.int32)
    radii = rng.uniform(5, 40, size=s).astype(np.float32)
    el = rng.random((s, p)) < 0.7 if fold else np.ones((s, p), dtype=bool)
    elig = torch.from_numpy(pack_join_mask(el).view(np.int32)).to(dev) \
        if fold else None
    args = [torch.from_numpy(a).to(dev) for a in (x, lens, radii)]
    got = pairwise_l2.join_batched_masked(*args, elig, with_sq=with_sq)
    want = ref.join_batched_masked(*args, elig, with_sq=with_sq)
    torch.cuda.synchronize()
    bits = ref.unpack_bits(got[0], p).cpu().numpy()
    want_bits = ref.unpack_bits(want[0], p).cpu().numpy()
    counts = got[1].cpu().numpy()
    for si, band in enumerate(_band(x, lens, radii, el)):
        n = lengths[si]
        assert (bits[si] == bits[si].T).all(), f"subset {si}: not symmetric"
        assert not ((bits[si] != want_bits[si]) & ~band).any(), f"subset {si}"
        assert abs(int(counts[si]) - int(want[1][si])) <= int(band.sum())
        assert int(counts[si]) == int(bits[si].sum())
        live = (np.arange(p) < n) & el[si]
        assert not (bits[si] & ~(live[:, None] & live[None, :])).any()
    words = got[0].cpu().numpy().view(np.uint32)
    for si, n in enumerate(lengths):
        assert not words[si, n:].any(), f"subset {si}: words past L"
    if with_sq:
        sq_k, sq_p = got[2].cpu().numpy(), want[2].cpu().numpy()
        fmax = np.finfo(np.float32).max
        for si, n in enumerate(lengths):
            valid = np.zeros((p, p), dtype=bool)
            valid[:n, :n] = True
            assert (sq_k[si][~valid] == fmax).all()
            if n:
                norm2 = (x[si, :n].astype(np.float64) ** 2).sum(-1).max()
                tol = (64.0 + 4.0 * d) * _EPS32 * norm2
                assert np.abs(sq_k[si][valid] - sq_p[si][valid]).max() <= tol
                assert (sq_k[si][:n, :n] == sq_k[si][:n, :n].T).all()


def _band_counts(x, lens, r, live=None):
    """(S,) cells of each subset's live square whose float64 squared
    distance, over the bf16-rounded coordinates, lies within the fp32 band
    ``(64 + 4d) eps32 max|x|^2`` of ``r^2`` (computed on the card in
    float64: its own error is ~1e-16 of the norms)."""
    s, p, d = x.shape
    xx = x.to(torch.bfloat16).double()
    n2 = (xx * xx).sum(-1)
    d2 = (n2[:, :, None] + n2[:, None, :]
          - 2.0 * xx @ xx.transpose(1, 2)).clamp_min(0.0)
    ok = torch.arange(p, device=x.device)[None, :] < lens.long()[:, None]
    if live is not None:
        ok &= live
    norm2 = torch.where(ok, n2, torch.zeros_like(n2)).amax(dim=1)
    tol = (64.0 + 4.0 * d) * _EPS32 * norm2
    band = (ok[:, :, None] & ok[:, None, :]) \
        & ((d2 - r.double()[:, None, None] ** 2).abs() <= tol[:, None, None])
    return band.sum(dim=(1, 2))


# (S, P, d, lengths): the shapes K2's tensor-core tiling meets — the
# recorded path's (8, 2880, 64) at full length, two feature panels with a
# partial second (d = 100), the embedded corpus's d = 2304, P off the
# 64-point tile, and lengths 0, 1, 63, 64 and 65 at the tile's edges.
PRUNE_CASES = [(8, 2880, 64, None), (2, 300, 100, None), (2, 256, 2304, None),
               (3, 200, 64, [200, 130, 77]), (5, 200, 64, [0, 1, 63, 64, 65]),
               (4, 97, 48, [97, 96, 33, 0])]


@pytest.mark.cuda
@pytest.mark.parametrize("s,p,d,lengths", PRUNE_CASES)
def test_prune_tensor_cores_match_plain_version_on_card(s, p, d, lengths):
    """K2 (wgmma on bf16 tiles) against its plain version at the shapes its
    tiling meets, with and without eligibility words (one subset wholly
    ineligible): counts within the band of the bf16 tile, and never below
    K1's counts at the fp32 radius."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(s * p + d)
    x = rng.uniform(0, 10, (s, p, d)).astype(np.float32)
    lens = np.array(lengths if lengths else [p] * s, dtype=np.int32)
    # radii just under the typical pair distance (E|x - y|^2 = 100 d / 6),
    # so that joins are partial at every d
    radii = (np.sqrt(d * 100 / 6.0) * rng.uniform(0.85, 1.0, size=s)) \
        .astype(np.float32)
    norms = np.sqrt((x.astype(np.float64) ** 2).sum(-1)).max()
    rc = ((radii + 2 * 2.0 ** -8 * norms) * 1.05).astype(np.float32)
    el = rng.random((s, p)) < 0.5
    el[min(1, s - 1)] = False
    words = torch.from_numpy(pack_join_mask(el).view(np.int32)).to(dev)
    xt, lt, rt, rct = (torch.from_numpy(a).to(dev)
                       for a in (x, lens, radii, rc))
    before = pairwise_l2.launches["join_batched_prune"]
    for w, live in ((None, None), (words, torch.from_numpy(el).to(dev))):
        got = pairwise_l2.join_batched_prune(xt, lt, rct, w)
        want = ref.join_batched_counts(xt, lt, rct, w)
        _, fp32 = pairwise_l2.join_batched_masked(xt, lt, rt, w)
        band = _band_counts(xt, lt, rct, live)
        assert bool(((got.long() - want.long()).abs() <= band).all()), \
            (got.tolist(), want.tolist(), band.tolist())
        assert bool((got >= fp32).all()), (got.tolist(), fp32.tolist())
        if w is not None:
            assert int(got[min(1, s - 1)]) == 0
    assert pairwise_l2.launches["join_batched_prune"] == before + 2
    empty = [i for i, n in enumerate(lens) if n == 0]
    assert all(int(got[i]) == 0 for i in empty)


@pytest.mark.cuda
def test_prune_adversarial_boundary_on_card():
    """Pairs within r (1 +/- k 2^-9) of the threshold, on the card: the
    coarse count at the widened radius never misses a pair at float64
    distance <= r, and is never below K1's count at the fp32 radius."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dev = torch.device("cuda")
    for d in (8, 64, 100):
        for seed, r in ((0, 1.0), (1, 7.3), (2, 123.0)):
            rng = np.random.default_rng(seed + d)
            base = rng.uniform(-1, 1, d)
            base /= np.linalg.norm(base)
            pts = [rng.uniform(-r, r, d).astype(np.float32)]
            for k in (-4, -1, 0, 1, 4):
                pts.append((pts[0] + base * r * (1.0 + k * 2.0 ** -9))
                           .astype(np.float32))
            x = np.stack(pts)[None].astype(np.float32)
            pf = x[0].astype(np.float64)
            d2 = ((pf[:, None] - pf[None, :]) ** 2).sum(-1)
            exact = int((np.sqrt(d2) <= r).sum())
            norms = np.sqrt((pf ** 2).sum(-1)).max()
            rc = np.array([(r + 2 * 2.0 ** -8 * norms) * 1.05], np.float32)
            xt = torch.from_numpy(x).to(dev)
            lt = torch.tensor([x.shape[1]], dtype=torch.int32, device=dev)
            got = int(pairwise_l2.join_batched_prune(
                xt, lt, torch.from_numpy(rc).to(dev))[0])
            fp32 = int(pairwise_l2.join_batched_masked(
                xt, lt, torch.tensor([r], dtype=torch.float32,
                                     device=dev))[1][0])
            assert got >= exact, f"d={d} seed={seed} r={r}: {got} < {exact}"
            assert got >= fp32, f"d={d} seed={seed} r={r}: {got} < {fp32}"


@pytest.mark.cuda
def test_cost_model_on_card_measures_both_slopes():
    """The cost-model probe on the card times the masked join and the
    coarse counts by CUDA events: both per-cell slopes clear the 1e-13 s
    floor (the fit raises otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.core import backend
    model = backend.calibrate_cost_model(64, torch.device("cuda"))
    assert model.platform == "cuda"
    assert model.dev_cell_s > backend.CELL_FLOOR_S
    assert model.prune_cell_s > backend.CELL_FLOOR_S
    assert model.dev_fixed_s >= 0.0


# (S, P, d, lengths): K2i's walk and panels — the path's (8, 2880, 64) with
# the recorded live lengths, a partial second 128-feature panel (d = 130),
# the embedded corpus's d = 2304, P off the 128-point tile and lengths at
# the tile's edges (and at its 64-row halves); widths at the int8 rows'
# 32-byte pitch's edges (d = 31 .. 128: one TMA panel, zeros past the
# pitch); runs of 4 tiles sharing a column panel whose last run of a subset
# is partial, the walk stepping into the next subset (8 x 2100: 153 tiles
# a subset, more than 4 a resident block); and more subsets than the walk's
# table holds (300: the interleaved order).
INT8_CASES = [(8, 2880, 64, [2779, 2876, 0, 0, 0, 0, 0, 0]),
              (2, 300, 130, None), (2, 256, 2304, None),
              (5, 200, 64, [0, 1, 63, 64, 65]), (4, 97, 17, [97, 96, 33, 0]),
              (200, 40, 33, None),
              *[(3, 260, d, [260, 129, 128]) for d in (31, 32, 33, 96, 127,
                                                        128)],
              (4, 300, 64, [300, 256, 192, 127]),
              (8, 2100, 64, None), (300, 130, 20, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,p,d,lengths", INT8_CASES)
def test_prune_int8_matches_plain_version_on_card(s, p, d, lengths):
    """K2i (int8 wgmma, exact int32 sums) against its plain version, with
    and without eligibility words (one subset wholly ineligible), on padded
    rows of random values (the scale spans the whole block): counts equal
    bit for bit, and never below K1's at the same radius."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(s * p + d + 1)
    x = rng.uniform(-10, 10, (s, p, d)).astype(np.float32)
    lens = np.array(lengths if lengths else [p] * s, dtype=np.int32)
    # E|x - y|^2 = 400 d / 6: radii just under it, partial joins at every d
    radii = (np.sqrt(d * 400 / 6.0) * rng.uniform(0.85, 1.0, size=s)) \
        .astype(np.float32)
    el = rng.random((s, p)) < 0.5
    el[min(1, s - 1)] = False
    words = torch.from_numpy(pack_join_mask(el).view(np.int32)).to(dev)
    x_h, l_h, r_h = (torch.from_numpy(a) for a in (x, lens, radii))
    xt, lt, rt = (t.to(dev) for t in (x_h, l_h, r_h))
    before = pairwise_l2.launches["join_batched_prune_int8"]
    for w in (None, words):
        got = pairwise_l2.join_batched_prune_int8(xt, lt, rt, w)
        want = ref.join_batched_counts_int8(
            x_h, l_h, r_h, None if w is None else w.cpu())
        _, fp32 = pairwise_l2.join_batched_masked(xt, lt, rt, w)
        assert got.tolist() == want.tolist()
        assert bool((got >= fp32).all()), (got.tolist(), fp32.tolist())
        if w is not None:
            assert int(got[min(1, s - 1)]) == 0
    assert pairwise_l2.launches["join_batched_prune_int8"] == before + 4
    assert all(int(got[i]) == 0 for i, n in enumerate(lens) if n == 0)


@pytest.mark.cuda
def test_prune_int8_scale_from_a_padded_row_on_card():
    """The largest magnitude of a subset lies in a padded row past every
    length: the scale still comes from it (the reference quantises the whole
    padded block), so the counts equal the plain version's and differ from
    those of the same subset without that row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dev = torch.device("cuda")
    s, p, d = 3, 200, 40
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (s, p, d)).astype(np.float32)
    lens = np.array([150, 63, 129], np.int32)
    x[:, p - 1, 3] = np.float32(8.0)            # row 199: past every length
    radii = np.full(s, 4.5, np.float32)         # partial joins either way
    x_h, l_h, r_h = (torch.from_numpy(a) for a in (x, lens, radii))
    got = pairwise_l2.join_batched_prune_int8(
        *(t.to(dev) for t in (x_h, l_h, r_h)))
    want = ref.join_batched_counts_int8(x_h, l_h, r_h)
    x_h[:, p - 1, 3] = 0.0
    without = ref.join_batched_counts_int8(x_h, l_h, r_h)
    assert got.tolist() == want.tolist()
    assert all(a != b for a, b in zip(want.tolist(), without.tolist()))
    assert all(0 < c < n * n for c, n in zip(want.tolist(), lens.tolist()))


@pytest.mark.cuda
def test_prune_int8_zero_and_single_point_subsets_on_card():
    """All-zero subsets (the scale's 1e-30 floor), single points, a zero
    radius and an infinite one, and integer coordinates on half levels:
    the plain version's counts, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dev = torch.device("cuda")
    s, p, d = 6, 70, 9
    rng = np.random.default_rng(5)
    x = np.round(rng.uniform(-4, 4, (s, p, d))).astype(np.float32)
    x[0] = 0.0
    x[3, :, 0] = 127.0
    x[3, ::2, 1] = 0.5
    x[3, 1::2, 1] = 1.5
    lens = np.array([70, 1, 0, 70, 17, 70], np.int32)
    radii = np.array([1.0, 0.0, 3.0, 0.0, np.inf, 2.5], np.float32)
    x_h, l_h, r_h = (torch.from_numpy(a) for a in (x, lens, radii))
    got = pairwise_l2.join_batched_prune_int8(
        *(t.to(dev) for t in (x_h, l_h, r_h)))
    assert got.tolist() == ref.join_batched_counts_int8(x_h, l_h, r_h).tolist()
    assert got[0] == 70 * 70 and got[1] == 1 and got[2] == 0
    assert got[4] == 17 * 17


@pytest.mark.cuda
def test_prune_int8_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dev = torch.device("cuda")
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    r = torch.ones(1, device=dev)
    with pytest.raises(TypeError):
        pairwise_l2.join_batched_prune_int8(
            torch.zeros((1, 4, 2), dtype=torch.float64, device=dev), lens, r)
    with pytest.raises(ValueError, match="overflows"):
        pairwise_l2.join_batched_prune_int8(
            torch.zeros((1, 1, pairwise_l2.INT8_MAX_D + 1), device=dev),
            lens, r)


@pytest.mark.cuda
def test_store_and_recovery_on_card_match_numpy(tmp_path):
    """``build_store`` and ``from_store`` with the default device (the
    card), then a WAL'd engine's inserts, deletes and compaction recovered
    with the default device: on both engines the torch backend's answers
    equal the same engine's numpy backend's (ids but for float64 ties
    within 8 ulps of the rescore; costs to 1e-9), filtered too, and K5
    runs the store's build (5 launches) and each replayed op (5: an insert
    batch, a delete's bulk rows, a compaction)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch import NKSEngine, flickr_like_dataset, random_queries
    from repro_torch.core import store
    from repro_torch.data.synthetic import attach_attrs, synthetic_attrs
    from repro_torch.kernels import project_bin
    ds = attach_attrs(flickr_like_dataset(n=4000, d=64, u=300, t=5, seed=6),
                      seed=1)
    more = flickr_like_dataset(n=400, d=64, u=300, t=5, seed=7)
    more_attrs = synthetic_attrs(more.n, seed=7)
    queries = random_queries(ds, 3, 10, seed=2)
    flt = {"where": [["price", "<", 50.0]]}

    def rows(eng, ids):          # answers carry external ids
        return np.searchsorted(eng._ext_of, np.asarray(ids, np.int64))

    def rescore(eng, ids):
        pts = np.asarray(eng.dataset.points[rows(eng, ids)], np.float64)
        return float(np.sqrt(((pts[:, None] - pts[None, :]) ** 2)
                             .sum(-1).max()))

    def covers(eng, q, ids):
        return set(q) <= {int(v) for i in rows(eng, ids)
                          for v in eng.dataset.kw.row(int(i))}

    def same(eng):
        # The numpy backend scores through the norms identity, the torch
        # backend through differences: two equally tight sets may swap, so
        # differing ids must both cover the query and rescore within 8 ulps.
        for tier in ("exact", "approx"):
            for kw in ({}, {"filter": flt}):
                got, want = (eng.query_batch(queries, k=2, tier=tier,
                                             backend=b, **kw)
                             for b in ("torch", "numpy"))
                for q, g, w in zip(queries, got, want):
                    np.testing.assert_allclose(
                        [c.diameter for c in g.candidates],
                        [c.diameter for c in w.candidates], rtol=1e-9)
                    for x, y in zip(g.candidates, w.candidates):
                        if x.ids != y.ids:
                            a, b = rescore(eng, x.ids), rescore(eng, y.ids)
                            assert covers(eng, q, x.ids) \
                                and covers(eng, q, y.ids)
                            assert abs(a - b) <= 8 * np.spacing(max(a, b))

    before = project_bin.launches["project_and_bin"]
    store.build_store(str(tmp_path / "store"), ds)
    assert project_bin.launches["project_and_bin"] == before + 5
    opened = NKSEngine.from_store(str(tmp_path / "store"),
                                  resident_budget_bytes=1 << 20)
    assert opened.device.type == "cuda"
    assert opened.backend.cache_bytes == 1 << 20
    same(opened)

    live = NKSEngine(ds, auto_compact=False)
    live.attach_wal(str(tmp_path / "wal"))
    for lo in range(0, more.n, 200):
        live.insert(more.points[lo:lo + 200],
                    [more.kw.row(i).tolist() for i in range(lo, lo + 200)],
                    attrs={k: v[lo:lo + 200] for k, v in more_attrs.items()})
    live.delete([5, 17, 4001, 4300])
    live.compact()
    before = project_bin.launches["project_and_bin"]
    rec = NKSEngine.recover(str(tmp_path / "wal"))
    assert rec.device.type == "cuda" and rec.ingest.replayed_ops == 4
    assert project_bin.launches["project_and_bin"] == before + 4 * 5
    same(rec)
    for tier in ("exact", "approx", "device"):
        assert [[c.key() for c in r.candidates]
                for r in rec.query_batch(queries, k=2, tier=tier)] == \
            [[c.key() for c in r.candidates]
             for r in live.query_batch(queries, k=2, tier=tier)]


@pytest.mark.cuda
def test_kernel_launches_counted_exactly_from_four_threads():
    """K5, K1 and the fused anchor-star kernel launched from 4 host threads
    at once, 25 times each a thread: every result equals the same call's
    from one thread, and every launch counter moved by exactly the launches
    made."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    import threading
    from repro_torch.kernels import diameter, ops, project_bin
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((5000, 64), device=dev, generator=gen)
    z = torch.randn((2, 64), device=dev, generator=gen)
    xb = torch.randn((4, 300, 16), device=dev, generator=gen)
    lens = torch.tensor([300, 250, 17, 0], dtype=torch.int32, device=dev)
    radii = torch.full((4,), 4.0, device=dev)
    groups = torch.randn((3, 700, 16), device=dev, generator=gen)
    mask = torch.ones((3, 700), dtype=torch.bool, device=dev)
    calls = {
        "project_and_bin": lambda: ops.project_and_bin(x, z, 3.0, 7),
        "join_batched_masked": lambda: ops.pairwise_l2_join_batched_masked(
            xb, lens, radii),
        "anchor_star": lambda: ops.anchor_star(groups, mask)}
    want = {name: [t.clone() for t in fn()] for name, fn in calls.items()}
    torch.cuda.synchronize()
    counters = {"project_and_bin": project_bin.launches,
                "join_batched_masked": pairwise_l2.launches,
                "anchor_star": diameter.launches}
    per_call = {"project_and_bin": 1, "join_batched_masked": 1,
                "anchor_star": 2}
    before = {name: counters[name][name] for name in calls}
    start = threading.Barrier(4)
    errors = []

    def run():
        try:
            start.wait()
            for i in range(25):
                for name, fn in calls.items():
                    got = fn()
                    if i % 8 == 0:
                        for a, b in zip(got, want[name]):
                            assert torch.equal(a, b), name
        except Exception as exc:         # surfaced by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    torch.cuda.synchronize()
    assert not errors, errors
    for name in calls:
        assert counters[name][name] - before[name] \
            == 4 * 25 * per_call[name], name


@pytest.mark.cuda
def test_runtime_on_card_matches_cpu_under_threads(tmp_path):
    """A serving runtime over a card engine at n=20,000: exact and device
    queries submitted while inserts and deletes arrive and one background
    compaction runs, then both tiers again afterwards. The exact answers
    equal a ``device="cpu"`` engine's over the same ops, the device tier's
    ids and diameters too, no request fails, and the launch counters moved
    by exactly the launches of the traffic: K5 5 per insert op, per delete
    of bulk rows and per compaction, the fused anchor-star kernel 2 per
    device query."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    import time
    from repro_torch import NKSEngine, flickr_like_dataset, random_queries
    from repro_torch.data.synthetic import attach_attrs, synthetic_attrs
    from repro_torch.kernels import diameter, project_bin
    from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime
    ds = attach_attrs(flickr_like_dataset(n=20_000, d=64, u=500, t=5,
                                          seed=8), seed=1)
    more = flickr_like_dataset(n=1200, d=64, u=500, t=5, seed=9)
    more_attrs = synthetic_attrs(more.n, seed=9)
    queries = random_queries(ds, 3, 16, seed=5)
    opts = dict(compact_ratio=0.05, compact_min=1000)
    card = NKSEngine(ds, **opts)
    card.attach_wal(str(tmp_path / "wal"))
    # the same ops in the same order: its synchronous compaction lands
    # where the runtime's background one does (after the third insert; the
    # fourth waits for the swap), so exact ties resolve alike
    cpu = NKSEngine(ds, device="cpu", **opts)
    ops = []
    for lo in range(0, more.n, 300):
        ops.append({"op": "insert", "points": more.points[lo:lo + 300],
                    "keywords": [more.kw.row(i).tolist()
                                 for i in range(lo, lo + 300)],
                    "attrs": {k: v[lo:lo + 300]
                              for k, v in more_attrs.items()}})
    ops.insert(2, {"op": "delete", "ids": list(range(0, 400, 2))})
    k5 = project_bin.launches["project_and_bin"]
    star = diameter.launches["anchor_star"]
    with ServingRuntime(card, RuntimeConfig(max_batch=8)) as rt:
        during = []
        for op in ops:
            ticket = rt.submit(op)
            during += [rt.submit({"op": "query", "keywords": q, "k": 1,
                                  "tier": tier})
                       for q in queries[:4] for tier in ("exact", "device")]
            assert ticket.result(120).ok
        for op in ops:
            if op["op"] == "insert":
                cpu.insert(op["points"], op["keywords"], attrs=op["attrs"])
            else:
                cpu.delete(op["ids"])
        deadline = time.monotonic() + 120
        while rt.stats.bg_compactions < 1 or rt._compacting:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        after = {tier: [rt.submit({"op": "query", "keywords": q, "k": 1,
                                   "tier": tier}) for q in queries]
                 for tier in ("exact", "device")}
        resp = [t.result(120) for t in during] \
            + [t.result(120) for ts in after.values() for t in ts]
    torch.cuda.synchronize()
    assert all(r.ok for r in resp)
    st = rt.stats
    assert st.errors == st.dispatch_failures == st.bg_compaction_errors \
        == st.bg_compaction_faults == 0
    assert st.bg_compactions == 1 and card.corpus_generation == 1
    # 4 inserts, 1 delete with bulk rows, 1 compaction
    assert project_bin.launches["project_and_bin"] - k5 == 5 * 6
    n_device = len(during) // 2 + len(queries)
    assert diameter.launches["anchor_star"] - star == 2 * n_device
    assert cpu.corpus_generation == 1 and cpu.delta_points == 300
    want = cpu.query_batch(queries, k=1, tier="exact")
    got = [t.response for t in after["exact"]]
    assert [[c.key() for c in r.payload["candidates"]] for r in got] \
        == [[c.key() for c in r.candidates] for r in want]
    from repro_torch.core.device_plane import pack_groups
    from repro_torch.core.distributed import diameter_band
    want_dev = cpu.query_batch(queries, k=1, tier="device")
    for q, r, w in zip(queries, [t.response for t in after["device"]],
                       want_dev):
        a, b = r.payload["candidates"], w.candidates
        assert a and [c.ids for c in a] == [c.ids for c in b]
        pg = pack_groups(cpu.dataset, q)
        band = diameter_band(pg.groups, pg.mask)
        for ca, cb in zip(a, b):
            assert abs(ca.diameter - cb.diameter) <= band
    card.close()


@pytest.mark.cuda
def test_ingest_pipeline_with_model_embedder_on_card(tmp_path):
    """Documents whose payload is token ids go through a ``ModelEmbedder``
    over the dense model on the card (K7 in every self-attention, one
    document a call) and a 2-worker pipeline into a serving runtime: the
    queue drains, K7 launched once a layer a document embedded, every row
    equals its document's embedding, and embedding a document again gives
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    import dataclasses
    from repro_torch import NKSEngine
    from repro_torch.configs import get_config
    from repro_torch.data.ingest import (DONE, IngestPipeline, JobStore,
                                         ModelEmbedder)
    from repro_torch.kernels import flash_attention
    from repro_torch.models.api import model_api
    from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime
    cfg = dataclasses.replace(get_config("minicpm-2b").smoke(), d_model=256,
                              n_heads=4, n_kv_heads=4, head_dim=64)
    api = model_api(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    seq, vocab = 96, [f"tag{i:03d}" for i in range(40)]

    def embed_fn(tokens):
        with torch.inference_mode():
            ids = torch.as_tensor(tokens, device="cuda").long()
            return api.embed(params, {"tokens": ids}).float().cpu().numpy()

    emb = ModelEmbedder(embed_fn, cfg.d_model, vocab, d_raw=seq)
    rng = np.random.default_rng(0)
    docs = [{"doc_id": f"doc-{i:04d}",
             "payload": rng.integers(0, cfg.vocab_size, seq)
             .astype(np.float32).tolist(),
             "tags": sorted({vocab[v] for v in rng.integers(0, 40, 3)})}
            for i in range(72)]
    seed = [emb.extract(d) for d in docs[:24]]
    from repro_torch.core.types import make_dataset
    eng = NKSEngine(make_dataset(np.stack([r.point for r in seed]),
                                 [r.keywords for r in seed],
                                 n_keywords=len(vocab)), n_scales=3)
    store = JobStore(str(tmp_path / "jobs.jsonl"), lease_s=30.0)
    store.add(docs[24:])
    k7 = flash_attention.launches["flash_attention"]
    with ServingRuntime(eng, RuntimeConfig()) as rt:
        report = IngestPipeline(store, rt, emb, workers=2,
                                batch_docs=8).run(timeout_s=300)
    assert report["drained"] and report["docs_failed"] == 0, report
    assert flash_attention.launches["flash_attention"] - k7 \
        == cfg.n_layers * 48
    ext2doc = {i: d["doc_id"] for i, d in enumerate(docs[:24])}
    ext2doc.update(store.ext_map())
    by_id = {d["doc_id"]: d for d in docs}
    pts = np.asarray(eng.dataset.points)
    for row, ext in enumerate(np.asarray(eng._ext_of)):
        np.testing.assert_array_equal(
            pts[row], emb.extract(by_id[ext2doc[int(ext)]]).point)
    assert store.counts()[DONE] == 48
    store.close()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [17, 64, 2304])
def test_anchor_star_ranges_on_card_plane(d):
    """K6 over anchor ranges, as a plane's shards call it: a range aligned
    to 128, one off a 128 boundary, the tail, a range whose anchors are all
    masked, and 8 equal slices of R. Each range's valid rows equal the same
    rows of the whole call bit for bit, and its plain version (the same
    range) within the band; two launches a range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import diameter
    q, r = 5, 3008
    groups, mask = _star_query(q, r, d, seed=d + 7)
    mask[0, 1500:1800] = False                   # a stretch with no anchor
    whole = diameter.anchor_star(groups, mask)
    band = _query_band(groups, mask)
    per = r // 8
    ranges = [(0, 640), (1000, 1000), (r - 17, 17), (1520, 200)] \
        + [(i * per, per) for i in range(8)]
    for a0, count in ranges:
        before = diameter.launches["anchor_star"]
        got = diameter.anchor_star(groups, mask, anchor_range=(a0, count))
        torch.cuda.synchronize()
        assert diameter.launches["anchor_star"] == before + 2
        assert [t.shape[0] for t in got] == [count] * 3
        valid = mask[0, a0:a0 + count]
        assert torch.equal(got[0][:, 0].long(),
                           torch.arange(a0, a0 + count, device="cuda"))
        for g, w in zip(got, whole):
            assert torch.equal(g[valid], w[a0:a0 + count][valid])
        want = ref.anchor_star(groups, mask, anchor_range=(a0, count))
        _check_star(groups, mask, got, want, band, (a0, count))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [17, 64])
def test_anchor_star_run_split_on_card_plane(d):
    """The served q=9 query's sparsity (groups of 2,961, 23, 4, 2, 2, 1, 2
    and 1 valid points, packed first) at a shard's anchor range: few runs
    of column tiles are live, so the kernel splits the fullest run's live
    tiles into parts. Its rows equal those of one column tile a unit (no
    split) bit for bit, whole and at each of 8 ranges, and the plain
    version within the band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import diameter
    q, r = 9, 8192
    groups, mask = _star_query(q, r, d, seed=d + 11)
    mask.zero_()
    for j, n in enumerate([8150, 2961, 23, 4, 2, 2, 1, 2, 1]):
        mask[j, :n] = True
    band = _query_band(groups, mask)
    per = r // 8
    for rng in [None] + [(i * per, per) for i in range(8)]:
        got = diameter.anchor_star(groups, mask, anchor_range=rng)
        one = diameter.anchor_star(groups, mask, anchor_range=rng,
                                   tiles_per_unit=1)
        for g, w in zip(got, one):
            assert torch.equal(g, w)
        want = ref.anchor_star(groups, mask, anchor_range=rng)
        _check_star(groups, mask, got, want, band, rng)


def _plane_tile(seed: int, s: int = 16, p: int = 192, d: int = 64):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((s, p, d), generator=gen, device="cuda") * 3
    lens = torch.randint(0, p + 1, (s,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lens[3] = 0                                  # an empty subset
    lens[8:10] = 0                               # an empty slab (shard 4)
    x = torch.where(torch.arange(p, device="cuda")[None, :, None]
                    < lens[:, None, None], x, 0.0)
    r = torch.rand((s,), generator=gen, device="cuda") * 8 + 4
    el = torch.rand((s, p), generator=gen, device="cuda") < 0.6
    words = torch.from_numpy(pack_join_mask(el.cpu().numpy()).view(np.int32))
    return x.contiguous(), lens, r, words.cuda()


@pytest.mark.cuda
def test_plane_joins_match_one_device_on_card():
    """An 8-shard plane on the one card (every shard ``cuda:0``): the masks
    and counts of K1, and the counts of K2 and K2i, with and without
    eligibility words, equal the single-device calls bit for bit; each
    kernel launches once a slab (K2i's two kernels once a slab)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.core.device_plane import DevicePlane
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_serving_mesh
    plane = DevicePlane(make_serving_mesh(data=8))
    assert plane.devices == (torch.device("cuda", 0),) * 8
    x, lens, r, words = _plane_tile(3)
    for elig in (None, words):
        before = dict(pairwise_l2.launches)
        m8, c8 = plane.join_batched_masked(x, lens, r, elig)
        m1, c1 = ops.pairwise_l2_join_batched_masked(x, lens, r, elig)
        assert torch.equal(m8, m1) and torch.equal(c8, c1)
        name = "join_batched_masked" + ("" if elig is None else "_elig")
        assert pairwise_l2.launches[name] == before[name] + 9
        for dtype, name, per in (("bf16", "join_batched_prune", 1),
                                 ("int8", "join_batched_prune_int8", 2)):
            name += "" if elig is None else "_elig"
            before = pairwise_l2.launches[name]
            n8 = plane.join_batched_counts(x, lens, r * 1.5, elig,
                                           dtype=dtype)
            n1 = ops.pairwise_l2_join_batched_counts(x, lens, r * 1.5, elig,
                                                     dtype=dtype)
            assert torch.equal(n8, n1)
            assert pairwise_l2.launches[name] == before + 9 * per


@pytest.mark.cuda
def test_plane_engine_matches_one_device_on_card():
    """``NKSEngine(mesh=8 shards on cuda:0)`` against the single-device
    engine on the card over one corpus: exact (default, forced onto the
    device with the bf16 and the int8 prune tier, under a filter) and
    approx batches bit for bit, with sharded dispatches on shards 1-7;
    the device tier's ids and float64 diameters bit for bit, K6 two
    launches a shard a query."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import NKSEngine, flickr_like_dataset, random_queries
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.device_plane import DevicePlane
    from repro_torch.core.filters import where
    from repro_torch.data.synthetic import attach_attrs
    from repro_torch.kernels import diameter
    from repro_torch.launch.mesh import make_serving_mesh
    ds = attach_attrs(flickr_like_dataset(n=20_000, d=32, u=300, t=4,
                                          seed=5), seed=1)
    plane = DevicePlane(make_serving_mesh(data=8))
    one = NKSEngine(ds, device="cuda")
    eight = NKSEngine(ds, mesh=plane,
                      _indices=(one.index_e, one.index_a))
    queries = random_queries(ds, 3, 24, seed=1)

    def rows(res):
        return [[(c.ids, c.diameter) for c in r.candidates] for r in res]

    runs = [("exact", {}, None), ("approx", {}, None),
            ("exact", dict(route="device", prune_tier="on"), None),
            ("exact", dict(route="device", prune_tier="on",
                           prune_dtype="int8"), None),
            ("exact", dict(route="device"), where(("price", "<", 50.0)))]
    for tier, kw, flt in runs:
        b1 = TorchBackend(**kw) if kw else "torch"
        b8 = TorchBackend(plane=plane, **kw) if kw else "torch"
        want = one.query_batch(queries, k=2, tier=tier, backend=b1,
                               filter=flt)
        got = eight.query_batch(queries, k=2, tier=tier, backend=b8,
                                filter=flt)
        assert rows(got) == rows(want), (tier, kw, flt)
        st = eight.last_batch_stats
        if kw:
            assert st.sharded_dispatches > 0
            assert len(st.shard_dispatches) == 8
            assert all(n > 0 for n in st.shard_dispatches[1:])
            assert 0 < st.t_collective_s <= st.t_dispatch_s
    q9 = random_queries(ds, 9, 8, seed=2)
    for qs, k in ((queries, 1), (q9, 10)):
        want = one.query_batch(qs, k=k, tier="device")
        before = diameter.launches["anchor_star"]
        got = eight.query_batch(qs, k=k, tier="device")
        assert diameter.launches["anchor_star"] == before + 16 * len(qs)
        assert rows(got) == rows(want)
        st = eight.last_batch_stats
        assert st.backend == "device-plane"
        assert st.shard_dispatches == [len(qs)] * 8


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["minicpm-2b", "qwen3-32b", "codeqwen1.5-7b",
                                  "starcoder2-7b", "mamba2-2.7b",
                                  "olmoe-1b-7b", "llama4-maverick-400b-a17b",
                                  "hymba-1.5b", "llama-3.2-vision-90b",
                                  "whisper-large-v3"])
def test_lm_serving_on_card_matches_cpu(name):
    """Each family's smoke config, head dim 64 (K7 takes 64 or 128), on the
    card against the port on the CPU: the forward's logits, prefill and
    three decode steps within 2^-5 of the largest logit (K7 against its
    plain version, cuBLAS against the CPU's sums), the vision gates set to
    0.7 so that cross-attention shows. Mixture-of-experts layers on the card
    take the CPU's expert choices (a near tie may route otherwise under
    other rounding; ``tests/test_torch_lm_serve.py``). K7 launches in the
    forward and prefill of every family with attention, never in decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import audio, transformer
    from repro_torch.models import moe as tmoe
    from repro_torch.models.api import model_api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(name).smoke(), head_dim=64)
    api = model_api(cfg)
    mod = audio if cfg.family == "audio" else transformer
    cpu = api.init(torch.Generator().manual_seed(0), device="cpu")
    for block in cpu["layers"] if cfg.family == "vlm" else []:
        block["cross"]["gate_a"].fill_(0.7)
        block["cross"]["gate_m"].fill_(0.7)
    card = _to(cpu, "cuda")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=gen)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(2, cfg.vision_tokens, cfg.vision_dim,
                                       generator=gen).to(torch.bfloat16)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(2, cfg.audio_frames, cfg.d_model,
                                      generator=gen).to(torch.bfloat16)
    steps = torch.randint(0, cfg.vocab_size, (3, 2, 1), generator=gen)

    route, chosen = tmoe.route, []

    def run(params, b, replay):
        calls = iter(chosen) if replay else None

        def routed(p, x, mcfg):
            probs, w, e, aux = route(p, x, mcfg)
            if calls is None:
                chosen.append(e.cpu())
                return probs, w, e, aux
            e = next(calls).to(x.device)
            w = torch.gather(probs, -1, e)
            return probs, w / w.sum(-1, keepdim=True).clamp_min(1e-9), e, aux
        tmoe.route = routed
        try:
            with torch.inference_mode():
                full, _ = mod.forward_train(
                    params, cfg, b["tokens"],
                    extra={k: b[k] for k in ("patches", "frames")
                           if k in b} or None)
                flash.reset_launches()
                out = [api.prefill(params, b, max_seq=20)]
                k7_prefill = flash.launches["flash_attention"]
                for tok in steps:
                    out.append(api.decode(params, out[-1][1],
                                          tok.to(b["tokens"].device)))
                k7_decode = flash.launches["flash_attention"] - k7_prefill
        finally:
            tmoe.route = route
        return full, [o[0] for o in out], k7_prefill, k7_decode

    want_full, want, _, _ = run(cpu, batch, False)
    got_full, got, k7_prefill, k7_decode = run(card, _to(batch, "cuda"), True)
    for g, w, what in [(got_full, want_full, "forward")] + [
            (g, w, f"step {i}") for i, (g, w) in enumerate(zip(got, want))]:
        g, w = g.float().cpu(), w.float()
        assert bool(torch.isfinite(g).all()), what
        assert float((g - w).abs().max()) <= 2.0 ** -5 * float(
            w.abs().max()), what
    attn_layers = {"ssm": 0, "audio": cfg.enc_layers + cfg.n_layers}.get(
        cfg.family, cfg.n_layers - (cfg.n_layers // cfg.cross_attn_every
                                    if cfg.family == "vlm" else 0))
    assert k7_prefill == attn_layers and k7_decode == 0


# K7b, the attention backward: (B, S, T, H, Kv, hd, causal, window) with
# query and key tiles that have edges, grouped heads (GQA 4/2, 4/1, 40/8,
# 12/4), hd 64 and 128, windows, non-causal and S != T, one row. Then the
# persistent kernels' edges: more units than resident CTAs (several rounds
# of the walk), S and T off the 128-key unit, a window edge inside a tile
# with S != T non-causal, hd 128 in groups of 5 and of 1.
FLASH_BWD_CASES = [
    (2, 130, 130, 4, 2, 64, True, None), (1, 33, 33, 4, 1, 128, True, None),
    (2, 200, 200, 8, 8, 64, False, None), (1, 300, 300, 4, 2, 64, True, 100),
    (1, 96, 160, 4, 4, 64, False, None), (1, 160, 96, 4, 2, 64, True, None),
    (1, 1, 1, 2, 1, 64, True, None), (2, 512, 512, 12, 4, 64, True, None),
    (1, 257, 257, 40, 8, 128, True, None),
    (1, 256, 256, 4, 2, 128, False, 64),
    (4, 1024, 1024, 16, 16, 64, True, None),
    (2, 330, 330, 4, 2, 64, True, None), (1, 190, 250, 4, 1, 64, False, None),
    (1, 160, 224, 4, 2, 64, False, 40),
    (1, 300, 300, 40, 8, 128, True, 100),
    (2, 190, 190, 4, 4, 128, True, None)]


def _bwd_inputs(b, s, t, h, kv, hd, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 .to(torch.bfloat16)
                 for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd),
                               (b, s, h, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,window", FLASH_BWD_CASES)
def test_flash_attention_bwd_matches_plain_version_on_card(b, s, t, h, kv,
                                                           hd, causal,
                                                           window):
    """K7's row log-sum-exp against the plain version's (fp32, 1e-4
    absolute: both sum the same unrounded numerators, in other orders), and
    K7b against ``ref.flash_attention_bwd`` on K7's output and statistics:
    every element of dq, dk, dv within
    ``ref.flash_attention_bwd_tolerance``; a second call gives the same bits
    (no atomics); three launches counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import flash_attention as flash
    q, k, v, do = _bwd_inputs(b, s, t, h, kv, hd, b * s + t + hd + h)
    o, lse = flash.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    _, lse_plain = ref.flash_attention(q, k, v, causal=causal,
                                       window=window, return_lse=True)
    assert float((lse - lse_plain).abs().max()) <= 1e-4
    before = flash.launches["flash_attention_bwd"]
    got = flash.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                    window=window)
    again = flash.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                      window=window)
    assert flash.launches["flash_attention_bwd"] == before + 6
    want = ref.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                   window=window)
    tols = ref.flash_attention_bwd_tolerance(q, k, v, o, do, lse, want,
                                             causal=causal, window=window)
    torch.cuda.synchronize()
    for name, g, a, w, tol in zip(("dq", "dk", "dv"), got, again, want,
                                  tols):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert torch.equal(g, a), f"{name}: two calls differ"
        assert bool(torch.isfinite(g.float()).all()), name
        err = (g.float() - w.float()).abs()
        assert bool((err <= tol).all()), \
            (name, float((err / tol.clamp_min(1e-30)).max()))


@pytest.mark.cuda
def test_flash_attention_autograd_reaches_k7b_on_card():
    """Under autograd ``ops.flash_attention`` runs K7 with statistics and
    its backward runs K7b and nothing else: the gradients equal a direct
    K7b call's bit for bit. Under ``no_grad`` the forward alone runs (no
    statistics kept), as in serving."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops
    q, k, v, do = _bwd_inputs(2, 192, 192, 8, 2, 64, 11)
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    flash.reset_launches()
    out = ops.flash_attention(*leaves, causal=True, window=None)
    out.backward(do)
    assert flash.launches == {"flash_attention": 1, "flash_attention_bwd": 3,
                              "flash_unsharded": 0}
    o, lse = flash.flash_attention(q, k, v, causal=True, return_lse=True)
    want = flash.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    assert torch.equal(out.detach(), o)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    flash.reset_launches()
    with torch.no_grad():
        ops.flash_attention(*leaves, causal=True)
    assert flash.launches == {"flash_attention": 1, "flash_attention_bwd": 0,
                              "flash_unsharded": 0}


@pytest.mark.cuda
def test_flash_attention_bwd_raises_on_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import flash_attention as flash
    q, k, v, do = _bwd_inputs(1, 64, 64, 4, 2, 64, 3)
    o, lse = flash.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(TypeError):
        flash.flash_attention_bwd(q, k, v, o, do.float(), lse)
    with pytest.raises(ValueError):
        flash.flash_attention_bwd(q, k, v, o, do, lse[:, :, :32])
    with pytest.raises(ValueError):
        flash.flash_attention_bwd(q, k, v, o, do, lse.to(torch.bfloat16))
    with pytest.raises(ValueError):
        flash.flash_attention_bwd(q, k, v, o, do.transpose(1, 2), lse)
    with pytest.raises(ValueError):
        flash.flash_attention_bwd(q[..., :32].contiguous(),
                                  k[..., :32].contiguous(),
                                  v[..., :32].contiguous(),
                                  o[..., :32].contiguous(),
                                  do[..., :32].contiguous(), lse)


@pytest.mark.cuda
def test_sharded_train_step_on_card():
    """[shard] (a) at small size: MiniCPM-2B's smoke config at head dim 64
    on a (pod=2, data=2, model=2) mesh of ``cuda:0`` shards, global batch
    4: K7 once per (dp, tp) shard a layer (forward and remat) and K7b 3 x
    8 kernels a layer; the sharded attention bit for bit the whole call's;
    the loss within 2^-8, the gradient norm and each gradient leaf within
    2^-4, and each parameter's move within 3% of lr where the gradients
    surely share a sign, of the unsharded step on the card; the counted
    collectives the dry run's reckoning."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import dp_axes, make_local_mesh
    from repro_torch.launch.step import (make_train_step,
                                         sharded_value_and_grad,
                                         value_and_grad)
    from repro_torch.models import hints
    from repro_torch.models.api import master_params, model_api
    from repro_torch.models.common import attend
    from repro_torch.train.optimizer import (OptimizerConfig,
                                             init_opt_state, tree_leaves,
                                             tree_map)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("minicpm-2b").smoke(), head_dim=64)
    mesh = make_local_mesh(2, 2, pod=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((4, 128, 4, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    want = ops.flash_attention(q, k, v, causal=True)
    flash.reset_launches()
    hints.enable_hints_mesh(mesh, dp_axes(mesh), "model")
    try:
        got = attend(q, k, v, causal=True, window=None)
    finally:
        hints.disable_hints()
    assert flash.launches["flash_attention"] == 8
    assert torch.equal(got, want)

    params0 = master_params(model_api(cfg).init(
        torch.Generator(device="cuda").manual_seed(1), device="cuda"))
    ocfg = OptimizerConfig(total_steps=10, warmup_steps=2, schedule="wsd",
                           peak_lr=1e-3)
    tokens = torch.randint(0, cfg.vocab_size, (4, 65), device="cuda")
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    plain = tree_map(torch.clone, params0)
    _, _, m_plain = make_train_step(cfg, ocfg)(
        plain, init_opt_state(plain, ocfg), batch)
    sh.census.reset()
    flash.reset_launches()
    p_sh, _, m_sh = make_train_step(cfg, ocfg, mesh=mesh)(
        params0, init_opt_state(params0, ocfg), batch)
    n = cfg.n_layers
    assert flash.launches == {"flash_attention": 2 * 8 * n,
                              "flash_attention_bwd": 3 * 8 * n,
                              "flash_unsharded": 0}
    pspecs = sh.param_specs(params0, mesh)
    assert sh.census.totals() == sh.step_census(params0, pspecs, mesh)
    assert abs(float(m_sh["loss"]) - float(m_plain["loss"])) \
        <= 2.0 ** -8 * float(m_plain["loss"])
    assert abs(float(m_sh["grad_norm"]) - float(m_plain["grad_norm"])) \
        <= 2.0 ** -4 * float(m_plain["grad_norm"])
    _, _, g_plain = value_and_grad(cfg, params0, batch)
    g_sh = sh.gather_tree(sharded_value_and_grad(
        cfg, sh.shard_tree(params0, pspecs, mesh), batch, mesh)[2],
        pspecs, mesh)
    lr = float(m_plain["lr"])
    clip = min(1.0, 1.0 / float(m_plain["grad_norm"]))
    full = sh.gather_tree(p_sh, pspecs, mesh)
    for a, b, p0, ga, gb in zip(tree_leaves(full), tree_leaves(plain),
                                tree_leaves(params0), tree_leaves(g_sh),
                                tree_leaves(g_plain)):
        assert float((ga - gb).norm()) <= 2.0 ** -4 * float(gb.norm()) \
            + 1e-6
        # a first AdamW step moves an element by about lr sign(g): where
        # the gradients surely share a sign the moves agree to 3% of lr
        sure = (gb.abs() > 2 * (ga - gb).abs()) & (gb.abs() * clip > 1e-6)
        assert bool(((a - b).abs()[sure]
                     <= 0.03 * lr + 2.0 ** -21 * b.abs()[sure]).all())
        assert float((a - b).norm()) <= 0.25 * float((b - p0).norm()) + 1e-6


@pytest.mark.cuda
def test_pipeline_forward_on_card():
    """[shard] (c) at small size: four smoke MiniCPM-2B layers (head dim 64)
    as the stages of a (pod=4) mesh of ``cuda:0`` stages, 8 microbatches of
    (1, 64): outputs bit for bit the sequential application; the gradients
    through the schedule (K7b once a stage a microbatch) within 2^-4 of
    each leaf's norm plus 2^-10 of the largest of the sequential
    backward's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import master_params
    from repro_torch.models.transformer import (apply_self_layer,
                                                init_self_layer)
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.pipeline_parallel import pipeline_forward
    cfg = dataclasses.replace(get_config("minicpm-2b").smoke(), head_dim=64)
    mesh = make_local_mesh(1, 1, pod=4)
    gen = torch.Generator(device="cuda").manual_seed(2)
    layers = [master_params(init_self_layer(gen, cfg)) for _ in range(4)]
    x = torch.randn((8, 1, 64, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    pos = torch.arange(64, dtype=torch.int32, device="cuda").expand(1, 64)

    def stage(p, h):
        return apply_self_layer(p, cfg, h, pos)[0]

    def sequential():
        outs = []
        for h in x:
            for p in layers:
                h = stage(p, h)
            outs.append(h)
        return torch.stack(outs)

    leaves = tree_leaves(layers)

    def grads(fn):
        for t in leaves:
            t.requires_grad_(True)
        try:
            return torch.autograd.grad(fn().float().square().mean(), leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)

    with torch.no_grad():
        got = pipeline_forward(stage, layers, x, mesh=mesh)
        assert torch.equal(got, sequential())
    flash.reset_launches()
    g_pipe = grads(lambda: pipeline_forward(stage, layers, x, mesh=mesh))
    assert flash.launches["flash_attention"] == 32
    assert flash.launches["flash_attention_bwd"] == 3 * 32
    g_seq = grads(sequential)
    norms = [float(g.norm()) for g in g_seq]
    for a, b, nb in zip(g_pipe, g_seq, norms):
        assert float((a - b).norm()) <= 2.0 ** -4 * nb + 2.0 ** -10 * max(
            norms)
