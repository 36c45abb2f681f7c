"""The plain anchor-star reference against a brute-force search, and its
pieces."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from harness.reference import (Query, alt_band, gather_query, loosest_topk,
                               reference, search, set_diameter, stars,
                               star_diameters, tightest_topk, to_tf32)


def brute(groups: list[np.ndarray], ids: list[np.ndarray], k: int):
    """Loops over every anchor and every point, float64."""
    out = []
    for a, anchor in enumerate(groups[0]):
        members = [anchor]
        star = [int(ids[0][a])]
        for g, gid in zip(groups[1:], ids[1:]):
            d2 = [float(((p - anchor) ** 2).sum()) for p in g]
            j = int(np.argmin(d2))                    # first of equal minima
            members.append(g[j])
            star.append(int(gid[j]))
        diam = max((float(np.sqrt(((x - y) ** 2).sum()))
                    for x, y in itertools.combinations(members, 2)),
                   default=0.0)
        out.append((diam, a, tuple(sorted(set(star)))))
    out.sort(key=lambda t: (t[0], t[1]))
    return [(d, s) for d, _, s in out[:k]]


def tiny_query(seed: int, q: int, sizes, d=5, integer=False):
    rng = np.random.default_rng(seed)
    n = 60
    pts = rng.integers(0, 4, (n, d)).astype(np.float32) if integer \
        else rng.uniform(-10, 10, (n, d)).astype(np.float32)
    posting = {t: np.sort(rng.choice(n, size=s, replace=False))
               for t, s in zip(range(q), sizes)}
    return pts, posting


@pytest.mark.parametrize("seed,q,sizes,k,integer", [
    (0, 2, (7, 9), 3, False),
    (1, 3, (12, 5, 8), 4, False),
    (2, 4, (9, 9, 3, 6), 2, False),
    (3, 3, (10, 10, 10), 5, True),         # integer coordinates: exact ties
    (4, 1, (6,), 3, False),
])
def test_reference_equals_brute_force(seed, q, sizes, k, integer):
    pts, posting = tiny_query(seed, q, sizes, integer=integer)
    qr = gather_query(torch.from_numpy(pts), lambda t: posting[t],
                      list(range(q)))
    got = search(qr, k)
    want = brute([pts[posting[t]].astype(np.float64) for t in range(q)],
                 [posting[t] for t in range(q)], k)
    assert got.ids == [s for _, s in want]
    assert got.diams == pytest.approx([d for d, _ in want], abs=1e-12)
    r = reference(qr, k)
    assert r.answer == got
    # the band's ends hold the reference's own diameters between them
    assert all(lo >= d - 1e-12 for lo, d in zip(r.loosest, got.diams))
    assert all(ti <= d + 1e-12 for ti, d in zip(r.tightest, got.diams))
    assert len(r.loosest) == len(r.tightest) == len(got.diams)


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_band_holds_every_star_within_it(seed):
    """On integer coordinates, where nearest points tie exactly: for each
    anchor, every star made of points within the band of the nearest has a
    diameter between the anchor's ``tightest`` and ``loosest`` readings,
    so the k least of those stars' diameters lie inside the band at each
    rank."""
    pts, posting = tiny_query(seed, 3, (12, 10, 10), d=3, integer=True)
    qr = gather_query(torch.from_numpy(pts), lambda t: posting[t], [0, 1, 2])
    k = 4
    members = stars(qr)
    diams = star_diameters(qr, members)
    tau = alt_band(qr)
    least, most, tied = [], [], False
    for anchor in qr.pts[0]:
        pools = []
        for g in qr.pts[1:]:
            sq = (g - anchor).square().sum(-1)
            pools.append(g[sq <= sq.min() + tau])
        tied |= any(len(p) > 1 for p in pools)
        ds = [float(set_diameter(torch.stack([anchor, *combo])))
              for combo in itertools.product(*pools)]
        least.append(min(ds))
        most.append(max(ds))
    assert tied
    tight = tightest_topk(qr, members, diams, k)
    loose = loosest_topk(qr, members, diams, k)
    assert all(t <= w + 1e-12 for t, w in zip(tight, sorted(least)[:k]))
    assert all(lo >= w - 1e-12 for lo, w in zip(loose, sorted(most)[:k]))


def test_empty_tag_gives_no_answer():
    pts, posting = tiny_query(5, 2, (4, 0))
    qr = gather_query(torch.from_numpy(pts), lambda t: posting[t], [0, 1])
    assert search(qr, 3).ids == [] and search(qr, 3, "tf32").ids == []


def test_blocks_change_nothing():
    pts, posting = tiny_query(6, 3, (40, 30, 20), d=7)
    qr = gather_query(torch.from_numpy(pts), lambda t: posting[t], [0, 1, 2])
    whole = stars(qr)
    tiny = stars(qr, block_bytes=64)
    assert torch.equal(whole, tiny)
    assert torch.equal(star_diameters(qr, whole),
                       star_diameters(qr, tiny, chunk=3))


def test_tf32_rounds_to_ten_mantissa_bits_nearest_even():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12,
                      -(1.0 + 3 * 2**-11), 3.0, 1.0 + 2**-10 + 2**-12],
                     dtype=torch.float32)
    want = [1.0, 1.0 + 2**-9, 1.0, -(1.0 + 2**-9), 3.0, 1.0 + 2**-10]
    assert to_tf32(x).tolist() == want
    r = to_tf32(torch.randn(1000))
    low = r.view(torch.int32) & 0x1FFF
    assert (low == 0).all()


def test_tf32_control_is_coarser_than_float64():
    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 10_000, (400, 64)).astype(np.float32)
    posting = {0: np.arange(0, 200), 1: np.arange(200, 300),
               2: np.arange(300, 400)}
    qr = gather_query(torch.from_numpy(pts), lambda t: posting[t], [0, 1, 2])
    ref, ctl = search(qr, 5), search(qr, 5, "tf32")
    gaps = [abs(a - b) / a for a, b in zip(ref.diams, ctl.diams)]
    assert max(gaps) > 1e-6


def test_set_diameter_and_scale():
    p = torch.tensor([[0.0, 0.0], [3.0, 4.0], [1.0, 1.0]], dtype=torch.float64)
    assert float(set_diameter(p)) == 5.0
    q = Query([0], [np.arange(3)], [p])
    c = p.mean(0)
    assert q.scale2 == pytest.approx(float((p - c).square().sum(-1).max()))
    zero = (torch.zeros((3, 1), dtype=torch.int64),
            torch.zeros(3, dtype=torch.float64))
    assert loosest_topk(q, *zero, 2) == [0.0, 0.0]
    assert tightest_topk(q, *zero, 2) == [0.0, 0.0]
