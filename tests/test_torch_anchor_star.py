"""The anchor-star search (``kernels.ops.anchor_star``, K6's fused entry)
through its plain version on the CPU.

Same seeded numpy inputs through the reference package's
``core.distributed.nks_anchor_topk`` and the port's, with k = R so that every
anchor's candidate is compared (keyed by its anchor: the order of diameters
closer than the band is rounding noise): ids equal, diameters within
``rtol 1e-5`` plus the fp32 band of
:func:`repro_torch.core.distributed.diameter_band` (the two packages sum the same fp32 products in different orders, and a
diameter may be 0). Exact ties are built from small integer coordinates, on
which every fp32 sum and product is exact in any order: there the nearest
point must be the lowest index among equal minima, as in a float64 argmin.
The CPU path must give bit for bit what the composition it was moved from
gave (transcribed here as ``_composition``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distributed import nks_anchor_topk as ref_nks_anchor_topk
from repro_torch.core.distributed import diameter_band, nks_anchor_topk
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

BIG = float(np.float32(3.4e38))


def _query(q: int, r: int, d: int, seed: int):
    """(groups, mask, ids) of one packed query: valid points first in each
    group (as the packing lays them out), one group of a few points, some
    anchors invalid, with R not a multiple of 128."""
    rng = np.random.default_rng(seed)
    groups = (rng.standard_normal((q, r, d)) * 20
              + rng.uniform(-50, 50, (1, 1, d))).astype(np.float32)
    sizes = rng.integers(r // 3, r + 1, size=q)
    sizes[-1] = min(sizes[-1], 5)
    mask = np.arange(r)[None, :] < sizes[:, None]
    mask[0, rng.random(r) < 0.2] = False              # holes among the anchors
    groups[~mask] = 0.0
    ids = rng.permutation(q * r).reshape(q, r).astype(np.int32)
    return groups, mask, ids


def _compare(q, groups, mask, ids):
    r = groups.shape[1]
    want_d, want_c = ref_nks_anchor_topk(jnp.asarray(groups),
                                         jnp.asarray(mask),
                                         jnp.asarray(ids), r)
    got_d, got_c = nks_anchor_topk(torch.from_numpy(groups),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(ids), r)
    want_d, want_c = np.asarray(want_d), np.asarray(want_c)
    got_d, got_c = got_d.numpy(), got_c.numpy()
    assert got_c.shape == (r, q) and got_c.dtype == np.int32
    assert got_d.shape == (r,) and got_d.dtype == np.float32
    assert (np.diff(got_d[np.isfinite(got_d)]) >= 0).all()
    # Each anchor's candidate (keyed by its anchor's id: the ranking of
    # diameters closer than the band is rounding noise, e.g. all of q = 1).
    g_order, w_order = np.argsort(got_c[:, 0]), np.argsort(want_c[:, 0])
    np.testing.assert_array_equal(got_c[g_order], want_c[w_order])
    got_d, want_d = got_d[g_order], want_d[w_order]
    fin = np.isfinite(want_d)
    np.testing.assert_array_equal(np.isfinite(got_d), fin)
    band = diameter_band(groups, mask)
    assert (np.abs(got_d[fin] - want_d[fin])
            <= 1e-5 * np.abs(want_d[fin]) + band).all()
    return fin


@pytest.mark.parametrize("d", [3, 16, 64])
@pytest.mark.parametrize("q", range(1, 10))
def test_anchor_star_matches_reference(q, d):
    groups, mask, ids = _query(q, 150, d, seed=q * 100 + d)
    fin = _compare(q, groups, mask, ids)
    assert fin.sum() == mask[0].sum()                 # every valid anchor
    if q > 1:
        # a group with no valid point: no candidate at all, in both
        mask[max(1, q // 2)] = False
        assert not _compare(q, groups, mask, ids).any()


def _lowest_argmin(anchors: np.ndarray, pts: np.ndarray,
                   valid: np.ndarray) -> np.ndarray:
    """Exact nearest valid point of each anchor on integer coordinates, the
    lowest index among equal minima (numpy's argmin takes the first)."""
    a, p = anchors.astype(np.int64), pts.astype(np.int64)
    sq = ((a[:, None] - p[None]) ** 2).sum(-1)
    sq = np.where(valid[None, :], sq, np.iinfo(np.int64).max)
    return sq.argmin(axis=1)


@pytest.mark.parametrize("d", [3, 16])
def test_anchor_star_exact_ties_resolve_to_lowest_index(d):
    """Small integer points with many equal distances: duplicates of other
    points, copies of the anchors (distance exactly 0 after the clamp), and
    masked copies at lower indices, which must not win."""
    rng = np.random.default_rng(d)
    q, r = 4, 200
    groups = rng.integers(-3, 4, size=(q, r, d)).astype(np.float32)
    for j in range(1, q):
        groups[j, 100:150] = groups[j, 20:70]          # duplicates, later
        groups[j, 150:170] = groups[0, 0:20]           # copies of anchors
        groups[j, 10:20] = groups[0, 0:10]             # ... and lower ones
    mask = np.ones((q, r), bool)
    mask[1:, 10:15] = False                            # lower copies masked
    mask[0, 190:] = False
    nn, worst, diam = ops.anchor_star(torch.from_numpy(groups),
                                      torch.from_numpy(mask))
    nn = nn.numpy()
    assert nn.dtype == np.int32 and nn.shape == (r, q)
    np.testing.assert_array_equal(nn[:, 0], np.arange(r))
    sq_worst = np.zeros(r)
    for j in range(1, q):
        want = _lowest_argmin(groups[0], groups[j], mask[j])
        np.testing.assert_array_equal(nn[:, j], want)
        sq_j = ((groups[0].astype(np.float64) - groups[j][want]) ** 2).sum(-1)
        sq_worst = np.maximum(sq_worst, sq_j)
    if d == 16:          # no random point repeats an anchor (7^16 cells)
        assert (nn[0:5, 1:] == np.arange(150, 155)[:, None]).all()
        assert (nn[5:10, 1:] == np.arange(15, 20)[:, None]).all()
    np.testing.assert_array_equal(worst.numpy(), sq_worst.astype(np.float32))
    tuples = np.stack([groups[j][nn[:, j]] for j in range(q)], 1)
    np.testing.assert_array_equal(
        diam.numpy(), ref.tuple_diameters(torch.from_numpy(tuples)).numpy())


def _composition(groups, mask, ids, k, block_bytes=1 << 30):
    """The device tier's composition before the plain version moved into
    ``kernels.ref.anchor_star``, as it stood in ``core/distributed.py``."""
    q, r, d = groups.shape
    groups = groups.float()
    center = torch.where(mask[..., None], groups, 0.0).sum(dim=(0, 1)) \
        / mask.sum().clamp_min(1)
    groups = groups - center
    anchors, anchor_mask, anchor_ids = groups[0], mask[0], ids[0]
    a = anchors.shape[0]
    chunk = max(1, block_bytes // (4 * max(r, 1)))
    tuples = torch.empty((a, q, d), dtype=torch.float32)
    cand_ids = torch.empty((a, q), dtype=ids.dtype)
    tuples[:, 0] = anchors
    cand_ids[:, 0] = anchor_ids
    worst_nn = torch.zeros(a, dtype=torch.float32)
    for a0 in range(0, a, chunk):
        rows = slice(a0, min(a, a0 + chunk))
        for j in range(1, q):
            b, b_mask = groups[j], mask[j]
            sq = (anchors[rows] * anchors[rows]).sum(1)[:, None] \
                + (b * b).sum(1)[None, :]
            sq.sub_(torch.mm(anchors[rows], b.T).mul_(2.0)).clamp_min_(0.0)
            sq = sq.masked_fill_(~b_mask[None, :], BIG)
            nn = sq.argmin(dim=1)
            nn_d = sq.gather(1, nn[:, None])[:, 0]
            worst_nn[rows] = torch.maximum(worst_nn[rows], nn_d)
            tuples[rows, j] = groups[j][nn]
            cand_ids[rows, j] = ids[j][nn]
    diam = ref.tuple_diameters(tuples)
    valid = anchor_mask & (worst_nn < BIG)
    diam = torch.where(valid, diam, torch.inf)
    order = torch.sort(diam, stable=True).indices[:k]
    return diam[order], cand_ids[order]


@pytest.mark.parametrize("q", [1, 3, 9])
def test_cpu_path_bit_for_bit_as_before(q):
    for d, r, seed in ((5, 37, 0), (64, 300, 1)):
        args = [torch.from_numpy(a) for a in _query(q, r, d, seed + q)]
        for k, block_bytes in ((1, 1 << 30), (7, 1 << 30), (r, 4 * r * 13)):
            got = nks_anchor_topk(*args, k, block_bytes=block_bytes)
            want = _composition(*args, k, block_bytes)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)
