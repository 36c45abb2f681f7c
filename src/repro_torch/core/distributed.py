"""The anchor-star NKS device tier, on one device.

``nks_anchor_topk``: for each anchor point of the query's first keyword
group, pick the nearest point of every other keyword group (one masked
pairwise squared-distance product per keyword), and rank the resulting
candidate tuples by their diameter r(A) — ``kernels.ops.tuple_diameters``,
the hand-written kernel K6 on the card. By the triangle inequality the best
anchor-star diameter is within 2x of the true optimum (each member lies
within the worst nearest-neighbour distance of the anchor, so every pair
within twice that). The tier is an fp32 filter: its diameters carry the
absolute band of :func:`diameter_band`.

The anchors are ``groups[0]``, the first keyword *as the caller gives it*,
as in the reference package (whose docstring says "rarest" but whose code
takes the first). The port keeps that choice so that its answers are the
reference's.

Everything runs on the tensors' device. The (A, R) distance blocks are
tiled over anchors so that no block exceeds ``block_bytes``. The groups come
from ``core.device_plane`` (packed on the host, or gathered on the device
from the resident corpus).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

BIG = float(np.float32(3.4e38))
_EPS32 = float(np.finfo(np.float32).eps)

# Byte budget of one (anchors, R) fp32 distance block; the product and its
# epilogue hold two such blocks at a time.
BLOCK_BYTES = 1 << 30


def _masked_sq_dists(a: torch.Tensor, b: torch.Tensor,
                     b_mask: torch.Tensor) -> torch.Tensor:
    """(A, d) x (B, d) -> (A, B) squared L2 with invalid b masked to BIG:
    ``max((|a|^2 + |b|^2) - 2 a.b, 0)`` in fp32, in place after the sum."""
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
    sq.sub_(torch.mm(a, b.T).mul_(2.0)).clamp_min_(0.0)
    return sq.masked_fill_(~b_mask[None, :], BIG)


def nks_anchor_topk(groups: torch.Tensor, mask: torch.Tensor,
                    ids: torch.Tensor, k: int, *,
                    block_bytes: int = BLOCK_BYTES
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor-star NKS top-k on one device.

    groups (q, R, d) fp32; mask (q, R) bool; ids (q, R) int32 global ids;
    anchors are ``groups[0]``. Returns (diams (min(k, R),) ascending, +inf
    for anchors with no candidate; cand_ids (min(k, R), q)).

    Points are centred on the masked mean before the distance math: the fp32
    ``|a|^2 + |b|^2 - 2ab`` identity cancels catastrophically for large
    coordinates. Ties keep the lower anchor first (a stable sort, as the
    reference's top-k does), and +inf entries come last.

    Anchors are taken ``block_bytes // (4 R)`` at a time. Each anchor's row
    is independent of the others, so tiling changes nothing but how the
    matrix product may round (its blocking), not which rows meet which."""
    q, r, d = groups.shape
    groups = groups.float()
    center = torch.where(mask[..., None], groups, 0.0).sum(dim=(0, 1)) \
        / mask.sum().clamp_min(1)
    groups = groups - center
    anchors, anchor_mask, anchor_ids = groups[0], mask[0], ids[0]
    a = anchors.shape[0]
    chunk = max(1, block_bytes // (4 * max(r, 1)))

    tuples = torch.empty((a, q, d), dtype=torch.float32, device=groups.device)
    cand_ids = torch.empty((a, q), dtype=ids.dtype, device=ids.device)
    tuples[:, 0] = anchors
    cand_ids[:, 0] = anchor_ids
    worst_nn = torch.zeros(a, dtype=torch.float32, device=groups.device)
    for a0 in range(0, a, chunk):
        rows = slice(a0, min(a, a0 + chunk))
        for j in range(1, q):
            sq = _masked_sq_dists(anchors[rows], groups[j], mask[j])
            nn = sq.argmin(dim=1)
            nn_d = sq.gather(1, nn[:, None])[:, 0]
            del sq
            worst_nn[rows] = torch.maximum(worst_nn[rows], nn_d)
            tuples[rows, j] = groups[j][nn]
            cand_ids[rows, j] = ids[j][nn]

    diam = ops.tuple_diameters(tuples)
    valid = anchor_mask & (worst_nn < BIG)
    diam = torch.where(valid, diam, torch.inf)
    order = torch.sort(diam, stable=True).indices[:k]
    return diam[order], cand_ids[order]


def diameter_band(groups: np.ndarray, mask: np.ndarray) -> float:
    """Absolute error band of the tier's fp32 diameters on one packed query:
    ``sqrt((64 + 4d) * eps32 * max|x - c|^2)`` over its valid points x, c
    their mean (the centring :func:`nks_anchor_topk` applies), in float64.
    The same form as the torch backend's join slack."""
    pts = np.asarray(groups, np.float64)[np.asarray(mask, bool)]
    if not len(pts):
        return 0.0
    c = pts.mean(axis=0)
    norm2 = float(((pts - c) ** 2).sum(-1).max())
    return float(np.sqrt((64.0 + 4.0 * groups.shape[-1]) * _EPS32 * norm2))
