"""The anchor-star NKS device tier, on one device.

``nks_anchor_topk``: for each anchor point of the query's first keyword
group, pick the nearest point of every other keyword group and rank the
resulting candidate tuples by their diameter r(A). The search itself is
``kernels.ops.anchor_star``: on the card the fused kernel K6
(``kernels/csrc/diameter.cu``), which takes the masked nearest neighbours
(lowest index among equal minima), the worst of their squared distances
and the tuple diameters in two launches, with no (anchors, R) distance
block and no (anchors, q, d) tuple tensor in memory; on the CPU its plain
version (``kernels.ref.anchor_star``: one masked distance product and an
argmin per keyword, tiled over anchors so that no block exceeds
``block_bytes``). By the triangle inequality the best anchor-star diameter
is within 2x of the true optimum (each member lies within the worst
nearest-neighbour distance of the anchor, so every pair within twice that).
The tier is an fp32 filter: its diameters carry the absolute band of
:func:`diameter_band`.

The anchors are ``groups[0]``, the first keyword *as the caller gives it*,
as in the reference package (whose docstring says "rarest" but whose code
takes the first). The port keeps that choice so that its answers are the
reference's.

Everything runs on the tensors' device. The groups come from
``core.device_plane`` (packed on the host, or gathered on the device from
the resident corpus).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ANCHOR_BLOCK_BYTES, BIG

_EPS32 = float(np.finfo(np.float32).eps)


def nks_anchor_topk(groups: torch.Tensor, mask: torch.Tensor,
                    ids: torch.Tensor, k: int, *,
                    block_bytes: int = ANCHOR_BLOCK_BYTES
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor-star NKS top-k on one device.

    groups (q, R, d) fp32; mask (q, R) bool; ids (q, R) int32 global ids;
    anchors are ``groups[0]``. Returns (diams (min(k, R),) ascending, +inf
    for anchors with no candidate; cand_ids (min(k, R), q)). The ids of a
    +inf entry are those of its anchor's tuple on the CPU and unspecified on
    the card.

    Points are centred on the masked mean before the distance math: the fp32
    ``|a|^2 + |b|^2 - 2ab`` identity cancels catastrophically for large
    coordinates. Ties keep the lower anchor first (a stable sort, as the
    reference's top-k does), and +inf entries come last. ``block_bytes``
    bounds the plain version's (anchors, R) blocks (the CPU path); the
    kernel has none."""
    groups = groups.float()
    center = torch.where(mask[..., None], groups, 0.0).sum(dim=(0, 1)) \
        / mask.sum().clamp_min(1)
    groups = groups - center
    nn, worst_nn, diam = ops.anchor_star(groups, mask.contiguous(),
                                         block_bytes=block_bytes)
    valid = mask[0] & (worst_nn < BIG)
    diam = torch.where(valid, diam, torch.inf)
    order = torch.sort(diam, stable=True).indices[:k]
    # cand_ids[i, j] = ids[j, nn[order[i], j]]
    cand_ids = ids.t().gather(0, nn[order].long())
    return diam[order], cand_ids


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
