"""The anchor-star NKS device tier, on one device and on the plane.

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

:func:`sharded_nks_topk` is the same tier over a list of shard devices
(the serving plane's ``DevicePlane.nks_topk``, and
:func:`distributed_nks_topk`): every shard holds the whole centred groups
and scores its own contiguous slice of the anchors (``anchor_range``), and
:func:`replicated_topk_merge` merges the shards' top-k lists into one.
:func:`search_step_specs` gives that step's input stand-ins and specs.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ANCHOR_BLOCK_BYTES, BIG
from repro_torch.launch.mesh import Mesh, resolve_device

_EPS32 = float(np.finfo(np.float32).eps)


def centred(groups: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """fp32 groups minus the mean of their valid points (over every group):
    the centring :func:`nks_anchor_topk` applies before the distance math."""
    groups = groups.float()
    center = torch.where(mask[..., None], groups, 0.0).sum(dim=(0, 1)) \
        / mask.sum().clamp_min(1)
    return groups - center


def anchor_topk(groups: torch.Tensor, mask: torch.Tensor, ids: torch.Tensor,
                k: int, *, block_bytes: int = ANCHOR_BLOCK_BYTES,
                anchor_range: tuple[int, int] | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The search of :func:`nks_anchor_topk` on groups already
    :func:`centred`, over the anchors of ``anchor_range`` ``(a0, count)``
    (default all): (diams (min(k, count),), cand_ids (min(k, count), q)),
    ties to the lower anchor."""
    nn, worst_nn, diam = ops.anchor_star(groups, mask.contiguous(),
                                         block_bytes=block_bytes,
                                         anchor_range=anchor_range)
    a0 = 0 if anchor_range is None else int(anchor_range[0])
    valid = mask[0, a0:a0 + len(diam)] & (worst_nn < BIG)
    diam = torch.where(valid, diam, torch.inf)
    order = torch.sort(diam, stable=True).indices[:k]
    # cand_ids[i, j] = ids[j, nn[order[i], j]]
    cand_ids = ids.t().gather(0, nn[order].long())
    return diam[order], cand_ids


def nks_anchor_topk(groups: torch.Tensor, mask: torch.Tensor,
                    ids: torch.Tensor, k: int, *,
                    block_bytes: int = ANCHOR_BLOCK_BYTES,
                    anchor_range: tuple[int, int] | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor-star NKS top-k on one device.

    groups (q, R, d) fp32; mask (q, R) bool; ids (q, R) int32 global ids;
    anchors are ``groups[0]``, or its rows a0 .. a0 + count - 1 with
    ``anchor_range`` ``(a0, count)`` (a shard's slice: the other groups stay
    whole, as in the reference's sharded search). Returns (diams
    (min(k, count),) ascending, +inf for anchors with no candidate;
    cand_ids (min(k, count), q)). The ids of a +inf entry are those of its
    anchor's tuple on the CPU and unspecified on the card.

    Points are centred on the masked mean of all the groups (whatever the
    range) before the distance math: the fp32 ``|a|^2 + |b|^2 - 2ab``
    identity cancels catastrophically for large coordinates. Ties keep the
    lower anchor first (a stable sort, as the reference's top-k does), and
    +inf entries come last. ``block_bytes`` bounds the plain version's
    (anchors, R) blocks (the CPU path); the kernel has none."""
    return anchor_topk(centred(groups, mask), mask, ids, k,
                       block_bytes=block_bytes, anchor_range=anchor_range)


def replicated_topk_merge(diams: Sequence[torch.Tensor],
                          cand_ids: Sequence[torch.Tensor], k: int,
                          device: torch.device | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase C: merge the shards' top-k into the global one on ``device``
    (default the first shard's). ``diams[i]`` (k_i,) ascending and
    ``cand_ids[i]`` (k_i, q) are shard i's; the result is the k smallest
    of their concatenation in shard order by a stable ascending sort — the
    reference's ``top_k`` tie rule: the lower shard first, then the lower
    local index."""
    device = diams[0].device if device is None else device
    d_all = torch.cat([d.to(device) for d in diams])
    c_all = torch.cat([c.to(device) for c in cand_ids])
    sel = torch.sort(d_all, stable=True).indices[:k]
    return d_all[sel], c_all[sel]


def sharded_nks_topk(devices: Sequence[torch.device], groups: torch.Tensor,
                     mask: torch.Tensor, ids: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor-star NKS top-k over shard ``devices``: ``groups`` (q, R, d),
    mask and ids (q, R), R a multiple of the shard count. Phase A centres
    the groups once on the first device (over all their valid points, as
    :func:`nks_anchor_topk` does) and copies them to each other shard
    device; phase B runs K6 on shard i's anchors [i R/n, (i+1) R/n) against
    the whole groups and keeps that shard's stable top-k; phase C merges
    (:func:`replicated_topk_merge`). Returns (diams (min(k, R),) ascending,
    +inf for no candidate; cand_ids (min(k, R), q)) on the first device:
    the single-device search's finite entries, bit for bit on the card."""
    first, n = devices[0], len(devices)
    r = groups.shape[1]
    if r % n:
        raise ValueError(
            f"nks_topk needs R % n_shards == 0, got R={r} over {n} shards "
            f"(pack with a shard-aligned r_max)")
    per = r // n
    mask = mask.to(first).contiguous()
    ids = ids.to(first)
    copies = {first: (centred(groups.to(first), mask), mask, ids)}
    parts = []
    for i, dev in enumerate(devices):
        if dev not in copies:
            copies[dev] = tuple(t.to(dev) for t in copies[first])
        parts.append(anchor_topk(*copies[dev], k,
                                 anchor_range=(i * per, per)))
    return replicated_topk_merge([p[0] for p in parts],
                                 [p[1] for p in parts], k, first)


def distributed_nks_topk(plane_or_devices, groups: torch.Tensor,
                         mask: torch.Tensor, ids: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sharded anchor-star top-k (:func:`sharded_nks_topk`) over a
    ``DevicePlane``, a ``launch.mesh.Mesh`` (its ``data`` axis, as the
    reference shards R over it) or a list of shard devices. Returns (diams
    (min(k, R),), ids (min(k, R), q)) on the first device."""
    if isinstance(plane_or_devices, Mesh):
        devices = tuple(plane_or_devices.along("data"))
    else:
        devices = getattr(plane_or_devices, "devices", None)
    if devices is None:
        devices = tuple(resolve_device(d) for d in plane_or_devices)
    return sharded_nks_topk(devices, groups, mask, ids, k)


def search_step_specs(q: int, r_total: int, d: int, k: int):
    """Stand-ins (``meta`` tensors: groups (q, R, d) fp32, mask (q, R)
    bool, ids (q, R) int32) and specs of the sharded serve step: R over
    ``data``, which is how :func:`sharded_nks_topk` deals the anchors to
    its shards. ``k`` does not change the inputs' shapes."""
    del k
    meta = torch.device("meta")
    structs = (torch.empty((q, r_total, d), dtype=torch.float32,
                           device=meta),
               torch.empty((q, r_total), dtype=torch.bool, device=meta),
               torch.empty((q, r_total), dtype=torch.int32, device=meta))
    specs = ((None, "data", None), (None, "data"), (None, "data"))
    return structs, specs


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
