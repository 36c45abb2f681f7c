"""Group packing for the anchor-star device tier.

:func:`pack_groups` pads one query's per-keyword relevant groups to a
(q, R, d) block with a mask and the global ids, exactly as the reference
package's ``core/device_plane.py`` does (R rounded up to ``align``, an
optional ``r_max`` with truncation accounting and ``strict``).

On the engine's path the points need not cross the bus: :func:`pack_group_ids`
packs only the (q, R) ids and mask on the host, and :func:`gather_groups`
builds the (q, R, d) block on the device from the corpus already resident
there. ``pack_groups`` is the two together on the host, kept for the tests.
A filtered query's eligibility mask restricts the groups before packing. The
multi-device plane, its top-k merge and shard placement come with later
slices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PackedGroups:
    """Padded (q, R, d) group tensor + mask + ids for one query.

    Iterates as the classic ``(groups, mask, ids)`` triple; ``truncated``
    counts relevant points dropped because a keyword group exceeded ``r_max``
    (0 when every group fit), and ``group_sizes`` records the pre-truncation
    group sizes. ``groups`` is None when only the ids were packed
    (:func:`pack_group_ids`)."""

    groups: np.ndarray | None   # (q, R, d) float32
    mask: np.ndarray            # (q, R) bool
    ids: np.ndarray             # (q, R) int32
    truncated: int
    group_sizes: list[int]

    def __iter__(self):
        return iter((self.groups, self.mask, self.ids))


def pack_group_ids(dataset, query, r_max: int | None = None, *,
                   strict: bool = False, align: int = 128,
                   eligible: np.ndarray | None = None) -> PackedGroups:
    """Host packing of the per-keyword relevant ids, without the points.

    R defaults to the largest group size rounded up to ``align``. A group
    larger than an explicit ``r_max`` is truncated to its first ``r_max``
    points — counted in ``PackedGroups.truncated`` and fatal under
    ``strict=True``. Slot ``[j, i]`` holds the i-th point of keyword
    ``query[j]``'s group; padding slots are masked off with id 0.
    ``eligible`` (a filtered query's (N,) point mask) restricts each group
    before packing, so the anchor-star tier never ships an ineligible
    point."""
    groups = [dataset.points_with(v) for v in query]
    if eligible is not None:
        groups = [g[eligible[g]] for g in groups]
    sizes = [len(g) for g in groups]
    if r_max is None:
        r_max = max(align, int(np.ceil(max(max(sizes), 1) / align)) * align)
    truncated = sum(max(s - r_max, 0) for s in sizes)
    if strict and truncated:
        raise ValueError(
            f"pack_groups: {truncated} relevant points truncated beyond "
            f"r_max={r_max} (group sizes {sizes}); raise r_max or drop strict")
    q = len(query)
    mask = np.zeros((q, r_max), bool)
    ids = np.zeros((q, r_max), np.int32)
    for j, g in enumerate(groups):
        g = g[:r_max]
        mask[j, :len(g)] = True
        ids[j, :len(g)] = g
    return PackedGroups(None, mask, ids, truncated, sizes)


def pack_groups(dataset, query, r_max: int | None = None, *,
                strict: bool = False, align: int = 128,
                eligible: np.ndarray | None = None) -> PackedGroups:
    """Host packing of per-keyword relevant groups (see
    :func:`pack_group_ids`): the ids' points at their slots, zeros in the
    padding."""
    pg = pack_group_ids(dataset, query, r_max, strict=strict, align=align,
                        eligible=eligible)
    out = np.zeros((*pg.ids.shape, dataset.dim), np.float32)
    out[pg.mask] = dataset.points[pg.ids[pg.mask]]
    return dataclasses.replace(pg, groups=out)


def gather_groups(points: torch.Tensor, mask: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """(q, R, d) groups gathered on ``points``' device from the resident
    (N, d) corpus: row ``ids[j, i]`` where ``mask[j, i]``, zeros elsewhere —
    the block :func:`pack_groups` builds on the host."""
    out = points.index_select(0, ids.reshape(-1).long()) \
        .view(*ids.shape, points.shape[1])
    return out.masked_fill_(~mask[..., None], 0.0)
