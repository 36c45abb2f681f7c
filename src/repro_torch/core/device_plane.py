"""The device plane: one list of shard devices for every serving tier, and
group packing for the anchor-star tier.

:func:`pack_groups` pads one query's per-keyword relevant groups to a
(q, R, d) block with a mask and the global ids, exactly as the reference
package's ``core/device_plane.py`` does (R rounded up to ``align``, an
optional ``r_max`` with truncation accounting and ``strict``). On the
engine's path the points need not cross the bus: :func:`pack_group_ids`
packs only the (q, R) ids and mask on the host, and :func:`gather_groups`
builds the (q, R, d) block on the device from the corpus already resident
there. A filtered query's eligibility mask restricts the groups before
packing.

:class:`DevicePlane` is the port's counterpart of the reference's mesh
plane. The reference runs one ``shard_map`` body a shard over a device
mesh in one process; the port keeps that single-controller shape with a
list of ``torch.device`` objects (``launch.mesh``), one a shard, in one
process:

  * **sharded batched join** — :meth:`DevicePlane.join_batched_masked` and
    :meth:`~DevicePlane.join_batched_counts` split a packed (S, P, d) tile
    on S into contiguous slabs, one a shard, run the same
    ``kernels.ops`` call on each slab's device (K1, K2 or K2i on the card,
    their plain versions on the CPU) and gather the masks and counts back
    in slab order on the first device (a peer copy across cards). Each
    subset's join is computed alone, so the result is the single-device
    call's, bit for bit;
  * **placement** — :func:`balance_order` deals a bin's subsets to the
    slabs in snake order of packed size, so the slabs carry level work;
  * **anchor-star tier** — :meth:`DevicePlane.nks_topk`, the search of
    ``core.distributed.sharded_nks_topk`` over the plane's shards: the
    groups are centred once on the first device and copied to every other
    shard device (phase A), each shard scores its contiguous R/n slice of
    the anchors with K6 over the whole groups (phase B, ``anchor_range``),
    and ``replicated_topk_merge`` takes the k smallest of the shards' top-k
    lists (phase C);
  * :meth:`~DevicePlane.pack_groups` and :meth:`~DevicePlane.pack_group_ids`
    round R up to a shard multiple.

Eight shards on one card (all ``cuda:0``) run every step above on one
device, one launch a slab on one stream. Copies between different cards
take the same code path (``Tensor.to``), untested until a machine with more
than one card is available. The plane holds no corpus data: tiles live in
the backend's cache, scoped to the corpus generation.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.distributed import replicated_topk_merge  # noqa: F401
from repro_torch.core.distributed import sharded_nks_topk
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, make_serving_mesh, resolve_device


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


def balance_order(lengths: np.ndarray, n_shards: int) -> np.ndarray:
    """Work-levelling shard placement: a permutation of ``range(len(lengths))``
    that deals subsets round-robin in descending size order.

    The plane assigns shard i the contiguous slab [i*S/n, (i+1)*S/n), so a
    length-sorted batch (the size-binned packer emits near-sorted bins) piles
    the big subsets onto the first shards. Dealing the descending sort
    across the n slabs in boustrophedon (snake) order — forward on even
    passes, backward on odd — pairs each shard's large draws with small
    ones, keeping slab work sums within one subset of each other (plain
    round-robin systematically favours low shard ids). The sort key is the
    *packed* work proxy (valid length; eligible counts when a filter packs
    eligible-dense), not the pruning radius: placement must stay
    radius-independent because committed tiles are reused across radii, so
    it sorts by size — the quantity that actually sets per-shard join cost.
    ``len(lengths)`` must be a shard multiple (callers pad first); returns
    ``perm`` such that ``x[perm]`` is the levelled order and
    ``out[np.argsort(perm)]`` restores dispatch order on readback.
    """
    s = len(lengths)
    assert s % n_shards == 0, (s, n_shards)
    order = np.argsort(-np.asarray(lengths, np.int64), kind="stable")
    ranks = order.reshape(-1, n_shards).copy()   # row = one dealing pass
    ranks[1::2] = ranks[1::2, ::-1]              # snake: reverse odd passes
    # shard i's contiguous slab = column i across passes
    return np.ascontiguousarray(ranks.T).reshape(-1)


class DevicePlane:
    """One list of shard devices, the serving plane of every sharded tier.

    ``devices`` (default :func:`repro_torch.launch.mesh.make_serving_mesh`)
    holds one device a shard, all CUDA or all CPU; a device may hold more
    than one shard. A :class:`~repro_torch.launch.mesh.Mesh` gives its
    devices along ``data`` (the other axes at 0), as the reference's plane
    takes its device mesh and shards over its ``data`` axis. Shard i owns the
    contiguous slab [i S/n, (i+1) S/n) of a sharded tile and the anchors
    [i R/n, (i+1) R/n) of a query's groups.
    The first device is where slabs are gathered back and where the
    backend keeps its resident corpus."""

    def __init__(self, devices: Sequence[str | torch.device] | Mesh
                 | None = None):
        if devices is None:
            devices = make_serving_mesh()
        if isinstance(devices, Mesh):
            if "data" not in devices.axis_names:
                raise ValueError(f"mesh has no 'data' axis: "
                                 f"{devices.axis_names}")
            devices = devices.along("data")
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a plane needs at least one shard device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a plane's shards are all CUDA or all CPU, got "
                             f"{[str(d) for d in self.devices]}")

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first shard's device: gathers land here."""
        return self.devices[0]

    def check_device(self, device: str | torch.device | None) -> None:
        """Raise unless ``device`` is None or names the first shard's
        device (an index-less ``"cuda"`` names the current card)."""
        if device is None:
            return
        d = torch.device(device)
        if d.type != self.device.type or resolve_device(d) != self.device:
            raise ValueError(f"device {device} is not the plane's first "
                             f"device {self.device}")

    def shard_pad(self, n: int) -> int:
        """Round ``n`` up to a multiple of the shard count (every slab holds
        the same number of subsets or anchors)."""
        s = self.n_shards
        return ((n + s - 1) // s) * s

    # ------------------------------------------------------------ sharded join
    def put_sharded(self, *arrays) -> tuple[list[torch.Tensor], ...]:
        """Split each array (a tensor or a host array) on dim 0 into the
        shards' slabs, slab i on device i (a view where it already lies
        there). A list of slabs passes through."""
        out = []
        for a in arrays:
            if isinstance(a, (list, tuple)):
                out.append(list(a))
                continue
            a = torch.as_tensor(a)
            if a.shape[0] % self.n_shards:
                raise ValueError(
                    f"sharding needs dim 0 % n_shards == 0, got "
                    f"{a.shape[0]} over {self.n_shards} shards (pad with "
                    f"zero-length subsets)")
            per = a.shape[0] // self.n_shards
            out.append([a[i * per:(i + 1) * per].to(dev)
                        for i, dev in enumerate(self.devices)])
        return tuple(out)

    def _gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([p.to(self.device) for p in parts])

    def join_batched_masked(self, x, lengths, r, elig=None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """Sharded masked batched self-join: (S, P, d) split on S, one
        ``ops.pairwise_l2_join_batched_masked`` call a slab on its device,
        no cross-shard work. Returns (mask (S, P, ceil(P/32)) int32 words,
        counts (S,) int32) on the first device, in slab order — the
        single-device call's result bit for bit, the optional packed
        eligibility words ``elig`` ((S, ceil(P/32))) sharded like the rest.
        S must be a shard multiple (pad with zero-length subsets, which give
        all-zero mask rows and zero counts). Any argument may be given as
        its slabs (:meth:`put_sharded`)."""
        xs, ls, rs = self.put_sharded(x, lengths, r)
        es = self.put_sharded(elig)[0] if elig is not None \
            else [None] * self.n_shards
        outs = [ops.pairwise_l2_join_batched_masked(xi, li, ri, ei)
                for xi, li, ri, ei in zip(xs, ls, rs, es)]
        return (self._gather([m for m, _ in outs]),
                self._gather([c for _, c in outs]))

    def join_batched_counts(self, x, lengths, r, elig=None, *,
                            dtype: str = "bf16") -> torch.Tensor:
        """Sharded coarse prune-tier counts (K2 for ``"bf16"``, K2i for
        ``"int8"``): the sharding of :meth:`join_batched_masked`, one
        ``ops.pairwise_l2_join_batched_counts`` call a slab, the (S,) int32
        counts gathered on the first device in slab order."""
        xs, ls, rs = self.put_sharded(x, lengths, r)
        es = self.put_sharded(elig)[0] if elig is not None \
            else [None] * self.n_shards
        return self._gather([
            ops.pairwise_l2_join_batched_counts(xi, li, ri, ei, dtype=dtype)
            for xi, li, ri, ei in zip(xs, ls, rs, es)])

    def shard_cells(self, lengths: np.ndarray, p_pad: int
                    ) -> tuple[list[int], list[int]]:
        """Per-shard (valid, total) join-block cell counts for one dispatch.

        ``lengths`` is the padded (S,) valid-point vector the dispatch
        shipped; shard i owns the contiguous slab [i*S/n, (i+1)*S/n). Valid
        cells are sum(len^2) over the slab, total is slab * P^2 — the
        utilisation ratio the stats report per shard."""
        n = self.n_shards
        per = len(lengths) // n
        lens = np.asarray(lengths, np.int64)
        valid = [int((lens[i * per:(i + 1) * per] ** 2).sum())
                 for i in range(n)]
        total = [per * p_pad * p_pad] * n
        return valid, total

    # -------------------------------------------------------- anchor-star tier
    def nks_topk(self, groups: torch.Tensor, mask: torch.Tensor,
                 ids: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Anchor-star NKS top-k over the plane's shards
        (:func:`repro_torch.core.distributed.sharded_nks_topk`): ``groups``
        (q, R, d), mask and ids (q, R) with R a shard multiple; shard i
        scores the anchors [i R/n, (i+1) R/n) against the whole groups.
        Returns (diams (min(k, R),), cand_ids (min(k, R), q)) on the first
        device."""
        return sharded_nks_topk(self.devices, groups, mask, ids, k)

    def _round_r(self, pg: PackedGroups) -> PackedGroups:
        r = pg.ids.shape[1]
        extra = self.shard_pad(r) - r
        if not extra:
            return pg
        return PackedGroups(
            None if pg.groups is None
            else np.pad(pg.groups, ((0, 0), (0, extra), (0, 0))),
            np.pad(pg.mask, ((0, 0), (0, extra))),
            np.pad(pg.ids, ((0, 0), (0, extra))),
            pg.truncated, pg.group_sizes)

    def pack_groups(self, dataset, query, r_max: int | None = None, *,
                    strict: bool = False,
                    eligible: np.ndarray | None = None) -> PackedGroups:
        """:func:`pack_groups` with R rounded up to a shard multiple so the
        result feeds :meth:`nks_topk` directly."""
        return self._round_r(pack_groups(dataset, query, r_max,
                                         strict=strict, eligible=eligible))

    def pack_group_ids(self, dataset, query, r_max: int | None = None, *,
                       strict: bool = False,
                       eligible: np.ndarray | None = None) -> PackedGroups:
        """:func:`pack_group_ids` with R rounded up to a shard multiple."""
        return self._round_r(pack_group_ids(dataset, query, r_max,
                                            strict=strict,
                                            eligible=eligible))


def get_plane(spec=None, *,
              device: str | torch.device | None = None) -> DevicePlane:
    """Resolve a plane spec: an existing plane, a list of shard devices, or
    None/``"auto"`` (the serving mesh from the environment,
    :func:`repro_torch.launch.mesh.make_serving_mesh`, on ``device``'s kind:
    the CPU with ``device="cpu"``)."""
    if isinstance(spec, DevicePlane):
        return spec
    if spec is None or (isinstance(spec, str) and spec == "auto"):
        return DevicePlane(make_serving_mesh(device=device))
    return DevicePlane(spec)
