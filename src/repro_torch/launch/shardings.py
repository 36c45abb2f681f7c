"""Per-leaf partition specs for every architecture (DP / FSDP / TP / EP / SP),
and the pieces a single controller holds by them.

The port of the reference package's ``launch/shardings.py``. Strategy, as
there:

  * parameters: FSDP over ``data`` x TP over ``model``; expert tensors
    shard experts over ``model`` (EP) and d_model over ``data``;
  * batch: sharded over the data-parallel axes (``pod``, ``data``); when
    the global batch does not divide them (long_500k) the batch replicates
    and the KV cache's sequence dim shards over ``data`` instead;
  * optimizer state mirrors the parameter specs;
  * KV caches: batch over the dp axes; kv heads over ``model`` when they
    divide it, else the cache's sequence over ``model``.

A spec is a tuple with one entry a dimension: an axis name, a tuple of
names (the first one major) or None, as the reference's ``PartitionSpec``
holds them (a one-name tuple is written as the name). Rules are by the
leaf's name on its last dims; leading axes are padded with None. The
port's trees hold lists where the reference stacks layers on leading
axes, so a port leaf has fewer leading axes and the same trailing spec;
its path names the dict keys and list indices to it, and the leaf names
(``names[-1]``) and the ``moe`` / ``shared`` membership of the path are
the reference's.

:func:`shard_tree` splits every leaf into its pieces on the mesh's devices
(one copy a distinct device: shards dealt onto one card share it) and
:func:`gather_tree` joins them back, bit for bit. :data:`census` counts
the collectives of the sharded train step (``launch.step``) by kind, axes
and bytes, and :func:`step_census` reckons the same from the specs alone
(``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Iterator

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.launch.mesh import Mesh, dp_axes, dp_size

TP = "model"


def _fsdp(mesh: Mesh):
    return "data" if "data" in mesh.axis_names else None


def _rule(name: str, path_names: list[str], ndim: int, mesh: Mesh,
          moe_ep: bool = True) -> tuple:
    f = _fsdp(mesh)
    in_moe = "moe" in path_names and "shared" not in path_names
    table: dict[str, tuple[int, tuple]] = {
        "tok": (2, (TP, f)),
        "head": (2, (f, TP)),
        "wq": (3, (f, TP, None)),
        "wk": (3, (f, TP, None)),
        "wv": (3, (f, TP, None)),
        "wo": (3, (TP, None, f)),
        "bq": (2, (TP, None)),
        "bk": (2, (TP, None)),
        "bv": (2, (TP, None)),
        "qn": (1, (None,)),
        "kn": (1, (None,)),
        "w1": (2, (f, TP)),
        "w3": (2, (f, TP)),
        "w2": (2, (TP, f)),
        "b1": (1, (TP,)),
        "b2": (1, (None,)),
        "router": (2, (f, None)),
        "z_proj": (2, (f, TP)),
        "x_proj": (2, (f, TP)),
        "b_proj": (2, (f, None)),
        "c_proj": (2, (f, None)),
        "dt_proj": (2, (f, TP)),
        "conv_x": (2, (None, TP)),
        "conv_b": (2, (None, None)),
        "conv_c": (2, (None, None)),
        "conv_bias_x": (1, (TP,)),
        "conv_bias_b": (1, (None,)),
        "conv_bias_c": (1, (None,)),
        "a_log": (1, (TP,)),
        "d_skip": (1, (TP,)),
        "dt_bias": (1, (TP,)),
        "norm_w": (1, (TP,)),
        "out_proj": (2, (TP, f)),
        "vis_proj": (2, (f, TP)),
        "enc_pos": (2, (None, None)),
        "dec_pos": (2, (None, None)),
        "w": (1, (None,)),            # norm scale
        "b": (1, (None,)),            # norm bias
        "gate_a": (0, ()),
        "gate_m": (0, ()),
    }
    if in_moe and name in ("w1", "w3"):
        # EP: experts over TP; otherwise experts replicated over TP
        base = (3, (TP, f, None)) if moe_ep else (3, (None, f, None))
    elif in_moe and name == "w2":
        base = (3, (TP, None, f)) if moe_ep else (3, (None, None, f))
    elif name in table:
        base = table[name]
    else:
        raise KeyError(f"no sharding rule for param leaf "
                       f"'{'/'.join(path_names)}'")
    base_ndim, tail = base
    lead = ndim - base_ndim
    if lead < 0:
        raise ValueError(f"leaf {'/'.join(path_names)} ndim {ndim} < rule "
                         f"{base_ndim}")
    return (None,) * lead + tuple(tail)


def _entry(ax):
    """A spec entry as ``PartitionSpec`` holds it: a one-name tuple is the
    name, an empty one None."""
    if isinstance(ax, tuple):
        return None if not ax else ax[0] if len(ax) == 1 else ax
    return ax


def entry_axes(ax) -> tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    return () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)


def spec_axes(spec: tuple) -> tuple[str, ...]:
    return tuple(a for ax in spec for a in entry_axes(ax))


def _divisible(spec: tuple, shape: tuple, mesh: Mesh) -> tuple:
    """Null out the axes that do not divide their dim evenly (e.g. 36
    heads over TP=16 replicate)."""
    fixed = []
    for dim, ax in zip(shape, spec):
        size = math.prod(mesh.shape[a] for a in entry_axes(ax))
        fixed.append(_entry(ax) if ax is not None and dim % size == 0
                     else None)
    return tuple(fixed)


# ------------------------------------------------------------ tree walks
def _map(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists (None stays None);
    ``path`` holds the dict keys and list indices as strings."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return None if tree is None else fn(path, tree)


def zip_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree (specs are tuples, so only
    dicts and lists are structure) and trees of its structure."""
    if isinstance(specs, dict):
        return {k: zip_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [zip_specs(fn, v, *parts)
                for v, *parts in zip(specs, *trees)]
    return None if specs is None else fn(specs, *trees)


# ----------------------------------------------------------------- specs
def param_specs(params_shape, mesh: Mesh, *, moe_ep: bool = True):
    """A spec tree matching a parameter tree (tensors, or shape stand-ins
    from ``models.api.params_specs``)."""
    return _map(lambda path, leaf: _divisible(
        _rule(path[-1], list(path), len(leaf.shape), mesh, moe_ep=moe_ep),
        tuple(leaf.shape), mesh), params_shape)


def opt_specs(params_shape, mesh: Mesh, *, moe_ep: bool = True) -> dict:
    ps = param_specs(params_shape, mesh, moe_ep=moe_ep)
    return {"m": ps, "v": ps, "step": ()}


def batch_specs(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh) -> dict:
    """Specs for the input batch dict of (arch x cell)."""
    shard_batch = cell.global_batch % dp_size(mesh) == 0
    bspec = (_entry(dp_axes(mesh)),) if shard_batch else ()
    out: dict[str, Any] = {"tokens": bspec + (None,)}
    if cell.kind == "train":
        out["targets"] = bspec + (None,)
    if cfg.family == "vlm":
        out["patches"] = bspec + (None, None)
    if cfg.family == "audio":
        out["frames"] = bspec + (None, None)
    return out


def cache_specs_tree(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh,
                     cache_shape):
    """Specs for the decode cache tree (``models.api.cache_specs``)."""
    dp = dp_axes(mesh)
    shard_batch = cell.global_batch % dp_size(mesh) == 0
    bsp = _entry(dp) if shard_batch else None
    # the batch cannot shard (long_500k B=1): shard the cache's sequence
    ssp = None if shard_batch else "data"
    kv_tp = TP if cfg.n_kv_heads % mesh.shape[TP] == 0 else None
    # kv heads that cannot shard over TP: the cache's sequence over TP
    ssp_kv = ssp if kv_tp is not None else (TP if ssp is None else ssp)

    def rule(path, leaf):
        name = path[-1]
        if name == "pos":
            return ()
        if name in ("k", "v"):          # (..., B, S, kv, hd)
            tail = (bsp, ssp_kv, kv_tp, None)
        elif name in ("xk", "xv"):      # (..., B, T, kv, hd) cross KV
            tail = (bsp, None, kv_tp, None)
        elif name == "ssm":             # (..., B, H, P, N)
            tail = (bsp, TP, None, None)
        elif name == "cx":              # (..., B, K-1, d_in)
            tail = (bsp, None, TP)
        elif name in ("cb", "cc"):      # (..., B, K-1, G*N)
            tail = (bsp, None, None)
        else:
            raise KeyError(f"no cache rule for {'/'.join(path)}")
        shape = tuple(leaf.shape)
        lead = len(shape) - len(tail)
        return _divisible((None,) * lead + tail, shape, mesh)

    return _map(rule, cache_shape)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to its mesh (the reference's ``NamedSharding``)."""
    mesh: Mesh
    spec: tuple


def named(tree_specs, mesh: Mesh):
    """Spec tree -> :class:`NamedSharding` tree."""
    return zip_specs(lambda s: NamedSharding(mesh, s), tree_specs)


# ---------------------------------------------------------------- pieces
def block_of(spec: tuple, coords: dict, mesh: Mesh) -> tuple[int, ...]:
    """The block a mesh coordinate holds: per dim, the row-major index of
    the coordinate over that dim's axes (0 where unsharded)."""
    out = []
    for ax in spec:
        i = 0
        for a in entry_axes(ax):
            i = i * mesh.shape[a] + coords[a]
        out.append(i)
    return tuple(out)


def block_slices(spec: tuple, shape: tuple, mesh: Mesh,
                 block: tuple) -> tuple[slice, ...]:
    out = []
    for dim, ax, i in zip(shape, spec, block):
        n = math.prod(mesh.shape[a] for a in entry_axes(ax))
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {ax} ({n})")
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


def holders(spec: tuple, mesh: Mesh) -> dict[tuple, list[torch.device]]:
    """{block: the distinct devices that hold it}, blocks in row-major
    order of the mesh."""
    out: dict[tuple, list[torch.device]] = {}
    for coords in mesh.coords():
        dev = mesh.device_at(**coords)
        devs = out.setdefault(block_of(spec, coords, mesh), [])
        if dev not in devs:
            devs.append(dev)
    return dict(sorted(out.items()))


class Sharded:
    """One leaf held as pieces by its spec: ``pieces[block][device]`` is
    the block's copy on that device (one a distinct device). It answers
    ``shape``, ``dtype`` and ``device`` (the mesh's first), as a restore
    template and the loop's device sync read them; :meth:`whole` and
    :meth:`full` gather it."""

    def __init__(self, shape: tuple, dtype: torch.dtype, spec: tuple,
                 mesh: Mesh, pieces: dict):
        self.shape, self.dtype, self.spec, self.mesh = \
            torch.Size(shape), dtype, spec, mesh
        self.pieces = pieces

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, spec "
                f"{self.spec}, {len(self.pieces)} blocks)")

    @property
    def device(self) -> torch.device:
        return self.mesh.first

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def blocks(self) -> Iterator[tuple[tuple, torch.Tensor]]:
        """(block, one copy of it): every element once."""
        for block, copies in self.pieces.items():
            yield block, next(iter(copies.values()))

    def copies(self) -> Iterator[torch.Tensor]:
        for copies in self.pieces.values():
            yield from copies.values()

    def full(self, device: torch.device | None = None) -> torch.Tensor:
        """The whole tensor on ``device`` (default the mesh's first)."""
        device = self.device if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        with torch.no_grad():
            for block, piece in self.blocks():
                out[block_slices(self.spec, tuple(self.shape), self.mesh,
                                 block)] = piece.to(device)
        return out

    def whole(self, device: torch.device | None = None) -> torch.Tensor:
        """The whole tensor on ``device``: the piece itself where one block
        holds it all and ``device`` has a copy (no gather), else
        :meth:`full`."""
        device = self.device if device is None else device
        if len(self.pieces) == 1:
            copies = next(iter(self.pieces.values()))
            if device in copies:
                return copies[device]
        return self.full(device)


def shard_leaf(t: torch.Tensor, spec: tuple, mesh: Mesh) -> Sharded:
    shape = tuple(t.shape)
    pieces = {}
    with torch.no_grad():
        for block, devs in holders(spec, mesh).items():
            sl = t[block_slices(spec, shape, mesh, block)]
            pieces[block] = {d: sl.to(d, copy=True).contiguous()
                             for d in devs}
    return Sharded(shape, t.dtype, spec, mesh, pieces)


def shard_tree(tree, specs, mesh: Mesh):
    """Every leaf of ``tree`` split into its pieces by ``specs``, each on
    the devices that hold it (copies: the tree is not changed)."""
    return zip_specs(lambda s, t: shard_leaf(t, s, mesh), specs, tree)


def gather_tree(pieces, specs, mesh: Mesh,
                device: torch.device | None = None):
    """The inverse of :func:`shard_tree`: whole tensors on ``device``
    (default the mesh's first), bit for bit."""
    def join(spec, p: Sharded):
        if p.spec != spec or p.mesh is not mesh:
            raise ValueError(f"pieces held by {p.spec} on {p.mesh}, asked "
                             f"to join by {spec} on {mesh}")
        return p.full(device)
    return zip_specs(join, specs, pieces)


# ---------------------------------------------------------------- census
def gather_axes(spec: tuple, mesh: Mesh) -> tuple[str, ...]:
    """The axes a parameter is all-gathered over (its sharded axes of size
    over 1), in mesh order."""
    used = spec_axes(spec)
    return tuple(a for a in mesh.axis_names
                 if a in used and mesh.shape[a] > 1)


def reduce_axes(spec: tuple, mesh: Mesh) -> tuple[str, ...]:
    """The axes its gradient is reduce-scattered over: the data-parallel
    axes (the reduction) and its sharded axes (the scatter), those of size
    over 1, in mesh order."""
    used = set(spec_axes(spec)) | set(dp_axes(mesh))
    return tuple(a for a in mesh.axis_names
                 if a in used and mesh.shape[a] > 1)


class Census:
    """Collectives counted as they run: {kind: {axes: bytes}}, the axes
    joined by ``+``. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: dict[str, dict[str, int]] = {}

    def record(self, kind: str, axes: tuple[str, ...], nbytes: int) -> None:
        if not axes:
            return
        with self._lock:
            by = self._totals.setdefault(kind, {})
            key = "+".join(axes)
            by[key] = by.get(key, 0) + int(nbytes)

    def reset(self) -> None:
        with self._lock:
            self._totals = {}

    def totals(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {k: dict(v) for k, v in self._totals.items()}


# The sharded train step's all-gathers and reduce-scatters since the last
# reset (``launch.step``).
census = Census()


def step_census(params_shape, pspecs, mesh: Mesh,
                passes: int = 1) -> dict[str, dict[str, int]]:
    """The collectives of one sharded train step reckoned from the specs:
    each data-parallel shard all-gathers every parameter over its sharded
    axes for each of its ``passes`` (2 where a mixture-of-experts model
    counts its expert choices first, ``launch.step.balance_pass``) and
    reduce-scatters its gradient over the dp axes and those, each the
    whole leaf's bytes (fp32 masters and gradients). What :data:`census`
    counts when the step runs: a collective a leaf a dp shard, so a
    skipped, doubled or misrouted one shows; it counts what the step asks
    for, not bytes a card moved."""
    out = Census()
    n_dp = dp_size(mesh)

    def leaf(spec, t):
        nbytes = math.prod(t.shape) * 4
        out.record("all-gather", gather_axes(spec, mesh),
                   passes * n_dp * nbytes)
        out.record("reduce-scatter", reduce_axes(spec, mesh), n_dp * nbytes)

    zip_specs(leaf, pspecs, params_shape)
    return out.totals()


def device_bytes(tree_shape, specs, mesh: Mesh,
                 itemsize: int | None = None) -> int:
    """Bytes one device holds of a tree under its specs: each leaf's
    elements over the product of its spec's axis sizes, at the leaf's item
    size (or ``itemsize``)."""
    total = [0]

    def leaf(spec, t):
        if not hasattr(t, "shape"):
            return
        n = math.prod(t.shape) // math.prod(mesh.shape[a]
                                            for a in spec_axes(spec))
        total[0] += n * (itemsize or t.element_size())

    zip_specs(leaf, specs, tree_shape)
    return total[0]
