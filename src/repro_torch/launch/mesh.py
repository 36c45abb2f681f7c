"""Device meshes: named axes over a grid of ``torch.device`` objects.

The reference package builds device meshes with named axes:

  * ``pod``   — the inter-pod axis: pure data parallelism (optionally with
                a compressed gradient reduce) or pipeline stages;
  * ``data``  — the intra-pod data-parallel / FSDP axis (batch rows and
                parameter and optimizer shards);
  * ``model`` — the tensor- and expert-parallel axis (heads, FFN hidden,
                vocabulary, experts, SSM heads).

The port is single-controller: one process holds a :class:`Mesh`, places
each shard's piece on its shard's device and runs each shard's work there,
and does the collectives as explicit tensor operations between the pieces
(``launch.shardings``, ``launch.step``). The serving plane
(``core.device_plane``) shards over ``data`` only.

Shards outnumbering the cards are dealt over them cyclically, so a
``(pod=2, data=2, model=2)`` mesh on one card is eight shards on
``cuda:0``: every split, per-shard launch and gather runs, on one device.
``REPRO_MESH_OVERRIDE`` (comma-separated axis sizes, e.g. ``2,2,2``) is
read by :func:`make_production_mesh` (the full shape) and by
:func:`make_serving_mesh` when no ``data`` is passed (its first value), as
in the reference; :func:`make_local_mesh` uses its arguments only.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Iterator, Sequence

import numpy as np
import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. With no CUDA device and no explicit choice this raises —
    there is no silent host path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain PyTorch versions on the host")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class Mesh:
    """Named axes over a grid of devices, in row-major order: the port's
    counterpart of the reference's device mesh. ``shape`` maps each axis
    name to its size, in axis order; a coordinate is a mapping of axis
    names to indices (axes left out are at 0)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[torch.device]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"mesh shape {shape} against axes {axis_names}")
        if min(shape, default=1) < 1 or len(devices) != math.prod(shape):
            raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                             f"devices, got {len(devices)}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        grid = np.empty(len(devices), dtype=object)
        grid[:] = list(devices)
        self.devices = grid.reshape(shape)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices "
                f"{sorted({str(d) for d in self.devices.flat})})")

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def first(self) -> torch.device:
        """The device at every axis's index 0: where gathers land."""
        return self.devices.flat[0]

    def _index(self, coords: dict) -> tuple:
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise KeyError(f"mesh has no axis {sorted(unknown)}: "
                           f"{self.axis_names}")
        return tuple(int(coords.get(a, 0)) for a in self.axis_names)

    def device_at(self, **coords) -> torch.device:
        return self.devices[self._index(coords)]

    def along(self, axis: str, **coords) -> list[torch.device]:
        """The devices along ``axis``, the other axes at ``coords``."""
        return [self.device_at(**{**coords, axis: i})
                for i in range(self.shape[axis])]

    def coords(self, axes: Sequence[str] | None = None) -> Iterator[dict]:
        """Every coordinate over ``axes`` (default all), row-major."""
        axes = self.axis_names if axes is None else tuple(axes)
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            yield dict(zip(axes, idx))


def _deal(n: int, device: str | torch.device | None) -> list[torch.device]:
    """``n`` shard devices: all on the CPU with ``device="cpu"``, else
    dealt cyclically over the local cards. With no card and no ``device``
    this raises."""
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to place the "
                           "mesh's shards on the host")
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def _mesh(shape: Sequence[int], axes: Sequence[str],
          device: str | torch.device | None) -> Mesh:
    return Mesh(shape, axes, _deal(math.prod(shape), device))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None) -> Mesh:
    """(16, 16) over ``("data", "model")``, or (2, 16, 16) over ``("pod",
    "data", "model")`` with ``multi_pod``; ``REPRO_MESH_OVERRIDE`` gives
    the sizes instead, as in the reference (three values, or ``multi_pod``,
    name the trailing axes of ``("pod", "data", "model")``). Its 256 or 512
    shards are dealt over the local cards (or all on the CPU with
    ``device="cpu"``)."""
    override = os.environ.get("REPRO_MESH_OVERRIDE")
    if override:
        shape = tuple(int(x) for x in override.split(","))
        axes = ("pod", "data", "model")[-len(shape):] if multi_pod or \
            len(shape) == 3 else ("data", "model")
        if len(axes) != len(shape):
            raise ValueError(f"REPRO_MESH_OVERRIDE={override!r} does not "
                             f"name the axes {axes}")
        return _mesh(shape, axes, device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_serving_mesh(data: int | None = None, *,
                      device: str | torch.device | None = None
                      ) -> list[torch.device]:
    """The serving plane's device list: ``data`` shards (default
    ``REPRO_MESH_OVERRIDE``'s first value, else one per local card, or one
    on the CPU) dealt cyclically over the local cards, or all on the CPU
    with ``device="cpu"``. With no card and no ``device`` this raises."""
    if data is None:
        override = os.environ.get("REPRO_MESH_OVERRIDE")
        if override:
            data = int(override.split(",")[0])
    if data is None:
        if device is not None and torch.device(device).type == "cpu":
            return [torch.device("cpu")]
        data = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return _deal(_check(data), device)


def make_local_mesh(data: int = 1, model: int = 1, pod: int | None = None,
                    *, device: str | torch.device | None = None) -> Mesh:
    """A small ``(data, model)`` mesh, or ``(pod, data, model)`` with
    ``pod``, for tests: on the card (shards dealt over the local cards)
    unless ``device="cpu"`` is passed; with no card and no ``device`` it
    raises."""
    if pod is not None:
        return _mesh((_check(pod), _check(data), _check(model)),
                     ("pod", "data", "model"), device)
    return _mesh((_check(data), _check(model)), ("data", "model"), device)


def dp_axes(mesh: Mesh) -> tuple[str, ...]:
    """The batch (data-parallel) axes of a mesh, ``pod`` included when
    present."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def _check(n: int) -> int:
    if int(n) < 1:
        raise ValueError(f"a mesh axis needs at least one shard, got {n}")
    return int(n)
