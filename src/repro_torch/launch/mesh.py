"""Device lists for the serving plane (``core.device_plane``).

The reference package builds a device mesh of its local devices with a
``data`` axis that serving shards over (``model`` stays 1). The port's plane
is single-controller too: one process holds a list of ``torch.device``
objects, one per shard, and launches each shard's kernel on its own device.
Only the ``data`` axis exists here.

``REPRO_MESH_OVERRIDE`` (comma-separated axis sizes, e.g. ``8,1``) sets the
shard count of :func:`make_serving_mesh` when no ``data`` is passed (its
first value), as in the reference. Shards outnumbering the cards are dealt
over them cyclically, so ``data=8`` on one card gives eight shards on
``cuda:0``: the slab split, the per-shard launches, the gather and the merge
all run, on one device.
"""
from __future__ import annotations

import os

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


def make_serving_mesh(data: int | None = None, *,
                      device: str | torch.device | None = None
                      ) -> list[torch.device]:
    """The plane's device list: ``data`` shards (default
    ``REPRO_MESH_OVERRIDE``'s first value, else one per local card, or one
    on the CPU) dealt cyclically over the local cards, or all on the CPU
    with ``device="cpu"``. With no card and no ``device`` this raises."""
    if data is None:
        override = os.environ.get("REPRO_MESH_OVERRIDE")
        if override:
            data = int(override.split(",")[0])
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * (1 if data is None else _check(data))
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to place the "
                           "plane's shards on the host")
    cards = torch.cuda.device_count()
    n = cards if data is None else _check(data)
    return [torch.device("cuda", i % cards) for i in range(n)]


def make_local_mesh(data: int = 1, *,
                    device: str | torch.device = "cpu"
                    ) -> list[torch.device]:
    """A plane of ``data`` shards all on ``device`` (the CPU by default),
    for tests."""
    return [resolve_device(device)] * _check(data)


def _check(data: int) -> int:
    if int(data) < 1:
        raise ValueError(f"a plane needs at least one shard, got {data}")
    return int(data)
