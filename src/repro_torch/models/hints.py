"""The active mesh of a sharded run, as the model code sees it.

The port of the reference package's ``models/hints.py``. There the hints
are GSPMD sharding constraints on key activations (heads over ``model``,
batch over the data-parallel axes), and the active mesh lets the Pallas
flash kernel be wrapped in ``shard_map``. The port is single-controller:
the code that splits a tensor places each piece itself, so a placement
constraint has nothing to constrain, and :func:`hint` returns its input.
What remains is the context:

  * :func:`tp_size` drives the grouped-query expansion of
    ``models.common`` as in the reference (keys and values repeated to one
    head per query head when the kv heads do not divide the TP axis);
  * the active mesh reaches attention, which then runs once per (dp, tp)
    shard (``models.common``), and :func:`on_dp_shard` narrows it to one
    data-parallel shard while the sharded train step runs that shard's
    rows (``launch.step``).

The launch layer enables the context for mesh runs; single-device code
never does, so the model code stays mesh-free.
"""
from __future__ import annotations

import contextlib
import math

_ACTIVE: dict | None = None


def enable_hints(dp_axes: tuple[str, ...], tp_axis: str, mesh=None):
    global _ACTIVE
    sizes = dict(mesh.shape) if mesh is not None else {}
    _ACTIVE = {"dp": tuple(dp_axes), "tp": tp_axis, "sizes": sizes}


def disable_hints():
    global _ACTIVE
    _ACTIVE = None


def _axis_size(axes) -> int:
    if _ACTIVE is None or not _ACTIVE["sizes"]:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(_ACTIVE["sizes"].get(a, 1) for a in axes)


def tp_size() -> int:
    """Size of the tensor-parallel axis (1 when hints are disabled)."""
    return _axis_size(_ACTIVE["tp"]) if _ACTIVE else 1


def active() -> dict | None:
    """The active context {dp, tp, sizes, mesh, dp_shard} or None."""
    return _ACTIVE


def enable_hints_mesh(mesh, dp_axes_: tuple[str, ...], tp_axis: str):
    """:func:`enable_hints` and keep the mesh, which attention splits
    over."""
    enable_hints(dp_axes_, tp_axis, mesh)
    _ACTIVE["mesh"] = mesh


@contextlib.contextmanager
def mesh_hints(mesh, dp_axes_: tuple[str, ...], tp_axis: str):
    """:func:`enable_hints_mesh` while it is open; the caller's context
    (or none) is restored after."""
    global _ACTIVE
    saved = _ACTIVE
    enable_hints_mesh(mesh, dp_axes_, tp_axis)
    try:
        yield
    finally:
        _ACTIVE = saved


@contextlib.contextmanager
def on_dp_shard(coords: dict):
    """While it is open, the model runs the rows of the one data-parallel
    shard at ``coords`` (dp axis -> index): attention splits them over that
    shard's ``model`` devices only."""
    if _ACTIVE is None or _ACTIVE.get("mesh") is None:
        raise RuntimeError("on_dp_shard needs enable_hints_mesh first")
    _ACTIVE["dp_shard"] = dict(coords)
    try:
        yield
    finally:
        _ACTIVE.pop("dp_shard", None)


def hint(x, *dims):
    """``dims`` entries: "dp", "tp" or None. Returns ``x``: a single
    controller places every piece where it computes it, so there is no
    constraint to state."""
    del dims
    return x
