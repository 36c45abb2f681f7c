"""Fault-tolerant checkpointing in the reference package's format.

The port of the reference package's ``ckpt/checkpoint.py``, file for file:

  * **atomic**: written into ``<dir>/.tmp-<step>-*``, fsynced, then renamed
    to ``<dir>/step_%08d``, so a preempted writer never leaves a half
    checkpoint that restore would pick;
  * **verifiable**: ``manifest.json`` records each leaf's shape, dtype and
    sha256 over its raw bytes; restore verifies before any state is built;
  * ``arrays.npz`` holds one array a leaf, its key with ``/`` written as
    ``__``; **rolling**: :class:`CheckpointManager` keeps the newest k.

Leaf keys are the reference's: the path of dict keys joined by ``/``. The
port keeps a model's layers, super-blocks and their members in lists; a
list is written as the reference's stacked leaf (its entries stacked leaf
by leaf on a new leading axis, nested lists on as many), so either package
finds the other's leaves (``core.carry.stack_lists``), and it is split
back into the lists on restore (``core.carry.unstack_lists``). A bf16 leaf
is written as the reference writes it: its raw 16-bit words (numpy ``|V2``
records) with dtype ``"bfloat16"`` in the manifest; the port reads those
words back as ``torch.bfloat16``. (The reference's own loader cannot cast
them, so it cannot restore a bf16 state.)

The reference's ``shardings=`` (device-putting each leaf with a sharding, for
an elastic resume onto another mesh) has no counterpart on one card: leaves
are restored onto the device of the matching leaf of ``like``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.core.carry import stack_lists, unstack_lists
from repro_torch.utils.tree import tree_leaves, tree_map

_BF16 = "bfloat16"


def _keys(tree, key: str = ""):
    """A tree of dicts and tensors with each tensor replaced by its leaf
    key: the path of dict keys joined by ``/`` (None stays None)."""
    if isinstance(tree, dict):
        return {k: _keys(v, f"{key}/{k}" if key else str(k))
                for k, v in tree.items()}
    return None if tree is None else key


def _stacked(state) -> dict:
    """{leaf key: host tensor} of ``state`` with every list stacked on
    leading axes (:func:`core.carry.stack_lists`): the reference's
    leaves."""
    tree = stack_lists(tree_map(lambda t: t.detach().cpu(), state))
    return dict(zip(tree_leaves(_keys(tree)), tree_leaves(tree)))


def _host(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as numpy: bf16 as raw 16-bit words."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()


def leaf_digests(state) -> dict:
    """{leaf key: sha256 of its raw bytes} of a state as
    :func:`save_checkpoint` would write it (lists stacked): what the
    manifest of a checkpoint of ``state`` holds."""
    return {key: _digest(_host(t)) for key, t in _stacked(state).items()}


def save_checkpoint(directory: str, step: int, state,
                    extra: dict | None = None) -> str:
    """Atomically persist ``state`` (a tree of dicts, lists and tensors) at
    ``step``; returns the checkpoint's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=directory)
    try:
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        arrays = {}
        for key, t in _stacked(state).items():
            arr = arrays[key] = _host(t)
            manifest["leaves"][key] = {
                "shape": list(arr.shape),
                "dtype": _BF16 if t.dtype == torch.bfloat16
                else str(arr.dtype),
                "sha256": _digest(arr),
            }
        data_path = os.path.join(tmp, "arrays.npz")
        with open(data_path, "wb") as f:
            np.savez(f, **{k.replace("/", "__"): v for k, v in arrays.items()})
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def load_checkpoint(path: str, like, *, verify: bool = True):
    """Restore a checkpoint into the structure of ``like`` (its dicts and
    lists; each leaf in the type and on the device of ``like``'s). Every
    leaf's sha256 is checked against the manifest (with ``verify``) and its
    shape against ``like``'s stacked, before any state is built; the
    stacked leaves are split back into ``like``'s lists
    (:func:`core.carry.unstack_lists`). Returns (state, step, extra)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    raw = np.load(os.path.join(path, "arrays.npz"))
    shapes = stack_lists(tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), like))
    keys = _keys(shapes)
    loaded = {}
    for key, want in zip(tree_leaves(keys), tree_leaves(shapes)):
        arr = raw[key.replace("/", "__")]
        meta = manifest["leaves"][key]
        if verify:
            if _digest(arr) != meta["sha256"]:
                raise IOError(f"checksum mismatch for leaf {key} in {path}")
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"leaf {key}: ckpt shape {arr.shape} != "
                             f"model shape {tuple(want.shape)}")
        loaded[key] = _tensor(arr, meta["dtype"])
    state = tree_map(lambda t, ref: t.to(device=ref.device, dtype=ref.dtype),
                     unstack_lists(tree_map(loaded.__getitem__, keys), like),
                     like)
    return state, manifest["step"], manifest["extra"]


def find_latest(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    return os.path.join(directory, steps[-1]) if steps else None


class CheckpointManager:
    """Rolling checkpoints + preemption-safe save."""

    def __init__(self, directory: str, keep: int = 3, every: int = 100):
        self.directory = directory
        self.keep = keep
        self.every = every

    def due(self, step: int) -> bool:
        """Whether :meth:`maybe_save` saves at ``step`` unforced."""
        return step != 0 and step % self.every == 0

    def maybe_save(self, step: int, state, extra=None, force: bool = False):
        if not force and not self.due(step):
            return None
        path = save_checkpoint(self.directory, step, state, extra)
        self._gc()
        return path

    def latest(self):
        return find_latest(self.directory)

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for stale in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, stale),
                          ignore_errors=True)
