"""Int8 error-feedback gradient compression for the slow (inter-pod) axis.

The port of the reference package's ``train/grad_compress.py``. The
data-parallel gradient reduce over the pod axis crosses links an order of
magnitude slower than those inside a pod, so it is compressed 4x: per-leaf
symmetric int8 quantisation with an **error-feedback** buffer (Seide et
al.; EF-SGD), so the quantisation error is added back the next step
instead of lost.

  * ``ef_compress`` / ``_quantize``: the error-feedback arithmetic, in fp32
    as the reference's (``torch.round`` rounds half to even, as
    ``jnp.round`` does);
  * ``compressed_psum``: the mean over the shards of ``axis``. The
    reference runs it inside ``shard_map``; the port is single-controller
    and takes every participant's tree at once. Each quantises with error
    feedback; the int8 payloads and the fp32 scales are all-gathered
    (copied to every participant's device); each participant dequantises
    and takes the mean itself, in the reference's order (the sum over the
    participants, then / P), so every participant holds the same bits.

Torch operations, as the reference's are XLA operations (no kernel). The
train step does not call it, in the reference or here: it is a library
function for runs whose pod axis is slow.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.utils.tree import tree_map


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    amax = g.abs().max()
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_compress(grads, error_buf):
    """Error-feedback quantisation of a gradient tree. Returns
    (dequantised gradients, new error buffer); ``error_buf`` is a tree like
    ``grads`` in fp32 (zeros on step 0, :func:`init_error_buf`)."""
    def leaf(g, e):
        g32 = g.float() + e
        q, scale = _quantize(g32)
        deq = q.float() * scale
        return deq.to(g.dtype), g32 - deq

    return _unzip(tree_map(leaf, grads, error_buf), grads)


def init_error_buf(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compressed_psum(grads: list, error_buf: list, mesh: Mesh,
                    axis: str = "pod") -> tuple[list, list]:
    """Int8-compressed mean of gradient trees over ``axis``:
    ``grads[p]`` and ``error_buf[p]`` are the trees of the participant at
    index p of ``axis`` (on its device, ``mesh.along(axis)[p]``). Returns
    (the reduced trees, the new error buffers), one a participant on its
    device; every reduced tree holds the same values, mean_p(q_p
    scale_p)."""
    devices = mesh.along(axis)
    if len(grads) != len(devices) or len(error_buf) != len(devices):
        raise ValueError(f"{len(grads)} gradient trees and "
                         f"{len(error_buf)} buffers for the {len(devices)} "
                         f"participants of {axis!r}")
    n = len(devices)

    def quantised(g, e):
        g32 = g.float() + e
        q, scale = _quantize(g32)
        return q, scale, g32 - q.float() * scale

    sent = [tree_map(quantised, g, e) for g, e in zip(grads, error_buf)]

    def reduced(g, *parts, dev):
        # the all-gather: every payload and scale copied to ``dev``
        q_all = torch.stack([q.to(dev) for q, _, _ in parts])
        s_all = torch.stack([s.to(dev) for _, s, _ in parts])
        deq = q_all.float() * s_all.reshape((-1,) + (1,) * (q_all.ndim - 1))
        return (deq.sum(dim=0) / n).to(g.dtype)

    red = [_map_parts(lambda g, *parts, dev=dev: reduced(g, *parts, dev=dev),
                      grads[p], sent) for p, dev in enumerate(devices)]
    err = [_map_parts(lambda _, part: part[2], grads[p], [sent[p]])
           for p in range(n)]
    return red, err


def _map_parts(fn, tree, parts_trees: list):
    """``fn(leaf, *parts)`` over ``tree`` and trees of the same structure
    whose leaves are tuples (tuples are leaves here, not lists)."""
    if isinstance(tree, dict):
        return {k: _map_parts(fn, v, [t[k] for t in parts_trees])
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_parts(fn, v, [t[i] for t in parts_trees])
                for i, v in enumerate(tree)]
    return None if tree is None else fn(tree, *parts_trees)


def _unzip(pairs, like):
    return (_map_parts(lambda _, p: p[0], like, [pairs]),
            _map_parts(lambda _, p: p[1], like, [pairs]))
