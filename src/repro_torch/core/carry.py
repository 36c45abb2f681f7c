"""Carry a built corpus, an index or model parameters across as plain arrays.

The serving state is the corpus and the two ProMiSH indices; the language
model's is its parameters (any of the ten architectures), and in training
its optimizer state too. These constructors rebuild that state from plain
numpy arrays — what any other implementation (or a file) can hand over — so
an engine answers, and a model embeds, generates and trains on, as the one
the arrays were read from; their inverses hand the model's state back in the
reference's stacked layout.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import resolve_device
from repro_torch.core.index import BucketSynopsis, HIStructure, PromishIndex
from repro_torch.core.types import KeywordDataset, dataset_from_csr
from repro_torch.utils.csr import CSR
from repro_torch.utils.tree import tree_map


def _csr(offsets, values) -> CSR:
    return CSR(offsets=np.ascontiguousarray(offsets, dtype=np.int64),
               values=np.ascontiguousarray(values))


def dataset_from_arrays(points: np.ndarray, kw_offsets: np.ndarray,
                        kw_values: np.ndarray,
                        n_keywords: int) -> KeywordDataset:
    """(N, d) points and the point -> keywords CSR (sorted unique rows)."""
    kw = _csr(kw_offsets, np.asarray(kw_values, dtype=np.int32))
    if kw.n_rows != len(points):
        raise ValueError(f"{len(points)} points but {kw.n_rows} keyword rows")
    return dataset_from_csr(points, kw, n_keywords)


def index_from_arrays(z: np.ndarray, p_max: float, n_scales: int,
                      exact: bool, scales: Sequence[dict]) -> PromishIndex:
    """A :class:`PromishIndex` from its arrays: the (m, d) projection
    vectors, the projection span and, per scale, ``width``, ``n_buckets``
    and the two CSRs (``table_offsets``/``table_values`` bucket -> points,
    ``khb_offsets``/``khb_values`` keyword -> buckets), and optionally
    ``synopsis``, the keyword arguments of its
    :class:`~repro_torch.core.index.BucketSynopsis` (the synopsis is carried
    with its tables: the planner's prunes read it, and a compaction rebuilds
    it only where the engine's build params ask for one)."""
    if len(scales) != n_scales:
        raise ValueError(f"{n_scales} scales but {len(scales)} given")
    structures = tuple(
        HIStructure(scale=s, width=float(sc["width"]),
                    n_buckets=int(sc["n_buckets"]),
                    table=_csr(sc["table_offsets"], sc["table_values"]),
                    khb=_csr(sc["khb_offsets"], sc["khb_values"]),
                    synopsis=BucketSynopsis(**sc["synopsis"])
                    if sc.get("synopsis") is not None else None)
        for s, sc in enumerate(scales))
    return PromishIndex(z=np.ascontiguousarray(z, dtype=np.float32),
                        w0=structures[0].width, n_scales=int(n_scales),
                        exact=bool(exact), structures=structures,
                        p_max=float(p_max))


def index_to_arrays(index: PromishIndex) -> dict:
    """The keyword arguments of :func:`index_from_arrays` for ``index``."""
    return dict(z=index.z, p_max=index.p_max, n_scales=index.n_scales,
                exact=index.exact,
                scales=[dict(width=h.width, n_buckets=h.n_buckets,
                             table_offsets=h.table.offsets,
                             table_values=h.table.values,
                             khb_offsets=h.khb.offsets,
                             khb_values=h.khb.values,
                             synopsis=None if h.synopsis is None
                             else dataclasses.asdict(h.synopsis))
                        for h in index.structures])


# Parameters held in fp32: the norms' weights and biases, and the leaves the
# reference reads in fp32 (the MoE router, the SSM's conv taps and biases in
# its one-token step, its decay, skip, dt bias and gated-norm weight, and the
# vision gates, tanh of an fp32 scalar). Every other leaf is a matrix, bias
# or position table the forward casts to bf16.
_FP32_LEAVES = ("w", "b", "qn", "kn", "router", "conv_x", "conv_b", "conv_c",
                "conv_bias_x", "conv_bias_b", "conv_bias_c", "a_log",
                "d_skip", "dt_bias", "norm_w", "gate_a", "gate_m")


def _leaf(name: str, a: np.ndarray, device: torch.device,
          master: bool = False) -> torch.Tensor:
    t = torch.tensor(np.asarray(a, dtype=np.float32))
    dtype = torch.float32 if master or name in _FP32_LEAVES \
        else torch.bfloat16
    return t.to(device=device, dtype=dtype)


def _convert(node: dict, device: torch.device, index: tuple = (),
             **kw) -> dict:
    """A parameter dict with every leaf read at ``index`` of its leading
    (stacked) axes."""
    return {k: _convert(v, device, index, **kw) if isinstance(v, dict)
            else _leaf(k, np.asarray(v)[index], device, **kw)
            for k, v in node.items()}


def _stack_len(node: dict) -> int:
    leaf = node
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return len(leaf)


def model_params_from_numpy(cfg: ArchConfig, tree: dict, *,
                            device: str | torch.device | None = None,
                            master: bool = False) -> dict:
    """The port's parameters, on ``device`` (the card unless the caller
    asks for another), from a model's parameter tree as numpy arrays in the
    layout of the reference's ``init_params``: fp32 leaves, homogeneous
    layers stacked on a leading axis, super-blocks on two. Leaves the
    forward reads in fp32 stay fp32 (:data:`_FP32_LEAVES`); every other
    leaf becomes bf16, the value the forward casts it to at every use. With
    ``master`` every leaf stays fp32: the master copy training updates,
    as the reference's parameters are fp32 throughout (the forward still
    casts each matrix to bf16 where it uses it). The stacks become lists:

      * ``layers`` (dense, state-space, hybrid, MoE with ``every == 1``):
        one dict a layer;
      * MoE super-blocks ``{"dense": (nb, every - 1, ...), "moe": (nb,
        ...)}``: one ``{"dense": [...], "moe": {...}}`` a block;
      * vision ``{"self": (nb, every - 1, ...), "cross": (nb, ...)}``: one
        ``{"self": [...], "cross": {...}}`` a block, and ``vis_proj``;
      * audio: ``enc_layers`` and ``dec_layers``, with ``enc_pos``,
        ``dec_pos`` and ``enc_norm``.

    The embedding table and, when the head is untied, ``embed.head`` are
    carried."""
    from repro_torch.models.transformer import n_blocks
    device = resolve_device(device)
    kw = dict(master=master)
    fam = cfg.family
    out = {"embed": _convert(tree["embed"], device, **kw),
           "final_norm": _convert(tree["final_norm"], device, **kw)}
    if fam == "audio":
        for name in ("enc_layers", "dec_layers"):
            stacked = tree[name]
            out[name] = [_convert(stacked, device, (i,), **kw)
                         for i in range(_stack_len(stacked))]
        want = (cfg.enc_layers, cfg.n_layers)
        got = (len(out["enc_layers"]), len(out["dec_layers"]))
        if got != want:
            raise ValueError(f"{got} stacked encoder/decoder layers, config "
                             f"has {want}")
        for name in ("enc_pos", "dec_pos"):
            out[name] = _leaf(name, tree[name], device, **kw)
        out["enc_norm"] = _convert(tree["enc_norm"], device, **kw)
        return out
    stacked = tree["layers"]
    nb = n_blocks(cfg)
    if fam == "moe" and cfg.moe.every > 1:
        inner, outer, per = "dense", "moe", cfg.moe.every - 1
    elif fam == "vlm":
        inner, outer, per = "self", "cross", cfg.cross_attn_every - 1
    else:
        inner = None
    n = _stack_len(stacked)
    if n != nb:
        raise ValueError(f"{n} stacked layers, config has {nb}")
    if inner is None:
        out["layers"] = [_convert(stacked, device, (i,), **kw)
                         for i in range(n)]
    else:
        out["layers"] = [{inner: [_convert(stacked[inner], device, (i, j),
                                           **kw)
                                  for j in range(per)],
                          outer: _convert(stacked[outer], device, (i,),
                                          **kw)}
                         for i in range(n)]
    if fam == "vlm":
        out["vis_proj"] = _leaf("vis_proj", tree["vis_proj"], device, **kw)
    return out


def stack_lists(tree):
    """A tree of tensors whose lists (the port's layers, super-blocks and
    their members) are stacked leaf by leaf on a new leading axis, nested
    lists on as many axes: the reference's stacked layout, dtypes and
    devices kept."""
    if isinstance(tree, dict):
        return {k: stack_lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _stack_trees([stack_lists(v) for v in tree])
    return tree


def _stack_trees(parts: list):
    if parts[0] is None:
        return None
    if isinstance(parts[0], dict):
        return {k: _stack_trees([p[k] for p in parts]) for k in parts[0]}
    return torch.stack(parts)


def unstack_lists(tree, like):
    """The inverse of :func:`stack_lists`: ``tree``'s stacked leaves split
    on their leading axes into the lists of ``like`` (entries are views of
    the stacked tensors)."""
    if isinstance(like, dict):
        return {k: unstack_lists(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [unstack_lists(tree_map(lambda t: t[i], tree), v)
                for i, v in enumerate(like)]
    return tree


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def model_params_to_numpy(params: dict) -> dict:
    """The inverse of :func:`model_params_from_numpy`: the reference's
    stacked parameter tree as fp32 numpy arrays (bf16 leaves widened
    exactly); the layout follows from the lists themselves."""
    return _to_numpy(stack_lists(params))


def opt_state_from_numpy(cfg: ArchConfig, state: dict, *,
                         device: str | torch.device | None = None) -> dict:
    """An AdamW state ``{"m", "v", "step"}`` (the reference's
    ``init_opt_state`` layout, numpy arrays) in the port's layout: the
    moments as parameter trees in the reference's state type (bf16 or
    fp32, read from ``m``'s leaves), ``step`` an int32 scalar tensor."""
    leaf = state["m"]["final_norm"]["w"]
    dtype = torch.bfloat16 if "bfloat16" in str(np.asarray(leaf).dtype) \
        else torch.float32
    device = resolve_device(device)

    def moments(tree):
        return tree_map(lambda t: t.to(dtype), model_params_from_numpy(
            cfg, tree, device=device, master=True))
    return {"m": moments(state["m"]), "v": moments(state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def opt_state_to_numpy(state: dict) -> dict:
    """The inverse of :func:`opt_state_from_numpy`: the moments as the
    reference's stacked fp32 numpy trees, ``step`` an int32 numpy
    scalar."""
    return {"m": model_params_to_numpy(state["m"]),
            "v": model_params_to_numpy(state["v"]),
            "step": np.asarray(int(state["step"]), dtype=np.int32)}
