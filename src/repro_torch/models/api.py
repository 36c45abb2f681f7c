"""Model API of the port: one entry point for all ten architectures.

    api = model_api(get_config("minicpm-2b"))
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    # on the host: api.init(torch.Generator().manual_seed(0), device="cpu")
    loss, metrics = api.loss(params, batch)          # differentiable
    logits, cache = api.prefill(params, batch, max_seq=576)
    logits, cache = api.decode(params, cache, tokens)   # tokens (B, 1)
    cache = api.init_cache(batch=8, max_seq=576)
    emb = api.embed(params, batch)   # (B, d_model) -> ProMiSH points

``batch`` holds ``"tokens"`` (B, S), and ``"targets"`` (and an optional
``"mask"``) for the loss, ``"patches"`` (B, vision_tokens, vision_dim) for
the vision family, ``"frames"`` (B, audio_frames, d_model) for the audio
family. ``loss`` is differentiable, as the reference's is: under grad mode
its attention's gradient is K7b on the card (``kernels.ops``), and with
``remat`` (the default) each layer runs again in the backward. Training
takes fp32 master parameters (``core.carry.model_params_from_numpy(...,
master=True)``, or :func:`master_params`): the forward casts every matrix
to bf16 where it uses it, so the loss is the same as on the bf16 serving
parameters. ``params_specs``, ``input_specs`` and ``cache_specs`` give
shape-and-type stand-ins of the parameters, a cell's inputs and its decode
cache as tensors on the ``meta`` device (nothing allocated: the
parameters are built as fake tensors, since a generator cannot draw on
``meta``); ``count_params`` and ``active_params`` count through them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.core.backend import resolve_device
from repro_torch.models import audio as audio_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.common import ACT_DTYPE, Params
from repro_torch.utils.tree import tree_leaves, tree_map

Batch = dict[str, Any]


def _xent(logits: torch.Tensor, targets: torch.Tensor,
          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross-entropy with an fp32 log-sum-exp."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable
    embed: Callable


def _extra_of(cfg: ArchConfig, batch: Batch):
    if cfg.family == "vlm":
        return {"patches": batch["patches"]}
    if cfg.family == "audio":
        return {"frames": batch["frames"]}
    return None


def _module(cfg: ArchConfig):
    return audio_lib if cfg.family == "audio" else tf_lib


def model_api(cfg: ArchConfig) -> ModelAPI:
    mod = _module(cfg)

    def init(gen: torch.Generator, *,
             device: str | torch.device | None = None) -> Params:
        """Random parameters drawn from ``gen`` on ``device``: the card
        unless the caller asks for another, and ``gen`` must live there."""
        device = resolve_device(device)
        if resolve_device(gen.device) != device:
            raise ValueError(f"generator on {gen.device}, parameters asked "
                             f"for on {device}")
        return mod.init_params(cfg, gen)

    def loss(params: Params, batch: Batch, *, remat: bool = True):
        """(xent + aux, {"xent", "aux"}), fp32 scalars; differentiable
        under grad mode, with each layer recomputed in the backward when
        ``remat``."""
        logits, aux = mod.forward_train(params, cfg, batch["tokens"],
                                        extra=_extra_of(cfg, batch),
                                        remat=remat)
        xent = _xent(logits, batch["targets"], batch.get("mask"))
        return xent + aux, {"xent": xent, "aux": aux}

    def prefill(params: Params, batch: Batch, *, max_seq: int | None = None):
        """(last-token logits (B, padded vocab), cache at ``max_seq``)."""
        return mod.prefill(params, cfg, batch["tokens"],
                           extra=_extra_of(cfg, batch), max_seq=max_seq)

    def decode(params: Params, cache: Params, tokens: torch.Tensor):
        """One step of (B, 1) tokens: (logits, cache advanced in place)."""
        return mod.decode(params, cfg, cache, tokens)

    def init_cache(batch: int, max_seq: int, *,
                   device: str | torch.device | None = None,
                   dtype=ACT_DTYPE) -> Params:
        """An empty cache on ``device`` (the card unless asked)."""
        return mod.init_cache(cfg, batch, max_seq,
                              device=resolve_device(device), dtype=dtype)

    def embed(params: Params, batch: Batch) -> torch.Tensor:
        """Mean-pooled final hidden states -> (B, d_model) bf16, under
        ``batch["mask"]`` (B, S) when given. Sums accumulate in fp32 and
        round to bf16, as the reference's bf16 reductions do."""
        hidden, _ = mod.forward_train(params, cfg, batch["tokens"],
                                      extra=_extra_of(cfg, batch),
                                      remat=False, return_hidden=True)
        mask = batch.get("mask")
        if mask is None:
            return hidden.mean(dim=1)
        m = mask.to(hidden.dtype)[..., None]
        return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)

    return ModelAPI(cfg=cfg, init=init, loss=loss, prefill=prefill,
                    decode=decode, init_cache=init_cache, embed=embed)


def master_params(tree):
    """A copy of a parameter tree with every tensor in fp32: the master
    copy training updates (the reference's parameters are fp32
    throughout). Serving's bf16 matrices become their fp32 values."""
    return tree_map(lambda t: t.float().clone(), tree)


# ------------------------------------------------------------- input specs
META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> Batch:
    """Stand-ins for every input of (arch x cell): int32 token ids (the
    token pipeline's type), bf16 patches or frames."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        batch: Batch = {"tokens": _meta((b, s), torch.int32),
                        "targets": _meta((b, s), torch.int32)}
    elif cell.kind == "prefill":
        batch = {"tokens": _meta((b, s), torch.int32)}
    else:                                  # decode: one new token, cache of s
        batch = {"tokens": _meta((b, 1), torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = _meta((b, cfg.vision_tokens, cfg.vision_dim),
                                 ACT_DTYPE)
    if cfg.family == "audio":
        batch["frames"] = _meta((b, cfg.audio_frames, cfg.d_model),
                                ACT_DTYPE)
    return batch


def cache_specs(cfg: ArchConfig, cell: ShapeCell) -> Params:
    """Stand-ins of the decode cache at this cell (seq_len positions);
    ``pos`` stays the Python int 0."""
    return _module(cfg).init_cache(cfg, cell.global_batch, cell.seq_len,
                                   device=META)


def params_specs(cfg: ArchConfig) -> Params:
    """Stand-ins of the parameters, in the types ``init`` gives them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = _module(cfg).init_params(cfg, torch.Generator())
        shapes = iter([(tuple(t.shape), t.dtype)
                       for t in tree_leaves(params)])
    return tree_map(lambda _: _meta(*next(shapes)), params)


def count_params(cfg: ArchConfig) -> int:
    """Parameters of the architecture (the padded vocabulary included),
    counted on :func:`params_specs`."""
    return sum(math.prod(t.shape) for t in tree_leaves(params_specs(cfg)))


def active_params(cfg: ArchConfig, total: int | None = None) -> int:
    """Parameters a token uses (mixture of experts: top-k of the pool), of
    ``total`` parameters (default ``count_params(cfg)``)."""
    total = count_params(cfg) if total is None else total
    if cfg.moe is None:
        return total
    e, k, f, d = (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
                  cfg.d_model)
    n_moe_layers = cfg.n_layers // cfg.moe.every
    return total - n_moe_layers * (e - k) * 3 * d * f
