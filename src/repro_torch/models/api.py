"""Model API of the port: ``init`` and ``embed``.

    api = model_api(get_config("minicpm-2b"))
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    # on the host: api.init(torch.Generator().manual_seed(0), device="cpu")
    emb = api.embed(params, {"tokens": tokens})   # (B, d_model) -> points

The reference's ``loss``, ``prefill`` and ``decode`` come with the training
and serving slices of the LM stack.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models import transformer as tf_lib
from repro_torch.models.common import Params

Batch = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable
    embed: Callable


def model_api(cfg: ArchConfig) -> ModelAPI:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family}: the port runs the "
                                  f"dense family only")

    def init(gen: torch.Generator, *,
             device: str | torch.device | None = None) -> Params:
        """Random parameters drawn from ``gen`` on ``device``: the card
        unless the caller asks for another, and ``gen`` must live there."""
        device = resolve_device(device)
        if resolve_device(gen.device) != device:
            raise ValueError(f"generator on {gen.device}, parameters asked "
                             f"for on {device}")
        return tf_lib.init_params(cfg, gen)

    def embed(params: Params, batch: Batch) -> torch.Tensor:
        """Mean-pooled final hidden states -> (B, d_model) bf16, under
        ``batch["mask"]`` (B, S) when given. Sums accumulate in fp32 and
        round to bf16, as the reference's bf16 reductions do."""
        hidden = tf_lib.forward_train(params, cfg, batch["tokens"])
        mask = batch.get("mask")
        if mask is None:
            return hidden.mean(dim=1)
        m = mask.to(hidden.dtype)[..., None]
        return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)

    return ModelAPI(cfg=cfg, init=init, embed=embed)
