"""Step functions (train, prefill and decode) shared by the launchers.

The port of the reference package's ``launch/step.py``: the reference jits
these; here they are plain callables, the serving ones under
``torch.inference_mode``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import model_api
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         tree_leaves, tree_map)


def value_and_grad(cfg: ArchConfig, params, batch, *, remat: bool = True):
    """(loss, metrics, gradients) of ``api.loss`` at ``params`` by
    autograd: K7 forward and K7b backward on the card, each layer
    recomputed in the backward when ``remat``. The gradients form a tree
    like ``params`` (a parameter the loss does not reach gets zeros, as in
    the reference); ``loss`` and ``metrics`` are detached."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = model_api(cfg).loss(params, batch, remat=remat)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, flat))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_map(lambda _: next(it), params)


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig, *,
                    remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "xent", "aux", "lr", "grad_norm"})``: :func:`value_and_grad`,
    then one AdamW step written into ``params`` and ``opt_state`` in place
    (``train.optimizer.adamw_update``). The parameters should be fp32
    masters (``models.api.master_params``); ``batch`` holds tensors on
    their device."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(cfg, params, batch,
                                              remat=remat)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def make_prefill_step(cfg: ArchConfig, *, max_seq: int | None = None):
    """``prefill_step(params, batch) -> (last-token logits, cache)``, the
    cache allocated at ``max_seq`` positions (the prompt's length when
    None)."""
    api = model_api(cfg)

    def prefill_step(params, batch):
        with torch.inference_mode():
            return api.prefill(params, batch, max_seq=max_seq)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``decode_step(params, cache, tokens) -> (logits, cache)``: one token
    a row; the cache's tensors are updated in place."""
    api = model_api(cfg)

    def decode_step(params, cache, tokens):
        with torch.inference_mode():
            return api.decode(params, cache, tokens)

    return decode_step
