"""AdamW with WSD / cosine schedules, global-norm clipping and a choice of
optimizer-state type.

The port of the reference package's ``train/optimizer.py`` over the port's
parameter trees (dicts and lists of tensors), with the reference's
arithmetic:

  * the schedule in fp32 tensor arithmetic (Python scalars enter as fp32,
    as the reference's weakly typed scalars do; never in double
    precision);
  * the global norm of the gradients in fp32, clipping by it;
  * fp32 moment math, bias corrections in fp32, decoupled weight decay on
    the fp32 parameter, each result rounded back to its leaf's type (the
    parameter's, the moments' ``state_dtype``); ``step`` an int32 tensor.

Unlike the reference, which returns new trees, :func:`adamw_update` writes
the new values into the parameter and moment tensors in place under
``torch.no_grad()``: at MiniCPM-2B's 2.7B parameters a second copy of the
state would not fit beside the first. The values are the reference's.

``state_dtype="bfloat16"`` halves the moments' memory (8 to 4 bytes a
parameter with fp32 masters' 4 more); WSD (Warmup-Stable-Decay) is the
MiniCPM schedule: linear warmup, a flat stable phase and a short 1 - sqrt
decay tail.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    decay_frac: float = 0.1          # WSD: fraction of steps in the decay tail
    schedule: str = "cosine"         # "cosine" | "wsd"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"     # "float32" | "bfloat16"


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Schedule value at ``step`` (an int or a tensor): an fp32 scalar on
    the step's device."""
    device = step.device if isinstance(step, torch.Tensor) else None
    step = _f32(step, device)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "wsd":
        decay_steps = _f32(max(cfg.total_steps * cfg.decay_frac, 1.0),
                           device)
        decay_start = cfg.total_steps - decay_steps
        in_decay = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
        decay = 1.0 - (1.0 - cfg.min_lr_frac) * torch.sqrt(in_decay)
    else:
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
            * (1 + torch.cos(math.pi * frac))
    return cfg.peak_lr * warm * decay


def state_dtype(cfg: OptimizerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    """Zero moments ``m`` and ``v`` in ``state_dtype`` beside each
    parameter, and ``step`` 0 (int32) on the parameters' device."""
    dt = state_dtype(cfg)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of their fp32 sums of squares."""
    return torch.sqrt(sum(leaf.float().square().sum()
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_scalars(step: torch.Tensor, gnorm: torch.Tensor,
                  cfg: OptimizerConfig) -> dict:
    """The step's scalars from the current ``step`` and the gradients'
    global norm: the new step, the learning rate, the clip scale and the
    two bias corrections (fp32 tensors on ``step``'s device)."""
    step = step + 1
    return {"step": step, "lr": lr_at(cfg, step),
            "scale": torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                                 max=1.0),
            "bc1": 1.0 - torch.pow(cfg.b1, step.float()),
            "bc2": 1.0 - torch.pow(cfg.b2, step.float())}


@torch.no_grad()
def adamw_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, sc: dict, cfg: OptimizerConfig) -> None:
    """One leaf's AdamW step in place, under the scalars ``sc``
    (:func:`adamw_scalars`, on the leaf's device)."""
    g = g.float() * sc["scale"]
    m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
    v32 = v.float() * cfg.b2 + g * g * (1 - cfg.b2)
    update = (m32 / sc["bc1"]) / (torch.sqrt(v32 / sc["bc2"]) + cfg.eps)
    p32 = p.float()
    p.copy_(p32 - sc["lr"] * (update + cfg.weight_decay * p32))
    m.copy_(m32)
    v.copy_(v32)


@torch.no_grad()
def adamw_update(params, grads, opt_state: dict, cfg: OptimizerConfig):
    """One AdamW step, written into ``params`` and ``opt_state``'s moments
    and step in place. Returns (params, opt_state, {"lr", "grad_norm"}),
    the same trees."""
    gnorm = global_norm(grads)
    sc = adamw_scalars(opt_state["step"], gnorm, cfg)
    tree_map(lambda p, g, m, v: adamw_leaf(p, g, m, v, sc, cfg), params,
             grads, opt_state["m"], opt_state["v"])
    opt_state["step"].copy_(sc["step"])
    return params, opt_state, {"lr": sc["lr"], "grad_norm": gnorm}
