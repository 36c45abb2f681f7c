"""Dense decoder-only transformer: parameters and the hidden-state forward.

The port of the reference package's ``models/transformer.py`` for the dense
family. The reference stacks its layers on a leading axis and scans over
them; here ``params["layers"]`` is a list with one dictionary per layer, run
in a Python loop. This slice runs the embedding trunk: the forward returns
the final-norm hidden states that feed ProMiSH. Logits, prefill, decode and
the caches come with a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (AttnSpec, Params, apply_mlp,
                                       apply_norm, embed_tokens,
                                       init_attention, init_embed, init_mlp,
                                       init_norm, self_attention)


def attn_spec(cfg: ArchConfig) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim, d_model=cfg.d_model,
                    qk_norm=cfg.qk_norm, bias=cfg.attn_bias,
                    rope_theta=cfg.rope_theta)


def init_self_layer(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {"ln1": init_norm(cfg.d_model, cfg.norm, gen.device),
            "attn": init_attention(gen, attn_spec(cfg)),
            "ln2": init_norm(cfg.d_model, cfg.norm, gen.device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp)}


def apply_self_layer(p: Params, cfg: ArchConfig, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """One pre-norm layer (dense MLP): (B, S, D) -> (B, S, D)."""
    h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    x = x + self_attention(p["attn"], attn_spec(cfg), h, positions)
    h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg.mlp)


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random parameters (N(0, 0.02) matrices, unit norms, zero biases) of
    a dense config on the generator's device."""
    return {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model),
            "final_norm": init_norm(cfg.d_model, cfg.norm, gen.device),
            "layers": [init_self_layer(gen, cfg)
                       for _ in range(cfg.n_layers)]}


def forward_train(params: Params, cfg: ArchConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) tokens -> final-norm hidden states (B, S, D) in bf16: the
    reference's ``forward_train(..., return_hidden=True)``."""
    bsz, s = tokens.shape
    x = embed_tokens(params["embed"], tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(bsz, s)
    for p_l in params["layers"]:
        x = apply_self_layer(p_l, cfg, x, positions)
    return apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
