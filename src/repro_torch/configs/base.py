"""Architecture configuration of the language models the port runs.

One :class:`ArchConfig` per architecture, with the published numbers, plus a
``smoke()`` reduction for the CPU tests. This is the reference package's
``configs/base.py`` trimmed to what the dense decoder forward reads: the
mixture-of-experts, state-space, hybrid, vision and audio fields come with
the slices that run those families; the training schedule, the shape cells
and the output head's tying with the slices that train and compute logits.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "ssm", "moe", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # None -> d_model // n_heads
    qk_norm: bool = False
    attn_bias: bool = False              # qwen1.5-style qkv bias
    mlp: Literal["swiglu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        heads = min(4, self.n_heads)
        kv = max(1, min(heads, self.n_kv_heads * heads // self.n_heads or 1))
        return dataclasses.replace(
            self, name=self.name + "-smoke",
            n_layers=max(2, min(4, self.n_layers)), d_model=64,
            n_heads=heads, n_kv_heads=kv, head_dim=16, d_ff=128,
            vocab_size=256)
