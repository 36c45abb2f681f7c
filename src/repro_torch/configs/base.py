"""Architecture and run configuration of the language models the port runs.

One :class:`ArchConfig` per architecture, with the published numbers, plus a
``smoke()`` reduction for the CPU tests. This is the reference package's
``configs/base.py``: the mixture-of-experts and state-space blocks
(:class:`MoEConfig`, :class:`SSMConfig`), the hybrid, vision and audio
fields, the output head's tying, the training schedule's name and the
input-shape cells (:class:`ShapeCell`; ``train_4k``, ``prefill_32k``,
``decode_32k``, ``long_500k``), which are plain data.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "ssm", "moe", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int          # per-expert hidden width
    every: int = 1            # MoE layer every `every` layers (others dense)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    def expert_parallel(self, d_model: int) -> bool:
        """Whether the experts' weights of one layer are heavy (over 2 GB in
        bf16): the reference pins such experts to its tensor-parallel axis
        and moves tokens to them. On one card it decides nothing."""
        return 3 * self.n_experts * self.d_ff_expert * d_model * 2 > 2e9


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256          # SSD chunk length


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
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    schedule: Literal["wsd", "cosine"] = "cosine"
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid (hymba): parallel attention + SSM heads in each layer
    hybrid: bool = False
    # vlm: every `cross_attn_every`-th layer is a vision cross-attention layer
    cross_attn_every: int = 0
    vision_tokens: int = 0
    vision_dim: int = 0
    # audio (whisper): encoder-decoder; n_layers == decoder layers
    enc_layers: int = 0
    audio_frames: int = 0                # stub conv frontend output length
    sub_quadratic: bool = False          # can run long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.enc_layers > 0

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        small_moe = None
        if self.moe is not None:
            small_moe = dataclasses.replace(
                self.moe, n_experts=min(8, self.moe.n_experts),
                top_k=min(2, self.moe.top_k), d_ff_expert=64)
        small_ssm = None
        if self.ssm is not None:
            small_ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=8,
                                            chunk=8, n_groups=1)
        heads = min(4, self.n_heads)
        kv = max(1, min(heads, self.n_kv_heads * heads // self.n_heads or 1))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, min(4, self.n_layers)) if self.cross_attn_every == 0
            else 2 * max(2, self.cross_attn_every // 2),
            d_model=64, n_heads=heads, n_kv_heads=kv, head_dim=16,
            d_ff=128, vocab_size=256, moe=small_moe, ssm=small_ssm,
            cross_attn_every=min(self.cross_attn_every, 2) if self.cross_attn_every else 0,
            vision_tokens=min(self.vision_tokens, 8), vision_dim=32 if self.vision_dim else 0,
            enc_layers=min(self.enc_layers, 2), audio_frames=min(self.audio_frames, 16),
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One input-shape cell: sequence length, global batch and the step it
    drives."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def is_serving(self) -> bool:
        return self.kind != "train"


TRAIN_4K = ShapeCell("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524_288, 1, "decode")
ALL_CELLS = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def supported_cells(cfg: ArchConfig) -> list[ShapeCell]:
    """long_500k needs sub-quadratic sequence mixing (SSM or hybrid); every
    architecture has a decoder, so the decode cells always run."""
    cells = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        cells.append(LONG_500K)
    return cells
