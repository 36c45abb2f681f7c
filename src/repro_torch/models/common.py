"""Shared layers of the dense decoder: plain functions over tensors.

The port of the reference package's ``models/common.py``, trimmed to what the
dense forward runs. Conventions, as there:

  * activations bf16; matrix weights are held in bf16 (the value the
    reference casts its fp32 parameters to at every product), norm weights
    in fp32; norm statistics and softmax accumulate in fp32;
  * parameters are dictionaries of tensors under the reference's names and
    layouts (attention weights head-axis-explicit: wq (D, H, hd),
    wo (H, hd, D));
  * the self-attention goes through ``kernels.ops.flash_attention``: the
    hand-written kernel K7 on the card, its plain version on the CPU.

Tensor-parallel sharding hints have no meaning on one card and are not
ported; the grouped-query heads are read in place by the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = dict[str, Any]
ACT_DTYPE = torch.bfloat16


# --------------------------------------------------------------------- init
def dense_init(gen: torch.Generator, shape,
               scale: float = 0.02) -> torch.Tensor:
    """N(0, scale^2) drawn in fp32 on the generator's device, held in bf16
    (the value the forward uses)."""
    w = torch.randn(shape, generator=gen, device=gen.device) * scale
    return w.to(ACT_DTYPE)


# -------------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def init_norm(d: int, kind: str, device: torch.device) -> Params:
    p = {"w": torch.ones(d, dtype=torch.float32, device=device)}
    if kind != "rmsnorm":
        p["b"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"], eps)
    return layernorm(x, p["w"], p["b"], eps)


# --------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> (cos, sin) each (..., S, head_dim/2) fp32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / torch.tensor(theta, dtype=torch.float32,
                               device=positions.device).pow(exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd), rotated by halves (not interleaved); cos/sin
    (..., S, hd/2) broadcast over heads. Computed in fp32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- attention
@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_model: int
    qk_norm: bool = False
    bias: bool = False
    rope_theta: float | None = 10_000.0


def init_attention(gen: torch.Generator, spec: AttnSpec) -> Params:
    h, kv, hd, d = spec.n_heads, spec.n_kv_heads, spec.head_dim, spec.d_model
    dev = gen.device
    p: Params = {
        "wq": dense_init(gen, (d, h, hd)),
        "wk": dense_init(gen, (d, kv, hd)),
        "wv": dense_init(gen, (d, kv, hd)),
        "wo": dense_init(gen, (h, hd, d)),
    }
    if spec.bias:
        for name, n in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros((n, hd), dtype=ACT_DTYPE, device=dev)
    if spec.qk_norm:
        p["qn"] = torch.ones(hd, dtype=torch.float32, device=dev)
        p["kn"] = torch.ones(hd, dtype=torch.float32, device=dev)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) x (D, H, hd) -> (B, S, H, hd) in x's dtype."""
    d, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * hd)).unflatten(-1, (h, hd))


def _project_qkv(p: Params, spec: AttnSpec, x: torch.Tensor,
                 positions: torch.Tensor):
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, Kv, hd), rope applied."""
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if spec.bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if spec.qk_norm:
        q = rmsnorm(q, p["qn"])
        k = rmsnorm(k, p["kn"])
    if spec.rope_theta is not None:
        cos, sin = rope_angles(positions, spec.head_dim, spec.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def self_attention(p: Params, spec: AttnSpec, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over a whole sequence (no cache): (B, S, D) ->
    (B, S, D). Positions must be 0..S-1 on every row, which is what the
    attention kernel assumes. (The reference's sliding-window option serves
    the hybrid family, not ported yet; the kernel takes a window.)"""
    q, k, v = _project_qkv(p, spec, x, positions)
    out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True)
    h, hd, d = p["wo"].shape
    return out.flatten(-2) @ p["wo"].to(x.dtype).reshape(h * hd, d)


# ---------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, d: int, f: int, kind: str) -> Params:
    if kind == "swiglu":
        return {"w1": dense_init(gen, (d, f)), "w3": dense_init(gen, (d, f)),
                "w2": dense_init(gen, (f, d))}
    dev = gen.device
    return {"w1": dense_init(gen, (d, f)),
            "b1": torch.zeros(f, dtype=ACT_DTYPE, device=dev),
            "w2": dense_init(gen, (f, d)),
            "b2": torch.zeros(d, dtype=ACT_DTYPE, device=dev)}


def apply_mlp(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    dt = x.dtype
    if kind == "swiglu":
        h = F.silu(x @ p["w1"].to(dt)) * (x @ p["w3"].to(dt))
        return h @ p["w2"].to(dt)
    # the reference's gelu is the tanh approximation
    h = F.gelu(x @ p["w1"].to(dt) + p["b1"].to(dt), approximate="tanh")
    return h @ p["w2"].to(dt) + p["b2"].to(dt)


# -------------------------------------------------------------------- embed
VOCAB_ALIGN = 128   # vocab padded to a multiple (the reference's alignment)


def padded_vocab(vocab: int) -> int:
    return ((vocab + VOCAB_ALIGN - 1) // VOCAB_ALIGN) * VOCAB_ALIGN


def init_embed(gen: torch.Generator, vocab: int, d: int) -> Params:
    """Embedding table padded to :data:`VOCAB_ALIGN` rows. (The reference's
    untied output head comes with the slice that computes logits.)"""
    return {"tok": dense_init(gen, (padded_vocab(vocab), d))}


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"].to(ACT_DTYPE)[tokens]
