"""Shared layers of the language models: plain functions over tensors.

The port of the reference package's ``models/common.py``. Conventions, as
there:

  * activations bf16; matrix weights are held in bf16 (the value the
    reference casts its fp32 parameters to at every product), norm weights
    in fp32; norm statistics and softmax accumulate in fp32;
  * parameters are dictionaries of tensors under the reference's names and
    layouts (attention weights head-axis-explicit: wq (D, H, hd),
    wo (H, hd, D));
  * a self-attention over a whole sequence (the forward and prefill) goes
    through ``kernels.ops.flash_attention``: the hand-written kernel K7 on
    the card, its plain version on the CPU. A decode step (one query over
    the cache) and cross-attention (queries and keys of different lengths)
    take the reference's direct path in torch ops, as the reference never
    sends them to its kernel: bf16 operands, fp32 products and softmax.

Under a mesh (``models.hints.enable_hints_mesh``) the whole-sequence
self-attention runs once per (dp, tp) shard, each on its shard's device
over its batch rows and its heads, and the pieces are gathered, as the
reference wraps its kernel in ``shard_map``; the grouped-query heads are
expanded to one key and value head per query head where the kv heads do
not divide the TP axis (the reference's expansion). Otherwise the kernel
reads the grouped heads in place. GSPMD's automatic tensor parallelism of
the matrix products has no counterpart: each data-parallel shard runs the
products on its whole parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as _flash
from repro_torch.models import hints

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
    causal: bool = True
    window: int | None = None       # sliding-window width (tokens) or None
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


def f32_dot(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of bf16 operands with fp32 products and sums, the
    reference's ``preferred_element_type=float32``: the operands are rounded
    to bf16 and multiplied in fp32 (a bf16 product would round its result
    to bf16)."""
    return torch.einsum(equation, a.to(ACT_DTYPE).float(),
                        b.to(ACT_DTYPE).float())


def direct_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's direct attention path (``blockwise_attention`` for a
    decode step or a short sequence): q (B, S, H, hd), k, v (B, T, Kv, hd),
    ``valid`` a (B, S, T) or broadcastable bool mask or None (every key).
    Scores in fp32 from bf16 operands, masked to -1e30, an fp32 softmax, the
    probabilities rounded to v's dtype for the PV product (fp32 sums), the
    output in q's dtype."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    sc = f32_dot("bskgd,btkd->bksgt", qg, k) * (1.0 / float(hd) ** 0.5)
    if valid is not None:
        sc = sc.masked_fill(~valid[:, None, :, None, :], -1e30)
    p = torch.softmax(sc, dim=-1)
    out = f32_dot("bksgt,btkd->bksgd", p.to(v.dtype), v)
    return out.permute(0, 2, 1, 3, 4).reshape(b, s, h, hd).to(q.dtype)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) x (H, hd, D) -> (B, S, D)."""
    h, hd, d = wo.shape
    return out.flatten(-2) @ wo.to(out.dtype).reshape(h * hd, d)


def self_attention(p: Params, spec: AttnSpec, x: torch.Tensor,
                   positions: torch.Tensor, *,
                   cache: Params | None = None) -> tuple[torch.Tensor, Params]:
    """Self-attention, (B, S, D) -> ((B, S, D), kv).

    Without a cache (the forward and prefill) ``positions`` must be 0..S-1
    on every row, which is what the kernel assumes; the whole sequence goes
    through ``ops.flash_attention`` (K7 on the card) under the spec's
    causality and window, and ``kv`` is this sequence's ``{"k", "v"}``
    (B, S, Kv, hd). With ``cache = {"k", "v"}`` (B, T, Kv, hd) tensors and
    ``"pos"`` (a Python int, the position of the first new token), a decode
    step: the new keys and values are written into the cache tensors in
    place at ``pos``, and the queries attend, by the reference's direct
    path, to the keys at or before ``pos`` and their own position, inside
    the window (the reference's mask). Masked keys carry no weight, so only
    the live span of the cache is read. ``kv`` is then the updated cache
    tensors."""
    q, k, v = _project_qkv(p, spec, x, positions)
    if cache is None:
        out = attend(q, k, v, causal=spec.causal, window=spec.window)
        return _out_proj(out, p["wo"]), {"k": k, "v": v}
    pos, s = cache["pos"], x.shape[1]
    k_all, v_all = cache["k"], cache["v"]
    k_all[:, pos:pos + s] = k.to(k_all.dtype)
    v_all[:, pos:pos + s] = v.to(v_all.dtype)
    # the reference's mask: keys at or before ``pos``, at or before the
    # query, inside its window; keys before ``lo`` are outside every window
    lo = 0 if spec.window is None else max(0, pos - spec.window + 1)
    kv_pos = torch.arange(lo, pos + 1, device=x.device)
    q_pos = positions[:, :, None]
    valid = kv_pos <= q_pos if spec.causal \
        else torch.ones_like(kv_pos <= q_pos)
    if spec.window is not None:
        valid = valid & (kv_pos > q_pos - spec.window)
    out = direct_attention(q, k_all[:, lo:pos + 1], v_all[:, lo:pos + 1],
                           valid)
    return _out_proj(out, p["wo"]), {"k": k_all, "v": v_all}


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int | None) -> torch.Tensor:
    """Whole-sequence self-attention of q (B, S, H, hd) over k, v (B, S,
    Kv, hd) through ``ops.flash_attention`` (K7 forward, K7b backward on
    the card). With a TP size over 1 (``hints.tp_size``), S > 1, groups of
    g > 1 and kv heads that do not divide it while the query heads do, k
    and v are first repeated to one head per query head (the reference's
    expansion). With an active mesh the call runs per shard
    (:func:`_sharded_attend`)."""
    b, s, h, _ = q.shape
    kvh = k.shape[2]
    g, tp = h // kvh, hints.tp_size()
    if s > 1 and g > 1 and kvh % tp != 0 and h % tp == 0:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    ctx = hints.active()
    if ctx is None or ctx.get("mesh") is None:
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
    return _sharded_attend(q, k, v, ctx, causal, window)


def _sharded_attend(q, k, v, ctx: dict, causal: bool,
                    window: int | None) -> torch.Tensor:
    """``ops.flash_attention`` once per (dp, tp) shard of the active mesh,
    each on its shard's device over its batch rows (row blocks in the
    order of the dp axes' coordinates, ``pod`` major) and its heads (kv
    heads with their whole groups), the pieces gathered on q's device.
    Inside ``hints.on_dp_shard`` the rows are that one dp shard's. Where
    the rows do not divide the dp shards or the heads the TP size, the
    call runs whole on the mesh's first device (of the dp shard's, inside
    one), counted under ``flash_unsharded``."""
    mesh = ctx["mesh"]
    tp = ctx["tp"]
    shard = ctx.get("dp_shard")
    dp_coords = [shard] if shard is not None else list(
        mesh.coords([a for a in ctx["dp"] if a in mesh.shape]))
    tp_n = mesh.shape.get(tp, 1)
    b, h, kvh = q.shape[0], q.shape[2], k.shape[2]
    if b % len(dp_coords) or h % tp_n or kvh % tp_n:
        build.count(_flash.launches, "flash_unsharded")
        dev = mesh.device_at(**(shard or {}))
        out = ops.flash_attention(*(t.to(dev).contiguous() for t in (q, k, v)),
                                  causal=causal, window=window)
        return out.to(q.device)
    rows, heads, kv_heads = b // len(dp_coords), h // tp_n, kvh // tp_n
    outs = []
    for i, coords in enumerate(dp_coords):
        r = slice(i * rows, (i + 1) * rows)
        parts = []
        for j in range(tp_n):
            dev = mesh.device_at(**coords, **({tp: j} if tp in mesh.shape
                                              else {}))
            hq = slice(j * heads, (j + 1) * heads)
            hk = slice(j * kv_heads, (j + 1) * kv_heads)
            out = ops.flash_attention(
                q[r, :, hq].to(dev).contiguous(),
                k[r, :, hk].to(dev).contiguous(),
                v[r, :, hk].to(dev).contiguous(), causal=causal,
                window=window)
            parts.append(out.to(q.device))
        outs.append(parts[0] if tp_n == 1 else torch.cat(parts, dim=2))
    # one piece is the output itself: no copy
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def cross_kv(p: Params, spec: AttnSpec,
             kv_src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention keys and values (B, T, Kv, hd) from memory tokens
    (B, T, D): computed once a request and cached in serving."""
    k, v = _heads(kv_src, p["wk"]), _heads(kv_src, p["wv"])
    if spec.qk_norm:
        k = rmsnorm(k, p["kn"])
    return k, v


def cross_attention(p: Params, spec: AttnSpec, x: torch.Tensor,
                    kv_src: torch.Tensor | None = None, *,
                    k: torch.Tensor | None = None,
                    v: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-attention: queries from x (B, S, D), keys and values from
    ``kv_src`` (B, T, D) or given (k, v); no RoPE, no mask. The reference
    runs it on its direct path (its kernel takes T == S only)."""
    if k is None:
        k, v = cross_kv(p, spec, kv_src)
    q = _heads(x, p["wq"])
    if spec.qk_norm:
        q = rmsnorm(q, p["qn"])
    return _out_proj(direct_attention(q, k, v), p["wo"])


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


def init_embed(gen: torch.Generator, vocab: int, d: int,
               tie: bool) -> Params:
    """Embedding table padded to :data:`VOCAB_ALIGN` rows, and an untied
    output head (D, padded vocab) unless ``tie``. Padded logit columns are
    pushed to -1e30 in :func:`unembed`."""
    vp = padded_vocab(vocab)
    p = {"tok": dense_init(gen, (vp, d))}
    if not tie:
        p["head"] = dense_init(gen, (d, vp))
    return p


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"].to(ACT_DTYPE)[tokens]


def unembed(p: Params, x: torch.Tensor, vocab: int) -> torch.Tensor:
    """(..., D) -> (..., padded vocab) logits in x's dtype: through the
    head, or the embedding table when tied; the padded columns get -1e30
    added in the logits' dtype."""
    w = p["head"] if "head" in p else p["tok"].t()
    logits = x @ w.to(x.dtype)
    vp = logits.shape[-1]
    if vp != vocab:
        pad = (torch.arange(vp, device=x.device) >= vocab).to(logits.dtype)
        logits = logits + pad * -1e30
    return logits
