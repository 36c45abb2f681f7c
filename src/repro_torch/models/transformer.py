"""Decoder-only transformers of the dense, mixture-of-experts, state-space,
hybrid and vision families: parameters, the forward, prefill and decode.

The port of the reference package's ``models/transformer.py``. The reference
stacks homogeneous layers on a leading axis and scans over them; here
``params["layers"]`` is a list with one entry per layer (or per super-block)
run in a Python loop:

  * dense, state-space, hybrid and mixture-of-experts with ``every == 1``:
    one parameter dict a layer;
  * mixture-of-experts with ``every > 1`` (llama4's dense/MoE alternation):
    one ``{"dense": [every - 1 layer dicts], "moe": layer dict}`` a block;
  * vision: one ``{"self": [every - 1 layer dicts], "cross": cross-layer
    dict}`` a block, and ``params["vis_proj"]`` (vision_dim, D).

Caches follow the same lists, under the reference's leaf names: ``{"k",
"v"}`` (B, max_seq, Kv, hd) per attention layer, the SSM state ``{"cx",
"cb", "cc", "ssm"}``, ``"state"`` beside ``k``/``v`` in a hybrid layer, and
``"xk"``/``"xv"`` (B, vision_tokens, Kv, hd) a vision block; ``"pos"`` is a
Python int, so that a decode step needs no host sync. Decode writes the new
keys and values into the cache tensors in place and returns the cache with
``pos`` advanced.

Three drivers share the layer functions, as in the reference:
``forward_train`` (no cache; logits or the final-norm hidden states, and the
aux loss; differentiable, with the reference's ``remat``: under grad mode
each entry of ``params["layers"]`` runs inside
``torch.utils.checkpoint.checkpoint``, which keeps only its input and runs
it again in the backward), ``prefill`` (builds the cache; last-token
logits) and ``decode`` (one step, cache in and out).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (ACT_DTYPE, AttnSpec, Params,
                                       apply_mlp, apply_norm,
                                       cross_attention, cross_kv, dense_init,
                                       embed_tokens, init_attention,
                                       init_embed, init_mlp, init_norm,
                                       self_attention, unembed)

HYMBA_WINDOW = 1024     # sliding-window width of the hybrid attention heads


def attn_spec(cfg: ArchConfig, *, window: int | None = None,
              causal: bool = True) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim, d_model=cfg.d_model,
                    qk_norm=cfg.qk_norm, bias=cfg.attn_bias, causal=causal,
                    window=window, rope_theta=cfg.rope_theta)


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


# ---------------------------------------------------------------- layers
def init_self_layer(gen: torch.Generator, cfg: ArchConfig, *,
                    use_moe: bool = False) -> Params:
    p: Params = {"ln1": init_norm(cfg.d_model, cfg.norm, gen.device),
                 "attn": init_attention(gen, attn_spec(cfg)),
                 "ln2": init_norm(cfg.d_model, cfg.norm, gen.device)}
    if use_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg.d_model, cfg.moe)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp)
    return p


def apply_self_layer(p: Params, cfg: ArchConfig, x: torch.Tensor,
                     positions: torch.Tensor, *, cache: Params | None = None):
    """One pre-norm layer, MLP or mixture of experts (by its parameters).
    Returns (x, kv {"k", "v"}, aux)."""
    h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    att, kv = self_attention(p["attn"], attn_spec(cfg), h, positions,
                             cache=cache)
    x = x + att
    h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    if "moe" in p:
        out, aux = moe_lib.apply_moe(p["moe"], h, cfg.moe)
    else:
        out, aux = apply_mlp(p["mlp"], h, cfg.mlp), _zero(x.device)
    return x + out, kv, aux


def init_ssm_layer(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {"ln1": init_norm(cfg.d_model, cfg.norm, gen.device),
            "ssm": ssm_lib.init_ssm(gen, cfg.d_model, cfg.ssm)}


def apply_ssm_layer(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                    state: Params | None = None):
    h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    out, new_state = ssm_lib.apply_ssm(p["ssm"], h, cfg.ssm, state=state)
    return x + out, new_state


def init_hybrid_layer(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Hymba: parallel attention and SSM heads fused by per-branch norms."""
    dev = gen.device
    return {"ln1": init_norm(cfg.d_model, cfg.norm, dev),
            "attn": init_attention(gen, attn_spec(cfg, window=HYMBA_WINDOW)),
            "ssm": ssm_lib.init_ssm(gen, cfg.d_model, cfg.ssm),
            "na": init_norm(cfg.d_model, cfg.norm, dev),
            "ns": init_norm(cfg.d_model, cfg.norm, dev),
            "ln2": init_norm(cfg.d_model, cfg.norm, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp)}


def apply_hybrid_layer(p: Params, cfg: ArchConfig, x: torch.Tensor,
                       positions: torch.Tensor, *,
                       cache: Params | None = None,
                       state: Params | None = None):
    """Returns (x, kv, new SSM state)."""
    spec = attn_spec(cfg, window=HYMBA_WINDOW)
    h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    att, kv = self_attention(p["attn"], spec, h, positions, cache=cache)
    ssm_out, new_state = ssm_lib.apply_ssm(p["ssm"], h, cfg.ssm, state=state)
    fused = 0.5 * (apply_norm(p["na"], att, cfg.norm, cfg.norm_eps)
                   + apply_norm(p["ns"], ssm_out, cfg.norm, cfg.norm_eps))
    x = x + fused
    h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg.mlp), kv, new_state


def init_cross_layer(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Gated vision cross-attention layer (llama-3.2-vision style); the two
    gates are fp32 scalars, 0 at initialisation (tanh(0) = 0)."""
    dev = gen.device
    return {"ln1": init_norm(cfg.d_model, cfg.norm, dev),
            "xattn": init_attention(gen, attn_spec(cfg, causal=False)),
            "gate_a": _zero(dev),
            "ln2": init_norm(cfg.d_model, cfg.norm, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp),
            "gate_m": _zero(dev)}


def apply_cross_layer(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                      kv_src: torch.Tensor | None = None,
                      k: torch.Tensor | None = None,
                      v: torch.Tensor | None = None) -> torch.Tensor:
    spec = attn_spec(cfg, causal=False)
    h = apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    att = cross_attention(p["xattn"], spec, h, kv_src, k=k, v=v)
    x = x + torch.tanh(p["gate_a"].float()).to(x.dtype) * att
    h = apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + torch.tanh(p["gate_m"].float()).to(x.dtype) \
        * apply_mlp(p["mlp"], h, cfg.mlp)


# ---------------------------------------------------------- parameters
def n_blocks(cfg: ArchConfig) -> int:
    """Entries of ``params["layers"]``: layers, or super-blocks where the
    family interleaves two kinds of layer."""
    if cfg.family == "moe" and cfg.moe.every > 1:
        return cfg.n_layers // cfg.moe.every
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_attn_every
    return cfg.n_layers


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random parameters (N(0, 0.02) matrices, unit norms, zero biases and
    gates) on the generator's device."""
    fam = cfg.family
    p: Params = {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model,
                                     cfg.tie_embeddings),
                 "final_norm": init_norm(cfg.d_model, cfg.norm, gen.device)}
    nb = n_blocks(cfg)
    if fam == "dense" or (fam == "moe" and cfg.moe.every == 1):
        p["layers"] = [init_self_layer(gen, cfg, use_moe=fam == "moe")
                       for _ in range(nb)]
    elif fam == "moe":
        p["layers"] = [{"dense": [init_self_layer(gen, cfg)
                                  for _ in range(cfg.moe.every - 1)],
                        "moe": init_self_layer(gen, cfg, use_moe=True)}
                       for _ in range(nb)]
    elif fam == "ssm":
        p["layers"] = [init_ssm_layer(gen, cfg) for _ in range(nb)]
    elif fam == "hybrid":
        p["layers"] = [init_hybrid_layer(gen, cfg) for _ in range(nb)]
    elif fam == "vlm":
        p["layers"] = [{"self": [init_self_layer(gen, cfg)
                                 for _ in range(cfg.cross_attn_every - 1)],
                        "cross": init_cross_layer(gen, cfg)}
                       for _ in range(nb)]
        p["vis_proj"] = dense_init(gen, (cfg.vision_dim, cfg.d_model))
    else:
        raise ValueError(f"family {fam} is handled by models.audio")
    return p


def _positions(bsz: int, s: int, device, pos0: int = 0) -> torch.Tensor:
    return torch.arange(pos0, pos0 + s, dtype=torch.int32,
                        device=device).expand(bsz, s)


def _vision(params: Params, extra: dict) -> torch.Tensor:
    return extra["patches"].to(ACT_DTYPE) @ params["vis_proj"].to(ACT_DTYPE)


def _padded(kv: Params, max_seq: int) -> Params:
    """A (B, S, Kv, hd) pair copied into zeroed (B, max_seq, Kv, hd)
    tensors, which decode then fills in place."""
    out = {}
    for name in ("k", "v"):
        a = kv[name]
        buf = a.new_zeros((a.shape[0], max_seq, *a.shape[2:]))
        buf[:, :a.shape[1]] = a
        out[name] = buf
    return out


def _kvc(kv: Params, pos: int) -> Params:
    return {"k": kv["k"], "v": kv["v"], "pos": pos}


# --------------------------------------------------------------- drivers
def _run(params: Params, cfg: ArchConfig, x: torch.Tensor,
         positions: torch.Tensor, *, extra=None, cache: Params | None = None,
         max_seq: int | None = None, remat: bool = False):
    """The layer stack, one driver for all three modes: no cache and no
    ``max_seq`` (the forward), ``max_seq`` (prefill: builds the cache
    layers) or ``cache`` (decode). Returns (x, aux, cache layers or
    None). ``remat`` (the forward under grad mode only) runs each entry of
    ``params["layers"]`` (a layer or a super-block) under
    ``torch.utils.checkpoint.checkpoint``: the reference's
    remat of its scan body."""
    fam = cfg.family
    aux = _zero(x.device)
    pos = None if cache is None else cache["pos"]
    building = max_seq is not None
    keep = building or cache is not None
    layers_in = cache["layers"] if cache is not None \
        else [None] * len(params["layers"])
    out_layers = []

    def self_layer(p_l, c_l, x):
        kv_in = None if c_l is None else _kvc(c_l, pos)
        x, kv, a = apply_self_layer(p_l, cfg, x, positions, cache=kv_in)
        return x, (_padded(kv, max_seq) if building else kv), a

    if fam == "vlm" and cache is None:
        vis = _vision(params, extra)

    def block(p_l, c_l, x):
        """One entry of ``params["layers"]``: (x, aux, its cache layer)."""
        if fam == "dense" or (fam == "moe" and cfg.moe.every == 1):
            return self_layer(p_l, c_l, x)
        if fam == "moe":
            a_sum, dense_kv = _zero(x.device), []
            for j, p_d in enumerate(p_l["dense"]):
                x, kv, a = self_layer(p_d, None if c_l is None
                                      else c_l["dense"][j], x)
                a_sum = a_sum + a
                dense_kv.append(kv)
            x, kv, a = self_layer(p_l["moe"], None if c_l is None
                                  else c_l["moe"], x)
            return x, {"dense": dense_kv, "moe": kv}, a_sum + a
        if fam == "ssm":
            x, st = apply_ssm_layer(p_l, cfg, x, state=c_l)
            return x, st, None
        if fam == "hybrid":
            kv_in = None if c_l is None else _kvc(c_l, pos)
            x, kv, st = apply_hybrid_layer(
                p_l, cfg, x, positions, cache=kv_in,
                state=None if c_l is None else c_l["state"])
            return x, {**(_padded(kv, max_seq) if building else kv),
                       "state": st}, None
        if fam == "vlm":
            self_kv = []
            for j, p_d in enumerate(p_l["self"]):
                x, kv, _ = self_layer(p_d, None if c_l is None
                                      else c_l["self"][j], x)
                self_kv.append(kv)
            if c_l is None:
                xk, xv = cross_kv(p_l["cross"]["xattn"],
                                  attn_spec(cfg, causal=False), vis)
            else:
                xk, xv = c_l["xk"], c_l["xv"]
            x = apply_cross_layer(p_l["cross"], cfg, x, k=xk, v=xv)
            return x, {"self": self_kv, "xk": xk, "xv": xv}, None
        raise ValueError(fam)

    remat = remat and not keep and torch.is_grad_enabled()
    for p_l, c_l in zip(params["layers"], layers_in):
        if remat:
            x, layer, a = checkpoint(block, p_l, c_l, x, use_reentrant=False)
        else:
            x, layer, a = block(p_l, c_l, x)
        if a is not None:
            aux = aux + a
        if keep:
            out_layers.append(layer)
    return x, aux, (out_layers if keep else None)


def forward_train(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
                  extra: dict | None = None, remat: bool = True,
                  return_hidden: bool = False):
    """(B, S) tokens -> (logits (B, S, padded vocab) in bf16, aux loss fp32
    scalar); no cache. ``return_hidden`` swaps the logits for the final-norm
    hidden states (B, S, D): the embedding trunk that feeds ProMiSH.
    Differentiable; ``remat`` recomputes each layer in the backward (it
    does nothing outside grad mode)."""
    bsz, s = tokens.shape
    x = embed_tokens(params["embed"], tokens)
    x, aux, _ = _run(params, cfg, x, _positions(bsz, s, tokens.device),
                     extra=extra, remat=remat)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    if return_hidden:
        return x, aux
    return unembed(params["embed"], x, cfg.vocab_size), aux


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            extra: dict | None = None, max_seq: int | None = None):
    """Builds the serving cache at ``max_seq`` (>= S) positions. Returns
    (last-token logits (B, padded vocab), cache)."""
    bsz, s = tokens.shape
    max_seq = s if max_seq is None else max_seq
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} < prompt length {s}")
    x = embed_tokens(params["embed"], tokens)
    x, _, layers = _run(params, cfg, x, _positions(bsz, s, tokens.device),
                        extra=extra, max_seq=max_seq)
    x = apply_norm(params["final_norm"], x[:, -1:], cfg.norm, cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.vocab_size)[:, 0]
    return logits, {"layers": layers, "pos": s}


def decode(params: Params, cfg: ArchConfig, cache: Params,
           tokens: torch.Tensor):
    """One serving step: tokens (B, 1) -> (logits (B, padded vocab),
    cache with ``pos`` advanced; its tensors updated in place)."""
    bsz, s = tokens.shape
    pos = cache["pos"]
    if pos + s > _cache_len(cfg, cache):
        raise ValueError(f"cache of {_cache_len(cfg, cache)} positions is "
                         f"full at {pos}")
    x = embed_tokens(params["embed"], tokens)
    x, _, layers = _run(params, cfg, x,
                        _positions(bsz, s, tokens.device, pos), cache=cache)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.vocab_size)[:, -1]
    return logits, {"layers": layers, "pos": pos + s}


def _cache_len(cfg: ArchConfig, cache: Params) -> int:
    """Positions the cache holds (an SSM state holds any number)."""
    first = cache["layers"][0]
    if cfg.family == "ssm":
        return 1 << 62
    if cfg.family == "moe" and "moe" in first:
        first = first["moe"]
    elif cfg.family == "vlm":
        first = first["self"][0]
    return first["k"].shape[1]


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device: torch.device, dtype=ACT_DTYPE) -> Params:
    """Empty decode cache at ``max_seq`` positions, ``pos`` 0."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    fam = cfg.family

    def kv_pair():
        return {"k": torch.zeros(batch, max_seq, kv, hd, dtype=dtype,
                                 device=device),
                "v": torch.zeros(batch, max_seq, kv, hd, dtype=dtype,
                                 device=device)}

    def state():
        return ssm_lib.init_state(batch, cfg.d_model, cfg.ssm, device=device)

    nb = n_blocks(cfg)
    if fam == "dense" or (fam == "moe" and cfg.moe.every == 1):
        layers = [kv_pair() for _ in range(nb)]
    elif fam == "moe":
        layers = [{"dense": [kv_pair() for _ in range(cfg.moe.every - 1)],
                   "moe": kv_pair()} for _ in range(nb)]
    elif fam == "ssm":
        layers = [state() for _ in range(nb)]
    elif fam == "hybrid":
        layers = [{**kv_pair(), "state": state()} for _ in range(nb)]
    elif fam == "vlm":
        shape = (batch, cfg.vision_tokens, kv, hd)
        layers = [{"self": [kv_pair()
                            for _ in range(cfg.cross_attn_every - 1)],
                   "xk": torch.zeros(shape, dtype=dtype, device=device),
                   "xv": torch.zeros(shape, dtype=dtype, device=device)}
                  for _ in range(nb)]
    else:
        raise ValueError(fam)
    return {"layers": layers, "pos": 0}
