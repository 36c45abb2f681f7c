"""Whisper-style encoder-decoder (the audio family).

The port of the reference package's ``models/audio.py``. The conv frontend
is a stub, as there: the batch supplies precomputed frame embeddings
(B, audio_frames, d_model). The backbone is whole:

  * encoder: learned positions, non-causal self-attention (through
    ``ops.flash_attention``, K7 on the card), GELU MLP, pre-LN;
  * decoder: learned positions, causal self-attention, cross-attention to
    the encoder output, GELU MLP.

Parameters: ``enc_layers`` and ``dec_layers`` are lists of per-layer dicts
(the reference stacks them). Serving caches the decoder's self-attention
keys and values and, per layer, the cross-attention keys and values
projected once from the encoder output: ``{"layers": [{"k", "v", "xk",
"xv"}, ...], "pos": int}``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (ACT_DTYPE, AttnSpec, Params,
                                       apply_mlp, apply_norm,
                                       cross_attention, cross_kv, dense_init,
                                       embed_tokens, init_attention,
                                       init_embed, init_mlp, init_norm,
                                       self_attention, unembed)

MAX_TEXT_POS = 32_768 + 8      # learned decoder positions (covers decode_32k)


def _spec(cfg: ArchConfig, causal: bool) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim, d_model=cfg.d_model,
                    qk_norm=False, bias=cfg.attn_bias, causal=causal,
                    window=None, rope_theta=None)


def init_enc_layer(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {"ln1": init_norm(cfg.d_model, cfg.norm, gen.device),
            "attn": init_attention(gen, _spec(cfg, causal=False)),
            "ln2": init_norm(cfg.d_model, cfg.norm, gen.device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp)}


def init_dec_layer(gen: torch.Generator, cfg: ArchConfig) -> Params:
    dev = gen.device
    return {"ln1": init_norm(cfg.d_model, cfg.norm, dev),
            "attn": init_attention(gen, _spec(cfg, causal=True)),
            "lnx": init_norm(cfg.d_model, cfg.norm, dev),
            "xattn": init_attention(gen, _spec(cfg, causal=False)),
            "ln2": init_norm(cfg.d_model, cfg.norm, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp)}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    dev = gen.device
    return {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model,
                            cfg.tie_embeddings),
        "enc_pos": dense_init(gen, (cfg.audio_frames, cfg.d_model),
                              scale=0.01),
        "dec_pos": dense_init(gen, (MAX_TEXT_POS, cfg.d_model), scale=0.01),
        "enc_layers": [init_enc_layer(gen, cfg)
                       for _ in range(cfg.enc_layers)],
        "dec_layers": [init_dec_layer(gen, cfg)
                       for _ in range(cfg.n_layers)],
        "enc_norm": init_norm(cfg.d_model, cfg.norm, dev),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dev),
    }


def _layers(body, layers, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``x = body(p_l, x)`` over ``layers``; under grad mode with ``remat``
    each call runs inside ``torch.utils.checkpoint.checkpoint`` (the
    reference's remat around its scan body)."""
    remat = remat and torch.is_grad_enabled()
    for p_l in layers:
        x = checkpoint(body, p_l, x, use_reentrant=False) if remat \
            else body(p_l, x)
    return x


def encode(params: Params, cfg: ArchConfig, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """frames (B, T, D) from the stub frontend -> encoder states (B, T, D)."""
    b, t, _ = frames.shape
    x = frames.to(ACT_DTYPE) + params["enc_pos"][:t].to(ACT_DTYPE)
    positions = torch.arange(t, dtype=torch.int32,
                             device=frames.device).expand(b, t)
    spec = _spec(cfg, causal=False)

    def body(p_l, x):
        h = apply_norm(p_l["ln1"], x, cfg.norm, cfg.norm_eps)
        att, _ = self_attention(p_l["attn"], spec, h, positions)
        x = x + att
        h = apply_norm(p_l["ln2"], x, cfg.norm, cfg.norm_eps)
        return x + apply_mlp(p_l["mlp"], h, cfg.mlp)
    x = _layers(body, params["enc_layers"], x, remat)
    return apply_norm(params["enc_norm"], x, cfg.norm, cfg.norm_eps)


def _dec_layer(p_l: Params, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor, enc_out=None, *, kv=None, pos=None,
               xk=None, xv=None):
    h = apply_norm(p_l["ln1"], x, cfg.norm, cfg.norm_eps)
    cache = None if kv is None else {"k": kv["k"], "v": kv["v"], "pos": pos}
    att, nkv = self_attention(p_l["attn"], _spec(cfg, causal=True), h,
                              positions, cache=cache)
    x = x + att
    h = apply_norm(p_l["lnx"], x, cfg.norm, cfg.norm_eps)
    x = x + cross_attention(p_l["xattn"], _spec(cfg, causal=False), h,
                            kv_src=enc_out, k=xk, v=xv)
    h = apply_norm(p_l["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + apply_mlp(p_l["mlp"], h, cfg.mlp), nkv


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def forward_train(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
                  extra: dict, remat: bool = True,
                  return_hidden: bool = False):
    """tokens (B, S) and ``extra["frames"]`` (B, T, D) -> (logits, aux =
    0). Differentiable; ``remat`` recomputes each encoder and decoder layer
    in the backward (it does nothing outside grad mode)."""
    b, s = tokens.shape
    enc_out = encode(params, cfg, extra["frames"], remat=remat)
    x = embed_tokens(params["embed"], tokens) \
        + params["dec_pos"][:s].to(ACT_DTYPE)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = _layers(lambda p_l, x: _dec_layer(p_l, cfg, x, positions,
                                          enc_out)[0],
                params["dec_layers"], x, remat)
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    if return_hidden:
        return x, _zero(x.device)
    return unembed(params["embed"], x, cfg.vocab_size), _zero(x.device)


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            extra: dict, max_seq: int | None = None):
    """Encodes the frames, projects every layer's cross keys and values
    once, runs the prompt and builds the cache at ``max_seq`` positions.
    Returns (last-token logits, cache)."""
    b, s = tokens.shape
    max_seq = s if max_seq is None else max_seq
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} < prompt length {s}")
    enc_out = encode(params, cfg, extra["frames"])
    x = embed_tokens(params["embed"], tokens) \
        + params["dec_pos"][:s].to(ACT_DTYPE)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    spec_x = _spec(cfg, causal=False)
    layers = []
    for p_l in params["dec_layers"]:
        xk, xv = cross_kv(p_l["xattn"], spec_x, enc_out)
        x, kv = _dec_layer(p_l, cfg, x, positions, xk=xk, xv=xv)
        entry = {}
        for name in ("k", "v"):
            buf = kv[name].new_zeros((b, max_seq, *kv[name].shape[2:]))
            buf[:, :s] = kv[name]
            entry[name] = buf
        layers.append({**entry, "xk": xk, "xv": xv})
    x = apply_norm(params["final_norm"], x[:, -1:], cfg.norm, cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.vocab_size)[:, 0]
    return logits, {"layers": layers, "pos": s}


def decode(params: Params, cfg: ArchConfig, cache: Params,
           tokens: torch.Tensor):
    """One step: tokens (B, 1) -> (logits, cache with ``pos`` advanced; its
    self-attention tensors updated in place)."""
    b, s = tokens.shape
    pos = cache["pos"]
    if pos + s > cache["layers"][0]["k"].shape[1]:
        raise ValueError(f"cache of {cache['layers'][0]['k'].shape[1]} "
                         f"positions is full at {pos}")
    x = embed_tokens(params["embed"], tokens) \
        + params["dec_pos"][pos:pos + s].to(ACT_DTYPE)
    positions = torch.arange(pos, pos + s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    layers = []
    for p_l, c_l in zip(params["dec_layers"], cache["layers"]):
        x, nkv = _dec_layer(p_l, cfg, x, positions, kv=c_l, pos=pos,
                            xk=c_l["xk"], xv=c_l["xv"])
        layers.append({"k": nkv["k"], "v": nkv["v"], "xk": c_l["xk"],
                       "xv": c_l["xv"]})
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return unembed(params["embed"], x, cfg.vocab_size)[:, -1], \
        {"layers": layers, "pos": pos + s}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               device: torch.device, dtype=ACT_DTYPE) -> Params:
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def zeros(t):
        return torch.zeros(batch, t, kv, hd, dtype=dtype, device=device)
    return {"layers": [{"k": zeros(max_seq), "v": zeros(max_seq),
                        "xk": zeros(cfg.audio_frames),
                        "xv": zeros(cfg.audio_frames)}
                       for _ in range(cfg.n_layers)],
            "pos": 0}
