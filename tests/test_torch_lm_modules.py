"""The language models' new modules against the reference package, on the
CPU, one module at a time on identical inputs: the mixture-of-experts layer
(routing, capacity dispatch with overflow, the shared expert, the aux loss),
the SSD scan and the Mamba2 conv, windowed self-attention in prefill and in
decode past the window, cross-attention and the padded output head.

Tolerances (see ``tests/test_torch_models.py``): a module within 2^-6 of
the reference output's largest magnitude; fp32 modules that round nowhere
(the one-token conv step, the SSD decode update) within 2^-20 of it.
Mixture of experts: the router is fp32 on both sides, so its
probabilities differ only by fp32 summation order; a token whose k-th and
(k+1)-th probabilities lie within that band (1e-6) may pick another expert,
and with it every later slot of its batch row may take another capacity
position. Rows holding such a token are left out of the element-wise
comparison, and such tokens must be under 1% of all.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as rc
from repro.models import moe as rmoe
from repro.models import ssm as rssm
from repro_torch.configs import get_config
from repro_torch.models import common as tc
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

MODULE = 2.0 ** -6
FP32 = 2.0 ** -20
BAND = 1e-6


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err, rel)


def _x(shape, seed, scale=1.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _tree(params_np, fp32=()):
    """numpy leaves -> (reference fp32 tree, port tree: bf16 but ``fp32``)."""
    ref = jax.tree.map(jnp.asarray, params_np)

    def conv(path, a):
        name = getattr(path[-1], "key", None)
        t = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
        return t if name in fp32 else t.to(torch.bfloat16)
    port = jax.tree_util.tree_map_with_path(conv, params_np)
    return ref, port


# ------------------------------------------------------------------- MoE
MOE_CASES = [("olmoe-1b-7b", 1.25), ("olmoe-1b-7b", 0.5),
             ("llama4-maverick-400b-a17b", 1.25),
             ("llama4-maverick-400b-a17b", 0.5)]


@pytest.mark.parametrize("arch,factor", MOE_CASES)
def test_apply_moe_matches_reference(arch, factor):
    """Top-2 of 8 (olmoe) and top-1 of 8 with the shared expert (llama4),
    at the served capacity and at half of it, where slots overflow."""
    cfg = dataclasses.replace(get_config(arch).smoke().moe,
                              capacity_factor=factor)
    rcfg = dataclasses.replace(ref_get_config(arch).smoke().moe,
                               capacity_factor=factor)
    d, b, s = 64, 4, 64
    tree = jax.tree.map(np.asarray,
                        rmoe.init_moe(jax.random.PRNGKey(1), d, rcfg))
    # a wider router than at initialisation, so that routing is not flat
    tree["router"] = tree["router"] * 20.0
    rp, tp = _tree(tree, fp32=("router",))
    jx, tx = _x((b, s, d), seed=2)
    want, waux = rmoe.apply_moe(rp, jx, rcfg)
    stats = {}
    got, aux = tmoe.apply_moe(tp, tx, cfg, stats)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32

    probs, _, top_e, _ = tmoe.route(tp, tx, cfg)
    srt = -np.sort(-probs.numpy(), axis=-1)
    k = cfg.top_k
    near = srt[..., k - 1] - srt[..., k] <= BAND          # (B, S)
    assert near.sum() <= 0.01 * b * s, int(near.sum())
    rows = ~near.any(-1)
    assert rows.any()
    _close(got[torch.from_numpy(rows)], np.asarray(
        want.astype(jnp.float32))[rows], MODULE, "moe out")
    assert abs(float(aux) - float(waux)) <= FP32 * 16 * float(waux)

    # the dispatch's own accounting: slots over capacity, per row as there
    cap = tmoe.capacity(s, cfg)
    assert cap == int(max(1, round(s * k / cfg.n_experts * factor)))
    per = np.stack([np.bincount(r, minlength=cfg.n_experts)
                    for r in top_e.reshape(b, -1).numpy()])
    assert stats["slots"] == b * s * k
    assert stats["dropped"] == int(np.maximum(per - cap, 0).sum())
    if factor < 1:
        assert stats["dropped"] > 0


def test_moe_router_and_conv_taps_stay_fp32_when_initialised():
    cfg = get_config("olmoe-1b-7b").smoke()
    p = tmoe.init_moe(torch.Generator().manual_seed(0), 64, cfg.moe)
    assert p["router"].dtype == torch.float32
    assert p["w1"].shape == (8, 64, 64) and p["w1"].dtype == torch.bfloat16
    s = tssm.init_ssm(torch.Generator().manual_seed(0), 64,
                      get_config("mamba2-2.7b").smoke().ssm)
    assert all(s[n].dtype == torch.float32 for n in
               ("conv_x", "conv_b", "conv_c", "conv_bias_x", "a_log",
                "d_skip", "dt_bias", "norm_w"))


# ------------------------------------------------------------------- SSM
def _ssm_tree(cfg, seed):
    tree = jax.tree.map(np.asarray, rssm.init_ssm(jax.random.PRNGKey(seed),
                                                  64, cfg))
    rng = np.random.default_rng(seed)
    for name in ("conv_bias_x", "conv_bias_b", "conv_bias_c", "dt_bias",
                 "a_log"):
        tree[name] = tree[name] + 0.3 * rng.standard_normal(
            tree[name].shape).astype(np.float32)
    for name in ("d_skip", "norm_w"):
        tree[name] = tree[name] * rng.uniform(0.5, 1.5, tree[name].shape) \
            .astype(np.float32)
    return _tree(tree, fp32=("conv_x", "conv_b", "conv_c", "conv_bias_x",
                             "conv_bias_b", "conv_bias_c", "a_log", "d_skip",
                             "dt_bias", "norm_w"))


@pytest.mark.parametrize("s,chunk", [(20, 8), (8, 8), (5, 8), (37, 16)])
def test_ssd_chunked_matches_reference(s, chunk):
    """S a multiple of the chunk, not one, and shorter than one chunk."""
    b, h, p, g, n = 2, 4, 8, 1, 16
    rng = np.random.default_rng(s + chunk)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    bi = rng.standard_normal((b, s, g, n)).astype(np.float32)
    ci = rng.standard_normal((b, s, g, n)).astype(np.float32)
    a = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    want_y, want_st = rssm.ssd_chunked(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(bi,
                                                                   jnp.bfloat16),
        jnp.asarray(ci, jnp.bfloat16), jnp.asarray(a), chunk=chunk)
    bf = torch.bfloat16
    got_y, got_st = tssm.ssd_chunked(
        torch.from_numpy(x).to(bf), torch.from_numpy(dt),
        torch.from_numpy(bi).to(bf), torch.from_numpy(ci).to(bf),
        torch.from_numpy(a), chunk=chunk)
    assert got_y.dtype == got_st.dtype == torch.float32
    _close(got_y, want_y, MODULE, "y")
    _close(got_st, want_st, MODULE, "state")


def test_causal_conv_and_conv_step_match_reference():
    """The whole-sequence conv in bf16, the one-token step in fp32 with the
    fp32 taps; stepping the window through a sequence gives the whole
    conv."""
    c, k, b, s = 48, 4, 2, 9
    rng = np.random.default_rng(0)
    w = (0.1 * rng.standard_normal((k, c))).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    u = rng.standard_normal((b, s, c)).astype(np.float32)
    ju, tu = jnp.asarray(u, jnp.bfloat16), torch.from_numpy(u).to(
        torch.bfloat16)
    _close(tssm._causal_conv(tu, torch.from_numpy(w), torch.from_numpy(bias)),
           rssm._causal_conv(ju, jnp.asarray(w), jnp.asarray(bias)),
           2.0 ** -7, "causal conv")
    window = np.zeros((b, k - 1, c), np.float32)
    jw, tw = jnp.asarray(window, jnp.bfloat16), torch.from_numpy(window).to(
        torch.bfloat16)
    for t in range(s):
        want, jw = rssm._conv_step(ju[:, t], jw, jnp.asarray(w),
                                   jnp.asarray(bias))
        got, tw = tssm._conv_step(tu[:, t], tw, torch.from_numpy(w),
                                  torch.from_numpy(bias))
        assert got.dtype == torch.float32
        _close(got, want, FP32, f"conv step {t}")
        _close(tw, jw, 0.0, f"window {t}")


def test_apply_ssm_prefill_then_decode_matches_reference():
    cfg = get_config("mamba2-2.7b").smoke().ssm
    rp, tp = _ssm_tree(cfg, seed=3)
    jx, tx = _x((2, 11, 64), seed=4)
    want, wst = rssm.apply_ssm(rp, jx[:, :8], cfg)
    got, st = tssm.apply_ssm(tp, tx[:, :8], cfg)
    _close(got, want, MODULE, "prefill")
    for name in ("cx", "cb", "cc", "ssm"):
        _close(st[name], wst[name], MODULE, name)
    for t in range(8, 11):
        want, wst = rssm.apply_ssm(rp, jx[:, t:t + 1], cfg, state=wst)
        got, st = tssm.apply_ssm(tp, tx[:, t:t + 1], cfg, state=st)
        _close(got, want, MODULE, f"decode {t}")
        _close(st["ssm"], wst["ssm"], MODULE, f"state {t}")
    zero = tssm.init_state(2, 64, cfg, device=torch.device("cpu"))
    ref_zero = rssm.init_state(2, 64, cfg)
    for name in zero:
        assert tuple(zero[name].shape) == ref_zero[name].shape
        assert str(zero[name].dtype).split(".")[-1] == str(
            ref_zero[name].dtype)


# ------------------------------------------------------------- attention
def _attn(window, causal=True, heads=(4, 2)):
    h, kv = heads
    spec_r = rc.AttnSpec(n_heads=h, n_kv_heads=kv, head_dim=16, d_model=64,
                         causal=causal, window=window, bias=True)
    spec_t = tc.AttnSpec(n_heads=h, n_kv_heads=kv, head_dim=16, d_model=64,
                         causal=causal, window=window, bias=True)
    tree = jax.tree.map(np.asarray, rc.init_attention(
        jax.random.PRNGKey(5), spec_r))
    rng = np.random.default_rng(6)
    for name in ("bq", "bk", "bv"):
        tree[name] = (0.3 * rng.standard_normal(tree[name].shape)).astype(
            np.float32)
    rp, tp = _tree(tree)
    return spec_r, spec_t, rp, tp


@pytest.mark.parametrize("window,causal", [(5, True), (None, True),
                                           (None, False), (1, True)])
def test_self_attention_prefill_then_decode_past_the_window(window, causal):
    """Prefill 12 tokens, then decode 6 more one by one into a cache of 20:
    with a window of 5 every decode step lies past it."""
    spec_r, spec_t, rp, tp = _attn(window, causal)
    b, s0, total, max_seq = 2, 12, 18, 20
    jx, tx = _x((b, total, 64), seed=7)
    pos_r = jnp.broadcast_to(jnp.arange(s0, dtype=jnp.int32)[None], (b, s0))
    pos_t = torch.arange(s0, dtype=torch.int32).expand(b, s0)
    want, wkv = rc.self_attention(rp, spec_r, jx[:, :s0], pos_r)
    got, kv = tc.self_attention(tp, spec_t, tx[:, :s0], pos_t)
    _close(got, want, MODULE, "prefill")
    wcache = {n: jnp.pad(wkv[n], ((0, 0), (0, max_seq - s0), (0, 0),
                                  (0, 0))) for n in ("k", "v")}
    cache = {n: torch.zeros(b, max_seq, *kv[n].shape[2:],
                            dtype=torch.bfloat16) for n in ("k", "v")}
    for n in ("k", "v"):
        cache[n][:, :s0] = kv[n]
    for t in range(s0, total):
        want, wcache = rc.self_attention(
            rp, spec_r, jx[:, t:t + 1], jnp.full((b, 1), t, jnp.int32),
            cache={**wcache, "pos": jnp.asarray(t, jnp.int32)})
        got, cache = tc.self_attention(
            tp, spec_t, tx[:, t:t + 1],
            torch.full((b, 1), t, dtype=torch.int32),
            cache={**cache, "pos": t})
        _close(got, want, MODULE, f"decode at {t}")
        for n in ("k", "v"):
            _close(cache[n], wcache[n], MODULE, f"cache {n} at {t}")


def test_cross_attention_matches_reference():
    spec_r, spec_t, rp, tp = _attn(None, causal=False, heads=(4, 1))
    jx, tx = _x((2, 6, 64), seed=8)
    jm, tm = _x((2, 13, 64), seed=9)
    want = rc.cross_attention(rp, spec_r, jx, jm)
    _close(tc.cross_attention(tp, spec_t, tx, tm), want, MODULE, "cross")
    k, v = tc.cross_kv(tp, spec_t, tm)
    _close(tc.cross_attention(tp, spec_t, tx, k=k, v=v), want, MODULE,
           "cross, cached k/v")


@pytest.mark.parametrize("tie", [True, False])
def test_unembed_pads_with_minus_1e30(tie):
    """A vocabulary off the 128 alignment: the padded columns get -1e30
    added in bf16, the live ones equal the reference's product."""
    vocab, d = 250, 64
    tree = jax.tree.map(np.asarray, rc.init_embed(jax.random.PRNGKey(2),
                                                  vocab, d, tie))
    rp, tp = _tree(tree)
    assert ("head" in tp) == (not tie)
    jx, tx = _x((2, 3, d), seed=10)
    want = rc.unembed(rp, jx, vocab)
    got = tc.unembed(tp, tx, vocab)
    assert got.shape == (2, 3, tc.padded_vocab(vocab)) == want.shape
    assert got.dtype == torch.bfloat16
    _close(got[..., :vocab], want[..., :vocab], MODULE, "live logits")
    np.testing.assert_array_equal(_np(got[..., vocab:]),
                                  _np(want[..., vocab:]))
    assert float(got[..., vocab:].max()) < -1e29
