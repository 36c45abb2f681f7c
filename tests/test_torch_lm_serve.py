"""The port's language models served on the CPU, against the reference
package: all ten architectures' ``smoke()`` configs.

The reference initialises each config; its parameter tree is perturbed with
seeded noise (norm weights, biases, the SSM's decay, skip and dt bias, the
vision gates: at initialisation they are 1, 0 and 0, which would hide a
dropped bias, a transposed norm or an invisible cross-attention) and carried
to the port (``core.carry.model_params_from_numpy``). The same seeded numpy
tokens, vision patches and audio frames go through both packages:
``forward_train`` logits and aux, ``loss``, ``prefill`` logits and cache,
and three teacher-forced ``decode`` steps' logits and cache. The port's own
invariant is checked too: prefill on a prefix, then decode the rest of the
tokens one by one, gives the forward's logits at those positions.

Tolerances, as in ``tests/test_torch_models.py``: both packages run bf16
activations with fp32 statistics but round at different places (the
port's prefill attention scales q before the dot; sums run in other
orders), so they differ by bf16 rounding that accumulates over the smoke
depth (2 to 4 layers). Logits and cache tensors must agree within 2^-5 of
the reference's largest magnitude; the loss within 2^-8 of it; the MoE aux
loss within 2^-5 of it. The teacher-forced
invariant within 5e-2 of the largest logit, the bound of the reference's
own invariant (``tests/test_models_smoke.py``) made relative, which
``chip_smoke.py`` holds at full width too: the forward runs the attention
kernel's plain version, the decode steps the direct path, which round the
scores and the softmax numerators differently, and a mixture-of-experts
token at a near tie between two experts may route otherwise in the two. Mixture-of-experts
models run it at a capacity that drops nothing (``capacity_factor = E /
k``): at the served capacity a slot's fate depends on which tokens share
its batch row, so a forward over all the tokens and a decode of one token
differ by design wherever an expert overflows.

Mixture-of-experts models are compared with the reference under the
reference's expert choices (:func:`same_routing`): where a token's k-th and
(k+1)-th router probabilities lie within the two packages' bf16 rounding of
the layer's input, either choice is right and the outputs differ by a whole
expert. The port routes by its own probabilities otherwise: the weights,
the capacity dispatch, the combine and the aux loss are its own. Every
token whose own choice differs from the reference's must lie at such a near
tie (margin under 2^-7 of the largest probability). On identical inputs the
port's routing itself is held to the reference's in
``tests/test_torch_lm_modules.py``.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import audio as ra
from repro.models import transformer as rt
from repro.models.api import model_api as ref_model_api
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.carry import model_params_from_numpy
from repro_torch.launch.step import make_decode_step, make_prefill_step
from repro_torch.models import audio as ta
from repro_torch.models import transformer as tt
from repro_torch.models.api import active_params, count_params, model_api

torch.set_num_threads(1)

ARCHS = sorted(REGISTRY)
B, S, MAX_SEQ = 2, 16, 20
LOGITS, LOSS, FORCED = 2.0 ** -5, 2.0 ** -8, 5e-2

# leaf name -> how the perturbation moves it
_SCALE = ("w", "qn", "kn", "norm_w", "d_skip")
_SHIFT = ("b", "bq", "bk", "bv", "b1", "b2", "conv_bias_x", "conv_bias_b",
          "conv_bias_c", "dt_bias", "a_log")
_GATES = ("gate_a", "gate_m")


def perturb(tree, seed: int):
    """The reference's numpy tree with its initial constants moved: norm
    weights and skips scaled by U(0.5, 1.5), biases, dt bias and a_log
    shifted by N(0, 0.1^2), the vision gates set to U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        name = getattr(path[-1], "key", None)
        a = np.asarray(a, dtype=np.float32)
        if name in _SCALE:
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in _SHIFT:
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if name in _GATES:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(move, tree)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale, (what, err, scale, rel)


def _index(tree, idx):
    return jax.tree.map(lambda a: np.asarray(a)[idx], tree)


def ref_cache_layers(cfg, layers) -> list:
    """The reference's stacked cache layers as the port's per-layer list."""
    fam = cfg.family
    if fam == "moe" and cfg.moe.every > 1:
        nb, per = tt.n_blocks(cfg), cfg.moe.every - 1
        return [{"dense": [_index(layers["dense"], (i, j))
                           for j in range(per)],
                 "moe": _index(layers["moe"], (i,))} for i in range(nb)]
    if fam == "vlm":
        nb, per = tt.n_blocks(cfg), cfg.cross_attn_every - 1
        return [{"self": [_index(layers["self"], (i, j)) for j in range(per)],
                 "xk": np.asarray(layers["xk"])[i],
                 "xv": np.asarray(layers["xv"])[i]} for i in range(nb)]
    n = len(jax.tree.leaves(layers)[0])
    return [_index(layers, (i,)) for i in range(n)]


def _compare_tree(got, want, rel, path="cache"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _compare_tree(got[k], want[k], rel, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare_tree(g, w, rel, f"{path}[{i}]")
    else:
        _close(got, want, rel, path)


def _batch(cfg, bsz, seq, seed):
    """Seeded numpy inputs as (reference batch, port batch)."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (bsz, seq)),
              "targets": rng.integers(0, cfg.vocab_size, (bsz, seq))}
    if cfg.family == "vlm":
        arrays["patches"] = rng.standard_normal(
            (bsz, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "audio":
        arrays["frames"] = rng.standard_normal(
            (bsz, cfg.audio_frames, cfg.d_model)).astype(np.float32)
    rb, tb = {}, {}
    for k, a in arrays.items():
        if a.dtype == np.float32:
            rb[k] = jnp.asarray(a, jnp.bfloat16)
            tb[k] = torch.from_numpy(a).to(torch.bfloat16)
        else:
            rb[k] = jnp.asarray(a, jnp.int32)
            tb[k] = torch.from_numpy(a)
    return rb, tb


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(reference cfg, port cfg, reference params, port params), both from
    one perturbed tree."""
    rcfg = ref_get_config(request.param).smoke()
    cfg = get_config(request.param).smoke()
    tree = perturb(ref_model_api(rcfg).init(jax.random.PRNGKey(3)), seed=4)
    rparams = jax.tree.map(jnp.asarray, tree)
    tparams = model_params_from_numpy(cfg, tree, device="cpu")
    return rcfg, cfg, rparams, tparams


@contextlib.contextmanager
def same_routing(cfg):
    """While active, every reference MoE layer call records its expert
    choice, and the port's ``moe.route`` takes the recorded choices in call
    order (the port's probabilities, weights renormalised over the chosen
    experts, its own aux loss). Yields the list of tokens (call, row,
    position, reference margin) where the port's own choice differed."""
    import repro.models.moe as rmoe
    from repro_torch.models import moe as tmoe
    ref_apply, port_route = rmoe.apply_moe, tmoe.route
    recorded, flips, calls = [], [], [0]

    def ref_wrap(p, x, mcfg):
        logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                            p["router"].astype(jnp.float32))
        probs = jax.nn.softmax(logits, axis=-1)
        _, top_e = jax.lax.top_k(probs, mcfg.top_k)
        # the layers run inside a scan: record through a host callback
        jax.debug.callback(
            lambda te, pr: recorded.append((np.asarray(te), np.asarray(pr))),
            top_e, probs, ordered=True)
        return ref_apply(p, x, mcfg)

    def port_wrap(p, x, mcfg):
        probs, _, own_e, _ = port_route(p, x, mcfg)
        want_e, want_p = recorded[calls[0]]
        k, e = mcfg.top_k, mcfg.n_experts
        srt = -np.sort(-want_p, axis=-1)
        margin = srt[..., k - 1] - srt[..., k]
        same = np.sort(own_e.numpy(), -1) == np.sort(want_e, -1)
        for bi, si in zip(*np.nonzero(~same.all(-1))):
            flips.append((calls[0], int(bi), int(si), float(margin[bi, si]),
                          float(want_p.max())))
        calls[0] += 1
        top_e = torch.from_numpy(want_e.copy()).long()
        top_w = torch.gather(probs, -1, top_e)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        b, s, _ = x.shape
        f_e = torch.bincount(top_e.reshape(-1), minlength=e).float() \
            / (b * s * k)
        aux = mcfg.aux_loss_weight * e * (f_e * probs.mean(dim=(0, 1))).sum()
        return probs, top_w, top_e, aux

    rmoe.apply_moe, tmoe.route = ref_wrap, port_wrap
    try:
        yield flips
    finally:
        rmoe.apply_moe, tmoe.route = ref_apply, port_route
    assert calls[0] == len(recorded), (calls[0], len(recorded))
    for call, bi, si, margin, top in flips:
        assert margin <= 2.0 ** -7 * top, (call, bi, si, margin, top)


def _ref_mod(cfg):
    return ra if cfg.family == "audio" else rt


def _extra(cfg, batch):
    if cfg.family == "vlm":
        return {"patches": batch["patches"]}
    if cfg.family == "audio":
        return {"frames": batch["frames"]}
    return None


@pytest.mark.parametrize("name", ARCHS)
def test_param_counts_match_reference(name):
    from repro.models.api import active_params as ref_active
    from repro.models.api import count_params as ref_count
    cfg = get_config(name).smoke()
    assert count_params(cfg) == ref_count(ref_get_config(name).smoke())
    assert active_params(cfg) == ref_active(ref_get_config(name).smoke())


def test_carried_tree_holds_fp32_where_the_reference_reads_fp32(arch):
    """Norms, the router, the SSM's conv taps and scalars and the vision
    gates stay fp32; matrices become bf16; an untied head is carried."""
    _, cfg, _, tparams = arch
    assert ("head" in tparams["embed"]) == (not cfg.tie_embeddings)
    fp32 = {"w", "b", "qn", "kn", "router", "conv_x", "conv_b", "conv_c",
            "conv_bias_x", "conv_bias_b", "conv_bias_c", "a_log", "d_skip",
            "dt_bias", "norm_w", "gate_a", "gate_m"}

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, list):
                for x in v:
                    walk(x)
            else:
                want = torch.float32 if k in fp32 else torch.bfloat16
                assert v.dtype == want, (k, v.dtype)
    walk(tparams)


def test_forward_train_logits_and_aux(arch):
    rcfg, cfg, rparams, tparams = arch
    rb, tb = _batch(cfg, B, S, seed=1)
    mod = ta if cfg.family == "audio" else tt
    with same_routing(cfg), torch.no_grad():
        want, raux = _ref_mod(rcfg).forward_train(
            rparams, rcfg, rb["tokens"], extra=_extra(rcfg, rb), remat=False)
        got, aux = mod.forward_train(tparams, cfg, tb["tokens"],
                                     extra=_extra(cfg, tb))
    assert got.dtype == torch.bfloat16
    _close(got, want, LOGITS, "logits")
    assert aux.dtype == torch.float32 and aux.dim() == 0
    if cfg.family == "moe":
        assert float(raux) > 0
        assert abs(float(aux) - float(raux)) <= LOGITS * float(raux)
    else:
        assert float(aux) == float(raux) == 0.0


def test_loss(arch):
    rcfg, cfg, rparams, tparams = arch
    rb, tb = _batch(cfg, B, S, seed=2)
    mask = np.arange(S)[None, :] < np.array([[S], [S // 2]])
    rb["mask"], tb["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    with same_routing(cfg):
        want, wm = ref_model_api(rcfg).loss(rparams, rb, remat=False)
        got, gm = model_api(cfg).loss(tparams, tb)
    for g, w in ((got, want), (gm["xent"], wm["xent"])):
        assert g.dtype == torch.float32
        assert abs(float(g) - float(w)) <= LOSS * abs(float(w))
    assert abs(float(gm["aux"]) - float(wm["aux"])) \
        <= LOGITS * abs(float(wm["aux"]))


def test_prefill_and_decode_steps(arch):
    """Prefill at MAX_SEQ, then three decode steps of given tokens: logits
    and every cache tensor against the reference's, after each step."""
    rcfg, cfg, rparams, tparams = arch
    rb, tb = _batch(cfg, B, S, seed=3)
    rapi, api = ref_model_api(rcfg), model_api(cfg)
    steps = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, B, 1))
    with same_routing(cfg), torch.no_grad():
        want, rcache = rapi.prefill(rparams, rb, max_seq=MAX_SEQ)
        got, cache = api.prefill(tparams, tb, max_seq=MAX_SEQ)
        assert cache["pos"] == int(rcache["pos"]) == S
        assert isinstance(cache["pos"], int)
        _close(got, want, LOGITS, "prefill logits")
        _compare_tree(cache["layers"],
                      ref_cache_layers(rcfg, rcache["layers"]), LOGITS)
        for i, tok in enumerate(steps):
            want, rcache = rapi.decode(rparams, rcache,
                                       jnp.asarray(tok, jnp.int32))
            got, cache = api.decode(tparams, cache, torch.from_numpy(tok))
            assert cache["pos"] == int(rcache["pos"]) == S + 1 + i
            _close(got, want, LOGITS, f"decode {i} logits")
            _compare_tree(cache["layers"],
                          ref_cache_layers(rcfg, rcache["layers"]), LOGITS,
                          f"decode {i} cache")


def test_init_cache_matches_reference_layout(arch):
    rcfg, cfg, _, _ = arch
    want = ref_cache_layers(
        rcfg, ref_model_api(rcfg).init_cache(B, MAX_SEQ)["layers"])
    got = model_api(cfg).init_cache(B, MAX_SEQ, device="cpu")
    assert got["pos"] == 0
    _compare_tree(got["layers"], want, 0.0)


def _no_drop(cfg):
    """The config at a capacity that drops no slot (see the docstring)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def test_teacher_forced_decode_reproduces_the_forward(arch):
    """Prefill on the first 4 tokens, decode the other S - 4 one by one:
    the prefill's and every step's logits equal the forward's at those
    positions."""
    _, cfg, _, tparams = arch
    cfg = _no_drop(cfg)
    _, tb = _batch(cfg, B, S, seed=6)
    api = model_api(cfg)
    mod = ta if cfg.family == "audio" else tt
    with torch.no_grad():
        full, _ = mod.forward_train(tparams, cfg, tb["tokens"],
                                    extra=_extra(cfg, tb))
        pre = dict(tb, tokens=tb["tokens"][:, :4])
        logits, cache = make_prefill_step(cfg, max_seq=S)(tparams, pre)
        got = [logits]
        step = make_decode_step(cfg)
        for i in range(4, S):
            logits, cache = step(tparams, cache, tb["tokens"][:, i:i + 1])
            got.append(logits)
    got = torch.stack(got, dim=1)
    _close(got, full[:, 3:], FORCED, "teacher-forced logits")
    assert cache["pos"] == S
    if cfg.family != "ssm":                 # an SSM state has no length
        with pytest.raises(ValueError, match="full"):
            step(tparams, cache, tb["tokens"][:, :1])
