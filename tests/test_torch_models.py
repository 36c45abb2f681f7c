"""The port's dense decoder against the reference package, on the CPU, and
every architecture's config.

The reference initialises each dense architecture's ``smoke()`` config; its
fp32 parameters go to the port through ``core.carry.model_params_from_numpy``
(matrices as bf16, the value the reference casts them to at every product),
and the same seeded numpy inputs go through both packages, module by module
and through ``api.embed``. The four dense configs cover rmsnorm and
layernorm, swiglu and gelu-tanh, qkv bias, qk-norm and grouped-query heads.

Tolerances. Both packages run bf16 activations with fp32 statistics, but
round at slightly different places (the port's attention scales q before the
dot, the reference scales the scores after it; matmul and reduction orders
differ), so results differ by bf16 rounding. An element-wise op (embedding
lookup) must be exact; a norm or a rotation, computed in fp32 and rounded
once, within one bf16 ulp (2^-7 relative); products and layers, whose fp32
sums round once at the end but whose inputs may already differ by an ulp,
within 2^-6 of the output's largest magnitude; the whole forward (2 to 4
layers and the mean pool) within 2^-5 of it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as rc
from repro.models import transformer as rt
from repro.models.api import model_api as ref_model_api
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.carry import model_params_from_numpy
from repro_torch.models import common as tc
from repro_torch.models import transformer as tt
from repro_torch.models.api import model_api

torch.set_num_threads(1)

DENSE = sorted(n for n, c in REGISTRY.items() if c.family == "dense")
B, S = 2, 24


@pytest.fixture(scope="module", params=DENSE)
def arch(request):
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg = ref_get_config(request.param).smoke()
    cfg = get_config(request.param).smoke()
    rparams = ref_model_api(rcfg).init(jax.random.PRNGKey(3))
    tparams = model_params_from_numpy(cfg, jax.tree.map(np.asarray, rparams),
                                      device="cpu")
    return rcfg, cfg, rparams, tparams


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


def _layer0(rparams, tparams):
    return jax.tree.map(lambda a: a[0], rparams["layers"]), \
        tparams["layers"][0]


def _positions():
    return jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S)), \
        torch.arange(S, dtype=torch.int32).expand(B, S)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_configs_match_reference(name):
    for ours, theirs in ((get_config(name), ref_get_config(name)),
                         (get_config(name).smoke(),
                          ref_get_config(name).smoke())):
        assert set(ours.__dataclass_fields__) \
            == set(theirs.__dataclass_fields__)
        for field in ours.__dataclass_fields__:
            a, b = getattr(ours, field), getattr(theirs, field)
            if dataclasses.is_dataclass(b):      # the MoE and SSM blocks
                assert dataclasses.asdict(a) == dataclasses.asdict(b), field
            else:
                assert a == b, field
        if theirs.moe is not None:
            assert ours.moe.expert_parallel(ours.d_model) \
                == theirs.moe.expert_parallel(theirs.d_model)
        assert ours.resolved_head_dim == theirs.resolved_head_dim
        assert ours.is_encoder_decoder == theirs.is_encoder_decoder


@pytest.mark.parametrize("entry", ["init", "carry"])
def test_model_entry_points_run_on_the_card_unless_asked(entry):
    """With no ``device`` the parameters go to the card: with no card that
    raises, and a generator that is not on the card is refused; with
    ``device="cpu"`` they are built on the host."""
    cfg = get_config("minicpm-2b").smoke()
    api = model_api(cfg)
    if entry == "init":
        def build(**kw):
            return api.init(torch.Generator().manual_seed(0), **kw)
    else:
        tree = jax.tree.map(np.asarray, ref_model_api(
            ref_get_config("minicpm-2b").smoke()).init(jax.random.PRNGKey(0)))

        def build(**kw):
            return model_params_from_numpy(cfg, tree, **kw)
    if torch.cuda.is_available():
        if entry == "init":
            with pytest.raises(ValueError, match="generator"):
                build()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    params = build(device="cpu")
    assert params["layers"][0]["attn"]["wq"].device.type == "cpu"


def test_embed_tokens_and_vocab_padding(arch):
    rcfg, cfg, rparams, tparams = arch
    assert tc.padded_vocab(cfg.vocab_size) == rc.padded_vocab(rcfg.vocab_size)
    assert tparams["embed"]["tok"].shape[0] % tc.VOCAB_ALIGN == 0
    # the output head is carried where it is not tied to the table
    assert set(tparams["embed"]) == ({"tok"} if cfg.tie_embeddings
                                     else {"tok", "head"})
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    want = rc.embed_tokens(rparams["embed"], jnp.asarray(toks))
    got = tc.embed_tokens(tparams["embed"], torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


def test_norms(arch):
    rcfg, cfg, rparams, tparams = arch
    rl, tl = _layer0(rparams, tparams)
    jx, tx = _x((B, S, cfg.d_model), seed=2)
    # non-trivial weights and bias, so that the affine part is checked too
    w = np.random.default_rng(5).uniform(0.5, 1.5, cfg.d_model)
    rp = dict(rl["ln1"], w=jnp.asarray(w, jnp.float32))
    tp = dict(tl["ln1"], w=torch.tensor(w, dtype=torch.float32))
    if "b" in rp:
        rp["b"] = jnp.full((cfg.d_model,), 0.25, jnp.float32)
        tp["b"] = torch.full((cfg.d_model,), 0.25)
    got = tc.apply_norm(tp, tx, cfg.norm, cfg.norm_eps)
    assert got.dtype == torch.bfloat16
    _close(got, rc.apply_norm(rp, jx, rcfg.norm, rcfg.norm_eps), 2.0 ** -7)


def test_rope(arch):
    rcfg, cfg, _, _ = arch
    hd = cfg.resolved_head_dim
    jx, tx = _x((B, S, cfg.n_heads, hd), seed=3)
    jpos, tpos = _positions()
    rcos, rsin = rc.rope_angles(jpos, hd, rcfg.rope_theta)
    tcos, tsin = tc.rope_angles(tpos, hd, cfg.rope_theta)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(rcos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(rsin), atol=1e-6)
    _close(tc.apply_rope(tx, tcos, tsin), rc.apply_rope(jx, rcos, rsin),
           2.0 ** -7)


def test_project_qkv(arch):
    rcfg, cfg, rparams, tparams = arch
    rl, tl = _layer0(rparams, tparams)
    jx, tx = _x((B, S, cfg.d_model), seed=4)
    jpos, tpos = _positions()
    want = rc._project_qkv(rl["attn"], rt.attn_spec(rcfg), jx, jpos)
    got = tc._project_qkv(tl["attn"], tt.attn_spec(cfg), tx, tpos)
    for g, w in zip(got, want):
        _close(g, w, 2.0 ** -6)


def test_self_attention(arch):
    rcfg, cfg, rparams, tparams = arch
    rl, tl = _layer0(rparams, tparams)
    jx, tx = _x((B, S, cfg.d_model), seed=5)
    jpos, tpos = _positions()
    want, _ = rc.self_attention(rl["attn"], rt.attn_spec(rcfg), jx, jpos)
    got, _ = tc.self_attention(tl["attn"], tt.attn_spec(cfg), tx, tpos)
    _close(got, want, 2.0 ** -6)


def test_apply_mlp(arch):
    """swiglu (three configs) or gelu-tanh with biases (starcoder2)."""
    rcfg, cfg, rparams, tparams = arch
    rl, tl = _layer0(rparams, tparams)
    jx, tx = _x((B, S, cfg.d_model), seed=6)
    _close(tc.apply_mlp(tl["mlp"], tx, cfg.mlp),
           rc.apply_mlp(rl["mlp"], jx, rcfg.mlp), 2.0 ** -6)


def test_apply_self_layer(arch):
    rcfg, cfg, rparams, tparams = arch
    rl, tl = _layer0(rparams, tparams)
    jx, tx = _x((B, S, cfg.d_model), seed=7)
    jpos, tpos = _positions()
    want, _, _ = rt.apply_self_layer(rl, rcfg, jx, jpos, use_moe=False)
    got, _, _ = tt.apply_self_layer(tl, cfg, tx, tpos)
    _close(got, want, 2.0 ** -6)


@pytest.mark.parametrize("masked", [False, True])
def test_api_embed(arch, masked):
    rcfg, cfg, rparams, tparams = arch
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (3, 40))
    rbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(toks)}
    if masked:
        mask = np.arange(40)[None, :] < np.array([[40], [17], [1]])
        rbatch["mask"], tbatch["mask"] = jnp.asarray(mask), \
            torch.from_numpy(mask)
    want = ref_model_api(rcfg).embed(rparams, rbatch)
    got = model_api(cfg).embed(tparams, tbatch)
    assert got.dtype == torch.bfloat16 and got.shape == (3, cfg.d_model)
    _close(got, want, 2.0 ** -5)


def test_ingest_embeddings_slice():
    """The slice end to end: the same tokens and parameters through the
    reference's ``NKSEngine.ingest_embeddings`` and the port's. Embeddings
    agree within the forward's tolerance; an engine of the port built over
    the reference's embeddings answers exactly as the reference engine does
    (per-query search and the numpy backend bit for bit, the port's torch
    backend on ids and to 1e-9 in diameter)."""
    from repro.serve.engine import NKSEngine as RefEngine
    from repro_torch.core.types import make_dataset
    from repro_torch.serve.engine import NKSEngine

    rcfg = ref_get_config("minicpm-2b").smoke()
    cfg = get_config("minicpm-2b").smoke()
    rapi, api = ref_model_api(rcfg), model_api(cfg)
    rparams = rapi.init(jax.random.PRNGKey(0))
    tparams = model_params_from_numpy(cfg, jax.tree.map(np.asarray, rparams),
                                      device="cpu")
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, cfg.vocab_size, (4, 16)) for _ in range(4)]
    keywords = [sorted(rng.choice(6, size=2, replace=False).tolist())
                for _ in range(16)]
    ref = RefEngine.ingest_embeddings(
        rapi, rparams, [{"tokens": jnp.asarray(t, jnp.int32)} for t in toks],
        keywords, n_scales=3)
    ours = NKSEngine.ingest_embeddings(api, tparams,
                                       [{"tokens": t} for t in toks],
                                       keywords, device="cpu", n_scales=3)
    assert ours.dataset.points.dtype == np.float32
    assert ours.dataset.points.shape == ref.dataset.points.shape == (16, 64)
    _close(torch.from_numpy(ours.dataset.points), ref.dataset.points,
           2.0 ** -5)

    same = NKSEngine(make_dataset(ref.dataset.points, keywords), n_scales=3,
                     device="cpu")
    queries = [[0, 1], [2, 3, 4], [1, 5], [0, 2, 4, 5]]
    for tier in ("exact", "approx"):
        for q in queries:
            want = ref.query(q, k=2, tier=tier).candidates
            got = same.query(q, k=2, tier=tier).candidates
            assert [(c.ids, c.diameter) for c in got] == \
                [(c.ids, c.diameter) for c in want]
        want = ref.query_batch(queries, k=2, tier=tier, backend="numpy")
        got = same.query_batch(queries, k=2, tier=tier, backend="numpy")
        assert [[(c.ids, c.diameter) for c in r.candidates] for r in got] == \
            [[(c.ids, c.diameter) for c in r.candidates] for r in want]
        dev = same.query_batch(queries, k=2, tier=tier)
        for rd, rw in zip(dev, want):
            assert [c.ids for c in rd.candidates] == \
                [c.ids for c in rw.candidates]
            np.testing.assert_allclose([c.diameter for c in rd.candidates],
                                       [c.diameter for c in rw.candidates],
                                       rtol=1e-9)
