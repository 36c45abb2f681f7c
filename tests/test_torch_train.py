"""The port's training stack against the reference package, on the CPU:
schedules, AdamW, the train step, the token pipeline, checkpoints (across
packages), the fault-tolerant loop, the launcher and the carried state.

Inputs are seeded numpy arrays handed to both packages. Tolerances:

  * ``lr_at``: 1e-6 relative. Both compute the schedule in fp32 from the
    same fp32 roundings of the config's scalars; cos and sqrt may differ by
    an ulp between XLA's and torch's libraries.
  * ``adamw_update`` on a smoke model's tree with random gradients and
    moments: parameters and fp32 moments within 1e-6 of the leaf's largest
    magnitude (the global norm sums leaves in another order, and XLA may
    fuse a multiply-add); bf16 moments within one bf16 ulp of the
    reference's value (an fp32 difference of 1e-6 may round either way)
    plus the same 1e-6 of the leaf's largest magnitude (where m b1 and
    g (1 - b1) cancel, that fp32 difference is many ulps of the result).
  * ``make_train_step``: the loss within 2^-8, the gradient norm within
    2^-4 (the per-leaf gradient tolerance of ``test_torch_train_grads``),
    the moments within 2^-4 of each leaf's norm plus 2^-10 of the largest.
    The first AdamW step moves each parameter by about lr times the sign of
    its gradient, so where a gradient lies near 0 the two packages may move
    it by up to 2 lr in opposite directions: each parameter within 2 lr
    (plus 1e-6 of its leaf's largest magnitude) of the reference's, and
    each leaf's step within 1/4 of the reference's step in norm.
  * The token pipeline: bit for bit.

Checkpoints, the loop and the launcher are in ``test_torch_train_loop.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.token_pipeline import PipelineConfig as RefPipelineConfig
from repro.data.token_pipeline import TokenPipeline as RefTokenPipeline
from repro.launch.step import make_train_step as ref_make_train_step
from repro.models.api import model_api as ref_model_api
from repro.train import optimizer as ropt
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.carry import (model_params_from_numpy,
                                    model_params_to_numpy,
                                    opt_state_from_numpy, opt_state_to_numpy)
from repro_torch.data.token_pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.step import make_train_step
from repro_torch.train import optimizer as topt
from test_torch_lm_serve import _batch, perturb
from test_torch_train_grads import port_grads

torch.set_num_threads(1)


# ------------------------------------------------------------- schedules
@pytest.mark.parametrize("schedule", ["wsd", "cosine"])
def test_lr_schedule_matches_reference(schedule):
    for cfg_kw in (dict(peak_lr=3e-4, warmup_steps=10, total_steps=100,
                        decay_frac=0.2, min_lr_frac=0.1),
                   dict(peak_lr=1.0, warmup_steps=5, total_steps=37,
                        decay_frac=0.3, min_lr_frac=0.0)):
        rcfg = ropt.OptimizerConfig(schedule=schedule, **cfg_kw)
        cfg = topt.OptimizerConfig(schedule=schedule, **cfg_kw)
        for step in range(0, cfg.total_steps + 3):
            want = float(ropt.lr_at(rcfg, step))
            got = topt.lr_at(cfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.dim() == 0
            assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-30)


def _tree_and_grads(seed: int):
    """A smoke model's reference tree, random gradients and moments."""
    rcfg = ref_get_config("minicpm-2b").smoke()
    tree = jax.tree.map(np.asarray,
                        ref_model_api(rcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def noise(a, scale):
        return (scale * rng.standard_normal(a.shape)).astype(np.float32)
    grads = jax.tree.map(lambda a: noise(a, 1e-2), tree)
    m = jax.tree.map(lambda a: noise(a, 1e-3), tree)
    v = jax.tree.map(lambda a: np.abs(noise(a, 1e-4)), tree)
    return get_config("minicpm-2b").smoke(), tree, grads, m, v


def _ulp_bf16(a: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    cfg, tree, grads, m, v = _tree_and_grads(seed=2)
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
              state_dtype=state_dtype, clip_norm=0.5)
    rcfg, ocfg = ropt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    rdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    rstate = {"m": jax.tree.map(lambda a: jnp.asarray(a, rdt), m),
              "v": jax.tree.map(lambda a: jnp.asarray(a, rdt), v),
              "step": jnp.asarray(3, jnp.int32)}
    want_p, want_s, want_om = ropt.adamw_update(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, grads),
        rstate, rcfg)

    params = model_params_from_numpy(cfg, tree, device="cpu", master=True)
    tgrads = model_params_from_numpy(cfg, grads, device="cpu", master=True)
    state = opt_state_from_numpy(cfg, jax.tree.map(np.asarray, rstate),
                                 device="cpu")
    assert state["m"]["embed"]["tok"].dtype == topt.state_dtype(ocfg)
    got_p, got_s, om = topt.adamw_update(params, tgrads, state, ocfg)
    assert got_p is params and got_s is state          # updated in place
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 4
    assert int(want_s["step"]) == 4
    for name in ("lr", "grad_norm"):
        assert abs(float(om[name]) - float(want_om[name])) \
            <= 1e-6 * abs(float(want_om[name]))

    def close(got, want, bf16):
        got = model_params_to_numpy(got)
        want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree.leaves(got)):
            bound = 1e-6 * np.abs(w).max() + (_ulp_bf16(w) if bf16 else 0)
            assert (np.abs(g - w) <= bound).all(), path
    close(params, want_p, False)
    close(state["m"], want_s["m"], state_dtype == "bfloat16")
    close(state["v"], want_s["v"], state_dtype == "bfloat16")


def test_init_opt_state_matches_reference():
    cfg, tree, *_ = _tree_and_grads(seed=1)
    ocfg = topt.OptimizerConfig(state_dtype="bfloat16")
    params = model_params_from_numpy(cfg, tree, device="cpu", master=True)
    state = topt.init_opt_state(params, ocfg)
    want = ropt.init_opt_state(tree, ropt.OptimizerConfig(
        state_dtype="bfloat16"))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    got = opt_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(got["m"]), jax.tree.leaves(want["m"])):
        assert a.shape == b.shape and not a.any()
    assert all(t.dtype == torch.bfloat16
               for t in topt.tree_leaves(state["v"]))


# ------------------------------------------------------------ train step
def test_train_step_matches_reference():
    name = "minicpm-2b"
    rcfg, cfg = ref_get_config(name).smoke(), get_config(name).smoke()
    tree = jax.tree.map(np.asarray, perturb(
        ref_model_api(rcfg).init(jax.random.PRNGKey(5)), seed=6))
    kw = dict(total_steps=10, warmup_steps=2, schedule="wsd",
              peak_lr=1e-3)
    rocfg, ocfg = ropt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    rb, tb = _batch(cfg, 2, 16, seed=7)
    rparams = jax.tree.map(jnp.asarray, tree)
    want_p, want_s, want_m = ref_make_train_step(rcfg, rocfg)(
        rparams, ropt.init_opt_state(rparams, rocfg), rb)

    params = model_params_from_numpy(cfg, tree, device="cpu", master=True)
    state = topt.init_opt_state(params, ocfg)
    got_p, got_s, got_m = make_train_step(cfg, ocfg)(params, state, tb)
    assert set(got_m) == {"loss", "xent", "aux", "lr", "grad_norm"}
    assert set(got_m) == set(want_m)
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) \
        <= 2.0 ** -8 * float(want_m["loss"])
    assert abs(float(got_m["lr"]) - float(want_m["lr"])) \
        <= 1e-6 * float(want_m["lr"])
    assert abs(float(got_m["grad_norm"]) - float(want_m["grad_norm"])) \
        <= 2.0 ** -4 * float(want_m["grad_norm"])
    assert not any(t.requires_grad for t in topt.tree_leaves(got_p))

    lr = float(want_m["lr"])
    g_p = model_params_to_numpy(got_p)
    for (path, w), g, p0 in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, want_p))[0],
            jax.tree.leaves(g_p), jax.tree.leaves(tree)):
        assert (np.abs(g - w) <= 2 * lr + 1e-6 * np.abs(w).max()).all(), path
        step_ref, step_got = w - p0, g - p0
        assert np.linalg.norm(step_got - step_ref) \
            <= 0.25 * np.linalg.norm(step_ref) + 1e-6, path
    got_state = opt_state_to_numpy(got_s)
    assert int(got_state["step"]) == int(want_s["step"]) == 1
    for moment in ("m", "v"):
        flat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda a: np.asarray(a, np.float32),
                         want_s[moment]))[0]
        floor = 2.0 ** -10 * max(np.linalg.norm(a) for _, a in flat)
        for (path, w), g in zip(flat, jax.tree.leaves(got_state[moment])):
            # v holds squared gradients: twice the gradient's relative error
            rel = 2.0 ** -4 * (2 if moment == "v" else 1)
            assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w) \
                + (floor if moment == "m" else floor * floor), (moment, path)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_remat_gradients_equal_plain_gradients(name):
    """Recomputing each layer in the backward changes nothing: the loss and
    every gradient equal the no-remat run's bit for bit (the recompute runs
    the same ops on the same inputs)."""
    cfg = get_config(name).smoke()
    rcfg = ref_get_config(name).smoke()
    tree = perturb(ref_model_api(rcfg).init(jax.random.PRNGKey(3)), seed=4)
    _, tb = _batch(cfg, 2, 16, seed=1)
    runs = []
    for remat in (False, True):
        params = model_params_from_numpy(cfg, tree, device="cpu",
                                         master=True)
        runs.append(port_grads(cfg, params, tb, remat=remat))
    (l0, m0, g0), (l1, m1, g1) = runs
    assert torch.equal(l0, l1)
    assert torch.equal(m0["aux"], m1["aux"])
    for a, b in zip(topt.tree_leaves(g0), topt.tree_leaves(g1)):
        assert torch.equal(a, b)


# ---------------------------------------------------------- token pipeline
@pytest.mark.parametrize("extras", [(), ("patches",)])
def test_token_pipeline_bit_for_bit(extras):
    kw = dict(vocab_size=32_000, global_batch=8, seq_len=24, seed=3,
              extras=extras, extra_shape=(4, 6) if extras else ())
    ref_pipe = RefTokenPipeline(RefPipelineConfig(**kw))
    pipe = TokenPipeline(PipelineConfig(**kw))
    for step in (0, 1, 17, 1000):
        for dp_size in (1, 2, 4, 8):
            for rank in range(dp_size):
                want = ref_pipe.batch_at(step, rank, dp_size)
                got = pipe.batch_at(step, rank, dp_size)
                assert set(got) == set(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        pipe.batch_at(0, 0, 3)


# ----------------------------------------------------------- carried state
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_carried_state_round_trips(name):
    cfg = get_config(name).smoke()
    tree = jax.tree.map(np.asarray, ref_model_api(
        ref_get_config(name).smoke()).init(jax.random.PRNGKey(1)))
    back = model_params_to_numpy(
        model_params_from_numpy(cfg, tree, device="cpu", master=True))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    state = ropt.init_opt_state(tree, ropt.OptimizerConfig(
        state_dtype="bfloat16"))
    got = opt_state_from_numpy(cfg, jax.tree.map(np.asarray, state),
                               device="cpu")
    assert got["m"]["final_norm"]["w"].dtype == torch.bfloat16
    back = opt_state_to_numpy(got)
    assert back["step"].dtype == np.int32
    assert jax.tree.structure(back["v"]) == jax.tree.structure(tree)
