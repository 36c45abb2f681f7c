"""The port's training loss and its gradients against the reference package:
all ten architectures' ``smoke()`` configs, on the CPU.

The reference initialises each config; its tree is perturbed with seeded
noise (``test_torch_lm_serve.perturb``: the norms, biases, SSM scalars and
vision gates move off their initial constants) and carried to the port as
fp32 master parameters (``core.carry.model_params_from_numpy(...,
master=True)``). The same seeded numpy batch goes through
``jax.value_and_grad`` of the reference's ``api.loss`` and through the
port's ``api.loss`` under autograd (its attention's gradient is the plain
K7b, ``kernels.ref.flash_attention_bwd``); the port's gradients are read
back in the reference's stacked layout (``model_params_to_numpy``).

Tolerances. Loss and xent within 2^-8 of the reference's, as the forward
(``test_torch_lm_serve``). Each gradient leaf: ``||port - ref|| <= 2^-4
||ref|| + 2^-10 max_leaf ||ref||`` (Frobenius norms). Both packages hold
fp32 parameters, cast them to bf16 where they are used and take fp32
gradients of those casts, so every cotangent is rounded to bf16 at each
cast of the backward, in both, and at different places inside attention
(the reference's autodiff rounds the probabilities' cotangent, the port's
K7b the softmax numerators and dS): a relative 2^-9 a rounding, through
the smoke depth's 2 to 4 layers. The largest difference measured over the
ten configs is 2.7% of a leaf's norm, hence 2^-4. The absolute term covers
leaves whose exact gradient is zero or a cancelling sum: whisper's key
biases (a shift of every key by one vector leaves the softmax unchanged,
so both packages give rounding noise) and the vision gates (one scalar
summed over every token). Mixture-of-experts models run under the
reference's expert choices (``same_routing``). Both sides run without
remat; ``test_torch_train.py`` holds the port's remat to its no-remat
gradients bit for bit. The ten configs are split over this file and
``test_torch_train_grads_more.py`` (one file runs on one test worker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.api import model_api as ref_model_api
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.carry import (model_params_from_numpy,
                                    model_params_to_numpy)
from repro_torch.launch.step import value_and_grad
from repro_torch.utils.tree import tree_leaves
from test_torch_lm_serve import _batch, perturb, same_routing

torch.set_num_threads(1)

ARCHS = sorted(REGISTRY)
HALF = len(ARCHS) // 2
B, S = 2, 16
LOSS, LEAF, FLOOR = 2.0 ** -8, 2.0 ** -4, 2.0 ** -10


def port_grads(cfg, params, batch, remat=False):
    """(loss, metrics, gradient tree) of the port's loss on master
    parameters, by autograd (``launch.step.value_and_grad``)."""
    return value_and_grad(cfg, params, batch, remat=remat)


@pytest.mark.parametrize("name", ARCHS[:HALF])
def test_loss_and_gradients_match_reference(name):
    check_loss_and_gradients(name)


def check_loss_and_gradients(name: str) -> None:
    rcfg = ref_get_config(name).smoke()
    cfg = get_config(name).smoke()
    tree = perturb(ref_model_api(rcfg).init(jax.random.PRNGKey(3)), seed=4)
    rparams = jax.tree.map(jnp.asarray, tree)
    tparams = model_params_from_numpy(cfg, tree, device="cpu", master=True)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tparams))
    rb, tb = _batch(cfg, B, S, seed=1)
    with same_routing(cfg):
        (rloss, rm), rgrads = jax.value_and_grad(
            lambda p: ref_model_api(rcfg).loss(p, rb, remat=False),
            has_aux=True)(rparams)
        loss, metrics, grads = port_grads(cfg, tparams, tb)
    assert loss.dtype == torch.float32
    for got, want in ((loss, rloss), (metrics["xent"], rm["xent"])):
        assert abs(float(got) - float(want)) <= LOSS * abs(float(want))

    got_tree = model_params_to_numpy(grads)
    flat = jax.tree_util.tree_flatten_with_path(rgrads)[0]
    norms = [float(np.linalg.norm(np.asarray(a, np.float32)))
             for _, a in flat]
    floor = FLOOR * max(norms)
    for (path, want), norm in zip(flat, norms):
        keys = [getattr(p, "key", None) for p in path]
        got = got_tree
        for k in keys:
            got = got[k]
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape, (keys, got.shape, want.shape)
        assert np.isfinite(got).all(), keys
        err = float(np.linalg.norm(got - want))
        assert err <= LEAF * norm + floor, (keys, err, norm, floor)
