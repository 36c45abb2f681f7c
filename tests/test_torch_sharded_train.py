"""The port's sharded training side against the reference package, on the
CPU: the partition specs, the pieces, error-feedback compression, the
sharded train step, the grouped-query expansion, the serve step's specs,
the dry run, the launcher on a mesh and the bench timer.

The reference's spec functions read only a mesh's ``axis_names`` and
``shape``, so they run on a ``jax.sharding.AbstractMesh`` of the production
shapes; the port's on CPU meshes of the same shapes. The port's trees hold
lists where the reference stacks layers on leading axes: a port spec tree
is stacked (:func:`stacked`: every list's members must agree, and gain a
leading None) before it is held to the reference's leaf for leaf.

Tolerances. Specs, pieces and error-feedback compression: exact. The
sharded step against the reference's ``make_train_step`` (``jax
.value_and_grad`` and its AdamW): ``test_torch_train``'s tolerances for
``make_train_step`` (loss 2^-8, gradient norm 2^-4, each parameter within
2 lr plus 1e-6 of its leaf's largest magnitude, each leaf's step within a
quarter of the reference's in norm). Against the port's own unsharded
step, more tightly: loss and metrics within 1e-6, the gradient norm within
2^-10 (each dp shard rounds its one row's bf16 gradient products on its
own, where the unsharded backward rounds the rows' sum once), each
parameter within 2 lr and each leaf's step within 1/16 of the unsharded
step in norm. The mixture-of-experts step (olmoe-1b-7b, under the
reference's expert choices): metrics and gradient leaves within
``test_torch_train_grads``' tolerances of ``jax.value_and_grad`` (loss
2^-8, leaf 2^-4 plus 2^-10 of the largest), gradient leaves within 2^-8
of the unsharded port's, and each parameter's move within 3% of lr of the
reference's AdamW wherever the two gradients surely share a sign.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.configs.base import supported_cells as ref_supported_cells
from repro.core.distributed import search_step_specs as ref_search_specs
from repro.launch import shardings as rsh
from repro.launch.step import make_train_step as ref_make_train_step
from repro.models import api as rapi
from repro.train import grad_compress as rgc
from repro.train import optimizer as ropt
from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.base import ALL_CELLS, supported_cells
from repro_torch.core.carry import (model_params_from_numpy,
                                    model_params_to_numpy)
from repro_torch.core.distributed import (distributed_nks_topk,
                                          nks_anchor_topk, search_step_specs)
from repro_torch.data.token_pipeline import PipelineConfig, TokenPipeline
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref as kref
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as sh
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import (dp_axes, dp_size, make_local_mesh,
                                     make_production_mesh)
from repro_torch.launch.step import (balance_pass, make_train_step,
                                     sharded_value_and_grad, value_and_grad)
from repro_torch.models import api as tapi
from repro_torch.models import hints
from repro_torch.models.api import master_params, model_api
from repro_torch.train import grad_compress as tgc
from repro_torch.train import optimizer as topt
from repro_torch.utils.timing import Timer, bench
from repro_torch.utils.tree import tree_leaves, tree_map
from test_torch_lm_serve import _batch, perturb

torch.set_num_threads(1)

ARCHS = sorted(REGISTRY)
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def port_mesh(name: str):
    shape, _ = MESHES[name]
    if name == "2x2x2":
        return make_local_mesh(2, 2, 2, device="cpu")
    return make_production_mesh(multi_pod=len(shape) == 3, device="cpu")


@pytest.fixture(autouse=True)
def _no_override(monkeypatch):
    monkeypatch.delenv("REPRO_MESH_OVERRIDE", raising=False)
    yield
    hints.disable_hints()


_PORT_SHAPES: dict = {}


def port_params_specs(cfg):
    """``models.api.params_specs``, memoised by config (the fake-tensor
    build of the MoE pools takes seconds)."""
    key = (cfg.name, cfg.n_layers, cfg.d_model)
    if key not in _PORT_SHAPES:
        _PORT_SHAPES[key] = tapi.params_specs(cfg)
    return _PORT_SHAPES[key]


def _prepend(tree):
    if isinstance(tree, dict):
        return {k: _prepend(v) for k, v in tree.items()}
    return (None,) + tree


def stacked(tree):
    """A port spec tree in the reference's stacked layout: every list's
    members must be equal; the list becomes its member with a leading
    None on each spec."""
    if isinstance(tree, dict):
        return {k: stacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        parts = [stacked(v) for v in tree]
        assert all(p == parts[0] for p in parts), parts
        return _prepend(parts[0])
    return tree


def assert_specs_equal(port_specs, ref_specs, what: str):
    flat = jax.tree_util.tree_flatten_with_path(
        ref_specs, is_leaf=lambda x: isinstance(x, jax.sharding
                                                .PartitionSpec))[0]
    got_tree = stacked(port_specs)
    n = 0
    for path, want in flat:
        got = got_tree
        for p in path:
            got = got[p.key]
        assert got == tuple(want), (what, [p.key for p in path], got, want)
        n += 1
    leaves = []
    sh.zip_specs(leaves.append, got_tree)
    assert n == len(leaves), what


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    """param_specs, opt_specs, batch_specs and cache_specs_tree against the
    reference's, leaf for leaf, on both production meshes and a (2, 2, 2)
    mesh, at full config and at the smoke config."""
    for smoke in (False, True):
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        if smoke:
            cfg, rcfg = cfg.smoke(), rcfg.smoke()
        shapes = port_params_specs(cfg)
        rshapes = rapi.params_specs(rcfg)
        for name, (shape, axes) in MESHES.items():
            mesh, rmesh = port_mesh(name), AbstractMesh(shape, axes)
            what = f"{arch} smoke={smoke} {name}"
            assert_specs_equal(sh.param_specs(shapes, mesh),
                               rsh.param_specs(rshapes, rmesh), what)
            assert_specs_equal(sh.opt_specs(shapes, mesh),
                               rsh.opt_specs(rshapes, rmesh), what)
            for cell in supported_cells(cfg):
                want = rsh.batch_specs(rcfg, cell, rmesh)
                assert sh.batch_specs(cfg, cell, mesh) \
                    == {k: tuple(v) for k, v in want.items()}, (what, cell)
                if cell.kind != "decode":
                    continue
                assert_specs_equal(
                    sh.cache_specs_tree(cfg, cell, mesh,
                                        tapi.cache_specs(cfg, cell)),
                    rsh.cache_specs_tree(rcfg, cell, rmesh,
                                         rapi.cache_specs(rcfg, cell)),
                    f"{what} {cell.name}")
    assert [c.name for c in supported_cells(get_config(arch))] \
        == [c.name for c in ref_supported_cells(ref_get_config(arch))]


@pytest.mark.parametrize("arch", ["minicpm-2b", "llama4-maverick-400b-a17b",
                                  "whisper-large-v3"])
def test_stand_ins_match_reference(arch):
    """params_specs, input_specs and cache_specs: the reference's shapes
    (lists stacked), on the meta device; count_params goes through them."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    shapes = port_params_specs(cfg)
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    ref_leaves = jax.tree_util.tree_flatten_with_path(
        rapi.params_specs(rcfg))[0]
    port = _stack_shapes(shapes)
    for path, leaf in ref_leaves:
        node = port
        for p in path:
            node = node[p.key]
        assert node == tuple(leaf.shape), path
    assert sum(int(np.prod(t.shape)) for t in tree_leaves(shapes)) \
        == rapi.count_params(rcfg)
    if arch == "minicpm-2b":
        assert tapi.count_params(cfg) == rapi.count_params(rcfg)
    for cell in supported_cells(cfg):
        got = {k: (tuple(v.shape), v.dtype) for k, v in
               tapi.input_specs(cfg, cell).items()}
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                rapi.input_specs(rcfg, cell).items()}
        assert {k: v[0] for k, v in got.items()} == \
            {k: v[0] for k, v in want.items()}
        assert all(str(v[1]).split(".")[-1] == want[k][1]
                   for k, v in got.items())


def _stack_shapes(tree):
    if isinstance(tree, dict):
        return {k: _stack_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        parts = [_stack_shapes(v) for v in tree]
        return _lead(parts[0], len(parts))
    return tuple(tree.shape)


def _lead(tree, n):
    if isinstance(tree, dict):
        return {k: _lead(v, n) for k, v in tree.items()}
    return (n,) + tree


def test_divisible_nulls_axes_that_do_not_divide():
    """36 heads over TP=16 replicate; the override's meshes null what does
    not divide (the reference's rule on both sides)."""
    cfg = get_config("minicpm-2b")
    shapes = port_params_specs(cfg)
    specs = sh.param_specs(shapes, make_production_mesh(device="cpu"))
    assert specs["layers"][0]["attn"]["wq"] == ("data", None, None)
    assert specs["embed"]["tok"] == ("model", "data")
    mesh = make_local_mesh(3, 5, device="cpu")
    rmesh = AbstractMesh((3, 5), ("data", "model"))
    assert_specs_equal(sh.param_specs(shapes, mesh),
                       rsh.param_specs(rapi.params_specs(
                           ref_get_config("minicpm-2b")), rmesh), "3x5")


def test_search_step_specs_match_reference():
    """The serve step's stand-ins and specs; inputs of those shapes sharded
    over a (data=8) mesh's R, as the specs say, answer as one device."""
    structs, specs = search_step_specs(q=4, r_total=1024, d=64, k=5)
    rstructs, rspecs = ref_search_specs(q=4, r_total=1024, d=64, k=5)
    assert specs == tuple(tuple(s) for s in rspecs)
    for got, want in zip(structs, rstructs):
        assert got.device.type == "meta"
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    g = torch.Generator().manual_seed(0)
    groups = torch.randn(tuple(structs[0].shape), generator=g)
    mask = torch.rand(tuple(structs[1].shape), generator=g) < 0.7
    ids = torch.arange(4 * 1024, dtype=torch.int32).reshape(4, 1024)
    want = nks_anchor_topk(groups, mask, ids, 5)
    got = distributed_nks_topk(make_local_mesh(8, device="cpu"), groups,
                               mask, ids, 5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ----------------------------------------------------------------- meshes
def test_meshes(monkeypatch):
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert dp_axes(mesh) == ("pod", "data") and dp_size(mesh) == 32
    monkeypatch.setenv("REPRO_MESH_OVERRIDE", "2,2,2")
    mesh = make_production_mesh(device="cpu")
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    assert mesh.along("model", pod=1, data=1) == [torch.device("cpu")] * 2
    monkeypatch.setenv("REPRO_MESH_OVERRIDE", "4,2")
    assert make_production_mesh(device="cpu").shape == {"data": 4,
                                                        "model": 2}
    assert make_production_mesh(multi_pod=True, device="cpu").shape == {
        "data": 4, "model": 2}
    local = make_local_mesh(2, 2, 2, device="cpu")
    assert local.shape == {"pod": 2, "data": 2, "model": 2}
    assert list(local.coords(("pod", "data"))) == [
        {"pod": 0, "data": 0}, {"pod": 0, "data": 1},
        {"pod": 1, "data": 0}, {"pod": 1, "data": 1}]
    if not torch.cuda.is_available():
        for make in (make_local_mesh, make_production_mesh):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_shard_and_gather_round_trip():
    """gather_tree(shard_tree(x)) is x bit for bit (fp32 masters, bf16
    moments), each piece its spec's block, one copy a distinct device."""
    cfg = get_config("olmoe-1b-7b").smoke()
    params = master_params(model_api(cfg).init(
        torch.Generator().manual_seed(1), device="cpu"))
    ocfg = topt.OptimizerConfig(state_dtype="bfloat16")
    opt = topt.init_opt_state(params, ocfg)
    opt["m"] = tree_map(lambda t: torch.randn(t.shape).to(t.dtype),
                        opt["m"])
    mesh = make_local_mesh(2, 2, 2, device="cpu")
    for tree, specs in ((params, sh.param_specs(params, mesh)),
                        (opt, sh.opt_specs(params, mesh))):
        pieces = sh.shard_tree(tree, specs, mesh)
        back = sh.gather_tree(pieces, specs, mesh)
        for a, b in zip(tree_leaves(tree), tree_leaves(back)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    wq = sh.shard_tree(params, sh.param_specs(params, mesh), mesh)[
        "layers"][0]["attn"]["wq"]
    assert wq.spec == ("data", "model", None)
    assert sorted(wq.pieces) == [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    assert torch.equal(wq.pieces[(1, 0, 0)][torch.device("cpu")],
                       params["layers"][0]["attn"]["wq"][32:, :2])


# ---------------------------------------------------- gradient compression
def test_ef_compress_bit_for_bit():
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((8, 32)).astype(np.float32),
             # g / scale lands on halves: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
             "b": np.array([127.0, 63.5, -0.5, 0.5, 1.5, 2.5, -2.5],
                           np.float32),
             "c": np.zeros((3,), np.float32)}
    errs = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in grads.items()}
    errs["b"][:] = 0.0
    for i in range(2):                    # the error feeds the next step
        want_d, want_e = rgc.ef_compress(
            {k: jnp.asarray(v) for k, v in grads.items()},
            {k: jnp.asarray(v) for k, v in errs.items()})
        got_d, got_e = tgc.ef_compress(
            {k: torch.from_numpy(v) for k, v in grads.items()},
            {k: torch.from_numpy(v.copy()) for k, v in errs.items()})
        for k in grads:
            np.testing.assert_array_equal(got_d[k].numpy(),
                                          np.asarray(want_d[k]))
            np.testing.assert_array_equal(got_e[k].numpy(),
                                          np.asarray(want_e[k]))
        if i == 0:
            assert got_d["b"].tolist() == [127.0, 64.0, -0.0, 0.0, 2.0, 2.0,
                                           -2.0]
        errs = {k: np.array(v) for k, v in want_e.items()}
    zeros = tgc.init_error_buf({"a": torch.ones(2, dtype=torch.bfloat16)})
    assert zeros["a"].dtype == torch.float32 and not zeros["a"].any()


# -------------------------------------------------------- the sharded step
OPT = dict(total_steps=10, warmup_steps=2, schedule="wsd", peak_lr=1e-3)


def _state(cfg, tree, ocfg):
    params = model_params_from_numpy(cfg, tree, device="cpu", master=True)
    return params, topt.init_opt_state(params, ocfg)


def test_sharded_step_matches_reference_and_unsharded():
    """MiniCPM-2B smoke, global batch 4 on a (2, 2, 2) CPU mesh (one row a
    dp shard): the reference's jitted step, the port's unsharded step and
    the sharded one on the same tree and batch."""
    name = "minicpm-2b"
    rcfg, cfg = ref_get_config(name).smoke(), get_config(name).smoke()
    tree = jax.tree.map(np.asarray, perturb(
        rapi.model_api(rcfg).init(jax.random.PRNGKey(5)), seed=6))
    rocfg, ocfg = ropt.OptimizerConfig(**OPT), topt.OptimizerConfig(**OPT)
    rb, tb = _batch(cfg, 4, 16, seed=7)
    rparams = jax.tree.map(jnp.asarray, tree)
    want_p, _, want_m = ref_make_train_step(rcfg, rocfg)(
        rparams, ropt.init_opt_state(rparams, rocfg), rb)
    plain_p, _, plain_m = make_train_step(cfg, ocfg)(*_state(cfg, tree,
                                                              ocfg), tb)

    mesh = make_local_mesh(2, 2, 2, device="cpu")
    kflash.reset_launches()
    calls = []
    orig = kref.flash_attention

    def counted(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return orig(q, k, v, **kw)
    sh.census.reset()
    params, state = _state(cfg, tree, ocfg)
    kref.flash_attention = counted
    try:
        got_p, got_s, got_m = make_train_step(cfg, ocfg, mesh=mesh)(
            params, state, tb)
    finally:
        kref.flash_attention = orig
    # attention once per (dp, tp) shard a layer, forward and remat
    assert calls == [(1, 16, 2, 16)] * (8 * 2 * cfg.n_layers)
    assert kflash.launches["flash_unsharded"] == 0
    pspecs = sh.param_specs(params, mesh)
    assert sh.census.totals() == sh.step_census(params, pspecs, mesh)
    assert isinstance(tree_leaves(got_p)[0], sh.Sharded)
    assert int(got_s["step"].whole()) == 1
    full = sh.gather_tree(got_p, pspecs, mesh)

    lr = float(want_m["lr"])
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) \
        <= 2.0 ** -8 * float(want_m["loss"])
    assert abs(float(got_m["grad_norm"]) - float(want_m["grad_norm"])) \
        <= 2.0 ** -4 * float(want_m["grad_norm"])
    for k in ("loss", "xent", "aux", "lr"):
        assert abs(float(got_m[k]) - float(plain_m[k])) \
            <= 1e-6 * abs(float(plain_m[k])), k
    assert abs(float(got_m["grad_norm"]) - float(plain_m["grad_norm"])) \
        <= 2.0 ** -10 * float(plain_m["grad_norm"])
    g_p, u_p = model_params_to_numpy(full), model_params_to_numpy(plain_p)
    for (path, w), g, u, p0 in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, want_p))[0],
            jax.tree.leaves(g_p), jax.tree.leaves(u_p),
            jax.tree.leaves(tree)):
        assert (np.abs(g - w) <= 2 * lr + 1e-6 * np.abs(w).max()).all(), path
        assert np.linalg.norm((g - p0) - (w - p0)) \
            <= 0.25 * np.linalg.norm(w - p0) + 1e-6, path
        assert (np.abs(g - u) <= 2 * lr + 1e-6 * np.abs(u).max()).all(), path
        assert np.linalg.norm(g - u) \
            <= np.linalg.norm(u - p0) / 16 + 1e-6, path


def test_sharded_step_replicates_a_batch_that_does_not_divide():
    """3 rows over 4 dp shards: the batch replicates (``batch_specs``'s
    rule), every shard runs all 3 rows, and the step equals the unsharded
    one as closely as above; a 1 x 1 mesh gives the unsharded step bit for
    bit."""
    cfg = get_config("minicpm-2b").smoke()
    params0 = master_params(model_api(cfg).init(
        torch.Generator().manual_seed(2), device="cpu"))
    ocfg = topt.OptimizerConfig(**OPT)
    _, tb = _batch(cfg, 3, 16, seed=8)
    runs = {}
    for name, mesh in (("plain", None),
                       ("1x1", make_local_mesh(1, 1, device="cpu")),
                       ("2x2x2", make_local_mesh(2, 2, 2, device="cpu"))):
        params = tree_map(torch.clone, params0)
        p, _, m = make_train_step(cfg, ocfg, mesh=mesh)(
            params, topt.init_opt_state(params, ocfg), tb)
        if mesh is not None:
            p = sh.gather_tree(p, sh.param_specs(params0, mesh), mesh)
        runs[name] = p, m
    (pp, pm), (p1, m1), (p8, m8) = runs["plain"], runs["1x1"], runs["2x2x2"]
    for k in pm:
        assert torch.equal(pm[k], m1[k]), k
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pp),
                                                 tree_leaves(p1)))
    assert abs(float(m8["loss"]) - float(pm["loss"])) \
        <= 1e-6 * float(pm["loss"])
    lr = float(pm["lr"])
    for a, b in zip(tree_leaves(p8), tree_leaves(pp)):
        assert float((a - b).abs().max()) <= 2 * lr + 1e-6


def _reference_choices(rcfg, rparams, rb):
    """The reference's loss and gradients by ``jax.value_and_grad`` on the
    whole batch, and its expert choices, (B, S, k) a MoE layer in layer
    order (its layers run in a scan: recorded through a host callback)."""
    import repro.models.moe as rmoe
    orig, recorded = rmoe.apply_moe, []

    def wrap(p, x, mcfg):
        probs = jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", x.astype(jnp.float32),
            p["router"].astype(jnp.float32)), axis=-1)
        jax.debug.callback(lambda te: recorded.append(np.asarray(te)),
                           jax.lax.top_k(probs, mcfg.top_k)[1], ordered=True)
        return orig(p, x, mcfg)
    rmoe.apply_moe = wrap
    try:
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: rapi.model_api(rcfg).loss(p, rb, remat=False),
            has_aux=True)(rparams)
        jax.effects_barrier()
    finally:
        rmoe.apply_moe = orig
    return loss, metrics, grads, recorded


def _forced_choices(monkeypatch, routers: list, choices: list):
    """Every port router call takes the reference's expert choices for its
    layer (the router whose values it holds) and rows (its dp shard's,
    inside a sharded step): the port's own probabilities, weights and
    load-balance counts then follow, as ``test_torch_lm_serve
    .same_routing`` does for one whole batch (near-tied choices differ by
    design between the packages)."""
    from repro_torch.models import moe as tmoe
    route, topk, now = tmoe.route, torch.topk, {}

    def forced_topk(t, k, dim=-1):
        if "e" not in now:
            return topk(t, k, dim=dim)
        e = now.pop("e")
        return torch.gather(t, -1, e), e

    def forced_route(p, x, mcfg):
        layer = next(i for i, r in enumerate(routers)
                     if torch.equal(r, p["router"]))
        shard = (hints.active() or {}).get("dp_shard")
        i = 0 if shard is None else shard.get("pod", 0) * 2 + shard["data"]
        b = x.shape[0]
        now["e"] = torch.from_numpy(
            choices[layer][i * b:(i + 1) * b].copy()).long()
        return route(p, x, mcfg)
    monkeypatch.setattr(tmoe, "route", forced_route)
    monkeypatch.setattr(torch, "topk", forced_topk)


def test_sharded_moe_step_matches_reference_and_unsharded(monkeypatch):
    """olmoe-1b-7b smoke (8 experts, top 2), global batch 4 on a (2, 2, 2)
    CPU mesh, one row a dp shard, under the reference's expert choices.
    The load-balance loss is a product of means over the whole batch, so
    each shard's gradient pass must take the whole batch's expert
    fractions (``launch.step.balance_pass``): the sharded aux loss, loss
    and gradients are the reference's within the gradient tests'
    tolerances and the unsharded port's within 2^-8 of each leaf's norm
    (0.24% at worst: each shard's bf16 products round on their own; with
    each shard's own fractions the embedding's gradient is 1.4% off and
    the router's 82%), and one sharded step is the reference's AdamW on
    its gradients wherever the two gradients surely share a sign (0.98 of
    the nonzero elements)."""
    name = "olmoe-1b-7b"
    rcfg, cfg = ref_get_config(name).smoke(), get_config(name).smoke()
    tree = jax.tree.map(np.asarray, perturb(
        rapi.model_api(rcfg).init(jax.random.PRNGKey(5)), seed=6))
    rb, tb = _batch(cfg, 4, 16, seed=7)
    rparams = jax.tree.map(jnp.asarray, tree)
    rloss, rm, rgrads, choices = _reference_choices(rcfg, rparams, rb)
    choices = choices[:cfg.n_layers]
    rocfg, ocfg = ropt.OptimizerConfig(**OPT), topt.OptimizerConfig(**OPT)
    params = model_params_from_numpy(cfg, tree, device="cpu", master=True)
    routers = [l["moe"]["router"].clone() for l in params["layers"]]
    _forced_choices(monkeypatch, routers, choices)
    mesh = make_local_mesh(2, 2, 2, device="cpu")
    pspecs = sh.param_specs(params, mesh)
    assert balance_pass(cfg, mesh, 4)
    _, plain_m, plain_g = value_and_grad(cfg, params, tb, remat=False)
    sh.census.reset()
    loss, metrics, g_pieces = sharded_value_and_grad(
        cfg, sh.shard_tree(params, pspecs, mesh), tb, mesh, remat=False)
    assert sh.census.totals()["all-gather"] == sh.step_census(
        params, pspecs, mesh, passes=2)["all-gather"]
    got_g = model_params_to_numpy(sh.gather_tree(g_pieces, pspecs, mesh))
    plain_g = model_params_to_numpy(plain_g)
    for k, want in (("aux", rm["aux"]), ("xent", rm["xent"])):
        assert abs(float(metrics[k]) - float(want)) \
            <= 2.0 ** -8 * abs(float(want)), k
        assert abs(float(metrics[k]) - float(plain_m[k])) \
            <= 1e-6 * abs(float(plain_m[k])), k
    assert abs(float(loss) - float(rloss)) <= 2.0 ** -8 * float(rloss)
    flat = jax.tree_util.tree_flatten_with_path(rgrads)[0]
    norms = [float(np.linalg.norm(np.asarray(a, np.float32)))
             for _, a in flat]
    floor = 2.0 ** -10 * max(norms)
    for (path, want), norm, got, un in zip(flat, norms,
                                           jax.tree.leaves(got_g),
                                           jax.tree.leaves(plain_g)):
        want = np.asarray(want, np.float32)
        assert np.isfinite(got).all(), path
        assert np.linalg.norm(got - want) <= 2.0 ** -4 * norm + floor, path
        assert np.linalg.norm(got - un) \
            <= 2.0 ** -8 * np.linalg.norm(un) + 1e-6 * floor, path

    # one step: the reference's AdamW on its gradients, the port's
    # sharded step. A first AdamW step moves an element by about lr
    # sign(g): where the gradients surely share a sign (|g| above twice
    # their difference, and far above eps once clipped) the moves agree to
    # 3% of lr (eps/|g| <= 1% a side) and fp32 roundings; a wrong sign is
    # 2 lr off.
    want_p, _, want_m = ropt.adamw_update(
        rparams, rgrads, ropt.init_opt_state(rparams, rocfg), rocfg)
    state = topt.init_opt_state(params, ocfg)
    got_p, _, got_m = make_train_step(cfg, ocfg, remat=False, mesh=mesh)(
        params, state, tb)
    full = model_params_to_numpy(sh.gather_tree(got_p, pspecs, mesh))
    assert abs(float(got_m["loss"]) - float(rloss)) \
        <= 2.0 ** -8 * float(rloss)
    assert abs(float(got_m["grad_norm"]) - float(want_m["grad_norm"])) \
        <= 2.0 ** -4 * float(want_m["grad_norm"])
    lr = float(want_m["lr"])
    clip = min(1.0, 1.0 / float(want_m["grad_norm"]))
    sure_n = nonzero_n = 0
    for (path, w), g, gg, gw in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, want_p))[0],
            jax.tree.leaves(full), jax.tree.leaves(got_g),
            jax.tree.leaves(jax.tree.map(np.asarray, rgrads))):
        sure = (np.abs(gw) > 2 * np.abs(gg - gw)) \
            & (np.abs(gw) * clip > 1e-6)
        assert (np.abs(g - w)[sure]
                <= 0.03 * lr + 2.0 ** -21 * np.abs(w)[sure]).all(), path
        sure_n += int(sure.sum())
        nonzero_n += int((gw != 0).sum())
    assert sure_n >= 0.5 * nonzero_n, (sure_n, nonzero_n)


def test_gqa_expansion_under_model_2():
    """qwen3-32b smoke (4 query heads, 1 kv head) under a (data=2,
    model=2) mesh: kv heads do not divide TP=2, so keys and values are
    repeated to one head a query head, and each tp shard's attention takes
    2 query heads over 2 kv heads; the loss is the reference's (which
    expands the same way under its hints) and the port's unsharded one."""
    name = "qwen3-32b"
    rcfg, cfg = ref_get_config(name).smoke(), get_config(name).smoke()
    assert (cfg.n_heads, cfg.n_kv_heads) == (4, 1)
    tree = perturb(rapi.model_api(rcfg).init(jax.random.PRNGKey(3)), seed=4)
    rb, tb = _batch(cfg, 2, 16, seed=1)
    want, _ = rapi.model_api(rcfg).loss(jax.tree.map(jnp.asarray, tree), rb,
                                        remat=False)
    params = model_params_from_numpy(cfg, tree, device="cpu")
    plain, _ = model_api(cfg).loss(params, tb, remat=False)
    mesh = make_local_mesh(2, 2, device="cpu")
    shapes = []
    orig = kref.flash_attention

    def counted(q, k, v, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return orig(q, k, v, **kw)
    hints.enable_hints_mesh(mesh, dp_axes(mesh), "model")
    assert hints.tp_size() == 2 and hints.hint(tb["tokens"], "dp") is \
        tb["tokens"]
    kref.flash_attention = counted
    try:
        got, _ = model_api(cfg).loss(params, tb, remat=False)
    finally:
        kref.flash_attention = orig
        hints.disable_hints()
    assert shapes == [((1, 16, 2, 16), (1, 16, 2, 16))] * (
        4 * cfg.n_layers)
    assert abs(float(got) - float(want)) <= 2.0 ** -8 * abs(float(want))
    assert abs(float(got) - float(plain)) <= 1e-6 * abs(float(plain))
    assert hints.tp_size() == 1


def test_attention_that_does_not_divide_runs_whole():
    """3 rows over 2 dp shards: the call runs whole on the mesh's first
    device, counted under ``flash_unsharded``, with the unsharded bits."""
    from repro_torch.models.common import attend
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((3, 16, 4, 16), generator=g).to(torch.bfloat16)
               for _ in range(3))
    want = attend(q, k, v, causal=True, window=None)
    mesh = make_local_mesh(2, 2, device="cpu")
    kflash.reset_launches()
    hints.enable_hints_mesh(mesh, dp_axes(mesh), "model")
    try:
        got = attend(q, k, v, causal=True, window=None)
        even = attend(q[:2], k[:2], v[:2], causal=True, window=None)
    finally:
        hints.disable_hints()
    assert kflash.launches["flash_unsharded"] == 1
    assert torch.equal(got, want)
    assert torch.equal(even, want[:2])


# ----------------------------------------------------------------- dry run
def test_dryrun_all_cells_ok(tmp_path, monkeypatch):
    """``launch/dryrun.py --all --both-meshes``: every cell ok; per-device
    parameter bytes are the sum the reference's specs give (fp32 in train
    cells, bf16 otherwise), and a train cell's census is what the sharded
    step counts on those specs (each parameter gathered twice a dp shard
    where a mixture-of-experts model's rows split over the dp shards)."""
    monkeypatch.setattr(dryrun, "params_specs", port_params_specs)
    out = tmp_path / "dry"
    assert dryrun.main(["--all", "--both-meshes", "--out", str(out)]) == 0
    files = sorted(out.glob("*.json"))
    want_n = sum(2 * len(supported_cells(get_config(a))) for a in ARCHS)
    assert len(files) == want_n
    import json
    for f in files:
        rec = json.loads(f.read_text())
        assert rec["ok"], rec.get("error")
        rcfg = ref_get_config(rec["arch"])
        multi = rec["mesh"] == "pod2"
        shape, axes = MESHES[rec["mesh"]]
        rmesh = AbstractMesh(shape, axes)
        rshapes = rapi.params_specs(rcfg)
        rspecs = rsh.param_specs(rshapes, rmesh)
        train = rec["cell"] == "train_4k"
        total = 0
        for leaf, spec in zip(jax.tree.leaves(rshapes),
                              jax.tree.leaves(rspecs, is_leaf=lambda x:
                                              isinstance(x, jax.sharding
                                                         .PartitionSpec))):
            n = int(np.prod(leaf.shape))
            for ax in spec:
                for a in ((ax,) if isinstance(ax, str) else ax or ()):
                    n //= rmesh.shape[a]
            total += n * (4 if train else 2)
        assert rec["memory"]["params"] == total, f.name
        assert rec["devices"] == (512 if multi else 256)
        if train:
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            tcfg = get_config(rec["arch"])
            shapes = port_params_specs(tcfg)
            gb = next(c for c in ALL_CELLS if c.name == "train_4k") \
                .global_batch
            passes = 2 if tcfg.moe is not None \
                and gb % dp_size(mesh) == 0 else 1
            assert rec["collectives"] == sh.step_census(
                shapes, sh.param_specs(shapes, mesh), mesh, passes=passes)
    cells = {c.name for c in ALL_CELLS}
    assert {json.loads(f.read_text())["cell"] for f in files} <= cells


# ---------------------------------------------------------------- launcher
def test_launcher_multi_pod_trains_rank_zeros_rows(tmp_path, monkeypatch):
    """``--multi-pod`` with ``REPRO_MESH_OVERRIDE=2,2,2`` (the launcher's
    config swapped for the smoke config) trains 2 steps on a (2, 2, 2)
    mesh; each step reads rank 0's 16 / 4 = 4 rows of the pipeline's
    global batch, the reference's ``dp_rank=0`` defect, and its loss is
    the loss on those 4 rows, not on all 16."""
    monkeypatch.setenv("REPRO_MESH_OVERRIDE", "2,2,2")
    monkeypatch.setattr(train_launch, "get_config",
                        lambda a: get_config(a).smoke())
    rows = []
    orig = TokenPipeline.batch_at

    def recorded(self, step, dp_rank=0, dp_size=1):
        out = orig(self, step, dp_rank, dp_size)
        rows.append((step, dp_rank, dp_size, out["tokens"].shape[0]))
        return out
    monkeypatch.setattr(TokenPipeline, "batch_at", recorded)
    argv = ["--arch", "minicpm-2b", "--multi-pod", "--device", "cpu",
            "--global-batch", "16", "--seq-len", "16", "--steps", "2",
            "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1000"]
    cfg, state, hist = train_launch.run(train_launch.parser().parse_args(
        argv))
    assert rows == [(0, 0, 4, 4), (1, 0, 4, 4)]
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert not isinstance(tree_leaves(state["params"])[0], sh.Sharded)
    assert hints.active() is None
    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        global_batch=16, seq_len=16))
    params = master_params(model_api(cfg).init(
        torch.Generator().manual_seed(0), device="cpu"))
    api = model_api(cfg)
    for b, want_close in ((pipe.batch_at(0, 0, 4), True),
                          (pipe.batch_at(0), False)):
        loss, _ = api.loss(params, train_launch.batch_to(b, "cpu"))
        close = abs(float(loss) - hist[0]["loss"]) \
            <= 1e-5 * abs(float(loss))
        assert close == want_close


# ------------------------------------------------------------------ timing
def test_timer_and_bench():
    with Timer() as t:
        sum(range(1000))
    assert t.elapsed >= 0.0
    calls = []
    med = bench(lambda x: calls.append(x), 7, repeats=5, warmup=2)
    assert calls == [7] * 7 and med >= 0.0

