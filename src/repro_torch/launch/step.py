"""Step functions (train, prefill and decode) shared by the launchers.

The port of the reference package's ``launch/step.py``: the reference jits
these; here they are plain callables, the serving ones under
``torch.inference_mode``.

``make_train_step(..., mesh=)`` is the sharded train step. The reference
jits one step under ``in_shardings`` and GSPMD partitions it; the port is
single-controller and spells the partition out (:func:`_sharded_step`):
FSDP pieces by ``launch.shardings``' specs, one data-parallel shard's
rows at a time on its whole gathered parameters, attention split over
``model`` (``models.common``), each shard's share of the batch's loss
differentiated and its gradient reduce-scattered back to the pieces (a
mixture-of-experts model's load-balance loss over the whole batch's
expert counts, :func:`sharded_value_and_grad`), one global gradient norm
and AdamW on every piece. GSPMD's automatic tensor parallelism of the
matrix products has no counterpart: each dp shard runs them whole.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import Mesh, dp_axes, dp_size
from repro_torch.models import hints, moe
from repro_torch.models.api import model_api
from repro_torch.train.optimizer import (OptimizerConfig, adamw_leaf,
                                         adamw_scalars, adamw_update,
                                         tree_leaves, tree_map)


def value_and_grad(cfg: ArchConfig, params, batch, *, remat: bool = True,
                   weights: tuple[float, float] | None = None):
    """(loss, metrics, gradients) of ``api.loss`` at ``params`` by
    autograd: K7 forward and K7b backward on the card, each layer
    recomputed in the backward when ``remat``. The gradients form a tree
    like ``params`` (a parameter the loss does not reach gets zeros, as in
    the reference); ``loss`` and ``metrics`` are detached. ``weights``
    (w_xent, w_aux) differentiates ``w_xent xent + w_aux aux`` instead,
    returned as the loss: a data-parallel shard's share of a batch's."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = model_api(cfg).loss(params, batch, remat=remat)
            if weights is not None:
                loss = weights[0] * metrics["xent"] \
                    + weights[1] * metrics["aux"]
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, flat))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_map(lambda _: next(it), params)


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig, *,
                    remat: bool = True, mesh: Mesh | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "xent", "aux", "lr", "grad_norm"})``: :func:`value_and_grad`,
    then one AdamW step written into ``params`` and ``opt_state`` in place
    (``train.optimizer.adamw_update``). The parameters should be fp32
    masters (``models.api.master_params``); ``batch`` holds tensors on
    their device. With a ``mesh`` the step is sharded
    (:func:`_sharded_step`)."""
    if mesh is not None:
        return _sharded_step(cfg, opt_cfg, remat, mesh)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(cfg, params, batch,
                                              remat=remat)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def shard_state(params, opt_state, mesh: Mesh) -> tuple:
    """The parameters and AdamW state as pieces by ``param_specs`` and
    ``opt_specs`` (``launch.shardings.shard_tree``); trees already held
    as pieces are returned as they are."""
    if isinstance(tree_leaves(params)[0], sh.Sharded):
        return params, opt_state
    return (sh.shard_tree(params, sh.param_specs(params, mesh), mesh),
            sh.shard_tree(opt_state, sh.opt_specs(params, mesh), mesh))


def balance_pass(cfg: ArchConfig, mesh: Mesh, rows: int) -> bool:
    """Whether the sharded step on ``mesh`` runs a forward pass a dp shard
    before its gradient passes, for a batch of ``rows``: a
    mixture-of-experts model whose rows split over more than one dp shard
    (its load-balance loss needs the whole batch's expert counts,
    :func:`sharded_value_and_grad`)."""
    n_dp = dp_size(mesh)
    return cfg.moe is not None and n_dp > 1 and rows % n_dp == 0


def _routers(tree, path: tuple = ()):
    """(path, tensor) of every ``router`` leaf of a parameter tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _routers(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _routers(v, path + (i,))
    elif path and path[-1] == "router":
        yield path, tree


def sharded_value_and_grad(cfg: ArchConfig, params, batch, mesh: Mesh, *,
                           remat: bool = True):
    """(loss, metrics, gradients) of the batch on ``mesh``, single-
    controller: ``params`` a tree of ``launch.shardings.Sharded`` pieces,
    the gradients a like tree of fp32 pieces. The batch is split over the
    dp axes' shards (``pod`` major) when its rows divide them, and
    replicated to each otherwise, as ``batch_specs`` says. For each dp
    shard in turn, on its first device:

      1. all-gather its whole parameters from the pieces (a leaf held
         whole on that device is read in place);
      2. :func:`value_and_grad` of its share of the batch's loss,
         ``w xent + r aux`` (w its share of the batch's tokens, the
         ``mask``'s, else rows x sequence; r its share of the rows),
         attention split over its ``model`` devices
         (``hints.on_dp_shard``), K7 forward and K7b backward per (dp,
         tp) shard on the card;
      3. reduce-scatter: add the gradient into the fp32 gradient pieces;
         the gathered parameters and the gradient are then dropped, so
         about one whole copy is live at a time. With one dp shard both
         weights are 1 and a leaf held whole keeps its gradient as it is:
         a 1 x 1 mesh gives the unsharded step's bits.

    A mixture-of-experts model's load-balance loss is a product of means
    over the batch (``E sum_e f_e P_e``), not a mean over rows: where its
    rows split (:func:`balance_pass`), each dp shard first runs a forward
    pass (its parameters gathered for it) to count its expert choices, and
    the gradient passes take the whole batch's fractions f_e
    (``models.moe.whole_batch_balance``), so that the shards' aux losses,
    weighted by rows, sum to the whole batch's, as in the reference.

    The loss and metrics are the shards' weighted sums. Every all-gather
    and reduce-scatter is counted in ``shardings.census`` (the whole
    leaf's bytes, by axes; ``shardings.step_census`` reckons the same
    from the specs)."""
    dp_coords = list(mesh.coords(dp_axes(mesh)))

    def gathered(p: sh.Sharded, dev: torch.device) -> torch.Tensor:
        if len(p.pieces) > 1:
            sh.census.record("all-gather", sh.gather_axes(p.spec, mesh),
                             math.prod(p.shape) * p.dtype.itemsize)
        return p.whole(dev)

    @torch.no_grad()
    def scatter_add(acc: sh.Sharded, p: sh.Sharded, g: torch.Tensor):
        """Add g into ``acc``'s pieces (held where ``p``'s are), which the
        first dp shard's gradient creates: a leaf held whole takes that
        gradient itself, no copy."""
        sh.census.record("reduce-scatter", sh.reduce_axes(p.spec, mesh),
                         g.numel() * g.element_size())
        for block, copies in p.pieces.items():
            part = g[sh.block_slices(p.spec, tuple(p.shape), mesh,
                                     block)].float()
            if len(p.pieces) > 1:
                part = part.clone()       # a view would keep all of g
            held = acc.pieces.setdefault(block, {})
            for dev in copies:
                if dev in held:
                    held[dev].add_(part.to(dev))
                else:
                    held[dev] = part.to(dev)

    n_rows, n_dp = batch["tokens"].shape[0], len(dp_coords)
    rows = n_rows // n_dp
    slices = [slice(i * rows, (i + 1) * rows) if n_rows % n_dp == 0
              else slice(None) for i in range(n_dp)]
    mask = batch.get("mask")
    tokens = [float(mask[r].sum()) if mask is not None
              else float(batch["tokens"][r].numel()) for r in slices]
    n_of = [batch["tokens"][r].shape[0] for r in slices]
    total, total_rows = max(sum(tokens), 1.0), sum(n_of)
    grads = tree_map(lambda p: sh.Sharded(
        p.shape, torch.float32, p.spec, mesh, {}), params)

    def shard(i: int):
        dev = mesh.device_at(**dp_coords[i])
        full = tree_map(lambda p: gathered(p, dev), params)
        keys = {id(t): path for path, t in _routers(full)}
        return dev, {k: v[slices[i]].to(dev) for k, v in batch.items()}, \
            full, keys

    balance: dict = {}
    sums = {}
    with hints.mesh_hints(mesh, dp_axes(mesh), sh.TP):
        if balance_pass(cfg, mesh, n_rows):
            for i, coords in enumerate(dp_coords):
                _, shard_batch, full, keys = shard(i)
                with torch.no_grad(), hints.on_dp_shard(coords), \
                        moe.whole_batch_balance(keys, balance, record=True):
                    model_api(cfg).loss(full, shard_batch, remat=False)
                del full
        for i, coords in enumerate(dp_coords):
            dev, shard_batch, full, keys = shard(i)
            w, r = tokens[i] / total, n_of[i] / total_rows
            with hints.on_dp_shard(coords), (
                    moe.whole_batch_balance(keys, balance, record=False)
                    if balance else contextlib.nullcontext()):
                loss, metrics, g_full = value_and_grad(
                    cfg, full, shard_batch, remat=remat, weights=(w, r))
            del full
            tree_map(scatter_add, grads, params, g_full)
            del g_full
            for k, v in (("loss", loss), ("xent", w * metrics["xent"]),
                         ("aux", r * metrics["aux"])):
                v = v.float().to(mesh.first)
                sums[k] = v if k not in sums else sums[k] + v
    return sums["loss"], {"xent": sums["xent"], "aux": sums["aux"]}, grads


def _sharded_step(cfg: ArchConfig, opt_cfg: OptimizerConfig, remat: bool,
                  mesh: Mesh):
    """The train step on ``mesh``, single-controller. ``params`` and
    ``opt_state`` are trees of ``launch.shardings.Sharded`` pieces (whole
    trees are sharded first, :func:`shard_state`; they are not updated).
    :func:`sharded_value_and_grad` gives the loss and the gradient pieces;
    then the global gradient norm over every block once, and AdamW
    (``train.optimizer.adamw_leaf``) on every copy of every piece."""

    def train_step(params, opt_state, batch):
        params, opt_state = shard_state(params, opt_state, mesh)
        loss, metrics, grads = sharded_value_and_grad(
            cfg, params, batch, mesh, remat=remat)
        gnorm = torch.sqrt(sum(
            t.float().square().sum().to(mesh.first)
            for g in tree_leaves(grads) for _, t in g.blocks()))
        step = next(opt_state["step"].copies())
        sc = adamw_scalars(step, gnorm, opt_cfg)
        by_dev = {}
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(opt_state["m"]),
                              tree_leaves(opt_state["v"])):
            for block, copies in p.pieces.items():
                for dev, t in copies.items():
                    if dev not in by_dev:
                        by_dev[dev] = {k: x.to(dev) for k, x in sc.items()}
                    adamw_leaf(t, g.pieces[block][dev], m.pieces[block][dev],
                               v.pieces[block][dev], by_dev[dev], opt_cfg)
        for t in opt_state["step"].copies():
            t.copy_(sc["step"].to(t.device))
        return params, opt_state, {"loss": loss, **metrics, "lr": sc["lr"],
                                   "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig, *, max_seq: int | None = None):
    """``prefill_step(params, batch) -> (last-token logits, cache)``, the
    cache allocated at ``max_seq`` positions (the prompt's length when
    None)."""
    api = model_api(cfg)

    def prefill_step(params, batch):
        with torch.inference_mode():
            return api.prefill(params, batch, max_seq=max_seq)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``decode_step(params, cache, tokens) -> (logits, cache)``: one token
    a row; the cache's tensors are updated in place."""
    api = model_api(cfg)

    def decode_step(params, cache, tokens):
        with torch.inference_mode():
            return api.decode(params, cache, tokens)

    return decode_step
