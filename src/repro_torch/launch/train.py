"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --steps 1000 --ckpt-dir /ckpt/minicpm [--multi-pod]
    REPRO_MESH_OVERRIDE=2,2,2 python -m repro_torch.launch.train \
        --arch minicpm-2b --multi-pod --global-batch 16 --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --smoke --device cpu --steps 3          # reduced config, on the host

The port of the reference package's ``launch/train.py`` with its flags and
``--device`` (default: the CUDA card; ``cpu`` runs the kernels' plain
versions). ``--smoke`` takes the reduced config (global batch 4, sequence
32 unless given) with fp32 optimizer state on a 1 x 1 mesh; otherwise the
full config at train_4k's sequence length and global batch with bf16
state, on the production mesh (``launch.mesh.make_production_mesh``:
``--multi-pod``'s (pod, data, model) or (data, model), or
``REPRO_MESH_OVERRIDE``'s sizes), its shards dealt over the local cards.
Parameters are initialised from seed 0 on the mesh's first device, kept as
fp32 masters and sharded with the AdamW state by ``launch.shardings``;
each step is ``make_train_step(..., mesh=)``, single-controller, with
the mesh's hints enabled so attention splits over ``model``. The
fault-tolerant loop (``train.train_loop``) restores from ``--ckpt-dir``
and checkpoints every ``--ckpt-every`` steps (the pieces gathered).

As in the reference, the loop runs ``dp_rank=0`` of ``dp_size(mesh)``
ranks, so each step reads only rank 0's ``global_batch / dp_size`` rows of
the pipeline's global batch (``data.token_pipeline.TokenPipeline
.batch_at``) and the single controller trains on those alone. This is a
defect of the reference, kept so that the port gives its answers.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TRAIN_4K
from repro_torch.data.token_pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.mesh import (Mesh, dp_axes, dp_size,
                                     make_local_mesh, make_production_mesh,
                                     resolve_device)
from repro_torch.launch.shardings import TP, Sharded
from repro_torch.launch.step import make_train_step, shard_state
from repro_torch.models.api import master_params, model_api
from repro_torch.models.hints import mesh_hints
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.train_loop import LoopConfig, TrainLoop
from repro_torch.utils.tree import tree_map


def batch_to(batch: dict, device: torch.device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``: token ids as
    int64, features as they are."""
    out = {}
    for name, a in batch.items():
        t = torch.as_tensor(a)
        out[name] = (t.long() if not t.is_floating_point() else t).to(device)
    return out


def trainer(cfg, opt_cfg: OptimizerConfig, device, mesh: Mesh | None = None):
    """(init_state, stepper) for :class:`TrainLoop`: fp32 master parameters
    drawn from seed 0 on ``device`` with a fresh AdamW state, and one train
    step (``make_train_step``) on a pipeline batch. With a ``mesh`` the
    state is held as pieces on it and the step is sharded."""
    api = model_api(cfg)
    step_fn = make_train_step(cfg, opt_cfg, mesh=mesh)

    def init_state():
        gen = torch.Generator(device=device).manual_seed(0)
        params = master_params(api.init(gen, device=device))
        opt = init_opt_state(params, opt_cfg)
        if mesh is not None:
            params, opt = shard_state(params, opt, mesh)
        return {"params": params, "opt": opt}

    def stepper(state, batch):
        params, opt, metrics = step_fn(state["params"], state["opt"],
                                       batch_to(batch, device))
        return {"params": params, "opt": opt}, metrics

    return init_state, stepper


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) (pod, data, model) mesh")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (global batch 4, sequence 32) on "
                         "a 1 x 1 mesh")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    return ap


def run(args: argparse.Namespace):
    """Trains as ``args`` say; returns (config, final state as whole trees
    on the mesh's first device, history)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        mesh = make_local_mesh(1, 1, device=device)
        gb, sl = args.global_batch or 4, args.seq_len or 32
    else:
        mesh = make_production_mesh(multi_pod=args.multi_pod, device=device)
        gb, sl = args.global_batch or TRAIN_4K.global_batch, \
            args.seq_len or TRAIN_4K.seq_len
    device = mesh.first
    opt_cfg = OptimizerConfig(total_steps=args.steps, schedule=cfg.schedule,
                              state_dtype="bfloat16" if not args.smoke
                              else "float32")
    init_state, stepper = trainer(cfg, opt_cfg, device, mesh)
    pipe = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=gb, seq_len=sl))
    loop = TrainLoop(LoopConfig(total_steps=args.steps,
                                ckpt_dir=args.ckpt_dir,
                                ckpt_every=args.ckpt_every),
                     stepper, pipe, init_state, to_tensors=gathered)
    with mesh_hints(mesh, dp_axes(mesh), TP):
        state, hist = loop.run(dp_rank=0, dp_size=dp_size(mesh))
    return cfg, gathered(state), hist


def gathered(state):
    """The state with every leaf held as pieces gathered whole on the
    mesh's first device (``Sharded.whole``): what a checkpoint writes."""
    return tree_map(lambda t: t.whole() if isinstance(t, Sharded) else t,
                    state)


def main(argv=None) -> int:
    cfg, _, hist = run(parser().parse_args(argv))
    if hist:
        print(f"{cfg.name}: {len(hist)} steps, "
              f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}, "
              f"stragglers={hist[-1]['stragglers']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
