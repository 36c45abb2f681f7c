"""Training launcher on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --steps 1000 --ckpt-dir /ckpt/minicpm
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --smoke --device cpu --steps 3          # reduced config, on the host

The port of the reference package's ``launch/train.py`` with its flags and
``--device`` (default: the CUDA card; ``cpu`` runs the kernels' plain
versions). ``--smoke`` takes the reduced config (global batch 4, sequence
32 unless given) with fp32 optimizer state; otherwise the full config at
train_4k's sequence length and global batch with bf16 state, as in the
reference. Parameters are initialised from seed 0 on the device and kept as
fp32 masters; the fault-tolerant loop (``train.train_loop``) restores from
``--ckpt-dir`` and checkpoints every ``--ckpt-every`` steps.

One card is one data-parallel rank: the reference's production mesh, its
parameter and optimizer shardings and ``--multi-pod`` belong to the sharded
training side, which is not ported (ROADMAP); ``--multi-pod`` raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TRAIN_4K
from repro_torch.data.token_pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.step import make_train_step
from repro_torch.models.api import master_params, model_api
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.train_loop import LoopConfig, TrainLoop


def batch_to(batch: dict, device: torch.device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``: token ids as
    int64, features as they are."""
    out = {}
    for name, a in batch.items():
        t = torch.as_tensor(a)
        out[name] = (t.long() if not t.is_floating_point() else t).to(device)
    return out


def trainer(cfg, opt_cfg: OptimizerConfig, device):
    """(init_state, stepper) for :class:`TrainLoop`: fp32 master parameters
    drawn from seed 0 on ``device`` with a fresh AdamW state, and one train
    step (``make_train_step``) on a pipeline batch."""
    api = model_api(cfg)
    step_fn = make_train_step(cfg, opt_cfg)

    def init_state():
        gen = torch.Generator(device=device).manual_seed(0)
        params = master_params(api.init(gen, device=device))
        return {"params": params, "opt": init_opt_state(params, opt_cfg)}

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
                    help="the reference's multi-pod mesh (not on one card)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (global batch 4, sequence 32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    return ap


def run(args: argparse.Namespace):
    """Trains as ``args`` say; returns (config, final state, history)."""
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod: the sharded training side (mesh, parameter and "
            "optimizer shardings, gradient compression, pipeline "
            "parallelism) is a later slice of the port; this launcher "
            "trains on one card")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        gb, sl = args.global_batch or 4, args.seq_len or 32
    else:
        gb, sl = args.global_batch or TRAIN_4K.global_batch, \
            args.seq_len or TRAIN_4K.seq_len

    opt_cfg = OptimizerConfig(total_steps=args.steps, schedule=cfg.schedule,
                              state_dtype="bfloat16" if not args.smoke
                              else "float32")
    init_state, stepper = trainer(cfg, opt_cfg, device)
    pipe = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=gb, seq_len=sl))
    loop = TrainLoop(LoopConfig(total_steps=args.steps,
                                ckpt_dir=args.ckpt_dir,
                                ckpt_every=args.ckpt_every),
                     stepper, pipe, init_state)
    state, hist = loop.run(dp_rank=0, dp_size=1)
    return cfg, state, hist


def main(argv=None) -> int:
    cfg, _, hist = run(parser().parse_args(argv))
    if hist:
        print(f"{cfg.name}: {len(hist)} steps, "
              f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}, "
              f"stragglers={hist[-1]['stragglers']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
