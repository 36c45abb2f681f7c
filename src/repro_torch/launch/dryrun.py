"""Multi-pod dry run: what every (architecture x cell x mesh) would hold and
move, reckoned from the specs with nothing allocated and nothing launched.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \
        --cell train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
        [--skip-done] [--out artifacts/dryrun]

The port of the reference package's ``launch/dryrun.py``, with its flags.
The reference lowers and compiles each cell's jitted step under its
shardings and reads XLA's memory analysis, cost analysis and, through
``launch/hlo_census.py``, the collectives of the compiled HLO text. The
port compiles nothing and has no HLO: ``hlo_census`` has no counterpart.
Its census is the sharded train step's own (``launch.shardings``): every
all-gather and reduce-scatter ``make_train_step(..., mesh=)`` performs,
reckoned from the parameter specs by ``shardings.step_census``, which is
what ``shardings.census`` counts when the step runs. Each cell writes one
JSON file to ``--out`` holding:

  * ``memory``: bytes a device holds of the parameters (fp32 masters for
    a train cell, bf16 for serving, as the reference's dry run casts
    them), the AdamW state (two bf16 moments and the int32 step), the
    batch and the decode cache, from ``models.api.params_specs``,
    ``input_specs`` and ``cache_specs`` under ``launch.shardings``' specs;
    and ``gathered``, one dp shard's whole fp32 parameters, which the
    sharded step gathers on its device;
  * ``collectives`` (train cells): {kind: {axes: bytes a step}}, each dp
    shard's all-gather of every parameter over its sharded axes (twice
    where a mixture-of-experts model's rows split, ``launch.step
    .balance_pass``) and reduce-scatter of its gradient over the dp axes
    and those: what the step asks for, not bytes measured on a card;
  * ``flops_per_device``: model flops of the cell over the mesh's
    devices. Train: 6 N tokens plus 3x the self-attention forward's 4 hd
    flops a live (query, key) pair (``PERF.md`` §2); prefill: 2 N tokens
    plus the forward's; decode: 2 N a row plus 4 hd a cached key a head a
    layer. N counts the active parameters (top-k experts).

The mesh is built on the CPU (its devices are never touched). ``ok`` is
false, with the traceback, where a rule is missing: that is a bug.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ALL_CELLS, ArchConfig, ShapeCell, \
    supported_cells
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.step import balance_pass
from repro_torch.models.api import (active_params, cache_specs,
                                    input_specs, params_specs)
from repro_torch.models.transformer import HYMBA_WINDOW, n_blocks
from repro_torch.utils.tree import tree_leaves


def _pairs(s: int, t: int, causal: bool, window: int | None) -> int:
    """Live (query, key) pairs of one (row, head): causal s(s+1)/2, under a
    window w the first w rows grow and the rest see w, non-causal s t."""
    if not causal:
        return s * t
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _self_attention_layers(cfg: ArchConfig) -> int:
    """Decoder self-attention layers (cross-attention not counted)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "vlm":
        return n_blocks(cfg) * (cfg.cross_attn_every - 1)
    return cfg.n_layers


def attention_forward_flops(cfg: ArchConfig, b: int, s: int) -> float:
    """4 hd flops a live pair, over every self-attention layer (the audio
    encoder's over its frames)."""
    per = 4.0 * cfg.resolved_head_dim * b * cfg.n_heads
    window = HYMBA_WINDOW if cfg.family == "hybrid" else None
    flops = per * _self_attention_layers(cfg) * _pairs(s, s, True, window)
    if cfg.family == "audio":
        flops += per * cfg.enc_layers * _pairs(cfg.audio_frames,
                                               cfg.audio_frames, False, None)
    return flops


def model_flops(cfg: ArchConfig, cell: ShapeCell, n_active: int) -> float:
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        return 6.0 * n_active * b * s + 3.0 * attention_forward_flops(
            cfg, b, s)
    if cell.kind == "prefill":
        return 2.0 * n_active * b * s + attention_forward_flops(cfg, b, s)
    return 2.0 * n_active * b + 4.0 * cfg.resolved_head_dim * b * \
        cfg.n_heads * s * _self_attention_layers(cfg)


def train_collectives(cfg: ArchConfig, mesh, rows: int) -> dict:
    """The sharded train step's collectives on ``mesh`` for ``cfg`` and a
    batch of ``rows``, reckoned from its parameter specs (fp32 masters and
    gradients)."""
    shapes = params_specs(cfg)
    return sh.step_census(shapes, sh.param_specs(shapes, mesh), mesh,
                          passes=2 if balance_pass(cfg, mesh, rows) else 1)


def run_cell(arch: str, cell: ShapeCell, multi_pod: bool, out_dir: str,
             _params: dict | None = None) -> dict:
    """One cell's record, written to ``out_dir``; ``_params`` memoises the
    parameter stand-ins by architecture."""
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    mesh_name = "pod2" if multi_pod else "pod1"
    rec: dict = {"arch": arch, "cell": cell.name, "mesh": mesh_name,
                 "mesh_shape": mesh.shape, "devices": mesh.size,
                 "ok": False}
    t0 = time.time()
    try:
        cache = {} if _params is None else _params
        if arch not in cache:
            shapes = params_specs(cfg)
            total = sum(math.prod(t.shape) for t in tree_leaves(shapes))
            cache[arch] = shapes, active_params(cfg, total)
        params, n_active = cache[arch]
        pspecs = sh.param_specs(params, mesh, moe_ep=True)
        batch = input_specs(cfg, cell)
        train = cell.kind == "train"
        mem = {"params": sh.device_bytes(params, pspecs, mesh,
                                         itemsize=4 if train else 2),
               "batch": sh.device_bytes(batch,
                                        sh.batch_specs(cfg, cell, mesh),
                                        mesh)}
        if train:
            mem["opt_state"] = 2 * sh.device_bytes(params, pspecs, mesh,
                                                   itemsize=2) + 4
            mem["gathered"] = sh.device_bytes(
                params, sh.zip_specs(lambda s: (None,) * len(s), pspecs),
                mesh, itemsize=4)
            rec["collectives"] = sh.step_census(
                params, pspecs, mesh,
                passes=2 if balance_pass(cfg, mesh, cell.global_batch)
                else 1)
        if cell.kind == "decode":
            cache_shape = cache_specs(cfg, cell)
            mem["cache"] = sh.device_bytes(
                cache_shape, sh.cache_specs_tree(cfg, cell, mesh,
                                                 cache_shape), mesh)
        rec["memory"] = mem
        rec["flops_per_device"] = model_flops(
            cfg, cell, n_active) / mesh.size
        rec["reckon_s"] = round(time.time() - t0, 3)
        rec["ok"] = True
        print(f"OK  {arch:28s} {cell.name:12s} {mesh_name} "
              f"flops/device={rec['flops_per_device']:.3e}")
        print("  memory:", mem)
        if train:
            print("  collectives:", rec["collectives"])
    except Exception:     # a missing rule: recorded in the cell's file
        rec["error"] = traceback.format_exc()
        print(f"FAIL {arch} {cell.name} {mesh_name}\n{rec['error']}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir,
                           f"{arch}__{cell.name}__{mesh_name}.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None,
                    choices=[c.name for c in ALL_CELLS])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results, params = [], {}
    for arch in archs:
        cells = supported_cells(get_config(arch))
        if args.cell:
            cells = [c for c in ALL_CELLS if c.name == args.cell]
        for cell in cells:
            for mp in meshes:
                tag = f"{arch}__{cell.name}__{'pod2' if mp else 'pod1'}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_done and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("ok"):
                            print("skip", tag)
                            continue
                results.append(run_cell(arch, cell, mp, args.out, params))
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells OK")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
