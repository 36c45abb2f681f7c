"""Host-side training loop with the fault-tolerance contract:

  * restore from the latest checkpoint on start (parameters, optimizer,
    data position);
  * rolling atomic checkpoints (``ckpt.checkpoint``);
  * SIGTERM/SIGINT => checkpoint now and exit cleanly (preemption);
  * straggler watch: an EWMA of the step time; steps slower than
    ``straggler_sigma`` deviations are counted and logged (the loop never
    blocks on it);
  * a metrics JSONL stream.

The port of the reference package's ``train/train_loop.py``. A step is timed
to the end of its device work: ``torch.cuda.synchronize`` on the state's
card takes the place of the reference's wait for its arrays.
"""
from __future__ import annotations

import dataclasses
import json
import signal
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.data.token_pipeline import TokenPipeline
from repro_torch.utils.tree import tree_leaves


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    straggler_sigma: float = 3.0
    metrics_path: str | None = None


def _sync(state) -> None:
    """Wait for the state's device work, where it lives on a card."""
    leaves = tree_leaves(state)
    if leaves and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)


class TrainLoop:
    def __init__(self, cfg: LoopConfig, step_fn: Callable,
                 pipeline: TokenPipeline, init_state: Callable,
                 to_tensors: Callable | None = None):
        """step_fn(state, batch) -> (state, metrics); init_state() -> a tree
        {"params", "opt", ...} of tensors; ``to_tensors(state)``, where the
        state holds something else (the sharded launcher's pieces), gives
        the tree of tensors a checkpoint writes."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.pipeline = pipeline
        self.init_state = init_state
        self.to_tensors = to_tensors or (lambda state: state)
        self._preempted = False

    def _handle_preemption(self, signum, frame):
        self._preempted = True

    def run(self, dp_rank: int = 0, dp_size: int = 1):
        cfg = self.cfg
        mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep,
                                every=cfg.ckpt_every)
        state = self.init_state()
        start_step = 0
        latest = mgr.latest()
        if latest is not None:
            state, start_step, extra = load_checkpoint(latest, state)
            start_step = int(extra.get("next_step", start_step))

        old_term = signal.signal(signal.SIGTERM, self._handle_preemption)
        old_int = signal.signal(signal.SIGINT, self._handle_preemption)

        ema_t, ema_var = None, 0.0
        stragglers = 0
        metrics_f = open(cfg.metrics_path, "a") if cfg.metrics_path else None
        history = []
        try:
            for step in range(start_step, cfg.total_steps):
                batch = self.pipeline.batch_at(step, dp_rank, dp_size)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                _sync(state)
                dt = time.perf_counter() - t0

                if ema_t is None:
                    ema_t = dt
                else:
                    dev = dt - ema_t
                    if step > 5 and ema_var > 0 and \
                            dev > self.cfg.straggler_sigma * np.sqrt(ema_var):
                        stragglers += 1
                    ema_t = 0.9 * ema_t + 0.1 * dt
                    ema_var = 0.9 * ema_var + 0.1 * dev * dev

                rec = {"step": step, "time_s": dt, "stragglers": stragglers,
                       **{k: float(v) for k, v in metrics.items()}}
                history.append(rec)
                if metrics_f and step % cfg.log_every == 0:
                    metrics_f.write(json.dumps(rec) + "\n")
                    metrics_f.flush()

                if self._preempted or mgr.due(step + 1):
                    mgr.maybe_save(step + 1, self.to_tensors(state),
                                   extra={"next_step": step + 1},
                                   force=self._preempted)
                if self._preempted:
                    break
        finally:
            signal.signal(signal.SIGTERM, old_term)
            signal.signal(signal.SIGINT, old_int)
            if metrics_f:
                metrics_f.close()
        return state, history
