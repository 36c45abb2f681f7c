"""Deterministic, resumable, elastic *training token* pipeline.

The port's copy of the reference package's ``data/token_pipeline.py``: numpy
only, and its batches are the reference's bit for bit at any ``(step,
dp_rank, dp_size)``. (Not corpus ingestion — that is ``data.ingest``, the
document -> job-queue -> engine path. This module feeds the trainers.)

Counter-based PRNG (Philox) keyed by (seed, step, dp_rank): any batch is a
pure function of its coordinates, so
  * resume-after-preemption needs only the step counter (stored in ckpt extra),
  * elastic rescale (different dp_size) re-partitions the same global batch —
    global batch content at a given step is identical for any dp_size that
    divides it,
  * no inter-host coordination or shuffle buffers.

The token stream is synthetic (structured Markov-ish noise so losses move) —
slot in a real tokenised corpus by replacing ``_tokens_for_slice``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    extras: tuple[str, ...] = ()          # "patches" / "frames"
    extra_shape: tuple[int, ...] = ()     # per-sample shape of the extra


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg

    def _rng(self, step: int, sample: int) -> np.random.Generator:
        # counter-based: key = seed, counter = (step, sample)
        return np.random.Generator(np.random.Philox(
            key=self.cfg.seed, counter=[0, 0, step, sample]))

    def _tokens_for_slice(self, step: int, lo: int, hi: int) -> np.ndarray:
        """Samples [lo, hi) of the global batch at ``step``."""
        c = self.cfg
        out = np.empty((hi - lo, c.seq_len + 1), dtype=np.int32)
        for i, sample in enumerate(range(lo, hi)):
            rng = self._rng(step, sample)
            # Markov chain over a small per-sample alphabet -> learnable
            alpha = rng.integers(0, c.vocab_size, size=64)
            idx = rng.integers(0, 64, size=c.seq_len + 1)
            drift = rng.integers(0, 3, size=c.seq_len + 1) - 1
            idx = np.abs((idx + np.cumsum(drift)) % 64)
            out[i] = alpha[idx]
        return out

    def batch_at(self, step: int, dp_rank: int = 0, dp_size: int = 1) -> dict:
        """This rank's shard of the global batch at ``step``."""
        c = self.cfg
        if c.global_batch % dp_size:
            raise ValueError("global_batch must divide dp_size")
        per = c.global_batch // dp_size
        lo = dp_rank * per
        toks = self._tokens_for_slice(step, lo, lo + per)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        for name in c.extras:
            rng = self._rng(step, self.cfg.global_batch + lo)
            batch[name] = rng.standard_normal(
                (per, *c.extra_shape)).astype(np.float32)
        return batch
