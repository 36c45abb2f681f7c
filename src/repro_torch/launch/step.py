"""Serving step functions (prefill and decode) shared by launchers.

The port of the reference package's ``launch/step.py``, serving half: the
reference jits these; here they are plain callables under
``torch.inference_mode``. The training step comes with the optimizer (the
LM training slice).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import model_api


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
