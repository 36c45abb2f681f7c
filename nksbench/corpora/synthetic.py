"""The paper's synthetic corpus (arXiv 1409.3867, Sec. VIII): coordinates
uniform on ``[0, coord_range]^d``, each point tagged with ``t`` distinct
keywords drawn uniformly from a dictionary of ``u``.

The statistics of ``src/repro_torch/data/synthetic.py``, vectorised:
points on the device in one call, tags on the host in bulk.
"""
from __future__ import annotations

import numpy as np
import torch

from harness.corpus import Corpus, rng as seeded_rng, torch_gen


def make(n: int, d: int, u: int, t: int = 1, *, seed: int,
              coord_range: float = 10_000.0) -> Corpus:
    """Uniform points and uniformly drawn distinct tags (paper Sec. VIII)."""
    rng = seeded_rng(seed, 1)
    if t == 1:
        values = rng.integers(0, u, size=n).astype(np.int32)
    else:
        # t distinct tags a point: the first t of a random key order,
        # drawn in chunks to bound the (rows, u) key block.
        chunks, step = [], max(1, (1 << 24) // max(u, 1))
        for lo in range(0, n, step):
            keys = rng.random((min(step, n - lo), u))
            chunks.append(np.sort(np.argpartition(keys, t - 1, axis=1)[:, :t],
                                  axis=1))
        values = np.concatenate(chunks).astype(np.int32).reshape(-1)
    offsets = np.arange(0, n * t + 1, t, dtype=np.int64)

    def make(device: torch.device) -> torch.Tensor:
        gen = torch_gen(seed, device)
        pts = torch.rand((n, d), generator=gen, device=device)
        return pts.mul_(float(coord_range))

    return Corpus(seed, n, d, u, offsets, values, make)
