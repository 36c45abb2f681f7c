"""The Flickr-like photo-tag corpus of Table III (arXiv 1409.3867), with the
statistics of ``src/repro_torch/data/flickr_like.py``: ``n_clusters``
Gaussian clusters (centres uniform on ``[0, 255]^d``, scales uniform in
``[4, 24]``), tag popularity Zipf with exponent ``zipf_a``, and each point
taking ``round(t * affinity)`` tags without replacement from its cluster's
pool of ``max(4 t, 16)`` tags (the pools drawn by popularity) and the rest
by global popularity; a point's tags are the unique ones. A tag id is its
popularity rank, so tag 0 is the most popular in every seeded corpus.

Vectorised: points on the device from the seed, tags on the host in
chunks of 2^18 points.
"""
from __future__ import annotations

import numpy as np
import torch

from harness.corpus import Corpus, rng as seeded_rng, torch_gen


def zipf_popularity(u: int, a: float) -> np.ndarray:
    """(u,) float64 probabilities proportional to rank^-a, rank 1..u."""
    pop = np.arange(1, u + 1, dtype=np.float64) ** (-a)
    return pop / pop.sum()


def make(n: int, d: int, u: int, t: int = 11, *, seed: int,
                n_clusters: int = 64, zipf_a: float = 1.3,
                affinity: float = 0.7) -> Corpus:
    """Clustered points with Zipf-popular, cluster-affine tags."""
    rng = seeded_rng(seed, 1)
    assign = rng.integers(0, n_clusters, size=n)
    pop = zipf_popularity(u, zipf_a)
    pool_size = max(t * 4, 16)
    pools = np.stack([rng.choice(u, size=pool_size, replace=False, p=pop)
                      for _ in range(n_clusters)])
    n_aff = min(int(round(t * affinity)), pool_size)
    cdf = pop.cumsum()
    cdf /= cdf[-1]
    tags = np.empty((n, t), dtype=np.int64)
    step = 1 << 18
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        pick = np.argpartition(rng.random((hi - lo, pool_size)), n_aff - 1,
                               axis=1)[:, :n_aff]
        tags[lo:hi, :n_aff] = pools[assign[lo:hi, None], pick]
        glob = cdf.searchsorted(rng.random((hi - lo, t - n_aff)),
                                side="right")
        tags[lo:hi, n_aff:] = np.minimum(glob, u - 1)
    tags.sort(axis=1)
    keep = np.ones_like(tags, dtype=bool)
    keep[:, 1:] = tags[:, 1:] != tags[:, :-1]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=offsets[1:])
    values = tags[keep].astype(np.int32)

    def make(device: torch.device) -> torch.Tensor:
        gen = torch_gen(seed, device)
        centers = torch.rand((n_clusters, d), generator=gen,
                             device=device).mul_(255.0)
        scales = torch.rand((n_clusters, 1), generator=gen,
                            device=device).mul_(20.0).add_(4.0)
        idx = torch.from_numpy(assign).to(device)
        pts = torch.randn((n, d), generator=gen, device=device)
        return pts.mul_(scales[idx]).add_(centers[idx])

    return Corpus(seed, n, d, u, offsets, values, make)
