"""Flickr-like "real" dataset generator.

The paper's real datasets are grayscale-histogram features of Flickr images
tagged with user keywords (Table III: up to 24,874 unique keywords, ~11-14
tags per point). Offline we synthesise data with the same statistics:

  * points drawn from a Gaussian-mixture (images cluster by visual content),
  * keyword frequencies follow a Zipf law (tag popularity is heavy-tailed),
  * keyword-cluster affinity: tags correlate with clusters (similar photos
    share tags), which is what makes NKS queries meaningful.

The random draws are the reference generator's, in the same order, so a seed
yields the same corpus in both packages. One step is restated: the per-point
Zipf draw ``rng.choice(u, size, replace=True, p=pop)`` rebuilds the
dictionary-sized CDF on every call, which dominates the build at 10^6 points.
Here the CDF is built once and each draw is ``rng.random(size)`` searched into
it — the same arithmetic ``Generator.choice`` performs, so the same keywords.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import KeywordDataset, make_dataset


def flickr_like_dataset(n: int, d: int, u: int, t: int = 11, *,
                        n_clusters: int = 64, zipf_a: float = 1.3,
                        affinity: float = 0.7, seed: int = 0) -> KeywordDataset:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, 255.0, size=(n_clusters, d)).astype(np.float32)
    scales = rng.uniform(4.0, 24.0, size=(n_clusters, 1)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    points = centers[assign] + rng.standard_normal((n, d)).astype(np.float32) * scales[assign]

    # Zipf keyword popularity over the dictionary.
    ranks = np.arange(1, u + 1, dtype=np.float64)
    pop = ranks ** (-zipf_a)
    pop /= pop.sum()
    # cluster-specific preferred keyword pools
    pool_size = max(t * 4, 16)
    cluster_pools = np.stack([
        rng.choice(u, size=pool_size, replace=False, p=pop) for _ in range(n_clusters)
    ])

    cdf = pop.cumsum()
    cdf /= cdf[-1]
    keywords = []
    for i in range(n):
        n_aff = int(round(t * affinity))
        pool = cluster_pools[assign[i]]
        aff = rng.choice(pool, size=min(n_aff, len(pool)), replace=False)
        glob = cdf.searchsorted(rng.random(t - len(aff)), side="right")
        keywords.append(np.unique(np.concatenate([aff, glob])).tolist())
    return make_dataset(points, keywords, n_keywords=u)
