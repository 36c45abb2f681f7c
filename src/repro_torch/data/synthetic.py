"""Synthetic dataset generator exactly per paper §VIII:

  * each coordinate uniform in [0, 10000]
  * each point tagged with t keywords drawn from a dictionary of size U
    (uniformly, like the paper's complexity model §VII).

Draws are made in the same order as the reference package's generator, so a
seed yields the same corpus and the same queries in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import KeywordDataset, make_dataset, merge_tenants


def synthetic_dataset(n: int, d: int, u: int, t: int = 1, *, seed: int = 0,
                      coord_range: float = 10_000.0) -> KeywordDataset:
    rng = np.random.default_rng(seed)
    points = rng.uniform(0.0, coord_range, size=(n, d)).astype(np.float32)
    # t distinct keywords per point
    if t == 1:
        kws = rng.integers(0, u, size=(n, 1))
    else:
        kws = np.argsort(rng.random((n, u)), axis=1)[:, :t]
    keywords = [row.tolist() for row in kws]
    return make_dataset(points, keywords, n_keywords=u)


def random_queries(dataset: KeywordDataset, q: int, n_queries: int, *,
                   seed: int = 0, require_nonempty: bool = True) -> list[list[int]]:
    """Random q-keyword queries from the dictionary (paper §VIII), keeping only
    keywords that tag >=1 point so every query has at least one candidate."""
    rng = np.random.default_rng(seed)
    present = np.flatnonzero(np.diff(dataset.ikp.offsets) > 0) if require_nonempty \
        else np.arange(dataset.n_keywords)
    if len(present) < q:
        raise ValueError("not enough populated keywords for query size")
    return [sorted(rng.choice(present, size=q, replace=False).tolist())
            for _ in range(n_queries)]


def synthetic_attrs(n: int, *, seed: int = 0, price_range: float = 100.0,
                    n_categories: int = 8) -> dict:
    """Per-point attribute columns for filtered-NKS workloads: a uniform
    numeric ``price`` (so a threshold at ``price_range * s`` hits selectivity
    ~s exactly) and a categorical ``category``."""
    rng = np.random.default_rng(seed + 101)
    return {
        "price": rng.uniform(0.0, price_range, size=n),
        "category": rng.integers(0, n_categories, size=n, dtype=np.int64),
    }


def attach_attrs(dataset: KeywordDataset, *, seed: int = 0,
                 price_range: float = 100.0,
                 n_categories: int = 8) -> KeywordDataset:
    """The same corpus with synthetic attribute columns attached."""
    return dataclasses.replace(
        dataset, attrs=synthetic_attrs(dataset.n, seed=seed,
                                       price_range=price_range,
                                       n_categories=n_categories))


def synthetic_tenants(tenant_sizes: "dict[str, int]", d: int, u: int,
                      t: int = 2, *, seed: int = 0,
                      with_attrs: bool = True) -> KeywordDataset:
    """A multi-tenant corpus: one synthetic sub-corpus per tenant, each with
    its own keyword namespace of size ``u``, packed via
    :func:`repro_torch.core.types.merge_tenants`."""
    corpora = {}
    for i, (name, n) in enumerate(tenant_sizes.items()):
        ds = synthetic_dataset(n=n, d=d, u=u, t=t, seed=seed + 7 * i)
        corpora[name] = {
            "points": ds.points,
            "keywords": [ds.kw.row(j).tolist() for j in range(ds.n)],
            "n_keywords": u,
            "attrs": synthetic_attrs(n, seed=seed + 13 * i) if with_attrs
            else None,
        }
    return merge_tenants(corpora)
