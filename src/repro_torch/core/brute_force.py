"""Brute-force NKS oracle — exhaustive enumeration of all minimal candidates.

Ground truth for correctness tests and for the paper's quality metrics
(AAR denominators, Table II's N_n). Exponential in q; use on small data only.

Every entry point takes an optional ``eligible`` (N,) bool mask — the
filtered-NKS oracle restricts per-keyword groups to eligible points, which is
*definitionally* the search over the filtered sub-corpus (every candidate is
a set of eligible points covering Q, minimality judged on keyword sets, which
filtering does not change). :func:`search_filtered` is the serving-shaped
wrapper: it evaluates a ``core.filters.Filter`` (predicates + tenant scoping)
into the mask first, so differential suites can drive the oracle with the
exact filter object the engine receives.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import TYPE_CHECKING, Sequence

import numpy as np

from repro_torch.core import semantics as semantics_mod
from repro_torch.core.subset_search import is_minimal_candidate, pairwise_l2_numpy
from repro_torch.core.types import Candidate, KeywordDataset, TopK

if TYPE_CHECKING:
    from repro_torch.core.semantics import QuerySemantics


def set_diameter(ids: Sequence[int], dataset: KeywordDataset) -> float:
    ids = list(ids)
    if len(ids) <= 1:
        return 0.0
    pts = dataset.points[np.asarray(ids)]
    return float(pairwise_l2_numpy(pts, pts).max())


def _query_groups(dataset: KeywordDataset, query: Sequence[int],
                  eligible: np.ndarray | None) -> list[np.ndarray]:
    """Per-keyword candidate groups, restricted to eligible points."""
    groups = [dataset.ikp.row(v) for v in query]
    if eligible is not None:
        groups = [g[eligible[g]] for g in groups]
    return groups


def enumerate_candidates(dataset: KeywordDataset, query: Sequence[int],
                         eligible: np.ndarray | None = None):
    """Yield every distinct minimal candidate set (as a sorted id tuple)."""
    query = sorted(set(int(v) for v in query))
    groups = _query_groups(dataset, query, eligible)
    if any(len(g) == 0 for g in groups):
        return
    seen: set[tuple[int, ...]] = set()
    for combo in itertools.product(*groups):
        ids = tuple(sorted(set(int(c) for c in combo)))
        if ids in seen:
            continue
        seen.add(ids)
        if is_minimal_candidate(ids, query, dataset):
            yield ids


def search(dataset: KeywordDataset, query: Sequence[int], k: int = 1,
           chunk: int = 250_000, max_tuples: float = 5e7,
           eligible: np.ndarray | None = None) -> TopK:
    """Exact top-k by full enumeration (vectorised).

    Enumerates the full cartesian product of per-keyword groups, computes all
    tuple diameters in chunked numpy, then scans tuples in diameter order
    applying the dedup + minimality filters until the top-k is stable. Any
    minimal candidate arises from at least one tuple with equal diameter, so
    the scan is exhaustive.

    ``eligible`` restricts the per-keyword groups before the product — the
    filtered oracle is the unfiltered oracle over the eligible sub-corpus.
    Refuses instances beyond ``max_tuples`` (the oracle is exponential in q
    by design — use ProMiSH-E as ground truth at scale, as the paper does).
    """
    query = sorted(set(int(v) for v in query))
    groups = _query_groups(dataset, query, eligible)
    if any(len(g) == 0 for g in groups):
        return TopK(k)
    total_est = 1.0
    for g in groups:
        total_est *= len(g)
    if total_est > max_tuples:
        raise ValueError(
            f"brute-force oracle infeasible: {total_est:.2e} tuples "
            f"(> {max_tuples:.0e}); use promish_e as ground truth")
    grids = np.meshgrid(*groups, indexing="ij")
    tuples = np.stack([g.ravel() for g in grids], axis=1).astype(np.int64)  # (T, q)
    t_total = len(tuples)
    diams = np.empty(t_total, dtype=np.float32)
    pts = dataset.points
    for lo in range(0, t_total, chunk):
        x = pts[tuples[lo:lo + chunk]].astype(np.float64)    # (C, q, d)
        diff = x[:, :, None, :] - x[:, None, :, :]
        sq = np.einsum("cijd,cijd->cij", diff, diff)
        diams[lo:lo + chunk] = np.sqrt(np.maximum(sq, 0.0)).max(axis=(1, 2))

    pq = TopK(k)
    order = np.argsort(diams, kind="stable")
    for idx in order:
        d = float(diams[idx])
        if pq.full() and d > pq.kth_diameter():
            break
        ids = tuple(sorted(set(int(p) for p in tuples[idx])))
        if is_minimal_candidate(ids, query, dataset):
            pq.offer(Candidate(ids=ids, diameter=d))
    return pq


def search_filtered(dataset: KeywordDataset, query: Sequence[int],
                    flt, k: int = 1, **kw) -> TopK:
    """Filtered/tenant-scoped oracle: evaluate a ``core.filters.Filter`` into
    the eligibility mask, resolve tenant-local keywords through the corpus
    namespace when the filter is tenant-scoped, and run :func:`search` over
    the eligible sub-corpus — the differential ground truth for the engine's
    ``query_batch(..., filter=...)`` path."""
    from repro_torch.core.filters import Filter
    flt = Filter.coerce(flt)
    if flt is None:
        return search(dataset, query, k=k, **kw)
    if flt.tenant is not None and dataset.tenants is not None:
        query = dataset.tenants.resolve(flt.tenant, query)
    return search(dataset, query, k=k, eligible=flt.evaluate(dataset), **kw)


def count_candidates(dataset: KeywordDataset, query: Sequence[int],
                     eligible: np.ndarray | None = None) -> int:
    """N_n of eq. 4 (measured, not modelled)."""
    return sum(1 for _ in enumerate_candidates(dataset, query,
                                               eligible=eligible))


# ------------------------------------------------------- flexible semantics
def weighted_set_cost(ids: Sequence[int], dataset: KeywordDataset,
                      wvec: np.ndarray | None) -> float:
    """Weighted diameter of a group: ``max sqrt(d2(a,b) * w(a) * w(b))``.

    The canonical arithmetic (difference-based float64 squared distances,
    weight product applied to the *squared* table, sqrt of the max) matches
    the fast path's frontier tables exactly — with ``wvec=None`` this is the
    plain geometric diameter."""
    ids = [int(i) for i in ids]
    if len(ids) <= 1:
        return 0.0
    pts = dataset.points[np.asarray(ids)].astype(np.float64)
    diff = pts[:, None, :] - pts[None, :, :]
    d2 = np.einsum("ijd,ijd->ij", diff, diff)
    if wvec is not None:
        d2 = semantics_mod.weighted_pair_sq(d2, wvec[np.asarray(ids)])
    return float(np.sqrt(d2.max()))


def enumerate_candidates_flex(dataset: KeywordDataset, query: Sequence[int],
                              sem: "QuerySemantics",
                              eligible: np.ndarray | None = None):
    """The flexible candidate universe: every distinct id set that is a
    minimal candidate for *some* keyword subset ``S ⊆ Q`` with ``|S| >= m``
    (classic minimal candidates when ``m = |Q|``). Yields sorted id tuples,
    deduped across subqueries — cost and coverage depend only on (ids, Q),
    never on which subquery produced the set."""
    seen: set[tuple[int, ...]] = set()
    for sub in sem.expand_subqueries(query):
        for ids in enumerate_candidates(dataset, sub, eligible=eligible):
            if ids not in seen:
                seen.add(ids)
                yield ids


def search_flex(dataset: KeywordDataset, query: Sequence[int], k: int = 1,
                *, semantics=None, eligible: np.ndarray | None = None
                ) -> list[Candidate]:
    """Flexible-semantics oracle: exhaustive enumeration over the m-of-k
    candidate universe, weighted costs, optional scored ranking — the ground
    truth for every ``semantics=...`` differential suite. Returns the top-k
    as a plain candidate list (scored mode stamps ``Candidate.score``).

    Ranking matches the fast path's queues exactly: ``(cost, |ids|, ids)``
    ascending, or ``(-score, cost, |ids|, ids)`` in scored mode. With
    degenerate semantics (``m = |Q|``, unit weights, no scoring) this
    reduces to :func:`search`'s result set by construction.
    """
    sem = semantics_mod.QuerySemantics.coerce(semantics) \
        or semantics_mod.QuerySemantics()
    query = sorted(set(int(v) for v in query))
    wvec = sem.weight_vector(dataset, query)
    cands = []
    for ids in enumerate_candidates_flex(dataset, query, sem,
                                         eligible=eligible):
        cands.append(Candidate(
            ids=ids, diameter=weighted_set_cost(ids, dataset, wvec)))
    if sem.score:
        cov = sem.coverage_fn(dataset, query)
        cands = [dataclasses.replace(
                     c, score=cov(c.ids) / (1.0 + sem.alpha * c.diameter))
                 for c in cands]
        cands.sort(key=lambda c: (-c.score, c.diameter, len(c.ids), c.ids))
    else:
        cands.sort(key=Candidate.key)
    return cands[:k]
