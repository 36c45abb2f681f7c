"""ProMiSH-E: exact NKS search (paper §IV, Algorithm 1).

Scale loop over the HI structures; per scale:
  * the plan layer (:mod:`repro_torch.core.plan`) selects covering buckets,
    filters them through the query bitset BS, and dedups subsets
    (Algorithm 2 semantics — an exact set-hash on the sorted id bytes, which
    is Algorithm 2 with a perfect hash: identical semantics, no false
    positives),
  * each planned subset runs subset search (§V).
Terminates at the first scale where the k-th diameter r_k <= w/2 = w0*2^(s-1);
Lemma 2 then guarantees every tighter candidate was already contained in some
explored bucket. Falls back to a full search over the relevant points if no
scale terminates (steps 33-39).

This is the single-query path (a plan batch of one). The batched serving
pipeline in ``repro_torch.serve.engine`` shares the same plan layer and fuses
all subsets of a scale into a few device dispatches.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import plan
from repro_torch.core.index import PromishIndex
from repro_torch.core.semantics import QuerySemantics
from repro_torch.core.subset_search import (DistanceFn, pairwise_l2_numpy,
                                            search_in_subset)
from repro_torch.core.types import KeywordDataset, TopK


@dataclasses.dataclass
class SearchStats:
    """Instrumentation for the paper's §VII/§VIII measurements."""

    buckets_selected: int = 0
    subsets_searched: int = 0
    duplicate_subsets: int = 0
    filtered_subsets: int = 0      # predicate-pruned subsets (filtered NKS)
    candidates_explored: int = 0   # N_p
    scales_visited: int = 0
    fallback: bool = False


def search(dataset: KeywordDataset, index: PromishIndex, query: Sequence[int],
           k: int = 1, distance_fn: DistanceFn = pairwise_l2_numpy,
           stats: SearchStats | None = None,
           eligible: np.ndarray | None = None,
           semantics=None) -> TopK:
    """Exact top-k NKS search. Returns the priority queue PQ.

    ``eligible`` is an (N,) bool point-eligibility mask (from
    ``core.filters.Filter.evaluate``): the search then answers over the
    filtered sub-corpus exactly — ineligible points are pruned from planning
    and from every keyword group, while the Lemma-2 termination bound is
    unaffected (the filtered corpus is a subset of the indexed one).

    ``semantics`` (a :class:`repro_torch.core.semantics.QuerySemantics` or
    its wire-dict form) enables m-of-k coverage, keyword weights, and scored
    ranking via :func:`_search_flex`; degenerate semantics (full coverage,
    unit weights, no scoring) fall straight through to the classic loop, so
    results stay bit-identical to a plain call.
    """
    if not index.exact:
        raise ValueError("ProMiSH-E requires an exact (overlapping-bin) index")
    query = sorted(set(int(v) for v in query))
    if any(v < 0 or v >= dataset.n_keywords for v in query):
        raise ValueError("query keyword outside dictionary")
    stats = stats if stats is not None else SearchStats()

    sem = QuerySemantics.coerce(semantics)
    if sem is not None and not sem.trivial_for(query):
        return _search_flex(dataset, index, query, k, sem,
                            distance_fn, stats, eligible, exact=True)

    pq = TopK(k)
    bitsets = [plan.query_bitset(dataset, query)]
    explored: dict[int, set[bytes]] = {0: set()}   # HC of Algorithm 2

    for s in range(index.n_scales):
        stats.scales_visited += 1
        for task in plan.plan_scale(index, s, [query], bitsets, [0],
                                    explored, stats, eligible=eligible):
            stats.subsets_searched += 1
            stats.candidates_explored += search_in_subset(
                task.f_ids, query, dataset, pq, distance_fn=distance_fn,
                eligible=eligible)
        # Termination (steps 29-31): r_k <= w0 * 2^(s-1)
        if pq.kth_diameter() <= index.w0 * (2.0 ** (s - 1)):
            return pq

    # Fallback: search all relevant points (steps 33-39).
    stats.fallback = True
    for task in plan.fallback_tasks(bitsets, [0], eligible=eligible):
        stats.candidates_explored += search_in_subset(
            task.f_ids, query, dataset, pq, distance_fn=distance_fn,
            eligible=eligible)
    return pq


def _search_flex(dataset: KeywordDataset, index: PromishIndex,
                 query: list[int], k: int, sem: QuerySemantics,
                 distance_fn: DistanceFn, stats: SearchStats,
                 eligible: np.ndarray | None, exact: bool):
    """Flexible-semantics scale loop shared by ProMiSH-E and ProMiSH-A.

    The query expands into its m-of-k subqueries; each runs the existing
    plan/subset-search machinery verbatim — its own bitset, its own
    Algorithm-2 explored set (E only), minimality judged against its own
    keyword subset — all feeding ONE shared queue (classic or scored, from
    ``sem.make_pq``). Candidate costs and coverage depend only on (ids, Q),
    so the queue's id-set dedup resolves cross-subquery duplicates exactly.

    Termination is unchanged: weighted costs dominate geometric diameters
    (weights >= 1), so a candidate with cost below the Lemma-2 scale bound
    has geometric diameter below it too and was contained in some explored
    bucket of its subquery; ``ScoredTopK.kth_diameter`` converts the k-th
    score into the equivalent cost bound.
    """
    subqueries = sem.expand_subqueries(query)
    wvec = sem.weight_vector(dataset, query)
    pq = sem.make_pq(dataset, query, k)
    bitsets = [plan.query_bitset(dataset, sub) for sub in subqueries]
    active = list(range(len(subqueries)))
    explored = {i: set() for i in active} if exact else None

    for s in range(index.n_scales):
        stats.scales_visited += 1
        for task in plan.plan_scale(index, s, subqueries, bitsets, active,
                                    explored, stats, eligible=eligible):
            stats.subsets_searched += 1
            stats.candidates_explored += search_in_subset(
                task.f_ids, subqueries[task.qidx], dataset, pq,
                distance_fn=distance_fn, eligible=eligible, weights=wvec)
        if exact:
            if pq.kth_diameter() <= index.w0 * (2.0 ** (s - 1)):
                return pq
        elif pq.full():
            return pq

    stats.fallback = True
    for task in plan.fallback_tasks(bitsets, active, eligible=eligible):
        stats.candidates_explored += search_in_subset(
            task.f_ids, subqueries[task.qidx], dataset, pq,
            distance_fn=distance_fn, eligible=eligible, weights=wvec)
    return pq
