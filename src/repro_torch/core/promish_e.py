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

from repro_torch.core import plan
from repro_torch.core.index import PromishIndex
from repro_torch.core.subset_search import (DistanceFn, pairwise_l2_numpy,
                                            search_in_subset)
from repro_torch.core.types import KeywordDataset, TopK


@dataclasses.dataclass
class SearchStats:
    """Instrumentation for the paper's §VII/§VIII measurements."""

    buckets_selected: int = 0
    subsets_searched: int = 0
    duplicate_subsets: int = 0
    candidates_explored: int = 0   # N_p
    scales_visited: int = 0
    fallback: bool = False


def search(dataset: KeywordDataset, index: PromishIndex, query: Sequence[int],
           k: int = 1, distance_fn: DistanceFn = pairwise_l2_numpy,
           stats: SearchStats | None = None) -> TopK:
    """Exact top-k NKS search. Returns the priority queue PQ."""
    if not index.exact:
        raise ValueError("ProMiSH-E requires an exact (overlapping-bin) index")
    query = sorted(set(int(v) for v in query))
    if any(v < 0 or v >= dataset.n_keywords for v in query):
        raise ValueError("query keyword outside dictionary")
    stats = stats if stats is not None else SearchStats()

    pq = TopK(k)
    bitsets = [plan.query_bitset(dataset, query)]
    explored: dict[int, set[bytes]] = {0: set()}   # HC of Algorithm 2

    for s in range(index.n_scales):
        stats.scales_visited += 1
        for task in plan.plan_scale(index, s, [query], bitsets, [0],
                                    explored, stats):
            stats.subsets_searched += 1
            stats.candidates_explored += search_in_subset(
                task.f_ids, query, dataset, pq, distance_fn=distance_fn)
        # Termination (steps 29-31): r_k <= w0 * 2^(s-1)
        if pq.kth_diameter() <= index.w0 * (2.0 ** (s - 1)):
            return pq

    # Fallback: search all relevant points (steps 33-39).
    stats.fallback = True
    for task in plan.fallback_tasks(bitsets, [0]):
        stats.candidates_explored += search_in_subset(
            task.f_ids, query, dataset, pq, distance_fn=distance_fn)
    return pq
