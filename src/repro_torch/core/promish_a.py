"""ProMiSH-A: approximate NKS search (paper §VI).

Differences from ProMiSH-E (kept faithful):
  * index uses non-overlapping bins -> one signature per point,
    so hashtables are 2^m-times smaller;
  * PQ starts empty (no +inf sentinels), so the first explored buckets set
    r_k and prune aggressively;
  * terminates after the first scale at which PQ holds k results;
  * no subset-duplicate check is needed (a point lives in exactly one bucket
    per scale, so bucket subsets within a scale are disjoint) — the plan
    layer runs with ``explored=None``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import plan
from repro_torch.core.index import PromishIndex
from repro_torch.core.promish_e import SearchStats, _search_flex
from repro_torch.core.semantics import QuerySemantics
from repro_torch.core.subset_search import (DistanceFn, pairwise_l2_numpy,
                                            search_in_subset)
from repro_torch.core.types import KeywordDataset, TopK


def search(dataset: KeywordDataset, index: PromishIndex, query: Sequence[int],
           k: int = 1, distance_fn: DistanceFn = pairwise_l2_numpy,
           stats: SearchStats | None = None,
           eligible: np.ndarray | None = None,
           semantics=None) -> TopK:
    """Approximate top-k NKS search. ``eligible`` applies a filtered query's
    point-eligibility mask: every returned candidate is drawn from eligible
    points only, with the same subset-pruning and group-restriction
    mechanics as ProMiSH-E. ``semantics`` enables the flexible
    m-of-k/weighted/scored modes through the shared ``_search_flex`` loop
    (A semantics: empty queue, no dedup, stop at the first scale that fills
    it)."""
    if index.exact:
        raise ValueError("ProMiSH-A requires an approximate (disjoint-bin) index")
    query = sorted(set(int(v) for v in query))
    stats = stats if stats is not None else SearchStats()

    sem = QuerySemantics.coerce(semantics)
    if sem is not None and not sem.trivial_for(query):
        return _search_flex(dataset, index, query, k, sem,
                            distance_fn, stats, eligible, exact=False)

    pq = TopK(k)
    bitsets = [plan.query_bitset(dataset, query)]

    for s in range(index.n_scales):
        stats.scales_visited += 1
        for task in plan.plan_scale(index, s, [query], bitsets, [0],
                                    None, stats, eligible=eligible):
            stats.subsets_searched += 1
            stats.candidates_explored += search_in_subset(
                task.f_ids, query, dataset, pq, distance_fn=distance_fn,
                eligible=eligible)
        if pq.full():
            return pq

    # Fallback mirrors ProMiSH-E: guarantees an answer when the hash never
    # co-locates all keywords (rare; more likely for very selective queries).
    stats.fallback = True
    for task in plan.fallback_tasks(bitsets, [0], eligible=eligible):
        stats.candidates_explored += search_in_subset(
            task.f_ids, query, dataset, pq, distance_fn=distance_fn,
            eligible=eligible)
    return pq
