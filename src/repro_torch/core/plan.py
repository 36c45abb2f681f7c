"""Batched query planning (Algorithm 1 steps 10-22, lifted out of the search).

The per-query recursion in ``promish_e``/``promish_a`` interleaves bucket
selection with subset search, so every query pays its own device dispatches.
This module separates the *what to search* decision from the searching: per
scale, :func:`plan_scale` collects every covering-bucket subset for a whole
batch of queries up front (bucket selection, bitset filtering, Algorithm-2
dedup keyed per query), producing a flat list of :class:`SubsetTask` that a
``DistanceBackend`` can pack into a single fused device dispatch.

Both the single-query searches (a batch of one) and the serving engine's
``query_batch`` pipeline are built on this layer.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.index import PromishIndex
from repro_torch.core.types import KeywordDataset


@dataclasses.dataclass
class PlanStats:
    """Bucket-selection accounting. ``promish_e.SearchStats`` is a duck-typed
    superset, so the single-query searches pass their own stats object."""

    buckets_selected: int = 0
    duplicate_subsets: int = 0
    filtered_subsets: int = 0      # pruned: no point satisfied the predicate
    buckets_pruned_zonemap: int = 0  # zone map proved no eligible bulk member


@dataclasses.dataclass(frozen=True)
class SubsetTask:
    """One covering-bucket subset F' queued for search on behalf of a query.

    ``diam_ub`` bounds the diameter of any subset drawn from the source
    bucket (``2 * synopsis radius``; +inf without a synopsis or when delta
    members ride along). When the bound already beats the query's live
    ``r_k`` every pair joins, so the dispatcher can substitute an infinite
    pruning radius — the all-ones-mask fast path that skips the device —
    without changing any result (enumeration settles membership in float64
    at the live radius either way).
    """

    qidx: int            # position in the batch
    f_ids: np.ndarray    # sorted unique point ids of F'
    diam_ub: float = float("inf")


def query_bitset(dataset: KeywordDataset, query: Sequence[int]) -> np.ndarray:
    """BS: mark every point tagged with >=1 query keyword (Alg. 1 steps 4-6)."""
    bs = np.zeros(dataset.n, dtype=bool)
    for v in query:
        bs[dataset.ikp.row(v)] = True
    return bs


class BatchPlanContext:
    """Per-batch memoization shared by planning and keyword grouping.

    One batch touches the same few keywords over and over: every scale's
    covering-bucket selection re-reads the same I_khb rows, and every subset
    task re-runs a membership test per query keyword. The context converts
    both into per-batch one-time work:

      * :meth:`kw_mask` — a boolean corpus mask per keyword, built once and
        reused by every bitset and every keyword-group restriction;
      * :meth:`covering` — the per-(scale, query) covering-bucket array,
        computed once even when duplicate queries share a batch or the
        fallback stage revisits a scale.

    The context is valid for exactly one batch. Build a fresh one per
    ``query_batch`` call.
    """

    def __init__(self, dataset: KeywordDataset):
        self.dataset = dataset
        self._kw_masks: dict[int, np.ndarray] = {}
        self._covers: dict[tuple, np.ndarray] = {}

    def kw_mask(self, v: int) -> np.ndarray:
        m = self._kw_masks.get(v)
        if m is None:
            m = np.zeros(self.dataset.n, dtype=bool)
            m[self.dataset.ikp.row(int(v))] = True
            self._kw_masks[v] = m
        return m

    def query_bitset(self, query: Sequence[int]) -> np.ndarray:
        bs = np.zeros(self.dataset.n, dtype=bool)
        for v in query:
            bs |= self.kw_mask(v)
        return bs

    def covering(self, hi, scale: int, query: Sequence[int]) -> np.ndarray:
        key = (id(hi), scale, tuple(query))
        cover = self._covers.get(key)
        if cover is None:
            cover = self._covers[key] = covering_buckets(hi, query)
        return cover


def covering_buckets(hi, query: Sequence[int]) -> np.ndarray:
    """Buckets containing all query keywords: intersect I_khb rows by counting."""
    counts = np.zeros(hi.n_buckets, dtype=np.int32)
    for v in query:
        counts[hi.khb.row(v)] += 1
    return np.flatnonzero(counts == len(query))


def plan_scale(index: PromishIndex, scale: int,
               queries: Sequence[Sequence[int]],
               bitsets: Sequence[np.ndarray],
               active: Sequence[int],
               explored: dict[int, set[bytes]] | None,
               stats: PlanStats | None = None,
               ctx: BatchPlanContext | None = None,
               delta=None,
               eligible: np.ndarray | None = None,
               zone=None) -> list[SubsetTask]:
    """Collect every subset to search at ``scale`` for the active queries.

    ``explored`` maps query index -> Algorithm-2 hash set (exact set-hash on
    sorted id bytes); pass None for ProMiSH-A semantics (disjoint bins make
    within-scale subsets distinct, and the paper does not dedup across
    scales). Task order is (query, bucket) — identical to the per-query loop,
    so a batch of one reproduces the classic search exactly.

    ``delta`` (a :class:`repro_torch.core.index.IndexDelta`) switches the
    plan to the streaming bulk ∪ delta view: coverage comes from the merged
    live corpus (bulk khb minus dead buckets, plus delta postings) and each
    covering bucket's subset is the bulk members (tombstones already cleared
    from the bitset) concatenated with the live relevant delta members.
    Delta ids all exceed bulk ids, so the concatenation stays sorted.

    ``eligible`` (an (N,) bool point-eligibility mask from
    ``core.filters.Filter.evaluate``) makes the plan *selectivity-aware*:
    subsets stay **unfiltered** — so Algorithm-2 keys and the backend's
    tile LRU entries are shared across filters — but a subset with no
    eligible member is pruned here, before any pack or dispatch (counted in
    ``PlanStats.filtered_subsets``). Pruning runs after the Algorithm-2
    dedup, so a fully-ineligible subset is checked once per query, not once
    per covering bucket.

    ``zone`` (a :class:`repro_torch.core.store.ZoneMapPruner`, requires
    ``eligible``) consults the scale's bucket synopsis *before* the member
    list is touched: a bucket whose zone map is provably disjoint from the
    filter — and that has no delta members, which the bulk-built synopsis
    cannot speak for — is skipped outright (``buckets_pruned_zonemap``),
    saving the (possibly memory-mapped) member-list read the other prunes
    would still pay. A zone-rejected bucket's subset is entirely
    ineligible, so the eligibility prune above would have dropped it anyway:
    results are bit-identical with ``zone`` on or off. Each task carries its
    bucket's diameter bound (``SubsetTask.diam_ub``) where the scale has a
    synopsis.
    """
    hi = index.structures[scale]
    syn = hi.synopsis
    tasks: list[SubsetTask] = []
    if delta is not None and len(active):
        # Resolve suspect (keyword, bucket) coverage once for the whole
        # batch: every query sharing a keyword reuses the same pass.
        delta.verify_suspects(
            scale, {int(v) for qidx in active for v in queries[qidx]})
    for qidx in active:
        bs = bitsets[qidx]
        if delta is None:
            cover = ctx.covering(hi, scale, queries[qidx]) \
                if ctx is not None else covering_buckets(hi, queries[qidx])
            d_buckets = d_ids = None
        else:
            cover = delta.covering_buckets(scale, queries[qidx])
            d_buckets, d_ids = delta.scale_pairs(scale, bs)
        rej = zone.reject(syn, cover) \
            if zone is not None and eligible is not None else None
        for ci, b in enumerate(cover):
            if stats is not None:
                stats.buckets_selected += 1
            dlo = dhi = 0
            if d_buckets is not None and len(d_buckets):
                dlo, dhi = np.searchsorted(d_buckets, [b, b + 1])
            if rej is not None and rej[ci] and dhi == dlo:
                # The synopsis speaks for the bulk members only; with no
                # delta members riding along, every point the bucket could
                # contribute is provably ineligible — skip before the
                # member-list read.
                if stats is not None:
                    stats.buckets_pruned_zonemap += 1
                continue
            pts = hi.table.row(int(b))
            # table rows are sorted unique point ids (CSR contract), so the
            # bitset filter preserves that — no np.unique on the hot path.
            f = np.ascontiguousarray(pts[bs[pts]], dtype=np.int64)
            if dhi > dlo:
                f = np.concatenate([f, d_ids[dlo:dhi]])
            if len(f) == 0:
                continue
            if explored is not None:
                key = f.tobytes()
                if key in explored[qidx]:
                    if stats is not None:
                        stats.duplicate_subsets += 1
                    continue
                explored[qidx].add(key)
            if eligible is not None and not eligible[f].any():
                if stats is not None:
                    stats.filtered_subsets += 1
                continue
            diam_ub = 2.0 * float(syn.radius[b]) \
                if syn is not None and dlo == dhi else float("inf")
            tasks.append(SubsetTask(qidx=qidx, f_ids=f, diam_ub=diam_ub))
    return tasks


def fallback_tasks(bitsets: Sequence[np.ndarray],
                   active: Sequence[int],
                   eligible: np.ndarray | None = None) -> list[SubsetTask]:
    """Alg. 1 steps 33-39: the full relevant-point subset per unfinished query.

    Unlike the per-scale plan, the fallback filters ``eligible`` directly
    into the subset: fallback subsets are near-corpus-sized and unique to the
    query, so there is no cache-sharing argument for keeping ineligible
    points — shrinking the pack dominates."""
    tasks = []
    for qidx in active:
        f = np.flatnonzero(bitsets[qidx]).astype(np.int64)
        if eligible is not None:
            f = f[eligible[f]]
        tasks.append(SubsetTask(qidx=qidx, f_ids=f))
    return tasks
