"""Search within a subset of points (paper §V, Algorithms 3-4).

Given a subset F' (points from one hash bucket filtered by the query bitset),
find all candidates tighter than the current k-th diameter:

  1. group F' by query keyword                      (step 2-5 of Alg. 3)
  2. pairwise inner joins at threshold r_k          (steps 6-18) — this is the
     dense hot spot; the join comes from a ``repro_torch.core.backend``
     ``DistanceBackend`` (numpy float64 on the control plane, the fused
     CUDA threshold-join kernel on the card),
  3. greedy least-edge group ordering               (steps 19-30; optimal is NP-hard),
  4. pruned multi-way join (Alg. 4), updating the top-k queue.

The join contract between the distance stage and enumeration is a **packed
adjacency bitmask**: ``mask[i, j // 32]`` bit ``j % 32`` (LSB-first) is set
iff points i and j of the subset join at the pruning radius ``r_k + slack``.
The device backend emits the mask directly (a 32x smaller readback than the
dense fp32 block); the numpy backend packs it on the host from exact float64
distances at the *current* r_k.

Algorithm 4 itself is a **vectorized frontier expansion** over that bitmask
(:func:`_frontier_tuples`): candidate prefixes live in numpy blocks, each
prefix carries the bitwise-AND of its members' adjacency rows, and extending
by the next keyword group is one bit-gather + ``np.nonzero`` — no per-element
Python until the final offers. Completed tuples are re-scored in batched
float64 (:func:`tuple_diameters_f64`) instead of rebuilding a dense
(|F'|, |F'|) float64 matrix per subset. Above ``frontier_limit`` materialised
prefixes the stage falls back to the classic pruned recursion
(:func:`_enumerate_recursive`), whose shrinking-r_k pruning bounds worst-case
blowup; approximate blocks only ever admit *extra* work, never wrong results.

:func:`search_in_subset` composes both stages for the classic per-query path.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.types import Candidate, KeywordDataset, TopK
from repro_torch.utils.csr import sorted_member

# distance backend fn: (A:(n,d), B:(m,d)) -> (n,m) float L2 distances
DistanceFn = Callable[[np.ndarray, np.ndarray], np.ndarray]

# Frontier rows above which Alg. 4 falls back to the pruned recursion: the
# frontier prunes at the (stale) dispatch-time radius, so a loose radius over
# a big subset can materialise far more prefixes than the recursion would
# visit with its live r_k.
DEFAULT_FRONTIER_LIMIT = 100_000

_BIT_SHIFTS = np.arange(32, dtype=np.uint32)


def pairwise_l2_numpy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Reference pairwise Euclidean distance (control-plane backend).

    float64 throughout: the ||a||^2+||b||^2-2ab identity cancels
    catastrophically in float32 for coordinates ~1e4 (diagonal errors up to
    ~sqrt(40)); the fp32 join kernel is therefore used only as a *pruning*
    filter, with candidate diameters re-scored through this exact path.

    Self-distance calls (``b is a``) get an exact-zero diagonal: even in
    float64 the identity leaves ~sqrt(ulp) diagonal residue, which would
    inflate repeated-point tuple diameters.
    """
    same = b is a
    a = np.asarray(a, dtype=np.float64)
    b = a if same else np.asarray(b, dtype=np.float64)
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    if same:
        np.fill_diagonal(sq, 0.0)
    np.maximum(sq, 0.0, out=sq)
    return np.sqrt(sq, out=sq)


def group_by_keyword(f_ids: np.ndarray, query: Sequence[int],
                     dataset: KeywordDataset) -> list[np.ndarray]:
    """SL: one id-array per query keyword (a point may appear in several).
    ``f_ids`` must be sorted (plan emits sorted unique ids); membership runs
    through searchsorted against each keyword's sorted I_kp row."""
    return [f_ids[sorted_member(f_ids, dataset.ikp.row(v))] for v in query]


def local_groups(f_ids: np.ndarray, query: Sequence[int],
                 dataset: KeywordDataset,
                 eligible: np.ndarray | None = None,
                 ctx=None) -> list[np.ndarray] | None:
    """Keyword groups as *row indices into f_ids* (Alg. 3 steps 2-5), or None
    when some query keyword has no representative in the subset (no candidate
    can exist — Alg. 3 bails before any distance work). Row indices come from
    ``np.searchsorted`` over the already-sorted ``f_ids``, or directly from
    the batch context's keyword masks when one is supplied (same rows, no
    per-task searchsorted).

    ``eligible`` (the (N,) predicate mask of a filtered query) restricts each
    group to eligible points. Enumeration only ever indexes adjacency rows
    through the groups, so this single restriction is what makes the whole
    Alg. 3/4 stage respect the mask: ineligible points can sit in the subset
    (keeping pack/cache keys filter-independent) yet never enter a
    candidate. A group emptied by the filter bails exactly like a missing
    keyword."""
    if ctx is not None:
        groups = []
        for v in query:
            rows = np.flatnonzero(ctx.kw_mask(v)[f_ids])
            if eligible is not None:
                rows = rows[eligible[f_ids[rows]]]
            if len(rows) == 0:
                return None
            groups.append(rows)
        return groups
    groups = group_by_keyword(f_ids, query, dataset)
    if eligible is not None:
        groups = [g[eligible[g]] for g in groups]
    if any(len(g) == 0 for g in groups):
        return None
    return [np.searchsorted(f_ids, g) for g in groups]


def greedy_group_order(m_counts: np.ndarray) -> list[int]:
    """Greedy least-weight-edge ordering (Alg. 3 steps 19-30).

    ``m_counts[i, j]`` = number of point pairs surviving the inner join of
    groups i and j. Repeatedly take the globally smallest remaining edge and
    append its unvisited endpoints.
    """
    q = m_counts.shape[0]
    if q == 1:
        return [0]
    iu, ju = _triu_indices(q)
    # stable argsort on the edge weights reproduces the classic
    # (count, i, j) tuple sort: ties keep the lexicographic (i, j) order
    # _triu_indices generates them in.
    order: list[int] = []
    seen = [False] * q
    for e in np.argsort(m_counts[iu, ju], kind="stable"):
        for v in (int(iu[e]), int(ju[e])):
            if not seen[v]:
                seen[v] = True
                order.append(v)
        if len(order) == q:
            break
    for i in range(q):          # isolated groups (no surviving pairs)
        if not seen[i]:
            order.append(i)
    return order


def is_minimal_candidate(ids: Sequence[int], query: Sequence[int],
                         dataset: KeywordDataset) -> bool:
    """Paper's candidate definition: covers Q and no proper subset does.
    Equivalent test: every point contributes >=1 query keyword that no other
    point in the set contributes."""
    kws = [set(int(x) for x in dataset.kw.row(p)) & set(query) for p in ids]
    for i in range(len(ids)):
        others = set().union(*(kws[j] for j in range(len(ids)) if j != i)) if len(ids) > 1 else set()
        if not (kws[i] - others):
            return False
    return True


# --------------------------------------------------------------- bitmask join
def pack_join_mask(adj: np.ndarray) -> np.ndarray:
    """(n, m) bool adjacency -> (n, ceil(m/32)) uint32, LSB-first per word.

    The host-side twin of the kernel's packed-mask output: bit ``j % 32`` of
    ``mask[i, j // 32]`` is ``adj[i, j]``; bits past ``m`` are zero.
    """
    n, m = adj.shape
    w = max((m + 31) // 32, 1)
    bits = np.zeros((n, w * 32), dtype=np.uint32)
    bits[:, :m] = adj
    return (bits.reshape(n, w, 32) << _BIT_SHIFTS).sum(axis=2, dtype=np.uint32)


def unpack_join_mask(mask: np.ndarray, n_cols: int) -> np.ndarray:
    """(n, W) uint32 packed adjacency -> (n, n_cols) uint8 0/1 matrix.

    One ``np.unpackbits`` call: the little-endian byte view of each uint32
    word yields bits in exactly column order (LSB-first contract)."""
    bytes_view = np.ascontiguousarray(mask).view(np.uint8)
    return np.unpackbits(bytes_view, axis=1, bitorder="little",
                         count=n_cols)


_TRIU_CACHE: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def _triu_indices(q: int) -> tuple[np.ndarray, np.ndarray]:
    out = _TRIU_CACHE.get(q)
    if out is None:
        out = _TRIU_CACHE[q] = np.triu_indices(q, 1)
    return out


def pair_counts(adj: np.ndarray, groups: list[np.ndarray]) -> np.ndarray:
    """Inner-join edge weights M[vi, vj] (Alg. 3 steps 6-18): survivors of
    the join between each group pair, counted on the 0/1 adjacency. One
    column-sum per group over its adjacency rows, then a gather per pair —
    O(q*n + q^2*|g|) instead of a (|gi|, |gj|) slice per pair."""
    q = len(groups)
    m_counts = np.zeros((q, q), dtype=np.int64)
    if q < 2:
        return m_counts
    colsum = [adj[g].sum(axis=0, dtype=np.int64) for g in groups]
    for i in range(q):
        ci = colsum[i]
        for j in range(i + 1, q):
            m_counts[i, j] = m_counts[j, i] = int(ci[groups[j]].sum())
    return m_counts


def _frontier_tuples(adj: np.ndarray, ordered_groups: list[np.ndarray],
                     limit: int, pts: np.ndarray | None = None,
                     thr: float = np.inf, d2: np.ndarray | None = None,
                     w: np.ndarray | None = None
                     ) -> tuple[np.ndarray, np.ndarray | None] | None:
    """Vectorized Alg. 4: expand candidate prefixes group-by-group over the
    join adjacency. Each frontier row keeps the bitwise-AND of its members'
    adjacency rows, so the extension test for the next group is one column
    gather; ``np.nonzero``'s row-major order preserves the recursion's
    lexicographic enumeration order.

    With ``pts`` (float64 subset coordinates), every adjacency-surviving
    extension is additionally *refined* against exact float64 distances at
    ``thr`` — the live r_k at subset start. This recovers the recursion's
    live-radius pruning that a dispatch-time mask cannot encode (the mask
    radius is a stale upper bound), and yields each completed tuple's
    diameter for free as the running max of refined pair distances.

    ``d2`` (a precomputed (n, n) float64 *squared*-distance matrix over the
    subset) replaces the per-extension einsum with a table gather — cheaper
    than recomputing coordinate differences whenever total candidate pairs
    exceed the n^2 build cost, which the caller decides by subset size.

    ``w`` (per-row weights for the streaming ``pts`` path; a weighted caller
    using ``d2`` pre-scales the table instead) folds flexible-semantics
    keyword weights into the refinement: each squared pair distance is
    multiplied by the pair's weight product before the max/threshold, so the
    returned diameters are weighted costs — identical arithmetic to the
    pre-scaled table and the oracle.

    Returns ``(tuples (T, q), diams (T,) | None)``, or None once the frontier
    exceeds ``limit`` (caller falls back to the pruned recursion)."""
    g0 = np.asarray(ordered_groups[0], dtype=np.int64)
    prefix = g0[:, None]
    compat = adj[g0]
    thr2 = thr * thr
    refine = pts is not None or d2 is not None
    d2max = np.zeros(len(g0)) if refine else None
    for g in ordered_groups[1:]:
        g = np.asarray(g, dtype=np.int64)
        fi, gj = np.nonzero(compat[:, g])
        if fi.size > limit:
            return None
        cand = g[gj]
        if refine:
            if d2 is not None:
                d2new = d2[prefix[fi], cand[:, None]].max(axis=1)   # (C, i) -> (C,)
            else:
                diff = pts[prefix[fi]] - pts[cand][:, None, :]      # (C, i, d)
                d2new = np.einsum("cid,cid->ci", diff, diff)
                if w is not None:
                    d2new = d2new * (w[prefix[fi]] * w[cand][:, None])
                d2new = d2new.max(axis=1)
            d2new = np.maximum(d2new, d2max[fi])
            keep = d2new <= thr2
            fi, cand, d2max = fi[keep], cand[keep], d2new[keep]
        prefix = np.concatenate([prefix[fi], cand[:, None]], axis=1)
        compat = compat[fi] & adj[cand]
    return prefix, (np.sqrt(d2max) if refine else None)


def tuple_diameters_f64(pts: np.ndarray) -> np.ndarray:
    """(T, q, d) float64 -> (T,) max pairwise L2 distances.

    Batched float64 rescore for frontier tuples, kept in float64 because the
    enumeration contract requires exact diameters before the top-k queue.
    """
    pts = np.asarray(pts, dtype=np.float64)
    sq = np.einsum("tqd,tqd->tq", pts, pts)
    gram = np.einsum("tqd,trd->tqr", pts, pts)
    d2 = np.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * gram, 0.0)
    return np.sqrt(d2.max(axis=(1, 2)))


# ------------------------------------------------------------------- offers
def _offer_singletons(rows: np.ndarray, f_ids: np.ndarray,
                      query: Sequence[int], dataset: KeywordDataset,
                      pq: TopK, gate: bool) -> int:
    """Offer one-point candidates (diameter 0) for every row whose point
    covers the whole query — the only tuples Alg. 4 can produce when the
    inner join has no off-diagonal pairs. ``gate`` applies the recursion's
    offer predicate (diam < r_k plus minimality); the q=1 fast path offers
    ungated, exactly as Alg. 4's base case does."""
    for o in rows:
        ids = (int(f_ids[o]),)
        if not gate:
            pq.offer(Candidate(ids=ids, diameter=0.0))
        elif 0.0 < pq.kth_diameter() and is_minimal_candidate(ids, query, dataset):
            pq.offer(Candidate(ids=ids, diameter=0.0))
    return len(rows)


def _offer_tuples(tuples: np.ndarray, diams: np.ndarray, f_ids: np.ndarray,
                  query: Sequence[int], dataset: KeywordDataset,
                  pq: TopK) -> None:
    """Offer completed tuples in enumeration order. The vectorized prefilter
    uses the entry r_k (an upper bound of the running r_k); the live gate
    re-checks against the current k-th diameter exactly as the recursion's
    ``offer`` does."""
    for i in np.flatnonzero(diams < pq.kth_diameter()):
        diam = float(diams[i])
        if diam >= pq.kth_diameter():
            continue
        ids = tuple(sorted(set(int(x) for x in f_ids[tuples[i]])))
        if is_minimal_candidate(ids, query, dataset):
            pq.offer(Candidate(ids=ids, diameter=diam))


# ----------------------------------------------------- recursion (fallback)
def _enumerate_recursive(f_ids: np.ndarray, ordered_groups: list[np.ndarray],
                         query: Sequence[int], dataset: KeywordDataset,
                         pq: TopK, dist: np.ndarray, slack: float,
                         rescore: bool) -> int:
    """Alg. 4's pruned nested loops — the above-``frontier_limit`` fallback.
    Prunes with the *live* r_k (tightening after every successful offer), so
    worst-case blowup stays bounded where the frontier's dispatch-time radius
    would not."""
    q = len(query)
    r_k = pq.kth_diameter()
    explored = 0
    # Lazy float64 self-distances for rescoring: built once per subset, on the
    # first completed tuple.
    exact_dist: np.ndarray | None = None

    def offer(cur: list[int], cur_r: float, r_k: float) -> float:
        nonlocal explored, exact_dist
        explored += 1
        ids = tuple(sorted(set(int(f_ids[c]) for c in cur)))
        if rescore:
            if exact_dist is None:
                pts = dataset.points[f_ids]
                exact_dist = pairwise_l2_numpy(pts, pts)
            diam = max((float(exact_dist[a, b]) for i, a in enumerate(cur)
                        for b in cur[i + 1:]), default=0.0)
        else:
            diam = float(cur_r)
        if diam < r_k and is_minimal_candidate(ids, query, dataset):
            if pq.offer(Candidate(ids=ids, diameter=diam)):
                return pq.kth_diameter()
        return r_k

    def recurse(idx: int, cur: list[int], cur_r: float, r_k: float) -> float:
        if idx == q:
            return offer(cur, cur_r, r_k)
        last = cur[-1]
        for o in ordered_groups[idx]:
            dlast = dist[last, o]
            if dlast > r_k + slack:
                continue
            new_r = cur_r
            ok = True
            for c in cur:
                dd = dist[c, o]
                if dd > r_k + slack:
                    ok = False
                    break
                if dd > new_r:
                    new_r = dd
            if ok:
                cur.append(int(o))
                r_k = recurse(idx + 1, cur, new_r, r_k)
                cur.pop()
        return r_k

    for o in ordered_groups[0]:
        r_k = recurse(1, [int(o)], 0.0, r_k)
    return explored


# ------------------------------------------------------- enumeration stages
def enumerate_with_distances(f_ids: np.ndarray, gl: list[np.ndarray],
                             query: Sequence[int], dataset: KeywordDataset,
                             pq: TopK, dist: np.ndarray, *,
                             slack: float = 0.0,
                             rescore: bool = False,
                             frontier_limit: int = DEFAULT_FRONTIER_LIMIT,
                             weights: np.ndarray | None = None) -> int:
    """Host enumeration over a dense self-distance block ``dist``.

    Packs the join mask at the *current* ``r_k + slack`` and runs the
    vectorized frontier; ``slack`` widens the predicate so an approximate
    (fp32 device) block never prunes a true candidate, and ``rescore``
    recomputes surviving diameters in float64 so approximate blocks only ever
    admit *extra* work, never wrong results. Mutates ``pq``; returns the
    number of candidate tuples fully materialised (the N_p statistic of
    §VII).

    ``weights`` ((N,) float64 per-point keyword weights, all >= 1) switches
    the objective to the weighted cost: the *geometric* ``dist``-derived
    mask keeps pruning (it is a superset of the weighted join — weighted
    cost dominates geometric diameter), while settlement runs through
    :func:`_enumerate_weighted`'s float64 weighted tables, exactly like the
    mask path.
    """
    q = len(query)
    if q == 1:
        return _offer_singletons(gl[0], f_ids, query, dataset, pq,
                                  gate=False)

    r_k = pq.kth_diameter()
    thr = r_k + slack
    adj = dist <= thr if np.isfinite(thr) \
        else np.ones(dist.shape, dtype=bool)
    # Self-distances are exactly 0, but the norms-identity arithmetic leaves
    # ~sqrt(ulp) noise on the diagonal of ``dist`` — enough to exclude
    # repeated-point (singleton) tuples once r_k reaches 0.
    np.fill_diagonal(adj, True)
    order = greedy_group_order(pair_counts(adj, gl))
    ordered_groups = [gl[i] for i in order]

    if weights is not None:
        return _enumerate_weighted(f_ids, adj, ordered_groups, query,
                                   dataset, pq, weights, frontier_limit)
    out = _frontier_tuples(adj, ordered_groups, frontier_limit)
    if out is None:
        return _enumerate_recursive(f_ids, ordered_groups, query, dataset,
                                    pq, dist, slack, rescore)
    tuples, _ = out
    if rescore:
        diams = tuple_diameters_f64(dataset.points[f_ids][tuples])
    else:
        diams = dist[tuples[:, :, None], tuples[:, None, :]].max(axis=(1, 2))
    _offer_tuples(tuples, diams, f_ids, query, dataset, pq)
    return len(tuples)


# Subset size below which the mask path precomputes the full float64
# squared-distance table for frontier refinement: the n^2*d build is cheaper
# than per-extension coordinate einsums as soon as the frontier materialises
# more candidate pairs than n^2, which small/mid subsets essentially always
# do. Large subsets keep the streaming einsum (no quadratic materialisation).
_D2_TABLE_MAX_N = 512


def _sq_dists_f64(pts: np.ndarray) -> np.ndarray:
    """(n, d) float64 -> (n, n) squared L2 distances.

    Difference-based (not the norms identity): the table must be *bitwise*
    interchangeable with the frontier's per-extension coordinate einsum, so
    it uses the same subtract-then-einsum arithmetic, chunked to bound the
    (rows, n, d) temporary."""
    n, d = pts.shape
    d2 = np.empty((n, n), dtype=np.float64)
    step = max(1, (1 << 22) // max(1, n * d))
    for i in range(0, n, step):
        diff = pts[i:i + step, None, :] - pts[None, :, :]
        d2[i:i + step] = np.einsum("ijd,ijd->ij", diff, diff)
    return d2


def _enumerate_weighted(f_ids: np.ndarray, adj: np.ndarray,
                        ordered_groups: list[np.ndarray],
                        query: Sequence[int], dataset: KeywordDataset,
                        pq: TopK, weights: np.ndarray,
                        frontier_limit: int) -> int:
    """Weighted-cost settlement over a *geometric* adjacency superset.

    ``adj`` was packed at the geometric pruning radius; with all weights
    >= 1 the weighted cost dominates the geometric diameter, so every
    weighted-joining pair is present and the mask only over-admits. The
    float64 squared-distance tables are pre-scaled by the pair weight
    product (:func:`repro_torch.core.semantics.weighted_pair_sq`
    arithmetic), so the frontier's refine-at-live-r_k and the recursion
    fallback both prune and settle directly in weighted cost."""
    pts = np.asarray(dataset.points[f_ids], dtype=np.float64)
    wloc = np.asarray(weights, dtype=np.float64)[f_ids]
    d2 = None
    if len(f_ids) <= _D2_TABLE_MAX_N:
        d2 = _sq_dists_f64(pts) * (wloc[:, None] * wloc[None, :])
    out = _frontier_tuples(adj, ordered_groups, frontier_limit,
                           pts=None if d2 is not None else pts,
                           thr=pq.kth_diameter(), d2=d2,
                           w=None if d2 is not None else wloc)
    if out is None:
        if d2 is None:
            d2 = _sq_dists_f64(pts) * (wloc[:, None] * wloc[None, :])
        return _enumerate_recursive(f_ids, ordered_groups, query, dataset,
                                    pq, np.sqrt(d2), 0.0, False)
    tuples, diams = out
    _offer_tuples(tuples, diams, f_ids, query, dataset, pq)
    return len(tuples)


def enumerate_with_block(f_ids: np.ndarray, gl: list[np.ndarray],
                         query: Sequence[int], dataset: KeywordDataset,
                         pq: TopK, block, *,
                         frontier_limit: int = DEFAULT_FRONTIER_LIMIT,
                         timers: dict | None = None,
                         weights: np.ndarray | None = None) -> int:
    """Host enumeration over a backend ``DistanceBlock``.

    Dense blocks re-pack the mask at the live r_k; mask-only device blocks
    are consumed as-is (their mask is fixed at the dispatch-time pruning
    radius, a safe superset of the live one). A block whose inner join has no
    off-diagonal pair at the dispatch radius short-circuits to the singleton
    scan — the adaptive-radii feedback that skips host enumeration for
    subsets the kernel already proved empty (the coarse bf16 prune tier
    lands here too: a pruned block carries ``join_count <= n_live`` and is
    never unpacked). Mutates ``pq``; returns N_p.

    ``block.rows`` marks an eligible-dense device block (low-selectivity
    packing): the mask covers only the subset-local eligible row positions
    in ``rows``, so groups — already restricted to eligible points — are
    remapped into that packed row space before the adjacency is consumed.

    ``timers`` (optional dict) accumulates ``rescore_s``: wall time in the
    float64 settlement of surviving tuples (table build + refine/recursion),
    the cascade's exact tier.

    ``weights`` ((N,) per-point keyword weights, all >= 1) routes settlement
    through :func:`_enumerate_weighted` — the geometric mask stays a valid
    superset of the weighted join, all the short-circuits below (diagonal
    bound, singleton scan) are weight-invariant, and the unweighted path is
    byte-identical to before.
    """
    if block.dist is not None:
        return enumerate_with_distances(
            f_ids, gl, query, dataset, pq, block.dist, slack=block.slack,
            rescore=block.rescore, frontier_limit=frontier_limit,
            weights=weights)

    q = len(query)
    if q == 1:
        return _offer_singletons(gl[0], f_ids, query, dataset, pq,
                                  gate=False)

    n_live = block.n if block.n_eligible is None else block.n_eligible
    if block.join_count <= n_live:
        # Only diagonal (self) pairs join: the multi-way join can only emit
        # single repeated points, i.e. points present in every keyword group.
        # With an eligibility mask folded into the block, counts cover only
        # eligible pairs, so the diagonal bound is the eligible point count.
        common = gl[0]
        for g in gl[1:]:
            common = common[sorted_member(common, g)]
        return _offer_singletons(common, f_ids, query, dataset, pq,
                                  gate=True)

    rows = block.rows
    if rows is not None:
        # Eligible-dense block: translate groups (subset-local rows, all
        # eligible by construction) into the packed eligible-row space and
        # restrict the id view to the packed rows.
        gl = [np.searchsorted(rows, g) for g in gl]
        f_ids = f_ids[rows]
    n_adj = block.n if rows is None else len(rows)
    # mask=None marks an infinite-radius block (all pairs join by
    # construction; the backend skipped the device round-trip).
    adj = np.ones((n_adj, n_adj), dtype=np.uint8) if block.mask is None \
        else unpack_join_mask(block.mask, n_adj)
    # Device-packed masks can drop the diagonal to fp32 noise at near-zero
    # dispatch radii; self-pairs always join (d(p,p) = 0).
    np.fill_diagonal(adj, 1)
    # Live-row restriction: the expansion only ever consults rows that are
    # members of some keyword group — the rest of the subset exists solely
    # to have joined on the device. Restricting the adjacency, coordinates,
    # and the float64 table to the group union shrinks the dominant
    # settlement cost from |subset|^2 to |live|^2 without changing a single
    # value (every distance entry depends only on its own row pair).
    live = np.unique(np.concatenate(gl))
    if len(live) < n_adj:
        remap = np.empty(n_adj, np.int64)
        remap[live] = np.arange(len(live))
        gl = [remap[g] for g in gl]
        f_ids = f_ids[live]
        adj = adj[np.ix_(live, live)]
        n_adj = len(live)
    order = greedy_group_order(pair_counts(adj, gl))
    ordered_groups = [gl[i] for i in order]
    t0 = time.perf_counter() if timers is not None else 0.0
    if weights is not None:
        explored = _enumerate_weighted(f_ids, adj, ordered_groups, query,
                                       dataset, pq, weights, frontier_limit)
        if timers is not None:
            timers["rescore_s"] = timers.get("rescore_s", 0.0) \
                + time.perf_counter() - t0
        return explored
    pts = np.asarray(dataset.points[f_ids], dtype=np.float64)
    d2 = _sq_dists_f64(pts) if n_adj <= _D2_TABLE_MAX_N else None
    # The mask prunes at the (stale) dispatch radius; the float64 refine
    # inside the expansion re-prunes at the live r_k and hands back exact
    # diameters, subsuming the batched rescore.
    out = _frontier_tuples(adj, ordered_groups, frontier_limit,
                           pts=None if d2 is not None else pts,
                           thr=pq.kth_diameter(), d2=d2)
    if out is None:
        # Mask too loose for vectorized expansion: rebuild exact float64
        # distances and run the live-r_k recursion (no slack, no rescore).
        # Always through pairwise_l2_numpy — the recursion's historical
        # distance source — so fallback results stay bit-identical.
        dist = pairwise_l2_numpy(pts, pts)
        explored = _enumerate_recursive(f_ids, ordered_groups, query, dataset,
                                        pq, dist, 0.0, False)
        if timers is not None:
            timers["rescore_s"] = timers.get("rescore_s", 0.0) \
                + time.perf_counter() - t0
        return explored
    tuples, diams = out
    if timers is not None:
        timers["rescore_s"] = timers.get("rescore_s", 0.0) \
            + time.perf_counter() - t0
    _offer_tuples(tuples, diams, f_ids, query, dataset, pq)
    return len(tuples)


def search_in_subset(f_ids: np.ndarray, query: Sequence[int],
                     dataset: KeywordDataset, pq: TopK,
                     distance_fn: DistanceFn = pairwise_l2_numpy,
                     eligible: np.ndarray | None = None,
                     weights: np.ndarray | None = None) -> int:
    """Algorithms 3+4, both stages fused (the per-query path). Mutates ``pq``;
    returns the number of candidate tuples fully materialised. ``eligible``
    applies a filtered query's point-eligibility mask (see
    :func:`local_groups`); ``weights`` switches settlement to the weighted
    cost (see :func:`enumerate_with_distances`)."""
    f_ids = np.unique(np.asarray(f_ids, dtype=np.int64))
    if len(f_ids) == 0:
        return 0
    gl = local_groups(f_ids, query, dataset, eligible=eligible)
    if gl is None:
        return 0
    pts = dataset.points[f_ids]
    dist = distance_fn(pts, pts)                      # (|F'|, |F'|)
    return enumerate_with_distances(f_ids, gl, query, dataset, pq, dist,
                                    weights=weights)
