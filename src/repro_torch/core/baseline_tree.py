"""Virtual bR*-Tree baseline (Zhang et al. [2], [7]) — the paper's reference.

A bulk-loaded (STR) R*-style tree whose nodes carry keyword bitmaps and MBRs.
Queries run a best-first branch-and-bound over q-tuples of entries (one per
query keyword, apriori-style growth), pruning by:
  * keyword bitmaps  (a node without keyword v cannot supply group v),
  * MBR pair mindist (a tuple whose max pairwise MINDIST exceeds the current
    r_k cannot contain a better candidate).

This reproduces the reference algorithm's behaviour, including its failure
mode: in high dimensions MBRs overlap (curse of dimensionality), MINDIST
collapses to ~0, pruning stops working, and the frontier grows exponentially —
exactly the >hours runtimes in the paper's figs. 8-10. A ``budget`` caps the
number of frontier pops so benchmarks terminate; hitting it is reported as a
timeout, mirroring the paper's ">5 hours" entries.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Sequence

import numpy as np

from repro_torch.core.subset_search import is_minimal_candidate, pairwise_l2_numpy
from repro_torch.core.types import Candidate, KeywordDataset, TopK


@dataclasses.dataclass
class _Node:
    lo: np.ndarray              # (d,) MBR lower corner
    hi: np.ndarray              # (d,) MBR upper corner
    kw_mask: np.ndarray         # (U,) bool keyword bitmap
    children: list["_Node"] | None   # internal
    point_ids: np.ndarray | None     # leaf
    depth: int = 0

    @property
    def is_leaf(self) -> bool:
        return self.point_ids is not None


class VirtualBRTree:
    """STR-packed R-tree with keyword bitmaps (leaf_size/fanout per paper §VIII:
    1000-entry leaves, 100-entry internal nodes)."""

    def __init__(self, dataset: KeywordDataset, leaf_size: int = 1000, fanout: int = 100):
        self.dataset = dataset
        self.leaf_size = leaf_size
        self.fanout = fanout
        self.root = self._bulk_load()

    # ---------------------------------------------------------------- build
    def _make_leaf(self, ids: np.ndarray) -> _Node:
        pts = self.dataset.points[ids]
        mask = np.zeros(self.dataset.n_keywords, dtype=bool)
        for p in ids:
            mask[self.dataset.kw.row(int(p))] = True
        return _Node(lo=pts.min(0), hi=pts.max(0), kw_mask=mask,
                     children=None, point_ids=ids)

    def _str_partition(self, ids: np.ndarray, node_cap: int) -> list[np.ndarray]:
        """Sort-Tile-Recursive packing of point ids into node_cap-sized cells."""
        pts = self.dataset.points[ids]
        d = pts.shape[1]
        n_cells = int(np.ceil(len(ids) / node_cap))
        order = np.argsort(pts[:, 0], kind="stable")
        ids = ids[order]
        if d == 1 or n_cells == 1:
            return [ids[i * node_cap:(i + 1) * node_cap] for i in range(n_cells)]
        n_slabs = int(np.ceil(np.sqrt(n_cells)))
        slab_sz = int(np.ceil(len(ids) / n_slabs))
        out = []
        for s in range(n_slabs):
            slab = ids[s * slab_sz:(s + 1) * slab_sz]
            if len(slab) == 0:
                continue
            sub = slab[np.argsort(self.dataset.points[slab, 1 % d], kind="stable")]
            for i in range(0, len(sub), node_cap):
                out.append(sub[i:i + node_cap])
        return out

    def _bulk_load(self) -> _Node:
        ids = np.arange(self.dataset.n, dtype=np.int64)
        nodes = [self._make_leaf(c) for c in self._str_partition(ids, self.leaf_size)]
        depth = 1
        while len(nodes) > 1:
            centers = np.stack([(nd.lo + nd.hi) * 0.5 for nd in nodes])
            order = np.lexsort((centers[:, 1 % centers.shape[1]], centers[:, 0]))
            nodes = [nodes[i] for i in order]
            parents = []
            for i in range(0, len(nodes), self.fanout):
                ch = nodes[i:i + self.fanout]
                lo = np.min([c.lo for c in ch], axis=0)
                hi = np.max([c.hi for c in ch], axis=0)
                mask = np.any([c.kw_mask for c in ch], axis=0)
                parents.append(_Node(lo=lo, hi=hi, kw_mask=mask, children=ch,
                                     point_ids=None, depth=depth))
            nodes = parents
            depth += 1
        return nodes[0]

    def nbytes(self) -> int:
        total = 0
        stack = [self.root]
        while stack:
            nd = stack.pop()
            total += nd.lo.nbytes + nd.hi.nbytes + nd.kw_mask.nbytes // 8 + 16
            if nd.children:
                stack.extend(nd.children)
            else:
                total += nd.point_ids.nbytes
        return total

    # ---------------------------------------------------------------- query
    def _mindist_entries(self, a, b) -> float:
        """MINDIST between two entries; an entry is ('n', node) or ('p', id)."""
        lo_a, hi_a = self._bounds(a)
        lo_b, hi_b = self._bounds(b)
        gap = np.maximum(0.0, np.maximum(lo_a - hi_b, lo_b - hi_a))
        return float(np.linalg.norm(gap))

    def _bounds(self, e):
        kind, v = e
        if kind == "p":
            pt = self.dataset.points[v]
            return pt, pt
        return v.lo, v.hi

    def _has_kw(self, e, v: int) -> bool:
        kind, x = e
        if kind == "p":
            return self.dataset.has_keyword(int(x), v)
        return bool(x.kw_mask[v])

    def _tuple_lb(self, entries) -> float:
        lb = 0.0
        for i in range(len(entries)):
            for j in range(i + 1, len(entries)):
                lb = max(lb, self._mindist_entries(entries[i], entries[j]))
        return lb

    def initial_estimate(self, query: Sequence[int], samples: int = 4) -> float:
        """Greedy upper bound on r*: from a few seeds of the rarest keyword,
        chain nearest matching points for the remaining keywords."""
        ds = self.dataset
        groups = {v: ds.ikp.row(v) for v in query}
        rare = min(query, key=lambda v: len(groups[v]))
        if len(groups[rare]) == 0:
            return float("inf")
        best = float("inf")
        seeds = groups[rare][:: max(1, len(groups[rare]) // samples)][:samples]
        for seed in seeds:
            ids = [int(seed)]
            for v in query:
                if v == rare:
                    continue
                cand = groups[v]
                dmat = pairwise_l2_numpy(ds.points[np.asarray(ids)], ds.points[cand])
                ids.append(int(cand[int(np.argmin(dmat.max(axis=0)))]))
            pts = ds.points[np.asarray(ids)]
            best = min(best, float(pairwise_l2_numpy(pts, pts).max()))
        return best

    def search(self, query: Sequence[int], k: int = 1, budget: int = 2_000_000):
        """Best-first exact top-k NKS search. Returns (TopK, timed_out, pops)."""
        query = sorted(set(int(v) for v in query))
        pq = TopK(k)
        est = self.initial_estimate(query)

        frontier: list[tuple[float, int, tuple]] = []
        counter = itertools.count()
        root_tuple = tuple(("n", self.root) for _ in query)
        if all(self._has_kw(("n", self.root), v) for v in query):
            heapq.heappush(frontier, (0.0, next(counter), root_tuple))

        pops = 0
        while frontier:
            lb, _, entries = heapq.heappop(frontier)
            pops += 1
            r_k = min(pq.kth_diameter(), est)
            if lb > r_k:
                break                      # exact: no unexplored tuple can win
            if pops > budget:
                return pq, True, pops
            # pick the first non-point entry to expand (largest volume first
            # would also work; index order keeps tuples canonical)
            expand_i = None
            for i, e in enumerate(entries):
                if e[0] == "n":
                    expand_i = i
                    break
            if expand_i is None:
                ids = tuple(sorted(set(int(e[1]) for e in entries)))
                if is_minimal_candidate(ids, query, self.dataset):
                    pts = self.dataset.points[np.asarray(ids)]
                    diam = float(pairwise_l2_numpy(pts, pts).max()) if len(ids) > 1 else 0.0
                    pq.offer(Candidate(ids=ids, diameter=diam))
                continue
            node = entries[expand_i][1]
            kw = query[expand_i]
            if node.is_leaf:
                kids = [("p", int(p)) for p in node.point_ids
                        if self.dataset.has_keyword(int(p), kw)]
            else:
                kids = [("n", c) for c in node.children if c.kw_mask[kw]]
            for kid in kids:
                new_entries = entries[:expand_i] + (kid,) + entries[expand_i + 1:]
                new_lb = self._tuple_lb(new_entries)
                if new_lb <= min(pq.kth_diameter(), est):
                    heapq.heappush(frontier, (new_lb, next(counter), new_entries))
        return pq, False, pops


def space_cost_model(n: int, d: int, u: int, q: int, t: int = 1,
                     e_bytes: int = 4, fanout: int = 100) -> int:
    """§VIII-D analytic space cost of Virtual bR*-Tree (bytes)."""
    n_nodes = 0
    level = int(np.ceil(n / 1000))
    while level >= 1:
        n_nodes += level
        if level == 1:
            break
        level = int(np.ceil(level / fanout))
    rtree = (2 * d + fanout) * e_bytes * n_nodes
    inv = (np.log(max(n, 2)) / np.log(fanout) + 1) * t * e_bytes * n
    br = (2 * d * e_bytes + 2 * d * e_bytes * q + fanout * e_bytes + u / 8) * n_nodes
    return int(rtree + inv + br)
