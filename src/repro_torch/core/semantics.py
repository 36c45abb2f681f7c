"""Flexible query semantics: m-of-k partial coverage, per-keyword weights,
and scored ranking.

Classic NKS is all-or-nothing — a candidate must cover *every* query keyword
and ranks by geometric diameter alone. Real search traffic is softer; this
module is the single definition of the three relaxations the whole pipeline
(oracle, per-query searches, batched engine) shares:

* **m-of-k coverage** (the Flexible Group Spatial Keyword Query's subgroup
  query): a result may cover any ``m`` of the ``k=len(Q)`` query keywords.
  Mechanically a query expands into *subqueries* — every keyword subset
  ``S ⊆ Q`` with ``m <= |S| <= |Q|`` — each planned and enumerated through
  the existing Algorithm-2 machinery unchanged (its own bitset, its own
  dedup set), all feeding one shared top-k queue. The candidate universe is
  exactly "groups minimal with respect to *some* subset of >= m query
  keywords"; with ``m = |Q|`` the only subquery is Q itself and everything
  degenerates to classic NKS.

* **per-keyword weights** (the ``title^4`` field-boost idiom): each query
  keyword carries a weight ``w >= 1``; a point's weight is the *largest*
  weight among the query keywords it is tagged with (set-determined — no
  assignment problem, so id-set dedup and minimality are untouched), and the
  objective becomes the weighted diameter ``max sqrt(d2(a,b) * w(a) * w(b))``
  over the group's pairs. The ``w >= 1`` floor is load-bearing twice over:
  weighted cost dominates geometric diameter, so (a) the geometric join
  mask at radius ``r_k`` stays a *superset* of the weighted-joining pairs —
  no kernel or backend changes — and (b) Lemma 2's termination test remains
  sound (a candidate with cost below the scale bound has geometric diameter
  below it too, hence was contained in some explored bucket).

* **scored top-k**: rank by ``score = coverage / (1 + alpha * cost)`` where
  ``coverage`` is the summed weight of the query keywords the group covers
  and ``cost`` the weighted diameter — tighter and better-covering groups
  both win. :class:`~repro_torch.core.types.ScoredTopK` duck-types ``TopK``
  and converts the k-th score back into a *cost* pruning bound, so every
  existing ``kth_diameter``-driven prune and the Lemma-2 termination keep
  working unchanged.

The canonical weighted arithmetic — multiply *squared* float64 distances by
the weight product, then ``sqrt`` of the max — is shared by the brute-force
oracle, the vectorized frontier, and the recursion fallback, so differential
suites compare like with like.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.types import KeywordDataset, ScoredTopK, TopK

# Hard cap on subqueries per original query: k-choose-m explodes for long
# queries with small m; past this the request is a planning DoS, not a
# search. NKS queries are short (the paper sweeps q <= 9), so the cap is
# far above any legitimate expansion.
MAX_SUBQUERIES = 512

_ALLOWED_KEYS = frozenset(("m", "weights", "score", "alpha"))


@dataclasses.dataclass(frozen=True)
class QuerySemantics:
    """The request-level semantics knobs, validated at construction.

    ``m`` — minimum query keywords a result must cover (None = all of them).
    ``weights`` — keyword id -> weight, every weight >= 1 (boost semantics).
    ``score`` — rank by blended score instead of pure cost.
    ``alpha`` — the score's cost-sensitivity (> 0); ignored unless ``score``.
    """

    m: int | None = None
    weights: dict[int, float] | None = None
    score: bool = False
    alpha: float = 1.0

    def __post_init__(self):
        if self.m is not None and (not isinstance(self.m, int)
                                   or isinstance(self.m, bool) or self.m < 1):
            raise ValueError(f"semantics.m must be a positive int, got {self.m!r}")
        if self.weights is not None:
            for kw, w in self.weights.items():
                if not np.isfinite(w) or w < 1.0:
                    raise ValueError(
                        f"keyword weight must be a finite value >= 1 "
                        f"(boost semantics), got {kw}^{w}")
        if not (np.isfinite(self.alpha) and self.alpha > 0):
            raise ValueError(f"semantics.alpha must be > 0, got {self.alpha}")

    # ------------------------------------------------------------- coercion
    @classmethod
    def coerce(cls, obj) -> "QuerySemantics | None":
        """None / QuerySemantics / JSON-dict -> validated QuerySemantics.

        The dict form is the wire shape the runtime and launcher speak:
        ``{"m": 2, "weights": {"3": 4.0}, "score": true, "alpha": 0.5}``
        (JSON object keys are strings; they coerce to keyword ids here).
        """
        if obj is None or isinstance(obj, cls):
            return obj
        if not isinstance(obj, dict):
            raise ValueError(f"semantics must be a dict or QuerySemantics, "
                             f"got {type(obj).__name__}")
        unknown = set(obj) - _ALLOWED_KEYS
        if unknown:
            raise ValueError(f"unknown semantics key(s): {sorted(unknown)}")
        weights = obj.get("weights")
        if weights is not None:
            weights = {int(kw): float(w) for kw, w in weights.items()}
        m = obj.get("m")
        return cls(m=int(m) if m is not None else None, weights=weights,
                   score=bool(obj.get("score", False)),
                   alpha=float(obj.get("alpha", 1.0)))

    def canonical_key(self) -> str:
        """Deterministic string form — the runtime's batch-coalescing key
        component (requests may only share a ``query_batch`` call when their
        semantics agree)."""
        w = sorted((self.weights or {}).items())
        return f"m={self.m};w={w};s={self.score};a={self.alpha}"

    def resolve_keywords(self, mapper: Callable[[int], int]) -> "QuerySemantics":
        """Map weight keys through a keyword-id translation (tenant-local ->
        global dictionary slots, same convention as query keywords)."""
        if not self.weights:
            return self
        return dataclasses.replace(
            self, weights={int(mapper(kw)): w
                           for kw, w in self.weights.items()})

    # ----------------------------------------------------------- degeneracy
    def trivial_for(self, query: Sequence[int]) -> bool:
        """True when these semantics cannot change the classic answer for
        ``query``: full coverage required, no non-unit weight touches the
        query, no scoring. Validates ``m`` against the query length."""
        q = [int(v) for v in query]
        if self.m is not None and self.m > len(q):
            raise ValueError(
                f"semantics.m={self.m} exceeds the query's {len(q)} keywords")
        if self.score:
            return False
        if self.m is not None and self.m < len(q):
            return False
        w = self.weights or {}
        return all(float(w.get(v, 1.0)) == 1.0 for v in q)

    # ------------------------------------------------------------ expansion
    def expand_subqueries(self, query: Sequence[int]) -> list[list[int]]:
        """Every keyword subset S with ``m <= |S| <= |Q|``, largest first
        (the full query leads, so the degenerate expansion is ``[Q]``).
        Subset order only affects exploration order, never results: the
        shared queue's key is a total order on id sets."""
        q = sorted(set(int(v) for v in query))
        m = len(q) if self.m is None else int(self.m)
        if not 1 <= m <= len(q):
            raise ValueError(
                f"semantics.m={m} out of range for a {len(q)}-keyword query")
        # closed-form count guards the cap before materialising anything
        total = sum(_n_choose(len(q), size) for size in range(m, len(q) + 1))
        if total > MAX_SUBQUERIES:
            raise ValueError(
                f"semantics.m={m} expands a {len(q)}-keyword query into "
                f"{total} subqueries (cap {MAX_SUBQUERIES}); raise m")
        out: list[list[int]] = []
        for size in range(len(q), m - 1, -1):
            out.extend(list(c) for c in itertools.combinations(q, size))
        return out

    # -------------------------------------------------------------- weights
    def weight_vector(self, dataset: KeywordDataset,
                      query: Sequence[int]) -> np.ndarray | None:
        """(N,) float64 per-point weights for ``query``, or None when every
        relevant weight is 1 (the caller then skips weighting entirely —
        the unweighted hot path stays bit-identical).

        ``w(p) = max{ weight(v) : v in kw(p) ∩ Q }`` — set-determined, so a
        candidate's cost depends only on its id set and the query, never on
        which subquery enumerated it (id-set dedup stays sound)."""
        w = self.weights or {}
        boosted = [(int(v), float(w[v])) for v in query
                   if float(w.get(v, 1.0)) != 1.0]
        if not boosted:
            return None
        wvec = np.ones(dataset.n, dtype=np.float64)
        for v, wv in boosted:
            rows = dataset.ikp.row(v)
            wvec[rows] = np.maximum(wvec[rows], wv)
        return wvec

    def total_weight(self, query: Sequence[int]) -> float:
        w = self.weights or {}
        return float(sum(float(w.get(int(v), 1.0)) for v in query))

    def coverage_fn(self, dataset: KeywordDataset,
                    query: Sequence[int]) -> Callable[[Sequence[int]], float]:
        """ids -> summed weight of the query keywords the group covers (the
        scored mode's numerator)."""
        qset = {int(v) for v in query}
        w = self.weights or {}

        def cov(ids: Sequence[int]) -> float:
            covered: set[int] = set()
            for p in ids:
                covered.update(
                    v for v in (int(x) for x in dataset.kw.row(int(p)))
                    if v in qset)
            return float(sum(float(w.get(v, 1.0)) for v in covered))

        return cov

    # ------------------------------------------------------------------ pq
    def make_pq(self, dataset: KeywordDataset, query: Sequence[int],
                k: int) -> "TopK | ScoredTopK":
        """The per-query result queue: classic ``TopK`` unless scoring.
        Flex queues are tie-open: m-of-k coverage admits equal-cost
        candidates (cost-0 singletons especially), which the strict
        enumeration gates must let through to the key-based tie-break."""
        if not self.score:
            return TopK(k, tie_open=True)
        return ScoredTopK(k, total_weight=self.total_weight(query),
                          alpha=self.alpha,
                          coverage=self.coverage_fn(dataset, query))


def _n_choose(n: int, r: int) -> int:
    out = 1
    for i in range(r):
        out = out * (n - i) // (i + 1)
    return out


def weighted_pair_sq(d2: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Canonical weighting: squared distances times the pair's weight
    product. Shared by the oracle's scan and the fast path's float64 tables
    so both sides of every differential suite run identical arithmetic."""
    return d2 * (w[:, None] * w[None, :])


def parse_weighted_keywords(raw: Sequence) -> tuple[list[int], dict[int, float]]:
    """The launcher's weight grammar: each ``keywords`` entry is either a
    keyword id or a ``"<id>^<weight>"`` boost string (the ``title^4``
    idiom). Returns (keyword ids, weights for the boosted ones).

        ["3", "7^4", 12]  ->  ([3, 7, 12], {7: 4.0})
    """
    kws: list[int] = []
    weights: dict[int, float] = {}
    for entry in raw:
        if isinstance(entry, str) and "^" in entry:
            kw_s, _, w_s = entry.partition("^")
            kw = int(kw_s)
            weights[kw] = float(w_s)
        else:
            kw = int(entry)
        kws.append(kw)
    return kws, weights
