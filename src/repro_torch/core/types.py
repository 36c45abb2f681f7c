"""Core datatypes for NKS (nearest keyword set) search.

A :class:`KeywordDataset` is the paper's ``D``: ``N`` points in ``R^d``, each
tagged with a keyword set drawn from a dictionary of size ``U``. Keywords are
integer ids; the mapping to strings lives in the application layer. A
:class:`StreamingCorpus` is the mutable view a streaming engine serves:
frozen bulk + append-only delta - tombstones.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.utils.csr import (CSR, csr_from_lists, invert_csr,
                                   ragged_arange, sorted_member)


@dataclasses.dataclass(frozen=True)
class TenantNamespace:
    """Per-tenant keyword namespaces over one shared global dictionary.

    Tenant ``t`` owns the contiguous global keyword slots
    ``[kw_offsets[t], kw_offsets[t+1])``; its *local* dictionary is
    ``[0, kw_offsets[t+1] - kw_offsets[t])``. :meth:`resolve` maps a tenant's
    local keyword ids into global slots — the serving layer runs it before
    planning, so the whole search pipeline stays namespace-oblivious (global
    ids only) while tenants can never name each other's keywords.
    """

    names: tuple[str, ...]
    kw_offsets: np.ndarray        # (T + 1,) int64, ascending

    @property
    def n_tenants(self) -> int:
        return len(self.names)

    def id_of(self, tenant: str | int) -> int:
        if isinstance(tenant, str):
            try:
                return self.names.index(tenant)
            except ValueError:
                raise KeyError(f"unknown tenant {tenant!r} "
                               f"(known: {list(self.names)})") from None
        t = int(tenant)
        if not 0 <= t < self.n_tenants:
            raise KeyError(f"tenant id {t} out of range [0, {self.n_tenants})")
        return t

    def dict_size(self, tenant: str | int) -> int:
        t = self.id_of(tenant)
        return int(self.kw_offsets[t + 1] - self.kw_offsets[t])

    def resolve(self, tenant: str | int, local_kws) -> list[int]:
        """Tenant-local keyword ids -> global dictionary slots (validated)."""
        t = self.id_of(tenant)
        size = self.dict_size(t)
        out = []
        for v in local_kws:
            v = int(v)
            if not 0 <= v < size:
                raise ValueError(
                    f"keyword {v} outside tenant {self.names[t]!r} dictionary "
                    f"(size {size})")
            out.append(int(self.kw_offsets[t]) + v)
        return out


def _check_attrs(attrs: "dict[str, np.ndarray] | None", n: int
                 ) -> "dict[str, np.ndarray] | None":
    if attrs is None:
        return None
    out = {}
    for name, col in attrs.items():
        col = np.ascontiguousarray(col)
        if col.shape != (n,):
            raise ValueError(f"attribute {name!r} must be ({n},), "
                             f"got {col.shape}")
        out[str(name)] = col
    return out


@dataclasses.dataclass(frozen=True)
class KeywordDataset:
    """The paper's tagged multi-dimensional dataset.

    points     : (N, d) float32 — the embedded objects.
    kw         : CSR point -> sorted keyword ids (the paper's sigma(o)).
    ikp        : CSR keyword -> sorted point ids (the paper's I_kp inverted index).
    n_keywords : dictionary size U.
    attrs      : optional per-point attribute columns (name -> (N,) array;
                 numeric dtypes take the ordered predicate ops, any dtype the
                 equality/set ops — see ``core.filters``).
    tenant_of  : optional (N,) int tenant id per point (multi-tenant corpora).
    tenants    : optional per-tenant keyword namespace over the dictionary.
    """

    points: np.ndarray
    kw: CSR
    ikp: CSR
    n_keywords: int
    attrs: dict | None = None
    tenant_of: np.ndarray | None = None
    tenants: TenantNamespace | None = None

    @property
    def n(self) -> int:
        return int(self.points.shape[0])

    @property
    def dim(self) -> int:
        return int(self.points.shape[1])

    def points_with(self, keyword: int) -> np.ndarray:
        """I_kp lookup: ids of points tagged with ``keyword``."""
        return self.ikp.row(keyword)

    def has_keyword(self, point_id: int, keyword: int) -> bool:
        row = self.kw.row(point_id)
        j = np.searchsorted(row, keyword)
        return bool(j < len(row) and row[j] == keyword)

    def attr_column(self, name: str) -> np.ndarray:
        """(N,) attribute column for predicate evaluation."""
        if not self.attrs or name not in self.attrs:
            have = sorted(self.attrs) if self.attrs else []
            raise KeyError(f"unknown attribute {name!r} (corpus has: {have})")
        return self.attrs[name]

    @property
    def tenant_ids(self) -> np.ndarray | None:
        """(N,) tenant id per point, or None on a single-tenant corpus."""
        return self.tenant_of


def make_dataset(points: np.ndarray, keywords: Sequence[Sequence[int]],
                 n_keywords: int | None = None, *,
                 attrs: dict | None = None,
                 tenant_of: np.ndarray | None = None,
                 tenants: TenantNamespace | None = None) -> KeywordDataset:
    points = np.ascontiguousarray(points, dtype=np.float32)
    keywords = [sorted(set(int(v) for v in ks)) for ks in keywords]
    if len(keywords) != len(points):
        raise ValueError(f"{len(points)} points but {len(keywords)} keyword sets")
    if n_keywords is None:
        n_keywords = 1 + max((max(ks) for ks in keywords if ks), default=-1)
    attrs = _check_attrs(attrs, len(points))
    if tenant_of is not None:
        tenant_of = np.ascontiguousarray(tenant_of, dtype=np.int32)
        if tenant_of.shape != (len(points),):
            raise ValueError(f"tenant_of must be ({len(points)},), "
                             f"got {tenant_of.shape}")
    kw = csr_from_lists(keywords)
    ikp = invert_csr(kw, n_keywords)
    return KeywordDataset(points=points, kw=kw, ikp=ikp,
                          n_keywords=int(n_keywords), attrs=attrs,
                          tenant_of=tenant_of, tenants=tenants)


def dataset_from_csr(points: np.ndarray, kw: CSR,
                     n_keywords: int) -> KeywordDataset:
    """A dataset from an already-built point -> keywords CSR (rows sorted
    unique). Identical to :func:`make_dataset` over the same rows, without
    the per-point Python pass."""
    return KeywordDataset(points=np.ascontiguousarray(points, np.float32),
                          kw=kw, ikp=invert_csr(kw, n_keywords),
                          n_keywords=int(n_keywords))


def merge_tenants(corpora: "dict[str, dict]") -> KeywordDataset:
    """Pack per-tenant corpora into one multi-tenant :class:`KeywordDataset`.

    ``corpora`` maps tenant name -> ``{"points": (n_t, d), "keywords":
    [[local ids...]], "n_keywords": local dict size, "attrs": optional
    per-tenant columns}``. Each tenant keeps a private keyword namespace:
    local id ``v`` of tenant ``t`` lands in global slot ``offset[t] + v``, so
    identical local ids of different tenants never collide and a
    tenant-scoped query can only ever reach its own postings. Attribute
    schemas must agree across tenants (or be absent everywhere).
    """
    if not corpora:
        raise ValueError("merge_tenants: no tenants")
    names = tuple(corpora)
    sizes = []
    for name in names:
        spec = corpora[name]
        nk = spec.get("n_keywords")
        if nk is None:
            nk = 1 + max((max(ks) for ks in spec["keywords"] if ks), default=-1)
        sizes.append(int(nk))
    offsets = np.zeros(len(names) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    ns = TenantNamespace(names=names, kw_offsets=offsets)

    points, keywords, tenant_of = [], [], []
    schemas = [frozenset(corpora[name].get("attrs") or ()) for name in names]
    if len(set(schemas)) > 1:
        raise ValueError(f"attribute schemas differ across tenants: "
                         f"{[sorted(s) for s in set(schemas)]}")
    attr_chunks: dict[str, list] = {k: [] for k in schemas[0]}
    for t, name in enumerate(names):
        spec = corpora[name]
        pts = np.asarray(spec["points"], dtype=np.float32)
        if pts.ndim != 2 or (points and pts.shape[1] != points[0].shape[1]):
            raise ValueError(f"tenant {name!r}: inconsistent point dims")
        points.append(pts)
        keywords.extend(ns.resolve(t, ks) for ks in spec["keywords"])
        tenant_of.append(np.full(len(pts), t, dtype=np.int32))
        for k in attr_chunks:
            col = np.asarray(spec["attrs"][k])
            if col.shape != (len(pts),):
                raise ValueError(f"tenant {name!r}: attribute {k!r} must be "
                                 f"({len(pts)},), got {col.shape}")
            attr_chunks[k].append(col)
    attrs = {k: np.concatenate(v) for k, v in attr_chunks.items()} or None
    return make_dataset(np.concatenate(points, axis=0), keywords,
                        n_keywords=int(offsets[-1]), attrs=attrs,
                        tenant_of=np.concatenate(tenant_of), tenants=ns)


class _MergedKw:
    """``kw`` adapter of a :class:`StreamingCorpus`: point -> keyword ids."""

    def __init__(self, view: "StreamingCorpus"):
        self._view = view

    def row(self, i: int) -> np.ndarray:
        v = self._view
        if i < v.bulk.n:
            return v.bulk.kw.row(i)
        return v._kw[i - v.bulk.n]


class _MergedIkp:
    """``ikp`` adapter of a :class:`StreamingCorpus`: keyword -> point ids.

    Rows are the *union* of the bulk CSR row and the delta postings —
    tombstoned points are NOT filtered here (the engine clears them from the
    query bitset once per batch, which is cheaper than filtering every
    lookup); :meth:`StreamingCorpus.points_with` is the live-filtered variant
    the device tier packs from. Delta ids are assigned in increasing order
    and all exceed bulk ids, so the concatenated row stays sorted — the
    searchsorted membership tests in ``subset_search`` rely on that.
    """

    def __init__(self, view: "StreamingCorpus"):
        self._view = view

    def row(self, v_kw: int) -> np.ndarray:
        view = self._view
        base = view.bulk.ikp.row(v_kw)
        extra = view._delta_postings(v_kw)
        if not len(extra):
            return base
        return np.concatenate([base.astype(np.int64), extra])


class StreamingCorpus:
    """Mutable merged corpus: immutable bulk + append-only delta - tombstones.

    Duck-types the :class:`KeywordDataset` surface the search pipeline
    touches (``points``, ``kw.row``, ``ikp.row``, ``n``, ``dim``,
    ``n_keywords``, ``points_with``) so the plan/backend/enumeration stages
    run unchanged over a streaming corpus. Internal point ids are bulk rows
    ``[0, bulk.n)`` followed by delta rows in absorption order; deletes are
    tombstones (ids stay allocated until the engine compacts into a fresh
    bulk). The point buffer grows by capacity doubling, so absorbing a batch
    is amortised O(batch), not O(corpus). Attribute columns and the tenant
    column of the delta are kept per absorbed batch; merged columns are
    memoised until the next absorb.
    """

    def __init__(self, bulk: KeywordDataset):
        self.bulk = bulk
        self.n_keywords = bulk.n_keywords
        self.n_delta = 0
        self._kw: list[np.ndarray] = []            # per delta point, sorted kws
        self._ikp: dict[int, list[int]] = {}       # kw -> delta ids (ascending)
        self._ikp_memo: dict[int, np.ndarray] = {}
        self._tomb: set[int] = set()
        self._tomb_sorted = np.empty(0, dtype=np.int64)
        self._buf: np.ndarray | None = None        # growable point storage
        self._filled = 0
        self._attr_chunks: dict[str, list[np.ndarray]] = \
            {k: [] for k in (bulk.attrs or {})}
        self._tenant_chunks: list[np.ndarray] = []
        self._col_memo: dict[str, np.ndarray] = {}

    # ------------------------------------------------------------- geometry
    @property
    def n(self) -> int:
        return self.bulk.n + self.n_delta

    @property
    def dim(self) -> int:
        return self.bulk.dim

    @property
    def kw(self) -> _MergedKw:
        return _MergedKw(self)

    @property
    def ikp(self) -> _MergedIkp:
        return _MergedIkp(self)

    def _ensure_capacity(self, need: int) -> None:
        """Grow the point buffer to hold ``need`` rows (capacity doubling)."""
        if self._buf is None:
            cap = max(1024, 2 * need)
            self._buf = np.empty((cap, self.dim), dtype=np.float32)
            self._buf[: self.bulk.n] = self.bulk.points
            self._filled = self.bulk.n
        elif len(self._buf) < need:
            cap = max(2 * len(self._buf), need)
            grown = np.empty((cap, self.dim), dtype=np.float32)
            grown[: self._filled] = self._buf[: self._filled]
            self._buf = grown

    @property
    def points(self) -> np.ndarray:
        """(n, d) float32 view over the merged corpus (bulk rows first).
        Delete-only streams never copy the bulk: the buffer materialises on
        the first absorb, not here."""
        if self.n_delta == 0:
            return self.bulk.points
        self._ensure_capacity(self.n)
        return self._buf[: self.n]

    # ------------------------------------------------------------ mutation
    def absorb(self, points: np.ndarray,
               keywords: Sequence[Sequence[int]],
               attrs: dict | None = None,
               tenant: "int | str | np.ndarray | None" = None) -> np.ndarray:
        """Append a batch; returns the assigned internal ids (ascending).
        The whole batch is validated before anything changes: queries see
        all of a batch or none of it.

        ``attrs``/``tenant`` must match the bulk corpus schema: a corpus with
        attribute columns requires the same columns on every batch (length =
        batch size); a multi-tenant corpus requires a tenant (one scalar for
        the whole batch, or a per-point array). Tenant names resolve through
        the corpus namespace. A schema-less corpus rejects both."""
        points = np.ascontiguousarray(points, dtype=np.float32)
        if points.ndim != 2 or points.shape[1] != self.dim:
            raise ValueError(f"expected (*, {self.dim}) points, got {points.shape}")
        if len(points) != len(keywords):
            raise ValueError(f"{len(points)} points but {len(keywords)} keyword sets")
        norm = [sorted(set(int(v) for v in ks)) for ks in keywords]
        for ks in norm:
            if ks and (ks[0] < 0 or ks[-1] >= self.n_keywords):
                raise ValueError("keyword outside dictionary")
        attr_cols = self._check_batch_attrs(attrs, len(points))
        tenant_col = self._check_batch_tenant(tenant, len(points))
        start = self.n
        need = start + len(points)
        self._ensure_capacity(need)
        self._buf[start:need] = points
        self._filled = need
        for j, ks in enumerate(norm):
            self._kw.append(np.asarray(ks, dtype=np.int32))
            for v in ks:
                self._ikp.setdefault(v, []).append(start + j)
                self._ikp_memo.pop(v, None)
        for name, col in attr_cols.items():
            self._attr_chunks[name].append(col)
        if tenant_col is not None:
            self._tenant_chunks.append(tenant_col)
        self._col_memo.clear()
        self.n_delta += len(points)
        return np.arange(start, start + len(points), dtype=np.int64)
    def _check_batch_attrs(self, attrs: dict | None, batch: int) -> dict:
        schema = set(self._attr_chunks)
        got = set(attrs or ())
        if got != schema:
            raise ValueError(f"attribute batch keys {sorted(got)} != corpus "
                             f"schema {sorted(schema)}")
        out = {}
        for name in schema:
            col = np.ascontiguousarray(attrs[name])
            if col.shape != (batch,):
                raise ValueError(f"attribute {name!r} must be ({batch},), "
                                 f"got {col.shape}")
            out[name] = col.astype(self.bulk.attrs[name].dtype, copy=False)
        return out

    def _check_batch_tenant(self, tenant, batch: int) -> np.ndarray | None:
        if self.bulk.tenant_of is None:
            if tenant is not None:
                raise ValueError("tenant given but the corpus has no tenant "
                                 "column")
            return None
        if tenant is None:
            raise ValueError("multi-tenant corpus: every absorbed batch "
                             "needs a tenant")
        ns = self.bulk.tenants
        if isinstance(tenant, (str, int, np.integer)):
            tid = ns.id_of(tenant) if ns is not None else int(tenant)
            return np.full(batch, tid, dtype=np.int32)
        col = np.asarray([ns.id_of(t) if ns is not None else int(t)
                          for t in tenant], dtype=np.int32)
        if col.shape != (batch,):
            raise ValueError(f"tenant column must be ({batch},), got {col.shape}")
        return col


    def delete(self, ids: np.ndarray) -> None:
        """Tombstone internal ids (bulk or delta); idempotence is the
        caller's job — the engine validates liveness before calling."""
        self._tomb.update(int(i) for i in ids)
        # True merge: O(T + b log b) — sort only the small batch and splice
        # it into the already-sorted array.
        new = np.asarray(sorted(set(int(i) for i in ids)), dtype=np.int64)
        pos = np.searchsorted(self._tomb_sorted, new)
        self._tomb_sorted = np.insert(self._tomb_sorted, pos, new)

    # -------------------------------------------------------------- queries
    @property
    def dirty(self) -> bool:
        return self.n_delta > 0 or bool(self._tomb)

    @property
    def n_tombstones(self) -> int:
        return len(self._tomb)

    def tombstoned(self, ids: np.ndarray) -> np.ndarray:
        """Boolean mask: which of ``ids`` are deleted."""
        return sorted_member(np.asarray(ids, dtype=np.int64),
                             self._tomb_sorted)

    def mask_tombstones(self, bitset: np.ndarray) -> None:
        """Clear deleted points from a query bitset (plan + fallback see only
        live points; this is where tombstones filter enumeration)."""
        if len(self._tomb_sorted):
            bitset[self._tomb_sorted] = False

    def live_internal_ids(self) -> np.ndarray:
        """Sorted internal ids of every live point (compaction order)."""
        alive = np.ones(self.n, dtype=bool)
        if len(self._tomb_sorted):
            alive[self._tomb_sorted] = False
        return np.flatnonzero(alive).astype(np.int64)

    def _delta_postings(self, v_kw: int) -> np.ndarray:
        lst = self._ikp.get(int(v_kw))
        if not lst:
            return np.empty(0, dtype=np.int64)
        arr = self._ikp_memo.get(int(v_kw))
        if arr is None or len(arr) != len(lst):
            arr = np.asarray(lst, dtype=np.int64)
            self._ikp_memo[int(v_kw)] = arr
        return arr

    def delta_ids_with(self, v_kw: int) -> np.ndarray:
        """Live delta ids tagged with ``v_kw`` (sorted)."""
        ids = self._delta_postings(v_kw)
        if not len(ids):
            return ids
        return ids[~self.tombstoned(ids)]

    def points_with(self, keyword: int) -> np.ndarray:
        """Live merged I_kp lookup (the device tier packs from this)."""
        merged = self.ikp.row(keyword)
        dead = self.tombstoned(merged)
        return merged[~dead] if dead.any() else merged

    # --------------------------------------------------- attribute surface
    @property
    def attrs(self) -> dict | None:
        """Attribute schema marker (duck-types ``KeywordDataset.attrs`` for
        presence checks; columns come from :meth:`attr_column`)."""
        return self.bulk.attrs

    @property
    def tenants(self) -> "TenantNamespace | None":
        return self.bulk.tenants

    def attr_column(self, name: str) -> np.ndarray:
        """Merged (n,) attribute column: bulk rows then delta rows.
        Tombstoned rows keep their values — eligibility is ANDed with
        liveness downstream, never consulted for dead points."""
        if name not in self._attr_chunks and (
                not self.bulk.attrs or name not in self.bulk.attrs):
            return self.bulk.attr_column(name)      # raises the KeyError
        col = self._col_memo.get(name)
        if col is None:
            col = np.concatenate([self.bulk.attr_column(name)]
                                 + self._attr_chunks[name]) \
                if self._attr_chunks[name] else self.bulk.attr_column(name)
            self._col_memo[name] = col
        return col

    @property
    def tenant_ids(self) -> np.ndarray | None:
        if self.bulk.tenant_of is None:
            return None
        col = self._col_memo.get("__tenant__")
        if col is None:
            col = np.concatenate([self.bulk.tenant_of] + self._tenant_chunks) \
                if self._tenant_chunks else self.bulk.tenant_of
            self._col_memo["__tenant__"] = col
        return col

    def compacted_dataset(self) -> KeywordDataset:
        """The live corpus as a fresh frozen :class:`KeywordDataset`
        (compaction's rebuild input), points and keyword rows in internal-id
        order. Keyword rows are sliced vectorised from the bulk CSR plus the
        delta arrays — every row is already sorted unique, so the result is
        identical to ``make_dataset`` over the same rows without the
        per-point Python pass."""
        live = self.live_internal_ids()
        points = np.ascontiguousarray(self.points[live])
        live_bulk = live[live < self.bulk.n]
        live_delta = live[live >= self.bulk.n] - self.bulk.n
        kwcsr = self.bulk.kw
        counts = np.diff(kwcsr.offsets)[live_bulk]
        idx = np.repeat(kwcsr.offsets[live_bulk], counts) + \
            ragged_arange(counts)
        delta_rows = [self._kw[i] for i in live_delta]
        values = np.concatenate(
            [kwcsr.values[idx].astype(np.int32)]
            + [r.astype(np.int32) for r in delta_rows]) if len(live) else \
            np.empty(0, dtype=np.int32)
        lens = np.concatenate(
            [counts, np.fromiter((len(r) for r in delta_rows), np.int64,
                                 count=len(delta_rows))])
        offsets = np.zeros(len(live) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        attrs = {name: np.ascontiguousarray(self.attr_column(name)[live])
                 for name in (self.bulk.attrs or {})} or None
        tenant_of = None
        if self.bulk.tenant_of is not None:
            tenant_of = np.ascontiguousarray(self.tenant_ids[live])
        return dataclasses.replace(
            dataset_from_csr(points, CSR(offsets=offsets, values=values),
                             self.n_keywords),
            attrs=attrs, tenant_of=tenant_of, tenants=self.bulk.tenants)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """A query result: a minimal point set covering Q, ranked by diameter then
    cardinality (the paper's tie-break).

    Under flexible semantics (``core.semantics``) ``diameter`` holds the
    *weighted* cost — identical to the geometric diameter with unit weights —
    and scored mode stamps ``score`` (None everywhere else, so the classic
    result shape is unchanged)."""

    ids: tuple[int, ...]          # sorted, unique point ids
    diameter: float
    score: float | None = None

    def key(self) -> tuple[float, int, tuple[int, ...]]:
        return (self.diameter, len(self.ids), self.ids)


class TopK:
    """The paper's priority queue PQ of top-k results.

    ``kth_diameter`` is +inf until k results exist — ProMiSH-E's k sentinel
    entries of diameter +inf and ProMiSH-A's initially empty queue behave the
    same, so one queue serves both.

    ``tie_open=True`` (flexible-semantics queues only) inflates the reported
    k-th diameter by one ulp. The enumeration gates prune with strict
    ``diam < r_k`` comparisons, which in classic mode never drops a result.
    m-of-k coverage admits many *equal-cost* candidates (cost-0 singletons
    especially), where a strict gate would discard a late-arriving equal
    whose (cost, cardinality, ids) key beats the incumbent; the one-ulp
    inflation lets exact ties through to ``offer``, whose total-order key
    settles them.
    """

    def __init__(self, k: int, tie_open: bool = False):
        self.k = int(k)
        self._items: list[Candidate] = []
        self._seen: set[tuple[int, ...]] = set()
        self._tie_open = tie_open

    def __len__(self) -> int:
        return len(self._items)

    @property
    def items(self) -> list[Candidate]:
        return list(self._items)

    def kth_diameter(self) -> float:
        if len(self._items) < self.k:
            return float("inf")
        kth = self._items[self.k - 1].diameter
        return math.nextafter(kth, math.inf) if self._tie_open else kth

    def offer(self, cand: Candidate) -> bool:
        """Insert if it improves the top-k; dedup by point-id set."""
        if cand.ids in self._seen:
            return False
        if len(self._items) >= self.k and cand.key() >= self._items[self.k - 1].key():
            return False
        self._items.append(cand)
        self._seen.add(cand.ids)
        self._items.sort(key=Candidate.key)
        if len(self._items) > self.k:
            drop = self._items.pop()
            self._seen.discard(drop.ids)
        return True

    def full(self) -> bool:
        return len(self._items) >= self.k


class ScoredTopK:
    """Scored-mode priority queue: rank by ``score = coverage / (1 + alpha *
    cost)`` — descending score, then the classic (cost, cardinality, ids)
    tie-break. Duck-types :class:`TopK` (``offer`` / ``kth_diameter`` /
    ``full`` / ``items``) so every search loop and enumeration stage runs
    unchanged.

    ``kth_diameter`` converts the k-th score back into the largest cost any
    still-admissible candidate could have: coverage is at most
    ``total_weight``, so a candidate beats the k-th score only if ``cost <=
    (total_weight / kth_score - 1) / alpha``. The bound is nudged one ulp up
    so equal-score candidates (which can still win on the tie-break) survive
    the strict ``<`` prefilters. Lemma-2 termination stays sound: weighted
    cost dominates geometric diameter (weights >= 1).

    Offers arrive as plain ``Candidate(ids, cost)``; the queue computes the
    score itself (``coverage`` is the semantics-supplied ids -> covered-weight
    function) and stamps it on the stored candidate.
    """

    def __init__(self, k: int, *, total_weight: float, alpha: float,
                 coverage):
        self.k = int(k)
        self.total_weight = float(total_weight)
        self.alpha = float(alpha)
        self._coverage = coverage
        self._items: list[Candidate] = []
        self._seen: set[tuple[int, ...]] = set()

    def __len__(self) -> int:
        return len(self._items)

    @property
    def items(self) -> list[Candidate]:
        return list(self._items)

    @staticmethod
    def _key(cand: Candidate) -> tuple:
        return (-cand.score, cand.diameter, len(cand.ids), cand.ids)

    def kth_diameter(self) -> float:
        if len(self._items) < self.k:
            return float("inf")
        kth = self._items[self.k - 1].score
        if kth <= 0.0:
            return float("inf")
        bound = (self.total_weight / kth - 1.0) / self.alpha
        return math.nextafter(max(bound, 0.0), math.inf)

    def offer(self, cand: Candidate) -> bool:
        """Insert if it improves the top-k; dedup by point-id set. The score
        is derived here, so the candidate's cost (``diameter``) is all the
        enumeration has to settle."""
        if cand.ids in self._seen:
            return False
        cov = float(self._coverage(cand.ids))
        cand = dataclasses.replace(
            cand, score=cov / (1.0 + self.alpha * cand.diameter))
        if len(self._items) >= self.k \
                and self._key(cand) >= self._key(self._items[self.k - 1]):
            return False
        self._items.append(cand)
        self._seen.add(cand.ids)
        self._items.sort(key=self._key)
        if len(self._items) > self.k:
            drop = self._items.pop()
            self._seen.discard(drop.ids)
        return True

    def full(self) -> bool:
        return len(self._items) >= self.k
