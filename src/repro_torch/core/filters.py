"""Attribute predicates and tenant scoping for filtered NKS.

The paper's query model is pure keyword-set tightness; a serving deployment
immediately needs the *filtered* variant — "tightest group matching these
keywords **where** price < 50 and tenant = acme". This module is the predicate
grammar and its one-pass evaluator:

  * :class:`Clause` — one ``attr op value`` comparison over a per-point
    attribute column (``KeywordDataset.attrs`` / the streaming merged view).
    Ops: ``< <= > >= == != in between``. Numeric columns take the ordered
    ops; any column takes the equality/set ops.
  * :class:`Filter` — a conjunction of clauses plus optional tenant scoping
    (``tenant="acme"`` restricts to points whose ``tenant_of`` matches;
    names resolve through the dataset's
    :class:`~repro_torch.core.types.TenantNamespace`).

``Filter.evaluate`` runs **once per query batch** and produces the (N,) bool
*point-eligibility mask* the whole pipeline consumes: the plan layer prunes
covering-bucket subsets with no eligible member, keyword groups restrict to
eligible rows before enumeration, and the device backend folds the mask into
the packed join bitmask on the card (K1's eligibility words, and K2's on the
prune tier; see ``core.backend``) — subsets and their packed tiles stay
filter-independent, so the LRU caches are shared across filters.

Evaluation is deliberately eager and total: an unknown attribute, a
type-incompatible op, or tenant scoping on a tenant-less corpus raises at
evaluate time (a serving frontend wants the 4xx, not a silently empty
answer).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

_ORDERED_OPS = {
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
}
_EQUALITY_OPS = {"==", "!="}
_SET_OPS = {"in", "between"}
OPS = tuple(_ORDERED_OPS) + tuple(sorted(_EQUALITY_OPS | _SET_OPS))


@dataclasses.dataclass(frozen=True)
class Clause:
    """One ``attr op value`` predicate over a per-point attribute column."""

    attr: str
    op: str
    value: object

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown predicate op {self.op!r} "
                             f"(supported: {', '.join(OPS)})")
        if self.op == "in":
            if not isinstance(self.value, (list, tuple, set, frozenset, np.ndarray)):
                raise ValueError(f"'in' needs a value list, got {self.value!r}")
            object.__setattr__(self, "value",
                               tuple(sorted(set(self.value))))
        elif self.op == "between":
            v = self.value
            if not (isinstance(v, (list, tuple)) and len(v) == 2):
                raise ValueError(f"'between' needs (lo, hi), got {v!r}")
            object.__setattr__(self, "value", (v[0], v[1]))

    def evaluate(self, column: np.ndarray) -> np.ndarray:
        """(N,) bool mask of rows satisfying the clause."""
        if self.op in _ORDERED_OPS:
            if not np.issubdtype(column.dtype, np.number):
                raise ValueError(
                    f"ordered op {self.op!r} on non-numeric column "
                    f"{self.attr!r} (dtype {column.dtype})")
            return _ORDERED_OPS[self.op](column, self.value)
        if self.op == "==":
            return column == self.value
        if self.op == "!=":
            return column != self.value
        if self.op == "between":
            lo, hi = self.value
            return (column >= lo) & (column <= hi)
        # "in": sorted-unique membership (values normalised in __post_init__)
        return np.isin(column, np.asarray(self.value))

    def as_json(self) -> list:
        v = list(self.value) if isinstance(self.value, tuple) else self.value
        return [self.attr, self.op, v]


@dataclasses.dataclass(frozen=True)
class Filter:
    """A conjunction of attribute clauses plus optional tenant scoping.

    ``tenant`` is a tenant name (resolved through the corpus
    :class:`~repro_torch.core.types.TenantNamespace`) or a raw tenant id. The empty
    filter (no clauses, no tenant) evaluates to all-eligible and is
    equivalent to no filter at all.
    """

    clauses: tuple[Clause, ...] = ()
    tenant: str | int | None = None

    def __bool__(self) -> bool:
        return bool(self.clauses) or self.tenant is not None

    def evaluate(self, dataset) -> np.ndarray:
        """The (N,) bool point-eligibility mask over ``dataset``.

        ``dataset`` is any corpus exposing the attribute surface
        (``KeywordDataset`` or the streaming merged view): ``n``,
        ``attr_column(name)``, ``tenant_ids``, ``tenants``.
        """
        eligible = np.ones(dataset.n, dtype=bool)
        if self.tenant is not None:
            tids = dataset.tenant_ids
            if tids is None:
                raise ValueError(
                    f"filter scopes to tenant {self.tenant!r} but the corpus "
                    f"has no tenant column")
            ns = dataset.tenants
            tid = ns.id_of(self.tenant) if ns is not None else int(self.tenant)
            eligible &= tids == tid
        for c in self.clauses:
            eligible &= c.evaluate(dataset.attr_column(c.attr))
        return eligible

    def selectivity(self, dataset) -> float:
        n = dataset.n
        return float(self.evaluate(dataset).sum()) / n if n else 0.0

    # ----------------------------------------------------------- conversions
    @classmethod
    def from_json(cls, spec: dict) -> "Filter":
        """Parse the serving-layer JSON form:
        ``{"tenant": "acme", "where": [["price", "<", 50], ...]}``."""
        if not isinstance(spec, dict):
            raise ValueError(f"filter spec must be an object, got {spec!r}")
        unknown = set(spec) - {"tenant", "where"}
        if unknown:
            raise ValueError(f"unknown filter keys: {sorted(unknown)}")
        clauses = []
        for item in spec.get("where", []):
            if len(item) != 3:
                raise ValueError(f"clause must be [attr, op, value]: {item!r}")
            clauses.append(Clause(str(item[0]), str(item[1]), item[2]))
        return cls(clauses=tuple(clauses), tenant=spec.get("tenant"))

    def as_json(self) -> dict:
        out: dict = {}
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.clauses:
            out["where"] = [c.as_json() for c in self.clauses]
        return out

    @staticmethod
    def coerce(spec) -> "Filter | None":
        """Accept a Filter, a JSON dict, or None (engine entry points)."""
        if spec is None:
            return None
        if isinstance(spec, Filter):
            return spec if spec else None
        flt = Filter.from_json(spec)
        return flt if flt else None


def where(*clauses: Sequence, tenant: str | int | None = None) -> Filter:
    """Terse constructor: ``where(("price", "<", 50), tenant="acme")``."""
    return Filter(clauses=tuple(Clause(a, op, v) for a, op, v in clauses),
                  tenant=tenant)
