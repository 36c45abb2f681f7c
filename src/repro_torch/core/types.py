"""Core datatypes for NKS (nearest keyword set) search.

A :class:`KeywordDataset` is the paper's ``D``: ``N`` points in ``R^d``, each
tagged with a keyword set drawn from a dictionary of size ``U``. Keywords are
integer ids; the mapping to strings lives in the application layer.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.utils.csr import CSR, csr_from_lists, invert_csr


@dataclasses.dataclass(frozen=True)
class KeywordDataset:
    """The paper's tagged multi-dimensional dataset.

    points     : (N, d) float32 — the embedded objects.
    kw         : CSR point -> sorted keyword ids (the paper's sigma(o)).
    ikp        : CSR keyword -> sorted point ids (the paper's I_kp inverted index).
    n_keywords : dictionary size U.
    """

    points: np.ndarray
    kw: CSR
    ikp: CSR
    n_keywords: int

    @property
    def n(self) -> int:
        return int(self.points.shape[0])

    @property
    def dim(self) -> int:
        return int(self.points.shape[1])

    def points_with(self, keyword: int) -> np.ndarray:
        """I_kp lookup: ids of points tagged with ``keyword``."""
        return self.ikp.row(keyword)


def make_dataset(points: np.ndarray, keywords: Sequence[Sequence[int]],
                 n_keywords: int | None = None) -> KeywordDataset:
    points = np.ascontiguousarray(points, dtype=np.float32)
    keywords = [sorted(set(int(v) for v in ks)) for ks in keywords]
    if len(keywords) != len(points):
        raise ValueError(f"{len(points)} points but {len(keywords)} keyword sets")
    if n_keywords is None:
        n_keywords = 1 + max((max(ks) for ks in keywords if ks), default=-1)
    kw = csr_from_lists(keywords)
    ikp = invert_csr(kw, n_keywords)
    return KeywordDataset(points=points, kw=kw, ikp=ikp,
                          n_keywords=int(n_keywords))


def dataset_from_csr(points: np.ndarray, kw: CSR,
                     n_keywords: int) -> KeywordDataset:
    """A dataset from an already-built point -> keywords CSR (rows sorted
    unique). Identical to :func:`make_dataset` over the same rows, without
    the per-point Python pass."""
    return KeywordDataset(points=np.ascontiguousarray(points, np.float32),
                          kw=kw, ikp=invert_csr(kw, n_keywords),
                          n_keywords=int(n_keywords))


@dataclasses.dataclass(frozen=True)
class Candidate:
    """A query result: a minimal point set covering Q, ranked by diameter then
    cardinality (the paper's tie-break)."""

    ids: tuple[int, ...]          # sorted, unique point ids
    diameter: float

    def key(self) -> tuple[float, int, tuple[int, ...]]:
        return (self.diameter, len(self.ids), self.ids)


class TopK:
    """The paper's priority queue PQ of top-k results.

    ``kth_diameter`` is +inf until k results exist — ProMiSH-E's k sentinel
    entries of diameter +inf and ProMiSH-A's initially empty queue behave the
    same, so one queue serves both.
    """

    def __init__(self, k: int):
        self.k = int(k)
        self._items: list[Candidate] = []
        self._seen: set[tuple[int, ...]] = set()

    def __len__(self) -> int:
        return len(self._items)

    @property
    def items(self) -> list[Candidate]:
        return list(self._items)

    def kth_diameter(self) -> float:
        if len(self._items) < self.k:
            return float("inf")
        return self._items[self.k - 1].diameter

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
