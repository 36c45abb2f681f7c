"""Compressed-sparse-row helpers used by every index structure in the framework.

A ``CSR`` maps ``row id -> sorted int array of values``. It is the flat-array
replacement for the paper's pointer-based hashtables / inverted indices: two
flat arrays (``offsets``, ``values``) that can be gathered on device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSR:
    """offsets: (n_rows+1,) int64; values: (nnz,) int32/int64."""

    offsets: np.ndarray
    values: np.ndarray

    @property
    def n_rows(self) -> int:
        return len(self.offsets) - 1

    @property
    def nnz(self) -> int:
        return int(len(self.values))

    def row(self, i: int) -> np.ndarray:
        return self.values[self.offsets[i] : self.offsets[i + 1]]

    def row_len(self, i: int) -> int:
        return int(self.offsets[i + 1] - self.offsets[i])

    def rows(self, idx: Iterable[int]) -> list[np.ndarray]:
        return [self.row(i) for i in idx]

    def nbytes(self) -> int:
        return self.offsets.nbytes + self.values.nbytes


def csr_from_lists(lists: Sequence[Sequence[int]], dtype=np.int32) -> CSR:
    """Build a CSR from a python list-of-lists."""
    lens = np.fromiter((len(row) for row in lists), dtype=np.int64, count=len(lists))
    offsets = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    values = np.empty(offsets[-1], dtype=dtype)
    for i, row in enumerate(lists):
        values[offsets[i] : offsets[i + 1]] = np.asarray(row, dtype=dtype)
    return CSR(offsets=offsets, values=values)


def csr_from_pairs(rows: np.ndarray, vals: np.ndarray, n_rows: int, dedup: bool = False) -> CSR:
    """Build a CSR from (row, value) pairs via a single sort.

    This is how every hashtable in the framework is assembled: the device
    produces flat (bucket_id, point_id) pairs; one sort yields the CSR.
    """
    rows = np.asarray(rows)
    vals = np.asarray(vals)
    if dedup and len(rows):
        key = rows.astype(np.int64) * (int(vals.max()) + 1 if len(vals) else 1) + vals.astype(np.int64)
        _, uniq = np.unique(key, return_index=True)
        rows, vals = rows[uniq], vals[uniq]
    order = np.argsort(rows, kind="stable")
    rows_s, vals_s = rows[order], vals[order]
    counts = np.bincount(rows_s, minlength=n_rows).astype(np.int64)
    offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return CSR(offsets=offsets, values=np.ascontiguousarray(vals_s))


def csr_from_pairs_torch(rows: torch.Tensor, vals: torch.Tensor, n_rows: int,
                         dedup: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`csr_from_pairs` on torch tensors of any device: the same
    (offsets int64, values in ``vals``' dtype), rows ascending, values
    ascending within a row under ``dedup`` and in input order otherwise.
    Ids must be non-negative."""
    if dedup and rows.numel():
        span = int(vals.max()) + 1
        key = torch.unique(rows.to(torch.int64) * span + vals.to(torch.int64),
                           sorted=True)
        rows_s, vals_s = key // span, (key % span).to(vals.dtype)
    else:
        rows_s, order = torch.sort(rows.to(torch.int64), stable=True)
        vals_s = vals[order]
    counts = torch.bincount(rows_s, minlength=n_rows)
    offsets = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets, vals_s.contiguous()


def ragged_arange_torch(counts: torch.Tensor) -> torch.Tensor:
    """:func:`ragged_arange` on an int64 torch tensor of any device."""
    total = int(counts.sum()) if counts.numel() else 0
    starts = torch.cumsum(counts, 0) - counts
    return torch.arange(total, dtype=torch.int64, device=counts.device) \
        - torch.repeat_interleave(starts, counts, output_size=total)


def invert_csr(csr: CSR, n_values: int) -> CSR:
    """Invert a row->values CSR into value->rows (e.g. point->keywords into
    keyword->points, the paper's I_kp)."""
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64), np.diff(csr.offsets))
    return csr_from_pairs(csr.values.astype(np.int64), rows.astype(np.int32), n_values)


def ragged_arange(counts: np.ndarray, total: int | None = None) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated — the gather index for slicing many
    CSR rows at once."""
    counts = np.asarray(counts, dtype=np.int64)
    if total is None:
        total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(starts, counts)
    return out


def sorted_member(values: np.ndarray, sorted_ref: np.ndarray) -> np.ndarray:
    """Boolean membership of ``values`` in sorted ``sorted_ref`` (both int),
    via searchsorted — no hashing, no np.unique. The membership primitive of
    every flat-array index structure here (subset grouping, tombstone masks,
    coverage re-verification)."""
    if len(sorted_ref) == 0 or len(values) == 0:
        return np.zeros(len(values), dtype=bool)
    idx = np.searchsorted(sorted_ref, values)
    idx[idx == len(sorted_ref)] = 0
    return sorted_ref[idx] == values
