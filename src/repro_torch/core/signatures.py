"""Signature construction and bucket hashing (paper §III).

ProMiSH-E: each point has 2 keys per projection (overlapping bins); the
cartesian product over m projections yields 2^m signatures per point.
ProMiSH-A: one key per projection -> one signature per point.

A signature is reduced to a hashtable bucket id with a fixed multiplicative
hash. The multipliers are constants (not data-dependent) so that distributed
shards agree on bucket ids.

The ``*_torch`` functions compute the same ids from int64 torch tensors on
any device (the index build on the card): int64 arithmetic wraps exactly as
the numpy uint64 arithmetic does, so the bits agree.
"""
from __future__ import annotations

import numpy as np
import torch

# Fixed odd 64-bit multipliers (splitmix64 outputs), one per projection slot.
_MULTIPLIERS = np.array(
    [
        0x9E3779B97F4A7C15,
        0xBF58476D1CE4E5B9,
        0x94D049BB133111EB,
        0xD6E8FEB86659FD93,
        0xA5CB3B1F6E9F8B17,
        0xC2B2AE3D27D4EB4F,
        0x165667B19E3779F9,
        0x27D4EB2F165667C5,
    ],
    dtype=np.uint64,
)


def signature_table(m: int) -> np.ndarray:
    """(2^m, m) binary selector table: row j picks key h1 or h2 for each of the
    m projections — the cartesian product enumeration."""
    j = np.arange(1 << m, dtype=np.int64)[:, None]
    return ((j >> np.arange(m, dtype=np.int64)[None, :]) & 1).astype(np.int64)


def signatures_overlapping(keys2: np.ndarray) -> np.ndarray:
    """keys2: (N, m, 2) dual keys -> (N, 2^m, m) all signatures per point."""
    n, m, _ = keys2.shape
    sel = signature_table(m)                      # (2^m, m)
    idx = np.broadcast_to(sel[None], (n, 1 << m, m))
    gathered = np.take_along_axis(keys2[:, None, :, :].repeat(1 << m, axis=1),
                                  idx[..., None], axis=3)
    return gathered[..., 0]                        # (N, 2^m, m)


def hash_signatures(sigs: np.ndarray, n_buckets: int) -> np.ndarray:
    """Multiplicative hash: (sum_i key_i * mult_i) mod n_buckets.

    sigs: (..., m) int64 -> (...,) int64 bucket ids in [0, n_buckets).
    """
    m = sigs.shape[-1]
    if m > len(_MULTIPLIERS):
        raise ValueError(f"m={m} exceeds supported projections {len(_MULTIPLIERS)}")
    acc = (sigs.astype(np.uint64) * _MULTIPLIERS[:m]).sum(axis=-1)
    # 64-bit finalizer improves low-bit avalanche before the modulo.
    acc ^= acc >> np.uint64(33)
    acc *= np.uint64(0xFF51AFD7ED558CCD)
    acc ^= acc >> np.uint64(33)
    return (acc % np.uint64(n_buckets)).astype(np.int64)


def bucket_ids_overlapping(keys2: np.ndarray, n_buckets: int) -> np.ndarray:
    """(N, m, 2) -> (N, 2^m) bucket ids (ProMiSH-E: 2^m buckets per point)."""
    return hash_signatures(signatures_overlapping(keys2), n_buckets)


def bucket_ids_disjoint(keys: np.ndarray, n_buckets: int) -> np.ndarray:
    """(N, m) -> (N,) bucket ids (ProMiSH-A: one bucket per point)."""
    return hash_signatures(keys, n_buckets)


# The same constants as signed int64 (two's complement: the same bits).
_MULTIPLIERS_I64 = _MULTIPLIERS.view(np.int64)
_FINALIZER_I64 = int(np.array([0xFF51AFD7ED558CCD], np.uint64)
                     .view(np.int64)[0])
_LOW31 = (1 << 31) - 1
_LOW32 = (1 << 32) - 1
_MAX_BUCKETS = 1 << 31


def _shr33(a: torch.Tensor) -> torch.Tensor:
    """Logical ``a >> 33`` of the uint64 bits held in int64 ``a`` (torch
    shifts int64 arithmetically)."""
    return (a >> 33) & _LOW31


def hash_signatures_torch(sigs: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """:func:`hash_signatures` on int64 tensors: (..., m) -> (...,) int64.

    ``n_buckets`` may be any power of two, or any other value in [1, 2^31).
    A power of two takes the low bits as a mask; any other modulus reduces
    the uint64 accumulator
    (held in int64, and torch has no unsigned 64-bit modulo) through its two
    32-bit halves: ``((hi mod n) (2^32 mod n) + lo) mod n``, each term below
    2^62, so the int64 arithmetic never wraps."""
    m = sigs.shape[-1]
    if m > len(_MULTIPLIERS):
        raise ValueError(f"m={m} exceeds supported projections {len(_MULTIPLIERS)}")
    pow2 = n_buckets >= 1 and n_buckets & (n_buckets - 1) == 0
    if not (pow2 or 1 <= n_buckets < _MAX_BUCKETS):
        raise ValueError(f"n_buckets={n_buckets} must be a power of two or "
                         f"lie in [1, 2^31)")
    mult = torch.from_numpy(_MULTIPLIERS_I64[:m].copy()).to(sigs.device)
    acc = (sigs.to(torch.int64) * mult).sum(dim=-1)
    acc = acc ^ _shr33(acc)
    acc = acc * _FINALIZER_I64
    acc = acc ^ _shr33(acc)
    if pow2:
        return acc & (n_buckets - 1)
    hi = (acc >> 32) & _LOW32
    lo = acc & _LOW32
    return (hi % n_buckets * ((1 << 32) % n_buckets) + lo) % n_buckets


def bucket_ids_overlapping_torch(h1: torch.Tensor, h2: torch.Tensor,
                                 n_buckets: int) -> torch.Tensor:
    """:func:`bucket_ids_overlapping` from the two key planes: h1, h2 (N, m)
    int64 (h2 already offset by C) -> (N, 2^m) bucket ids."""
    m = h1.shape[1]
    sel = torch.from_numpy(signature_table(m).astype(bool)).to(h1.device)
    sigs = torch.where(sel[None], h2[:, None, :], h1[:, None, :])
    return hash_signatures_torch(sigs, n_buckets)
