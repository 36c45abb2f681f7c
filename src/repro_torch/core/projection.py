"""Random unit-vector projections and bin-key computation (paper §III, eqs 1-2).

These are the numpy control-plane versions the index build runs; the fused
projection + binning kernel is a later slice of the port (see ROADMAP.md).
"""
from __future__ import annotations

import numpy as np

# Offset separating h2 keys from h1 keys (the paper's constant C). We use a
# fixed power of two rather than the data-dependent max(h1)-min(h1)+2 so that
# every shard of a distributed index derives identical keys.
DEFAULT_C = 1 << 20


def sample_unit_vectors(rng: np.random.Generator, m: int, d: int) -> np.ndarray:
    """m unit vectors drawn uniformly from the (d-1)-sphere."""
    z = rng.standard_normal((m, d)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    return z


def project(points: np.ndarray, z: np.ndarray) -> np.ndarray:
    """(N,d) x (m,d) -> (N,m) projected values z.o."""
    return points.astype(np.float32) @ z.T.astype(np.float32)


def bin_keys_overlapping(proj: np.ndarray, w: float, c: int = DEFAULT_C) -> np.ndarray:
    """ProMiSH-E dual keys (eqs 1-2): every point lies in two overlapping bins
    per projection.  Returns (N, m, 2) int64 with [..., 0]=h1, [..., 1]=h2+C.
    """
    h1 = np.floor(proj / w).astype(np.int64)
    h2 = np.floor((proj - w / 2.0) / w).astype(np.int64) + c
    return np.stack([h1, h2], axis=-1)


def bin_keys_disjoint(proj: np.ndarray, w: float) -> np.ndarray:
    """ProMiSH-A single key per projection: (N, m) int64."""
    return np.floor(proj / w).astype(np.int64)


def projection_span(proj: np.ndarray) -> float:
    """pMax — the maximum span of projected values over any unit vector
    (paper eq 3 input)."""
    return float((proj.max(axis=0) - proj.min(axis=0)).max())

