"""ProMiSH index build (paper §III): multi-scale HI structures.

Each HI structure at scale ``s`` is:
  * a hashtable  H  : bucket id -> point ids     (CSR ``table``)
  * an inverted  I_khb: keyword -> bucket ids    (CSR ``khb``)
built from bin width ``w = w0 * 2^s``.

The keyword->point inverted index I_kp lives on the dataset itself
(:class:`repro_torch.core.types.KeywordDataset`).

Build cost is one matmul (projections), one floor per bin plane, and two
sorts per scale, all flat-array numpy on the host. The build is
deterministic in ``seed``: the same corpus and parameters give the same
structures as the reference package's build.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import projection as proj
from repro_torch.core import signatures as sig
from repro_torch.core.types import KeywordDataset
from repro_torch.utils.csr import CSR, csr_from_pairs, ragged_arange


@dataclasses.dataclass(frozen=True)
class HIStructure:
    """Hashtable + keyword->bucket inverted index at one scale."""

    scale: int
    width: float
    n_buckets: int
    table: CSR      # bucket -> point ids (a point appears once per distinct bucket)
    khb: CSR        # keyword -> bucket ids containing >=1 point with that keyword

    def nbytes(self) -> int:
        return self.table.nbytes() + self.khb.nbytes()


@dataclasses.dataclass(frozen=True)
class PromishIndex:
    """The full multi-scale index (either flavour).

    exact=True  -> ProMiSH-E (overlapping bins, 2^m signatures/point)
    exact=False -> ProMiSH-A (disjoint bins, 1 signature/point)
    """

    z: np.ndarray                  # (m, d) unit random vectors
    w0: float
    n_scales: int
    exact: bool
    structures: tuple[HIStructure, ...]
    p_max: float

    def nbytes(self) -> int:
        return self.z.nbytes + sum(h.nbytes() for h in self.structures)


def _build_scale(dataset: KeywordDataset, projected: np.ndarray, scale: int,
                 width: float, n_buckets: int, exact: bool) -> HIStructure:
    n = dataset.n
    if exact:
        keys2 = proj.bin_keys_overlapping(projected, width)
        buckets = sig.bucket_ids_overlapping(keys2, n_buckets)       # (N, 2^m)
        point_ids = np.repeat(np.arange(n, dtype=np.int32), buckets.shape[1])
        flat_buckets = buckets.reshape(-1)
    else:
        keys = proj.bin_keys_disjoint(projected, width)
        flat_buckets = sig.bucket_ids_disjoint(keys, n_buckets)       # (N,)
        point_ids = np.arange(n, dtype=np.int32)

    # A point may receive duplicate bucket ids from distinct signatures
    # (overlap or hash collision) — dedup so each bucket lists a point once.
    table = csr_from_pairs(flat_buckets, point_ids, n_buckets, dedup=True)

    # I_khb: for every (bucket, point) entry expand the point's keywords and
    # dedup (keyword, bucket) pairs (vectorised: gather each point's kw slice).
    pts = table.values                                                # points in bucket order
    bkt_of_entry = np.repeat(np.arange(n_buckets, dtype=np.int64), np.diff(table.offsets))
    kw_counts = np.diff(dataset.kw.offsets)[pts]                      # kws per entry
    bk_rep = np.repeat(bkt_of_entry, kw_counts)
    starts = dataset.kw.offsets[pts]
    # ragged gather of keyword slices
    total = int(kw_counts.sum())
    idx = np.repeat(starts, kw_counts) + ragged_arange(kw_counts, total)
    kws = dataset.kw.values[idx].astype(np.int64)
    khb = csr_from_pairs(kws, bk_rep.astype(np.int32),
                         dataset.n_keywords, dedup=True)
    return HIStructure(scale=scale, width=width, n_buckets=n_buckets,
                       table=table, khb=khb)


def build_index(dataset: KeywordDataset, *, m: int = 2, n_scales: int = 5,
                exact: bool = True, seed: int = 0) -> PromishIndex:
    """Build a ProMiSH index (paper defaults: m=2, L=5, w0=pMax/2^L).

    The hashtable has one bucket per point, rounded up to a power of two
    (the paper uses a fixed table size; we scale with N).
    """
    rng = np.random.default_rng(seed)
    z = proj.sample_unit_vectors(rng, m, dataset.dim)
    projected = proj.project(dataset.points, z)
    p_max = proj.projection_span(projected)
    w0 = p_max / (2.0 ** n_scales)
    n_buckets = max(64, 1 << int(np.ceil(np.log2(max(dataset.n, 1)))))
    structures = []
    for s in range(n_scales):
        width = w0 * (2.0 ** s)
        # Fewer, larger buckets are expected at coarse scales; halve the table.
        nb = max(64, n_buckets >> s) if not exact else n_buckets
        structures.append(_build_scale(dataset, projected, s, width, nb,
                                       exact))
    return PromishIndex(z=z, w0=float(w0), n_scales=n_scales, exact=exact,
                        structures=tuple(structures), p_max=p_max)
