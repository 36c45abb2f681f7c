"""ProMiSH index build (paper §III): multi-scale HI structures.

Each HI structure at scale ``s`` is:
  * a hashtable  H  : bucket id -> point ids     (CSR ``table``)
  * an inverted  I_khb: keyword -> bucket ids    (CSR ``khb``)
built from bin width ``w = w0 * 2^s``.

The keyword->point inverted index I_kp lives on the dataset itself
(:class:`repro_torch.core.types.KeywordDataset`).

Build cost is one matmul (projections), one floor per bin plane, and two
sorts per scale. :func:`build_index` is the flat-array numpy build on the
host, the oracle of the build on the device (``core.index_build``, which the
engine runs): both are deterministic in ``seed``, and the same corpus and
parameters give the same structures as the reference package's build.
:class:`BucketSynopsis` (``synopsis=True``) summarises each bucket — count,
bounding radius, attribute and tenant ranges — for the planner's zone and
radius prunes, built on the host with the reference's arithmetic.

:class:`IndexDelta` is the streaming companion of a frozen index: inserts
and deletes are binned through K5 (``core.index_build.bin_rows``) and
settled against the numpy product of the batch, the values the reference's
delta computes at the same point.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import projection as proj
from repro_torch.core import signatures as sig
from repro_torch.core.types import KeywordDataset
from repro_torch.utils.csr import (CSR, csr_from_pairs, ragged_arange,
                                   sorted_member)


@dataclasses.dataclass(frozen=True)
class BucketSynopsis:
    """Per-bucket summary table of one scale's hashtable (zone maps).

    Everything here is a *conservative superset* of the bucket's bulk
    membership, so consulting it can only ever skip work, never answers:

      * ``radius`` — an upper bound on the distance from the bucket's points
        to their centroid (f64 max, rounded *up* into f32). ``2 * radius``
        bounds the diameter of any subset drawn from the bucket, letting the
        dispatcher substitute an infinite pruning radius (the all-pairs-join
        fast path) when the bound already beats the live ``r_k``. The
        centroid itself is a build-time intermediate and is not retained.
      * ``attr_min`` / ``attr_max`` — per numeric attribute column, the
        bucket's value range; a conjunctive
        :class:`~repro_torch.core.filters.Filter` clause provably empty
        against the range prunes the bucket before its member list is read.
      * ``tenant_min`` / ``tenant_max`` — same idea for tenant-scoped queries.

    Empty buckets carry ``radius = 0`` and inverted ranges (min=+inf,
    max=-inf), which every prune rule rejects harmlessly.
    """

    counts: np.ndarray                          # (n_buckets,) int32
    radius: np.ndarray                          # (n_buckets,) float32, >= true
    attr_min: dict                              # name -> (n_buckets,) float64
    attr_max: dict                              # name -> (n_buckets,) float64
    tenant_min: np.ndarray | None = None        # (n_buckets,) int32
    tenant_max: np.ndarray | None = None

    def nbytes(self) -> int:
        total = self.counts.nbytes + self.radius.nbytes
        total += sum(a.nbytes for a in self.attr_min.values())
        total += sum(a.nbytes for a in self.attr_max.values())
        if self.tenant_min is not None:
            total += self.tenant_min.nbytes + self.tenant_max.nbytes
        return total


def build_synopsis(dataset: KeywordDataset, table: CSR, n_buckets: int, *,
                   chunk: int = 1 << 21) -> BucketSynopsis:
    """Build the per-bucket synopsis of one scale's hashtable, on the host.

    Two vectorised ``reduceat`` passes over the member array (chunked so the
    d-dimensional gather never materialises more than ~``chunk`` rows): one
    for per-bucket centroids (sums / counts), one for the max distance to the
    centroid. Restricting the reduceat starts to *nonempty* buckets makes
    consecutive segments exactly bucket boundaries. The arithmetic is the
    reference package's, so the synopses are equal bit for bit.
    """
    counts = np.diff(table.offsets).astype(np.int64)
    radius = np.zeros(n_buckets, dtype=np.float32)
    nonempty = np.flatnonzero(counts > 0)
    pts = dataset.points
    if len(nonempty):
        csum = np.cumsum(counts[nonempty])
        b0 = 0
        while b0 < len(nonempty):
            base = int(csum[b0 - 1]) if b0 else 0
            b1 = int(np.searchsorted(csum, base + chunk, side="left")) + 1
            b1 = min(max(b1, b0 + 1), len(nonempty))
            sel = nonempty[b0:b1]
            lo = int(table.offsets[sel[0]])
            hi = int(table.offsets[sel[-1] + 1])
            rows = pts[table.values[lo:hi]].astype(np.float64)
            starts = (table.offsets[sel] - lo).astype(np.int64)
            cent = np.add.reduceat(rows, starts, axis=0) \
                / counts[sel][:, None]
            ent = np.repeat(np.arange(len(sel)), counts[sel])
            diff = rows - cent[ent]
            dist = np.sqrt(np.einsum("ij,ij->i", diff, diff))
            rmax = np.maximum.reduceat(dist, starts).astype(np.float32)
            # Round up so the f32 bound still dominates the f64 max.
            radius[sel] = np.nextafter(rmax, np.float32(np.inf))
            b0 = b1

    def _minmax(col: np.ndarray, lo_fill, hi_fill, dtype):
        vals = col[table.values]
        amin = np.full(n_buckets, lo_fill, dtype=dtype)
        amax = np.full(n_buckets, hi_fill, dtype=dtype)
        if len(nonempty):
            starts = table.offsets[nonempty].astype(np.int64)
            amin[nonempty] = np.minimum.reduceat(vals, starts)
            amax[nonempty] = np.maximum.reduceat(vals, starts)
        return amin, amax

    attr_min: dict = {}
    attr_max: dict = {}
    for name, col in (dataset.attrs or {}).items():
        if not np.issubdtype(np.asarray(col).dtype, np.number):
            continue                      # categorical strings: no zone map
        attr_min[name], attr_max[name] = _minmax(
            np.asarray(col, dtype=np.float64), np.inf, -np.inf, np.float64)
    tenant_min = tenant_max = None
    if dataset.tenant_of is not None:
        tenant_min, tenant_max = _minmax(
            dataset.tenant_of.astype(np.int32),
            np.iinfo(np.int32).max, np.iinfo(np.int32).min, np.int32)
    return BucketSynopsis(counts=counts.astype(np.int32), radius=radius,
                          attr_min=attr_min, attr_max=attr_max,
                          tenant_min=tenant_min, tenant_max=tenant_max)


@dataclasses.dataclass(frozen=True)
class HIStructure:
    """Hashtable + keyword->bucket inverted index at one scale."""

    scale: int
    width: float
    n_buckets: int
    table: CSR      # bucket -> point ids (a point appears once per distinct bucket)
    khb: CSR        # keyword -> bucket ids containing >=1 point with that keyword
    synopsis: BucketSynopsis | None = None      # zone maps and radii

    def nbytes(self) -> int:
        total = self.table.nbytes() + self.khb.nbytes()
        if self.synopsis is not None:
            total += self.synopsis.nbytes()
        return total


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

    @property
    def m(self) -> int:
        return int(self.z.shape[0])

    @property
    def widths(self) -> list[float]:
        return [h.width for h in self.structures]

    def nbytes(self) -> int:
        return self.z.nbytes + sum(h.nbytes() for h in self.structures)


def _build_scale(dataset: KeywordDataset, projected: np.ndarray, scale: int,
                 width: float, n_buckets: int, exact: bool,
                 synopsis: bool = False) -> HIStructure:
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
    syn = build_synopsis(dataset, table, n_buckets) if synopsis else None
    return HIStructure(scale=scale, width=width, n_buckets=n_buckets,
                       table=table, khb=khb, synopsis=syn)


def default_n_buckets(n: int) -> int:
    """One bucket per point, rounded up to a power of two (at least 64)."""
    return max(64, 1 << int(np.ceil(np.log2(max(n, 1)))))


def build_index(dataset: KeywordDataset, *, m: int = 2, n_scales: int = 5,
                exact: bool = True, seed: int = 0, w0: float | None = None,
                n_buckets: int | None = None,
                synopsis: bool = False) -> PromishIndex:
    """Build a ProMiSH index (paper defaults: m=2, L=5, w0=pMax/2^L).

    The hashtable has one bucket per point, rounded up to a power of two
    (the paper uses a fixed table size; we scale with N). An explicit
    ``n_buckets`` (and ``w0``) pins the hash geometry independently of N —
    a streaming engine passes both so the bucket ids of points absorbed
    later, and of every rebuild at compaction, stay comparable with a fresh
    build over the same corpus.

    ``synopsis=True`` also builds each scale's :class:`BucketSynopsis` (zone
    maps and bounding radii), which the planner consults; a streaming
    engine's compactions rebuild them, since the flag rides in its pinned
    build params.
    """
    rng = np.random.default_rng(seed)
    z = proj.sample_unit_vectors(rng, m, dataset.dim)
    projected = proj.project(dataset.points, z)
    p_max = proj.projection_span(projected)
    if w0 is None:
        w0 = p_max / (2.0 ** n_scales)
    if n_buckets is None:
        n_buckets = default_n_buckets(dataset.n)
    structures = []
    for s in range(n_scales):
        width = w0 * (2.0 ** s)
        # Fewer, larger buckets are expected at coarse scales; halve the table.
        nb = max(64, n_buckets >> s) if not exact else n_buckets
        structures.append(_build_scale(dataset, projected, s, width, nb,
                                       exact, synopsis))
    return PromishIndex(z=z, w0=float(w0), n_scales=n_scales, exact=exact,
                        structures=tuple(structures), p_max=p_max)


# ------------------------------------------------------------ streaming delta
class IndexDelta:
    """Incremental companion of one frozen :class:`PromishIndex`.

    The bulk index is built once and never mutated; this buffer absorbs the
    stream on top of it:

      * **inserts** — each absorbed point is projected with the bulk's ``z``
        and binned with the bulk's per-scale ``(width, n_buckets)`` (the same
        eq. 1-2 / signature-hash path the build uses: K5, settled against
        the batch's numpy product), so the bucket id a delta point lands in
        is the bucket a full rebuild would put it in — unless the point lies
        within an ulp of a bin edge, where the batch's product and the
        rebuild's may round apart, as in the reference. Assignments are
        stored per scale as (n_delta, n_sig) bucket matrices (2^m signatures
        for ProMiSH-E, one for ProMiSH-A).
      * **bulk deletes** — tombstones live on the corpus; here we only track
        which (keyword, bucket) coverage entries became *suspect* (the
        deleted point may have been the bucket's last live holder of that
        keyword), so query-time coverage can re-verify just those buckets
        instead of scanning the bulk index.

    Query-time, :meth:`covering_buckets` and :meth:`scale_pairs` give the
    plan layer the bulk ∪ delta view of one scale.
    """

    def __init__(self, index: PromishIndex, corpus):
        self.index = index
        self.corpus = corpus            # StreamingCorpus (bulk + delta view)
        self.n_bulk = corpus.bulk.n
        L = index.n_scales
        self._chunks: list[list[np.ndarray]] = [[] for _ in range(L)]
        self._mat: list[np.ndarray | None] = [None] * L
        # scale -> keyword -> set of suspect bucket ids (bulk deletes only):
        # buckets whose (keyword, bucket) coverage must be re-verified at
        # query time. Verdicts are monotone under a grow-only tombstone set,
        # so verified buckets leave the suspect set — dead ones permanently
        # into ``_dead`` (a bucket cannot come back to life), live ones
        # dropped until a later retire() touches them again.
        self._suspect: list[dict[int, set[int]]] = [{} for _ in range(L)]
        self._dead: list[dict[int, set[int]]] = [{} for _ in range(L)]

    # ------------------------------------------------------------- absorb
    def _bucket_ids(self, keys: tuple[torch.Tensor, torch.Tensor],
                    hi: HIStructure) -> np.ndarray:
        """(B, n_sig) bucket ids at one scale from that scale's bin keys
        (h1, h2 int64 (B, m) on the device) — the hashing the build ran."""
        h1, h2 = keys
        if self.index.exact:
            buckets = sig.bucket_ids_overlapping_torch(h1, h2, hi.n_buckets)
        else:
            buckets = sig.hash_signatures_torch(h1, hi.n_buckets)[:, None]
        return buckets.cpu().numpy()

    def _keys(self, points: np.ndarray, rows_dev: torch.Tensor) -> list:
        from repro_torch.core.index_build import bin_rows
        return bin_rows(rows_dev, points, self.index.z, self.index.widths)

    def absorb(self, points: np.ndarray, rows_dev: torch.Tensor,
               keys: list | None = None) -> None:
        """Bin a batch of new points at every scale (append-only).
        ``rows_dev`` holds the batch's rows on the device; ``keys`` (per
        scale (h1, h2)) short-circuits the binning when the caller already
        binned the batch with this index's ``z`` and widths (see
        :func:`absorb_into` — an engine's E and A indices draw identical
        ``z`` from the same seed, so the stream pays one K5 launch per
        scale, not two)."""
        if keys is None:
            keys = self._keys(np.ascontiguousarray(points, np.float32),
                              rows_dev)
        for s, hi in enumerate(self.index.structures):
            self._chunks[s].append(self._bucket_ids(keys[s], hi))
            self._mat[s] = None

    def retire(self, bulk_ids: np.ndarray, points_dev: torch.Tensor,
               keys: list | None = None) -> None:
        """Record bulk deletions: mark every (keyword, bucket) pair the
        deleted points contributed to as suspect for coverage.
        ``points_dev`` is the resident corpus on the device; ``keys`` as in
        :meth:`absorb`, for the bulk rows of ``bulk_ids`` in order."""
        bulk_ids = np.asarray(bulk_ids, dtype=np.int64)
        bulk_ids = bulk_ids[bulk_ids < self.n_bulk]
        if not len(bulk_ids):
            return      # delta deletions are handled by the corpus tombstones
        if keys is None:
            keys = self._keys(self.corpus.bulk.points[bulk_ids],
                              _gather(points_dev, bulk_ids))
        for s, hi in enumerate(self.index.structures):
            buckets = self._bucket_ids(keys[s], hi)
            suspect = self._suspect[s]
            for i, pid in enumerate(bulk_ids):
                bset = set(int(b) for b in buckets[i])
                for v in self.corpus.bulk.kw.row(int(pid)):
                    suspect.setdefault(int(v), set()).update(bset)

    def bucket_matrix(self, scale: int) -> np.ndarray:
        """(n_delta, n_sig) bucket assignments at ``scale``."""
        mat = self._mat[scale]
        if mat is None or len(mat) != self.corpus.n_delta:
            chunks = self._chunks[scale]
            n_sig = (1 << self.index.m) if self.index.exact else 1
            mat = np.concatenate(chunks, axis=0) if chunks else \
                np.empty((0, n_sig), dtype=np.int64)
            self._mat[scale] = mat
        return mat

    # ------------------------------------------------------------ query side
    def _delta_buckets_with(self, scale: int, v_kw: int) -> np.ndarray:
        """Buckets at ``scale`` holding >=1 live delta point tagged v_kw."""
        ids = self.corpus.delta_ids_with(v_kw)
        if not len(ids):
            return np.empty(0, dtype=np.int64)
        mat = self.bucket_matrix(scale)
        return np.unique(mat[ids - self.n_bulk])

    def verify_suspects(self, scale: int, keywords) -> int:
        """Batch-resolve suspect (keyword, bucket) coverage entries at one
        scale for every keyword in ``keywords``; returns the number of pairs
        verified. Each keyword's live posting list is materialised once and
        reused across all of its suspect buckets. Verdicts are monotone
        under the grow-only tombstone set, so resolved pairs leave the
        suspect map — dead buckets permanently into ``_dead``, live ones
        dropped until a later ``retire()`` touches them again."""
        suspect = self._suspect[scale]
        if not suspect:
            return 0
        hi = self.index.structures[scale]
        verified = 0
        for v in {int(v) for v in keywords}:
            buckets = suspect.get(v)
            if not buckets:
                continue
            vpts = self.corpus.bulk.ikp.row(v)
            live_v = vpts[~self.corpus.tombstoned(vpts)]
            newly_dead = {b for b in buckets
                          if not len(live_v)
                          or not sorted_member(hi.table.row(int(b)),
                                               live_v).any()}
            verified += len(buckets)
            buckets.clear()                # live-verified; retire() re-adds
            if newly_dead:
                self._dead[scale].setdefault(v, set()).update(newly_dead)
        return verified

    def covering_buckets(self, scale: int, query) -> np.ndarray:
        """Buckets containing all query keywords across bulk ∪ delta, live
        points only — the streaming replacement for
        :func:`repro_torch.core.plan.covering_buckets` (same ascending
        order)."""
        self.verify_suspects(scale, query)
        per_kw = []
        hi = self.index.structures[scale]
        for v in query:
            kb = hi.khb.row(int(v)).astype(np.int64)
            dead = self._dead[scale].get(int(v))
            if dead:
                kb = kb[~sorted_member(
                    kb, np.asarray(sorted(dead), dtype=np.int64))]
            dv = self._delta_buckets_with(scale, int(v))
            per_kw.append(np.union1d(kb, dv) if len(dv) else kb)
        stacked = np.concatenate(per_kw) if per_kw else np.empty(0, np.int64)
        u, counts = np.unique(stacked, return_counts=True)
        return u[counts == len(per_kw)]

    def scale_pairs(self, scale: int,
                    bitset: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Relevant live delta membership at one scale, as parallel
        ``(buckets, ids)`` arrays sorted by (bucket, id) and deduped (a
        ProMiSH-E point may draw the same bucket from distinct signatures).
        The plan layer slices per covering bucket with searchsorted."""
        rel = np.flatnonzero(bitset[self.n_bulk:])
        if not len(rel):
            empty = np.empty(0, dtype=np.int64)
            return empty, empty
        mat = self.bucket_matrix(scale)[rel]                    # (R, n_sig)
        ids = np.repeat(rel.astype(np.int64) + self.n_bulk, mat.shape[1])
        buckets = mat.reshape(-1).astype(np.int64)
        order = np.lexsort((ids, buckets))
        buckets, ids = buckets[order], ids[order]
        keep = np.ones(len(buckets), dtype=bool)
        keep[1:] = (buckets[1:] != buckets[:-1]) | (ids[1:] != ids[:-1])
        return buckets[keep], ids[keep]


def _gather(points_dev: torch.Tensor, ids: np.ndarray) -> torch.Tensor:
    return points_dev.index_select(
        0, torch.from_numpy(np.asarray(ids, np.int64)).to(points_dev.device))


def _shared_keys(deltas, points: np.ndarray, rows_dev: torch.Tensor):
    """Per delta, the batch's bin keys at each of its scales, binned once
    per distinct (``z``, widths) — an engine's exact and approx indices
    share both, so the common case launches K5 once per scale."""
    seen: list[tuple] = []
    out = []
    for d in deltas:
        for z, widths, keys in seen:
            if widths == d.index.widths and np.array_equal(z, d.index.z):
                break
        else:
            keys = d._keys(points, rows_dev)
            seen.append((d.index.z, d.index.widths, keys))
        out.append(keys)
    return out


def absorb_into(deltas, points: np.ndarray, rows_dev: torch.Tensor) -> None:
    """Absorb one insert batch into several :class:`IndexDelta` buffers,
    sharing the binning between deltas whose indices drew the same ``z``
    and widths. ``rows_dev`` holds the batch's rows on the device."""
    points = np.ascontiguousarray(points, np.float32)
    deltas = list(deltas)
    for d, keys in zip(deltas, _shared_keys(deltas, points, rows_dev)):
        d.absorb(points, rows_dev, keys=keys)


def retire_from(deltas, ids: np.ndarray, points_dev: torch.Tensor) -> None:
    """Record one delete batch (internal ids, bulk or delta) in several
    :class:`IndexDelta` buffers, binning the deleted bulk rows once per
    distinct (``z``, widths). ``points_dev`` is the resident corpus."""
    deltas = list(deltas)
    if not deltas:
        return
    ids = np.asarray(ids, dtype=np.int64)
    bulk_ids = ids[ids < deltas[0].n_bulk]
    if not len(bulk_ids):
        return
    rows = deltas[0].corpus.bulk.points[bulk_ids]
    for d, keys in zip(deltas, _shared_keys(
            deltas, rows, _gather(points_dev, bulk_ids))):
        d.retire(bulk_ids, points_dev, keys=keys)
