"""The index build on the device: binning in K5, hashing and CSR assembly
in PyTorch, the index the host build gives, bit for bit.

The index is *defined* by the host: ``z`` from ``default_rng(seed)``, the
projections ``p_host`` as numpy's fp32 product over the whole corpus (the
same call the host build makes), ``p_max`` and ``w0`` from their span. Those
stay on the host: numpy's product of a row subset is not the same rows of
the full product, so ``p_host`` cannot be recomputed piecewise, and every
bin edge moves with ``w0``.

Everything per entry runs on the device. Per scale, one K5 launch
(``kernels.ops.project_and_bin``) projects the resident corpus and bins both
keys; the exact and approximate indices share ``z`` and the widths, and the
approximate key ``floor(p / w)`` is K5's ``h1``, so one launch serves both.
K5's sum runs in another order than numpy's and multiplies by ``fp32(1/w)``
where numpy divides by ``fp32(w)``, so an entry whose scaled value lies
within a provable margin of an integer may bin differently. Those entries
(``settled``) are re-binned on the host from ``p_host`` with the host
build's own elementwise formula (:func:`projection.bin_keys_overlapping`),
and written back over K5's keys. The margin, in bin units:

  * ``2 gamma_d |x|_2 / w``: both fp32 dot products lie within
    ``gamma_d sum_i |x_i z_i| <= gamma_d |x|_2`` of the exact value
    (Higham, |z|_2 = 1), ``gamma_d = d u / (1 - d u)``, ``u = 2^-24``;
  * ``8 u (|v| + 1)``: the divide against the multiply by the rounded
    reciprocal, the subtraction of ``w / 2`` and the fp32 products, each a
    few ulps of the scaled value ``v``.

Signatures hash on the device in int64 (``signatures.*_torch``), the
(bucket, point) and (keyword, bucket) pairs dedup and sort there
(``csr_from_pairs_torch``), and the CSRs are copied back to the host, where
the plan layer reads them. With ``synopsis=True`` each scale's bucket
synopsis (:func:`repro_torch.core.index.build_synopsis`: counts, bounding
radii, attribute and tenant ranges) is then built on the host from those
tables, with the host build's own numpy arithmetic, so it equals the host
build's bit for bit.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import projection as proj
from repro_torch.core import signatures as sig
from repro_torch.core.index import (HIStructure, PromishIndex,
                                    build_synopsis, default_n_buckets)
from repro_torch.core.types import KeywordDataset
from repro_torch.kernels import ops
from repro_torch.kernels.ref import bin_constants
from repro_torch.utils.csr import (CSR, csr_from_pairs_torch,
                                   ragged_arange_torch)

_U = 2.0 ** -24


@dataclasses.dataclass
class BuildStats:
    """One build of an engine's indices: wall per phase (each ends in a
    device synchronisation), K5 launches, and entries settled on the host
    per scale (h1 and h2 counted apart)."""

    t_project_s: float = 0.0      # host: z, the numpy product, p_max, w0
    t_bin_s: float = 0.0          # K5 launches
    t_settle_s: float = 0.0       # margin test, host re-binning, write-back
    t_assemble_s: float = 0.0     # hashing and both CSRs on the device
    t_copy_s: float = 0.0         # CSRs to the host
    t_synopsis_s: float = 0.0     # host: bucket synopses (synopsis=True)
    k5_launches: int = 0
    settled: list[int] = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def margin_scale(rows: torch.Tensor) -> torch.Tensor:
    """(B,) float32: ``2 gamma_d |x|_2`` per row, rounded up (the fp32 norm
    is inflated by its own worst-case error and |z|_2's)."""
    d = rows.shape[1]
    gamma = d * _U / (1.0 - d * _U)
    norm = torch.linalg.vector_norm(rows.to(torch.float32), dim=1)
    return norm * float(2.0 * gamma * (1.0 + 1e-3))


def _near_edge(v: torch.Tensor, margin: torch.Tensor) -> torch.Tensor:
    """Entries whose scaled value lies within ``margin`` (plus the ulps
    term) of an integer."""
    tol = margin + 8.0 * _U * (v.abs() + 1.0)
    return (v - torch.round(v)).abs() <= tol


def bin_scale(rows: torch.Tensor, z: torch.Tensor, margin: torch.Tensor,
              p_host: np.ndarray, width: float,
              stats: BuildStats | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both bin keys of ``rows`` (B, d) at ``width``, as the host computes
    them from ``p_host`` (B, m), the numpy product these rows are defined
    by: one K5 launch, then the entries near a bin edge re-binned from
    ``p_host``. Returns (h1, h2) int64 (B, m) on the rows' device, h2
    offset by C. ``stats`` (optional) gets the launch, the entries settled
    and the two phases' walls."""
    t0 = time.perf_counter()
    h1, h2, p = ops.project_and_bin(rows, z, width, proj.DEFAULT_C)
    if stats is not None:
        _sync(rows.device)
        stats.k5_launches += 1
        stats.t_bin_s += time.perf_counter() - t0
        t0 = time.perf_counter()
    inv_w, half_w, _ = (torch.tensor(c, dtype=torch.float32, device=p.device)
                        for c in bin_constants(width, proj.DEFAULT_C))
    scaled = margin[:, None] / float(np.float32(width))
    flag1 = _near_edge(p * inv_w, scaled)
    flag2 = _near_edge((p - half_w) * inv_w, scaled)
    h1, h2 = h1.to(torch.int64), h2.to(torch.int64)
    settled = 0
    for plane, flag, which in ((h1, flag1, 0), (h2, flag2, 1)):
        idx = torch.nonzero(flag.reshape(-1)).reshape(-1)
        if not len(idx):
            continue
        flat = idx.cpu().numpy()
        keys = proj.bin_keys_overlapping(p_host.reshape(-1)[flat], width)
        plane.view(-1)[idx] = torch.from_numpy(
            np.ascontiguousarray(keys[:, which])).to(plane.device)
        settled += len(flat)
    if stats is not None:
        _sync(rows.device)
        stats.settled.append(settled)
        stats.t_settle_s += time.perf_counter() - t0
    return h1, h2


def bin_rows(rows_dev: torch.Tensor, rows: np.ndarray, z: np.ndarray,
             widths, stats: BuildStats | None = None
             ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Bin keys of a batch of rows at every width, one K5 launch each,
    settled against ``proj.project(rows, z)`` — the numpy product of this
    batch, which is what defines its keys (the reference bins an insert or
    delete batch from exactly that product). ``rows_dev`` holds the same
    rows on the device."""
    p_host = proj.project(rows, z)
    z_dev = torch.tensor(z, device=rows_dev.device)
    margin = margin_scale(rows_dev)
    return [bin_scale(rows_dev, z_dev, margin, p_host, w, stats)
            for w in widths]


def _khb(table_offsets: torch.Tensor, table_values: torch.Tensor,
         kw_offsets: torch.Tensor, kw_values: torch.Tensor,
         n_keywords: int) -> tuple[torch.Tensor, torch.Tensor]:
    """I_khb on the device: every (bucket, point) entry expanded to the
    point's keywords (a ragged gather of its keyword slice), then the
    (keyword, bucket) pairs deduped."""
    n_buckets = len(table_offsets) - 1
    pts = table_values.to(torch.int64)
    per_bucket = table_offsets[1:] - table_offsets[:-1]
    bkt = torch.repeat_interleave(
        torch.arange(n_buckets, dtype=torch.int64, device=pts.device),
        per_bucket, output_size=len(pts))
    kw_counts = (kw_offsets[1:] - kw_offsets[:-1])[pts]
    total = int(kw_counts.sum()) if len(pts) else 0
    bk_rep = torch.repeat_interleave(bkt, kw_counts, output_size=total)
    idx = torch.repeat_interleave(kw_offsets[pts], kw_counts,
                                  output_size=total) \
        + ragged_arange_torch(kw_counts)
    kws = kw_values[idx].to(torch.int64)
    del bkt, idx
    return csr_from_pairs_torch(kws, bk_rep.to(torch.int32), n_keywords,
                                dedup=True)


def _to_host(offsets: torch.Tensor, values: torch.Tensor) -> CSR:
    return CSR(offsets=offsets.cpu().numpy(), values=values.cpu().numpy())


def _assemble_scale(dataset: KeywordDataset, h1: torch.Tensor,
                    h2: torch.Tensor, scale: int, width: float,
                    n_buckets: int, kw: tuple[torch.Tensor, torch.Tensor],
                    stats: BuildStats,
                    flavours: tuple[bool, ...] = (True, False),
                    synopsis: bool = False) -> list[HIStructure]:
    """One scale of the indices in ``flavours`` (True: exact, False:
    approximate) from its bin keys (h1, h2 int64 (n, m) on the device): the
    exact structure hashes all 2^m signatures into ``n_buckets``, the
    approximate one h1 alone into ``n_buckets >> scale`` (at least 64);
    tables and I_khb are assembled on the device and copied to the host,
    where ``synopsis`` builds each table's bucket synopsis."""
    dev = h1.device
    point_ids = torch.arange(dataset.n, dtype=torch.int32, device=dev)
    out = []
    t1 = time.perf_counter()
    for exact in flavours:
        nb = n_buckets if exact else max(64, n_buckets >> scale)
        if exact:
            buckets = sig.bucket_ids_overlapping_torch(h1, h2, nb)
            ids = torch.repeat_interleave(point_ids, buckets.shape[1])
        else:
            buckets, ids = sig.hash_signatures_torch(h1, nb), point_ids
        t_off, t_val = csr_from_pairs_torch(buckets.reshape(-1), ids, nb,
                                            dedup=True)
        del buckets, ids
        k_off, k_val = _khb(t_off, t_val, *kw, dataset.n_keywords)
        _sync(dev)
        t2 = time.perf_counter()
        table = _to_host(t_off, t_val)
        khb = _to_host(k_off, k_val)
        t3 = time.perf_counter()
        syn = build_synopsis(dataset, table, nb) if synopsis else None
        t4 = time.perf_counter()
        out.append(HIStructure(scale=scale, width=width, n_buckets=nb,
                               table=table, khb=khb, synopsis=syn))
        stats.t_assemble_s += t2 - t1
        stats.t_copy_s += t3 - t2
        stats.t_synopsis_s += t4 - t3
        t1 = t4
    return out


def build_indices(dataset: KeywordDataset, points_dev: torch.Tensor, *,
                  m: int = 2, n_scales: int = 5, seed: int = 0,
                  w0: float | None = None, n_buckets: int | None = None,
                  stats: BuildStats | None = None,
                  build_exact: bool = True, build_approx: bool = True,
                  synopsis: bool = False
                  ) -> tuple[PromishIndex | None, PromishIndex | None]:
    """The ProMiSH indices of ``dataset`` (exact, approximate), equal array
    for array to :func:`repro_torch.core.index.build_index` with the same
    arguments, built on the device ``points_dev`` (the corpus's rows, (n, d)
    fp32) lies on: one K5 launch per scale. ``w0``/``n_buckets`` pin the
    hash geometry as there (``n_buckets`` a power of two or below 2^31). Phase
    walls, K5 launches and settled entries accumulate in ``stats``.
    ``build_exact=False`` / ``build_approx=False`` skip that flavour's
    assembly; its slot in the result is None. ``synopsis=True`` attaches
    each scale's bucket synopsis, built on the host from the copied-back
    tables (``stats.t_synopsis_s``)."""
    st = stats if stats is not None else BuildStats()
    dev = points_dev.device
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    z = proj.sample_unit_vectors(rng, m, dataset.dim)
    p_host = proj.project(dataset.points, z)
    p_max = proj.projection_span(p_host)
    if w0 is None:
        w0 = p_max / (2.0 ** n_scales)
    if n_buckets is None:
        n_buckets = default_n_buckets(dataset.n)
    z_dev = torch.from_numpy(z).to(dev)
    margin = margin_scale(points_dev)
    kw = (torch.from_numpy(dataset.kw.offsets).to(dev),
          torch.from_numpy(dataset.kw.values).to(dev))
    _sync(dev)
    st.t_project_s += time.perf_counter() - t0
    flavours = tuple(f for f, on in ((True, build_exact),
                                     (False, build_approx)) if on)
    structs = []
    for s in range(n_scales):
        width = w0 * (2.0 ** s)
        h1, h2 = bin_scale(points_dev, z_dev, margin, p_host, width, st)
        structs.append(_assemble_scale(dataset, h1, h2, s, width, n_buckets,
                                       kw, st, flavours, synopsis))
        del h1, h2
    built = {exact: PromishIndex(z=z, w0=float(w0), n_scales=n_scales,
                                 exact=exact, structures=tuple(per_scale),
                                 p_max=p_max)
             for exact, per_scale in zip(flavours, zip(*structs))}
    return built.get(True), built.get(False)
