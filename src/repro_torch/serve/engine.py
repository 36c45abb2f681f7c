"""Batched NKS serving engine over a static corpus.

Production shape: a frontend batches keyword-set queries; the engine answers
from a ProMiSH index over an embedding corpus, in three quality/latency tiers:

  * ``exact``  — ProMiSH-E (100% accuracy, Lemma-2 guarantee);
  * ``approx`` — ProMiSH-A (the paper's fast tier);
  * ``device`` — the anchor-star tier (``core.distributed``): the whole
    search of one query on the device, within 2x of the optimum.

``query_batch`` runs the exact and approx tiers as a **staged batched
pipeline**: per scale, bucket selection for the whole batch is amortised
through ``core.plan.plan_scale`` (shared per-query Algorithm-2 dedup), surviving
subsets are packed on the device into a handful of size-binned fused
threshold-join dispatches (``backend="torch"``, each emitting the packed join
bitmask; subsets whose pruning radius is still infinite skip the device
entirely) or looped through float64 numpy (``backend="numpy"``), and the host
enumeration stage consumes the join blocks through the vectorized frontier of
``subset_search.enumerate_with_block``. Per-scale dispatches, phase timings
and cache hits are recorded in :class:`PipelineStats`
(``engine.last_batch_stats``).

The engine runs on the card: it puts the corpus on the CUDA device once, at
construction, builds both indices there (``core.index_build``: binning in
K5, hashing and CSR assembly in PyTorch), and its ``"torch"`` backend
launches the hand-written kernels. ``device="cpu"`` runs the same pipeline
on the host through the kernels' plain PyTorch versions; with no CUDA device
and no ``device`` it raises. The device tier gathers each query's keyword
groups from that resident corpus and issues one anchor-star dispatch per
query.

**Sharded serving** (``mesh=``, a
:class:`~repro_torch.core.device_plane.DevicePlane`, a list of shard
devices or ``"auto"``): one plane carries every tier. The engine's
``"torch"`` backend splits each device-routed bin that packs a subset a
shard over the plane's slabs (K1, K2 or K2i once a slab), and the device
tier scores each shard's slice of the anchors with K6 and merges the
shards' top-k. Answers are the single-device engine's, bit for bit.

**Streaming ingest** (``insert`` / ``delete`` / ``compact``): the engine
serves while the corpus changes. Inserts land in an append-only delta
(:class:`~repro_torch.core.types.StreamingCorpus` +
:class:`~repro_torch.core.index.IndexDelta` per index flavour) binned through
K5 with the bulk index's hash geometry, and their rows join the resident
corpus on the device (each uploaded once); deletes are tombstones; a
size/ratio-triggered compaction (``compact_ratio``/``compact_min``) rebuilds
both indices on the device over the live corpus and swaps them in, bumping
``corpus_generation`` — the token the backend caches are scoped to (absorbs
keep caches warm, only compaction invalidates). A query issued after an
ingest call returns sees all of that call's batch and every earlier one;
results carry *external* ids that stay stable across compactions.
``PipelineStats`` records generation/delta/tombstone state per batch,
``engine.ingest`` the lifetime counters.

**Filtered and tenant-scoped serving** (``filter=`` on ``query`` and
``query_batch``, a :class:`~repro_torch.core.filters.Filter` or its JSON
form): the predicate and tenant mask is evaluated once per batch and ANDed
with the tombstones; planning prunes subsets with no eligible member,
keyword groups restrict to eligible points, and the device join takes the
mask as eligibility words (K1's fold, K2's on the prune tier) or, at low
selectivity, packs only the eligible rows — the readback is the unfiltered
dispatch's packed mask either way. On a multi-tenant corpus a
tenant-scoped query speaks tenant-local keyword ids.

**Flexible semantics** (``semantics=`` on ``query`` and ``query_batch``, a
:class:`~repro_torch.core.semantics.QuerySemantics` or its JSON form): m-of-k
coverage expands each query into its keyword subqueries, which run the same
plan/dispatch/enumerate loop as execution entries sharing their query's
queue; keyword weights rescale only the host float64 settlement (the
device join at the geometric radius stays a superset); scored queues rank by
coverage over cost. Degenerate semantics give the classic answer exactly;
the device tier refuses the rest.

**Durability** (``attach_wal`` / ``snapshot`` / ``recover``, see
:mod:`repro_torch.serve.wal`): every insert, delete and compaction is
appended to a write-ahead log and fsync'd before it is acknowledged
(``ingest_group()`` shares one fsync among a run of ops); ``snapshot()``
rolls the log; ``recover(root)`` loads the latest snapshot and replays the
log through the same card path as live ops, into an engine that answers as
the uninterrupted one did, bit for bit.

**Out-of-core serving** (``from_store``, see :mod:`repro_torch.core.store`):
an engine opens over a bulk store on disk without a rebuild. The keyword
CSRs and bucket tables stay memory-mapped on the host for the planner; the
points are read off their mapped leaf once, into the card, where the whole
corpus stays resident (a corpus that does not fit raises at open). With
bucket synopses (``synopsis=True``, or a store built with them) the planner
skips buckets whose zone maps exclude a filter and dispatches subsets whose
diameter bound already beats the live ``r_k`` through the all-ones fast
path; answers are bit-identical with the prunes on or off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import carry, plan, promish_a, promish_e
from repro_torch.core import store as storemod
from repro_torch.core.backend import (DistanceBackend, NumpyBackend,
                                      TorchBackend, resolve_device)
from repro_torch.core.device_plane import (gather_groups, get_plane,
                                           pack_group_ids)
from repro_torch.core.distributed import nks_anchor_topk
from repro_torch.core.filters import Filter
from repro_torch.core.index import (IndexDelta, PromishIndex, absorb_into,
                                    retire_from)
from repro_torch.core.index_build import BuildStats, build_indices
from repro_torch.core.semantics import QuerySemantics
from repro_torch.core.subset_search import enumerate_with_block, local_groups
from repro_torch.core.types import (Candidate, KeywordDataset,
                                    StreamingCorpus, TopK, make_dataset)
from repro_torch.serve import wal as walmod
from repro_torch.serve.faults import NO_FAULTS, FaultPlan

# Process-global corpus-generation tokens: every (engine, compaction) pair
# gets a unique token, so a DistanceBackend shared across engines can never
# serve one engine's cached rows to another (generation numbers restart at 0
# per engine; tokens do not).
_CORPUS_TOKENS = itertools.count(1)


@dataclasses.dataclass
class QueryResult:
    query: list[int]
    candidates: list[Candidate]
    latency_s: float
    tier: str


@dataclasses.dataclass
class ScaleStats:
    """One pipeline stage = one scale of the multi-scale index."""

    scale: int
    active_queries: int = 0
    buckets_selected: int = 0
    duplicate_subsets: int = 0
    filtered_subsets: int = 0    # predicate-pruned before pack/dispatch
    tasks_planned: int = 0
    tasks_searched: int = 0      # tasks with all keyword groups non-empty
    dispatches: int = 0          # device/loop distance dispatches this scale
    join_pairs: int = 0
    queries_finished: int = 0
    # Synopsis prunes (zero without synopses): buckets zone-rejected before
    # their member lists were read, subsets sent through the all-ones fast
    # path because their bucket's diameter bound beat the live r_k.
    buckets_pruned_zonemap: int = 0
    buckets_pruned_radius: int = 0


@dataclasses.dataclass
class PipelineStats:
    """End-to-end accounting for one ``query_batch`` call.

    The four phase timers split the batch wall time: ``plan`` (bucket
    selection + keyword grouping), ``pack`` (tile packing, backend-side),
    ``dispatch`` (device dispatch + D2H readback, and host-routed bins),
    ``enumerate`` (host Alg. 4 over the join masks). Cache counters mirror
    the backend's LRU. The device tier fills ``pack`` (host id packing, the
    ids' upload and the device gather, as enqueued), ``dispatch`` (the
    anchor-star search and the readback that waits for it), the transfer
    bytes and ``shard_dispatches``.

    Device-plane accounting (``mesh=``): ``shard_dispatches[i]`` counts the
    dispatches shard i took part in (a single-device dispatch lands on
    shard 0; the list has one entry without a plane),
    ``shard_valid_cells``/``shard_total_cells`` each shard's valid and
    padded join-block cells, ``sharded_dispatches`` the dispatches split
    over the shards and ``t_collective_s`` their wall (the shards' launches
    and the gather back; for the device tier the whole sharded search).
    """

    batch_size: int
    tier: str
    backend: str
    scales: list[ScaleStats] = dataclasses.field(default_factory=list)
    fallback_queries: int = 0
    fallback_dispatches: int = 0
    candidates_explored: int = 0
    t_plan_s: float = 0.0
    t_pack_s: float = 0.0
    t_dispatch_s: float = 0.0
    t_enumerate_s: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    valid_cells: int = 0
    total_cells: int = 0
    # Cascade accounting: the coarse bf16 count pass (``t_prune_s``), the
    # fp32 masked join (the remainder of ``t_dispatch_s``), the host float64
    # settlement of surviving tuples (``t_rescore_s``, measured inside the
    # enumeration stage), and cost-model routing (bins sent to the float64
    # host loop instead of the device). ``bin_occupancy`` maps each size
    # class (padded width) to [valid, padded] packed point counts.
    prune_tier_dispatches: int = 0
    cells_pruned: int = 0
    t_prune_s: float = 0.0
    t_rescore_s: float = 0.0
    t_host_s: float = 0.0
    host_routed_dispatches: int = 0
    host_routed_subsets: int = 0
    bin_occupancy: dict = dataclasses.field(default_factory=dict)
    shard_dispatches: list[int] = dataclasses.field(default_factory=list)
    sharded_dispatches: int = 0
    t_collective_s: float = 0.0
    shard_valid_cells: list[int] = dataclasses.field(default_factory=list)
    shard_total_cells: list[int] = dataclasses.field(default_factory=list)
    # Streaming-ingest accounting: the corpus generation the batch ran
    # against (bumped by compaction only), the delta/tombstone sizes at
    # batch time, and the engine's lifetime compaction count.
    corpus_generation: int = 0
    delta_points: int = 0
    tombstones: int = 0
    compactions: int = 0
    # Filtered accounting: eligible_points/selectivity describe the batch's
    # predicate mask (None on an unfiltered batch); filtered_subsets counts
    # planned subsets pruned because no member satisfied the predicate;
    # elig_fold/dense_dispatches count the device dispatches of each packing
    # mode. The "no new D2H" contract of the eligibility fold reads d2h_bytes.
    eligible_points: int | None = None
    filter_selectivity: float | None = None
    filtered_subsets: int = 0
    elig_fold_dispatches: int = 0
    elig_dense_dispatches: int = 0
    # Flexible semantics: planned subqueries after m-of-k expansion
    # (== batch_size on a classic batch — one subquery per query).
    subqueries: int = 0
    # Out-of-core tiering: buckets the planner skipped because the filter
    # was provably disjoint from their zone maps, subsets dispatched through
    # the all-ones fast path because their bucket's diameter bound already
    # beat the live r_k, and bytes of point rows the backend gathered off a
    # memory-mapped store leaf. All zero on an engine without synopses over
    # a resident corpus.
    buckets_pruned_zonemap: int = 0
    buckets_pruned_radius: int = 0
    cold_bytes_read: int = 0
    # Spans on time.perf_counter(): the call's entry, and per query of a
    # device-tier call, in order, (pack_start, dispatch_start,
    # readback_done), the readings ``t_pack_s`` and ``t_dispatch_s`` sum
    # (a query whose filter empties a group spans nothing). A query waits
    # on its batchmates from ``t_call_start`` to its ``pack_start``.
    t_call_start: float = 0.0
    query_spans: list[tuple[float, float, float]] = dataclasses.field(
        default_factory=list)

    @property
    def dispatches_per_scale(self) -> list[int]:
        return [s.dispatches for s in self.scales]

    @property
    def total_dispatches(self) -> int:
        return sum(s.dispatches for s in self.scales) + self.fallback_dispatches

    @property
    def device_dispatches(self) -> int:
        """Bins the backend joined on the device (the rest went to the host
        route)."""
        return self.total_dispatches - self.host_routed_dispatches

    @property
    def phases(self) -> dict:
        """JSON-ready phase breakdown."""
        probed = self.cache_hits + self.cache_misses
        return {
            "plan_s": self.t_plan_s,
            "pack_s": self.t_pack_s,
            "dispatch_s": self.t_dispatch_s,
            "enumerate_s": self.t_enumerate_s,
            "collective_s": self.t_collective_s,
            "cache_hit_rate": self.cache_hits / probed if probed else None,
        }

    @property
    def shard_utilisation(self) -> list[float]:
        """Valid-cell fraction of each shard's packed join blocks (the
        complement is pad waste shipped to that shard)."""
        return [round(v / t, 4) if t else 0.0
                for v, t in zip(self.shard_valid_cells,
                                self.shard_total_cells)]

    @property
    def sharding(self) -> dict:
        """JSON-ready device-plane summary."""
        return {
            "sharded_dispatches": self.sharded_dispatches,
            "shard_dispatches": list(self.shard_dispatches),
            "shard_utilisation": self.shard_utilisation,
            "padded_cell_ratio": self.padded_cell_ratio,
            "collective_s": self.t_collective_s,
        }

    @property
    def padded_cell_ratio(self) -> float | None:
        """Fraction of dispatched join-block cells that were padding; None
        with no device dispatches."""
        if not self.total_cells:
            return None
        return 1.0 - self.valid_cells / self.total_cells

    @property
    def cascade(self) -> dict:
        """JSON-ready per-tier cascade summary."""
        return {
            "prune_tier_dispatches": self.prune_tier_dispatches,
            "cells_pruned": self.cells_pruned,
            "prune_s": self.t_prune_s,
            "join_s": max(self.t_dispatch_s - self.t_prune_s
                          - self.t_host_s, 0.0),
            "rescore_s": self.t_rescore_s,
            "device_dispatches": self.device_dispatches,
            "host_routed_dispatches": self.host_routed_dispatches,
            "host_routed_subsets": self.host_routed_subsets,
            "host_s": self.t_host_s,
        }

    @property
    def binning(self) -> dict:
        """JSON-ready size-class occupancy."""
        return {
            "padded_cell_ratio": self.padded_cell_ratio,
            "bins": {str(k): {"points": v[0], "padded": v[1]}
                     for k, v in sorted(self.bin_occupancy.items())},
        }

    @property
    def filtering(self) -> dict:
        """JSON-ready filtered-serving summary."""
        return {"eligible_points": self.eligible_points,
                "selectivity": self.filter_selectivity,
                "filtered_subsets": self.filtered_subsets,
                "fold_dispatches": self.elig_fold_dispatches,
                "dense_dispatches": self.elig_dense_dispatches,
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes}

    @property
    def ingest(self) -> dict:
        """JSON-ready streaming state at batch time."""
        return {"generation": self.corpus_generation,
                "delta_points": self.delta_points,
                "tombstones": self.tombstones,
                "compactions": self.compactions}

    @property
    def tiering(self) -> dict:
        """JSON-ready out-of-core tiering summary."""
        return {"buckets_pruned_zonemap": self.buckets_pruned_zonemap,
                "buckets_pruned_radius": self.buckets_pruned_radius,
                "cold_bytes_read": self.cold_bytes_read}


@dataclasses.dataclass
class IngestStats:
    """Lifetime streaming counters for one engine (``engine.ingest``)."""

    inserts: int = 0            # insert calls absorbed
    points_inserted: int = 0
    deletes: int = 0            # delete calls absorbed
    points_deleted: int = 0
    compactions: int = 0
    generation: int = 0         # == engine.corpus_generation
    wal_appends: int = 0        # ops made durable before their ack
    replayed_ops: int = 0       # ops re-applied by the last recover()
    snapshots: int = 0          # log-rolling snapshots taken

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class StaleCompactionError(RuntimeError):
    """A prepared compaction no longer matches the live streaming state —
    an ingest op slipped in between prepare and commit; the commit refuses
    rather than swap in a bulk that silently drops the interleaved ops."""


@dataclasses.dataclass
class PreparedCompaction:
    """The O(N) half of a compaction: the folded bulk dataset, its rows on
    the device, the indices built there, and the external-id remap.
    ``version`` pins the streaming state it was prepared against; commit
    re-checks it."""

    version: tuple[int, int]            # (corpus rows, tombstones) at prepare
    bulk: KeywordDataset
    points_dev: torch.Tensor
    index_e: PromishIndex | None
    index_a: PromishIndex | None
    live: np.ndarray
    ext: np.ndarray
    build_stats: BuildStats


_DELTA_FIELDS = ("t_pack_s", "t_dispatch_s", "cache_hits", "cache_misses",
                 "h2d_bytes", "d2h_bytes", "valid_cells", "total_cells",
                 "prune_tier_dispatches", "cells_pruned", "t_prune_s",
                 "t_host_s", "host_routed_dispatches", "host_routed_subsets",
                 "elig_fold_dispatches", "elig_dense_dispatches",
                 "cold_bytes_read", "sharded_dispatches", "t_collective_s")
_SHARD_FIELDS = ("shard_dispatches", "shard_valid_cells", "shard_total_cells")


class NKSEngine:
    def __init__(self, dataset: KeywordDataset, *, m: int = 2,
                 n_scales: int = 5, seed: int = 0,
                 w0: float | None = None, n_buckets: int | None = None,
                 compact_ratio: float = 0.25, compact_min: int = 4096,
                 auto_compact: bool = True,
                 build_exact: bool = True, build_approx: bool = True,
                 device: str | torch.device | None = None,
                 faults: FaultPlan | None = None, synopsis: bool = False,
                 resident_budget_bytes: int | None = None, mesh=None,
                 _indices: tuple[PromishIndex, PromishIndex] | None = None):
        """Put the corpus on ``device`` (the CUDA card unless the caller
        passes another; see :func:`repro_torch.core.backend.resolve_device`)
        and build both indices there (:func:`core.index_build.build_indices`;
        phase walls in ``self.build_stats``). The ``"torch"`` backend is
        built here too, so its cost model is calibrated — and on the card
        its kernels built — before the first batch; one device-tier search
        on a dummy pack does the same for that tier (the matrix product
        library's set-up and K6's build).

        Streaming knobs: ``w0``/``n_buckets`` pin the hash geometry across
        compactions (None derives both from the corpus, per the paper;
        ``n_buckets`` is a power of two or below 2^31); after an insert or
        delete, the delta is folded into a fresh bulk index once
        ``delta_points + tombstones >= max(compact_min, compact_ratio * N)``
        (``auto_compact=False`` leaves compaction to :meth:`compact`).

        ``build_exact=False`` / ``build_approx=False`` skip that index (and
        its streaming delta and rebuilds); its tier then raises.

        ``synopsis=True`` builds each scale's bucket synopsis (zone maps and
        bounding radii, on the host from the copied-back tables), and every
        compaction rebuilds them: the flag rides in the pinned build params.
        ``resident_budget_bytes`` bounds the torch backend's tile and table
        cache (``TorchBackend(cache_bytes=)``), the hot tier above the
        memory-mapped leaves of an engine opened with :meth:`from_store`.
        ``faults`` (a :class:`~repro_torch.serve.faults.FaultPlan`) arms the
        ``compact`` and ``wal_ack`` fault points for the durability tests.

        ``mesh`` attaches a device plane: a
        :class:`~repro_torch.core.device_plane.DevicePlane`, a list of shard
        devices, or ``"auto"`` (``launch.mesh.make_serving_mesh``: every
        local card, or ``REPRO_MESH_OVERRIDE``'s first value, on ``device``'s
        kind). The engine's device is the plane's first; the ``"torch"``
        backend shards its device-routed bins over the plane and the device
        tier runs the sharded anchor-star search. ``mesh=None`` (default)
        keeps every tier on one device."""
        self.plane = None
        if mesh is not None:
            self.plane = get_plane(mesh, device=device)
            self.plane.check_device(device)
            device = self.plane.device
        self.device = resolve_device(device)
        self._bulk = dataset
        self.last_batch_stats: PipelineStats | None = None
        self._build_params = dict(m=m, n_scales=n_scales, seed=seed,
                                  w0=w0, n_buckets=n_buckets,
                                  synopsis=synopsis)
        self.resident_budget_bytes = resident_budget_bytes
        self._corpus_token = next(_CORPUS_TOKENS)
        kw = {} if resident_budget_bytes is None \
            else {"cache_bytes": int(resident_budget_bytes)}
        self.backend = TorchBackend(device=self.device, plane=self.plane,
                                    **kw)
        self.backend.attach(dataset.points, self._corpus_token)
        self.build_stats = BuildStats()
        if _indices is not None:
            self.index_e, self.index_a = _indices
        else:
            self.index_e, self.index_a = build_indices(
                dataset, self.backend._points_dev, stats=self.build_stats,
                build_exact=build_exact, build_approx=build_approx,
                **self._build_params)
        # Streaming-ingest state: lazy — a never-mutated engine keeps the
        # frozen KeywordDataset and the classic single-corpus code paths.
        self._view: StreamingCorpus | None = None
        self._deltas: dict[str, IndexDelta] = {}
        # internal -> external id map, stored in a capacity-doubled buffer so
        # absorbing a batch appends in O(batch), not O(corpus).
        self._ext_buf = np.arange(dataset.n, dtype=np.int64)
        self._ext_len = dataset.n
        self._next_ext = dataset.n
        self._identity_ids = True
        self.corpus_generation = 0
        self.compact_ratio = float(compact_ratio)
        self.compact_min = int(compact_min)
        self.auto_compact = bool(auto_compact)
        self.ingest = IngestStats()
        # Durability (attach_wal / recover): every mutating op is appended —
        # and fsync'd — before its ack. None = volatile engine (the default).
        self._faults = faults or NO_FAULTS
        self._wal: walmod.WriteAheadLog | None = None
        self._wal_root: str | None = None
        self._wal_epoch = 0
        self._wal_group = 0         # ingest_group() nesting depth
        self._replaying = False
        self.backend.warmup(dataset.dim)
        shape = (2, 128 if self.plane is None else self.plane.shard_pad(128))
        (nks_anchor_topk if self.plane is None else self.plane.nks_topk)(
            torch.zeros((*shape, dataset.dim), device=self.device),
            torch.ones(shape, dtype=torch.bool, device=self.device),
            torch.zeros(shape, dtype=torch.int32, device=self.device), 1)

    # ------------------------------------------------------------- streaming
    @property
    def dataset(self):
        """The corpus the engine currently serves: the merged streaming view
        while a delta/tombstone set is live, the frozen bulk otherwise."""
        return self._view if self._view is not None else self._bulk

    @property
    def delta_points(self) -> int:
        return self._view.n_delta if self._view is not None else 0

    @property
    def tombstone_count(self) -> int:
        return self._view.n_tombstones if self._view is not None else 0

    def _streaming_dirty(self) -> bool:
        return self._view is not None and self._view.dirty

    @property
    def next_external_id(self) -> int:
        """The id the next inserted point will receive (ids are assigned
        strictly sequentially)."""
        return int(self._next_ext)

    @property
    def _ext_of(self) -> np.ndarray:
        return self._ext_buf[: self._ext_len]

    def _ext_append(self, ext: np.ndarray) -> None:
        need = self._ext_len + len(ext)
        if len(self._ext_buf) < need:
            grown = np.empty(max(2 * len(self._ext_buf), need), dtype=np.int64)
            grown[: self._ext_len] = self._ext_buf[: self._ext_len]
            self._ext_buf = grown
        self._ext_buf[self._ext_len:need] = ext
        self._ext_len = need

    def _streaming_state(self) -> tuple[StreamingCorpus, dict[str, IndexDelta]]:
        """The live streaming state, or a freshly built (uncommitted) one —
        callers assign it back only after the mutation succeeded, so a
        rejected op leaves the engine on the frozen bulk path."""
        if self._view is not None:
            return self._view, self._deltas
        view = StreamingCorpus(self._bulk)
        return view, {key: IndexDelta(index, view)
                      for key, index in (("e", self.index_e),
                                         ("a", self.index_a))
                      if index is not None}

    def insert(self, points: np.ndarray,
               keywords: Sequence[Sequence[int]],
               attrs: dict | None = None, tenant=None) -> np.ndarray:
        """Absorb a batch of tagged points; returns their external ids.

        The batch is visible to every query issued after this call returns
        (absorbed atomically: a rejected batch changes nothing). Its rows
        are uploaded once, into the resident corpus on the device, where K5
        bins them at every scale (one launch per scale for both indices);
        the bulk index is untouched until compaction folds the delta in.

        ``attrs``/``tenant`` carry the batch's attribute columns and tenant
        (a name, an id, or one per point): a corpus built with attributes
        (or tenants) requires them on every insert, and a corpus without
        rejects them. ``keywords`` are *global* dictionary ids here; a
        tenant's local ids resolve through ``dataset.tenants.resolve``."""
        view, deltas = self._streaming_state()
        # validates keywords and the attribute/tenant schema before any
        # mutation
        ids = view.absorb(points, keywords, attrs=attrs, tenant=tenant)
        self.backend.attach(view.points, self._corpus_token)
        rows_dev = self.backend._points_dev[view.n - len(ids):]
        absorb_into(deltas.values(), view.points[ids], rows_dev)
        self._view, self._deltas = view, deltas
        ext = np.arange(self._next_ext, self._next_ext + len(ids),
                        dtype=np.int64)
        self._next_ext += len(ids)
        self._ext_append(ext)
        self.ingest.inserts += 1
        self.ingest.points_inserted += len(ids)
        # Durability point: the op is in memory; make it survive process
        # death *before* anything downstream (auto-compaction, the ack) runs.
        self._wal_append({
            "op": "insert",
            "points": walmod.encode_array(
                np.ascontiguousarray(points, np.float32)),
            "keywords": [[int(v) for v in ks] for ks in keywords],
            "attrs": ({name: walmod.encode_array(np.asarray(col))
                       for name, col in attrs.items()}
                      if attrs is not None else None),
            "tenant": (walmod.encode_array(tenant)
                       if isinstance(tenant, np.ndarray) else tenant),
            "first_ext": int(ext[0]) if len(ext) else int(self._next_ext),
            "count": len(ext),
        })
        self._maybe_compact()
        return ext

    def delete(self, external_ids: Sequence[int]) -> int:
        """Tombstone points by external id; returns the number deleted.
        Unknown, duplicate, or already-deleted ids raise without applying
        anything (the caller's view of the corpus is stale)."""
        ext = np.asarray(list(external_ids), dtype=np.int64)
        if not len(ext):
            return 0
        if len(np.unique(ext)) != len(ext):
            raise KeyError(f"duplicate ids in delete batch: {ext.tolist()}")
        internal = np.searchsorted(self._ext_of, ext)
        bad = (internal >= len(self._ext_of)) | (self._ext_of[np.minimum(
            internal, len(self._ext_of) - 1)] != ext)
        if bad.any():
            raise KeyError(f"unknown external ids: {ext[bad].tolist()}")
        view, deltas = self._streaming_state()
        dead = view.tombstoned(internal)
        if dead.any():
            raise KeyError(f"already deleted: {ext[dead].tolist()}")
        retire_from(deltas.values(), internal, self.backend._points_dev)
        view.delete(internal)
        self._view, self._deltas = view, deltas
        self.ingest.deletes += 1
        self.ingest.points_deleted += len(ext)
        self._wal_append({"op": "delete", "ids": [int(i) for i in ext]})
        self._maybe_compact()
        return len(ext)

    def compact_prepare(self) -> PreparedCompaction | None:
        """The O(N) half of :meth:`compact`: folds bulk ∪ delta into a fresh
        frozen dataset, gathers its rows on the device from the resident
        corpus, and builds the new indices there with the constructor's
        build params. Reads (never mutates) the live streaming view; the
        swap is :meth:`compact_commit`. The caller must hold ingest still
        between the two (commit verifies). Returns None when nothing is
        dirty."""
        if not self._streaming_dirty():
            return None
        view = self._view
        live = view.live_internal_ids()
        if not len(live):
            # An all-deleted corpus has no projection span to rebuild from;
            # keep serving from tombstones until something is inserted.
            raise ValueError("compact: corpus would be empty — insert points "
                             "before compacting away the last live one")
        version = (view.n, view.n_tombstones)
        bulk = view.compacted_dataset()
        # Mid-rebuild fault point: the compacted dataset exists, the new
        # indices do not — a crash here leaves the old generation intact.
        self._faults.check("compact")
        points_dev = self.backend._points_dev.index_select(
            0, torch.from_numpy(live).to(self.device))
        stats = BuildStats()
        index_e, index_a = build_indices(
            bulk, points_dev, stats=stats,
            build_exact=self.index_e is not None,
            build_approx=self.index_a is not None, **self._build_params)
        return PreparedCompaction(
            version=version, bulk=bulk, points_dev=points_dev,
            index_e=index_e, index_a=index_a, live=live,
            ext=np.ascontiguousarray(self._ext_of[live]), build_stats=stats)

    def compact_commit(self, prep: PreparedCompaction | None) -> bool:
        """Atomically swap a prepared compaction in: pointer swaps, the
        prepared rows become the resident corpus, and the generation bump
        scopes the backend caches. Raises :class:`StaleCompactionError` when
        the streaming state moved since prepare."""
        if prep is None:
            return False
        if self._view is None or \
                (self._view.n, self._view.n_tombstones) != prep.version:
            raise StaleCompactionError(
                f"streaming state moved since prepare (prepared @ "
                f"rows,tombstones={prep.version}, live="
                f"{(self._view.n, self._view.n_tombstones) if self._view is not None else None})")
        self._bulk = prep.bulk
        self.index_e, self.index_a = prep.index_e, prep.index_a
        self.build_stats = prep.build_stats
        self._ext_buf = prep.ext
        self._ext_len = len(prep.live)
        # The map is identity iff no id was ever retired: ext values are
        # strictly increasing in [0, _next_ext), so full size == identity
        # (a compaction that trimmed only trailing ids still needs the map:
        # the next insert gets external id _next_ext).
        self._identity_ids = self._ext_len == self._next_ext
        self._view = None
        self._deltas = {}
        self.corpus_generation += 1
        self._corpus_token = next(_CORPUS_TOKENS)
        self.backend.attach(prep.bulk.points, self._corpus_token,
                            points_dev=prep.points_dev)
        self.ingest.compactions += 1
        self.ingest.generation = self.corpus_generation
        self._wal_append({"op": "compact",
                          "generation": self.corpus_generation})
        return True

    def compact(self) -> bool:
        """Fold the delta into a fresh immutable bulk index (atomic swap):
        rebuild over the live points in external-id order, remap internal
        ids, bump ``corpus_generation`` (invalidating backend caches), reset
        the delta. No-op (returns False) when nothing is dirty."""
        return self.compact_commit(self.compact_prepare())

    def _maybe_compact(self) -> None:
        if not self.auto_compact or self._view is None or self._replaying:
            # During WAL replay the logged compact records drive compaction:
            # the cadence already fired once, at its logged position.
            return
        if self._view.n_tombstones >= self._view.n:
            # Everything is dead: nothing to rebuild from. The delete that
            # got us here already succeeded — stay on tombstones until an
            # insert brings the corpus back (explicit compact() still raises).
            return
        churn = self._view.n_delta + self._view.n_tombstones
        if churn >= max(self.compact_min, self.compact_ratio * self._bulk.n):
            self.compact()

    def _externalize(self, cands: list[Candidate]) -> list[Candidate]:
        """Map internal candidate ids to stable external ids (identity until
        a compaction leaves holes in the id space)."""
        if self._identity_ids:
            return cands
        return [dataclasses.replace(
                    c, ids=tuple(int(self._ext_of[i]) for i in c.ids))
                for c in cands]

    def _record_ingest(self, stats: PipelineStats) -> None:
        stats.corpus_generation = self.corpus_generation
        stats.delta_points = self.delta_points
        stats.tombstones = self.tombstone_count
        stats.compactions = self.ingest.compactions

    # ------------------------------------------------------------ durability
    def _wal_append(self, record: dict) -> None:
        if self._wal is None or self._replaying:
            return
        # Inside an ingest_group() the fsync is deferred to the group barrier
        # (one fsync per batch window); the ack ordering contract moves with
        # it — callers must not ack grouped ops until the group exits.
        self._wal.append(record, sync=self._wal_group == 0)
        self.ingest.wal_appends += 1

    @contextlib.contextmanager
    def ingest_group(self):
        """Group-commit scope: WAL appends inside the block defer their fsync
        to one barrier at exit (``WriteAheadLog.sync``), so a run of ingest
        ops acknowledged together pays a single durability barrier. Every
        record in the group is durable before the ``with`` block returns, so
        a caller that acks only after the block never acks a volatile write.
        Nests (only the outermost exit issues the barrier); on an engine
        without a WAL it does nothing."""
        self._wal_group += 1
        try:
            yield self
        finally:
            self._wal_group -= 1
            if self._wal_group == 0 and self._wal is not None \
                    and not self._replaying:
                # InjectedCrash from the wal_ack fault point propagates from
                # here — after the fsync, before any caller could ack.
                self._wal.sync()

    def _engine_meta(self) -> dict:
        return {
            "next_ext": int(self._next_ext),
            "identity_ids": bool(self._identity_ids),
            "corpus_generation": int(self.corpus_generation),
            "compact_ratio": self.compact_ratio,
            "compact_min": self.compact_min,
            "auto_compact": self.auto_compact,
            "build_exact": self.index_e is not None,
            "build_approx": self.index_a is not None,
            "ingest": self.ingest.as_dict(),
        }

    def attach_wal(self, root: str, faults: FaultPlan | None = None) -> None:
        """Make the engine durable under ``root`` (see ``serve.wal``).

        Writes the genesis snapshot (epoch 0: the current frozen state, so
        recovery always has a base corpus) and opens the WAL segment; from
        here every insert/delete/compact is fsync'd before its ack. A dirty
        engine compacts first — a snapshot is a clean generation boundary."""
        if self._wal is not None:
            raise RuntimeError(f"WAL already attached at {self._wal_root}")
        if faults is not None:
            self._faults = faults
        if self._streaming_dirty():
            self.compact()
        os.makedirs(root, exist_ok=True)
        self._wal_root = root
        self._wal_epoch = 0
        self._write_snapshot(0)
        walmod.write_manifest(root, 0)
        self._wal = walmod.WriteAheadLog(walmod.wal_path(root, 0),
                                         faults=self._faults)

    def _write_snapshot(self, epoch: int) -> None:
        walmod.save_snapshot(
            walmod.snap_dir(self._wal_root, epoch),
            dataset=self._bulk, index_e=self.index_e, index_a=self.index_a,
            build_params=self._build_params,
            engine_meta={**self._engine_meta(),
                         "ext": walmod.encode_array(
                             np.ascontiguousarray(self._ext_of))})

    def snapshot(self) -> str:
        """Roll the log: fold the delta (if dirty), persist the full engine
        state as the next epoch's snapshot, and start an empty WAL segment.
        After this, recovery replays nothing older — the ack horizon moves
        from "snapshot + log suffix" to "snapshot". Returns the snapshot
        directory."""
        if self._wal is None:
            raise RuntimeError("snapshot() requires an attached WAL "
                               "(attach_wal first)")
        if self._streaming_dirty():
            self.compact()
        epoch = self._wal_epoch + 1
        self._write_snapshot(epoch)
        self._wal.close()
        # Ordering: the new (empty) segment must exist before the manifest
        # names its epoch — recovery reads the manifest first.
        new_wal = walmod.WriteAheadLog(walmod.wal_path(self._wal_root, epoch),
                                       faults=self._faults)
        walmod.write_manifest(self._wal_root, epoch)
        self._wal = new_wal
        self._wal_epoch = epoch
        self.ingest.snapshots += 1
        walmod.gc_epochs(self._wal_root, epoch)
        return walmod.snap_dir(self._wal_root, epoch)

    def _replay_record(self, rec: dict) -> None:
        """Re-apply one logged op through the live entry points (inserts
        bin through K5 and join the resident corpus, as live ones do)."""
        op = rec["op"]
        if op == "insert":
            attrs = rec["attrs"]
            if attrs is not None:
                attrs = {name: walmod.decode_array(col)
                         for name, col in attrs.items()}
            tenant = rec["tenant"]
            if isinstance(tenant, dict) and "__nd__" in tenant:
                tenant = walmod.decode_array(tenant)
            ext = self.insert(walmod.decode_array(rec["points"]),
                              rec["keywords"], attrs=attrs, tenant=tenant)
            if len(ext) != rec["count"] or \
                    (len(ext) and int(ext[0]) != rec["first_ext"]):
                raise IOError(
                    f"WAL replay diverged: insert assigned ids "
                    f"{int(ext[0]) if len(ext) else None}+{len(ext)}, log "
                    f"recorded {rec['first_ext']}+{rec['count']}")
        elif op == "delete":
            self.delete(rec["ids"])
        elif op == "compact":
            self.compact()
            if self.corpus_generation != rec["generation"]:
                raise IOError(
                    f"WAL replay diverged: compact reached generation "
                    f"{self.corpus_generation}, log recorded "
                    f"{rec['generation']}")
        else:
            raise IOError(f"unknown WAL record op {op!r}")

    @classmethod
    def recover(cls, root: str, *, device: str | torch.device | None = None,
                mesh=None, verify: bool = True,
                faults: FaultPlan | None = None) -> "NKSEngine":
        """Rebuild an engine on ``device`` (the card unless the caller asks
        for another; with ``mesh``, the plane's first device) from its WAL
        root: latest snapshot + log replay.

        The recovered engine answers **bit-identically** to an uninterrupted
        engine that executed the same acknowledged op sequence: the snapshot
        stores the built index structures verbatim, and replay re-runs the
        deterministic ingest path (K5 binning, the resident corpus append),
        including logged compactions at their logged positions. A torn tail
        is truncated before the segment reopens. The WAL stays attached —
        the engine keeps appending to the recovered segment."""
        man = walmod.read_manifest(root)
        epoch = int(man["epoch"])
        snap = walmod.load_snapshot(walmod.snap_dir(root, epoch),
                                    verify=verify)
        bp, em = snap["build_params"], snap["engine"]
        engine = cls(snap["dataset"],
                     m=bp["m"], n_scales=bp["n_scales"], seed=bp["seed"],
                     w0=bp["w0"], n_buckets=bp["n_buckets"],
                     synopsis=bp.get("synopsis", False),
                     build_exact=em["build_exact"],
                     build_approx=em["build_approx"], device=device,
                     mesh=mesh, compact_ratio=em["compact_ratio"],
                     compact_min=em["compact_min"],
                     auto_compact=em["auto_compact"], faults=faults,
                     _indices=(snap["index_e"], snap["index_a"]))
        engine._ext_buf = walmod.decode_array(em["ext"])
        engine._ext_len = len(engine._ext_buf)
        engine._next_ext = em["next_ext"]
        engine._identity_ids = em["identity_ids"]
        engine.corpus_generation = em["corpus_generation"]
        for field, value in em["ingest"].items():
            setattr(engine.ingest, field, value)
        engine.ingest.replayed_ops = 0
        engine._wal_root = root
        engine._wal_epoch = epoch
        wal_file = walmod.wal_path(root, epoch)
        rstats = walmod.WalStats()
        engine._replaying = True
        try:
            for rec in walmod.WriteAheadLog.replay(wal_file, rstats):
                engine._replay_record(rec)
                engine.ingest.replayed_ops += 1
        finally:
            engine._replaying = False
        if rstats.torn_tail:
            # A torn tail is an unacknowledged op and replay skipped it, but
            # its bytes are still on disk: appending after them would plant a
            # CRC mismatch mid-file, and the *next* recovery would raise
            # TornRecordError — losing every write acknowledged after this
            # recovery. Truncate to the last whole record before reopening.
            with open(wal_file, "rb+") as f:
                f.truncate(rstats.valid_bytes)
                f.flush()
                os.fsync(f.fileno())
        engine._wal = walmod.WriteAheadLog(wal_file, faults=engine._faults)
        engine._wal.stats.replayed = rstats.replayed
        engine._wal.stats.torn_tail = rstats.torn_tail
        return engine

    @classmethod
    def from_store(cls, directory: str, *,
                   device: str | torch.device | None = None, mesh=None,
                   mmap: bool = True, verify: bool = False,
                   resident_budget_bytes: int | None = None,
                   **kw) -> "NKSEngine":
        """Open an engine on ``device`` (the card unless the caller asks for
        another) over a bulk store (``core.store``), without a rebuild.

        With ``mmap=True`` (the default) the keyword CSRs and the bucket
        tables stay on disk as memory-mapped leaves for the planner (the
        per-bucket synopses load resident); the points are read off their
        mapped leaf once, into the card, by ``TorchBackend.attach`` — a
        corpus that does not fit there raises. ``resident_budget_bytes``
        bounds the backend's tile and table cache. Answers are bit-identical
        to an engine built with the store's recorded ``build_params``, and
        streaming absorbs and compactions continue the same sequence.
        ``mesh`` attaches a device plane as the constructor does; ``kw``
        goes to the constructor."""
        st = storemod.load_store(directory, mmap=mmap, verify=verify)
        bp = st["build_params"] or {}
        return cls(st["dataset"],
                   m=bp.get("m", 2), n_scales=bp.get("n_scales", 5),
                   seed=bp.get("seed", 0), w0=bp.get("w0"),
                   n_buckets=bp.get("n_buckets"),
                   synopsis=bp.get("synopsis", False),
                   build_exact=st["index_e"] is not None,
                   build_approx=st["index_a"] is not None,
                   device=device, mesh=mesh,
                   resident_budget_bytes=resident_budget_bytes,
                   _indices=(st["index_e"], st["index_a"]), **kw)

    @property
    def wal_stats(self) -> walmod.WalStats | None:
        return self._wal.stats if self._wal is not None else None

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()

    @classmethod
    def from_arrays(cls, points: np.ndarray, kw_offsets: np.ndarray,
                    kw_values: np.ndarray, n_keywords: int, *,
                    index_e: dict, index_a: dict,
                    device: str | torch.device | None = None) -> "NKSEngine":
        """An engine over a corpus and indices given as plain arrays (see
        :mod:`repro_torch.core.carry`): ``index_e``/``index_a`` are the
        keyword arguments of :func:`carry.index_from_arrays`."""
        dataset = carry.dataset_from_arrays(points, kw_offsets, kw_values,
                                            n_keywords)
        return cls(dataset, device=device,
                   _indices=(carry.index_from_arrays(**index_e),
                             carry.index_from_arrays(**index_a)))

    @classmethod
    def ingest_embeddings(cls, api, params, batches: Sequence[dict],
                          keywords: Sequence[Sequence[int]], *,
                          device: str | torch.device | None = None,
                          **kw) -> "NKSEngine":
        """Build the corpus from model embeddings: each batch (``"tokens"``
        (B, S) and an optional ``"mask"``) is embedded by ``api.embed`` on the
        engine's device, where ``params`` must live; the (B, d_model) rows,
        as float32, are the points, tagged with ``keywords`` in order.
        ``kw`` goes to the constructor."""
        device = resolve_device(device)
        embs = []
        with torch.inference_mode():
            for batch in batches:
                on_dev = {name: torch.as_tensor(t, device=device)
                          for name, t in batch.items()}
                embs.append(api.embed(params, on_dev).float().cpu().numpy())
        points = np.concatenate(embs, axis=0)
        return cls(make_dataset(points, keywords), device=device, **kw)

    def query(self, keywords: Sequence[int], k: int = 1,
              tier: str = "approx", filter=None,
              semantics=None) -> QueryResult:
        """One query through the per-query search (float64 on the host), or
        one anchor-star dispatch on the engine's device (``tier="device"``).
        A filtered exact or approx query runs the batched pipeline (a batch
        of one), which threads the eligibility mask through every stage, and
        so does a query under non-trivial ``semantics`` (see
        :meth:`query_batch`); the device tier refuses those."""
        t0 = time.perf_counter()
        self._validate_queries([keywords])
        flt = Filter.coerce(filter)
        sem = QuerySemantics.coerce(semantics)
        flex = sem is not None and not sem.trivial_for(
            sorted(set(int(v) for v in keywords)))
        if tier == "device" and flex:
            raise ValueError(
                "device tier does not support flexible semantics; "
                "use tier='exact' or 'approx'")
        if tier in ("exact", "approx") and (self._streaming_dirty()
                                            or flt is not None or flex):
            # The per-query searches walk a frozen index; with a live delta
            # the batched pipeline (a batch of one reproduces them exactly)
            # is the delta-aware path — and the filtered path, and the
            # flexible one (m-of-k expansion, weights and scored queues
            # live in ``_batch_search``).
            res = self.query_batch([keywords], k=k, tier=tier,
                                   backend="numpy", filter=flt,
                                   semantics=sem)[0]
            return dataclasses.replace(res, latency_s=time.perf_counter() - t0)
        if tier == "exact":
            pq = promish_e.search(self.dataset, self._index(tier), keywords,
                                  k=k)
        elif tier == "approx":
            pq = promish_a.search(self.dataset, self._index(tier), keywords,
                                  k=k)
        elif tier == "device":
            resolved = self._resolve_namespace([keywords], flt)[0]
            eligible = self._eligible(flt)
            return QueryResult(
                list(keywords),
                self._externalize(self._device_topk(resolved, k,
                                                    eligible=eligible)),
                time.perf_counter() - t0, tier)
        else:
            raise ValueError(tier)
        return QueryResult(list(keywords), self._externalize(pq.items),
                           time.perf_counter() - t0, tier)

    def _index(self, tier: str) -> PromishIndex:
        index = self.index_e if tier == "exact" else self.index_a
        if index is None:
            raise ValueError(f"engine built without the {tier!r} index")
        return index

    def _resolve_namespace(self, queries: Sequence[Sequence[int]],
                           flt: Filter | None) -> list[list[int]]:
        """Per-tenant dictionary resolution, run before planning: a
        tenant-scoped query on a namespaced corpus speaks *tenant-local*
        keyword ids, mapped into the tenant's global dictionary slots here
        (out-of-range local ids raise — the tenant cannot name, let alone
        reach, another tenant's keywords)."""
        if flt is None or flt.tenant is None or self.dataset.tenants is None:
            return [list(q) for q in queries]
        ns = self.dataset.tenants
        return [ns.resolve(flt.tenant, q) for q in queries]

    def _eligible(self, flt: Filter | None) -> np.ndarray | None:
        """The batch's (N,) point-eligibility mask, evaluated once and ANDed
        with the tombstones (eligibility implies liveness); None unfiltered."""
        if flt is None:
            return None
        eligible = flt.evaluate(self.dataset)
        if self._view is not None:
            self._view.mask_tombstones(eligible)
        return eligible

    def _device_topk(self, keywords: list[int], k: int,
                     stats: PipelineStats | None = None,
                     eligible: np.ndarray | None = None) -> list[Candidate]:
        """One anchor-star dispatch, the device tier's unit of work. The
        anchors are the points of ``keywords[0]`` as given. Only the (q, R)
        ids and mask cross to the device, where the groups are gathered from
        the resident corpus; diameters and ids come back in one readback.
        On a plane (R rounded to a shard multiple) the groups go to every
        shard and each scores its slice of the anchors
        (``DevicePlane.nks_topk``). Candidates are the anchor stars of
        finite diameter, ascending. ``eligible`` (a filtered query's point
        mask) restricts the packed groups; a group the filter empties means
        no feasible candidate, so the dispatch is skipped."""
        if eligible is not None and any(
                not eligible[self.dataset.points_with(v)].any()
                for v in keywords):
            if stats is not None:
                t = time.perf_counter()
                stats.query_spans.append((t, t, t))
            return []
        t0 = time.perf_counter()
        dev = self.device
        plane = self.plane
        pg = (pack_group_ids if plane is None else plane.pack_group_ids)(
            self.dataset, keywords, eligible=eligible)
        mask = torch.from_numpy(pg.mask).to(dev)
        ids = torch.from_numpy(pg.ids).to(dev)
        groups = gather_groups(self.backend._points_dev, mask, ids)
        t1 = time.perf_counter()
        if plane is None:
            diams, cids = nks_anchor_topk(groups, mask, ids, k)
        else:
            diams, cids = plane.nks_topk(groups, mask, ids, k)
        diams, cids = diams.cpu().numpy(), cids.cpu().numpy()
        t2 = time.perf_counter()
        if stats is not None:
            if plane is None:
                stats.shard_dispatches[0] += 1
            else:
                stats.sharded_dispatches += 1
                stats.t_collective_s += t2 - t1
                for i in range(plane.n_shards):
                    stats.shard_dispatches[i] += 1
            stats.t_pack_s += t1 - t0
            stats.t_dispatch_s += t2 - t1
            stats.query_spans.append((t0, t1, t2))
            stats.h2d_bytes += pg.mask.nbytes + pg.ids.nbytes
            stats.d2h_bytes += diams.nbytes + cids.nbytes
        return [Candidate(tuple(sorted(set(int(x) for x in row))), float(dm))
                for dm, row in zip(diams, cids) if np.isfinite(dm)]

    # ------------------------------------------------------------- batched path
    def _validate_queries(self, queries: Sequence[Sequence[int]]
                          ) -> list[list[int]]:
        out = []
        for q in queries:
            q = sorted(set(int(v) for v in q))
            if any(v < 0 or v >= self.dataset.n_keywords for v in q):
                raise ValueError("query keyword outside dictionary")
            out.append(q)
        return out

    def _run_tasks(self, tasks: list[plan.SubsetTask],
                   queries: list[list[int]], pqs: list[TopK],
                   backend: DistanceBackend, stats: PipelineStats,
                   ctx: plan.BatchPlanContext, timers: dict,
                   eligible: np.ndarray | None = None,
                   weights: list[np.ndarray | None] | None = None
                   ) -> tuple[int, int, int]:
        """Distance stage + enumeration stage for one batch of subset tasks.
        ``eligible`` is the batch's predicate mask: keyword groups restrict
        to eligible rows (a task whose filtered groups lose a keyword is
        dropped before any pack), and the backend scopes its joins to it.
        ``weights`` maps each task's ``qidx`` to its query's (N,)
        keyword-weight vector (or None, unweighted): the dispatch stages are
        weight-blind (the geometric join is a superset of the weighted one),
        only host settlement consumes it.
        Returns (tasks_searched, dispatches_issued, join_pairs)."""
        t0 = time.perf_counter()
        prepared = []
        for t in tasks:
            gl = local_groups(t.f_ids, queries[t.qidx], self.dataset,
                              eligible=eligible, ctx=ctx)
            if gl is not None:
                prepared.append((t, gl))
        stats.t_plan_s += time.perf_counter() - t0
        if not prepared:
            return 0, 0, 0
        d0 = backend.stats.dispatches
        # Radius substitution: when the source bucket's diameter bound
        # already beats the query's live r_k, every pair in the subset joins
        # — the backend's infinite-radius path synthesizes the identical
        # all-ones join without touching the point rows. Result- and
        # join_count-preserving for both backends.
        radii = []
        for t, _ in prepared:
            r = pqs[t.qidx].kth_diameter()
            if np.isfinite(r) and t.diam_ub <= r:
                r = float("inf")
                stats.buckets_pruned_radius += 1
            radii.append(r)
        blocks = backend.self_join_blocks(
            self.dataset.points,
            [t.f_ids for t, _ in prepared], radii,
            keys=[t.f_ids.tobytes() for t, _ in prepared],
            generation=self._corpus_token, eligible=eligible)
        t1 = time.perf_counter()
        join_pairs = 0
        for (t, gl), db in zip(prepared, blocks):
            join_pairs += db.join_count
            stats.candidates_explored += enumerate_with_block(
                t.f_ids, gl, queries[t.qidx], self.dataset, pqs[t.qidx], db,
                timers=timers,
                weights=None if weights is None else weights[t.qidx])
        stats.t_enumerate_s += time.perf_counter() - t1
        return len(prepared), backend.stats.dispatches - d0, join_pairs

    def _batch_search(self, queries: list[list[int]], k: int, tier: str,
                      backend: DistanceBackend, flt: Filter | None = None,
                      sem: QuerySemantics | None = None
                      ) -> tuple[list[TopK], PipelineStats]:
        exact = tier == "exact"
        index = self._index(tier)
        stats = PipelineStats(batch_size=len(queries), tier=tier,
                              backend=backend.name)
        b0 = dataclasses.replace(backend.stats)
        b0_bins = dict(backend.stats.bin_points)
        # dataclasses.replace shares the list fields: snapshot them by value
        b0_shards = [list(getattr(backend.stats, f)) for f in _SHARD_FIELDS]
        # Flexible semantics: each query's m-of-k subqueries run the
        # plan/dispatch/enumerate loop as independent *execution* entries
        # that share the original query's queue (and weight vector) — the
        # queue's id-set dedup resolves cross-subquery duplicates, since a
        # candidate's cost and coverage depend only on (ids, Q). A classic
        # batch (``sem`` None) expands to itself: one execution entry per
        # query, plain TopK queues, no weights.
        if sem is None:
            pqs = [TopK(k) for _ in queries]
            exec_queries: list[list[int]] = list(queries)
            exec_orig = list(range(len(queries)))
            exec_pqs, exec_weights = pqs, None
        else:
            pqs = [sem.make_pq(self.dataset, q, k) for q in queries]
            wvecs = [sem.weight_vector(self.dataset, q) for q in queries]
            exec_queries, exec_orig = [], []
            for o, q in enumerate(queries):
                for sub in sem.expand_subqueries(q):
                    exec_queries.append(sub)
                    exec_orig.append(o)
            exec_pqs = [pqs[o] for o in exec_orig]
            exec_weights = [wvecs[o] for o in exec_orig]
        stats.subqueries = len(exec_queries)
        t0 = time.perf_counter()
        # One BatchPlanContext per batch: keyword masks and covering-bucket
        # selections are memoized for the batch's lifetime.
        pctx = plan.BatchPlanContext(self.dataset)
        bitsets = [pctx.query_bitset(q) for q in exec_queries]
        # Streaming: plan over bulk ∪ delta, tombstones cleared from every
        # bitset (the subsets the backend packs and the enumeration walks
        # then contain live points only).
        delta = None
        if self._streaming_dirty():
            delta = self._deltas["e" if exact else "a"]
            for bs in bitsets:
                self._view.mask_tombstones(bs)
        # Filtered batch: the predicate/tenant mask, evaluated once here;
        # plan pruning, group restriction and the device join all consume
        # this same array.
        eligible = self._eligible(flt)
        if eligible is not None:
            stats.eligible_points = int(eligible.sum())
            live = self.dataset.n - self.tombstone_count
            stats.filter_selectivity = round(
                stats.eligible_points / live, 6) if live else 0.0
        # Zone-map pruning: with bucket synopses and a filter in play, the
        # planner skips buckets whose zone maps are provably disjoint from
        # the predicate before their member lists are read. Results are
        # bit-identical with the pruner on or off.
        zone = None
        if eligible is not None and index.structures[0].synopsis is not None:
            zp = storemod.ZoneMapPruner(flt, self.dataset)
            zone = zp if zp.active else None
        stats.t_plan_s += time.perf_counter() - t0
        explored = {i: set() for i in range(len(exec_queries))} if exact \
            else None
        active = list(range(len(exec_queries)))
        timers = {"rescore_s": 0.0}

        for s in range(index.n_scales):
            if not active:
                break
            sstats = ScaleStats(scale=s, active_queries=len(active))
            pstats = plan.PlanStats()
            t0 = time.perf_counter()
            tasks = plan.plan_scale(index, s, exec_queries, bitsets, active,
                                    explored, pstats, ctx=pctx, delta=delta,
                                    eligible=eligible, zone=zone)
            stats.t_plan_s += time.perf_counter() - t0
            sstats.buckets_selected = pstats.buckets_selected
            sstats.duplicate_subsets = pstats.duplicate_subsets
            sstats.filtered_subsets = pstats.filtered_subsets
            stats.filtered_subsets += pstats.filtered_subsets
            sstats.buckets_pruned_zonemap = pstats.buckets_pruned_zonemap
            stats.buckets_pruned_zonemap += pstats.buckets_pruned_zonemap
            sstats.tasks_planned = len(tasks)
            pr0 = stats.buckets_pruned_radius
            searched, dispatches, pairs = self._run_tasks(
                tasks, exec_queries, exec_pqs, backend, stats, pctx, timers,
                eligible, exec_weights)
            sstats.tasks_searched = searched
            sstats.dispatches = dispatches
            sstats.join_pairs = pairs
            sstats.buckets_pruned_radius = stats.buckets_pruned_radius - pr0
            # Per-query termination, exactly as the per-query searches do it:
            # E: Lemma-2 radius test after the scale; A: first full PQ.
            # Termination is a property of the ORIGINAL query's shared queue,
            # so one decision per original deactivates all its subqueries.
            still = []
            done_orig: dict[int, bool] = {}
            for qidx in active:
                o = exec_orig[qidx]
                if o not in done_orig:
                    done_orig[o] = pqs[o].kth_diameter() \
                        <= index.w0 * (2.0 ** (s - 1)) if exact \
                        else pqs[o].full()
                    if done_orig[o]:
                        sstats.queries_finished += 1
                if not done_orig[o]:
                    still.append(qidx)
            active = still
            stats.scales.append(sstats)

        if active:
            stats.fallback_queries = len(active)
            tasks = plan.fallback_tasks(bitsets, active, eligible)
            _, stats.fallback_dispatches, _ = self._run_tasks(
                tasks, exec_queries, exec_pqs, backend, stats, pctx, timers,
                eligible, exec_weights)
        stats.t_rescore_s = timers["rescore_s"]
        for f in _DELTA_FIELDS:
            setattr(stats, f, getattr(backend.stats, f) - getattr(b0, f))
        for f, before in zip(_SHARD_FIELDS, b0_shards):
            getattr(stats, f).extend(
                v - (before[i] if i < len(before) else 0)
                for i, v in enumerate(getattr(backend.stats, f)))
        for edge, (pts, padded) in backend.stats.bin_points.items():
            before = b0_bins.get(edge, (0, 0))
            dp, dpad = pts - before[0], padded - before[1]
            if dp or dpad:
                stats.bin_occupancy[edge] = (dp, dpad)
        return pqs, stats

    def query_batch(self, queries: Sequence[Sequence[int]], k: int = 1,
                    tier: str = "approx",
                    backend: str | DistanceBackend = "torch",
                    filter=None, semantics=None) -> list[QueryResult]:
        """Answer a batch of queries through the staged pipeline.

        Bucket selection, Algorithm-2 dedup and device dispatch are amortised
        across the batch: with ``backend="torch"`` (the engine's own backend,
        on its device) each scale issues a few size-binned fused
        threshold-join dispatches covering all live subsets; ``"numpy"``
        loops float64 joins on the host; a :class:`DistanceBackend` instance
        is used as given. The ``device`` tier issues one anchor-star
        dispatch per query on the engine's device (``backend`` is not used).
        Per-result latency is the batch wall time divided by the batch size.
        Pipeline accounting lands in ``self.last_batch_stats``.

        ``filter`` (a :class:`~repro_torch.core.filters.Filter` or its JSON
        form) applies attribute predicates and tenant scoping to the whole
        batch: the mask is evaluated once, planning prunes fully-ineligible
        subsets, the device join is scoped to eligible points (no new D2H),
        and every candidate is drawn from eligible points only. On a
        namespaced multi-tenant corpus a tenant-scoped batch speaks
        tenant-local keyword ids; results echo them.

        ``semantics`` (a :class:`~repro_torch.core.semantics.QuerySemantics`
        or its JSON form ``{"m": ..., "weights": {...}, "score": ...,
        "alpha": ...}``) applies m-of-k partial coverage, per-keyword weights
        (tenant-local keys under a tenant filter) and scored ranking to the
        whole batch. Degenerate semantics (full coverage, unit weights, no
        scoring) are dropped before planning, so results stay bit-identical
        to a plain call; the device tier rejects non-trivial semantics."""
        flt = Filter.coerce(filter)
        sem = QuerySemantics.coerce(semantics)
        if sem is not None and tier == "device":
            if any(not sem.trivial_for(sorted(set(int(v) for v in q)))
                   for q in queries):
                raise ValueError(
                    "device tier does not support flexible semantics; "
                    "use tier='exact' or 'approx'")
            sem = None
        if tier == "device":
            t0 = time.perf_counter()
            self._validate_queries(queries)
            n_sh = 1 if self.plane is None else self.plane.n_shards
            stats = PipelineStats(
                batch_size=len(queries), tier=tier,
                backend="anchor" if self.plane is None else "device-plane",
                shard_dispatches=[0] * n_sh, t_call_start=t0)
            resolved = self._resolve_namespace(queries, flt)
            eligible = self._eligible(flt)
            if eligible is not None:
                stats.eligible_points = int(eligible.sum())
            out = [QueryResult(list(q), self._externalize(
                       self._device_topk(rq, k, stats, eligible)), 0.0, tier)
                   for q, rq in zip(queries, resolved)]
            per_q = (time.perf_counter() - t0) / max(len(queries), 1)
            self._record_ingest(stats)
            self.last_batch_stats = stats
            return [dataclasses.replace(r, latency_s=per_q) for r in out]
        if tier not in ("exact", "approx"):
            raise ValueError(tier)
        t0 = time.perf_counter()
        qlists = self._validate_queries(self._resolve_namespace(queries, flt))
        if sem is not None:
            if flt is not None and flt.tenant is not None \
                    and self.dataset.tenants is not None:
                # Weight keys speak the same tenant-local ids as the query
                # keywords — resolve them through the same namespace.
                ns, tenant = self.dataset.tenants, flt.tenant
                sem = sem.resolve_keywords(
                    lambda kw: ns.resolve(tenant, [kw])[0])
            # Degenerate semantics normalise away entirely: the classic
            # pipeline below is then byte-for-byte the plain one.
            if all(sem.trivial_for(q) for q in qlists):
                sem = None
        pqs, stats = self._batch_search(qlists, k, tier,
                                        self._resolve_backend(backend), flt,
                                        sem)
        stats.t_call_start = t0
        self._record_ingest(stats)
        self.last_batch_stats = stats
        per_q = (time.perf_counter() - t0) / max(len(qlists), 1)
        # results echo the caller's keyword lists verbatim (tenant-local on
        # a namespaced corpus)
        return [QueryResult(list(q), self._externalize(pq.items), per_q, tier)
                for q, pq in zip(queries, pqs)]

    def _resolve_backend(self, backend: str | DistanceBackend
                         ) -> DistanceBackend:
        """``"torch"``: the engine's own backend (corpus already on its
        device, cost model calibrated); ``"numpy"``: a fresh float64 host
        loop; an instance passes through."""
        if isinstance(backend, DistanceBackend):
            return backend
        if backend == "torch":
            return self.backend
        if backend == "numpy":
            return NumpyBackend()
        raise ValueError(f"unknown distance backend: {backend!r}")
