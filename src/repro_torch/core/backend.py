"""Distance backends for the subset-search pipeline.

The §V inner joins and Algorithm 4 predicates consume one *join structure*
per covering-bucket subset. This module routes that production:

  * :class:`NumpyBackend` — float64 on the control plane; distances are exact,
    so enumeration needs no slack and no rescoring. Emits dense distance
    blocks; the enumeration stage packs its own bitmask at the live r_k. One
    "dispatch" per subset (the per-query loop the paper measures).
  * :class:`TorchBackend` — keeps the corpus on the device, packs every
    subset of a size class into one dense (S, P, d) tile *on the device*
    (an ``index_select`` from the id lists), and issues **one** fused
    ``kernels.ops.pairwise_l2_join_batched_masked`` dispatch per tile, with
    per-subset pruning radii. What comes back to the host is the **packed
    adjacency bitmask** (S, P, ceil(P/32)) — a 32x smaller readback than the
    dense fp32 block. fp32 on the device is a *pruning filter*: the
    per-subset radius is widened by an absolute slack bounding fp32
    cancellation error, and the enumeration stage re-scores surviving tuples
    through the float64 path before they enter the queue
    (``subset_search.enumerate_with_block``). A coarse counts pass (the
    prune tier, bf16 by default or int8) can run ahead of the fp32 join,
    and a measured cost model sends bins too small for the device to the
    exact host path; every tier and route gives bitwise the same results.

The block contract (:class:`DistanceBlock`) carries either ``dist`` (dense
float64, numpy) or ``mask`` (packed uint32 at the dispatch-time pruning
radius), plus ``join_count`` — the kernel's inner-join cardinality, which the
enumeration stage uses to skip subsets whose join is empty before any host
work (the adaptive-radii feedback loop).

``TorchBackend`` keeps a byte-bounded LRU cache keyed on the Algorithm-2
subset hashes (the sorted-id bytes): whole packed tiles already on the
device, and host float64 distance tables of host-routed subsets —
steady-state repeated subsets skip gather and packing entirely.

A filtered call (``eligible``, a point mask) leaves tiles and cache keys
filter-independent: the mask reaches the card as packed eligibility words
that K1 folds into its mask and counts (and K2 into its coarse counts), so
the readback is the unfiltered dispatch's bytes. Where the eligible share of
a call's subset points is below ``elig_pack_threshold``, tiles instead pack
only the eligible rows (uncached), and each block carries its row map.
"""
from __future__ import annotations

import abc
import dataclasses
import time
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.device_plane import balance_order
from repro_torch.core.subset_search import (_sq_dists_f64, pack_join_mask,
                                            pairwise_l2_numpy)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import JOIN_SQUARE_TILE
from repro_torch.launch.mesh import resolve_device

_EPS32 = float(np.finfo(np.float32).eps)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class BackendStats:
    """Dispatch accounting for the pipeline stats (§VII-style instrumentation)."""

    dispatches: int = 0        # device/loop calls issued
    subsets: int = 0           # join blocks produced
    points_packed: int = 0     # total valid points shipped
    points_padded: int = 0     # pad waste (packed tile points - valid points)
    join_pairs: int = 0        # threshold-join survivors across all subsets
    t_pack_s: float = 0.0      # host time: gather + tile packing
    t_dispatch_s: float = 0.0  # device time: dispatch + D2H readback
    cache_hits: int = 0        # tile / host-table LRU hits, per subset
    cache_misses: int = 0
    cache_evictions: int = 0
    # Transfer accounting (device backend): host->device bytes shipped (id
    # lists, lengths, radii, packed eligibility words) and device->host bytes
    # read back (packed masks and join counts). The corpus itself moves
    # once, at attach. The filtered contract — eligibility folds into the
    # existing packed mask, adding no new D2H — is asserted on these.
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    # Join-block cells dispatched to the device: valid (sum of length^2) and
    # total (padded tile cells).
    valid_cells: int = 0
    total_cells: int = 0
    # Cascade / routing accounting: the coarse bf16 prune tier and the
    # cost-model host route. ``t_prune_s`` and ``t_host_s`` are *components*
    # of ``t_dispatch_s``. ``bin_points`` maps each size-class edge to
    # cumulative (valid, padded) point totals packed under it.
    prune_tier_dispatches: int = 0         # coarse counts passes issued
    cells_pruned: int = 0                  # fp32 tile cells skipped via prune
    t_prune_s: float = 0.0                 # wall inside coarse counts passes
    host_routed_dispatches: int = 0        # bins routed to the host path
    host_routed_subsets: int = 0           # subsets served by host routing
    t_host_s: float = 0.0                  # wall inside host-routed bins
    bin_points: dict = dataclasses.field(default_factory=dict)
    generation_purges: int = 0  # cache invalidations on corpus-generation bump
    # Filtered device dispatches by packing mode: eligibility words folded
    # into full-width tiles, or eligible rows packed densely.
    elig_fold_dispatches: int = 0
    elig_dense_dispatches: int = 0
    # Out-of-core accounting: bytes of point rows gathered on the host off a
    # memory-mapped store leaf (the cold tier). The torch backend's device
    # bins gather from the corpus resident on the card and count nothing;
    # its host-routed bins gather off the host array and count.
    cold_bytes_read: int = 0
    # Sharded-dispatch accounting (a DevicePlane routes the dispatch over
    # its shards; lists are indexed by shard position and sized on the
    # first device dispatch; a single-device dispatch lands on shard 0).
    sharded_dispatches: int = 0            # dispatches split over shards
    t_collective_s: float = 0.0            # wall of their fp32 join stage
    shard_dispatches: list = dataclasses.field(default_factory=list)
    shard_valid_cells: list = dataclasses.field(default_factory=list)
    shard_total_cells: list = dataclasses.field(default_factory=list)

    def ensure_shards(self, n: int) -> None:
        for lst in (self.shard_dispatches, self.shard_valid_cells,
                    self.shard_total_cells):
            lst.extend([0] * (n - len(lst)))


@dataclasses.dataclass(frozen=True)
class DistanceBlock:
    """One subset's join structure plus the contract needed to consume it.

    n          : number of valid points in the subset.
    dist       : (n, n) float64 pairwise L2 distances, or None for mask-only
                 device blocks.
    mask       : (n, ceil(n/32)) uint32 packed adjacency at the dispatch-time
                 pruning radius (bit j%32 of word j//32 set iff points i, j
                 join). None for dense blocks — and for device blocks whose
                 radius was infinite (every pair joins by construction; the
                 backend skips the dispatch and enumeration treats the
                 adjacency as all-ones) or that the prune tier proved empty.
    slack      : absolute distance error bound; dense approximate blocks are
                 pruned at r + slack (mask blocks bake it into the radius).
    rescore    : True when the block is approximate and accepted tuples must
                 be re-scored in float64 before entering the top-k queue.
    join_count : #{pairs joining at the pruning radius}, diagonal included —
                 ``join_count <= n`` proves the inner join empty, letting the
                 enumeration stage skip the subset (adaptive radii).
    n_eligible : number of subset points satisfying the query's predicate
                 mask, or None on an unfiltered call. When set, ``mask`` and
                 ``join_count`` cover eligible pairs only (the eligibility
                 fold), so the empty-join test becomes
                 ``join_count <= n_eligible``.
    rows       : eligible-dense packing (low-selectivity filtered dispatch):
                 sorted subset-local row positions actually packed into the
                 device tile. ``mask`` then covers only those rows — the
                 enumeration stage remaps its keyword groups into the packed
                 row space (``subset_search.enumerate_with_block``). None on
                 the standard full-subset pack.
    """

    n: int
    slack: float
    rescore: bool
    join_count: int
    dist: np.ndarray | None = None
    mask: np.ndarray | None = None
    n_eligible: int | None = None
    rows: np.ndarray | None = None


class DistanceBackend(abc.ABC):
    """Produces per-subset self-join blocks for the enumeration stage."""

    name: str = "abstract"

    def __init__(self) -> None:
        self.stats = BackendStats()

    def _note_cold_read(self, points: np.ndarray, n_rows: int) -> None:
        """Count a row gather against the cold tier when ``points`` is a
        memory-mapped store leaf (resident corpora cost nothing)."""
        if isinstance(points, np.memmap):
            self.stats.cold_bytes_read += \
                int(n_rows) * int(points.shape[1]) * points.itemsize

    @abc.abstractmethod
    def pairwise(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Dense (n, m) distance matrix for one pair of point sets."""

    @abc.abstractmethod
    def self_join_blocks(self, points: np.ndarray,
                         id_lists: Sequence[np.ndarray],
                         radii: Sequence[float],
                         keys: Sequence[bytes] | None = None,
                         generation: int | None = None,
                         eligible: np.ndarray | None = None
                         ) -> list[DistanceBlock]:
        """Self-join blocks for a batch of subsets at per-subset radii.

        ``points`` is the full corpus; each ``id_lists[i]`` selects one
        subset's rows (sorted unique ids). ``keys`` are the Algorithm-2
        subset hashes (sorted-id bytes) used as cache keys; pass None to
        bypass caching. ``generation`` is the caller's corpus-generation
        token: calls under the same token may share cache entries even if
        the ``points`` array object changed (streaming absorbs are
        append-only, so existing rows are immutable within a generation);
        a token change invalidates everything (compaction remapped ids).
        ``eligible`` (an (N,) bool point mask of a filtered query) scopes
        each block's counts, and a device block's mask, to eligible pairs
        (``DistanceBlock.n_eligible``)."""


@dataclasses.dataclass(frozen=True)
class DispatchCostModel:
    """Measured crossover model for dispatch routing (calibrated at warmup).

    Costs are a two-point linear fit per route: a fixed per-dispatch term
    plus a per-join-cell term, probed at the corpus dimensionality the
    backend actually serves (so no cross-d extrapolation). ``prune_cell_s``
    is the coarse counts-pass cost per cell; the prune tier only pays off
    where the coarse pass is measurably cheaper than the fp32 one, which
    ``prune_profitable`` reads from the card's own timings (off the card
    there is no such discount, so it is False).
    """

    platform: str
    d: int
    dev_fixed_s: float     # per-dispatch overhead (launch/readback)
    dev_cell_s: float      # fp32 masked join, per padded tile cell
    prune_cell_s: float    # coarse counts pass, per padded tile cell
    host_fixed_s: float    # numpy route, per subset
    host_cell_s: float     # numpy float64 join, per valid cell
    settle_cell_s: float = 0.0   # expected host f64 settlement of a device
    settle_fixed_s: float = 0.0  # block (unpack + table + expansion), per
    #                              valid cell / per subset

    def device_cost(self, padded_cells: int, valid_cells: int = 0,
                    n_subsets: int = 0) -> float:
        # A device block is not free after readback: subsets whose join is
        # non-empty settle on the host in float64 — work a host-routed block
        # (which ships exact distances) never repeats. The settle terms make
        # the two routes comparable as *end-to-end* costs.
        return self.dev_fixed_s + self.dev_cell_s * padded_cells \
            + self.settle_cell_s * valid_cells \
            + self.settle_fixed_s * n_subsets

    def host_cost(self, n_subsets: int, valid_cells: int) -> float:
        return self.host_fixed_s * n_subsets + self.host_cell_s * valid_cells

    @property
    def prune_profitable(self) -> bool:
        return (self.platform == "cuda"
                and self.prune_cell_s < 0.7 * self.dev_cell_s)


_COST_MODELS: dict[tuple, DispatchCostModel] = {}

# Per-cell slopes at or under this are no measurement: on the card a probe
# that gives one raises, off it the slope is clamped here.
CELL_FLOOR_S = 1e-13


def fit_cost_model(platform: str, d: int, cells: tuple[int, int],
                   dev_s: tuple[float, float], prune_s: tuple[float, float],
                   dispatch_s: float, host_cells: tuple[int, int],
                   host_s: tuple[float, float]) -> DispatchCostModel:
    """The two-point fit of :class:`DispatchCostModel` from probe timings.

    ``dev_s`` and ``prune_s`` are the masked join's and the coarse counts'
    times per call at ``cells`` padded cells (small, big), ``dispatch_s`` a
    whole masked dispatch at the small size with its readback, and
    ``host_s`` the host join at ``host_cells`` valid cells. The per-cell
    terms are the slopes between the two sizes, the fixed terms what the
    small probe leaves. On the card a device slope at or under
    :data:`CELL_FLOOR_S` raises; elsewhere it is clamped there."""
    span = cells[1] - cells[0]
    dev_slope = (dev_s[1] - dev_s[0]) / span
    prune_slope = (prune_s[1] - prune_s[0]) / span
    if platform == "cuda" and min(dev_slope, prune_slope) <= CELL_FLOOR_S:
        raise RuntimeError(
            f"cost-model probe measured no per-cell time on the card "
            f"(masked join {dev_slope:.3g} s, prune {prune_slope:.3g} s per "
            f"cell between {cells[0]} and {cells[1]} cells)")
    dev_cell = max(dev_slope, CELL_FLOOR_S)
    host_cell = max((host_s[1] - host_s[0]) / (host_cells[1] - host_cells[0]),
                    CELL_FLOOR_S)
    host_fixed = max(host_s[0] - host_cell * host_cells[0], 0.0)
    # Settlement share of a device block's end-to-end cost, as a fraction of
    # the equivalent host join. Without an accelerator the fp32 dispatch buys
    # no arithmetic advantage and every settled subset re-pays host-f64 work
    # on top of the dispatch, so the full host cost is charged. On the card
    # the prune tier removes most settlements and the dispatch term
    # collapses, so half is charged.
    settle_frac = 0.5 if platform == "cuda" else 1.0
    return DispatchCostModel(
        platform=platform, d=d,
        dev_fixed_s=max(dispatch_s - dev_cell * cells[0], 0.0),
        dev_cell_s=dev_cell, prune_cell_s=max(prune_slope, CELL_FLOOR_S),
        host_fixed_s=host_fixed, host_cell_s=host_cell,
        settle_cell_s=settle_frac * host_cell,
        settle_fixed_s=settle_frac * host_fixed)


def _device_s(f, reps: int = 10) -> float:
    """Device time per call of ``f`` by CUDA events over ``reps`` calls
    queued behind a spin of the card (``torch.cuda._sleep``), so that the
    calls run back to back at the card's pace and not the host's."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    f()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)     # tens of ms: the host queues meanwhile
    start.record()
    for _ in range(reps):
        f()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3 / reps


def calibrate_cost_model(d: int, device: torch.device,
                         prune_dtype: str = "bf16") -> DispatchCostModel:
    """Measure the device/host crossover at dimensionality ``d`` on
    ``device`` (memoized per process, device, d and ``prune_dtype``) and fit
    it (:func:`fit_cost_model`). The coarse-count probe runs the prune tier
    in ``prune_dtype`` (K2 for bf16, K2i for int8), the arm the backend will
    run. Each probe runs once to warm up (the first call on the card builds
    the kernels).

    On the card the device probes are batches of 8 subsets of 1024 and 2880
    points, the span of the largest tiles a 10^6-point corpus dispatches,
    timed on the card by CUDA events (:func:`_device_s`): a host clock around
    launch and readback puts its own jitter into a slope of microseconds.
    The whole small dispatch, readback included, is timed by the host clock
    for the fixed term. The plain versions on the CPU keep the small probes
    (32 and 256 points), all timed by the host clock, best of 5, with the
    readback."""
    device = resolve_device(device)
    key = (device.type, d, prune_dtype)
    model = _COST_MODELS.get(key)
    if model is not None:
        return model

    def best(f, reps=5):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            f()
            _sync(device)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    on_card = device.type == "cuda"
    n_sub = 8
    p_small, p_big = (1024, 2880) if on_card else (32, 256)
    gen = torch.Generator(device=device).manual_seed(0)
    x_s = torch.randn((n_sub, p_small, d), generator=gen, device=device)
    x_b = torch.randn((n_sub, p_big, d), generator=gen, device=device)
    l_s = torch.full((n_sub,), p_small, dtype=torch.int32, device=device)
    l_b = torch.full((n_sub,), p_big, dtype=torch.int32, device=device)
    r = torch.ones(n_sub, dtype=torch.float32, device=device)

    def dev(x, lens):
        return ops.pairwise_l2_join_batched_masked(x, lens, r)[1]

    def prune(x, lens):
        return ops.pairwise_l2_join_batched_counts(x, lens, r,
                                                   dtype=prune_dtype)

    for f in (dev, prune):
        f(x_s, l_s).cpu()
        f(x_b, l_b).cpu()
    if on_card:
        timed = _device_s
    else:
        def timed(f):
            return best(lambda: f().cpu())
    dev_s = (timed(lambda: dev(x_s, l_s)), timed(lambda: dev(x_b, l_b)))
    prune_s = (timed(lambda: prune(x_s, l_s)),
               timed(lambda: prune(x_b, l_b)))
    dispatch_s = best(lambda: dev(x_s, l_s).cpu())

    p_s = np.zeros((32, d))
    p_b = np.zeros((256, d))

    def host(pts):
        dist = pairwise_l2_numpy(pts, pts)
        (dist <= 1.0).sum()

    host(p_s)
    host_s = (best(lambda: host(p_s)), best(lambda: host(p_b)))
    model = fit_cost_model(
        device.type, d, (n_sub * p_small ** 2, n_sub * p_big ** 2), dev_s,
        prune_s, dispatch_s, (32 ** 2, 256 ** 2), host_s)
    _COST_MODELS[key] = model
    return model


def _dp_segment(values: np.ndarray, counts: np.ndarray,
                cap: int) -> np.ndarray:
    """Waste-minimizing size-class edges over a length histogram.

    ``values`` are distinct (rounded) subset lengths, ``counts`` their
    multiplicities. A segmentation assigns every value to the segment's top
    value (the bin edge each member pads to); its cost is total padded tile
    cells ``sum(edge^2 * members)`` plus ``lam`` per segment. The O(u^2) DP
    is exact for a given ``lam``; ``lam`` escalates x4 from one cell until
    the optimum uses at most ``cap`` segments, so edges are deterministic —
    no timing enters the choice."""
    u = len(values)
    if u <= cap:
        return values.copy()
    v2 = values.astype(np.float64) ** 2
    csum = np.concatenate([[0.0], np.cumsum(counts.astype(np.float64))])
    lam = 1.0
    while True:
        dp = np.zeros(u + 1)
        prev = np.zeros(u + 1, np.int64)
        nseg = np.zeros(u + 1, np.int64)
        for j in range(1, u + 1):
            cost = dp[:j] + v2[j - 1] * (csum[j] - csum[:j]) + lam
            bi = int(np.argmin(cost))
            dp[j], prev[j], nseg[j] = cost[bi], bi, nseg[bi] + 1
        if nseg[u] <= cap:
            edges = []
            j = u
            while j > 0:
                edges.append(int(values[j - 1]))
                j = prev[j]
            return np.asarray(sorted(edges), dtype=values.dtype)
        lam *= 4.0


class NumpyBackend(DistanceBackend):
    """float64 control-plane backend: exact, loops subset by subset."""

    name = "numpy"

    def pairwise(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        self.stats.dispatches += 1
        return pairwise_l2_numpy(a, b)

    def self_join_blocks(self, points: np.ndarray,
                         id_lists: Sequence[np.ndarray],
                         radii: Sequence[float],
                         keys: Sequence[bytes] | None = None,
                         generation: int | None = None,
                         eligible: np.ndarray | None = None
                         ) -> list[DistanceBlock]:
        t0 = time.perf_counter()
        out = []
        for ids, r in zip(id_lists, radii):
            pts = points[ids]
            self._note_cold_read(points, len(ids))
            dist = self.pairwise(pts, pts)
            n_elig = None
            if eligible is None:
                count = int((dist <= r).sum()) if np.isfinite(r) else dist.size
            else:
                # Mirror the device fold: counts cover eligible pairs only,
                # so the empty-join signal fires at the filtered selectivity.
                el = eligible[ids]
                n_elig = int(el.sum())
                pair_ok = el[:, None] & el[None, :]
                count = int(((dist <= r) & pair_ok).sum()) \
                    if np.isfinite(r) else int(pair_ok.sum())
            self.stats.subsets += 1
            self.stats.points_packed += len(ids)
            self.stats.join_pairs += count
            out.append(DistanceBlock(n=len(ids), dist=dist, slack=0.0,
                                     rescore=False, join_count=count,
                                     n_eligible=n_elig))
        self.stats.t_dispatch_s += time.perf_counter() - t0
        return out


def _to_uint32(words: torch.Tensor) -> np.ndarray:
    """int32 mask words on any device -> host uint32, bit for bit."""
    return words.cpu().numpy().view(np.uint32)


class TorchBackend(DistanceBackend):
    """Fused device backend: one batched threshold-join dispatch per bin.

    The corpus lives on ``device`` as an (n, d) fp32 tensor, uploaded once
    per corpus generation (:meth:`attach`); a streaming corpus's inserted
    rows are appended to it (capacity doubling), each uploaded once.
    Per-point float64 squared norms stay on the host for the slack. Subset
    counts and pad widths are rounded up (``quantum``) so repeated scales
    reuse tile shapes. A call whose packed (S, P, P) join block would exceed
    ``max_block_bytes`` is split into size-bounded chunks — still one
    dispatch per chunk.

    On a CUDA device the joins run the hand-written kernels; on the CPU
    (``device="cpu"``) their plain PyTorch versions. ``cache_bytes`` bounds
    the device-tile / host-table LRU.

    ``plane`` (a :class:`~repro_torch.core.device_plane.DevicePlane`) makes
    multi-device execution a property of this backend: a device-routed bin
    that packs at least one subset a shard is split over the plane's shards
    (subsets dealt to slabs in snake order of packed size), one kernel
    launch a slab, and the masks and counts gathered back; per-shard
    utilisation lands in the stats. Thinner bins, and bins whose shard-rounded tile would exceed
    ``max_block_bytes``, keep the single-device dispatch. Each subset's join
    is computed alone, so blocks are bit-identical across routes. The
    resident corpus lives on the plane's first device, which is the
    backend's ``device``.
    """

    name = "torch"

    def __init__(self, *, device: str | torch.device | None = None,
                 quantum: int = 8,
                 max_block_bytes: int = 256 << 20,
                 cache_bytes: int = 128 << 20,
                 bin_strategy: str = "quantile",
                 n_classes: int = 6,
                 route: str = "auto",
                 prune_tier: str = "auto",
                 prune_dtype: str = "bf16",
                 prune_eps: float = 0.05,
                 elig_pack_threshold: float = 0.25,
                 plane=None,
                 cost_model: DispatchCostModel | None = None) -> None:
        super().__init__()
        # quantum: subset counts and pad widths round up to it (tile-shape
        #   reuse). max_block_bytes: one dispatch's (S, P, P) join block
        #   stays under it. cache_bytes: the LRU's bound.
        # bin_strategy: "quantile" fits size-class edges to the planned
        #   subset-length distribution per call (at most n_classes edges,
        #   never more padded cells than "pow2"); "pow2" pads each subset to
        #   the next power of two.
        # route: "auto" sends bins below the measured device break-even to
        #   the exact host path; "device" pins every finite-radius bin on the
        #   device.
        # prune_tier: "on"/"off"/"auto" — the coarse counts pass ahead of
        #   the fp32 masked join; "auto" enables it only where the calibrated
        #   model (probed in prune_dtype) shows the coarse pass is cheaper.
        # prune_dtype: the coarse arithmetic, "bf16" (K2) or "int8" (K2i);
        #   prune_eps: the coarse radius's relative headroom.
        # elig_pack_threshold: below this filter selectivity (eligible share
        #   of a call's subset points), tiles pack the eligible rows densely
        #   instead of folding eligibility words into full-width tiles.
        # plane: a DevicePlane whose shards take the device-routed bins.
        # cost_model: a fixed routing model in place of the calibrated one.
        if bin_strategy not in ("quantile", "pow2"):
            raise ValueError(f"unknown bin_strategy: {bin_strategy!r}")
        if route not in ("auto", "device"):
            raise ValueError(f"unknown route: {route!r}")
        if prune_tier not in ("auto", "on", "off"):
            raise ValueError(f"unknown prune_tier: {prune_tier!r}")
        if prune_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown prune_dtype: {prune_dtype!r}")
        if plane is not None:
            plane.check_device(device)
            device = plane.device
        self.device = resolve_device(device)
        self.plane = plane
        self.quantum = quantum
        self.max_block_bytes = max_block_bytes
        self.cache_bytes = cache_bytes
        self.bin_strategy = bin_strategy
        self.n_classes = n_classes
        self.route = route
        self.prune_tier = prune_tier
        self.prune_dtype = prune_dtype
        self.prune_eps = prune_eps
        self.elig_pack_threshold = float(elig_pack_threshold)
        self._model = cost_model
        # The class floor is the masked join's tile on the card (every block
        # computes whole tiles anyway); the plain version uses exact shapes.
        self._min_class = JOIN_SQUARE_TILE if self.device.type == "cuda" \
            else self.quantum
        self._edge_cache: dict[bytes, np.ndarray] = {}
        # LRU over device-committed dispatch tiles and host distance tables;
        # values are (nbytes, payload). Entries are valid for one corpus
        # *generation* (subset keys are id bytes): within a generation the
        # id space is append-only (streaming absorbs and tombstones), so
        # entries survive corpus growth; a new generation clears them.
        self._cache: OrderedDict[tuple, tuple[int, object]] = OrderedDict()
        self._cache_nbytes = 0
        self._corpus: np.ndarray | None = None
        self._generation: int | None = None
        # Resident corpus: rows [0, n) of a capacity-doubled device buffer,
        # and their float64 squared norms in a host buffer of the same
        # capacity. ``_points_dev`` is the (n, d) view.
        self._buf: torch.Tensor | None = None
        self._norm_buf: np.ndarray | None = None
        self._n = 0

    # --------------------------------------------------------------- corpus
    @property
    def _points_dev(self) -> torch.Tensor | None:
        return None if self._buf is None else self._buf[:self._n]

    @property
    def _norm2(self) -> np.ndarray | None:
        return None if self._norm_buf is None else self._norm_buf[:self._n]

    def attach(self, points: np.ndarray, generation: int | None = None,
               points_dev: torch.Tensor | None = None) -> None:
        """Make ``points`` the resident corpus.

        Under the current ``generation`` token the corpus only grows: rows
        past the resident ones are appended (each uploaded once). A new
        token, or none (array identity decides), replaces the corpus: every
        cache entry goes, and the rows are uploaded, or taken from
        ``points_dev`` when the caller already holds them on the device."""
        same = points is self._corpus if generation is None \
            else generation == self._generation
        if same and self._buf is not None and len(points) >= self._n:
            if len(points) > self._n:
                self._append(points[self._n:])
            self._corpus = points
            return
        if self._cache and generation is not None \
                and self._generation is not None:
            self.stats.generation_purges += 1
        self._cache.clear()
        self._cache_nbytes = 0
        self._edge_cache.clear()
        self._generation = generation
        pts32 = np.ascontiguousarray(points, dtype=np.float32)
        if not pts32.flags.writeable:
            # a memory-mapped store leaf: read it once, here
            pts32 = pts32.copy()
        self._buf = points_dev.contiguous() if points_dev is not None \
            else torch.from_numpy(pts32).to(self.device)
        # float64 squared norms of the fp32 rows: the slack of any subset is
        # a max over these, bit-identical to recomputing it from the rows.
        self._norm_buf = (pts32.astype(np.float64) ** 2).sum(axis=1)
        self._n = len(pts32)
        self._corpus = points

    def _append(self, rows: np.ndarray) -> None:
        """Append rows to the resident corpus, doubling its capacity when
        full."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        need = self._n + len(rows)
        if need > len(self._buf):
            cap = max(2 * len(self._buf), need)
            buf = torch.empty((cap, self._buf.shape[1]), dtype=torch.float32,
                              device=self.device)
            buf[:self._n] = self._buf[:self._n]
            norms = np.empty(cap, dtype=np.float64)
            norms[:self._n] = self._norm_buf[:self._n]
            self._buf, self._norm_buf = buf, norms
        self._buf[self._n:need] = torch.from_numpy(rows).to(self.device)
        self._norm_buf[self._n:need] = (rows.astype(np.float64) ** 2).sum(1)
        self._n = need

    # ------------------------------------------------------------------ cache
    def _cache_get(self, key: tuple):
        entry = self._cache.get(key)
        if entry is None:
            return None
        self._cache.move_to_end(key)
        return entry[1]

    def _cache_put(self, key: tuple, payload, nbytes: int) -> None:
        if nbytes > self.cache_bytes:
            return
        old = self._cache.pop(key, None)
        if old is not None:
            self._cache_nbytes -= old[0]
        self._cache[key] = (nbytes, payload)
        self._cache_nbytes += nbytes
        while self._cache_nbytes > self.cache_bytes:
            _, (dropped, _) = self._cache.popitem(last=False)
            self._cache_nbytes -= dropped
            self.stats.cache_evictions += 1

    def _slack(self, ids: np.ndarray, d: int) -> float:
        """Absolute L2 error bound for the fp32 ||a||^2+||b||^2-2ab identity.

        The squared-distance error is dominated by cancellation at the
        squared-norm scale S: |err_sq| <= c*eps32*S with c a small constant
        times the reduction depth; sqrt is monotone, so |err_dist| <=
        sqrt(err_sq). c = 64 + 4d leaves headroom across accumulation orders.
        """
        if len(ids) == 0:
            return 0.0
        s_norm = float(self._norm2[ids].max())
        return float(np.sqrt((64.0 + 4.0 * d) * _EPS32 * s_norm))

    def pairwise(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        self.stats.dispatches += 1
        sq, _ = ops.pairwise_l2_join(
            torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(self.device))
        return np.sqrt(sq.cpu().numpy().astype(np.float64))

    def _round(self, n: int) -> int:
        q = self.quantum
        return max(q, ((n + q - 1) // q) * q)

    def _class_pad(self, n: int) -> int:
        """Size class for one subset: next power of two >= max(n, floor)."""
        p = self._min_class
        while p < n:
            p <<= 1
        return p

    def _cost_model(self, d: int) -> DispatchCostModel:
        if self._model is None:
            self._model = calibrate_cost_model(d, self.device,
                                               self.prune_dtype)
        return self._model

    def warmup(self, d: int) -> None:
        """Calibrate the cost model (and so build the kernels on the card)
        before serving, where the route or the prune tier depends on it."""
        if self.route == "auto" or self.prune_tier == "auto":
            self._cost_model(d)

    def _prune_active(self, d: int) -> bool:
        if self.prune_tier == "on":
            return True
        if self.prune_tier == "off":
            return False
        return self._cost_model(d).prune_profitable

    def _quantile_edges(self, sizes: np.ndarray) -> np.ndarray:
        """Data-driven size-class edges for one call's subset lengths.

        Lengths are rounded up to the quantum (shape reuse) and floored at
        the min class, then segmented by the waste-minimizing DP
        (:func:`_dp_segment`) capped at ``n_classes`` edges — or the pow2
        class count if that is larger, which makes the pow2 segmentation a
        *feasible* DP choice and hence quantile padded cells <= pow2 padded
        cells on every call (the guard below enforces it exactly). Edges are
        cached per sorted-length signature for the life of the corpus."""
        q = self.quantum
        vals = np.maximum(((np.maximum(sizes, 1) + q - 1) // q) * q,
                          self._min_class).astype(np.int64)
        svals = np.sort(vals)
        sig = svals.tobytes()
        hit = self._edge_cache.get(sig)
        if hit is not None:
            return hit
        distinct, counts = np.unique(svals, return_counts=True)
        pow2_edges = np.unique([self._class_pad(int(v)) for v in distinct])
        cap = max(self.n_classes, len(pow2_edges))
        edges = _dp_segment(distinct, counts, cap)

        def total_cells(e):
            cls = e[np.searchsorted(e, distinct)]
            return int((counts * cls.astype(np.int64) ** 2).sum())

        if total_cells(edges) > total_cells(pow2_edges):
            edges = pow2_edges
        if len(self._edge_cache) > 128:
            self._edge_cache.clear()
        self._edge_cache[sig] = edges
        return edges

    def self_join_blocks(self, points: np.ndarray,
                         id_lists: Sequence[np.ndarray],
                         radii: Sequence[float],
                         keys: Sequence[bytes] | None = None,
                         generation: int | None = None,
                         eligible: np.ndarray | None = None
                         ) -> list[DistanceBlock]:
        if not len(id_lists):
            return []
        if keys is None:
            keys = [None] * len(id_lists)
        self.attach(points, generation)
        # Size-binned dispatch: padding every subset of a scale to the batch
        # max wastes quadratically. Size-class edges are fitted to this
        # call's lengths (:meth:`_quantile_edges`); within a class, chunk so
        # one dispatch's (S, P, P) join block stays under the memory budget,
        # then route each chunk: bins whose estimated device cost exceeds the
        # measured host cost go to the exact numpy path (route="auto"), the
        # rest dispatch on the device. Result order matches the task order.
        blocks: list[DistanceBlock | None] = [None] * len(id_lists)
        finite: list[int] = []
        for i, ids in enumerate(id_lists):
            if not np.isfinite(radii[i]):
                # An infinite pruning radius joins every pair by construction
                # (fresh queues at scale 0): the mask is all-ones, so skip the
                # device round-trip and synthesize the trivial block. The
                # enumeration stage prunes with its live r_k instead. Under a
                # filter the all-ones adjacency covers eligible pairs only —
                # the same contract as the device fold.
                n = len(ids)
                n_elig = None if eligible is None else int(eligible[ids].sum())
                pairs = n * n if n_elig is None else n_elig * n_elig
                self.stats.subsets += 1
                self.stats.points_packed += n
                self.stats.join_pairs += pairs
                blocks[i] = DistanceBlock(n=n, slack=0.0, rescore=True,
                                          join_count=pairs, n_eligible=n_elig)
                continue
            finite.append(i)
        if not finite:
            return blocks
        sizes = np.fromiter((len(id_lists[i]) for i in finite), np.int64,
                            count=len(finite))
        # Eligible-dense packing: when a filter keeps only a thin slice of
        # each subset, folding eligibility words into a full-width tile
        # wastes ~1/selectivity^2 of the join cells. Below the threshold the
        # tiles pack eligible rows densely instead — sized by eligible
        # counts, uncached (the pack is filter-dependent), blocks carrying
        # the packed row map for the enumeration stage.
        elig_dense = False
        if eligible is not None:
            el_counts = np.fromiter(
                (int(eligible[id_lists[i]].sum()) for i in finite), np.int64,
                count=len(finite))
            tot = int(sizes.sum())
            elig_dense = tot > 0 and \
                int(el_counts.sum()) < self.elig_pack_threshold * tot
            if elig_dense:
                sizes = el_counts
        if self.bin_strategy == "quantile":
            edges = self._quantile_edges(sizes)
            cls = edges[np.searchsorted(edges, np.maximum(sizes, 1))]
        else:
            cls = np.array([self._class_pad(int(max(s, 1))) for s in sizes])
        classes: dict[int, list[int]] = {}
        for pos in range(len(finite)):
            classes.setdefault(int(cls[pos]), []).append(pos)
        model = None
        if self.route == "auto":
            model = self._cost_model(points.shape[1])
        budget = max(1, self.max_block_bytes // 4)
        for p_pad, poss in sorted(classes.items()):
            # Budget the *padded* subset count: _dispatch rounds it up to
            # quantum for shape reuse, so floor max_s to a quantum multiple
            # (falling back to unrounded single-subset dispatches when even
            # one quantum of this class would blow the budget).
            max_s = budget // (p_pad * p_pad)
            if max_s >= self.quantum:
                max_s = (max_s // self.quantum) * self.quantum
            max_s = max(1, max_s)
            for c0 in range(0, len(poss), max_s):
                chunk = poss[c0:c0 + max_s]
                idxs = [finite[p] for p in chunk]
                sub_ids = [id_lists[i] for i in idxs]
                sub_r = [radii[i] for i in idxs]
                sub_keys = [keys[i] for i in idxs]
                if model is not None:
                    padded_cells = self._round(len(chunk)) * p_pad * p_pad
                    valid_cells = int((sizes[chunk] ** 2).sum())
                    if model.host_cost(len(chunk), valid_cells) \
                            < model.device_cost(padded_cells, valid_cells,
                                                len(chunk)):
                        out = self._host_dispatch(points, sub_ids, sub_r,
                                                  sub_keys, eligible)
                        for i, b in zip(idxs, out):
                            blocks[i] = b
                        continue
                out = self._dispatch(sub_ids, sub_r, sub_keys, p_pad,
                                     eligible, elig_dense)
                for i, b in zip(idxs, out):
                    blocks[i] = b
        return blocks

    def _host_dispatch(self, points: np.ndarray,
                       id_lists: Sequence[np.ndarray],
                       radii: Sequence[float],
                       keys: Sequence[bytes | None],
                       eligible: np.ndarray | None) -> list[DistanceBlock]:
        """Cost-model host route: one bin served by the exact float64 path.

        Blocks carry dense float64 distances (no slack, no rescore) computed
        with the *same* difference-based arithmetic the enumeration stage's
        float64 settlement uses (``sqrt`` of ``_sq_dists_f64``) — not the
        norms identity of :class:`NumpyBackend`, which rounds differently at
        the last ulp. That keeps the routing decision invisible in the
        output: a bin served here yields bitwise the same diameters the
        device route's rescore would have produced. The whole bin counts as
        one dispatch. Distance tables are LRU-cached per subset key
        (radius- and filter-independent), so a steady-state host-routed bin
        recomputes nothing but the threshold count."""
        t0 = time.perf_counter()
        out = []
        for ids, r, key in zip(id_lists, radii, keys):
            ck = None if key is None else ("hostdist", key)
            dist = self._cache_get(ck) if ck is not None else None
            if dist is None:
                dist = np.sqrt(_sq_dists_f64(
                    np.asarray(points[ids], np.float64)))
                self._note_cold_read(points, len(ids))
                if ck is not None:
                    self.stats.cache_misses += 1
                    self._cache_put(ck, dist, dist.nbytes)
            else:
                self.stats.cache_hits += 1
            n_elig = None
            if eligible is None:
                count = int((dist <= r).sum())
            else:
                el = eligible[ids]
                n_elig = int(el.sum())
                count = int(((dist <= r) & el[:, None] & el[None, :]).sum())
            self.stats.subsets += 1
            self.stats.points_packed += len(ids)
            self.stats.join_pairs += count
            out.append(DistanceBlock(n=len(ids), dist=dist, slack=0.0,
                                     rescore=False, join_count=count,
                                     n_eligible=n_elig))
        dt = time.perf_counter() - t0
        self.stats.dispatches += 1
        self.stats.host_routed_dispatches += 1
        self.stats.host_routed_subsets += len(id_lists)
        self.stats.t_host_s += dt
        self.stats.t_dispatch_s += dt
        return out

    def _pack_tile(self, id_lists: Sequence[np.ndarray], s_pad: int,
                   p_pad: int, rows: np.ndarray | None = None
                   ) -> torch.Tensor:
        """(s_pad, p_pad, d) fp32 tile gathered on the device from the
        resident corpus: subset i's rows land at slots [0, len) of tile row
        ``rows[i]`` (default i), the rest stay zero. Only the id lists cross
        to the device."""
        d = self._points_dev.shape[1]
        lens = np.fromiter((len(ids) for ids in id_lists), np.int64,
                           count=len(id_lists))
        ids = np.concatenate(id_lists).astype(np.int64, copy=False) \
            if len(id_lists) else np.zeros(0, np.int64)
        if rows is None:
            rows = np.arange(len(id_lists), dtype=np.int64)
        starts = np.repeat(np.asarray(rows, np.int64) * p_pad, lens)
        offs = np.arange(len(ids), dtype=np.int64) \
            - np.repeat(np.cumsum(lens) - lens, lens)
        slots = starts + offs
        ids_t = torch.from_numpy(ids).to(self.device)
        slots_t = torch.from_numpy(slots).to(self.device)
        self.stats.h2d_bytes += ids.nbytes + slots.nbytes
        x = torch.zeros((s_pad * p_pad, d), dtype=torch.float32,
                        device=self.device)
        x.index_copy_(0, slots_t, self._points_dev.index_select(0, ids_t))
        return x.view(s_pad, p_pad, d)

    def _dispatch(self, id_lists: Sequence[np.ndarray],
                  radii: Sequence[float], keys: Sequence[bytes | None],
                  p_pad: int, eligible: np.ndarray | None = None,
                  elig_dense: bool = False) -> list[DistanceBlock]:
        t0 = time.perf_counter()
        dev = self.device
        n_subsets = len(id_lists)
        d = int(self._points_dev.shape[1])
        # Eligible-dense packing: tiles hold only the eligible rows and the
        # blocks carry the packed row map. The pack is filter-dependent, so
        # the tile cache is bypassed.
        row_lists = None
        pack_ids = id_lists
        if elig_dense:
            row_lists = [np.flatnonzero(eligible[ids]) for ids in id_lists]
            pack_ids = [ids[rw] for ids, rw in zip(id_lists, row_lists)]
        lengths = np.fromiter((len(ids) for ids in pack_ids), np.int32,
                              count=n_subsets)
        # Shard the bin over the plane when it packs at least one subset per
        # shard; thinner bins stay on one device (sharding them would only
        # ship empty slabs).
        plane = self.plane
        sharded = plane is not None and n_subsets >= plane.n_shards
        s_pad = self._round(n_subsets)
        if sharded:
            s_pad = plane.shard_pad(s_pad)
        budget_cells = max(1, self.max_block_bytes // 4)
        if s_pad * p_pad * p_pad > budget_cells:
            # Shape-reuse rounding must not blow the budget. Sharding needs a
            # shard multiple; if even the minimal one is over budget, the bin
            # drops to the single-device route at its exact size.
            s_pad = plane.shard_pad(n_subsets) if sharded else n_subsets
            if sharded and s_pad * p_pad * p_pad > budget_cells:
                sharded = False
                s_pad = n_subsets
        lens_pad = np.zeros(s_pad, np.int32)
        lens_pad[:n_subsets] = lengths
        # Shard placement: deal subsets to tile rows in snake order of packed
        # size so each shard's contiguous slab carries level work
        # (``device_plane.balance_order``). The permutation is a pure
        # function of the packed lengths — radius-independent, so cached
        # tiles stay valid — and ``inv[i]`` is subset i's tile row.
        inv = None
        if sharded:
            perm = balance_order(lens_pad, plane.n_shards)
            inv = np.empty(s_pad, np.int64)
            inv[perm] = np.arange(s_pad)

        def to_rows(arr: np.ndarray) -> np.ndarray:
            if inv is None:
                return arr
            out = np.zeros_like(arr)
            out[inv] = arr
            return out

        lens_ship = to_rows(lens_pad)
        tile_key = None
        if not elig_dense and not any(k is None for k in keys):
            tile_key = ("tile", tuple(keys), s_pad, p_pad, sharded)
        cached_tile = self._cache_get(tile_key) if tile_key else None
        if cached_tile is not None:
            # Packed tile already on the device: skip gather and packing;
            # only the radii (and eligibility words) change between calls.
            # Hit counters are per *subset* (a tile hit serves every subset
            # it packs).
            self.stats.cache_hits += n_subsets
            x_dev, lens_dev, slacks, slabs = cached_tile
        else:
            slacks = np.array([self._slack(ids, d) for ids in pack_ids],
                              np.float64)
            x_dev = self._pack_tile(pack_ids, s_pad, p_pad,
                                    None if inv is None
                                    else inv[:n_subsets])
            lens_dev = torch.from_numpy(lens_ship).to(dev)
            self.stats.h2d_bytes += lens_ship.nbytes
            slabs = None
            nbytes = x_dev.numel() * 4 + slacks.nbytes
            if sharded:
                # The shards' slabs of the committed tile, on their devices
                # (views where a shard shares the first device).
                slabs = plane.put_sharded(x_dev, lens_dev)
                nbytes += sum(t.numel() * 4 for t in slabs[0]
                              if t.device != dev)
            if tile_key is not None:
                self.stats.cache_misses += n_subsets
                self._cache_put(tile_key, (x_dev, lens_dev, slacks, slabs),
                                nbytes)

        # Pruning radius r + slack, rounded *up* to fp32 so the device
        # comparison can never be tighter than the published slack contract.
        # ``r_pad`` is indexed by subset, the shipped vectors by tile row.
        r_pad = np.zeros(s_pad, np.float32)
        r_mask = np.asarray(radii, np.float64) + slacks
        with np.errstate(over="ignore"):    # nextafter(f32max) saturates to inf
            r_pad[:n_subsets] = np.nextafter(r_mask.astype(np.float32),
                                             np.float32(np.inf))
        r_pad[:n_subsets][~np.isfinite(r_mask)] = np.float32(np.inf)
        r_ship = to_rows(r_pad)
        # Filtered dispatch (fold mode): pack each subset's eligibility bits
        # into the mask word layout. These words are the *only* extra traffic
        # a filter adds — the tile (cached or not) is filter-independent, and
        # the readback stays the same packed mask. Eligible-dense tiles skip
        # the fold (every packed row is eligible by construction).
        elig_words = el_counts = None
        if eligible is not None and not elig_dense:
            el = np.zeros((s_pad, p_pad), dtype=bool)
            el_counts = np.zeros(n_subsets, np.int64)
            for i, ids in enumerate(id_lists):
                eli = eligible[ids]
                el[i if inv is None else inv[i], :len(ids)] = eli
                el_counts[i] = int(eli.sum())
            words = pack_join_mask(el).view(np.int32)   # (s_pad, p_pad/32)
            elig_words = torch.from_numpy(words).to(dev)
            self.stats.h2d_bytes += words.nbytes
        self.stats.t_pack_s += time.perf_counter() - t0
        self.stats.h2d_bytes += r_ship.nbytes
        # The diagonal bound of the empty-join test: eligible counts under a
        # fold, packed lengths otherwise.
        n_live = lengths.astype(np.int64) if el_counts is None else el_counts

        # ---- tier 0: coarse prune in prune_dtype (counts only) ----
        pruned = None
        cc = None
        if self._prune_active(d):
            # Coarse radius: the fp32 pruning radius widened by the coarse
            # tier's own error budget — a second fp32-identity slack (the
            # coarse pass accumulates in fp32 too) plus the bf16 coordinate
            # rounding (2 * eps16 * max-norm, eps16 = 2^-8; the max norm is
            # recovered from the slack, sqrt(S_norm) = slack /
            # sqrt((64+4d)*eps32)), all scaled by (1 + prune_eps) headroom.
            # Any pair the fp32 tier could join is therefore inside the
            # coarse radius: coarse count <= diagonal bound proves the fp32
            # join empty, and results stay bit-identical whether or not the
            # fp32 tier ran. Under a fold the coarse pass takes the same
            # eligibility words, so its counts bound K1's eligible counts.
            eps16 = 2.0 ** -8
            rtnorm = slacks / np.sqrt((64.0 + 4.0 * d) * _EPS32)
            r_c = (r_mask + slacks + 2.0 * eps16 * rtnorm) \
                * (1.0 + self.prune_eps)
            rc_pad = np.zeros(s_pad, np.float32)
            with np.errstate(over="ignore"):
                rc_pad[:n_subsets] = np.nextafter(
                    r_c.astype(np.float32), np.float32(np.inf))
            rc_ship = to_rows(rc_pad)
            t_p = time.perf_counter()
            rc_dev = torch.from_numpy(rc_ship).to(dev)
            if sharded:
                cnt_c = plane.join_batched_counts(
                    slabs[0], slabs[1], rc_dev, elig_words,
                    dtype=self.prune_dtype)
            else:
                cnt_c = ops.pairwise_l2_join_batched_counts(
                    x_dev, lens_dev, rc_dev, elig_words,
                    dtype=self.prune_dtype)
            counts_c = cnt_c.cpu().numpy()
            dtp = time.perf_counter() - t_p
            self.stats.t_prune_s += dtp
            self.stats.t_dispatch_s += dtp
            self.stats.prune_tier_dispatches += 1
            self.stats.h2d_bytes += rc_ship.nbytes
            self.stats.d2h_bytes += counts_c.nbytes
            cc = counts_c[:n_subsets] if inv is None \
                else counts_c[inv[:n_subsets]]
            pruned = cc <= n_live
            self.stats.cells_pruned += int(pruned.sum()) * p_pad * p_pad

        # ---- tier 1: fp32 masked join on surviving subsets ----
        mask = counts = None
        sub_rows = None
        if pruned is None or not pruned.all():
            t1 = time.perf_counter()
            if pruned is not None and pruned.any():
                # Survivor sub-dispatch: gather surviving rows out of the
                # committed tile on the device (no re-pack); it shards again
                # when it still holds a subset a shard.
                surv = np.flatnonzero(~pruned)
                rows_surv = surv if inv is None else inv[surv]
                n_surv = len(surv)
                s_sub = self._round(n_surv)
                sub_sharded = sharded and n_surv >= plane.n_shards
                if sub_sharded:
                    s_sub = plane.shard_pad(s_sub)
                idx_pad = np.zeros(s_sub, np.int64)
                idx_pad[:n_surv] = rows_surv
                lens_sub = np.zeros(s_sub, np.int32)
                lens_sub[:n_surv] = lengths[surv]
                r_sub = np.zeros(s_sub, np.float32)
                r_sub[:n_surv] = r_pad[surv]
                self.stats.h2d_bytes += idx_pad.nbytes + lens_sub.nbytes \
                    + r_sub.nbytes
                idx_dev = torch.from_numpy(idx_pad).to(dev)
                x_sub = x_dev.index_select(0, idx_dev)
                elig_sub = None if elig_words is None \
                    else elig_words.index_select(0, idx_dev)
                join = plane.join_batched_masked if sub_sharded \
                    else ops.pairwise_l2_join_batched_masked
                m, c = join(x_sub, torch.from_numpy(lens_sub).to(dev),
                            torch.from_numpy(r_sub).to(dev), elig_sub)
                sub_rows = {int(i): j for j, i in enumerate(surv)}
            elif sharded:
                m, c = plane.join_batched_masked(
                    slabs[0], slabs[1], torch.from_numpy(r_ship).to(dev),
                    elig_words)
            else:
                m, c = ops.pairwise_l2_join_batched_masked(
                    x_dev, lens_dev, torch.from_numpy(r_ship).to(dev),
                    elig_words)
            mask = _to_uint32(m)
            counts = c.cpu().numpy()
            dt = time.perf_counter() - t1
            self.stats.t_dispatch_s += dt
            self.stats.d2h_bytes += mask.nbytes + counts.nbytes
            if sharded:
                self.stats.t_collective_s += dt

        valid = int(lengths.sum())
        self.stats.dispatches += 1
        if elig_dense:
            self.stats.elig_dense_dispatches += 1
        elif eligible is not None:
            self.stats.elig_fold_dispatches += 1
        self.stats.subsets += n_subsets
        self.stats.points_packed += valid
        self.stats.points_padded += s_pad * p_pad - valid
        bp = self.stats.bin_points.get(p_pad, (0, 0))
        self.stats.bin_points[p_pad] = (bp[0] + valid,
                                        bp[1] + s_pad * p_pad - valid)
        self.stats.valid_cells += int((lengths.astype(np.int64) ** 2).sum())
        self.stats.total_cells += s_pad * p_pad * p_pad
        if sharded:
            # Per-shard accounting: every shard took a slab; utilisation is
            # valid against total join-block cells of each slab (on the
            # shipped, placement-permuted lengths).
            self.stats.sharded_dispatches += 1
            self.stats.ensure_shards(plane.n_shards)
            valid_sh, total_sh = plane.shard_cells(lens_ship, p_pad)
            for i in range(plane.n_shards):
                self.stats.shard_dispatches[i] += 1
                self.stats.shard_valid_cells[i] += valid_sh[i]
                self.stats.shard_total_cells[i] += total_sh[i]
        else:
            # A single-device dispatch lands on the first device (shard 0
            # of the plane when one is attached).
            self.stats.ensure_shards(plane.n_shards if plane else 1)
            self.stats.shard_dispatches[0] += 1
            self.stats.shard_valid_cells[0] += int(
                (lengths.astype(np.int64) ** 2).sum())
            self.stats.shard_total_cells[0] += s_pad * p_pad * p_pad

        out = []
        for i in range(n_subsets):
            n = len(id_lists[i])
            n_elig = None if eligible is None else int(n_live[i])
            rows_i = None if row_lists is None else row_lists[i]
            if pruned is not None and pruned[i]:
                # Coarse count at or below the diagonal bound: the fp32 join
                # is provably empty off-diagonal, emit the mask-free block
                # (the enumeration stage's singleton path never unpacks it).
                self.stats.join_pairs += int(cc[i])
                out.append(DistanceBlock(
                    n=n, slack=float(slacks[i]), rescore=True,
                    join_count=int(cc[i]), n_eligible=n_elig, rows=rows_i))
                continue
            if sub_rows is not None:
                row = sub_rows[i]
            else:
                row = i if inv is None else int(inv[i])
            npk = int(lengths[i])
            words = (npk + 31) // 32
            self.stats.join_pairs += int(counts[row])
            out.append(DistanceBlock(
                n=n, mask=mask[row, :npk, :words], slack=float(slacks[i]),
                rescore=True, join_count=int(counts[row]),
                n_eligible=n_elig, rows=rows_i))
        return out
