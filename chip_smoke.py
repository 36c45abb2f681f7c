#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, the full-size corpus
    python3 chip_smoke.py --n 20000 --embed-docs 64 --embed-long-docs 2 \
        --stream-points 2000 --stream-deletes 200 --tenant-points 5000
                                     # a quick check of every phase

Phases:
  1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and report
     the card (name and power limit, as nvidia-smi gives them) and the
     ``-Xptxas -v`` lines (registers, shared memory, spills) of the K7,
     K1-K4 and K6 kernels.
  1b. [build] Build the engine over a flickr-like corpus of 10^6 points
     (Table III's largest real dataset: u=24,874 keywords, t=11 tags, at the
     d=64 top of the paper's dimensionality grid; attribute columns price,
     uniform in [0, 100), and 8 categories, which do not enter the index;
     m=2, 5 scales, the hash
     geometry pinned at the corpus's own w0 and table size): the host
     projection, K5 (exactly 5 launches: one per scale for both indices),
     the settlement of near-edge entries from the host product, hashing
     and CSR assembly on the card and the copy back, each timed. Both
     indices must equal ``core.index.build_index`` on the host array for
     array, bit for bit.
  2. Serve the main path at full size on that engine. Four paths,
     each driven with the launch counters set to 0 just before it and read
     just after: a batch of 64 random 3-keyword queries (k=1) in the exact
     tier and then in the approx tier through the engine's default torch
     backend; the exact batch again with every bin forced onto the device and
     the bf16 prune tier armed; the exact batch again on the default route
     with ``TorchBackend(prune_tier="off")`` and with a fresh default
     backend (QPS with the tier off and armed, K2's launches on each); then
     [prune-int8] with ``TorchBackend(prune_tier="on", prune_dtype="int8")``
     (K2i, the int8 arm, must launch and K2 not); and
     ``backend.pairwise`` on one subset. The default exact batch must launch
     K1 (and K2 where the cost model's per-cell ratio, printed, arms the
     tier), the forced batch K1 and K2, the prune-off batch no K2, the
     pairwise call K3.
     Answers are held to the numpy backend on the same engine (identical ids,
     float64 diameters to 1e-9: the two backends score through different
     float64 formulas), the forced, prune-off, fresh and int8 runs to the
     default run bit for bit, and every answer is checked to be a covering
     set of finite diameter.
  2b. [semantics] On the same engine, the batch's queries (3 keywords, k=2)
     under the reference semantics bench's four variants — classic, m-of-k
     (m=2), weighted (the batch's two lowest keyword ids boosted to 3.0),
     scored (m=2) — in the exact and approx tiers, on the torch and the
     numpy backend, each a path of its own (QPS, subqueries, phases, K1/K2
     launches). Torch answers equal numpy's (ids; costs and scores to 1e-9;
     ties only within TIE_ULPS ulps of the rescored cost, the weighted cost
     of ``brute_force.weighted_set_cost`` for the weighted variant);
     degenerate semantics equal classic bit for bit on every route; the
     device tier refuses the flexible variants.
  3. Hold each kernel against its plain PyTorch version on the card, on the
     largest input the main path gave it (recorded during phase 2): masks
     may differ only on cells whose float64 squared distance lies within the
     fp32 error band of the threshold, counts by at most that many cells, sq
     by at most the band; K1's mask must be symmetric bit for bit (it
     computes the upper triangle of tiles and mirrors it), and K2's SASS
     must hold HGMMA, its tensor-core product (``cuobjdump -sass``). K2i
     (the int8 arm) at K2's path input, at the price < 50 input with its
     eligibility words and at a seeded d=2304 input must equal its plain
     version (run on host copies: integer PyTorch on the CPU) bit for bit,
     count at least K1's fp32 counts at the same radius; its join's SASS
     must hold IGMMA and UTMALDG (TMA) and ptxas must report no spills in
     its two kernels. Time kernel, plain version (K2i's on the host's
     clock) and the library yardsticks (K2: bf16 torch.bmm then a count;
     K2i: the quantisation in torch ops, torch._int_mm a subset, then a
     count; K3: torch.cdist) with CUDA events, and K1-K3 by the
     fresh-process profiler (K2i's prep and join kernels also one by
     one). [K4] The same on K1's largest input for K4 (the
     dense block and 128 x 128 tile counts, which no served path launches,
     as in the reference: only ``ops.pairwise_l2_join_batched`` calls it),
     timed with CUDA events and the profiler beside ``torch.cdist`` and a
     count; each live square must be bitwise symmetric (K4 computes the
     upper triangle of tiles and writes the transpose), and K4 is also
     checked and timed on a dense input of the same shape (every length P)
     for its FMA rate. K3's counts must lie on the reference's 128 x 128
     grid.
  3b. The anchor-star device tier on the same engine (no second build), each
     batch a path of its own: (a) the same 64 queries at k=1 on
     ``tier="device"``; (b) 64 random 9-keyword queries (the paper's largest
     query size) at k=10. The fused anchor-star kernel (K6's device-tier
     entry, ``kernels.diameter.anchor_star``) must launch its two kernels
     once per query (the neighbour stage and the diameter stage), the
     standalone K6 never, and no join kernel. Profiled again: the
     device-tier window holds no matrix-product and no argmin kernel, and
     the fused entry alone at its largest input launches nothing but its
     own two kernels (and the memset of its keys). Every answer is a
     covering set of finite diameter, ascending, and its float64 rescore
     from its ids lies within the fp32 band ``sqrt((64 + 4d) eps32
     max|x - c|^2)`` of the reported diameter (x the query's packed points,
     c their mean: ``core.distributed.diameter_band``); at k=1 the answer
     lies in [opt - band, 2 opt + band] against the exact tier's optimum
     (the triangle-inequality guarantee).
     (c) The first 8 queries of (a): ``nks_anchor_topk`` on the card
     against the same packed groups on the CPU (the plain path end to end):
     equal id sets, diameters within the band.

  3c. [filter] On the same engine, the 64 queries at k=1 under four
     filters — price < 50 (fold mode: eligibility words into K1, and K2 on
     the prune tier), price < 10 and price < 1 (below the 0.25 threshold:
     eligible-dense packing), category == 3 with price in [20, 70] — and,
     per filter, 64 more drawn from the keywords holding 4 to 16 eligible
     points (every one answerable), each set through the exact tier
     (default backend, and forced onto the device with the prune tier
     armed), the approx tier and the device tier, every batch a path of its
     own; price < 50 over the 64 queries also with the prune tier off (bit
     for bit the default). The forced run over the second set must dispatch
     in the filter's packing mode (counted per dispatch by the backend). Answers
     equal the numpy backend's under the same filter (ids, diameters to
     1e-9, the narrow tie acceptance of the stream phase), hold only
     eligible points, exist iff every keyword has an eligible point, the
     forced run equals the default bit for bit, and the device tier's pass
     the checks of 3b (a) against the filtered exact optimum (bands of the
     eligible groups). A filter keeping nothing gives
     empty answers. K1 must launch with eligibility words and K2 too in
     the forced run (counted per launch by the wrappers); K1 and K2 are
     held to their plain versions at the forced price < 50 run's largest
     input, eligibility words included. No new D2H: the phase's largest
     backend call whose tiles the cache holds, unfiltered and then under
     price < 50 on one fold-mode backend, reads back the same bytes and
     ships only radii and eligibility words.

  3d. [stream] On the same engine: insert 10,000 flickr-like points
     (another seed) with attribute columns in 8 batches (K5: exactly 5
     launches per batch), delete 1,000 (half bulk, half delta), then the 64
     queries in the exact and approx tiers must answer as the numpy backend
     does on the same engine (ids equal, diameters to 1e-9) and name no
     deleted point, and so must the exact tier under price < 50 (eligible,
     live points only); ``compact()``
     (K5: exactly 5 launches), after which the answers equal a fresh
     engine's over the compacted corpus and the compacted indices equal the
     host build with the pinned geometry. Prints insert points/s and the
     delete and compaction seconds.
  3e. [store] ``core.store.build_store`` over the served corpus with the
     served engine's pinned geometry and bucket synopses (K5: exactly 5
     launches; the card build, the host synopses and the writes timed
     apart), then ``NKSEngine.from_store(mmap=True,
     resident_budget_bytes=256 MiB)`` timed to its first answer: the
     indices equal the served engine's bit for bit, and the 64 queries in
     the exact, approx and device tiers and the price<50 and category-3
     batches answer bit for bit as the served engine did (QPS beside it,
     the zone and radius prune counters, cold reads).
  3f. [wal] A fresh engine over the served corpus: ``attach_wal``, 4
     insert batches of 1,250 with attributes (each fsync'd), ``snapshot()``,
     4 batches in one ``ingest_group()`` (one fsync), 1,000 deletes,
     ``compact()``, 2 batches; then a torn tail and ``NKSEngine.recover``,
     which must replay the 8 ops after the snapshot (K5: 5 launches an
     insert batch, delete and compaction) and answer in all three tiers and
     under price<50 bit for bit as the uninterrupted engine did. Both
     phases write to a fresh temporary directory (its free bytes printed)
     and remove it.
  3g. [tenant] At a reduced size (two tenants of 50,000 synthetic points,
     d=64, 1,000 local keywords each): 16 tenant-local 3-keyword queries
     per tenant in the exact, approx and device tiers; results echo the
     local ids, cover the resolved keywords, never reach the other tenant,
     and the torch and numpy backends agree; an id outside the tenant's
     dictionary raises.

  4. Embed at full width: MiniCPM-2B (40 layers, d_model 2304, 36 heads of
     64; random weights from a seeded generator on the card) embeds 4,096
     documents of 512 tokens in batches of 32 and 8 documents of its 4,096
     context in batches of 2 through ``NKSEngine.ingest_embeddings``; every
     self-attention runs the hand-written kernel K7, which must launch 40
     times per batch. Tags come from the flickr-like sampler (u=1,000,
     t=3). The engine's build runs K5 at d=2304 (exactly 5 launches) and
     both indices must equal the host build bit for bit. Every embedding
     must be finite and no two equal; 64 exact
     3-keyword queries (k=1, m=2, 5 scales) over the embedded corpus must
     answer as the numpy backend does (ids equal, diameters to 1e-9).
     Prints embed wall time, tokens/s, the model-FLOP share of the embed
     wall against the bf16 peak, K7's launches and peak device memory. The
     same 64 queries then run on ``tier="device"`` with the checks of 3b (a):
     the fused anchor-star kernel at d=2304.
  5. Hold K7 against its plain PyTorch version on the card: on the path's
     own q, k, v of both shapes (recorded during phase 4), causal; the long
     shape again with window 1024; grouped-query heads (36 query, 4 kv,
     head dim 128). Tolerance (``kernels.ref.flash_attention_tolerance``):
     the two round the softmax numerators at different scales (running
     against final maximum: 2^-9 relative each) and the output once, so
     ``|kernel - plain| <= 2^-7 |plain| + 2^-6 sqrt(sum_j p_j^2 v_j^2) / l``,
     a bound that scales with each row's own rounding noise. A planted
     fault (the last query tile skipping the key tile before its diagonal)
     must lie outside it. Time kernel, plain version and
     ``F.scaled_dot_product_attention`` with CUDA events (kernel and SDPA in
     turns, kernel, SDPA, SDPA, kernel; each the mean of its two runs), and
     the kernel by the fresh-process profiler; print kernel/SDPA per case.
  6. Hold the fused anchor-star kernel against its plain version
     (``kernels.ref.anchor_star``) on the card at the largest (q, R, d)
     input of 3b (a), of 3b (b) (q=9) and of the embed corpus's device batch
     (d=2304): on the valid anchors each neighbour's float64 distance to
     its anchor within the query's band of the plain one's, worst_nn too,
     and the diameters within rtol 1e-5 plus the band of the plain
     diameters of the kernel's own tuples. Time kernel, plain version and
     the composition it replaced (cuBLAS product, torch passes, argmin and
     the standalone K6) with CUDA events, and the kernel by the fresh-process
     profiler. Then hold the standalone K6 (``tuple_diameters``) against its
     plain version at the (R, q, d) tuples those neighbours form: max
     |kernel - plain| over the per-tuple band of the norms identity
     ``sqrt((64 + 4d) eps32 max|x|^2)`` at most 1; time kernel, plain
     version and ``torch.cdist(pts, pts).amax(dim=(1, 2))`` (two calls: no
     single PyTorch call computes r(A)) with CUDA events.

  7. [K5] Hold K5 against its plain PyTorch version on the card on the
     build's own inputs: (10^6, 64, m=2) at all 5 widths and the embedded
     corpus (4,104, 2,304, m=2) at its 5: p within the dot-product bound
     2 gamma_d |x|_2 of the plain p, bins equal except entries inside the
     settlement margin, which may be 1 apart. Time K5, the plain version
     and ``torch.matmul(x, z.T)`` followed by the two floor passes with CUDA
     events.

Profiler figures (device time per kernel, busy shares) are kept only where
the profiler's events of the kernel equal its launch counter over the same
calls; otherwise they print as None beside both counts. The kernels' device
times (K1-K7) are measured at the end, in a fresh child process
(``--profile-jobs``, given the saved inputs): in this process, after the
served phases' profiler windows, the profiler misses launches. A kernel
whose bound is by bytes is timed there with L2 evicted before each call (a
write of twice the card's L2 between calls, outside the timed kernel), and
a device time under a kernel's bound fails the run.

Prints the kernels' JSON line, the card line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, when a
phase fails, when there is no CUDA device, or when the port's sources are
not beside this file. Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores,
# bf16 and int8 on the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_S = 3.35e12
EPS32 = 2.0 ** -23
# Profiler kernel names of matrix products (cuBLAS/CUTLASS kernels).
MATMUL_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "sm90_")


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn`` takes on the host's clock: for a plain
    version that runs on the CPU only."""
    ts = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - ts) * 1e3 / reps


def profiled(fn, reps: int) -> tuple[dict, float]:
    """Run ``fn`` ``reps`` times under torch.profiler (CPU and CUDA
    activity): one profiling context with ``acc_events=True`` (events kept
    across cycles) where the installed torch takes it, else one context per
    call, summed. Returns ({kernel name: (device seconds, events)}, the
    host wall of the calls, each ending in a device sync). Callers count
    the events against the launch counters."""
    import inspect
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if "acc_events" in inspect.signature(profile).parameters:
        with profile(activities=acts, acc_events=True) as prof:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - ts
        return kernel_table(prof), wall
    table, wall = {}, 0.0
    for _ in range(reps):
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall += time.perf_counter() - ts
        for name, (sec, n) in kernel_table(prof).items():
            s0, n0 = table.get(name, (0.0, 0))
            table[name] = (s0 + sec, n0 + n)
    return table, wall


class KernelProfiles:
    """Kernel device times by torch.profiler, measured in a fresh child
    process (``--profile-jobs``). In this script's own process, after the
    profiler windows of the served phases, the profiler has seen as few as
    3 of 20 back-to-back launches of a kernel (an H100 run at full size); a
    process whose first profiling sessions these are saw every one.
    :meth:`add` registers a call (a wrapper of ``repro_torch.kernels`` by
    "module.function", its arguments) and the result dicts to fill;
    :meth:`run` saves the arguments under ``build/``, profiles every call in
    one child and writes ``device`` ({ms, events, launches, evicted, parts})
    and ``device_ms`` into each of them. A call whose targets are bound by
    bytes is timed with L2 evicted before each launch (an input that stays
    in the 50 MB L2 between back-to-back launches read faster than the
    bound allows); ``parts`` names kernels of a call timed one by one. A
    device time under a target's bound fails the run."""

    def __init__(self):
        self.jobs: dict = {}
        self.targets: dict = {}

    def add(self, label: str, fn: str, args: tuple, mark: str, counter: str,
            reps: int, *targets: dict, parts: tuple = (), **kw) -> None:
        evict = any(t.get("bound_by") == "bytes" for t in targets)
        self.jobs[label] = dict(fn=fn, args=args, kw=kw, mark=mark,
                                counter=counter, reps=reps, evict=evict,
                                parts=parts)
        self.targets[label] = targets

    def run(self) -> dict:
        import torch
        path = ROOT / "build" / "profile_jobs.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(self.jobs, path)
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                              "--profile-jobs", str(path)],
                             capture_output=True, text=True, timeout=600)
        path.unlink()
        check(out.returncode == 0, f"the profiling child failed: "
              f"{out.stderr.strip()[-2000:]}")
        results = json.loads(out.stdout.strip().splitlines()[-1])
        for label, res in results.items():
            for target in self.targets[label]:
                target["device"] = res
                target["device_ms"] = res["ms"]
            print(f"[profiler] {label}: {res['ms']} ms of device time per "
                  f"call ({res['events']} kernel events for "
                  f"{res['launches']} launches, in a fresh process"
                  f"{', L2 evicted before each call' if res['evicted'] else ''}"
                  f"){'; ' if res['parts'] else ''}"
                  f"{', '.join(f'{k} {v} ms' for k, v in res['parts'].items())}",
                  flush=True)
        for label, res in results.items():
            for target in self.targets[label]:
                dev, bnd = res["ms"], target.get("bound_ms")
                check(dev is None or bnd is None or dev >= bnd,
                      f"{label}: device time {dev} ms is under its bound "
                      f"{bnd} ms ({target.get('bound_by')}): an impossible "
                      f"reading")
        return results


def run_profile_jobs(path: str) -> int:
    """The child of :class:`KernelProfiles`: profiles each saved call and
    prints the results as one JSON line."""
    import importlib
    import torch
    jobs = torch.load(path, weights_only=False)
    out = {}
    for label, job in jobs.items():
        mod, name = job["fn"].rsplit(".", 1)
        fn = getattr(importlib.import_module(f"repro_torch.kernels.{mod}"),
                     name)
        # the profiler sometimes drops kernel events (its events then differ
        # from the launch counter and ms is None): up to three attempts
        for attempt in range(1, 4):
            res = profiled_ms(lambda: fn(*job["args"], **job["kw"]),
                              job["reps"], job["mark"], job["counter"],
                              evict=job["evict"], parts=job["parts"])
            if res["ms"] is not None:
                break
        out[label] = dict(res, attempts=attempt)
    print(json.dumps(out))
    return 0


def marked(table: dict, mark: str) -> tuple[float, int]:
    """(device seconds, events) of the kernels whose name holds ``mark``."""
    sec = sum(v[0] for k, v in table.items() if mark in k)
    return sec, sum(v[1] for k, v in table.items() if mark in k)


def profiled_ms(fn, reps: int, mark: str, counter: str, evict: bool = False,
                parts: tuple = ()) -> dict:
    """Mean device time (ms) per call of ``fn`` of the CUDA kernels whose
    name holds ``mark``, from torch.profiler over ``reps`` calls: the kernel
    alone, without the host's launch gaps that CUDA events between
    back-to-back calls also count. The profiler's kernel events are counted
    against the wrapper's launch counter ``counter`` over the same calls;
    where the two differ (the profiler lost launches) ``ms`` is None and
    both counts are reported. With ``evict`` a write of twice the card's L2
    (a fill kernel, outside the marked ones) precedes each call, so that
    the call reads its inputs from device memory. ``parts``: kernel names
    whose device time per call is reported one by one."""
    import torch
    timed = fn
    if evict:
        l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                     0) or 50 << 20
        scratch = torch.empty(2 * l2, dtype=torch.uint8, device="cuda")

        def timed():
            scratch.fill_(1)
            return fn()
    fn()
    torch.cuda.synchronize()
    before = launch_counts()[counter]
    table, _ = profiled(timed, reps)
    launches = launch_counts()[counter] - before
    sec, events = marked(table, mark)
    ok = events == launches > 0
    return {"ms": sec * 1e3 / reps if ok else None,
            "events": events, "launches": launches, "evicted": evict,
            "parts": {p: marked(table, p)[0] * 1e3 / reps if ok else None
                      for p in parts}}


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


class Recorder:
    """Wraps one ``kernels.ops`` entry point during the served run and keeps
    a copy of the largest input it was given (by padded join cells) that the
    plain version can hold in memory: at most ``CAP_CELLS`` cells, or else
    the smallest one."""

    CAP_CELLS = 1 << 28

    def __init__(self, ops, name: str, cells):
        self.ops, self.name, self.cells = ops, name, cells
        self.fn = getattr(ops, name)
        self.calls = 0
        self.best = None
        self.best_cells = -1
        self.shapes: dict[str, int] = {}
        setattr(ops, name, self)

    def __call__(self, *args, **kw):
        self.calls += 1
        c = self.cells(*args)
        key = "x".join(str(s) for s in args[0].shape)
        self.shapes[key] = self.shapes.get(key, 0) + 1
        cap = self.CAP_CELLS
        if self.best is None or (c <= cap and (c > self.best_cells
                                               or self.best_cells > cap)) \
                or (c > cap and self.best_cells > cap
                    and c < self.best_cells):
            self.best_cells = c
            self.best = [a.clone() if hasattr(a, "clone") else a for a in args]
        return self.fn(*args, **kw)

    def restore(self) -> None:
        setattr(self.ops, self.name, self.fn)


class FirstCall:
    """Wraps ``kernels.ops.project_and_bin`` while a path runs: keeps the
    arguments of its first call (references: the callers never write to
    them afterwards) and the width of every call."""

    def __init__(self, ops, name: str):
        self.ops, self.name = ops, name
        self.fn = getattr(ops, name)
        self.first = None
        self.widths: list[float] = []
        setattr(ops, name, self)

    def __call__(self, *args, **kw):
        if self.first is None:
            self.first = args
        self.widths.append(args[2])
        return self.fn(*args, **kw)

    def restore(self) -> None:
        setattr(self.ops, self.name, self.fn)


def kernel_modules():
    from repro_torch.kernels import (diameter, flash_attention, pairwise_l2,
                                     project_bin)
    return pairwise_l2, diameter, project_bin, flash_attention


def reset_all() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


def launch_counts() -> dict:
    out = {}
    for mod in kernel_modules():
        out.update(mod.launches)
    return out


def drive_path(by_path: dict, path: str, fn):
    """Run one path with the launch counters set to 0 just before it and
    read just after (into ``by_path[path]``); returns (result, wall)."""
    import torch
    torch.cuda.synchronize()
    reset_all()
    ts = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - ts
    by_path[path] = launch_counts()
    return out, wall


def index_equal(got, want, label: str) -> None:
    """Two ProMiSH indices equal array for array, dtypes included."""
    import numpy as np
    check((got.w0, got.p_max, got.n_scales, got.exact)
          == (want.w0, want.p_max, want.n_scales, want.exact),
          f"{label}: w0/p_max/scales differ")
    check(np.array_equal(got.z, want.z), f"{label}: z differs")
    for a, b in zip(got.structures, want.structures):
        check((a.width, a.n_buckets) == (b.width, b.n_buckets),
              f"{label}: scale {a.scale} geometry differs")
        for part in ("table", "khb"):
            x, y = getattr(a, part), getattr(b, part)
            for arr in ("offsets", "values"):
                u, v = getattr(x, arr), getattr(y, arr)
                check(u.dtype == v.dtype and np.array_equal(u, v),
                      f"{label}: scale {a.scale} {part}.{arr} differs")


def tuple_cells(pts, *_):
    return pts.shape[0] * pts.shape[1] * pts.shape[2]


def batched_cells(x, *_):
    return x.shape[0] * x.shape[1] * x.shape[1]


def pair_cells(a, b, *_):
    return a.shape[0] * b.shape[0]


def self_sq64(x):
    """float64 squared distances of a (S, P, d) tile (difference-free but in
    float64, whose error is ~1e-16 of the norms: far inside the fp32 band)."""
    x64 = x.double()
    n2 = (x64 * x64).sum(-1)
    return (n2[:, :, None] + n2[:, None, :]
            - 2.0 * x64 @ x64.transpose(1, 2)).clamp_min(0.0), n2


def band_check_batched(x, lengths, r, got_counts, want_counts,
                       got_mask=None, want_mask=None, bf16=False, elig=None):
    """Masks equal off the fp32 boundary band; counts within the band size.
    With eligibility words ``elig`` the band holds eligible pairs only.
    Returns (max |count diff|, differing mask bits)."""
    import torch
    from repro_torch.kernels import ref
    s, p, d = x.shape
    xx = x.to(torch.bfloat16).float() if bf16 else x
    el = None if elig is None else ref.unpack_bits(elig, p)     # (S, P)
    diff_counts = (got_counts.long() - want_counts.long()).abs()
    bits = 0
    step = max(1, (1 << 26) // max(p * p, 1))      # bound the float64 block
    for s0 in range(0, s, step):
        sl = slice(s0, min(s, s0 + step))
        d2, n2 = self_sq64(xx[sl])
        live = torch.arange(p, device=x.device)[None, :] \
            < lengths[sl].long()[:, None]
        sq_live = live[:, :, None] & live[:, None, :]
        norm2 = torch.where(live, n2, torch.zeros_like(n2)).amax(dim=1)
        tol = (64.0 + 4.0 * d) * EPS32 * norm2
        r2 = r[sl].double() ** 2
        band = sq_live & ((d2 - r2[:, None, None]).abs()
                          <= tol[:, None, None])
        if el is not None:
            band &= el[sl][:, :, None] & el[sl][:, None, :]
        band_n = band.sum(dim=(1, 2))
        check(bool((diff_counts[sl] <= band_n).all()),
              "counts differ beyond the boundary band")
        if got_mask is not None:
            off = ref.unpack_bits(got_mask[sl], p) \
                != ref.unpack_bits(want_mask[sl], p)
            bits += int(off.sum())
            check(not bool((off & ~band).any()),
                  "mask bits differ off the boundary band")
    return int(diff_counts.max()) if s else 0, bits


def self_join_work(x, lengths) -> tuple[float, float]:
    """(operations, input bytes) a batched self-join needs: 2d flops per
    distinct pair of live points (the Gram matrix is symmetric) and per
    squared norm, and each live point's d fp32 coordinates read once."""
    d = x.shape[2]
    lens = lengths.double()
    flops = 2.0 * d * float((lens * (lens + 1) / 2).sum() + lens.sum())
    return flops, float(lens.sum()) * d * 4 + lengths.numel() * 8


def launch_path(name: str, by_path: dict) -> str:
    """The first path (in the order driven) on which kernel ``name``
    launched."""
    for path, counts in by_path.items():
        if counts[name] > 0:
            return path
    raise SmokeError(f"kernel {name} launched on no path")


def row_launches(name: str, by_path: dict) -> dict:
    path = launch_path(name, by_path)
    return dict(launches=by_path[path][name], path=path,
                launches_by_path={p: c[name] for p, c in by_path.items()})


def masked_row(rec, by_path: dict, profiles: KernelProfiles,
               elig: bool = False) -> dict:
    """K1 at the recorded input (with its eligibility words when ``elig``)
    against its plain version: masks equal off the fp32 band, counts within
    it, and the mask symmetric bit for bit (the kernel computes the upper
    triangle of tiles and mirrors it)."""
    import torch
    from repro_torch.kernels import pairwise_l2 as K
    from repro_torch.kernels import ref
    x, lengths, r = rec.best[:3]
    words = rec.best[3] if elig else None
    check(not elig or words is not None,
          "the recorded K1 input carries no eligibility words")
    s, p, d = x.shape
    m_k, c_k = K.join_batched_masked(x, lengths, r, words)
    m_p, c_p = ref.join_batched_masked(x, lengths, r, words)
    torch.cuda.synchronize()
    err, bits = band_check_batched(x, lengths, r, c_k, c_p, m_k, m_p,
                                   elig=words)
    for si in range(s):
        b = ref.unpack_bits(m_k[si], p)
        check(bool((b == b.T).all()),
              f"K1: the mask of subset {si} is not symmetric")
    flops, in_bytes = self_join_work(x, lengths)
    extra = words.numel() * 4 if elig else 0
    b_ms, b_by = bound(flops, in_bytes + extra + m_k.numel() * 4 + s * 4,
                       PEAK_FP32_FLOPS)
    name = "join_batched_masked"
    row = dict(
        name=name + (" (elig)" if elig else ""), route="cuda",
        source="src/repro_torch/kernels/csrc/pairwise_l2.cu",
        replaces="src/repro/kernels/pairwise_l2.py:368",
        **row_launches(name + ("_elig" if elig else ""), by_path),
        max_abs_err=err, mask_bits_in_band=bits, symmetric=True,
        shape=[s, p, d], lengths=lengths.tolist(),
        ms=cuda_ms(lambda: K.join_batched_masked(x, lengths, r, words), 20),
        plain_ms=cuda_ms(lambda: ref.join_batched_masked(x, lengths, r,
                                                         words), 3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    profiles.add("K1" + (" (elig)" if elig else ""),
                 "pairwise_l2.join_batched_masked", (x, lengths, r, words),
                 "triangle_join_kernel", "join_batched_masked", 20, row)
    return row


def sass_ops(lib: str, kernel: str, ops: tuple[str, ...]) -> list | None:
    """Which of ``ops`` ``cuobjdump -sass`` of the built ``lib`` shows in the
    function whose name holds ``kernel`` (None where the toolkit has no
    cuobjdump)."""
    from repro_torch.kernels import build
    tool = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(build.library_path(lib))],
                         capture_output=True, text=True, timeout=300)
    for part in out.stdout.split("Function : ")[1:]:
        if kernel in part.split("\n", 1)[0]:
            return [op for op in ops if op in part]
    return []


def sass_has(lib: str, kernel: str, op: str) -> bool | None:
    """Whether ``op`` is in the SASS of ``kernel`` (see :func:`sass_ops`)."""
    found = sass_ops(lib, kernel, (op,))
    return None if found is None else bool(found)


def bf16_library_counts(x, lengths, r, words):
    """K2's yardstick, a library composition of the same counts: the points
    rounded to bf16, ``torch.bmm`` (cuBLAS, fp32 accumulation, a bf16
    product), then the norms, the threshold and the count in torch ops. The
    product's bf16 rounding may move pairs at the threshold."""
    import torch
    from repro_torch.kernels import ref
    xb = x.to(torch.bfloat16)
    g = torch.bmm(xb, xb.transpose(1, 2)).float()
    xf = xb.float()
    n = (xf * xf).sum(-1)
    sq = n[:, :, None] + n[:, None, :] - 2.0 * g
    _, live = ref._live_rows(lengths, x.shape[1], words)
    joined = (sq <= (r * r)[:, None, None]) & live[:, :, None] \
        & live[:, None, :]
    return joined.sum(dim=(1, 2), dtype=torch.int32)


def int8_library_counts(x, lengths, r, words):
    """K2i's yardstick, a library composition of the same counts: the
    per-subset quantisation in torch ops (``kernels.ref.quantize_int8``,
    the same roundings), ``torch._int_mm`` (cuBLASLt's int8 product into
    int32) on each subset's int8 rows, then the threshold count. Raises
    where ``_int_mm`` refuses the shape."""
    import torch
    from repro_torch.kernels import ref
    s, p, d = x.shape
    q, scale = ref.quantize_int8(x)
    q8 = q.to(torch.int8)
    n2 = (q * q).sum(-1, dtype=torch.int32)
    thr = ref.int8_threshold(scale, r, d)
    _, live = ref._live_rows(lengths, p, words)
    out = []
    for i in range(s):
        g = torch._int_mm(q8[i], q8[i].t())
        sq = n2[i, :, None] + n2[i, None, :] - 2 * g
        joined = (sq <= thr[i]) & live[i, :, None] & live[i, None, :]
        out.append(joined.sum(dtype=torch.int32))
    return torch.stack(out)


def prune_row(rec, by_path: dict, profiles: KernelProfiles,
              elig: bool = False) -> dict:
    """K2 at the recorded input (with its eligibility words when ``elig``)
    against its plain version: counts within the bf16 tile's band, and its
    SASS holds the tensor cores' HGMMA."""
    import torch
    from repro_torch.kernels import pairwise_l2 as K
    from repro_torch.kernels import ref
    x, lengths, r = rec.best[:3]
    words = rec.best[3] if elig else None
    check(not elig or words is not None,
          "the recorded K2 input carries no eligibility words")
    s, p, d = x.shape
    k_k = K.join_batched_prune(x, lengths, r, words)
    k_p = ref.join_batched_counts(x, lengths, r, words)
    torch.cuda.synchronize()
    err, _ = band_check_batched(x, lengths, r, k_k, k_p, bf16=True,
                                elig=words)
    # bf16 x bf16 products accumulated in fp32: the tensor cores' contract
    flops, in_bytes = self_join_work(x, lengths)
    extra = words.numel() * 4 if elig else 0
    b_ms, b_by = bound(flops, in_bytes + extra + s * 4, PEAK_BF16_FLOPS)
    name = "join_batched_prune"
    row = dict(
        name=name + (" (elig)" if elig else ""), route="cuda",
        source="src/repro_torch/kernels/csrc/pairwise_l2.cu",
        replaces="src/repro/kernels/pairwise_l2.py:262",
        **row_launches(name + ("_elig" if elig else ""), by_path),
        max_abs_err=err, shape=[s, p, d], lengths=lengths.tolist(),
        sass_hgmma=sass_has("pairwise_l2", "prune_join_kernel", "HGMMA"),
        ms=cuda_ms(lambda: K.join_batched_prune(x, lengths, r, words), 20),
        plain_ms=cuda_ms(lambda: ref.join_batched_counts(x, lengths, r,
                                                         words), 3, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: bf16_library_counts(x, lengths, r, words),
                           5),
        library="x.to(bfloat16), torch.bmm (cuBLAS) then the norms and a "
                "count in torch ops",
        library_count_diff=int((bf16_library_counts(x, lengths, r, words)
                                - k_k).abs().max()) if s else 0)
    check(row["sass_hgmma"] is not False, "K2's SASS has no HGMMA")
    profiles.add("K2" + (" (elig)" if elig else ""),
                 "pairwise_l2.join_batched_prune", (x, lengths, r, words),
                 "prune_join_kernel", "join_batched_prune", 20, row)
    return row


def prune_int8_row(rec_prune, rec_elig, by_path: dict,
                   profiles: KernelProfiles) -> dict:
    """K2i (``join_batched_prune_int8``) against its plain version, exactly:
    at K2's path input (the prune tier's largest recorded input, its coarse
    radii), at the forced price<50 run's K2 input with its eligibility
    words, and at a seeded d=2304 input. Counts equal the plain version's
    bit for bit and are at least K1's fp32 counts at the same radius; the
    join kernel's SASS holds the tensor cores' integer product (IGMMA) and
    TMA loads (UTMALDG), and ptxas reports no spills in K2i's two kernels.
    Its yardstick (:func:`int8_library_counts`) is timed where ``_int_mm``
    takes the shape, and its counts compared."""
    import torch
    from repro_torch.kernels import pairwise_l2 as K
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(7)
    x24 = torch.randn((8, 512, 2304), generator=g, device="cuda")
    l24 = torch.tensor([512, 500, 257, 64, 63, 1, 0, 0], dtype=torch.int32,
                       device="cuda")
    r24 = torch.full((8,), 62.0, device="cuda")    # ~ the median distance
    cases = [("path", *rec_prune.best[:3], None),
             ("path (elig)", *rec_elig.best[:4]),
             ("d2304", x24, l24, r24, None)]
    out = []
    for label, x, lengths, r, words in cases:
        s, p, d = x.shape
        # The plain version is integer PyTorch on the CPU (the card has no
        # integer bmm): it takes host copies of the same inputs.
        host = tuple(t.cpu() if t is not None else None
                     for t in (x, lengths, r, words))
        k_k = K.join_batched_prune_int8(x, lengths, r, words)
        _, k1 = K.join_batched_masked(x, lengths, r, words)
        k_k, k1 = k_k.cpu(), k1.cpu()
        k_p = ref.join_batched_counts_int8(*host)
        check(bool((k_k == k_p).all()), f"K2i {label}: counts "
              f"{k_k.tolist()} differ from the plain version's "
              f"{k_p.tolist()}")
        check(bool((k_k >= k1).all()), f"K2i {label}: counts "
              f"{k_k.tolist()} below K1's {k1.tolist()}")
        # int8 x int8 products summed in int32: the tensor cores' int8 rate;
        # bytes: each live subset's whole padded block (its scale spans it)
        ops_n, _ = self_join_work(x, lengths)
        in_bytes = float((lengths > 0).sum()) * p * d * 4 + s * 8
        extra = words.numel() * 4 if words is not None else 0
        b_ms, b_by = bound(ops_n, in_bytes + extra + s * 4, PEAK_INT8_OPS)
        try:
            lib_counts = int8_library_counts(x, lengths, r, words).cpu()
            lib_ms = cuda_ms(lambda: int8_library_counts(x, lengths, r,
                                                         words), 5)
            lib_note = None
        except RuntimeError as exc:
            lib_counts, lib_ms = None, None
            lib_note = f"torch._int_mm refused the shape: {exc}"
        case = dict(case=label, shape=[s, p, d], lengths=lengths.tolist(),
                    counts=k_k.tolist(), k1_counts=k1.tolist(),
                    max_abs_err=int((k_k - k_p).abs().max()) if s else 0,
                    ms=cuda_ms(lambda: K.join_batched_prune_int8(
                        x, lengths, r, words), 20),
                    plain_ms=host_ms(lambda: ref.join_batched_counts_int8(
                        *host), 2), plain_on="cpu",
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    library_counts_equal=None if lib_counts is None
                    else bool((lib_counts == k_k).all()),
                    library_note=lib_note)
        out.append((case, (x, lengths, r, words)))
    name = "join_batched_prune_int8"
    row = dict(out[0][0], name=name, route="cuda",
               source="src/repro_torch/kernels/csrc/pairwise_l2.cu",
               replaces="src/repro/kernels/ops.py:101",
               **row_launches(name, by_path),
               elig_launches_by_path={p: c[name + "_elig"]
                                      for p, c in by_path.items()},
               library="kernels.ref.quantize_int8 in torch ops, "
                       "torch._int_mm (cuBLASLt) a subset, then a count",
               sass=sass_ops("pairwise_l2", "prune_int8_kernel",
                             ("IGMMA", "UTMALDG", "IMMA", "HGMMA")),
               spills=[ln for ln in ptxas_report("pairwise_l2")
                       if "int8" in ln.split(":")[0] and "spill" in ln],
               cases=[case for case, _ in out])
    check(row["sass"] is None or {"IGMMA", "UTMALDG"} <= set(row["sass"]),
          f"K2i's join SASS lacks IGMMA or UTMALDG: {row['sass']}")
    check(bool(row["spills"]) and all(
        "0 bytes spill stores, 0 bytes spill loads" in ln
        for ln in row["spills"]), f"K2i's kernels spill: {row['spills']}")
    for i, (case, args) in enumerate(out):
        # the kernels' two launches a call: names holding "int8_"
        profiles.add(f"K2i {case['case']}",
                     "pairwise_l2.join_batched_prune_int8", args, "int8_",
                     name, 20, case, *((row,) if i == 0 else ()),
                     parts=("int8_prep_kernel", "prune_int8_kernel"))
    return row


def kernel_rows(rec_mask, rec_prune, rec_pair, by_path,
                profiles: KernelProfiles) -> list[dict]:
    import torch
    from repro_torch.kernels import pairwise_l2 as K
    from repro_torch.kernels import ref
    rows = [masked_row(rec_mask, by_path, profiles),
            prune_row(rec_prune, by_path, profiles)]

    a, b = rec_pair.best[:2]
    (m, d), n = a.shape, b.shape[0]
    sq_k, n_k = K.pairwise_join(a, b)
    sq_p, n_p = ref.pairwise_join(a, b)
    torch.cuda.synchronize()
    norm2 = max(float((a.double() ** 2).sum(-1).max()),
                float((b.double() ** 2).sum(-1).max()))
    err = float((sq_k - sq_p).abs().max())
    check(err <= (64.0 + 4.0 * d) * EPS32 * norm2,
          f"pairwise_join sq differs by {err} beyond the fp32 band")
    check(tuple(n_k.shape) == tuple(n_p.shape) == (-(-m // 128),
                                                     -(-n // 128)),
          f"pairwise_join counts {tuple(n_k.shape)} are not on the "
          f"reference's 128 x 128 grid")
    check(int(n_k.sum()) == int(n_p.sum()) == m * n
          and bool((n_k == n_p).all()),
          "pairwise_join counts at r=inf must cover every pair")
    flops = 2.0 * d * (m * n + m + n)
    nbytes = (m + n) * d * 4 + m * n * 4 + n_k.numel() * 4
    b_ms, b_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
    rows.append(dict(
        name="pairwise_join", route="cuda",
        source="src/repro_torch/kernels/csrc/pairwise_l2.cu",
        replaces="src/repro/kernels/pairwise_l2.py:111",
        **row_launches("pairwise_join", by_path), max_abs_err=err,
        shape=[m, n, d],
        ms=cuda_ms(lambda: K.pairwise_join(a, b), 20),
        plain_ms=cuda_ms(lambda: ref.pairwise_join(a, b), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.cdist(a, b).square(), 20)))
    profiles.add("K3", "pairwise_l2.pairwise_join", (a, b),
                 "pairwise_join_kernel", "pairwise_join", 20, rows[-1])
    return rows


def check_answers(ds, queries, results, tier) -> None:
    import math
    for q, res in zip(queries, results):
        check(len(res.candidates) == 1, f"{tier}: query {q} has "
              f"{len(res.candidates)} answers, want 1")
        c = res.candidates[0]
        check(math.isfinite(c.diameter) and c.diameter >= 0.0,
              f"{tier}: query {q} diameter {c.diameter}")
        covered = set()
        for i in c.ids:
            covered.update(int(v) for v in ds.kw.row(i))
        check(set(q) <= covered, f"{tier}: answer {c.ids} does not cover {q}")


# Float64 rescores of two tied answers may differ by at most this many ulps
# of the larger (the ties recorded so far differ by 0-4).
TIE_ULPS = 8


def ulps_apart(a: float, b: float) -> float:
    """|a - b| in ulps of the larger magnitude (0 where both are 0)."""
    import math
    unit = math.ulp(max(abs(a), abs(b)))
    return abs(a - b) / unit if unit else 0.0


def answer_diff(a, b, rtol: float, ds=None, ties=None, cost=None,
                score=None, partial: bool = False) -> str | None:
    """The first query on which two batches of answers differ (ids, or
    costs/diameters beyond ``rtol``, or scores beyond ``rtol``), described;
    None if they agree. With ``ds`` an answer whose ids differ is a tie when
    the reported costs agree within ``rtol``, both sets cover the query (any
    of its keywords with ``partial``, as m-of-k answers may) and
    their float64 costs rescored from the ids (``cost(query, ids)``, by
    default the diameter by coordinate differences) lie within
    :data:`TIE_ULPS` ulps of each other, and (``score(query, ids)``, the
    covered weight of a scored query) cover equally: the numpy backend
    scores through the norms identity, the torch backend through
    differences, and the two may round two equally tight sets apart. Ties
    are appended to ``ties`` with the ulps between their rescores."""
    if len(a) != len(b):
        return f"{len(a)} answers against {len(b)}"
    cost = cost or (lambda q, ids: rescore(ds, ids))
    for ra, rb in zip(a, b):
        ca = [(c.ids, c.diameter, c.score) for c in ra.candidates]
        cb = [(c.ids, c.diameter, c.score) for c in rb.candidates]
        if len(ca) == len(cb) and all(
                abs(x[1] - y[1]) <= rtol * max(abs(y[1]), 1e-300)
                and (x[2] is None) == (y[2] is None)
                and (x[2] is None
                     or abs(x[2] - y[2]) <= rtol * max(abs(y[2]), 1e-300))
                for x, y in zip(ca, cb)):
            if [c[0] for c in ca] == [c[0] for c in cb]:
                continue
            if ds is not None:
                apart = [ulps_apart(cost(ra.query, x[0]), cost(ra.query, y[0]))
                         if x[0] != y[0] else 0.0 for x, y in zip(ca, cb)]
                if all(covers(ds, ra.query, x[0], partial)
                       and covers(ds, ra.query, y[0], partial)
                       and u <= TIE_ULPS
                       and (score is None or x[0] == y[0]
                            or score(ra.query, x[0]) == score(ra.query, y[0]))
                       for x, y, u in zip(ca, cb, apart)):
                    if ties is not None:
                        ties.append({"query": ra.query, "a": ca, "b": cb,
                                     "ulps": max(apart)})
                    continue
        return f"query {ra.query}: {ca} against {cb}"
    return None


def covers(ds, query, ids, partial: bool = False) -> bool:
    """Whether ``ids`` cover every keyword of ``query`` (with ``partial``,
    at least one: an m-of-k answer covers some of them)."""
    found = set()
    for i in ids:
        found.update(int(v) for v in ds.kw.row(i))
    return bool(set(query) & found) if partial else set(query) <= found


def same_answers(a, b, rtol: float) -> bool:
    return answer_diff(a, b, rtol) is None


def rescore(ds, ids) -> float:
    """float64 diameter of a point set, by coordinate differences."""
    import numpy as np
    x = ds.points[list(ids)].astype(np.float64)
    return float(np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1).max()))


def check_device_answers(ds, queries, results, label: str, k: int,
                         opts=None, eligible=None) -> dict:
    """Every answer covering, finite, ascending, and within the query's band
    of its float64 rescore; with ``opts`` (the exact tier's diameters) the
    first answer in [opt - band, 2 opt + band]. Under a filter the band is
    that of the eligible groups. Returns the largest |rescore - reported| /
    band and the device/opt ratios (float64 rescore over opt, where opt >
    0)."""
    import numpy as np
    from repro_torch.core.device_plane import pack_groups
    from repro_torch.core.distributed import diameter_band
    worst, ratios = 0.0, []
    for i, (q, res) in enumerate(zip(queries, results)):
        cands = res.candidates
        check(1 <= len(cands) <= k, f"{label}: query {q} has {len(cands)} "
              f"answers, want 1..{k}")
        diams = [c.diameter for c in cands]
        check(diams == sorted(diams), f"{label}: query {q} not ascending")
        pg = pack_groups(ds, q, eligible=eligible)
        band = diameter_band(pg.groups, pg.mask)
        for c in cands:
            check(np.isfinite(c.diameter), f"{label}: query {q} diameter "
                  f"{c.diameter}")
            covered = set()
            for p in c.ids:
                covered.update(int(v) for v in ds.kw.row(p))
            check(set(q) <= covered, f"{label}: answer {c.ids} does not "
                  f"cover {q}")
            err = abs(rescore(ds, c.ids) - c.diameter)
            check(err <= band, f"{label}: query {q} answer {c.ids} reports "
                  f"{c.diameter}, float64 rescore differs by {err} > band "
                  f"{band}")
            worst = max(worst, err / band if band else 0.0)
        if opts is not None:
            opt, got = opts[i], cands[0].diameter
            check(opt - band <= got <= 2.0 * opt + band,
                  f"{label}: query {q} device {got} outside [opt - band, "
                  f"2 opt + band] for opt {opt}, band {band}")
            if opt > 0:
                ratios.append(rescore(ds, cands[0].ids) / opt)
    out = {"max_err_over_band": worst}
    if opts is not None:
        out["device_over_opt"] = {
            "n": len(ratios), "median": float(np.median(ratios)),
            "max": float(np.max(ratios)), "min": float(np.min(ratios))} \
            if ratios else None
    return out


def device_report(ds, queries, wall: float, st, rec) -> dict:
    """One device-tier batch: QPS, phases, transfers, the fused anchor-star
    kernel's input shapes (q, R, d: R anchors per query), the distance cells
    the plain version computes (sum of R * R * (q - 1)) and the largest
    anchor group."""
    cells = sum(n * int(key.split("x")[1]) ** 2
                * (int(key.split("x")[0]) - 1)
                for key, n in rec.shapes.items())
    return {"queries": len(queries), "q": len(queries[0]), "wall_s": wall,
            "qps": len(queries) / wall, "phases": st.phases,
            "shard_dispatches": st.shard_dispatches,
            "h2d_bytes": st.h2d_bytes, "d2h_bytes": st.d2h_bytes,
            "star_calls_by_shape": rec.shapes,
            "star_largest": list(rec.best[0].shape), "distance_cells": cells,
            "largest_anchor_group": max(len(ds.points_with(q[0]))
                                        for q in queries)}


def serve(args, report: dict) -> tuple:
    import numpy as np
    import torch
    from repro_torch import NKSEngine, flickr_like_dataset, random_queries
    from repro_torch.core import projection as proj
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.device_plane import pack_groups
    from repro_torch.core.distributed import diameter_band, nks_anchor_topk
    from repro_torch.core.index import build_index, default_n_buckets
    from repro_torch.data.synthetic import attach_attrs
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise_l2 as K

    t0 = time.perf_counter()
    # Attribute columns (price uniform in [0, 100), 8 categories) for the
    # filter phase; they do not enter the index.
    ds = attach_attrs(flickr_like_dataset(n=args.n, u=24_874, t=11, d=64,
                                          seed=args.seed), seed=1)
    t1 = time.perf_counter()
    # The streaming phase compacts this engine: pin its hash geometry
    # (w0 = pMax / 2^L over the seed's projections, one bucket per point)
    # so a fresh engine over the compacted corpus shares it.
    z = proj.sample_unit_vectors(np.random.default_rng(args.seed), 2, ds.dim)
    pinned = dict(m=2, n_scales=5, seed=args.seed,
                  w0=proj.projection_span(proj.project(ds.points, z)) / 32,
                  n_buckets=default_n_buckets(ds.n))
    t1b = time.perf_counter()
    rec_k5 = FirstCall(ops, "project_and_bin")
    try:
        torch.cuda.synchronize()
        reset_all()
        t2a = time.perf_counter()
        engine = NKSEngine(ds, **pinned)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        rec_k5.restore()
    build_launches = launch_counts()
    queries = random_queries(ds, 3, args.queries, seed=args.seed + 1)
    bst = engine.build_stats
    report["setup"] = {"n": ds.n, "d": ds.dim, "u": ds.n_keywords,
                       "dataset_s": t1 - t0, "pin_probe_s": t1b - t1,
                       "engine_build_s": t2 - t2a,
                       "build_split": bst.as_dict(),
                       "build_launches": build_launches,
                       "points_bytes": ds.points.nbytes,
                       "index_bytes": {"exact": engine.index_e.nbytes(),
                                       "approx": engine.index_a.nbytes()},
                       "device_bytes_after_build":
                           torch.cuda.memory_allocated(),
                       "cost_model": dataclasses.asdict(engine.backend._model)
                       if engine.backend._model is not None else None}
    rest = (t2 - t2a) - (bst.t_project_s + bst.t_bin_s + bst.t_settle_s
                         + bst.t_assemble_s + bst.t_copy_s)
    print(f"[build] corpus n={ds.n} d={ds.dim} u={ds.n_keywords}: dataset "
          f"{t1 - t0:.1f}s; engine {t2 - t2a:.3f}s = host projection "
          f"{bst.t_project_s:.3f}s + K5 {bst.t_bin_s:.4f}s ({bst.k5_launches}"
          f" launches) + settlement {bst.t_settle_s:.3f}s (settled per scale "
          f"{bst.settled}) + hash and CSR on the card {bst.t_assemble_s:.3f}s"
          f" + copy back {bst.t_copy_s:.3f}s + upload, cost model and warm-up"
          f" {rest:.3f}s; launches {build_launches}", flush=True)
    check(build_launches["project_and_bin"] == 5,
          f"the engine build launched K5 {build_launches['project_and_bin']}"
          f" times, want 5 (one per scale for both indices)")
    ts = time.perf_counter()
    for index, exact in ((engine.index_e, True), (engine.index_a, False)):
        index_equal(index, build_index(ds, m=2, n_scales=5, exact=exact,
                                       seed=args.seed),
                    f"10^6 {'exact' if exact else 'approx'} index")
    report["setup"]["host_build_s"] = time.perf_counter() - ts
    print(f"[build] both indices equal the host numpy build bit for bit "
          f"(z, w0, p_max, every table and khb); the host build took "
          f"{report['setup']['host_build_s']:.1f}s", flush=True)

    recs = (Recorder(ops, "pairwise_l2_join_batched_masked", batched_cells),
            Recorder(ops, "pairwise_l2_join_batched_counts", batched_cells),
            Recorder(ops, "pairwise_l2_join", pair_cells))
    answers, by_path, diam_recs = {}, {}, {}

    def drive(path, fn):
        return drive_path(by_path, path, fn)

    def batch_report(wall, st):
        return {"wall_s": wall, "qps": len(queries) / wall,
                "phases": st.phases, "cascade": st.cascade,
                "binning": st.binning,
                "fallback_queries": st.fallback_queries,
                "dispatches_per_scale": st.dispatches_per_scale,
                "device_bins": st.device_dispatches,
                "host_bins": st.host_routed_dispatches,
                "h2d_bytes": st.h2d_bytes, "d2h_bytes": st.d2h_bytes}

    backend = engine.backend
    prune_armed = backend._prune_active(ds.dim)
    report["default_backend"] = {"route": backend.route,
                                 "prune_tier": backend.prune_tier,
                                 "prune_armed": prune_armed}
    model = backend._model
    report["default_backend"]["prune_over_dev_cell"] = \
        model.prune_cell_s / model.dev_cell_s
    print(f"[serve] default backend: route {backend.route}, prune tier "
          f"{backend.prune_tier} -> armed {prune_armed}; cost model at "
          f"d={model.d}: dev_cell_s {model.dev_cell_s:.4g}, prune_cell_s "
          f"{model.prune_cell_s:.4g}, prune/dev "
          f"{model.prune_cell_s / model.dev_cell_s:.4f} (armed below 0.7); "
          f"{report['setup']['cost_model']}", flush=True)
    forced = TorchBackend(route="device", prune_tier="on")
    forced.attach(ds.points)                    # upload outside the timing
    # one subset: the largest relevant-point set of the batch's queries (the
    # union of its keywords' postings), cut to 4096 points
    ids = max((np.unique(np.concatenate([ds.points_with(v) for v in q]))
               for q in queries), key=len)[:4096]
    try:
        for tier in ("exact", "approx"):
            answers[tier], wall = drive(tier, lambda: engine.query_batch(
                queries, k=1, tier=tier))
            st = engine.last_batch_stats
            report[tier] = batch_report(wall, st)
            print(f"[serve] {tier}: {len(queries)} queries in {wall:.3f}s = "
                  f"{len(queries) / wall:.2f} QPS; phases {st.phases}; "
                  f"device bins {st.device_dispatches}, host bins "
                  f"{st.host_routed_dispatches}; fallback "
                  f"{st.fallback_queries}; launches {by_path[tier]}",
                  flush=True)
        forced_ans, wall = drive("forced", lambda: engine.query_batch(
            queries, k=1, tier="exact", backend=forced))
        st = engine.last_batch_stats
        report["exact_forced_device_prune"] = batch_report(wall, st)
        print(f"[serve] exact, route=device + prune tier: {wall:.3f}s = "
              f"{len(queries) / wall:.2f} QPS; cascade {st.cascade}; "
              f"launches {by_path['forced']}", flush=True)
        # The default route with the prune tier off, then with a fresh
        # default backend (both with cold tile caches): answers bit for bit
        # the default run's, whether or not auto armed the tier.
        for path, be in (("exact-prune-off", TorchBackend(prune_tier="off")),
                         ("exact-prune-auto", TorchBackend())):
            be.attach(ds.points)
            answers[path], wall = drive(path, lambda: engine.query_batch(
                queries, k=1, tier="exact", backend=be))
            report[path] = batch_report(wall, engine.last_batch_stats)
        print(f"[serve] exact QPS with the prune tier armed by auto "
              f"({prune_armed}) / off / auto on a fresh backend: "
              f"{report['exact']['qps']:.2f} / "
              f"{report['exact-prune-off']['qps']:.2f} / "
              f"{report['exact-prune-auto']['qps']:.2f}; K2 launches "
              f"{by_path['exact']['join_batched_prune']} / "
              f"{by_path['exact-prune-off']['join_batched_prune']} / "
              f"{by_path['exact-prune-auto']['join_batched_prune']}; K1 "
              f"launches {by_path['exact']['join_batched_masked']} / "
              f"{by_path['exact-prune-off']['join_batched_masked']} / "
              f"{by_path['exact-prune-auto']['join_batched_masked']}; "
              f"cascade off {report['exact-prune-off']['cascade']}",
              flush=True)
        # [prune-int8]: the default batch on a backend whose forced prune
        # tier runs the int8 arm (K2i); its cost model is calibrated (K2i
        # and K1 probes) before the path's counters start.
        be8 = TorchBackend(prune_tier="on", prune_dtype="int8")
        be8.attach(ds.points)
        be8.warmup(ds.dim)
        calls0 = recs[1].calls
        answers["exact-prune-int8"], wall = drive(
            "exact-prune-int8", lambda: engine.query_batch(
                queries, k=1, tier="exact", backend=be8))
        st = engine.last_batch_stats
        report["exact-prune-int8"] = batch_report(wall, st)
        n8 = by_path["exact-prune-int8"]
        report["exact-prune-int8"]["dispatches"] = recs[1].calls - calls0
        print(f"[prune-int8] exact, prune tier forced on in int8: {wall:.3f}s"
              f" = {len(queries) / wall:.2f} QPS; cascade {st.cascade}; K2i "
              f"launches {n8['join_batched_prune_int8']} for "
              f"{recs[1].calls - calls0} dispatches (2 kernels a call), "
              f"K2 {n8['join_batched_prune']}, K1 "
              f"{n8['join_batched_masked']}", flush=True)
        check(n8["join_batched_prune_int8"]
              == 2 * (recs[1].calls - calls0) > 0,
              f"K2i launched {n8['join_batched_prune_int8']} kernels for "
              f"{recs[1].calls - calls0} dispatches, not 2 a dispatch")
        one, _ = drive("pairwise", lambda: forced.pairwise(ds.points[ids],
                                                           ds.points[ids]))
        print(f"[serve] backend.pairwise on {len(ids)} points: launches "
              f"{by_path['pairwise']}", flush=True)
        queries9 = random_queries(ds, 9, args.queries, seed=args.seed + 2)
        for path, qs, k in (("device-q3", queries, 1),
                            ("device-q9", queries9, 10)):
            rec = diam_recs[path] = Recorder(ops, "anchor_star", tuple_cells)
            try:
                answers[path], wall = drive(path, lambda: engine.query_batch(
                    qs, k=k, tier="device"))
            finally:
                rec.restore()
            st = engine.last_batch_stats
            report[path] = device_report(ds, qs, wall, st, rec)
            print(f"[device] {path}: {len(qs)} queries of {len(qs[0])} "
                  f"keywords at k={k} in {wall:.4f}s = {len(qs) / wall:.2f} "
                  f"QPS; phases {st.phases}; launches {by_path[path]}; "
                  f"largest anchor-star input (q, R, d) "
                  f"{report[path]['star_largest']}; distance "
                  f"cells {report[path]['distance_cells']}; largest anchor "
                  f"group {report[path]['largest_anchor_group']}",
                  flush=True)
    finally:
        for rec in recs:
            rec.restore()
    by_path["build"] = build_launches
    report["launches_by_path"] = by_path
    report["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    report["recorded_shapes"] = {r.name: r.shapes for r in recs}

    check(by_path["exact"]["join_batched_masked"] > 0,
          "the default exact batch launched no masked join")
    if prune_armed:
        check(by_path["exact"]["join_batched_prune"] > 0,
              "the prune tier is armed but the exact batch launched no prune")
    for name in ("join_batched_masked", "join_batched_prune"):
        check(by_path["forced"][name] > 0,
              f"kernel {name} never launched in the forced run")
    check(by_path["pairwise"]["pairwise_join"] == 1,
          "backend.pairwise did not launch the pairwise join once")
    check(one.shape == (len(ids), len(ids)), "pairwise shape")
    for tier in ("exact", "approx"):
        check_answers(ds, queries, answers[tier], tier)
    check_answers(ds, queries, forced_ans, "exact-forced")
    check([[(c.ids, c.diameter) for c in r.candidates] for r in forced_ans]
          == [[(c.ids, c.diameter) for c in r.candidates]
              for r in answers["exact"]],
          "forced device + prune run differs from the default run")
    check(by_path["exact-prune-int8"]["join_batched_prune_int8"] > 0
          and by_path["exact-prune-int8"]["join_batched_prune"] == 0,
          "the int8 prune tier did not run K2i alone: "
          f"{by_path['exact-prune-int8']}")
    for path in ("exact-prune-off", "exact-prune-auto", "exact-prune-int8"):
        check([[(c.ids, c.diameter) for c in r.candidates]
               for r in answers[path]]
              == [[(c.ids, c.diameter) for c in r.candidates]
                  for r in answers["exact"]],
              f"{path} differs from the default run")
    check(by_path["exact-prune-off"]["join_batched_prune"] == 0,
          "the prune tier is off but the batch launched K2")
    n_cmp = min(args.compare, len(queries))
    for tier in ("exact", "approx"):
        ts = time.perf_counter()
        ref_ans = engine.query_batch(queries[:n_cmp], k=1, tier=tier,
                                     backend="numpy")
        report[tier]["numpy_backend_s"] = time.perf_counter() - ts
        check(same_answers(answers[tier][:n_cmp], ref_ans, 1e-9),
              f"{tier}: torch and numpy backends disagree")
    print(f"[serve] answers: all covering and finite; forced run and the "
          f"prune-off, fresh default and int8 prune runs identical to the "
          f"default; "
          f"first {n_cmp} per tier agree with the numpy backend", flush=True)

    for path, qs in (("device-q3", queries), ("device-q9", queries9)):
        check_star_launches(by_path[path], qs, path)
        check(not any(by_path[path][n] for n in K.launches),
              f"{path}: the device tier launched a join kernel")
    for path in ("exact", "approx", "forced", "exact-prune-off",
                 "exact-prune-auto", "exact-prune-int8", "pairwise"):
        check(by_path[path]["tuple_diameters"] == 0
              and by_path[path]["anchor_star"] == 0,
              f"{path}: a join path launched K6")
    opts = [r.candidates[0].diameter for r in answers["exact"]]
    report["device-q3"]["checks"] = check_device_answers(
        ds, queries, answers["device-q3"], "device-q3", 1, opts)
    report["device-q9"]["checks"] = check_device_answers(
        ds, queries9, answers["device-q9"], "device-q9", 10)
    worst = 0.0
    for q, res in zip(queries[:n_cmp], answers["device-q3"][:n_cmp]):
        pg = pack_groups(ds, q)
        band = diameter_band(pg.groups, pg.mask)
        host = [torch.from_numpy(a) for a in pg]
        on_card = [a.cuda() for a in host]
        (d_c, c_c), (d_h, c_h) = (nks_anchor_topk(*on_card, 1),
                                  nks_anchor_topk(*host, 1))
        check(sorted(set(c_c[0].tolist())) == sorted(set(c_h[0].tolist()))
              == list(res.candidates[0].ids),
              f"device tier on the card and on the CPU disagree on {q}")
        err = abs(float(d_c[0]) - float(d_h[0]))
        check(err <= band, f"device tier on {q}: card {float(d_c[0])} vs CPU "
              f"{float(d_h[0])} beyond the band {band}")
        worst = max(worst, err / band if band else 0.0)
    report["device-q3"]["card_vs_cpu"] = {"queries": n_cmp,
                                         "max_err_over_band": worst}
    for path, qs, k in (("device-q3", queries, 1),
                        ("device-q9", queries9, 10)):
        report[path]["profile"] = prof = device_profile(
            lambda: engine.query_batch(qs, k=k, tier="device"), len(qs),
            path)
        print(f"[device] profiler, {path} again after its launches were "
              f"read: anchor-star events {prof.get('own_events')} for "
              f"{prof.get('own_launches')} launches; device busy "
              f"{prof.get('busy_share')} of {prof.get('wall_s')}s; kernel "
              f"time by kind {prof.get('share_of_kernel_time')}; kernels a "
              f"query {prof.get('kernels_per_query')}; top kernels "
              f"{prof.get('top_kernels_s')}", flush=True)
    report["star_stage_kernels"] = stage_kernels(diam_recs["device-q9"])
    print(f"[device] answers covering, finite, ascending and within the band "
          f"of their float64 rescore: q=3 {report['device-q3']['checks']}, "
          f"q=9 {report['device-q9']['checks']}; first {n_cmp} on the card "
          f"equal the CPU's (max err/band {worst:.4g})", flush=True)
    # What [store] holds the store's engine to: the served engine's indices
    # and answers over the served corpus ([stream] compacts this engine).
    kept = {"index_e": engine.index_e, "index_a": engine.index_a,
            "answers": {p: answers[p] for p in ("exact", "approx",
                                                "device-q3")}}
    return recs, by_path, diam_recs, (engine, ds, queries, pinned, rec_k5,
                                      kept)


def semantics(args, report: dict, served, by_path: dict) -> None:
    """[semantics] Flexible query semantics on the served engine: the
    batch's queries (3 keywords, k=2)
    under the four variants of the reference's semantics bench — classic,
    m-of-k (m=2), weighted (the two lowest keyword ids of the batch boosted
    to 3.0) and scored (m=2) — in the exact and approx tiers, each a path
    of its own on the torch backend and on the numpy backend. Torch answers
    equal the numpy backend's (ids; costs and scores to 1e-9; ties within
    TIE_ULPS of the rescored cost: the weighted cost of
    ``brute_force.weighted_set_cost`` for the weighted variant, the
    geometric diameter otherwise, scored ties with equal coverage); every
    weighted answer's cost equals ``weighted_set_cost`` of its ids to 1e-9
    (the einsum's summation order depends on the table's shape); m-of-k
    answers cover at least m keywords. Degenerate
    semantics (m=3, empty weights) answer bit for bit as classic on each
    route (over the first ``--compare`` queries), a flexible ``query``
    answers bit for bit as its numpy-backend batch of one and as its row of
    the numpy backend's whole batch, and the device tier refuses the
    flexible variants."""
    import numpy as np
    from repro_torch.core.brute_force import weighted_set_cost
    from repro_torch.core.semantics import QuerySemantics

    engine, ds, queries = served[:3]
    qs = queries
    k = 2
    boosted = sorted({v for q in qs for v in q})[:2]
    variants = {"classic": None, "m_of_k": {"m": 2},
                "weighted": {"weights": {v: 3.0 for v in boosted}},
                "scored": {"m": 2, "score": True}}
    out = report["semantics"] = {"queries": len(qs), "k": k,
                                 "boosted": boosted, "runs": {}}
    t_phase = time.perf_counter()
    answers = {}

    def rows(res):
        return [[(c.ids, c.diameter, c.score) for c in r.candidates]
                for r in res]

    for tier in ("exact", "approx"):
        for name, raw in variants.items():
            sem = QuerySemantics.coerce(raw)
            for be in ("torch", "numpy"):
                path = f"sem-{tier}-{name}-{be}"
                answers[(tier, name, be)], wall = drive_path(
                    by_path, path, lambda: engine.query_batch(
                        qs, k=k, tier=tier, backend=be, semantics=raw))
                st = engine.last_batch_stats
                n = by_path[path]
                out["runs"][path] = {
                    "queries": len(qs), "wall_s": wall,
                    "qps": len(qs) / wall, "subqueries": st.subqueries,
                    "phases": st.phases, "cascade": st.cascade,
                    "fallback_queries": st.fallback_queries,
                    "device_bins": st.device_dispatches,
                    "host_bins": st.host_routed_dispatches,
                    "k1_launches": n["join_batched_masked"],
                    "k2_launches": n["join_batched_prune"]}
                print(f"[semantics] {tier} {name} {be}: {len(qs)} queries "
                      f"in {wall:.3f}s = {len(qs) / wall:.2f} QPS; "
                      f"subqueries {st.subqueries}; phases {st.phases}; "
                      f"fallback {st.fallback_queries}; device bins "
                      f"{st.device_dispatches}, host bins "
                      f"{st.host_routed_dispatches}; K1/K2 launches "
                      f"{n['join_batched_masked']}/{n['join_batched_prune']}",
                      flush=True)
                if be == "numpy":
                    check(not any(n.values()), f"{path} launched kernels: {n}")
            got, want = (answers[(tier, name, b)] for b in ("torch", "numpy"))
            wvecs = {tuple(q): sem.weight_vector(ds, q) if sem else None
                     for q in qs}
            m = sem.m if sem is not None and sem.m is not None else 3

            def cost(q, ids):
                return weighted_set_cost(ids, ds, wvecs[tuple(q)])

            score = None
            if sem is not None and sem.score:
                def score(q, ids):
                    return sem.coverage_fn(ds, q)(ids)
            ties = []
            diff = answer_diff(got, want, 1e-9, ds, ties,
                               cost=cost, score=score, partial=m < 3)
            check(diff is None, f"semantics {tier} {name}: torch and numpy "
                  f"backends disagree: {diff}")
            out["runs"][f"sem-{tier}-{name}-torch"]["ties"] = ties
            for be in ("torch", "numpy"):
                for q, r in zip(qs, answers[(tier, name, be)]):
                    check(1 <= len(r.candidates) <= k,
                          f"semantics {tier} {name} {be}: query {q} has "
                          f"{len(r.candidates)} answers")
                    for c in r.candidates:
                        kws = {int(v) for i in c.ids for v in ds.kw.row(i)}
                        check(len(kws & set(q)) >= m,
                              f"semantics {tier} {name} {be}: {c.ids} covers "
                              f"fewer than {m} of {q}")
                        check(np.isfinite(c.diameter), f"semantics {tier} "
                              f"{name} {be}: cost {c.diameter}")
                        check((c.score is not None) == (score is not None),
                              f"semantics {tier} {name} {be}: score "
                              f"{c.score}")
                        if name == "weighted":
                            w = cost(q, c.ids)
                            check(abs(c.diameter - w) <= 1e-9 * max(w, 1e-300),
                                  f"semantics {tier} weighted {be}: {c.ids} "
                                  f"reports {c.diameter}, weighted_set_cost "
                                  f"{w}")
            print(f"[semantics] {tier} {name}: torch equals numpy over "
                  f"{len(qs)} queries ({len(ties)} ties, at most "
                  f"{max([t['ulps'] for t in ties], default=0)} ulps apart)",
                  flush=True)

    # Degenerate semantics are the classic path, bit for bit, on each route
    # (over the first --compare queries: a batch's answers are per query);
    # a flexible query() runs as a numpy-backend batch of one (as the
    # reference's does) and answers as the query's row of the numpy
    # backend's whole batch (the torch backend's costs may differ from it in
    # the last bits, hence answer_diff above); the device tier refuses the
    # flexible variants. qb holds a boosted keyword, so the weights touch it.
    qb = next(q for q in qs if set(q) & set(boosted))
    ib = qs.index(qb)
    n_deg = min(args.compare, len(qs))
    for tier in ("exact", "approx"):
        for be in ("torch", "numpy"):
            classic = rows(answers[(tier, "classic", be)][:n_deg])
            for degen in ({"m": 3}, {"weights": {}}):
                res = engine.query_batch(qs[:n_deg], k=k, tier=tier,
                                         backend=be, semantics=degen)
                check(rows(res) == classic, f"semantics {degen} on {tier} "
                      f"{be} differs from classic")
        for name in ("m_of_k", "weighted", "scored"):
            one = engine.query(qb, k=k, tier=tier, semantics=variants[name])
            batch = engine.query_batch([qb], k=k, tier=tier,
                                       backend="numpy",
                                       semantics=variants[name])
            check(rows([one]) == rows(batch),
                  f"query({tier}, {name}) differs from its batch of one")
            check(rows([one]) == rows([answers[(tier, name, "numpy")][ib]]),
                  f"query({tier}, {name}) differs from its row of the numpy "
                  f"backend's batch")
    for name in ("m_of_k", "weighted", "scored"):
        for call in (lambda: engine.query_batch([qb], k=k, tier="device",
                                                semantics=variants[name]),
                     lambda: engine.query(qb, k=k, tier="device",
                                          semantics=variants[name])):
            try:
                call()
            except ValueError:
                continue
            raise SmokeError(f"the device tier took semantics {name}")
    for name in variants:
        check(by_path[f"sem-exact-{name}-torch"]["join_batched_masked"] > 0,
              f"semantics exact {name}: the torch backend launched no K1")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[semantics] degenerate semantics (m=3, no weights) equal classic "
          f"bit for bit on every route; query() equals its batch of one and "
          f"its row of the whole batch; the device "
          f"tier refuses m-of-k, weighted and scored; phase "
          f"{out['wall_s']:.1f}s", flush=True)


def stream(args, report: dict, served, by_path: dict) -> None:
    """Inserts, deletes and a compaction on the served engine, each a path
    of its own: K5 must launch 5 times per insert batch and per compaction;
    answers on the dirty corpus equal the numpy backend's on the same
    engine, and after compaction a fresh engine's over the compacted corpus;
    the compacted indices equal the host build with the pinned geometry."""
    import numpy as np
    import torch
    from repro_torch import NKSEngine, flickr_like_dataset
    from repro_torch.core.filters import where
    from repro_torch.core.index import build_index
    from repro_torch.data.synthetic import synthetic_attrs

    engine, ds, queries, pinned = served[:4]
    more = flickr_like_dataset(n=args.stream_points, u=24_874, t=11, d=64,
                               seed=args.seed + 7)
    more_attrs = synthetic_attrs(more.n, seed=7)
    n_batches = 8
    bounds = np.linspace(0, more.n, n_batches + 1).astype(int)
    inserted, insert_s = [], 0.0
    total = {}
    for b in range(n_batches):
        lo, hi = bounds[b], bounds[b + 1]
        kws = [more.kw.row(i).tolist() for i in range(lo, hi)]
        ext, wall = drive_path(by_path, f"insert-{b}", lambda: engine.insert(
            more.points[lo:hi], kws,
            attrs={k: v[lo:hi] for k, v in more_attrs.items()}))
        check(by_path[f"insert-{b}"]["project_and_bin"] == 5,
              f"insert batch {b} launched K5 "
              f"{by_path[f'insert-{b}']['project_and_bin']} times, want 5")
        inserted += ext.tolist()
        insert_s += wall
        for name, c in by_path.pop(f"insert-{b}").items():
            total[name] = total.get(name, 0) + c
    by_path["insert"] = total
    rng = np.random.default_rng(args.seed + 8)
    doomed = sorted(rng.choice(ds.n, args.stream_deletes // 2,
                               replace=False).tolist()
                    + rng.choice(inserted, args.stream_deletes
                                 - args.stream_deletes // 2,
                                 replace=False).tolist())
    _, delete_s = drive_path(by_path, "delete",
                             lambda: engine.delete(doomed))
    st = {"inserted": len(inserted), "batches": n_batches,
          "insert_s": insert_s, "insert_points_per_s": len(inserted)
          / insert_s, "deleted": len(doomed), "delete_s": delete_s,
          "delta_points": engine.delta_points,
          "tombstones": engine.tombstone_count}
    print(f"[stream] inserted {len(inserted)} points in {n_batches} batches "
          f"in {insert_s:.3f}s = {len(inserted) / insert_s:.0f} points/s "
          f"(launches {by_path['insert']}); deleted {len(doomed)} (half bulk, "
          f"half delta) in {delete_s:.4f}s (launches {by_path['delete']})",
          flush=True)
    dead = set(doomed)
    # A delete may take the last live holder of a rare keyword: such a
    # query has no covering set, so no answer.
    live = [all(len(engine.dataset.points_with(v)) for v in q)
            for q in queries]
    st["queries_without_live_cover"] = live.count(False)
    for tier in ("exact", "approx"):
        got, wall = drive_path(by_path, f"stream-{tier}",
                               lambda: engine.query_batch(queries, k=1,
                                                          tier=tier))
        ts = time.perf_counter()
        want = engine.query_batch(queries, k=1, tier=tier, backend="numpy")
        numpy_s = time.perf_counter() - ts
        check_answers(engine.dataset,
                      [q for q, ok in zip(queries, live) if ok],
                      [r for r, ok in zip(got, live) if ok], f"stream-{tier}")
        check(not any(r.candidates for r, ok in zip(got, live) if not ok),
              f"stream-{tier}: an answer for a query with no live cover")
        ties = []
        diff = answer_diff(got, want, 1e-9, engine.dataset, ties)
        check(diff is None, f"stream-{tier}: torch and numpy backends "
              f"disagree on the dirty corpus: {diff}")
        check(not any(set(c.ids) & dead for r in got for c in r.candidates),
              f"stream-{tier}: a deleted point answered")
        st[tier] = {"wall_s": wall, "qps": len(queries) / wall,
                    "numpy_backend_s": numpy_s, "ties": ties,
                    "stats": engine.last_batch_stats.ingest}
        print(f"[stream] {tier} on the dirty corpus: {wall:.3f}s = "
              f"{len(queries) / wall:.2f} QPS, equal to the numpy backend "
              f"({numpy_s:.3f}s) but for {len(ties)} exact ties {ties}; "
              f"{engine.last_batch_stats.ingest}", flush=True)
    flt = where(("price", "<", 50.0))
    eligible = flt.evaluate(engine.dataset)
    engine.dataset.mask_tombstones(eligible)
    got, wall = drive_path(by_path, "stream-filter-exact",
                           lambda: engine.query_batch(queries, k=1,
                                                      tier="exact",
                                                      filter=flt))
    filt_st = engine.last_batch_stats.filtering
    want = engine.query_batch(queries, k=1, tier="exact", backend="numpy",
                              filter=flt)
    ties = []
    diff = answer_diff(got, want, 1e-9, engine.dataset, ties)
    check(diff is None, f"stream-filter-exact: torch and numpy backends "
          f"disagree on the dirty corpus: {diff}")
    answered = check_filtered_answers(engine.dataset, queries, got, eligible,
                                      "stream-filter-exact")
    check(filt_st["eligible_points"] == int(eligible.sum()),
          "stream-filter-exact: eligible points differ from the live mask")
    st["filter_exact"] = {"wall_s": wall, "qps": len(queries) / wall,
                          "answered": answered, "filtering": filt_st,
                          "ties": ties,
                          "launches": by_path["stream-filter-exact"]}
    print(f"[stream] exact under price<50 on the dirty corpus (inserts "
          f"carry attributes): {wall:.3f}s = {len(queries) / wall:.2f} QPS, "
          f"answered {answered}, equal to the numpy backend but for "
          f"{len(ties)} ties; filtering {filt_st}; launches "
          f"{by_path['stream-filter-exact']}", flush=True)
    done, compact_s = drive_path(by_path, "compact", engine.compact)
    check(done and engine.corpus_generation == 1, "compaction did not run")
    check(by_path["compact"]["project_and_bin"] == 5,
          f"the compaction launched K5 {by_path['compact']['project_and_bin']}"
          f" times, want 5")
    st["compact_s"] = compact_s
    st["compact_build_split"] = engine.build_stats.as_dict()
    ts = time.perf_counter()
    fresh = NKSEngine(engine.dataset, **pinned)
    st["fresh_engine_s"] = time.perf_counter() - ts
    ext = engine._ext_of
    for tier in ("exact", "approx"):
        got = engine.query_batch(queries, k=1, tier=tier)
        want = fresh.query_batch(queries, k=1, tier=tier)
        check([[(c.ids, c.diameter) for c in r.candidates] for r in got]
              == [[(tuple(int(ext[i]) for i in c.ids), c.diameter)
                   for c in r.candidates] for r in want],
              f"after compaction the {tier} answers differ from a fresh "
              f"engine's")
    del fresh
    torch.cuda.empty_cache()
    ts = time.perf_counter()
    for index, exact in ((engine.index_e, True), (engine.index_a, False)):
        index_equal(index, build_index(engine.dataset, exact=exact, **pinned),
                    f"compacted {'exact' if exact else 'approx'} index")
    st["host_build_s"] = time.perf_counter() - ts
    report["stream"] = st
    print(f"[stream] compaction of {engine.dataset.n} live points in "
          f"{compact_s:.3f}s (launches {by_path['compact']}; split "
          f"{st['compact_build_split']}); answers equal a fresh engine's "
          f"over the compacted corpus ({st['fresh_engine_s']:.2f}s to "
          f"build); compacted indices equal the pinned host build "
          f"({st['host_build_s']:.1f}s)", flush=True)


def keys_of(results) -> list:
    return [[(c.ids, c.diameter) for c in r.candidates] for r in results]


def disk_room(tmp: str, need: float, label: str) -> int:
    """Free bytes of the filesystem holding ``tmp``, printed; fails the run
    when the phase's reckoned bytes (``need``, with a third more for
    headroom) do not fit."""
    import shutil
    free = shutil.disk_usage(tmp).free
    print(f"[{label}] scratch {tmp}: {free} bytes free, the phase needs "
          f"about {int(need)}", flush=True)
    check(free > 1.33 * need, f"[{label}]: {free} bytes free for about "
          f"{int(need)} of leaves")
    return free


def leaf_bytes(ds, kept, synopsis: bool) -> float:
    """The store's leaves as the served corpus and indices reckon them: the
    points, both keyword CSRs, the attribute columns, both indices and, with
    ``synopsis``, counts, radii and two float64 ranges per numeric column
    for every bucket of every scale."""
    total = ds.points.nbytes + ds.kw.nbytes() + ds.ikp.nbytes() \
        + sum(c.nbytes for c in ds.attrs.values())
    for index in (kept["index_e"], kept["index_a"]):
        total += index.nbytes()
        if synopsis:
            total += sum(h.n_buckets * (8 + 16 * len(ds.attrs))
                         for h in index.structures)
    return float(total)


def store_phase(args, report: dict, served, by_path: dict) -> None:
    """[store] ``build_store`` over the served corpus with the served
    engine's pinned geometry and bucket synopses (the card build, K5: 5
    launches; the host synopses; the writes and their fsyncs, timed apart),
    then ``NKSEngine.from_store(mmap=True, resident_budget_bytes=256 MiB)``
    timed to its first answer. The loaded indices equal the served engine's
    bit for bit (synopses apart); the 64 queries in the exact, approx and
    device tiers and the price<50 and category-3 batches answer exactly as
    the served engine did (ids and float64 costs, the default backend), so
    the prunes change nothing. QPS beside the served engine's, the prune
    counters and the cold reads. Scratch space is a fresh temporary
    directory, removed at the end."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import NKSEngine
    from repro_torch.core import store
    from repro_torch.core.filters import where
    from repro_torch.core.index_build import BuildStats

    engine, ds, queries, pinned = served[:4]
    kept = served[5]
    budget = 256 << 20
    tmp = tempfile.mkdtemp(prefix="nks-store-")
    out = {}
    try:
        out["reckoned_bytes"] = leaf_bytes(ds, kept, True)
        out["free_bytes"] = disk_room(tmp, out["reckoned_bytes"], "store")
        root = os.path.join(tmp, "store")
        bst = BuildStats()
        _, build_s = drive_path(by_path, "store-build",
                                lambda: store.build_store(
                                    root, ds, synopsis=True, stats=bst,
                                    **pinned))
        k5 = by_path["store-build"]["project_and_bin"]
        check(k5 == 5, f"build_store launched K5 {k5} times, want 5")
        card_s = bst.t_project_s + bst.t_bin_s + bst.t_settle_s \
            + bst.t_assemble_s + bst.t_copy_s
        out.update(build_s=build_s, build_split=bst.as_dict(),
                   card_build_s=card_s, synopsis_s=bst.t_synopsis_s,
                   write_s=build_s - card_s - bst.t_synopsis_s,
                   store_nbytes=store.store_nbytes(root))
        print(f"[store] build_store over {ds.n} points in {build_s:.3f}s = "
              f"card build {card_s:.3f}s (K5 {k5} launches, settled "
              f"{bst.settled}) + host synopses {bst.t_synopsis_s:.3f}s + "
              f"upload, leaf writes and fsyncs {out['write_s']:.3f}s; "
              f"store_nbytes {out['store_nbytes']} (reckoned "
              f"{int(out['reckoned_bytes'])})", flush=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opened = NKSEngine.from_store(root, mmap=True,
                                      resident_budget_bytes=budget)
        torch.cuda.synchronize()
        out["open_s"] = time.perf_counter() - t0
        check(isinstance(opened.dataset.points, np.memmap)
              and isinstance(opened.index_e.structures[0].table.values,
                             np.memmap),
              "from_store(mmap=True) did not map the points and the tables")
        check(opened.backend.cache_bytes == budget,
              f"resident_budget_bytes did not reach the backend: "
              f"{opened.backend.cache_bytes}")
        for got, want, label in ((opened.index_e, kept["index_e"], "exact"),
                                 (opened.index_a, kept["index_a"],
                                  "approx")):
            index_equal(got, want, f"store {label} index")
            check(all(h.synopsis is not None for h in got.structures),
                  f"store {label} index lost its synopses")
        flts = {"filter:price<50:exact": where(("price", "<", 50.0)),
                "filter:cat3,price20-70:exact": where(
                    ("category", "==", 3),
                    ("price", "between", (20.0, 70.0)))}
        served_qps = {
            "exact": report["exact"]["qps"],
            "approx": report["approx"]["qps"],
            "device-q3": report["device-q3"]["qps"],
            **{k: report["filter"]["results"][k.split(":")[1]]["random"]
               ["exact"]["qps"] for k in flts}}
        batches = [("store-exact", "exact", "exact", None),
                   ("store-approx", "approx", "approx", None),
                   ("store-device", "device-q3", "device", None)] \
            + [(f"store-{k[7:]}", k, "exact", f) for k, f in flts.items()]
        for path, key, tier, flt in batches:
            got, wall = drive_path(by_path, path, lambda: opened.query_batch(
                queries, k=1, tier=tier, filter=flt))
            if path == "store-exact":
                out["first_answer_s"] = out["open_s"] + wall
            st = opened.last_batch_stats
            check(keys_of(got) == keys_of(kept["answers"][key]),
                  f"{path}: the store's engine answers otherwise than the "
                  f"served engine")
            out[path] = {"wall_s": wall, "qps": len(queries) / wall,
                         "served_qps": served_qps[key],
                         "launches": by_path[path],
                         **({} if tier == "device" else
                            {"tiering": st.tiering, "phases": st.phases})}
            print(f"[store] {path}: {len(queries) / wall:.2f} QPS (served "
                  f"engine {served_qps[key]:.2f}); bit for bit the served "
                  f"engine's; tiering "
                  f"{out[path].get('tiering')}; launches {by_path[path]}",
                  flush=True)
        check(by_path["store-exact"]["join_batched_masked"] > 0,
              "the store's exact batch launched no masked join")
        check_star_launches(by_path["store-device"], queries, "store-device")
        print(f"[store] from_store(mmap=True, resident_budget_bytes={budget})"
              f" opened in {out['open_s']:.3f}s (points read off their "
              f"mapped leaf into the card once), first answer after "
              f"{out['first_answer_s']:.3f}s; indices equal the served "
              f"engine's bit for bit, synopses on every scale", flush=True)
        del opened
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["store"] = out


def wal_phase(args, report: dict, served, by_path: dict) -> None:
    """[wal] A fresh engine over the served corpus (``auto_compact=False``),
    ``attach_wal`` (the genesis snapshot) timed, then, each acknowledged op
    fsync'd before it returns: 4 attributed insert batches of 1,250, a
    ``snapshot()`` (it compacts first), 4 batches inside one
    ``ingest_group()`` (one fsync), 1,000 deletes (half bulk, half delta), a
    ``compact()`` and 2 more batches. The answers of the 64 queries in all
    three tiers and of a price<50 batch are recorded, the engine is dropped
    without ``close()``, half a record is appended to the segment (a torn
    tail), and ``NKSEngine.recover`` (timed) must replay exactly the 8 ops
    after the snapshot, report the torn tail, launch K5 5 times a replayed
    insert batch, delete (its bulk rows) and compaction, and answer as the
    uninterrupted engine did, bit for bit."""
    import gc
    import json
    import os
    import shutil
    import tempfile
    import zlib
    import numpy as np
    import torch
    from repro_torch import NKSEngine, flickr_like_dataset
    from repro_torch.core.filters import where
    from repro_torch.data.synthetic import synthetic_attrs
    from repro_torch.serve import wal as walmod

    _, ds, queries, pinned = served[:4]
    kept = served[5]
    per, n_batches = 1_250, 10
    more = flickr_like_dataset(n=per * n_batches, u=24_874, t=11, d=64,
                               seed=args.seed + 9)
    more_attrs = synthetic_attrs(more.n, seed=9)

    def batch(b):
        lo, hi = b * per, (b + 1) * per
        return (more.points[lo:hi], [more.kw.row(i).tolist()
                                     for i in range(lo, hi)],
                {k: v[lo:hi] for k, v in more_attrs.items()})

    tmp = tempfile.mkdtemp(prefix="nks-wal-")
    root = os.path.join(tmp, "wal")
    out = {}
    try:
        # the genesis snapshot, the epoch-1 snapshot and the segments
        out["free_bytes"] = disk_room(tmp, 2 * leaf_bytes(ds, kept, False),
                                      "wal")
        live = NKSEngine(ds, auto_compact=False, **pinned)
        t0 = time.perf_counter()
        live.attach_wal(root)
        out["attach_s"] = time.perf_counter() - t0
        ins_s, inserted = [], []
        for b in range(4):
            t0 = time.perf_counter()
            inserted += live.insert(*batch(b)[:2], attrs=batch(b)[2]).tolist()
            ins_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        live.snapshot()
        out["snapshot_s"] = time.perf_counter() - t0
        f0 = live.wal_stats.fsyncs
        t0 = time.perf_counter()
        group = []
        with live.ingest_group():
            for b in range(4, 8):
                group += live.insert(*batch(b)[:2],
                                     attrs=batch(b)[2]).tolist()
        out["group_s"] = time.perf_counter() - t0
        out["group_fsyncs"] = live.wal_stats.fsyncs - f0
        check(out["group_fsyncs"] == 1, f"the group of 4 inserts issued "
              f"{out['group_fsyncs']} fsyncs, want 1")
        rng = np.random.default_rng(args.seed + 10)
        doomed = sorted(rng.choice(ds.n, 500, replace=False).tolist()
                        + rng.choice(group, 500, replace=False).tolist())
        t0 = time.perf_counter()
        live.delete(doomed)
        out["delete_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        live.compact()
        out["compact_s"] = time.perf_counter() - t0
        for b in range(8, 10):
            t0 = time.perf_counter()
            live.insert(*batch(b)[:2], attrs=batch(b)[2])
            ins_s.append(time.perf_counter() - t0)
        out["insert_s"] = ins_s
        out["insert_fsync_mean_s"] = sum(ins_s) / len(ins_s)
        flt = where(("price", "<", 50.0))
        recorded = {tier: keys_of(live.query_batch(queries, k=1, tier=tier))
                    for tier in ("exact", "approx", "device")}
        recorded["price<50"] = keys_of(live.query_batch(
            queries, k=1, tier="exact", filter=flt))
        out["wal_stats"] = dataclasses.asdict(live.wal_stats)
        out["ingest"] = live.ingest.as_dict()
        seg = walmod.wal_path(root, 1)
        out["segment_bytes"] = os.path.getsize(seg)
        del live                                # no close(): a crash
        gc.collect()
        torch.cuda.empty_cache()
        payload = json.dumps({"op": "delete", "ids": [1, 2, 3]}).encode()
        frame = walmod._FRAME.pack(len(payload), zlib.crc32(payload)) \
            + payload
        with open(seg, "ab") as f:
            f.write(frame[:len(frame) // 2])
        rec, out["recover_s"] = drive_path(
            by_path, "wal-replay", lambda: NKSEngine.recover(root))
        ops = out["ingest"]["wal_appends"]
        out["replayed_ops"] = rec.ingest.replayed_ops
        out["torn_tail"] = rec.wal_stats.torn_tail
        check(rec.ingest.replayed_ops == 8, f"recover replayed "
              f"{rec.ingest.replayed_ops} ops, want the 8 after the snapshot")
        check(rec.wal_stats.torn_tail, "recover saw no torn tail")
        k5 = by_path["wal-replay"]["project_and_bin"]
        # 6 insert batches, the delete's bulk rows, the compaction
        check(k5 == 5 * 8, f"the replay launched K5 {k5} times, want 40")
        for tier in ("exact", "approx", "device"):
            check(keys_of(rec.query_batch(queries, k=1, tier=tier))
                  == recorded[tier], f"[wal] the recovered engine's {tier} "
                  f"answers differ from the uninterrupted engine's")
        check(keys_of(rec.query_batch(queries, k=1, tier="exact",
                                      filter=flt)) == recorded["price<50"],
              "[wal] the recovered engine's price<50 answers differ")
        print(f"[wal] attach_wal (genesis snapshot of {ds.n} points) "
              f"{out['attach_s']:.3f}s; fsync'd insert of {per} points "
              f"{out['insert_fsync_mean_s']:.4f}s on average ({ins_s}); "
              f"snapshot() (compaction first) {out['snapshot_s']:.3f}s; "
              f"4 inserts in one ingest_group() {out['group_s']:.3f}s with "
              f"{out['group_fsyncs']} fsync; 1,000 deletes "
              f"{out['delete_s']:.4f}s; compact() {out['compact_s']:.3f}s; "
              f"{ops} ops logged, segment {out['segment_bytes']} bytes",
              flush=True)
        print(f"[wal] recover with a torn tail: {out['recover_s']:.3f}s, "
              f"replayed {rec.ingest.replayed_ops} ops (torn tail "
              f"{rec.wal_stats.torn_tail}); K5 {k5} launches; exact, approx,"
              f" device and price<50 answers bit for bit the uninterrupted "
              f"engine's; launches {by_path['wal-replay']}", flush=True)
        rec.close()
        del rec
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["wal"] = out


class LargestCalls:
    """Wraps a backend's ``self_join_blocks`` and keeps the arguments of the
    ``KEEP`` calls with the most points in finite-radius subsets (the ones
    the card joins), largest first."""

    KEEP = 8

    def __init__(self, backend):
        self.backend, self.fn = backend, backend.self_join_blocks
        self.calls: list[tuple[int, list, list]] = []
        backend.self_join_blocks = self

    def __call__(self, points, id_lists, radii, **kw):
        import math
        n = sum(len(ids) for ids, r in zip(id_lists, radii)
                if math.isfinite(r))
        if n and (len(self.calls) < self.KEEP or n > self.calls[-1][0]):
            self.calls.append((n, [ids.copy() for ids in id_lists],
                               list(radii)))
            self.calls.sort(key=lambda c: -c[0])
            del self.calls[self.KEEP:]
        return self.fn(points, id_lists, radii, **kw)

    def restore(self) -> None:
        del self.backend.self_join_blocks


def check_filtered_answers(ds, queries, results, eligible, label: str
                           ) -> int:
    """Each query has one answer iff every keyword has an eligible point;
    every answer covers the query with eligible points at a finite
    diameter. Returns the number of answered queries."""
    import math
    answered = 0
    for q, res in zip(queries, results):
        feasible = all(eligible[ds.points_with(v)].any() for v in q)
        check(len(res.candidates) == int(feasible),
              f"{label}: query {q} has {len(res.candidates)} answers, want "
              f"{int(feasible)}")
        for c in res.candidates:
            check(math.isfinite(c.diameter) and c.diameter >= 0.0,
                  f"{label}: query {q} diameter {c.diameter}")
            check(covers(ds, q, c.ids), f"{label}: answer {c.ids} does not "
                  f"cover {q}")
            check(bool(eligible[list(c.ids)].all()),
                  f"{label}: answer {c.ids} holds an ineligible point")
        answered += int(feasible)
    return answered


def feasible_queries(ds, eligible, n: int, seed: int, lo: int = 4,
                     hi: int = 16) -> tuple[list[list[int]], int]:
    """``n`` three-keyword queries drawn from the keywords that hold ``lo``
    to ``hi`` eligible points: every one has an answer under the filter,
    and the eligible work per keyword stays alike across selectivities."""
    import numpy as np
    off, vals = ds.ikp.offsets, ds.ikp.values
    c = np.concatenate([[0], np.cumsum(eligible[vals], dtype=np.int64)])
    per_kw = c[off[1:]] - c[off[:-1]]
    pool = np.flatnonzero((per_kw >= lo) & (per_kw <= hi))
    check(len(pool) >= 3, f"only {len(pool)} keywords hold {lo}..{hi} "
          f"eligible points")
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(pool, size=3, replace=False).tolist())
            for _ in range(n)], len(pool)


def filtered(args, report: dict, served, by_path: dict) -> tuple:
    """[filter] The 64 queries, and per filter 64 more drawn from keywords
    with 4 to 16 eligible points (all feasible), on the served engine under
    four filters: the exact tier (default backend, and forced onto the
    device with the prune tier), the approx tier and the device tier, each
    a path of its own. Answers equal the numpy backend's under the same
    filter (ids; float64 diameters to 1e-9, the stream phase's narrow tie
    acceptance), hold only eligible points, and the device tier's pass the
    covering/band checks against the filtered exact answers; a filter that
    keeps nothing gives empty answers. K1 must launch with eligibility words
    in fold mode, K2 in the forced run; the forced run over the feasible
    queries must dispatch in the filter's packing mode (fold for price<50,
    eligible-dense for the others); a filtered repeat of an unfiltered
    dispatch reads back the same bytes. Returns the Recorders of K1 and K2
    from the forced price<50 run (inputs with their eligibility words)."""
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.filters import where
    from repro_torch.kernels import ops

    engine, ds, queries = served[:3]
    kept = served[5]["answers"]
    filters = {                                 # filter, packing mode
        "price<50": (where(("price", "<", 50.0)), "fold"),
        "price<10": (where(("price", "<", 10.0)), "dense"),
        "price<1": (where(("price", "<", 1.0)), "dense"),
        "cat3,price20-70": (where(("category", "==", 3),
                                  ("price", "between", (20.0, 70.0))),
                            "dense"),
    }
    forced = TorchBackend(route="device", prune_tier="on")
    forced.attach(ds.points)                    # upload outside the timing
    prune_off = TorchBackend(prune_tier="off")  # the default route
    prune_off.attach(ds.points)
    largest = LargestCalls(engine.backend)
    recs = None
    out = {}

    def run_set(name, flt, eligible, qs, prefix):
        nonlocal recs
        rep, answers = {}, {}
        tiers = [("exact", "exact", "torch"),
                 ("exact-forced", "exact", forced),
                 ("approx", "approx", "torch"),
                 ("device", "device", "torch")]
        if prefix == "filter:price<50":
            tiers.insert(1, ("exact-prune-off", "exact", prune_off))
        for tier, t, b in tiers:
            path = f"{prefix}:{tier}"
            record = path == "filter:price<50:exact-forced"
            if record:
                recs = (Recorder(ops, "pairwise_l2_join_batched_masked",
                                 batched_cells),
                        Recorder(ops, "pairwise_l2_join_batched_counts",
                                 batched_cells))
            try:
                answers[tier], wall = drive_path(
                    by_path, path, lambda: engine.query_batch(
                        qs, k=1, tier=t, backend=b, filter=flt))
            finally:
                if record:
                    for rec in recs:
                        rec.restore()
            st = engine.last_batch_stats
            rep[tier] = {"wall_s": wall, "qps": len(qs) / wall,
                         "filtering": st.filtering, "phases": st.phases,
                         "launches": by_path[path]}
            if t != "device":
                rep[tier]["cascade"] = st.cascade
            rep[tier]["answered"] = check_filtered_answers(
                ds, qs, answers[tier], eligible, path)
            if path in ("filter:price<50:exact",
                        "filter:cat3,price20-70:exact"):
                kept[path] = answers[tier]      # for [store]
            print(f"[filter] {prefix[7:]} {tier}: {wall:.3f}s = "
                  f"{len(qs) / wall:.2f} QPS; answered "
                  f"{rep[tier]['answered']} of {len(qs)}; filtering "
                  f"{st.filtering}; launches {by_path[path]}", flush=True)
        for other in ("exact-forced", "exact-prune-off"):
            check(other not in answers
                  or [[(c.ids, c.diameter) for c in r.candidates]
                      for r in answers[other]]
                  == [[(c.ids, c.diameter) for c in r.candidates]
                      for r in answers["exact"]],
                  f"{prefix}: the {other} run differs from the default")
        if "exact-prune-off" in answers:
            off = by_path[f"{prefix}:exact-prune-off"]
            check(off["join_batched_prune"] == 0,
                  f"{prefix}: the prune tier is off but K2 launched")
            print(f"[filter] {prefix[7:]} exact QPS default / prune tier off:"
                  f" {rep['exact']['qps']:.2f} / "
                  f"{rep['exact-prune-off']['qps']:.2f}; K2 launches "
                  f"{by_path[prefix + ':exact']['join_batched_prune']} / "
                  f"{off['join_batched_prune']}; answers identical",
                  flush=True)
        for tier in ("exact", "approx"):
            ts = time.perf_counter()
            want = engine.query_batch(qs, k=1, tier=tier, backend="numpy",
                                      filter=flt)
            ties = []
            diff = answer_diff(answers[tier], want, 1e-9, ds, ties)
            check(diff is None, f"{prefix} {tier}: torch and numpy "
                  f"backends disagree: {diff}")
            rep[tier]["numpy_backend_s"] = time.perf_counter() - ts
            rep[tier]["ties"] = ties
        opts, fq, fres = [], [], []
        for q, ex, dv in zip(qs, answers["exact"], answers["device"]):
            if ex.candidates:
                opts.append(ex.candidates[0].diameter)
                fq.append(q)
                fres.append(dv)
        rep["device"]["checks"] = check_device_answers(
            ds, fq, fres, f"{prefix} device", 1, opts, eligible)
        check_star_launches(by_path[f"{prefix}:device"], fq,
                            f"{prefix}:device")
        print(f"[filter] {prefix[7:]}: exact and approx equal the numpy "
              f"backend ({rep['exact']['numpy_backend_s']:.2f}s, "
              f"{rep['approx']['numpy_backend_s']:.2f}s; ties "
              f"{len(rep['exact']['ties'])}, {len(rep['approx']['ties'])}); "
              f"forced equals default; device answers "
              f"{rep['device']['checks']}", flush=True)
        return rep

    try:
        for name, (flt, mode) in filters.items():
            eligible = flt.evaluate(ds)
            fq, pool = feasible_queries(ds, eligible, len(queries),
                                        args.seed + 3)
            rep = out[name] = {"eligible_points": int(eligible.sum()),
                               "mode": mode, "feasible_pool": pool}
            rep["random"] = run_set(name, flt, eligible, queries,
                                    f"filter:{name}")
            rep["feasible"] = run_set(name, flt, eligible, fq,
                                      f"filter:{name}:feasible")
            check(rep["feasible"]["exact"]["answered"] == len(fq),
                  f"filter {name}: a feasible query went unanswered")
            fst = rep["feasible"]["exact-forced"]["filtering"]
            check(fst[f"{mode}_dispatches"] > 0,
                  f"filter {name}: the forced run over the feasible queries "
                  f"made no {mode} dispatch: {fst}")
            print(f"[filter] {name}: {pool} keywords hold 4..16 eligible "
                  f"points; forced run over the feasible queries: "
                  f"{fst['fold_dispatches']} fold and "
                  f"{fst['dense_dispatches']} eligible-dense dispatches on "
                  f"the card (want {mode})", flush=True)
        nothing = where(("price", "<", -1.0))
        for tier in ("exact", "approx", "device"):
            res = engine.query_batch(queries, k=1, tier=tier, filter=nothing)
            check(all(not r.candidates for r in res),
                  f"filter price<-1 {tier}: an answer from an empty filter")
        print("[filter] price<-1 (keeps nothing): every tier answers "
              "nothing", flush=True)
    finally:
        largest.restore()
    words = {p: {k: c[k] for k in ("join_batched_masked_elig",
                                   "join_batched_prune_elig")}
             for p, c in by_path.items() if p.startswith("filter:")}
    check(words["filter:price<50:exact"]["join_batched_masked_elig"]
          + words["filter:price<50:exact-forced"]["join_batched_masked_elig"]
          > 0, "fold mode (price<50) launched K1 with no eligibility words")
    check(words["filter:price<50:exact-forced"]["join_batched_prune_elig"]
          > 0, "the forced run launched K2 with no eligibility words")
    print(f"[filter] K1/K2 launches with eligibility words (paths with "
          f"any): {({p: w for p, w in words.items() if any(w.values())})}",
          flush=True)

    # No new D2H: the largest call (most points at finite radii) of the
    # phase's default-backend batches whose tiles the backend's cache holds
    # (no eviction in the unfiltered run: the contract is about a repeat of
    # a cached dispatch), unfiltered and then filtered with price<50, on one
    # fresh fold-mode backend.
    evicted = []
    for points, ids, radii in largest.calls:
        keys = [i.tobytes() for i in ids]
        be = TorchBackend(route="device", prune_tier="off",
                          elig_pack_threshold=0.0)
        be.attach(ds.points)
        be.self_join_blocks(ds.points, ids, radii, keys=keys)
        if be.stats.cache_evictions:
            evicted.append(points)
            continue
        h2d0, d2h0 = be.stats.h2d_bytes, be.stats.d2h_bytes
        be.self_join_blocks(ds.points, ids, radii, keys=keys,
                            eligible=filters["price<50"][0].evaluate(ds))
        h2d1, d2h1 = be.stats.h2d_bytes - h2d0, be.stats.d2h_bytes - d2h0
        break
    else:
        raise SmokeError(f"no call of the phase fits the tile cache "
                         f"(points at finite radii {evicted})")
    d2h = {"subsets": len(ids), "points": points,
           "dispatches": be.stats.dispatches // 2,
           "larger_calls_evicted": evicted,
           "unfiltered": {"h2d_bytes": h2d0, "d2h_bytes": d2h0},
           "filtered_repeat": {"h2d_bytes": h2d1, "d2h_bytes": d2h1}}
    check(d2h0 > 0 and d2h1 == d2h0,
          f"eligibility fold changed the readback: {d2h}")
    check(0 < h2d1 < h2d0, f"the filtered repeat re-shipped the tiles: {d2h}")
    report["filter"] = {"filters": {k: v[0].as_json() for k, v in
                                    filters.items()},
                        "results": out, "elig_launches": words,
                        "no_new_d2h": d2h}
    print(f"[filter] no new D2H: {len(ids)} subsets ({points} points at "
          f"finite radii) of the phase's largest backend call whose tiles "
          f"the cache holds (larger ones evicted: {evicted}), unfiltered "
          f"then with price<50 on one fold-mode backend: D2H "
          f"{d2h0} then {d2h1} bytes; H2D {h2d0} then {h2d1} (radii and "
          f"eligibility words only)", flush=True)
    return recs


def tenants(args, report: dict, by_path: dict) -> None:
    """[tenant] A tenant-scoped engine at a reduced size: two tenants of
    ``args.tenant_points`` synthetic points each (d=64, 1,000 local
    keywords, 3 per point). Tenant-local keyword ids resolve, no answer
    reaches another tenant's points, the torch and numpy backends agree,
    and an id outside a tenant's dictionary raises."""
    import numpy as np
    from repro_torch import NKSEngine
    from repro_torch.core.filters import Filter
    from repro_torch.data.synthetic import synthetic_tenants

    sizes = {"acme": args.tenant_points, "globex": args.tenant_points}
    mt = synthetic_tenants(sizes, d=64, u=1_000, t=3, seed=args.seed)
    ts = time.perf_counter()
    eng = NKSEngine(mt, m=2, n_scales=5, seed=args.seed)
    build_s = time.perf_counter() - ts
    ns = mt.tenants
    rng = np.random.default_rng(args.seed + 11)
    out = {"tenants": sizes, "d": 64, "local_keywords": 1_000,
           "engine_build_s": build_s,
           "reduced": f"two tenants of {args.tenant_points:,} points each, "
                      f"not the 10^6-point served corpus"}
    for name in sizes:
        tid = ns.id_of(name)
        lo = int(ns.kw_offsets[tid])
        populated = [v - lo for v in range(lo, int(ns.kw_offsets[tid + 1]))
                     if len(mt.points_with(v))]
        qs = [sorted(rng.choice(populated, 3, replace=False).tolist())
              for _ in range(16)]
        flt = Filter(tenant=name)
        res = {}
        for tier in ("exact", "approx", "device"):
            path = f"tenant:{name}:{tier}"
            res[tier], wall = drive_path(by_path, path, lambda: eng.query_batch(
                qs, k=1, tier=tier, filter=flt))
            out[path] = {"wall_s": wall, "qps": len(qs) / wall,
                         "launches": by_path[path]}
            for q, r in zip(qs, res[tier]):
                check(r.query == q, f"{path}: result echoes {r.query}, "
                      f"not the tenant-local query {q}")
                check(len(r.candidates) == 1, f"{path}: query {q} has "
                      f"{len(r.candidates)} answers")
                for c in r.candidates:
                    check(bool((mt.tenant_of[list(c.ids)] == tid).all()),
                          f"{path}: answer {c.ids} reaches another tenant")
                    check(covers(mt, ns.resolve(name, q), c.ids),
                          f"{path}: answer {c.ids} does not cover {q}")
        for tier in ("exact", "approx"):
            want = eng.query_batch(qs, k=1, tier=tier, backend="numpy",
                                   filter=flt)
            ties = []
            # ties are judged on the global keyword slots
            glob = [dataclasses.replace(r, query=ns.resolve(name, r.query))
                    for r in res[tier]]
            diff = answer_diff(glob, want, 1e-9, mt, ties)
            check(diff is None, f"tenant {name} {tier}: torch and numpy "
                  f"backends disagree: {diff}")
            out[f"tenant:{name}:{tier}"]["ties"] = ties
        print(f"[tenant] {name}: 16 tenant-local queries; exact "
              f"{out[f'tenant:{name}:exact']['qps']:.2f} QPS, approx "
              f"{out[f'tenant:{name}:approx']['qps']:.2f}, device "
              f"{out[f'tenant:{name}:device']['qps']:.2f}; every answer in "
              f"the tenant; torch equals numpy; launches "
              f"{by_path[f'tenant:{name}:exact']}", flush=True)
    try:
        eng.query_batch([[1_000]], tier="exact", filter=Filter(tenant="acme"))
    except ValueError:
        pass
    else:
        raise SmokeError("a keyword id outside the tenant's dictionary was "
                         "served")
    report["tenant"] = out
    print(f"[tenant] cut: {out['reduced']} (engine build {build_s:.2f}s); a "
          f"local id outside the tenant's dictionary raises", flush=True)


def k4_check(x, lengths, r, bm: int, bn: int) -> dict:
    """K4 against its plain version on (x, lengths, r): sq within the fp32
    band on every valid cell, bitwise symmetric on each live square and
    fp32 max exactly outside it; tile counts equal but for cells within the
    band of r^2. Returns the largest error, its share of the band, the
    largest tile-count difference and the band's cells."""
    import torch
    from repro_torch.kernels import pairwise_l2 as K
    from repro_torch.kernels import ref

    s, p, d = x.shape
    sq_k, c_k = K.join_batched_tiles(x, lengths, r, bm=bm, bn=bn)
    sq_p, c_p = ref.join_batched_dense(x, lengths, r, bm=bm, bn=bn)
    torch.cuda.synchronize()
    fmax = torch.finfo(torch.float32).max
    gm, gn = -(-p // bm), -(-p // bn)
    err = over = 0.0
    count_diff = band_total = 0
    for si in range(s):
        n = int(lengths[si])
        valid = torch.arange(p, device=x.device) < n
        cell = valid[:, None] & valid[None, :]
        check(bool(((sq_k[si] == fmax) == ~cell).all())
              and bool(((sq_p[si] == fmax) == ~cell).all()),
              "K4: fp32 max outside the valid square differs")
        blk = sq_k[si, :n, :n]
        check(torch.equal(blk.contiguous().view(torch.int32),
                          blk.T.contiguous().view(torch.int32)),
              f"K4: subset {si}'s live square is not bitwise symmetric")
        d2, n2 = self_sq64(x[si:si + 1])
        norm2 = float(n2[0, :n].max()) if n else 0.0
        tol = (64.0 + 4.0 * d) * EPS32 * norm2
        e = float((sq_k[si] - sq_p[si]).abs()[cell].max()) if n else 0.0
        err, over = max(err, e), max(over, e / tol if tol else 0.0)
        check(e <= tol, f"K4: sq differs by {e} beyond the fp32 band {tol}")
        band = cell & ((d2[0] - float(r[si]) ** 2).abs() <= tol)
        pad = torch.zeros((gm * bm, gn * bn), dtype=torch.int64,
                          device=x.device)
        pad[:p, :p] = band
        band_cells = pad.view(gm, bm, gn, bn).sum(dim=(1, 3))
        diff = (c_k[si].long() - c_p[si].long()).abs()
        check(bool((diff <= band_cells).all()),
              f"K4: subset {si} tile counts differ beyond the band")
        count_diff = max(count_diff, int(diff.max()))
        band_total += int(band.sum())
    return dict(max_abs_err=err, max_err_over_band=over,
                max_tile_count_diff=count_diff, band_cells=band_total,
                symmetric=True)


def k4_row(rec_mask, by_path: dict, profiles: KernelProfiles) -> dict:
    """K4 against its plain version (``k4_check``) on K1's largest path
    input (x, lengths, r) at 128 x 128 count tiles, then timed there and on
    a dense input of the same shape (every length P: all tiles live, the
    kernel's FMA rate). No served path launches it (only
    ``ops.pairwise_l2_join_batched``)."""
    import torch
    from repro_torch.kernels import pairwise_l2 as K
    from repro_torch.kernels import ref

    x, lengths, r = rec_mask.best[:3]
    s, p, d = x.shape
    bm = bn = 128
    checked = k4_check(x, lengths, r, bm, bn)
    for path, counts in by_path.items():
        check(counts["join_batched_tiles"] == 0,
              f"K4 launched on the served path {path}")

    def timing(x, lengths, r) -> dict:
        flops, in_bytes = self_join_work(x, lengths)
        nbytes = s * p * p * 4.0 + in_bytes + s * (-(-p // bm)) \
            * (-(-p // bn)) * 4
        b_ms, b_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
        r2 = r.float() * r.float()

        def library():
            return (torch.cdist(x, x).square() <= r2[:, None, None]).sum(
                (1, 2))
        return dict(
            ms=cuda_ms(lambda: K.join_batched_tiles(x, lengths, r), 20),
            plain_ms=cuda_ms(lambda: ref.join_batched_dense(x, lengths, r),
                             3, warmup=1),
            library_ms=cuda_ms(library, 20), bound_ms=b_ms, bound_by=b_by,
            bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
            ops_ms=flops / PEAK_FP32_FLOPS * 1e3, flops=flops)

    row = dict(name="join_batched_tiles", route="cuda",
               source="src/repro_torch/kernels/csrc/pairwise_l2.cu",
               replaces="src/repro/kernels/pairwise_l2.py:175",
               launches=0, path=None,
               launches_by_path={p_: c["join_batched_tiles"]
                                 for p_, c in by_path.items()},
               **checked, shape=[s, p, d], tile=[bm, bn],
               lengths=lengths.tolist(), **timing(x, lengths, r),
               library="torch.cdist(x, x).square() then a count")
    # every subset full: seeded points, radii near the median distance
    gen = torch.Generator(device=x.device).manual_seed(1)
    xd = torch.rand((s, p, d), generator=gen, device=x.device) * 100.0
    ld = torch.full((s,), p, dtype=torch.int32, device=x.device)
    rd = torch.full((s,), 100.0 * (d / 6.0) ** 0.5, device=x.device)
    dense = dict(shape=[s, p, d], lengths=ld.tolist(),
                 **k4_check(xd, ld, rd, bm, bn), **timing(xd, ld, rd))
    row["dense"] = dense
    profiles.add("K4", "pairwise_l2.join_batched_tiles", (x, lengths, r),
                 "batched_tiles_kernel", "join_batched_tiles", 20, row,
                 bm=bm, bn=bn)
    profiles.add("K4 dense", "pairwise_l2.join_batched_tiles", (xd, ld, rd),
                 "batched_tiles_kernel", "join_batched_tiles", 20, dense,
                 bm=bm, bn=bn)
    for label, t in (("path", row), ("dense", dense)):
        print(f"[K4] join_batched_tiles {label} {t['shape']} lengths "
              f"{t['lengths']} tiles {bm}x{bn}: {t['ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f} ms, cdist + count {t['library_ms']:.4f} "
              f"ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']}: bytes "
              f"{t['bytes_ms']:.4f} ms, fp32 operations {t['ops_ms']:.4f} "
              f"ms); max |sq - plain| {t['max_abs_err']} "
              f"({t['max_err_over_band']:.3g} of the band); tile counts "
              f"differ by at most {t['max_tile_count_diff']} "
              f"({t['band_cells']} cells in the band); bitwise symmetric",
              flush=True)
    print("[K4] launches on every served path 0 (no engine path calls it, "
          "as in the reference)", flush=True)
    return row


def k5_row(cases, launches_by_path: dict, profiles: KernelProfiles) -> dict:
    """K5 against its plain version on the path's inputs (label, x, z,
    widths): p within 2 gamma_d |x|_2 of the plain p, bins equal except
    inside the settlement margin, where they may be 1 apart. Timings with
    CUDA events at the first width; the row's numbers are the first case's."""
    import numpy as np
    import torch
    from repro_torch.core import index_build
    from repro_torch.core.projection import DEFAULT_C
    from repro_torch.kernels import project_bin as P
    from repro_torch.kernels import ref

    rows = []
    for label, x, z, widths in cases:
        n, d = x.shape
        m = z.shape[0]
        err = over = 0.0
        differ = near_edge = 0
        for w in widths:
            got = P.project_and_bin(x, z, w, DEFAULT_C)
            want = ref.project_and_bin(x, z, w, DEFAULT_C)
            torch.cuda.synchronize()
            margin = index_build.margin_scale(x)[:, None] \
                / float(np.float32(w))
            dp = (got[2] - want[2]).abs()
            err = max(err, float(dp.max()))
            over = max(over, float((dp / (margin * w)).max()))
            check(bool((dp <= margin * w).all()),
                  f"K5 {label} w={w}: p differs from the plain version "
                  f"beyond the dot-product bound")
            inv_w, half_w, _ = (torch.tensor(c, device=x.device)
                                for c in ref.bin_constants(w, DEFAULT_C))
            for g, e, v in ((got[0], want[0], want[2] * inv_w),
                            (got[1], want[1], (want[2] - half_w) * inv_w)):
                off = g != e
                near = (v - v.round()).abs() <= margin + 8 * 2.0 ** -24 \
                    * (v.abs() + 1)
                check(int((g.long() - e.long()).abs().max()) <= 1
                      and not bool((off & ~near).any()),
                      f"K5 {label} w={w}: bins differ outside the margin")
                differ += int(off.sum())
                near_edge += int(near.sum())
        w = widths[0]
        inv_w, half_w, _ = (torch.tensor(c, device=x.device)
                            for c in ref.bin_constants(w, DEFAULT_C))

        def library():
            p = torch.matmul(x, z.T)
            return torch.floor(p * inv_w), torch.floor((p - half_w) * inv_w)
        nbytes = (n * d + m * d + 3 * n * m) * 4.0
        flops = 2.0 * n * m * d
        b_ms, b_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
        rows.append(dict(
            case=label, shape=[n, d, m], widths=list(widths),
            max_abs_err=err, max_err_over_bound=over, bins_differ=differ,
            entries_in_margin=near_edge,
            ms=cuda_ms(lambda: P.project_and_bin(x, z, w, DEFAULT_C), 20),
            plain_ms=cuda_ms(lambda: ref.project_and_bin(x, z, w, DEFAULT_C),
                             20),
            library_ms=cuda_ms(library, 20), bound_ms=b_ms, bound_by=b_by,
            bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
            ops_ms=flops / PEAK_FP32_FLOPS * 1e3))
        r = rows[-1]
        print(f"[K5] project_and_bin {label} {r['shape']} at {len(widths)} "
              f"widths: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"matmul + two floors {r['library_ms']:.4f} ms, bound "
              f"{b_ms:.5f} ms by {b_by}: bytes {r['bytes_ms']:.5f} ms, fp32 "
              f"operations {r['ops_ms']:.5f} ms); max |p - plain| {err} "
              f"({over:.3g} of the bound); bins differing {differ} of "
              f"{near_edge} entries in the margin", flush=True)
    main_case = rows[0]
    row = dict(name="project_and_bin", route="cuda",
               source="src/repro_torch/kernels/csrc/project_bin.cu",
               replaces="src/repro/kernels/project_bin.py:52",
               launches=launches_by_path["build"], path="build",
               launches_by_path=launches_by_path,
               max_abs_err=max(r["max_abs_err"] for r in rows),
               shape=main_case["shape"], ms=main_case["ms"],
               plain_ms=main_case["plain_ms"],
               bound_ms=main_case["bound_ms"],
               bound_by=main_case["bound_by"],
               library_ms=main_case["library_ms"],
               library="torch.matmul(x, z.T) then the two floor passes",
               cases=rows)
    for (label, x, z, widths), case in zip(cases, rows):
        targets = (case, row) if case is main_case else (case,)
        profiles.add(f"K5 {label}", "project_bin.project_and_bin",
                     (x, z, widths[0], DEFAULT_C), "project_bin_kernel",
                     "project_and_bin", 20, *targets)
    return row


class ShapeRecorder:
    """Wraps ``kernels.ops.flash_attention`` during the embed path: counts
    calls per q shape and keeps a copy of the first (q, k, v) of each."""

    def __init__(self, ops):
        self.ops, self.fn = ops, ops.flash_attention
        self.calls: dict[tuple, int] = {}
        self.first: dict[tuple, tuple] = {}
        ops.flash_attention = self

    def __call__(self, q, k, v, **kw):
        key = tuple(q.shape)
        self.calls[key] = self.calls.get(key, 0) + 1
        if key not in self.first:
            self.first[key] = (q.clone(), k.clone(), v.clone())
        return self.fn(q, k, v, **kw)

    def restore(self) -> None:
        self.ops.flash_attention = self.fn


def live_pairs(s: int, t: int, causal: bool, window) -> int:
    """(query, key) pairs the attention mask leaves live, per (batch, head)."""
    i = range(s)
    hi = [min(t, q + 1) if causal else t for q in i]
    lo = [max(0, q - window + 1) if window else 0 for q in i]
    return sum(max(0, h - lo_) for h, lo_ in zip(hi, lo))


def attention_flops(b, s, h, hd, t=None, causal=True, window=None) -> float:
    """QK^T and PV over the live pairs: 4 hd flops per pair."""
    return 4.0 * hd * b * h * live_pairs(s, s if t is None else t, causal,
                                         window)


def embed(args, report: dict) -> tuple:
    import numpy as np
    import torch
    from repro_torch import NKSEngine, flickr_like_dataset, random_queries
    from repro_torch.configs import get_config
    from repro_torch.kernels import diameter as D
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.core.index import build_index
    from repro_torch.kernels import pairwise_l2 as K
    from repro_torch.kernels import project_bin as P
    from repro_torch.kernels import ref
    from repro_torch.models.api import model_api

    cfg = get_config("minicpm-2b")
    api = model_api(cfg)
    hd = cfg.resolved_head_dim
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for layer in params["layers"]
                   for part in layer.values() for t in part.values()) \
        + sum(t.numel() for t in params["final_norm"].values())

    rng = np.random.default_rng(args.seed)
    groups = [(args.embed_docs, 512, 32), (args.embed_long_docs, 4096, 2)]
    batches = []
    for n_docs, seq, bsz in groups:
        toks = rng.integers(0, cfg.vocab_size, (n_docs, seq))
        batches += [{"tokens": toks[i:i + bsz]}
                    for i in range(0, n_docs, bsz)]
    n_docs = sum(g[0] for g in groups)
    tokens = sum(g[0] * g[1] for g in groups)
    tags = flickr_like_dataset(n=n_docs, d=1, u=1_000, t=3, seed=args.seed)
    keywords = [tags.kw.row(i).tolist() for i in range(n_docs)]
    attn = cfg.n_layers * sum(
        attention_flops(*b["tokens"].shape, cfg.n_heads, hd) for b in batches)
    model_flops = 2.0 * n_params * tokens + attn

    embed_s = [0.0]

    def timed_embed(p, batch):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        out = api.embed(p, batch)
        torch.cuda.synchronize()
        embed_s[0] += time.perf_counter() - ts
        return out

    rec = ShapeRecorder(ops)
    rec_k5 = FirstCall(ops, "project_and_bin")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FA.reset_launches()
        reset_all()
        ts = time.perf_counter()
        engine = NKSEngine.ingest_embeddings(
            dataclasses.replace(api, embed=timed_embed), params, batches,
            keywords, m=2, n_scales=5, seed=args.seed)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - ts
        k7 = FA.launches["flash_attention"]
        ingest_joins = dict(K.launches)
        k5 = P.launches["project_and_bin"]
    finally:
        rec.restore()
        rec_k5.restore()
    peak = torch.cuda.max_memory_allocated()
    mfu = model_flops / embed_s[0] / PEAK_BF16_FLOPS
    points = engine.dataset.points
    emb = {"model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "head_dim": hd, "docs": n_docs,
           "tokens": tokens, "batches": len(batches),
           "non_embedding_params": n_params, "init_s": init_s,
           "embed_s": embed_s[0], "tokens_per_s": tokens / embed_s[0],
           "model_flops": model_flops, "attention_flops": attn,
           "model_flop_share": mfu,
           "engine_build_s": ingest_s - embed_s[0],
           "k7_launches": k7, "k7_calls_by_shape":
               {"x".join(map(str, k)): c for k, c in rec.calls.items()},
           "join_launches_in_build": ingest_joins,
           "peak_device_bytes": peak,
           "cost_model": dataclasses.asdict(engine.backend._model)}
    report["embed"] = emb
    print(f"[embed] {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}x{hd} heads): {n_docs} documents, "
          f"{tokens} tokens in {len(batches)} batches; weights {init_s:.1f}s",
          flush=True)
    print(f"[embed] embed wall {embed_s[0]:.3f}s = {tokens / embed_s[0]:.0f} "
          f"tokens/s; model-FLOP share {mfu:.4f} of {PEAK_BF16_FLOPS:.3g} "
          f"FLOP/s ({model_flops:.4g} FLOP, attention {attn:.4g}); K7 "
          f"launches {k7} by shape {emb['k7_calls_by_shape']}; peak device "
          f"memory {peak} bytes; engine build (index, upload, cost model at "
          f"d={cfg.d_model}) {ingest_s - embed_s[0]:.3f}s", flush=True)
    model = engine.backend._model
    emb["prune_over_dev_cell"] = model.prune_cell_s / model.dev_cell_s
    print(f"[embed] cost model at d={model.d}: dev_cell_s "
          f"{model.dev_cell_s:.4g}, prune_cell_s {model.prune_cell_s:.4g}, "
          f"prune/dev {emb['prune_over_dev_cell']:.4f} -> prune tier armed "
          f"{engine.backend._prune_active(model.d)}", flush=True)

    check(k7 == cfg.n_layers * len(batches),
          f"K7 launched {k7} times, want {cfg.n_layers} x {len(batches)}")
    check(k5 == 5, f"the embedded corpus's build launched K5 {k5} times, "
          f"want 5")
    for index, exact in ((engine.index_e, True), (engine.index_a, False)):
        index_equal(index, build_index(engine.dataset, m=2, n_scales=5,
                                       exact=exact, seed=args.seed),
                    f"embedded {'exact' if exact else 'approx'} index")
    emb["k5_launches"] = k5
    emb["build_split"] = engine.build_stats.as_dict()
    print(f"[build] embedded corpus {points.shape}: K5 launched {k5} times "
          f"(d={cfg.d_model}); build split {emb['build_split']}; both "
          f"indices equal the host numpy build bit for bit", flush=True)
    check(points.shape == (n_docs, cfg.d_model), f"points {points.shape}")
    check(bool(np.isfinite(points).all()), "non-finite embedding")
    distinct = len(np.unique(points, axis=0))
    check(distinct == n_docs, f"only {distinct} distinct embeddings of "
          f"{n_docs}")

    prof = profile_embed(api, params, batches[:4])
    emb["profile"] = prof
    if prof:
        print(f"[embed] profiler, {prof['batches']} batches of 32x512: K7 "
              f"events {prof['own_events']} for {prof['own_launches']} "
              f"launches; device busy {prof['busy_share']} of "
              f"{prof['wall_s']:.3f}s; kernel time by kind "
              f"{prof['share_of_kernel_time']}", flush=True)
    else:
        print("[embed] profiler saw no device time", flush=True)
    emb["geometry"] = corpus_geometry(points, cfg.d_model,
                                      engine.backend.device)
    print(f"[embed] corpus geometry {emb['geometry']}", flush=True)

    queries = random_queries(engine.dataset, 3, args.queries,
                             seed=args.seed + 2)
    rec_join = Recorder(ops, "pairwise_l2_join_batched_masked", batched_cells)
    try:
        K.reset_launches()
        ts = time.perf_counter()
        answers = engine.query_batch(queries, k=1, tier="exact")
        wall = time.perf_counter() - ts
        serve_joins = dict(K.launches)
    finally:
        rec_join.restore()
    st = engine.last_batch_stats
    ts = time.perf_counter()
    ref_ans = engine.query_batch(queries, k=1, tier="exact", backend="numpy")
    numpy_s = time.perf_counter() - ts
    check_answers(engine.dataset, queries, answers, "embed-exact")
    check(same_answers(answers, ref_ans, 1e-9),
          "embedded corpus: torch and numpy backends disagree")
    emb["serve"] = {"queries": len(queries), "wall_s": wall,
                    "qps": len(queries) / wall, "numpy_backend_s": numpy_s,
                    "phases": st.phases, "cascade": st.cascade,
                    "binning": st.binning, "launches": serve_joins,
                    "fallback_queries": st.fallback_queries}
    if rec_join.best is not None:
        x, lengths, r = rec_join.best[:3]
        m_k, c_k = K.join_batched_masked(x, lengths, r)
        m_p, c_p = ref.join_batched_masked(x, lengths, r)
        torch.cuda.synchronize()
        err, bits = band_check_batched(x, lengths, r, c_k, c_p, m_k, m_p)
        emb["serve"]["k1_vs_plain"] = {"shape": list(x.shape),
                                      "max_count_diff": err,
                                      "mask_bits_in_band": bits}
    print(f"[embed] exact over the {n_docs} x {cfg.d_model} corpus: "
          f"{len(queries)} queries in {wall:.3f}s = {len(queries) / wall:.2f}"
          f" QPS; phases {st.phases}; cascade {st.cascade}; device bins "
          f"{st.device_dispatches}, host bins {st.host_routed_dispatches}; "
          f"launches {serve_joins}; K1 vs plain "
          f"{emb['serve'].get('k1_vs_plain')}; answers equal the numpy "
          f"backend's, which took {numpy_s:.3f}s", flush=True)

    rec_diam = Recorder(ops, "anchor_star", tuple_cells)
    try:
        torch.cuda.synchronize()
        K.reset_launches()
        D.reset_launches()
        ts = time.perf_counter()
        dev_ans = engine.query_batch(queries, k=1, tier="device")
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
        k6 = dict(D.launches)
        dev_joins = dict(K.launches)
    finally:
        rec_diam.restore()
    st = engine.last_batch_stats
    emb["device"] = device_report(engine.dataset, queries, wall, st,
                                  rec_diam)
    check_star_launches(k6, queries, "embed-device")
    check(not any(dev_joins.values()),
          "embed-device: the device tier launched a join kernel")
    emb["device"]["checks"] = check_device_answers(
        engine.dataset, queries, dev_ans, "embed-device", 1,
        [r.candidates[0].diameter for r in answers])
    emb["device"]["profile"] = device_profile(
        lambda: engine.query_batch(queries, k=1, tier="device"),
        len(queries), "embed-device")
    print(f"[embed] device tier over the {n_docs} x {cfg.d_model} corpus: "
          f"{len(queries)} queries in {wall:.4f}s = {len(queries) / wall:.2f}"
          f" QPS; phases {st.phases}; launches {k6}, largest anchor-star "
          f"input {emb['device']['star_largest']}; checks "
          f"{emb['device']['checks']}"
          f"; profiler (again, after the launches were read): busy "
          f"{emb['device']['profile'].get('busy_share')}, kernel time by "
          f"kind {emb['device']['profile'].get('share_of_kernel_time')}",
          flush=True)
    return rec, k7, rec_diam, k6, rec_k5, k5


def corpus_geometry(points, d: int, device) -> dict:
    """Norms and inter-point distances of the embedded corpus (float64 on
    the card, the first 2,048 points) beside the fp32 slack the torch
    backend widens every pruning radius by (``TorchBackend._slack`` for a
    subset holding the largest-norm point): how many pairs lie inside that
    band decides how much of the join the host must settle in float64."""
    import torch
    x = torch.from_numpy(points).to(device, torch.float64)
    n2 = (x * x).sum(1)
    slack = float(((64.0 + 4.0 * d) * EPS32 * n2.max()).sqrt())
    sample = x[:2048]
    dist = torch.cdist(sample, sample)
    off = dist[~torch.eye(len(sample), dtype=torch.bool, device=device)]
    q = torch.quantile(off[:1 << 24], torch.tensor(
        [0.01, 0.5], dtype=torch.float64, device=device)).tolist()
    return {"max_norm": float(n2.max().sqrt()),
            "median_norm": float(n2.sqrt().median()), "slack": slack,
            "dist_q01": q[0], "dist_median": q[1],
            "pairs_within_slack": float((off <= slack).double().mean())}


def kernel_table(prof) -> dict:
    """{kernel name: (device seconds, events)} from a finished
    torch.profiler run."""
    from torch.autograd import DeviceType
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        sec, n = kernels.get(e.key, (0.0, 0))
        kernels[e.key] = (sec + us * 1e-6, n + e.count)
    return kernels


def profile_window(fn, own: tuple[str, str, str]) -> dict:
    """Run ``fn()`` once under torch.profiler (CPU and CUDA activity,
    every event kept): its wall, summed kernel time, busy share (kernel
    time / wall) and the share of kernel time of the hand-written kernel
    ``own`` = (label, name mark, launch counter), of matrix products
    (cuBLAS/CUTLASS kernels) and of everything else. The profiler's events
    of ``own`` are counted against its launch counter over the window: where
    they differ, the figures are None beside both counts, since the
    profiler lost events. Returns ``{}`` if it saw no device time."""
    label, mark, counter = own
    before = launch_counts()[counter]
    kernels, wall = profiled(fn, 1)
    launches = launch_counts()[counter] - before
    _, events = marked(kernels, mark)
    total = sum(v[0] for v in kernels.values())
    if total <= 0.0:
        return {}
    counts = {"own_events": events, "own_launches": launches,
              "kernel_events": sum(v[1] for v in kernels.values()),
              "kernel_names": sorted(k[:160] for k in kernels)}
    if events != launches:
        return {"wall_s": wall, "kernel_s": None, "busy_share": None,
                "share_of_kernel_time": None, **counts}
    kinds = {label: 0.0, "matmul": 0.0, "other": 0.0}
    for name, (sec, _) in kernels.items():
        kind = label if mark in name else "matmul" \
            if any(m in name.lower() for m in MATMUL_MARKS) else "other"
        kinds[kind] += sec
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_s": wall, "kernel_s": total, "busy_share": total / wall,
            "share_of_kernel_time": {k: v / total for k, v in kinds.items()},
            "kernel_s_by_kind": kinds,
            "top_kernels_s": {k[:120]: v[0] for k, v in top}, **counts}


def profile_embed(api, params, batches) -> dict:
    """Kernel time by kind over a few embed batches: K7 (``flash_fwd``),
    matrix products and everything else (norms, RoPE, SwiGLU, casts, adds).
    Runs after the embed path's launches were read."""
    import torch

    dev = params["final_norm"]["w"].device

    def run():
        with torch.inference_mode():
            for b in batches:
                api.embed(params, {"tokens": torch.as_tensor(
                    b["tokens"], device=dev)})
    prof = profile_window(run, ("flash_attention (K7)", "flash_fwd",
                                "flash_attention"))
    return {"batches": len(batches), **prof} if prof else {}


def flash_row(rec: ShapeRecorder, k7_launches: int,
              profiles: KernelProfiles) -> dict:
    """K7 against its plain version at the embed path's shapes and two
    variants; timings with CUDA events beside ``F.scaled_dot_product_attention``
    on the same inputs, and the kernel's device time from the fresh-process
    profiler. The row's own numbers are those of the shape the path
    launched most."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    def sdpa(q, k, v, window):
        """The library's causal attention on the same inputs."""
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        mask = None
        if window is not None:
            i = torch.arange(q.shape[1], device=q.device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                  - window)
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            enable_gqa=k.shape[2] != q.shape[2])

    def dropped_tile(q, k, v):
        """A planted fault: the plain version's rows S-64.. (the last query
        tile) computed without key tile [S-128, S-64) that they all see."""
        s = q.shape[1]

        def keep(a):
            return torch.cat([a[:, :s - 128], a[:, s - 64:]], dim=1)
        return ref.flash_attention(keep(q), keep(k), keep(v),
                                   causal=True)[:, s - 128:]

    gen = torch.Generator(device="cuda").manual_seed(7)
    gqa = tuple(torch.randn(shape, generator=gen, device="cuda")
                .to(torch.bfloat16)
                for shape in ((2, 2048, 36, 128), (2, 2048, 4, 128),
                              (2, 2048, 4, 128)))
    shapes = sorted(rec.first, key=lambda sh: -rec.calls[sh])
    longest = max(shapes, key=lambda sh: sh[1])
    cases = [("path", rec.first[sh], None) for sh in shapes]
    cases.append(("path+window", rec.first[longest], 1024))
    cases.append(("gqa", gqa, None))
    rows = []
    shared: dict = {}        # the row; the profiler fills its device_ms too
    for label, (q, k, v), window in cases:
        b, s, h, hd = q.shape
        got = FA.flash_attention(q, k, v, causal=True, window=window)
        want = ref.flash_attention(q, k, v, causal=True, window=window)
        tol = ref.flash_attention_tolerance(q, k, v, want, causal=True,
                                            window=window).clamp_min_(1e-30)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        max_err = float(err.max())
        err_over_tol = float((err / tol).max())
        check(err_over_tol <= 1.0,
              f"K7 {label} {tuple(q.shape)}: differs from the plain version "
              f"by {max_err} ({err_over_tol} of the bf16 tolerance)")
        fault = None
        if window is None and s >= 128:
            fault = float(((dropped_tile(q, k, v).float()
                            - want[:, s - 64:].float()).abs()
                           / tol[:, s - 64:]).max())
            check(fault > 1.0, f"K7 {label}: a dropped key tile stays "
                               f"within the tolerance ({fault} of it)")
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound(attention_flops(b, s, h, hd, k.shape[1], True,
                                           window), nbytes, PEAK_BF16_FLOPS)
        plain_abs = want.float().abs()
        stats = dict(max_abs_plain=float(plain_abs.max()),
                     rms_plain=float(plain_abs.square().mean().sqrt()),
                     median_row_rms_plain=float(
                         plain_abs.square().mean(-1).sqrt().median()),
                     max_err_over_tol=err_over_tol,
                     dropped_tile_err_over_tol=fault)
        del got, want, err, tol, plain_abs
        # kernel and library in turns: kernel, sdpa, sdpa, kernel
        ms_k = [cuda_ms(lambda: FA.flash_attention(q, k, v, causal=True,
                                                   window=window), 20)]
        ms_l = [cuda_ms(lambda: sdpa(q, k, v, window), 20) for _ in range(2)]
        ms_k.append(cuda_ms(lambda: FA.flash_attention(q, k, v, causal=True,
                                                       window=window), 20))
        rows.append(dict(
            case=label, shape=list(q.shape), kv_heads=k.shape[2],
            window=window, max_abs_err=max_err, **stats,
            ms=sum(ms_k) / 2, ms_runs=ms_k,
            plain_ms=cuda_ms(lambda: ref.flash_attention(
                q, k, v, causal=True, window=window), 3, warmup=1),
            library_ms=sum(ms_l) / 2, library_ms_runs=ms_l,
            ratio_to_library=sum(ms_k) / sum(ms_l),
            bound_ms=b_ms, bound_by=b_by))
        targets = (rows[-1], shared) if len(rows) == 1 else (rows[-1],)
        profiles.add(f"K7 {label} {tuple(q.shape)}",
                     "flash_attention.flash_attention", (q, k, v), "flash_fwd",
                     "flash_attention", 20, *targets, causal=True,
                     window=window)
        torch.cuda.empty_cache()
        print(f"[kernel] flash_attention {label} {tuple(q.shape)} kv "
              f"{k.shape[2]} window {window}: {rows[-1]['ms']:.4f} ms "
              f"(runs {ms_k}; plain {rows[-1]['plain_ms']:.4f} ms, sdpa "
              f"{rows[-1]['library_ms']:.4f} ms (runs {ms_l}), kernel/sdpa "
              f"{rows[-1]['ratio_to_library']:.3f}, bound {b_ms:.4f} ms by "
              f"{b_by}); max_abs_err {rows[-1]['max_abs_err']}, max|plain| "
              f"{stats['max_abs_plain']}, rms(plain) {stats['rms_plain']}, "
              f"err/tol {err_over_tol}, dropped tile err/tol {fault}",
              flush=True)
    main_case = rows[0]
    shared.update(dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:99",
                launches=k7_launches, path="embed",
                launches_by_path={"embed": k7_launches},
                max_abs_err=max(r["max_abs_err"] for r in rows),
                max_err_over_tol=max(r["max_err_over_tol"] for r in rows),
                min_dropped_tile_err_over_tol=min(
                    r["dropped_tile_err_over_tol"] for r in rows
                    if r["dropped_tile_err_over_tol"] is not None),
                shape=main_case["shape"], ms=main_case["ms"],
                plain_ms=main_case["plain_ms"],
                bound_ms=main_case["bound_ms"],
                bound_by=main_case["bound_by"],
                library_ms=main_case["library_ms"],
                ratio_to_library=main_case["ratio_to_library"], cases=rows))
    return shared


def star_launches(queries) -> int:
    """Kernel launches of the fused anchor-star entry for these queries: the
    neighbour stage and the diameter stage of each (the diameter stage
    alone for a one-keyword query)."""
    return sum(2 if len(set(q)) > 1 else 1 for q in queries)


def check_star_launches(counts: dict, queries, label: str) -> None:
    """The device tier launched the fused anchor-star kernels once per
    query and the standalone K6 never."""
    want = star_launches(queries)
    check(counts["anchor_star"] == want,
          f"{label}: the anchor-star kernels launched "
          f"{counts['anchor_star']} times for {len(queries)} queries, want "
          f"{want} (two a query)")
    check(counts["tuple_diameters"] == 0,
          f"{label}: the standalone K6 launched on the device tier")


def device_profile(fn, n_queries: int, label: str) -> dict:
    """:func:`profile_window` over a device-tier batch, with the fused
    anchor-star kernels as its own: no matrix product and no argmin may
    appear among its kernels (the neighbour stage is all in the fused
    kernel), and the kernels a query launches are counted."""
    prof = profile_window(fn, ("anchor_star (K6)", "anchor_star_",
                               "anchor_star"))
    bad = [n for n in prof.get("kernel_names", ())
           if any(m in n.lower() for m in MATMUL_MARKS + ("argmin",))]
    check(not bad, f"{label}: the device tier launched {bad}")
    if prof:
        prof["kernels_per_query"] = prof["kernel_events"] / n_queries
    return prof


def stage_kernels(rec) -> dict:
    """The kernels one call of the fused entry launches at its largest
    recorded input, by the profiler's names: its own two and the memset of
    its keys, nothing else (no product, elementwise pass or argmin)."""
    from repro_torch.kernels import ops
    groups, mask = rec.best[:2]
    table, _ = profiled(lambda: ops.anchor_star(groups, mask), 2)
    names = {k[:160]: v[1] for k, v in table.items()}
    others = [k for k in names
              if "anchor_star_" not in k and "memset" not in k.lower()]
    check(not others, f"the anchor-star entry launched other kernels: "
          f"{others}")
    print(f"[device] the anchor-star entry alone at {list(groups.shape)}, "
          f"2 calls: kernel events {names}", flush=True)
    return names


def adaptive_reps(fn, budget_ms: float = 1500.0, cap: int = 50) -> int:
    """Launches to time ``fn`` over: about ``budget_ms`` of it, 2 to cap."""
    t = cuda_ms(fn, 1, warmup=1)
    return max(2, min(cap, int(budget_ms / max(t, 1e-3))))


def star_check(groups, mask, got, want, label: str) -> dict:
    """The fused kernel's outputs against the plain version's on the valid
    anchors (phase 6): each neighbour's float64 distance to its anchor
    within the query's band of the plain one's, worst_nn likewise, and the
    diameters within rtol 1e-5 plus the band of the plain diameters of the
    kernel's own tuples."""
    import torch
    from repro_torch.kernels import ref
    q, _, d = groups.shape
    pts = groups[mask].double()
    band = float(((64.0 + 4.0 * d) * EPS32 * (pts - pts.mean(0)).square()
                  .sum(-1).max()).sqrt()) if len(pts) else 0.0
    (nn, worst, diam), (nn_p, worst_p, _) = got, want
    valid = mask[0]
    a64 = groups[0].double()[valid]
    nn_err, differ = 0.0, 0
    for j in range(1, q):
        g64 = groups[j].double()
        idx, idx_p = nn[valid, j].long(), nn_p[valid, j].long()
        check(bool(mask[j][idx].all()) or not bool(mask[j].any()),
              f"K6 {label}: a neighbour of group {j} is not a valid point")
        dk = (a64 - g64[idx]).norm(dim=-1)
        dp = (a64 - g64[idx_p]).norm(dim=-1)
        if len(dk):
            nn_err = max(nn_err, float((dk - dp).abs().max()))
        differ += int((idx != idx_p).sum())
    live = valid & (worst_p < ref.BIG)
    w_err = float((worst.double().sqrt() - worst_p.double().sqrt())
                  .abs()[live].max()) if bool(live.any()) else 0.0
    tuples = torch.stack([groups[j][nn[:, j].long()] for j in range(q)], 1)
    own = ref.tuple_diameters(tuples).double()[valid]
    d_err = (diam.double()[valid] - own).abs()
    d_over = float((d_err / (1e-5 * own + band)).max()) if len(own) else 0.0
    diam_err = float(d_err.max()) if len(own) else 0.0
    check(nn_err <= band and w_err <= band and d_over <= 1.0,
          f"K6 {label}: the fused kernel differs from its plain version: "
          f"neighbour distances by {nn_err}, worst_nn by {w_err}, diameters "
          f"by {d_over} of their tolerance (band {band})")
    return dict(band=band, nn_dist_err=nn_err, nn_differ=differ,
                worst_err=w_err, diam_err=diam_err,
                max_abs_err=max(nn_err, w_err, diam_err))


def composition(groups, mask):
    """The device tier's neighbour stage as it was before the fused kernel:
    the plain version's cuBLAS products, torch passes and argmin, with the
    standalone K6 kernel for the diameters (the yardstick ``library_ms``)."""
    from repro_torch.kernels import diameter as D
    from repro_torch.kernels import ref
    plain = ref.tuple_diameters
    ref.tuple_diameters = D.tuple_diameters
    try:
        return ref.anchor_star(groups, mask)
    finally:
        ref.tuple_diameters = plain


def anchor_star_row(cases: list, launches_by_path: dict,
                    profiles: KernelProfiles) -> tuple[dict, list]:
    """The fused anchor-star kernel against its plain version at each
    recorded input (label, Recorder of ``ops.anchor_star``); timings with
    CUDA events beside the plain version and the composition it replaced;
    the bound counts this input's valid anchors and points. Returns the row
    (its own numbers those of the first case, the main device batch's
    largest input) and, per case, the (R, q, d) tuples its neighbours form
    (the standalone K6's inputs)."""
    import torch
    from repro_torch.kernels import diameter as D
    from repro_torch.kernels import ref

    rows, tuples = [], []
    for label, rec in cases:
        groups, mask = rec.best[:2]
        q, r, d = groups.shape
        got = D.anchor_star(groups, mask)
        want = ref.anchor_star(groups, mask)
        torch.cuda.synchronize()
        res = star_check(groups, mask, got, want, label)
        nn = got[0]
        tuples.append((label, torch.stack(
            [groups[j][nn[:, j].long()] for j in range(q)], 1).contiguous()))
        a_valid = int(mask[0].sum())
        r_valid = [int(mask[j].sum()) for j in range(1, q)]
        flops = 2.0 * a_valid * d * sum(r_valid) + 2.0 * a_valid * q * q * d
        nbytes = (a_valid + sum(r_valid)) * d * 4.0 + q * r + r * (4.0 * q + 8)
        b_ms, b_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
        pad_ms, _ = bound(2.0 * r * d * (q - 1) * r, q * r * (d * 4.0 + 1),
                          PEAK_FP32_FLOPS)
        kernel = lambda: D.anchor_star(groups, mask)          # noqa: E731
        plain = lambda: ref.anchor_star(groups, mask)         # noqa: E731
        lib = lambda: composition(groups, mask)               # noqa: E731
        reps_k, reps_p = adaptive_reps(kernel), adaptive_reps(plain, 3000.0)
        rows.append(dict(
            case=label, shape=[q, r, d], valid_anchors=a_valid,
            valid_points=r_valid, **res,
            ms=cuda_ms(kernel, reps_k), plain_ms=cuda_ms(plain, reps_p),
            library_ms=cuda_ms(lib, reps_p), bound_ms=b_ms, bound_by=b_by,
            padded_bound_ms=pad_ms, reps=reps_k))
        c = rows[-1]
        c["library_over_kernel"] = c["library_ms"] / c["ms"]
        print(f"[kernel] anchor_star {label} (q, R, d) {c['shape']}, valid "
              f"anchors {a_valid}, valid points {r_valid}: {c['ms']:.4f} ms "
              f"(plain {c['plain_ms']:.4f} ms, composition "
              f"{c['library_ms']:.4f} ms = {c['library_over_kernel']:.2f}x "
              f"the kernel, bound {b_ms:.5f} ms by {b_by}, at the padded "
              f"shape {pad_ms:.5f} ms); neighbour distance err "
              f"{res['nn_dist_err']:.3g} ({res['nn_differ']} neighbours "
              f"differ), worst err {res['worst_err']:.3g}, diameter err "
              f"{res['diam_err']:.3g}, band {res['band']:.3g}", flush=True)
        profiles.add(f"K6 anchor_star {label}", "diameter.anchor_star",
                     (groups, mask), "anchor_star_", "anchor_star",
                     max(3, min(50, int(1000.0 / c["ms"]))), c)
    main_case = rows[0]
    row = dict(name="anchor_star", route="cuda",
               source="src/repro_torch/kernels/csrc/diameter.cu",
               replaces="src/repro/kernels/diameter.py:36",
               also_replaces="src/repro/core/distributed.py:39 (the "
                             "neighbour stage: _masked_sq_dists and the "
                             "argmin loop at :79)",
               launches=launches_by_path["device-q3"], path="device-q3",
               launches_by_path=launches_by_path,
               max_abs_err=max(r["max_abs_err"] for r in rows),
               shape=main_case["shape"], ms=main_case["ms"],
               plain_ms=main_case["plain_ms"],
               bound_ms=main_case["bound_ms"],
               bound_by=main_case["bound_by"],
               library_ms=main_case["library_ms"],
               library="the composition it replaced: torch.mm + torch "
                       "passes + argmin + gather per group, then the "
                       "standalone K6",
               cases=rows)
    profiles.targets[f"K6 anchor_star {cases[0][0]}"] += (row,)
    return row, tuples


def diameter_row(cases: list, launches_by_path: dict,
                 profiles: KernelProfiles) -> dict:
    """The standalone K6 against its plain version at each (label, tuples)
    input; timings with CUDA events. The row's own numbers are those of the
    first case (the tuples of the main device batch's largest input)."""
    import torch
    from repro_torch.kernels import diameter as D
    from repro_torch.kernels import ref

    rows = []
    for label, x in cases:
        t, q, d = x.shape
        got = D.tuple_diameters(x)
        want = ref.tuple_diameters(x)
        torch.cuda.synchronize()
        band = ((64.0 + 4.0 * d) * EPS32
                * x.double().square().sum(-1).amax(-1)).sqrt()
        err = (got.double() - want.double()).abs()
        over = float((err / band.clamp_min(1e-30)).max())
        check(over <= 1.0, f"K6 {label} {tuple(x.shape)}: differs from the "
              f"plain version by {float(err.max())} ({over} of the band)")
        flops = 2.0 * t * q * q * d
        nbytes = (t * q * d + t) * 4.0
        b_ms, b_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
        rows.append(dict(
            case=label, shape=[t, q, d], max_abs_err=float(err.max()),
            max_err_over_band=over,
            ms=cuda_ms(lambda: D.tuple_diameters(x), 50),
            plain_ms=cuda_ms(lambda: ref.tuple_diameters(x), 20),
            library_ms=cuda_ms(lambda: torch.cdist(x, x).amax(dim=(1, 2)),
                               20),
            bound_ms=b_ms, bound_by=b_by,
            bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
            ops_ms=flops / PEAK_FP32_FLOPS * 1e3))
        r = rows[-1]
        print(f"[kernel] tuple_diameters {label} {r['shape']}: "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, cdist+amax "
              f"{r['library_ms']:.4f} ms, bound {b_ms:.5f} ms by {b_by}: "
              f"bytes {r['bytes_ms']:.5f} ms, fp32 operations "
              f"{r['ops_ms']:.5f} ms); max_abs_err {r['max_abs_err']}, "
              f"err/band {over}", flush=True)
    main_case = rows[0]
    row = dict(name="tuple_diameters", route="cuda",
               source="src/repro_torch/kernels/csrc/diameter.cu",
               replaces="src/repro/kernels/diameter.py:36",
               launches=launches_by_path["device-q3"], path=None,
               launches_by_path=launches_by_path,
               max_abs_err=max(r["max_abs_err"] for r in rows),
               max_err_over_band=max(r["max_err_over_band"] for r in rows),
               shape=main_case["shape"], ms=main_case["ms"],
               plain_ms=main_case["plain_ms"],
               bound_ms=main_case["bound_ms"],
               bound_by=main_case["bound_by"],
               library_ms=main_case["library_ms"],
               library="torch.cdist(pts, pts).amax(dim=(1, 2)): two calls",
               cases=rows)
    for (label, x), case in zip(cases, rows):
        targets = (case, row) if case is main_case else (case,)
        profiles.add(f"K6 {label}", "diameter.tuple_diameters", (x,),
                     "tuple_diameters_kernel", "tuple_diameters", 50,
                     *targets)
    return row


def ptxas_report(name: str) -> list[str]:
    """The register, shared-memory and spill lines nvcc's ``-Xptxas -v``
    printed for the current build of ``csrc/<name>.cu``, each after the
    kernel it belongs to, and its warnings and notes (C7513, C7520: wgmma
    serialized)."""
    from repro_torch.kernels import build
    log = build.library_path(name).with_suffix(".so.log")
    lines, kernel = [], None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line or "(C75" in line \
                or "warning" in line.lower():
            lines.append(f"{kernel}: {line.strip()}")
    return lines


def redesigned_summary(rows: list[dict], elig_rows: list[dict]) -> None:
    """The redesigned kernels' numbers side by side, once the profiler has
    filled in their device times: K7 at every case against
    ``F.scaled_dot_product_attention``, K1 and K2 with and without
    eligibility words, K2i at its three inputs, K3, K4 at the path input
    and dense, K6."""
    flash = next(r for r in rows if r["name"] == "flash_attention")
    for case in flash["cases"]:
        print(f"[K7] {case['case']} {case['shape']} kv {case['kv_heads']} "
              f"window {case['window']}: {case['ms']:.4f} ms by events, "
              f"{case.get('device_ms')} ms device, sdpa "
              f"{case['library_ms']:.4f} ms, kernel/sdpa "
              f"{case['ratio_to_library']:.3f}, bound {case['bound_ms']:.4f} "
              f"ms ({case['bound_by']})", flush=True)
    for r in [rows[0], elig_rows[0]]:
        print(f"[K1] {r['name']} {r['shape']}: {r['ms']:.4f} ms by events, "
              f"{r.get('device_ms')} ms device, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), symmetric {r['symmetric']}", flush=True)
    for r in [rows[1], elig_rows[1]]:
        print(f"[K2] {r['name']} {r['shape']} lengths {r['lengths']}: "
              f"{r['ms']:.4f} ms by events, {r.get('device_ms')} ms device, "
              f"library {r['library_ms']:.4f} ms ({r['library']}; its counts "
              f"differ by at most {r['library_count_diff']}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), SASS HGMMA "
              f"{r['sass_hgmma']}", flush=True)
    k2i = next(r for r in rows if r["name"] == "join_batched_prune_int8")
    for case in k2i["cases"]:
        dev = case.get("device_ms")
        share = f", the bound {case['bound_ms'] / dev:.1%} of it" if dev \
            else ""
        parts = case.get("device", {}).get("parts", {})
        lib = (f"{case['library_ms']:.4f} ms (counts equal: "
               f"{case['library_counts_equal']})"
               if case["library_ms"] is not None else case["library_note"])
        print(f"[K2i] {case['case']} {case['shape']} lengths "
              f"{case['lengths']}: {case['ms']:.4f} ms by events, {dev} ms "
              f"device (prep {parts.get('int8_prep_kernel')}, join "
              f"{parts.get('prune_int8_kernel')}), plain "
              f"{case['plain_ms']:.4f} ms (CPU), library {lib}, bound "
              f"{case['bound_ms']:.5f} ms ({case['bound_by']}{share}); counts "
              f"{case['counts']} (K1 {case['k1_counts']}); SASS "
              f"{k2i['sass']}; launches {k2i['launches_by_path']}",
              flush=True)
    k3 = next(r for r in rows if r["name"] == "pairwise_join")
    k4 = next(r for r in rows if r["name"] == "join_batched_tiles")
    for label, r in (("K3 pairwise_join", k3), ("K4 path", k4),
                     ("K4 dense", k4["dense"])):
        dev = r.get("device_ms")
        share = f", the bound {r['bound_ms'] / dev:.1%} of it" if dev else ""
        print(f"[{label.split()[0]}] {label} {r['shape']}: {r['ms']:.4f} ms by "
              f"events, {dev} ms device, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}{share})", flush=True)
    star = next(r for r in rows if r["name"] == "anchor_star")
    for case in star["cases"]:
        dev = case.get("device_ms")
        share = f", the bound {case['bound_ms'] / dev:.1%} of it" if dev \
            else ""
        print(f"[K6] anchor_star {case['case']} (q, R, d) {case['shape']}: "
              f"{case['ms']:.4f} ms by events, {dev} ms device, composition "
              f"{case['library_ms']:.4f} ms ({case['library_over_kernel']:.2f}"
              f"x the kernel), plain {case['plain_ms']:.4f} ms, bound "
              f"{case['bound_ms']:.5f} ms ({case['bound_by']}{share})",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="corpus points (default: Table III's 10^6)")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--compare", type=int, default=8,
                    help="queries per tier held to the numpy backend")
    ap.add_argument("--embed-docs", type=int, default=4096,
                    help="documents of 512 tokens to embed (batches of 32)")
    ap.add_argument("--embed-long-docs", type=int, default=8,
                    help="documents of 4096 tokens to embed (batches of 2)")
    ap.add_argument("--stream-points", type=int, default=10_000,
                    help="points inserted in the streaming phase (8 batches)")
    ap.add_argument("--stream-deletes", type=int, default=1_000,
                    help="points deleted there, half bulk and half delta")
    ap.add_argument("--tenant-points", type=int, default=50_000,
                    help="points per tenant of the tenant-scoped check")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                          / "chip_smoke.json"))
    ap.add_argument("--profile-jobs", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.profile_jobs:
        return run_profile_jobs(args.profile_jobs)
    from repro_torch.kernels import build

    report: dict = {}
    try:
        t0 = time.perf_counter()
        # one nvcc per source, all started together
        with concurrent.futures.ThreadPoolExecutor() as pool:
            list(pool.map(build.build, ("pairwise_l2", "flash_attention",
                                        "diameter", "project_bin")))
        report["build_s"] = time.perf_counter() - t0
        card = card_line()
        report["card"] = card
        print(f"[build] kernels built in {report['build_s']:.1f}s; card: "
              f"{card}", flush=True)
        report["ptxas"] = {n: ptxas_report(n) for n in
                           ("flash_attention", "pairwise_l2", "diameter")}
        for n, lines in report["ptxas"].items():
            for line in lines:
                print(f"[ptxas] {n}: {line}", flush=True)
        from repro_torch.kernels import pairwise_l2
        engine = pairwise_l2.library().join_engine_smem
        engine.restype, engine.argtypes = ctypes.c_int, []
        report["k3_k4_dynamic_smem"] = engine()
        print(f"[ptxas] pairwise_l2: pairwise_join_kernel and "
              f"batched_tiles_kernel take {report['k3_k4_dynamic_smem']} "
              f"bytes of dynamic shared memory a block", flush=True)
        recs, by_path, diam_recs, served = serve(args, report)
        semantics(args, report, served, by_path)
        elig_recs = filtered(args, report, served, by_path)
        stream(args, report, served, by_path)
        store_phase(args, report, served, by_path)
        wal_phase(args, report, served, by_path)
        tenants(args, report, by_path)
        profiles = KernelProfiles()
        rows = kernel_rows(*recs, by_path, profiles)
        rows.append(k4_row(recs[0], by_path, profiles))
        report["kernels"] = rows
        # K1 and K2 at the forced price<50 run's input, eligibility words
        # included (printed beside the rows above, not another kernel)
        elig_rows = [masked_row(elig_recs[0], by_path, profiles, elig=True),
                     prune_row(elig_recs[1], by_path, profiles, elig=True)]
        report["kernels_elig"] = elig_rows
        rows.append(prune_int8_row(recs[1], elig_recs[1], by_path, profiles))
        for row in rows + elig_rows:
            print(f"[kernel] {row['name']} {row['shape']}: {row['ms']:.4f} ms "
                  f"(plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
                  f" ms by {row['bound_by']}, library {row['library_ms']}); "
                  f"max_abs_err {row['max_abs_err']}; lengths "
                  f"{row.get('lengths')}; launches {row['launches_by_path']}",
                  flush=True)
        rec, k7, rec_diam, k6, rec_k5_embed, k5_embed = embed(args, report)
        rows.append(flash_row(rec, k7, profiles))
        del rec
        star_by, k6_by = ({p: c[n] for p, c in by_path.items()}
                          for n in ("anchor_star", "tuple_diameters"))
        star_by["embed-device"] = k6["anchor_star"]
        k6_by["embed-device"] = k6["tuple_diameters"]
        star_row, tuples = anchor_star_row(
            [("path", diam_recs["device-q3"]), ("q9", diam_recs["device-q9"]),
             ("d2304", rec_diam)], star_by, profiles)
        rows.append(star_row)
        rows.append(diameter_row(tuples, k6_by, profiles))
        k5_by_path = {p: c["project_and_bin"] for p, c in by_path.items()}
        k5_by_path["embed-build"] = k5_embed
        rec_k5 = served[4]
        rows.append(k5_row([
            ("path", *rec_k5.first[:2], rec_k5.widths),
            ("d2304", *rec_k5_embed.first[:2], rec_k5_embed.widths)],
            k5_by_path, profiles))
        report["kernel_profiles"] = profiles.run()
        redesigned_summary(rows, elig_rows)
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1, default=str))

    keys = ("name", "route", "source", "replaces", "launches", "path",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
