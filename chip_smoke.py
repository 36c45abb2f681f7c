#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, the full-size corpus
    python3 chip_smoke.py --n 20000 --embed-docs 64 --embed-long-docs 2 \
        --stream-points 2000 --stream-deletes 200 --tenant-points 5000 \
        --runtime-points 2000 --ingest-docs 1500 --launch-docs 300 \
        --model-docs 32 --launch-points 20000   # a quick check of every phase

Phases:
  1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and report
     the card (name and power limit, as nvidia-smi gives them) and the
     ``-Xptxas -v`` lines (registers, shared memory, spills) of the K7,
     K7b, K1-K4 and K6 kernels.
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
     array, bit for bit (its steps run one scale of one index a child
     process, all at once).
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
     per filter, 16 more (``--filter-feasible``) drawn from the keywords
     holding 4 to 16 eligible
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

  3c'. [plane] The sharded serving plane at full width: an 8-shard
     ``DevicePlane(make_serving_mesh(data=8))`` (shards dealt over the
     cards there are: eight ``cuda:0`` shards on one card) and
     ``NKSEngine(mesh=plane)`` over the served corpus with the served
     engine's indices (no second build). Each a path of its own: the 64
     queries exact and approx at k=1, exact forced onto the device with
     the bf16 prune tier, exact with the int8 prune tier, exact under
     price < 50, the device tier at q=3, k=1 and q=9, k=10. Every answer
     equals the single-shard engine's same-route answer bit for bit (the
     device tier's ids and float64 diameters too); K1, K2 and K2i launch
     once a slab of a sharded dispatch (counted against the plane's
     calls), the exact paths dispatch on shards 1-7, K6's two kernels
     launch once a shard a query. Prints QPS beside the single-shard
     figure, sharded of total dispatches, dispatches a shard, shard
     utilisation and the collective wall, and each shard's device.
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
  3g. [runtime] A fresh engine over the served corpus (pinned geometry,
     attributes; compaction at 10,000 churned points), a WAL, and
     ``ServingRuntime`` on its default torch backend (max_batch 32,
     max_queue 1,024, nothing shed): the 64 exact and 64 price<50 requests
     at once (``runtime-exact``: K1, and K2 where auto arms it), the 64
     device requests (``runtime-device``: K6 twice a request), (a) the 256
     requests of the four kinds at once, each bit for bit the engine's own
     batch; (b) the same as Poisson arrivals at half (a)'s throughput,
     latency percentiles by kind; (c) 8 fsync'd inserts of 1,250 points
     among queries, the background compaction with queries and 1,000
     deletes submitted while it runs, an explicit compaction (K5: 55);
     then every tier and price<50 bit for bit a fresh engine's over the
     final rows. No request may fail and no swallowed-error counter move.
  3h. [ingest] 2,500 flickr-like documents (d_raw 256, u=24,874, t=11)
     through ``ProjectionEmbedder(64)`` and a 4-worker ``IngestPipeline``
     into that runtime, one worker killed at its 3rd insert under 10 s
     leases: the queue drains, no worker thread dies, one row lands per
     document and is its embedding bit for bit, K5 5 an insert op.
  3i. [examples] ``examples/torch/quickstart.py --n 2000`` and
     ``examples/torch/ingest_corpus.py`` as child processes on the card,
     one after the other:
     exit 0. Beside it, and beside no phase that reports a time, the host
     build of 3d's compacted indices runs in child processes (a scale of
     an index each), waited for before [launch].
  3j. [launch] ``python -m repro_torch.launch.serve`` at 5 x 10^4 points
     (``--launch-points``) with ``--runtime --wal --ingest-docs 2000`` on a
     request file (64 queries,
     inserts, a delete, health, snapshot, a malformed line, the queries
     again) in a child process: exit 0, every line parses, the malformed
     line an error, the first 64 answers equal an engine's in this process
     fed the same documents; the child's launch counters (K5 660).
  3k. [tenant] At a reduced size (two tenants of 25,000 synthetic points,
     d=64, 1,000 local keywords each): 16 tenant-local 3-keyword queries
     per tenant in the exact, approx and device tiers; results echo the
     local ids, cover the resolved keywords, never reach the other tenant,
     and the torch and numpy backends agree; an id outside the tenant's
     dictionary raises.

  4. Embed at full width: MiniCPM-2B (40 layers, d_model 2304, 36 heads of
     64; random weights from a seeded generator on the card) embeds 2,048
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
  4b. [ingest-model] 64 documents of 512 token ids through a
     ``ModelEmbedder`` over MiniCPM-2B (the [embed] weights, one document a
     call) and a 2-worker pipeline into a runtime over the embedded corpus:
     K7 40 launches a document, K5 5 an insert batch, 8 documents embedded
     again bit for bit, device and exact answers equal a fresh engine's
     over the final rows.
  4c. [generate] Serve the language models: MiniCPM-2B at full width and
     depth on the [embed] weights, 8 prompts of 512 random tokens,
     ``prefill(max_seq=576)`` (K7 40 launches) and 64 greedy ``decode``
     steps (K7 none): prefill tokens/s, decode ms a step and tokens/s, the
     KV cache's bytes and a decode step's bound (weights and live cache
     over 3.35 TB/s). The prefill's logits equal the forward's last
     position within 2^-6 of the largest; prefill 448 then decode 64 given
     tokens equals the forward within 5e-2 of the largest logit. Then
     olmoe-1b-7b, mamba2-2.7b, hymba-1.5b (2,048-token prompts: its 1,024
     window bites), whisper-large-v3 (1,500 random frames, 64 tokens) at
     full width and depth, llama-3.2-vision-90b and llama4-maverick at
     full width cut to one super-block, B=2, each freed before the next:
     prefill (K7 once an attention layer), the same two checks over 8
     decode steps (MoE at no drop, on the forward's expert choices), the
     MoE slots dropped at the served capacity and the aux loss.
  4d. [train] Train the language models (after [generate]): (c) the main
     path, ``launch/train.py``'s entry point for MiniCPM-2B at full width
     and depth, 3 steps at global batch 2 (cut from train_4k's 256 to one
     card) and sequence 4,096, remat on, bf16 optimizer state, fp32 master
     parameters: K7 2 x 40 launches a step (the forward and the remat
     recompute), K7b 3 x 40 (three kernels a layer), every loss and
     gradient norm finite, every parameter leaf moved; seconds a step,
     tokens/s, the model-FLOP share (6 N tokens plus 3 x the attention
     forward's, over 989 TFLOP/s), ``max_memory_allocated``, and one more
     step under the profiler (K7, K7b, matrix products, the rest). (d) The
     fault-tolerant loop at embedder-100m's full size (12 x 768, vocab
     32,000; ``examples/torch/train_embedder.py``'s config, the launcher's
     trainer),
     B=8, S=512, bf16 moments: 6 uninterrupted steps; 6 checkpointed every
     3 with a SIGTERM in step 4 (saved at step 5); every restored leaf's
     sha256 equal to its manifest's; a new loop resumes at step 5; the
     interrupted and resumed losses within 2^-10 of the uninterrupted
     run's (the embedding's backward sums repeated tokens by atomics, in
     an order that changes between runs). (b) MiniCPM-2B cut to 2 layers
     at full width, B=1, S=512: the loss within 2^-8 and every gradient
     leaf within 2^-4 of its norm plus 2^-10 of the largest (the CPU
     tests' tolerance) of the same parameters and batch on the CPU, then
     the AdamW step on both (parameters within 2 lr, each leaf's step
     within 1/4). (a) K7b against its plain twin at MiniCPM-2B's (2, 4096,
     36, 64), embedder-100m's (8, 512, 12/4, 64), hymba's (2, 2048, 25/5,
     64) window 1024 and a hd-128 GQA shape (2, 512, 40/8, 128), all
     causal, from K7's own output and row statistics: within
     ``ref.flash_attention_bwd_tolerance``, two calls bit for bit, a
     dropped key tile outside the tolerance (embedder shape); timed by
     events beside SDPA's backward (``torch.autograd.grad`` through
     ``F.scaled_dot_product_attention``), the plain twin, and by the
     fresh-process profiler (its three kernels one by one: bwd_prep,
     bwd_dkdv, bwd_dq), each beside the previous design's times ("was");
     the K7b kernels' registers and spills from nvcc's report (no
     spills); and at a (dp, tp) shard's heads of MiniCPM-2B,
     (1, 512, 18, 64) and (1, 4096, 18, 64). (a) runs after [shard], so
     its launch counts take in the sharded paths. The launcher in (c) runs
     with ``REPRO_MESH_OVERRIDE=1,1``: one card, one shard.
  4e. [shard] The sharded training side (after [train]), on a (pod=2,
     data=2, model=2) mesh of eight ``cuda:0`` shards unless stated: (a)
     MiniCPM-2B at full width cut to 2 layers: the attention (4, 512, 36,
     64) split once per (dp, tp) shard (K7 8 launches of (1, 512, 18,
     64)) bit for bit the whole call (K7b's gradients compared too); one
     ``make_train_step(..., mesh=)`` step at global batch 4, S=512, fp32
     masters, bf16 moments, against the unsharded step on the same batch:
     K7 2 x 8 a layer, K7b 3 x 8 kernels a layer, the loss within 2^-8,
     the gradient norm within 2^-4, each parameter within 2 lr and each
     leaf's step within 1/4 (the CPU tests' tolerances), the counted
     all-gather and reduce-scatter bytes equal to
     ``launch.dryrun.train_collectives``. (b) ``compressed_psum`` over
     ``pod`` on the two pods' mean gradients: within amax/127 of the exact
     mean, identical on both pods, error buffers ``g32 - deq`` exactly.
     (c) ``pipeline_forward`` on a (pod=4) mesh, a full-width MiniCPM-2B
     layer a stage, 8 microbatches of (1, 512): outputs bit for bit the
     sequential application, the gradients through the schedule (K7b per
     stage) against the sequential backward's; both walls and the bubble
     3/11. (d) ``REPRO_MESH_OVERRIDE=2,2,2 python -m
     repro_torch.launch.train --arch minicpm-2b --multi-pod --global-batch
     16 --seq-len 4096 --steps 2`` at full depth in a child process: two
     finite steps, rank 0's 4 of 16 rows each (the reference's defect),
     K7 and K7b per (dp, tp) shard; s a step, tokens/s, peak memory.
  5. Hold K7 against its plain PyTorch version on the card: on the path's
     own q, k, v of both shapes (recorded during phase 4), causal; the long
     shape again with window 1024; grouped-query heads (36 query, 4 kv,
     head dim 128); and the first q, k, v of every (shape, mask) the
     [generate] prefills gave it: olmoe (2, 512, 16, 128), hymba (2, 2048,
     25/5, 64) with window 1024, whisper's non-causal encoder (2, 1500, 20,
     64) and its decoder, the vision self layers (2, 512, 64/8, 128) and
     llama4 (2, 512, 40/8, 128), each beside SDPA under the same mask. Tolerance (``kernels.ref.flash_attention_tolerance``):
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
     profiler. Also at shard 1's anchor range of 8 of the q=9 input (the
     anchors a plane's second shard scores; a0 = R/8, not a multiple of
     128): within the band of its plain version over the same range, and
     its valid rows bit for bit the same rows of the whole call. Then hold
     the standalone K6 (``tuple_diameters``) against its
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

Prints ``[phases]`` (the seconds of every phase), the kernels' JSON line,
the card line, and last
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
import math
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


class HostBuild:
    """The host numpy build of both indices over a corpus, as
    ``core.index.build_index`` makes it, one scale of one index a child
    process (``--host-build-job``), all at once: at 10^6 points the whole
    build takes a minute of one core, a scale a few seconds. Started where
    nothing is timed, or beside a phase that reports no time. :meth:`check`
    waits for the children and holds the card's indices to their build bit
    for bit; :meth:`close` ends them and removes their files."""

    KINDS = ("exact", "approx")

    def __init__(self, ds, params: dict, label: str):
        import pickle
        self.label = label
        self.n_scales = params.get("n_scales", 5)
        self.path = ROOT / "build" / f"host_build_{label}.pkl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "wb") as f:
            pickle.dump((ds, params), f, protocol=pickle.HIGHEST_PROTOCOL)
        self.procs = {(kind, s): subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--host-build-job",
             f"{kind}:{s}:{self.path}"], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for kind in self.KINDS for s in range(self.n_scales)}

    def _out(self, kind: str, s: int) -> pathlib.Path:
        return pathlib.Path(f"{self.path}.{kind}{s}")

    def check(self, indices) -> float:
        """Waits for the children; the indices (exact, approx) must equal
        their build. Returns the longest child's build seconds."""
        import pickle
        from repro_torch.core.index import PromishIndex
        parts, seconds = {}, []
        try:
            for (kind, s), proc in self.procs.items():
                _, err = proc.communicate(timeout=900)
                check(proc.returncode == 0, f"{self.label}: the host build "
                      f"child ({kind}, scale {s}) failed: "
                      f"{err.strip()[-2000:]}")
                with open(self._out(kind, s), "rb") as f:
                    *parts[kind, s], sec = pickle.load(f)
                seconds.append(sec)
        finally:
            self.close()
        for got, kind in zip(indices, self.KINDS):
            z, w0, p_max, _ = parts[kind, 0]
            want = PromishIndex(
                z=z, w0=w0, n_scales=self.n_scales, exact=kind == "exact",
                structures=tuple(parts[kind, s][3]
                                 for s in range(self.n_scales)),
                p_max=p_max)
            index_equal(got, want, f"{self.label} {kind} index")
        return max(seconds)

    def close(self) -> None:
        """Ends any child still running and removes the input and outputs."""
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        for p in (self.path, *(self._out(*job) for job in self.procs)):
            p.unlink(missing_ok=True)


def run_host_build_job(job: str) -> int:
    """A child of :class:`HostBuild`: ``job`` is ``<kind>:<scale>:<path>``;
    builds that scale of that index (``exact`` or ``approx``) on the host by
    ``core.index.build_index``'s steps (the seeded projection, w0 and table
    size unless pinned, then ``_build_scale``) and pickles (z, w0, p_max,
    the scale's structure, seconds) beside its input."""
    import pickle
    import numpy as np
    from repro_torch.core import projection as proj
    from repro_torch.core.index import _build_scale, default_n_buckets
    kind, scale, path = job.split(":", 2)
    s, exact = int(scale), kind == "exact"
    with open(path, "rb") as f:
        ds, params = pickle.load(f)
    ts = time.perf_counter()
    rng = np.random.default_rng(params.get("seed", 0))
    z = proj.sample_unit_vectors(rng, params.get("m", 2), ds.dim)
    projected = proj.project(ds.points, z)
    p_max = proj.projection_span(projected)
    w0 = params.get("w0")
    if w0 is None:
        w0 = p_max / (2.0 ** params.get("n_scales", 5))
    n_buckets = params.get("n_buckets")
    if n_buckets is None:
        n_buckets = default_n_buckets(ds.n)
    nb = n_buckets if exact else max(64, n_buckets >> s)
    structure = _build_scale(ds, projected, s, w0 * (2.0 ** s), nb, exact,
                             params.get("synopsis", False))
    with open(f"{path}.{kind}{s}", "wb") as f:
        pickle.dump((z, w0, p_max, structure, time.perf_counter() - ts), f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    return 0


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
    arguments of its first call and the width of every call. The arguments
    are kept as references where the callers never write to them
    afterwards (an index build), else as copies (``clone=True``: an insert
    batch, whose buffers the engine goes on using)."""

    def __init__(self, ops, name: str, clone: bool = False):
        self.ops, self.name, self.clone = ops, name, clone
        self.fn = getattr(ops, name)
        self.first = None
        self.widths: list[float] = []
        setattr(ops, name, self)

    def __call__(self, *args, **kw):
        if self.first is None:
            self.first = tuple(a.clone() if self.clone and hasattr(a, "clone")
                               else a for a in args)
        self.widths.append(args[2])
        return self.fn(*args, **kw)

    def first_widths(self) -> list[float]:
        """The widths of the calls, each once, in the order first called."""
        return list(dict.fromkeys(self.widths))

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
    from repro_torch.core.index import default_n_buckets
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
    host_build = HostBuild(ds, dict(m=2, n_scales=5, seed=args.seed),
                           "served")
    report["setup"]["host_build_child_s"] = host_build.check(
        (engine.index_e, engine.index_a))
    report["setup"]["host_build_s"] = time.perf_counter() - ts
    print(f"[build] both indices equal the host numpy build bit for bit "
          f"(z, w0, p_max, every table and khb); the host build took "
          f"{report['setup']['host_build_s']:.1f}s (a scale of an index a "
          f"child process, the longest "
          f"{report['setup']['host_build_child_s']:.1f}s)", flush=True)

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
                                                "device-q3", "device-q9",
                                                "exact-prune-int8")},
            "queries9": queries9, "qps": {
                p: report[p]["qps"] for p in (
                    "exact", "approx", "exact-prune-int8", "device-q3",
                    "device-q9")}}
    kept["answers"]["forced"] = forced_ans
    kept["qps"]["forced"] = report["exact_forced_device_prune"]["qps"]
    return recs, by_path, diam_recs, (engine, ds, queries, pinned, rec_k5,
                                      kept)


def semantics(args, report: dict, served, by_path: dict) -> None:
    """[semantics] Flexible query semantics on the served engine: the
    first ``--semantics-queries`` of the batch's queries (3 keywords, k=2)
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
    qs = queries[:args.semantics_queries]
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


class SlabCalls:
    """Counts, while a path runs, the calls of the plane's two sharded joins
    and of the ``kernels.ops`` joins they make a slab, apart from the ops
    calls made outside the plane (single-device dispatches). With it a path
    checks that the plane launched its kernel once a slab."""

    OPS = ("pairwise_l2_join_batched_masked",
           "pairwise_l2_join_batched_counts")

    def __init__(self, plane, ops):
        self.plane, self.ops = plane, ops
        self.plane_calls = {n: 0 for n in self.OPS}
        self.slab_calls = {n: 0 for n in self.OPS}
        self.direct_calls = {n: 0 for n in self.OPS}
        self.depth = 0
        self.saved = []
        for op, meth in zip(self.OPS, ("join_batched_masked",
                                       "join_batched_counts")):
            self._wrap_ops(op)
            self._wrap_plane(meth, op)

    def _wrap_ops(self, name):
        fn = getattr(self.ops, name)

        def call(*args, **kw):
            (self.slab_calls if self.depth else self.direct_calls)[name] += 1
            return fn(*args, **kw)
        self.saved.append((self.ops, name, fn))
        setattr(self.ops, name, call)

    def _wrap_plane(self, meth, op):
        fn = getattr(self.plane, meth)

        def call(*args, **kw):
            self.plane_calls[op] += 1
            self.depth += 1
            try:
                return fn(*args, **kw)
            finally:
                self.depth -= 1
        self.saved.append((self.plane, meth, None))
        setattr(self.plane, meth, call)

    def restore(self) -> None:
        for obj, name, fn in self.saved:
            if fn is None:
                delattr(obj, name)              # the instance's wrapper
            else:
                setattr(obj, name, fn)

    def as_dict(self) -> dict:
        return {"plane_calls": dict(self.plane_calls),
                "slab_calls": dict(self.slab_calls),
                "direct_calls": dict(self.direct_calls)}


def plane_phase(args, report: dict, served, by_path: dict) -> None:
    """[plane] The sharded serving plane at full width: an 8-shard
    ``DevicePlane(make_serving_mesh(data=8))`` (the shards dealt over the
    cards there are: eight on ``cuda:0`` with one card) and
    ``NKSEngine(mesh=plane)`` over the served 10^6-point corpus, reusing the
    served engine's indices (``_indices=``, no second build). Each path with
    the counters set to 0 just before it: the 64 queries exact and approx at
    k=1 (default backend), exact forced onto the device with the bf16 prune
    tier armed, exact with ``prune_dtype="int8"``, exact under price < 50,
    and the device tier at q=3, k=1 and q=9, k=10. Every answer equals the
    served single-shard engine's on the same route bit for bit (ids and
    float64 diameters, the device tier's too). K1, K2 and K2i launch once a
    slab of each sharded dispatch (K2i's two kernels), counted against the
    plane's calls; the exact paths dispatch on shards 1-7; K6's two kernels
    launch once a shard a query (16 a query). Prints QPS beside the
    single-shard figure (the served engine on the same route, run again
    just before the plane's run, both warm), sharded of total dispatches,
    dispatches a shard, shard utilisation and the collective wall."""
    import torch
    from repro_torch import NKSEngine
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.device_plane import DevicePlane
    from repro_torch.core.filters import where
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_serving_mesh

    engine, ds, queries, pinned, _, kept = served
    queries9 = kept["queries9"]
    plane = DevicePlane(make_serving_mesh(data=8))
    n = plane.n_shards
    check(n == 8 and all(d.type == "cuda" for d in plane.devices),
          f"[plane] want 8 CUDA shards, got {plane.devices}")
    out: dict = {"devices": [str(d) for d in plane.devices], "paths": {}}
    report["plane"] = out
    torch.cuda.synchronize()
    ts = time.perf_counter()
    eng8 = NKSEngine(ds, **pinned, mesh=plane,
                     _indices=(engine.index_e, engine.index_a))
    torch.cuda.synchronize()
    out["engine_s"] = time.perf_counter() - ts
    model = eng8.backend._model
    out["cost_model_prune_over_dev"] = model.prune_cell_s / model.dev_cell_s
    print(f"[plane] {n} shards on {sorted(set(out['devices']))}; engine over "
          f"the served corpus with its indices in {out['engine_s']:.3f}s "
          f"(upload, cost model, warm-up; no build); its cost model's "
          f"prune/dev {out['cost_model_prune_over_dev']:.4f} (the served "
          f"engine's {report['default_backend']['prune_over_dev_cell']:.4f})",
          flush=True)
    # the sharded and the single-shard backends of the forced and int8
    # routes, corpus uploaded (and the int8 arm's cost model calibrated)
    # outside the timing
    backends = {}
    for name, kw in (("forced", dict(route="device", prune_tier="on")),
                     ("int8", dict(prune_tier="on", prune_dtype="int8"))):
        for sharded in (True, False):
            be = TorchBackend(plane=plane, **kw) if sharded \
                else TorchBackend(**kw)
            be.attach(ds.points)
            be.warmup(ds.dim)
            backends[name, sharded] = be
    price50 = where(("price", "<", 50.0))
    runs = [  # path, tier, k, queries, backend, filter, single-shard key
        ("plane-exact", "exact", 1, queries, "torch", None, "exact"),
        ("plane-approx", "approx", 1, queries, "torch", None, "approx"),
        ("plane-forced", "exact", 1, queries, "forced", None, "forced"),
        ("plane-int8", "exact", 1, queries, "int8", None, "exact-prune-int8"),
        ("plane-price<50", "exact", 1, queries, "torch", price50,
         "filter:price<50:exact"),
        ("plane-device-q3", "device", 1, queries, "torch", None, "device-q3"),
        ("plane-device-q9", "device", 10, queries9, "torch", None,
         "device-q9")]
    for path, tier, k, qs, be, flt, key in runs:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        again = engine.query_batch(qs, k=k, tier=tier, filter=flt,
                                   backend=backends.get((be, False), be))
        torch.cuda.synchronize()
        single_wall = time.perf_counter() - ts
        be = backends.get((be, True), be)
        calls = SlabCalls(plane, ops)
        try:
            res, wall = drive_path(by_path, path, lambda: eng8.query_batch(
                qs, k=k, tier=tier, backend=be, filter=flt))
        finally:
            calls.restore()
        st = eng8.last_batch_stats
        launches = by_path[path]
        want = kept["answers"][key]
        same = [[(c.ids, c.diameter) for c in r.candidates] for r in res] \
            == [[(c.ids, c.diameter) for c in r.candidates] for r in want]
        same = same and [[(c.ids, c.diameter) for c in r.candidates]
                         for r in again] \
            == [[(c.ids, c.diameter) for c in r.candidates] for r in want]
        rep = out["paths"][path] = {
            "queries": len(qs), "k": k, "wall_s": wall,
            "qps": len(qs) / wall, "single_shard_qps": len(qs) / single_wall,
            "single_shard_qps_served": kept["qps"][key],
            "sharded_dispatches": st.sharded_dispatches,
            "total_dispatches": st.total_dispatches if tier != "device"
            else len(qs),
            "shard_dispatches": list(st.shard_dispatches),
            "shard_utilisation": st.shard_utilisation,
            "t_collective_s": st.t_collective_s, "phases": st.phases,
            "sharding": st.sharding, "launches": launches,
            "calls": calls.as_dict(), "identical": same}
        print(f"[plane] {path}: {len(qs)} queries at k={k} in {wall:.4f}s = "
              f"{rep['qps']:.2f} QPS (single shard just before "
              f"{rep['single_shard_qps']:.2f}, in its own phase "
              f"{rep['single_shard_qps_served']:.2f}); sharded "
              f"{st.sharded_dispatches} of "
              f"{rep['total_dispatches']} dispatches; shard_dispatches "
              f"{st.shard_dispatches}; shard_utilisation "
              f"{st.shard_utilisation}; t_collective_s "
              f"{st.t_collective_s:.4f}; phases {st.phases}; launches "
              f"{ {k2: v for k2, v in launches.items() if v} }; plane and "
              f"slab calls {calls.as_dict()}", flush=True)
        check(same, f"[plane] {path}: answers differ from the single-shard "
              f"engine's {key} run")
        if tier == "device":
            check(launches["anchor_star"] == 2 * n * len(qs),
                  f"[plane] {path}: K6 launched {launches['anchor_star']} "
                  f"kernels for {len(qs)} queries, want {2 * n} a query")
            check(st.shard_dispatches == [len(qs)] * n
                  and st.sharded_dispatches == len(qs)
                  and st.backend == "device-plane",
                  f"[plane] {path}: shard accounting {st.sharding}")
            continue
        check(launches["anchor_star"] == 0, f"[plane] {path}: K6 launched")
        for op, kernels in (
                ("pairwise_l2_join_batched_masked",
                 launches["join_batched_masked"]),
                ("pairwise_l2_join_batched_counts",
                 launches["join_batched_prune"]
                 + launches["join_batched_prune_int8"] // 2)):
            check(calls.slab_calls[op] == n * calls.plane_calls[op]
                  and kernels == calls.slab_calls[op]
                  + calls.direct_calls[op],
                  f"[plane] {path}: {op} launched {kernels} kernels for "
                  f"{calls.plane_calls[op]} sharded calls and "
                  f"{calls.direct_calls[op]} single-device calls "
                  f"({calls.as_dict()}): not once a slab")
        if tier == "exact":
            check(st.sharded_dispatches > 0
                  and len(st.shard_dispatches) == n
                  and all(st.shard_dispatches[1:]),
                  f"[plane] {path}: no sharded dispatch on every shard: "
                  f"{st.sharding}")
            check(0.0 < st.t_collective_s <= st.t_dispatch_s,
                  f"[plane] {path}: collective wall {st.t_collective_s} not "
                  f"in (0, dispatch {st.t_dispatch_s}]")
        check(all(0.0 <= u <= 1.0 for u in st.shard_utilisation),
              f"[plane] {path}: utilisation {st.shard_utilisation}")
    check(by_path["plane-forced"]["join_batched_prune"] > 0,
          "[plane] the forced run launched no K2")
    check(by_path["plane-int8"]["join_batched_prune_int8"] > 0
          and by_path["plane-int8"]["join_batched_prune"] == 0,
          f"[plane] the int8 run did not run K2i alone: "
          f"{by_path['plane-int8']}")
    check(by_path["plane-price<50"]["join_batched_masked_elig"] > 0,
          "[plane] price<50 launched K1 without eligibility words")
    del eng8, backends
    torch.cuda.empty_cache()
    shards = ", ".join(f"shard {i} {d}" for i, d in enumerate(out["devices"]))
    print(f"[plane] every path bit for bit the single-shard engine's; "
          f"shard devices: {shards}", flush=True)


def stream(args, report: dict, served, by_path: dict) -> None:
    """Inserts, deletes and a compaction on the served engine, each a path
    of its own: K5 must launch 5 times per insert batch and per compaction;
    answers on the dirty corpus equal the numpy backend's on the same
    engine, and after compaction a fresh engine's over the compacted corpus;
    the compacted indices equal the host build with the pinned geometry
    (built by :class:`HostBuild` children beside ``[examples]``; this
    returns the compacted corpus and indices for them)."""
    import numpy as np
    import torch
    from repro_torch import NKSEngine, flickr_like_dataset
    from repro_torch.core.filters import where
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
    report["stream"] = st
    print(f"[stream] compaction of {engine.dataset.n} live points in "
          f"{compact_s:.3f}s (launches {by_path['compact']}; split "
          f"{st['compact_build_split']}); answers equal a fresh engine's "
          f"over the compacted corpus ({st['fresh_engine_s']:.2f}s to "
          f"build); the compacted indices go to the pinned host build in "
          f"child processes", flush=True)
    return engine.dataset, (engine.index_e, engine.index_a), pinned


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


def percentiles(values) -> dict:
    """p50, p95 and p99 of ``values`` (seconds), or None when empty."""
    import numpy as np
    if not len(values):
        return None
    v = np.asarray(values, dtype=np.float64)
    return {f"p{q}": float(np.percentile(v, q)) for q in (50, 95, 99)}


def cand_keys(candidates) -> list:
    return [(c.ids, c.diameter) for c in candidates]


def runtime_checks(rt, label: str, bg_compactions: int) -> dict:
    """The runtime's counters after a phase without injected faults: no
    request failed or was dropped, no dispatch retried, no rebuild error
    was swallowed, and ``bg_compactions`` is the count the traffic
    triggers."""
    st = rt.stats.as_dict()
    for name in ("errors", "dispatch_failures", "dispatch_retries",
                 "bg_compaction_errors", "bg_compaction_faults", "crashed",
                 "expired", "rejected_full", "degraded_queries"):
        check(st[name] == 0, f"[{label}] runtime stats {name} = {st[name]}")
    check(st["bg_compactions"] == bg_compactions,
          f"[{label}] {st['bg_compactions']} background compactions, the "
          f"traffic triggers {bg_compactions}")
    check(rt.health()["last_compaction_error"] is None,
          f"[{label}] {rt.health()['last_compaction_error']}")
    return st


def runtime_phase(args, report: dict, served, by_path: dict) -> tuple:
    """[runtime] A fresh engine over the served corpus (its pinned
    geometry and attributes, ``compact_ratio=0.01`` and ``compact_min`` 10,000
    (``--runtime-points``) so that 10,000 churned points trigger one
    background compaction), ``attach_wal`` to a fresh
    temporary directory, then ``ServingRuntime`` on the default ``"torch"``
    backend, ``max_batch=32``, ``max_queue=1024`` and
    ``degrade_watermark=1.0`` (nothing shed). Paths: ``runtime-exact`` (the
    64 exact and the 64 exact price<50 requests at once: K1, and K2 where
    auto arms it), ``runtime-device`` (the 64 device requests, q=3, k=1: K6
    twice a request), (a) ``runtime-burst``: the 64 queries in each of the
    exact, approx and device tiers and exact under price<50, 256 requests
    submitted at once, every answer bit for bit the engine's own
    ``query_batch``; (b) ``runtime-paced``: the same 256 as Poisson arrivals
    (seed 0) at half (a)'s throughput, latency percentiles by kind; (c)
    ``runtime-ingest``: 8 insert ops of 1,250 attributed points, each
    acknowledged after its fsync, with exact and approx queries between
    them, the 8th triggering the background compaction; queries and 1,000
    deletes submitted while it runs; then an explicit ``compact``. K5 must
    launch 5 times an insert op, a delete of bulk rows and a compaction.
    Afterwards the 64 queries in the three tiers and under price<50 equal,
    bit for bit, a fresh engine's over the final live rows (same order,
    same geometry), compared by row. Returns (runtime, temporary dir) for
    [ingest], which closes both."""
    import os
    import tempfile
    import numpy as np
    import torch
    from repro_torch import NKSEngine, flickr_like_dataset
    from repro_torch.data.synthetic import synthetic_attrs
    from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime

    _, ds, queries, pinned = served[:4]
    out: dict = {}
    report["runtime"] = out
    t0 = time.perf_counter()
    churn = args.runtime_points         # 10,000: compact_ratio 0.01 at 10^6
    engine = NKSEngine(ds, compact_ratio=churn / ds.n, compact_min=churn,
                       **pinned)
    out["engine_build_s"] = time.perf_counter() - t0
    out["compaction_threshold"] = churn
    tmp = tempfile.mkdtemp(prefix="nks-runtime-")
    # the genesis snapshot, the segment and the job journal of [ingest]
    out["free_bytes"] = disk_room(tmp, 1.25 * leaf_bytes(ds, served[5], False),
                                  "runtime")
    engine.attach_wal(os.path.join(tmp, "wal"))
    flt = {"where": [["price", "<", 50.0]]}
    kinds = {"exact": dict(tier="exact"), "approx": dict(tier="approx"),
             "device": dict(tier="device"),
             "price<50": dict(tier="exact", filter=flt)}
    t0 = time.perf_counter()
    direct = {kind: keys_of(engine.query_batch(queries, k=1, **kw))
              for kind, kw in kinds.items()}
    out["direct_s"] = time.perf_counter() - t0

    def request(kind, q):
        return {"op": "query", "keywords": q, "k": 1, **kinds[kind]}

    def answers(tickets):
        """The responses of (kind, query index, ticket) triples: every one
        ok and equal, bit for bit, to the engine's own batch."""
        lat = {kind: [] for kind in kinds}
        for kind, i, t in tickets:
            r = t.result(600)
            check(r.status == "ok" and not r.degraded,
                  f"[runtime] {kind} request {i}: {r.status} {r.error} "
                  f"(degraded {r.degraded})")
            check(cand_keys(r.payload["candidates"]) == direct[kind][i],
                  f"[runtime] {kind} request {i} differs from the engine's "
                  f"own batch")
            lat[kind].append(r.latency_s)
        return lat

    rt = ServingRuntime(engine, RuntimeConfig(max_batch=32, max_queue=1024,
                                              degrade_watermark=1.0))
    for path, group in (("runtime-exact", ("exact", "price<50")),
                        ("runtime-device", ("device",))):
        b0 = rt.stats.batches
        lat, wall = drive_path(by_path, path, lambda: answers(
            [(kind, i, rt.submit(request(kind, q))) for kind in group
             for i, q in enumerate(queries)]))
        n = len(group) * len(queries)
        out[path] = {"requests": n, "wall_s": wall, "qps": n / wall,
                     "batches": rt.stats.batches - b0,
                     "latency": {k: percentiles(v) for k, v in lat.items()
                                 if v},
                     "launches": by_path[path]}
    c = by_path["runtime-exact"]
    armed = engine.backend._prune_active(ds.dim)
    check(c["join_batched_masked"] > 0, "runtime-exact: K1 did not launch")
    check((c["join_batched_prune"] > 0) == armed,
          f"runtime-exact: K2 launched {c['join_batched_prune']} times with "
          f"the prune tier armed {armed}")
    check(c["anchor_star"] == 0 and c["project_and_bin"] == 0,
          f"runtime-exact: {c}")
    c = by_path["runtime-device"]
    check(c["anchor_star"] == 2 * len(queries),
          f"runtime-device: K6 launched {c['anchor_star']} times, want "
          f"{2 * len(queries)}")
    check(not any(c[k] for k in c if k.startswith("join")),
          f"runtime-device launched a join kernel: {c}")
    print(f"[runtime] engine over the served corpus {out['engine_build_s']:.3f}s"
          f", compaction at {churn} churned points, WAL attached; "
          f"runtime-exact ({len(queries)} exact + {len(queries)} price<50 "
          f"at once) "
          f"{out['runtime-exact']['qps']:.2f} QPS in "
          f"{out['runtime-exact']['batches']} batches, launches "
          f"{by_path['runtime-exact']}; runtime-device "
          f"{out['runtime-device']['qps']:.2f} QPS, launches "
          f"{by_path['runtime-device']}", flush=True)

    order = [(kind, i) for i in range(len(queries)) for kind in kinds]
    b0, q0 = rt.stats.batches, rt.stats.batched_queries
    lat, wall = drive_path(by_path, "runtime-burst", lambda: answers(
        [(kind, i, rt.submit(request(kind, queries[i])))
         for kind, i in order]))
    burst = {"requests": len(order), "wall_s": wall,
             "qps": len(order) / wall, "batches": rt.stats.batches - b0,
             "mean_batch": (rt.stats.batched_queries - q0)
             / max(rt.stats.batches - b0, 1),
             "latency": {k: percentiles(v) for k, v in lat.items()},
             "launches": by_path["runtime-burst"]}
    out["burst"] = burst
    check(by_path["runtime-burst"]["anchor_star"] == 2 * len(queries)
          and by_path["runtime-burst"]["project_and_bin"] == 0,
          f"runtime-burst launches {by_path['runtime-burst']}")

    def fmt(lat):
        return "; ".join(
            f"{k} " + "/".join(f"{v[p] * 1e3:.1f}" for p in ("p50", "p95",
                                                             "p99"))
            for k, v in lat.items() if v)

    print(f"[runtime] (a) burst of {len(order)} requests at once: "
          f"{burst['qps']:.2f} QPS ({wall:.3f}s), {burst['batches']} batches"
          f" (mean {burst['mean_batch']:.1f}); latency p50/p95/p99 ms "
          f"{fmt(burst['latency'])}; launches {by_path['runtime-burst']}; "
          f"every answer bit for bit the engine's own batch", flush=True)

    rate = 0.5 * burst["qps"]
    gaps = np.random.default_rng(0).exponential(1.0 / rate, len(order))

    def paced():
        tickets, start = [], time.perf_counter()
        for (kind, i), at in zip(order, np.cumsum(gaps)):
            pause = start + at - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
            tickets.append((kind, i, rt.submit(request(kind, queries[i]))))
        return answers(tickets)

    b0, q0 = rt.stats.batches, rt.stats.batched_queries
    lat, wall = drive_path(by_path, "runtime-paced", paced)
    pace = {"offered_qps": rate, "requests": len(order), "wall_s": wall,
            "qps": len(order) / wall, "batches": rt.stats.batches - b0,
            "mean_batch": (rt.stats.batched_queries - q0)
            / max(rt.stats.batches - b0, 1),
            "latency": {k: percentiles(v) for k, v in lat.items()},
            "latency_all": percentiles([x for v in lat.values() for x in v]),
            "launches": by_path["runtime-paced"]}
    out["paced"] = pace
    print(f"[runtime] (b) paced: {len(order)} Poisson arrivals (seed 0) at "
          f"{rate:.2f} requests/s (half of (a)): served {pace['qps']:.2f} "
          f"QPS over {wall:.3f}s, {pace['batches']} batches (mean "
          f"{pace['mean_batch']:.1f}); latency p50/p95/p99 ms "
          f"{fmt(pace['latency'])}; all "
          f"{fmt({'': pace['latency_all']})}; answers bit for bit",
          flush=True)

    more = flickr_like_dataset(n=churn, u=24_874, t=11, d=64,
                               seed=args.seed + 11)
    more_attrs = synthetic_attrs(more.n, seed=11)
    per, n_del = churn // 8, churn // 10
    rng = np.random.default_rng(args.seed + 12)

    def mixed():
        acks, qs = [], []
        fsyncs0 = engine.wal_stats.fsyncs
        for b in range(8):
            lo, hi = b * per, (b + 1) * per
            ticket = rt.submit({
                "op": "insert", "points": more.points[lo:hi],
                "keywords": [more.kw.row(i).tolist() for i in range(lo, hi)],
                "attrs": {k: v[lo:hi] for k, v in more_attrs.items()}})
            qs += [(kind, i, rt.submit(request(kind, queries[i])))
                   for i in range(4 * b, 4 * b + 4)
                   for kind in ("exact", "approx") if i < len(queries)]
            r = ticket.result(600)
            check(r.status == "ok", f"[runtime] insert {b}: {r.status} "
                  f"{r.error}")
            acks.append(r.latency_s)
        waited = time.perf_counter()
        while not rt.health()["compaction_inflight"] \
                and rt.stats.bg_compactions == 0 \
                and time.perf_counter() - waited < 5.0:
            time.sleep(0.001)
        # the second half of the queries and, after the first 8 pairs, the
        # deletes, while the compaction runs (the deletes are parked until
        # its swap if it is still running when they reach the head)
        inflight = []
        for j in range(32):
            i = (32 + j) % len(queries)
            for kind in ("exact", "approx"):
                inflight.append(rt.health()["compaction_inflight"])
                qs.append((kind, i, rt.submit(request(kind, queries[i]))))
            if j == 8:
                doomed = sorted(
                    rng.choice(ds.n, n_del // 2, replace=False).tolist()
                    + (ds.n + rng.choice(8 * per, n_del - n_del // 2,
                                         replace=False)).tolist())
                inflight.append(rt.health()["compaction_inflight"])
                delete = rt.submit({"op": "delete", "ids": doomed})
        during = sum(inflight)
        r = delete.result(600)
        check(r.status == "ok" and r.payload["deleted"] == n_del,
              f"[runtime] delete: {r.status} {r.error}")
        waited = time.perf_counter()
        while rt.stats.bg_compactions < 1 or rt.health()["compaction_inflight"]:
            check(time.perf_counter() - waited < 600,
                  "[runtime] the background compaction did not finish")
            time.sleep(0.005)
        r = rt.submit({"op": "compact"}).result(600)
        check(r.status == "ok" and r.payload["compacted"],
              f"[runtime] compact: {r.status} {r.error} {r.payload}")
        # answers during the mix are held to nothing but success: the
        # corpus moves under them
        for kind, i, t in qs:
            rr = t.result(600)
            check(rr.status == "ok", f"[runtime] {kind} request {i} during "
                  f"the mix: {rr.status} {rr.error}")
        return {"ack_s": acks, "queries": len(qs),
                "submitted_during_compaction": during,
                "fsyncs": engine.wal_stats.fsyncs - fsyncs0,
                "query_latency": percentiles(
                    [t.response.latency_s for _, _, t in qs])}

    mix, wall = drive_path(by_path, "runtime-ingest", mixed)
    mix["wall_s"] = wall
    mix["ack_latency"] = percentiles(mix["ack_s"])
    mix["launches"] = by_path["runtime-ingest"]
    out["mixed"] = mix
    k5 = by_path["runtime-ingest"]["project_and_bin"]
    # 8 insert ops, the delete (its bulk rows), the background and the
    # explicit compaction
    check(k5 == 5 * 11, f"runtime-ingest launched K5 {k5} times, want 55")
    check(mix["submitted_during_compaction"] > 0,
          "[runtime] no request was submitted while the compaction ran")
    check(mix["fsyncs"] >= 8, f"[runtime] {mix['fsyncs']} fsyncs for 8 "
          f"acknowledged insert ops")
    st = runtime_checks(rt, "runtime", 1)
    check(engine.ingest.compactions == 2 and engine.corpus_generation == 2,
          f"[runtime] {engine.ingest.compactions} compactions, generation "
          f"{engine.corpus_generation}")
    out["stats"] = st
    print(f"[runtime] (c) mixed: 8 fsync'd inserts of {per} points, ack "
          f"latency p50/p95/p99 ms {fmt({'ack': mix['ack_latency']})} "
          f"({[round(a, 4) for a in mix['ack_s']]} s); {mix['queries']} "
          f"exact and approx queries between them, "
          f"{mix['submitted_during_compaction']} requests submitted while "
          f"the background compaction ran; {n_del} deletes; compact(); "
          f"{wall:.3f}s; {mix['fsyncs']} fsyncs; deferred ingest "
          f"{st['deferred_ingest']}, ingest runs {st['ingest_runs']}, "
          f"bg_compactions {st['bg_compactions']}, mean coalesced batch "
          f"{rt.stats.mean_batch:.2f}; launches {by_path['runtime-ingest']}",
          flush=True)

    t0 = time.perf_counter()
    final = engine.dataset
    fresh = NKSEngine(final, **pinned)
    out["fresh_engine_s"] = time.perf_counter() - t0
    ext = engine._ext_of
    check(final.n == ds.n + 8 * per - n_del and len(ext) == final.n,
          f"[runtime] {final.n} live rows")

    def by_row(keys):
        """External ids to rows of the final corpus (ids ascend with rows)."""
        return [[(tuple(int(v) for v in np.searchsorted(ext, ids)), d)
                 for ids, d in row] for row in keys]

    for kind, kw in kinds.items():
        resp = [t.result(600) for t in [rt.submit(request(kind, q))
                                        for q in queries]]
        check(all(r.status == "ok" for r in resp),
              f"[runtime] {kind} after the mix: "
              f"{[(r.status, r.error) for r in resp if r.status != 'ok']}")
        got = [cand_keys(r.payload["candidates"]) for r in resp]
        want = keys_of(fresh.query_batch(queries, k=1, **kw))
        check(by_row(got) == want, f"[runtime] after the mix the "
              f"{kind} answers differ from a fresh engine's over the final "
              f"rows")
    runtime_checks(rt, "runtime", 1)
    del fresh
    torch.cuda.empty_cache()
    print(f"[runtime] after the mix: {final.n} live rows; exact, approx, "
          f"device and price<50 through the runtime equal a fresh engine's "
          f"over them (same order, same geometry; built in "
          f"{out['fresh_engine_s']:.3f}s), compared by row", flush=True)
    return rt, tmp


def ingest_phase(args, report: dict, rt, tmp: str, by_path: dict):
    """[ingest] ``flickr_like_documents`` (d_raw=256, the served vocabulary
    u=24,874, t=11, attributes, seed 11) through ``ProjectionEmbedder(64)``
    and ``IngestPipeline(workers=4)`` into a ``RuntimeSink`` on the
    [runtime] runtime, one worker killed at its 3rd insert
    (``FaultPlan(crash={"insert": 3})``) under 10 s leases (a third of the
    default), so that survivors reclaim the leases that lapse while the
    dead worker's intent holds the insert fence (``reclaims`` >= 1) and
    reconcile that intent on the card. The lease must outlast every
    insert: one that does not is reverted while in flight and lands twice,
    a fault of the reference's design kept by the port (ROADMAP Queue C),
    which a 2 s lease met once. So each insert is timed from its submission
    to the runtime to its terminal response, and the slowest must stay
    within half the lease. The queue drains with no failed document, no
    worker thread dies, exactly one row lands per document and every row
    equals ``embedder.extract(doc).point`` bit for bit, with its keywords;
    K5 launches 5 times an insert op. Closes the runtime and removes
    ``tmp``. Returns the ``FirstCall`` of K5 (its first insert batch)."""
    import os
    import shutil
    import threading
    import numpy as np
    import torch
    from repro_torch.data.ingest import (IngestPipeline, JobStore,
                                         ProjectionEmbedder, RuntimeSink,
                                         flickr_like_documents)
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.serve.faults import FaultPlan

    class TimedSink(RuntimeSink):
        """The pipeline's runtime sink, with each insert's seconds from
        submission to terminal response."""

        def __init__(self, runtime):
            super().__init__(runtime)
            self.insert_s: list[float] = []

        def insert(self, *batch):
            ts = time.perf_counter()
            try:
                return super().insert(*batch)
            finally:
                self.insert_s.append(time.perf_counter() - ts)

    engine = rt.engine
    out: dict = {}
    report["ingest"] = out
    try:
        t0 = time.perf_counter()
        docs, vocab = flickr_like_documents(
            args.ingest_docs, d_raw=256, u=engine.dataset.n_keywords, t=11,
            seed=11, with_attrs=True)
        emb = ProjectionEmbedder(engine.dataset.dim, vocab, d_raw=256,
                                 seed=11)
        store = JobStore(os.path.join(tmp, "jobs.jsonl"), lease_s=10.0,
                         backoff_s=0.01, max_attempts=10)
        store.add(docs)
        out["setup_s"] = time.perf_counter() - t0
        faults = FaultPlan(crash={"insert": 3})
        sink = TimedSink(rt)
        pipe = IngestPipeline(store, sink, emb, workers=4, faults=faults)
        ops0, ext0 = rt.stats.ingest_ops, engine.next_external_id
        died, hook = [], threading.excepthook
        threading.excepthook = lambda a: died.append(
            f"{a.thread.name}: {a.exc_type.__name__}: {a.exc_value}")
        rec_k5 = FirstCall(kernel_ops, "project_and_bin", clone=True)
        try:
            rep, wall = drive_path(by_path, "ingest",
                                   lambda: pipe.run(timeout_s=600.0))
        finally:
            rec_k5.restore()
            threading.excepthook = hook
        ops = rt.stats.ingest_ops - ops0
        out.update({k: rep[k] for k in ("drained", "docs_done",
                                        "docs_failed", "docs_per_s",
                                        "retries", "reclaims", "exhausted",
                                        "dead_workers", "workers")})
        out["wall_s"], out["insert_ops"] = wall, ops
        out["launches"] = by_path["ingest"]
        ins = np.asarray(sink.insert_s)
        out["lease_s"] = store.lease_s
        out["insert_s"] = dict(
            n=len(ins), max=float(ins.max()),
            **{f"p{q}": float(np.percentile(ins, q)) for q in (50, 99)})
        out["slowest_insert_over_lease"] = float(ins.max()) / store.lease_s
        check(rep["drained"] and rep["docs_failed"] == 0
              and rep["docs_done"] == len(docs),
              f"[ingest] the queue did not drain: {rep['counts']}")
        check(out["slowest_insert_over_lease"] <= 0.5,
              f"[ingest] the slowest insert took {ins.max():.3f}s, over "
              f"half the {store.lease_s:.0f}s lease")
        check(rep["reclaims"] >= 1, "[ingest] no lapsed lease was reclaimed")
        check(faults.fired.get("insert") == 1
              and len(rep["dead_workers"]) == 1,
              f"[ingest] the crash did not fire once: {faults.fired}, dead "
              f"{rep['dead_workers']}")
        check(not died, f"[ingest] a worker thread died: {died}")
        check(engine.next_external_id - ext0 == len(docs),
              f"[ingest] {engine.next_external_id - ext0} rows landed for "
              f"{len(docs)} documents")
        # a batch lands once: acked by its worker, or by another's
        # reconciliation of its expired intent
        check(ops == sum(w["batches_inserted"] + w["reconciled_applied"]
                         for w in rep["workers"].values()),
              f"[ingest] {ops} insert ops for the workers' batches "
              f"{rep['workers']}")
        k5 = by_path["ingest"]["project_and_bin"]
        check(k5 == 5 * ops, f"[ingest] K5 launched {k5} times for {ops} "
              f"insert ops, want {5 * ops}")
        t0 = time.perf_counter()
        ext2doc = store.ext_map()
        check(len(ext2doc) == len(docs), f"[ingest] {len(ext2doc)} acked")
        by_id = {d["doc_id"]: d for d in docs}
        ext = np.fromiter(ext2doc, np.int64, count=len(ext2doc))
        rows = np.searchsorted(engine._ext_of, ext)
        check(bool((engine._ext_of[rows] == ext).all()),
              "[ingest] an acked external id is not live")
        recs = [emb.extract(by_id[ext2doc[int(e)]]) for e in ext]
        view = engine.dataset
        check(np.array_equal(np.asarray(view.points[rows]),
                             np.stack([r.point for r in recs])),
              "[ingest] a document's row differs from its embedding")
        check(all(sorted(int(v) for v in view.kw.row(int(r))) == rec.keywords
                  for r, rec in zip(rows, recs)),
              "[ingest] a document's keywords differ")
        out["check_s"] = time.perf_counter() - t0
        runtime_checks(rt, "ingest", 1)
        print(f"[ingest] {len(docs)} documents (d_raw 256, u "
              f"{len(vocab)}, t 11) through ProjectionEmbedder(64) and 4 "
              f"workers into the runtime: {wall:.3f}s = "
              f"{rep['docs_per_s']:.1f} docs/s, {ops} insert ops; one "
              f"worker killed at its insert ({rep['dead_workers']}), "
              f"retries {rep['retries']}, reclaims {rep['reclaims']}, "
              f"failed {rep['docs_failed']}; {len(ins)} inserts from "
              f"submission to response p50/p99/max "
              f"{out['insert_s']['p50'] * 1e3:.1f}/"
              f"{out['insert_s']['p99'] * 1e3:.1f}/{ins.max() * 1e3:.1f} ms, "
              f"the slowest {out['slowest_insert_over_lease']:.4f} of the "
              f"{store.lease_s:.0f}s lease; every row bit for bit its "
              f"document's embedding; K5 {k5} launches (5 an insert op); "
              f"launches {by_path['ingest']}", flush=True)
    finally:
        rt.close()
        engine.close()
        store.close()
        shutil.rmtree(tmp, ignore_errors=True)
        del rt, engine
        torch.cuda.empty_cache()
    return rec_k5


LAUNCHER = """
import json, runpy, sys
sys.argv[0] = "repro_torch.launch.serve"
try:
    runpy.run_module("repro_torch.launch.serve", run_name="__main__",
                     alter_sys=True)
finally:
    from repro_torch.kernels import (diameter, flash_attention, pairwise_l2,
                                     project_bin)
    counts = {}
    for mod in (pairwise_l2, diameter, project_bin, flash_attention):
        counts.update(mod.launches)
    print("LAUNCHES " + json.dumps(counts), file=sys.stderr)
"""


def launch_phase(args, report: dict, served, by_path: dict) -> None:
    """[launch] ``python -m repro_torch.launch.serve --n 50000 --d 64 --u
    24874 --t 11 --attrs --tier exact --runtime --wal DIR --requests FILE
    --ingest-docs 2000`` in a child process on the card (run as ``-m`` runs
    it, through ``runpy``, so that the child prints its launch counters at
    exit). The corpus is ``--launch-points`` (cut from the served 10^6 for
    time: ``[runtime]`` already serves that size; the child only proves the
    launcher end to end). FILE holds 64 random 3-keyword queries over that
    corpus, 4 attributed insert ops, a delete, ``health``, ``snapshot``, a
    malformed line and the 64 queries again. The child must exit 0, every
    output line parse, the malformed line get ``status: error`` and nothing
    else an error; its first 64 answers must equal this process's engine
    over the corpus the launcher builds (``flickr_like_dataset(seed=0)``,
    default geometry), fed the same ``--launch-docs`` documents by the same
    pipeline,
    answer by answer (ids translated through both job journals). Meanwhile
    this process builds that engine."""
    import argparse
    import json
    import os
    import shutil
    import subprocess
    import tempfile
    import torch
    from repro_torch import NKSEngine, flickr_like_dataset, random_queries
    from repro_torch.data.ingest import JobStore
    from repro_torch.data.synthetic import attach_attrs, synthetic_attrs
    from repro_torch.launch import serve as launcher

    # The corpus the launcher builds: flickr_like_dataset(seed=0) with
    # attribute columns of seed 0.
    ds = attach_attrs(flickr_like_dataset(n=args.launch_points, u=24_874,
                                          t=11, d=64, seed=0), seed=0)
    queries = random_queries(ds, 3, args.queries, seed=args.seed + 1)
    out: dict = {"points": ds.n}
    report["launch"] = out
    tmp = tempfile.mkdtemp(prefix="nks-launch-")
    try:
        # the child's genesis snapshot and the one its "snapshot" writes
        out["free_bytes"] = disk_room(
            tmp, 2.25 * leaf_bytes(served[1], served[5], False), "launch")
        more = flickr_like_dataset(n=400, u=24_874, t=11, d=64,
                                   seed=args.seed + 13)
        more_attrs = synthetic_attrs(more.n, seed=13)
        lines = [json.dumps({"keywords": q, "k": 1}) for q in queries]
        for b in range(4):
            lo, hi = 100 * b, 100 * (b + 1)
            lines.append(json.dumps({
                "op": "insert", "points": more.points[lo:hi].tolist(),
                "keywords": [more.kw.row(i).tolist() for i in range(lo, hi)],
                "attrs": {k: v[lo:hi].tolist()
                          for k, v in more_attrs.items()}}))
        lines += [json.dumps({"op": "delete", "ids": [3, 5, 8, 13]}),
                  json.dumps({"op": "health"}),
                  json.dumps({"op": "snapshot"}),
                  '{"keywords": [1, 2',
                  *[json.dumps({"keywords": q, "k": 1}) for q in queries]]
        reqs = os.path.join(tmp, "requests.jsonl")
        with open(reqs, "w") as f:
            f.write("\n".join(lines) + "\n")
        argv = ["--n", str(ds.n), "--d", "64", "--u", "24874", "--t", "11",
                "--attrs", "--tier", "exact", "--runtime",
                "--wal", os.path.join(tmp, "wal"), "--requests", reqs,
                "--ingest-docs", str(args.launch_docs),
                "--ingest-jobs", os.path.join(tmp, "jobs")]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        ts = time.perf_counter()
        child = subprocess.Popen([sys.executable, "-c", LAUNCHER, *argv],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env,
                                 cwd=tmp)
        try:
            # The same corpus (the launcher attaches attributes with seed 0)
            # and the same documents, in this process.
            t0 = time.perf_counter()
            engine = NKSEngine(ds, build_approx=False, compact_ratio=0.25,
                               compact_min=4096)
            report_in = launcher._run_ingest_pipeline(
                engine, ds, argparse.Namespace(
                    ingest_docs=args.launch_docs, u=24_874, t=11,
                    ingest_workers=2,
                    ingest_jobs=os.path.join(tmp, "jobs-here")))
            want = engine.query_batch(queries, k=1, tier="exact")
            out["in_process_s"] = time.perf_counter() - t0
        finally:
            stdout, stderr = child.communicate(timeout=900)
        out["child_s"] = time.perf_counter() - ts
        out["rc"] = child.returncode
        tail = "\n".join(stderr.splitlines()[-20:])
        check(child.returncode == 0, f"[launch] exit {child.returncode}:\n"
              f"{tail}")
        outs = [json.loads(line) for line in stdout.splitlines()]
        n_q = len(queries)
        check(len(outs) == len(lines), f"[launch] {len(outs)} responses "
              f"for {len(lines)} lines")
        check([o["op"] for o in outs[n_q:n_q + 7]] == [
              "insert", "insert", "insert", "insert", "delete", "health",
              "snapshot"], f"[launch] ops {[o['op'] for o in outs]}")
        bad = outs[n_q + 7]
        check(bad.get("op") == "parse" and bad.get("status") == "error",
              f"[launch] the malformed line got {bad}")
        errs = [(i, o) for i, o in enumerate(outs)
                if i != n_q + 7 and ("error" in o or o.get("status"))]
        check(not errs, f"[launch] error responses {errs[:3]}")
        check(all(o["results"] for i, o in enumerate(outs)
                  if o["op"] == "query"), "[launch] an empty answer")
        launches = json.loads(next(
            line for line in stderr.splitlines()
            if line.startswith("LAUNCHES "))[len("LAUNCHES "):])
        by_path["launch"] = launches
        ingest_line = next((line for line in stderr.splitlines()
                            if line.startswith("ingest: ")), "")
        check(f"ingest: {args.launch_docs} docs" in ingest_line
              and "failed=0" in ingest_line, f"[launch] {ingest_line}")
        check("device=cuda" in stderr, "[launch] not served on the card")
        theirs = JobStore(os.path.join(tmp, "jobs", "jobs.jsonl")).ext_map()
        here = {doc: ext for ext, doc in JobStore(
            os.path.join(tmp, "jobs-here", "jobs.jsonl")).ext_map().items()}
        check(len(theirs) == len(here) == args.launch_docs,
              "[launch] the journals disagree on the documents")

        def mapped(i):
            return i if i < ds.n else here[theirs[i]]

        for q, o, w in zip(queries, outs[:n_q], want):
            got = [(sorted(mapped(i) for i in r["ids"]), r["diameter"])
                   for r in o["results"]]
            exp = [(sorted(c.ids), launcher._result_row(c)["diameter"])
                   for c in w.candidates]
            check(got == exp, f"[launch] query {q}: {got} against {exp}")
        k5 = launches["project_and_bin"]
        # build, 125 pipeline batches of 16, 4 insert ops, the delete (bulk
        # rows), the snapshot's compaction
        want_k5 = 5 * (1 + -(-args.launch_docs // 16) + 4 + 1 + 1)
        check(k5 == want_k5, f"[launch] K5 launched {k5} times in the "
              f"child, want {want_k5}")
        check(launches["join_batched_masked"] > 0, "[launch] K1 did not "
              "launch in the child")
        out.update(responses=len(outs), launches=launches,
                   ingest=ingest_line, ingest_in_process=report_in)
        print(f"[launch] python -m repro_torch.launch.serve {' '.join(argv)}"
              f": exit 0 in {out['child_s']:.1f}s, {len(outs)} responses "
              f"parsed, the malformed line an error envelope; {ingest_line};"
              f" the first {n_q} answers equal this process's engine fed the"
              f" same documents ({out['in_process_s']:.1f}s); child launches "
              f"{launches}", flush=True)
        del engine
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ingest_model_phase(args, report: dict, model, by_path: dict) -> tuple:
    """[ingest-model] Documents whose payload is 512 token ids through
    ``ModelEmbedder`` over the port's ``api.embed`` (MiniCPM-2B at full
    width and depth, the [embed] parameters; one document a call under
    ``torch.inference_mode``), 2 workers, ``batch_docs=16``, into a serving
    runtime over the [embed] corpus engine (4,104 x 2,304). K7 must launch
    40 times a document, K5 5 times an insert batch; 8 documents embedded
    again give their rows bit for bit; afterwards the 64 device queries
    through the runtime equal a fresh engine's over the final rows (ids;
    diameters within the fp32 band, as [embed] checks) and the 64 exact
    queries on both engines (the numpy backend: the torch backend's exact
    tier takes about 18 s a batch at d=2304, ROADMAP Queue C) bit for
    bit. Returns the ``ShapeRecorder`` of K7 and the ``FirstCall`` of K5
    (its first insert batch) on this path, for their checks against the
    plain versions."""
    import os
    import shutil
    import tempfile
    import types
    import numpy as np
    import torch
    from repro_torch import NKSEngine, flickr_like_dataset
    from repro_torch.data.ingest import IngestPipeline, JobStore, ModelEmbedder
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime

    cfg, api, params, engine, queries = model
    n_docs, seq = args.model_docs, 512
    vocab = [f"tag{i:03d}" for i in range(engine.dataset.n_keywords)]
    rng = np.random.default_rng(args.seed + 12)
    tags = flickr_like_dataset(n=n_docs, d=1, u=len(vocab), t=3,
                               seed=args.seed + 12)
    docs = [{"doc_id": f"doc-{i:06d}",
             "payload": rng.integers(0, cfg.vocab_size, seq)
             .astype(np.float32).tolist(),
             "tags": [vocab[v] for v in tags.kw.row(i)]}
            for i in range(n_docs)]

    def embed_fn(tokens):
        # pipeline workers are threads: inference mode is per thread
        with torch.inference_mode():
            ids = torch.as_tensor(tokens, device=engine.device).long()
            return api.embed(params, {"tokens": ids}).float().cpu().numpy()

    emb = ModelEmbedder(embed_fn, cfg.d_model, vocab, d_raw=seq)
    out: dict = {"docs": n_docs, "tokens": n_docs * seq}
    report["ingest_model"] = out
    tmp = tempfile.mkdtemp(prefix="nks-ingest-model-")
    n0 = engine.dataset.n
    try:
        store = JobStore(os.path.join(tmp, "jobs.jsonl"), lease_s=120.0)
        store.add(docs)
        rt = ServingRuntime(engine, RuntimeConfig())
        try:
            pipe = IngestPipeline(store, rt, emb, workers=2, batch_docs=16)
            rec_k7 = ShapeRecorder(kernel_ops)
            rec_k5 = FirstCall(kernel_ops, "project_and_bin", clone=True)
            try:
                rep, wall = drive_path(by_path, "ingest-model",
                                       lambda: pipe.run(timeout_s=900.0))
            finally:
                rec_k5.restore()
                rec_k7.restore()
            check(list(rec_k7.calls) == [(1, seq, cfg.n_heads,
                                           cfg.resolved_head_dim)],
                  f"[ingest-model] K7 ran at {rec_k7.calls}")
            ops = rep["workers"]
            out.update(wall_s=wall, docs_per_s=rep["docs_per_s"],
                       tokens_per_s=n_docs * seq / wall,
                       retries=rep["retries"], reclaims=rep["reclaims"],
                       launches=by_path["ingest-model"])
            check(rep["drained"] and rep["docs_done"] == n_docs
                  and rep["docs_failed"] == 0,
                  f"[ingest-model] the queue did not drain: {rep['counts']}")
            batches = sum(w["batches_inserted"] for w in ops.values())
            c = by_path["ingest-model"]
            check(c["flash_attention"] == cfg.n_layers * n_docs,
                  f"[ingest-model] K7 launched {c['flash_attention']} times"
                  f", want {cfg.n_layers} a document")
            check(c["project_and_bin"] == 5 * batches,
                  f"[ingest-model] K5 launched {c['project_and_bin']} times"
                  f" for {batches} insert batches")
            ext2doc = store.ext_map()
            by_id = {d["doc_id"]: d for d in docs}
            pts = engine.dataset.points
            again = sorted(ext2doc)[:: max(len(ext2doc) // 8, 1)][:8]
            for e in again:
                point = emb.extract(by_id[ext2doc[e]]).point
                check(np.array_equal(pts[e], point), f"[ingest-model] "
                      f"document {ext2doc[e]} embedded again differs from "
                      f"its row")
            t0 = time.perf_counter()
            dev = [t.result(600) for t in [
                rt.submit({"op": "query", "keywords": q, "k": 1,
                           "tier": "device"}) for q in queries]]
            out["device_s"] = time.perf_counter() - t0
            check(all(r.status == "ok" for r in dev),
                  "[ingest-model] a device request failed")
            runtime_checks(rt, "ingest-model", 0)
        finally:
            rt.close()
        final = engine.dataset.compacted_dataset()
        check(final.n == n0 + n_docs, f"[ingest-model] {final.n} rows")
        t0 = time.perf_counter()
        fresh = NKSEngine(final, m=2, n_scales=5, seed=args.seed,
                          w0=engine.index_e.w0,
                          n_buckets=engine.index_e.structures[0].n_buckets)
        out["fresh_engine_s"] = time.perf_counter() - t0
        got = engine.query_batch(queries, k=1, tier="exact", backend="numpy")
        want = fresh.query_batch(queries, k=1, tier="exact", backend="numpy")
        check(keys_of(got) == keys_of(want), "[ingest-model] exact answers "
              "differ from a fresh engine's over the final rows")
        want_dev = fresh.query_batch(queries, k=1, tier="device")
        dev_res = [types.SimpleNamespace(candidates=r.payload["candidates"])
                   for r in dev]
        check([[c.ids for c in r.candidates] for r in dev_res]
              == [[c.ids for c in r.candidates] for r in want_dev],
              "[ingest-model] device answers differ from a fresh engine's")
        out["device_checks"] = check_device_answers(
            final, queries, dev_res, "ingest-model-device", 1,
            [r.candidates[0].diameter for r in want])
        out["device_bit_for_bit"] = keys_of(dev_res) == keys_of(want_dev)
        print(f"[ingest-model] {n_docs} documents of {seq} tokens through "
              f"ModelEmbedder({cfg.name}, one document a call) and 2 "
              f"workers into the runtime over the {n0} x {cfg.d_model} "
              f"corpus: {wall:.3f}s = {out['docs_per_s']:.2f} docs/s = "
              f"{out['tokens_per_s']:.0f} tokens/s; {batches} insert "
              f"batches; retries {rep['retries']}; launches "
              f"{by_path['ingest-model']}; 8 documents embedded again bit "
              f"for bit; {len(queries)} device queries through the runtime "
              f"({out['device_s']:.3f}s) equal a fresh engine's (bit for "
              f"bit {out['device_bit_for_bit']}; {out['device_checks']}), "
              f"exact (numpy backend) bit for bit", flush=True)
        del fresh
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return rec_k7, rec_k5


# [generate]'s families beyond MiniCPM-2B: (architecture, prompt tokens,
# layers kept or None for the full depth). The two depth cuts keep one
# super-block: llama-3.2-vision-90b's 4 self-attention layers and 1 cross
# layer (its 100 layers would need 176 GB), llama4-maverick's dense layer
# and 128-expert MoE layer (its 48 layers about 800 GB).
GENERATE_FAMILIES = (("olmoe-1b-7b", 512, None), ("mamba2-2.7b", 512, None),
                     ("hymba-1.5b", 2048, None),
                     ("whisper-large-v3", 64, None),
                     ("llama-3.2-vision-90b", 512, 5),
                     ("llama4-maverick-400b-a17b", 512, 2))
# Teacher-forced decode against the forward: the reference's own invariant
# (its tests/test_models_smoke.py, rtol and atol 5e-2, at the smoke configs'
# depth of at most 4 layers), made relative to the largest logit, held at
# full width on each model's first SHALLOW layers. The whole-sequence and
# one-token paths round differently, and the difference compounds layer
# after layer, in the reference too (tools/teacher_forced_depth.py, CPU:
# mamba2 at width 256 drifts 0.0161 / 0.0340 / 0.0550 at 4 / 16 / 64
# layers in the reference, 0.0125 / 0.0328 / 0.0494 in the port). So at
# the full depth L the bound grows as independent roundings add, as
# sqrt(L / SHALLOW). Prefill against the forward's last position: both run
# the same kernels on the same shapes up to the head, whose product differs
# in shape (one position against all), so within a bf16 rounding of it.
GENERATE_TOL = 5e-2
SHALLOW = 4
PREFILL_TOL = 2.0 ** -6


def forced_tol(cfg) -> float:
    """The teacher-forced bound at the decoder depth of ``cfg``."""
    return GENERATE_TOL * max(1.0, (cfg.n_layers / SHALLOW) ** 0.5)


def shallow(cfg, params) -> tuple:
    """The model's first SHALLOW layers at full width (the same tensors),
    for the check at the reference test's depth. A model whose layers come
    in super-blocks runs one block in [generate] and is kept whole."""
    if cfg.family == "vlm" or (cfg.moe is not None and cfg.moe.every > 1) \
            or cfg.n_layers <= SHALLOW:
        return cfg, params
    if cfg.family == "audio":
        return (dataclasses.replace(cfg, n_layers=SHALLOW,
                                    enc_layers=min(cfg.enc_layers, SHALLOW)),
                {**params, "enc_layers": params["enc_layers"][:SHALLOW],
                 "dec_layers": params["dec_layers"][:SHALLOW]})
    return (dataclasses.replace(cfg, n_layers=SHALLOW),
            {**params, "layers": params["layers"][:SHALLOW]})


def teacher_forced(cfg, params, tokens, extra, n_prompt: int,
                   by_path=None, path=None) -> dict:
    """Prefill ``tokens[:, :n_prompt]``, then decode the rest one given
    token a step, against ``forward_train`` over all of them: max |decode -
    forward| over the largest live logit at positions n_prompt - 1 ..
    (the prefill's logits and every step's). A mixture-of-experts model
    runs at a capacity that drops nothing (``capacity_factor = E / k``):
    at the served capacity a slot's fate depends on the tokens sharing its
    row, so a forward over all tokens and a one-token decode differ by
    design where an expert overflows; and on the forward's expert choices
    (:class:`RouteReplay`). With ``path`` the decode steps are a path of
    their own in ``by_path``. Returns err, decode seconds, reroutes."""
    import torch
    from repro_torch.models import audio, moe, transformer
    from repro_torch.models.api import model_api
    replay = None
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        replay = RouteReplay(moe)
    api = model_api(cfg)
    ex = extra or None
    steps = tokens.shape[1] - n_prompt
    try:
        with torch.inference_mode():
            full, _ = (audio if cfg.family == "audio" else transformer) \
                .forward_train(params, cfg, tokens, extra=ex)
            if replay is not None:
                replay.replay = True
            logits, cache = api.prefill(
                params, {**extra, "tokens": tokens[:, :n_prompt]},
                max_seq=tokens.shape[1])

            def forced():
                nonlocal cache
                got = [logits]
                for i in range(n_prompt, tokens.shape[1]):
                    if replay is not None:
                        replay.pos = i
                    lg, cache = api.decode(params, cache, tokens[:, i:i + 1])
                    got.append(lg)
                return torch.stack(got, 1)
            if path is None:
                ts = time.perf_counter()
                got = forced()
                torch.cuda.synchronize()
                dec_s = time.perf_counter() - ts
            else:
                got, dec_s = drive_path(by_path, path, forced)
            check(bool(torch.isfinite(got[..., :cfg.vocab_size].float())
                       .all()), f"[generate] {cfg.name}: a non-finite logit")
            check(cache["pos"] == tokens.shape[1], f"[generate] {cfg.name}: "
                  f"pos {cache['pos']} after {steps} steps")
            err = rel_err(got, full[:, n_prompt - 1:], cfg.vocab_size)
    finally:
        if replay is not None:
            replay.restore()
    flips = [] if replay is None else replay.flips
    check(all(g <= m * (1 + 1e-3) + 1e-6 for g, m in flips),
          f"[generate] {cfg.name}: a token routed otherwise than in the "
          f"forward where its input's difference cannot explain it (gap, "
          f"bound): {[f for f in flips if f[0] > f[1]]}")
    return {"err": err, "decode_s": dec_s, "reroutes": len(flips)}


def held(label: str, cfg, res: dict, tol: float) -> None:
    check(res["err"] <= tol, f"[generate] {label}: teacher-forced decode "
          f"differs from the forward by {res['err']} of its largest logit "
          f"(limit {tol:.4g} at {cfg.n_layers} layers)")


def rel_err(got, want, vocab: int) -> float:
    """max |got - want| over max |want| of two logit tensors on the card,
    over the live vocabulary (the padded columns hold -1e30)."""
    want = want[..., :vocab].float()
    return float((got[..., :vocab].float() - want).abs().max()
                 / want.abs().max())


def attention_layers(cfg) -> int:
    """K7 launches of one prefill: every self-attention layer (the audio
    encoder's too); cross-attention and decode take the direct path."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "audio":
        return cfg.enc_layers + cfg.n_layers
    if cfg.family == "vlm":
        from repro_torch.models.transformer import n_blocks
        return n_blocks(cfg) * (cfg.cross_attn_every - 1)
    return cfg.n_layers


class MoEDrops:
    """Wraps ``models.moe.apply_moe`` while a path runs and adds up its
    slots over capacity and all its slots."""

    def __init__(self, moe):
        self.moe, self.fn = moe, moe.apply_moe
        self.stats: dict = {}
        moe.apply_moe = self

    def __call__(self, p, x, cfg, stats=None):
        return self.fn(p, x, cfg, self.stats)

    def restore(self) -> None:
        self.moe.apply_moe = self.fn


class RouteReplay:
    """Wraps ``models.moe.route`` for the teacher-forced check of a
    mixture-of-experts model. While ``replay`` is off it keeps each call's
    expert choice and probabilities (the forward: one call a MoE layer);
    while on, call i takes the expert choice of recorded call i modulo the
    MoE layers, at positions ``pos`` onwards (set by the caller: 0 for the
    prefill, the step's position for a decode step), with its own
    probabilities' weights renormalised over them. A token whose own choice
    differs is kept in ``flips`` as (the recorded gap between its k-th and
    (k+1)-th router logits, the most its input's difference from the
    forward's can move such a gap: ``|x - x_fwd|_2`` times twice the
    router's largest column norm). Each gap must lie within that: the
    forward runs K7 and decode the direct path, whose roundings move the
    layer's input, and at such a near tie either choice is right; the check
    is of the cache, not of that choice."""

    def __init__(self, moe):
        self.moe, self.fn = moe, moe.route
        self.calls: list = []
        self.flips: list = []
        self.replay, self.i, self.pos = False, 0, 0
        moe.route = self

    def __call__(self, p, x, cfg):
        import torch
        probs, w, e, aux = self.fn(p, x, cfg)
        if not self.replay:
            self.calls.append((e, probs, x))
            return probs, w, e, aux
        want_e, want_p, want_x = self.calls[self.i % len(self.calls)]
        self.i += 1
        span = slice(self.pos, self.pos + x.shape[1])
        want_e, want_p = want_e[:, span], want_p[:, span]
        differ = (e.sort(-1).values != want_e.sort(-1).values).any(-1)
        if bool(differ.any()):
            logp = want_p.clamp_min(1e-38).log().sort(-1, descending=True) \
                .values
            gap = logp[..., cfg.top_k - 1] - logp[..., cfg.top_k]
            moved = (x.float() - want_x[:, span].float()).norm(dim=-1) \
                * 2 * p["router"].float().norm(dim=0).max()
            self.flips += [(float(g), float(m)) for g, m in
                           zip(gap[differ], moved[differ])]
        w = torch.gather(probs, -1, want_e)
        return probs, w / w.sum(-1, keepdim=True).clamp_min(1e-9), want_e, aux

    def restore(self) -> None:
        self.moe.route = self.fn


def _tensors(tree) -> list:
    """The tensors of a nested dict/list of parameters or caches."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _tensors(v)]
    return [tree]


def param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def generate_phase(args, report: dict, model, by_path: dict) -> list:
    """[generate] Serve the language models on the card: prefill, decode
    and their caches, every prefill self-attention through K7.

    MiniCPM-2B at full width and depth on the [embed] parameters: 8
    prompts of 512 random tokens, ``prefill(max_seq=576)`` (K7 40 times),
    then 64 greedy ``decode`` steps (K7 never); prefill tokens/s, decode ms
    a step and tokens/s, the KV cache's bytes, and a decode step's bound
    (the weights and the live cache read once over 3.35 TB/s). Checks: the
    prefill's logits equal ``forward_train``'s at the last position within
    ``PREFILL_TOL`` of the largest; a teacher-forced run (prefill 448 of the
    same tokens, then decode the next 64 given ones) equals the forward's
    logits at those positions within ``GENERATE_TOL`` of the largest; every
    logit finite; ``pos`` advances.

    Then the other families at full width (``GENERATE_FAMILIES``), B=2,
    random weights from the seed, each freed before the next: prefill
    (K7 once an attention layer), the same prefill check, then 8
    teacher-forced decode steps against the forward over the prompt and
    those tokens. Mixture-of-experts models report the slots their served
    prefill dropped over capacity and the forward's aux loss, and run the
    teacher-forced check at a capacity that drops nothing (``capacity_factor
    = E / k``): at the served capacity a slot's fate depends on the tokens
    sharing its row, so a forward over all tokens and a one-token decode
    differ by design where an expert overflows. The vision gates are set to
    seeded values in [0.5, 1.5] (0 at initialisation would hide the
    cross-attention). Returns K7's cases for its row: the first (q, k, v)
    of every (shape, mask) these prefills gave it."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.models import audio, moe, transformer
    from repro_torch.models.api import model_api

    cfg, api, params, _, _ = model
    out: dict = {}
    report["generate"] = out
    rng = np.random.default_rng(args.seed + 20)
    dev = params["final_norm"]["w"].device
    card = card_line()

    b, s, n_new, max_seq = 8, 512, 64, 576
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                           device=dev)
    with torch.inference_mode():
        api.prefill(params, {"tokens": toks}, max_seq=max_seq)   # warm-up
        (first, cache), pre_s = drive_path(
            by_path, "generate-prefill",
            lambda: api.prefill(params, {"tokens": toks}, max_seq=max_seq))
        k7 = by_path["generate-prefill"]["flash_attention"]
        check(k7 == cfg.n_layers, f"[generate] K7 launched {k7} times in "
              f"the prefill, want {cfg.n_layers}")
        check(cache["pos"] == s, f"[generate] prefill pos {cache['pos']}")
        kv_bytes = param_bytes(cache["layers"])
        finite = torch.isfinite(first.float()).all()

        def greedy():
            nonlocal cache, finite
            logits = first
            for _ in range(n_new):
                tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
                logits, cache = api.decode(params, cache, tok)
                finite = finite & torch.isfinite(logits.float()).all()
        _, dec_s = drive_path(by_path, "generate-decode", greedy)
        k7 = by_path["generate-decode"]["flash_attention"]
        check(k7 == 0, f"[generate] K7 launched {k7} times in decode")
        check(cache["pos"] == s + n_new, f"[generate] pos {cache['pos']} "
              f"after {n_new} steps")
        check(bool(finite), "[generate] a non-finite logit")
        del cache
        full, _ = transformer.forward_train(params, cfg, toks)
        err_prefill = rel_err(first, full[:, -1], cfg.vocab_size)
        check(err_prefill <= PREFILL_TOL, f"[generate] prefill logits differ "
              f"from the forward's last position by {err_prefill}")
        del full
    # teacher-forced: prefill 448 tokens, decode the next 64 given ones, at
    # the full depth and on the first SHALLOW layers
    forced = teacher_forced(cfg, params, toks, {}, s - n_new)
    held(cfg.name, cfg, forced, forced_tol(cfg))
    scfg, sparams = shallow(cfg, params)
    forced_shallow = teacher_forced(scfg, sparams, toks, {}, s - n_new) \
        if scfg is not cfg else forced
    held(f"{cfg.name} first {scfg.n_layers} layers", scfg, forced_shallow,
         GENERATE_TOL)
    weights = param_bytes(params)
    # a decode step reads the weights and the live cache once: mean over
    # the 64 steps of 40 x 2 x B x (pos + 1) x d_model x 2 bytes
    live = 2 * cfg.n_layers * b * cfg.n_kv_heads * cfg.resolved_head_dim \
        * 2 * (s + (n_new + 1) / 2)
    bound_ms = (weights + live) / PEAK_BYTES_S * 1e3
    out["minicpm"] = {
        "model": cfg.name, "batch": b, "prompt": s, "new_tokens": n_new,
        "max_seq": max_seq, "prefill_s": pre_s,
        "prefill_tokens_per_s": b * s / pre_s, "decode_s": dec_s,
        "decode_ms_per_step": dec_s / n_new * 1e3,
        "decode_tokens_per_s": b * n_new / dec_s, "kv_cache_bytes": kv_bytes,
        "weight_bytes": weights, "decode_step_bound_ms": bound_ms,
        "prefill_err": err_prefill, "teacher_forced_err": forced["err"],
        "teacher_forced_limit": forced_tol(cfg),
        "teacher_forced_err_shallow": forced_shallow["err"],
        "launches": {p: by_path[p] for p in ("generate-prefill",
                                             "generate-decode")},
        "card": card}
    print(f"[generate] {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}): {b} prompts of {s} tokens, prefill "
          f"{pre_s:.4f}s = {b * s / pre_s:.0f} tokens/s (K7 "
          f"{by_path['generate-prefill']['flash_attention']}); {n_new} greedy "
          f"decode steps {dec_s:.4f}s = {dec_s / n_new * 1e3:.3f} ms a step = "
          f"{b * n_new / dec_s:.1f} tokens/s (K7 0); KV cache {kv_bytes} "
          f"bytes at max_seq {max_seq}; a step reads {weights} weight bytes "
          f"+ {live:.4g} cache bytes: bound {bound_ms:.4f} ms over "
          f"{PEAK_BYTES_S:.3g} B/s; card {card}", flush=True)
    print(f"[generate] {cfg.name}: prefill logits vs the forward's last "
          f"position {err_prefill:.3g} of the largest (limit "
          f"{PREFILL_TOL:.3g}); teacher-forced 448 + 64 vs the forward "
          f"{forced['err']:.4g} at {cfg.n_layers} layers (limit "
          f"{forced_tol(cfg):.4g}), {forced_shallow['err']:.4g} on the first "
          f"{scfg.n_layers} (limit {GENERATE_TOL}); every logit finite",
          flush=True)

    cases = []
    for arch, seq, depth in GENERATE_FAMILIES:
        fcfg = get_config(arch)
        if depth is not None:
            fcfg = dataclasses.replace(fcfg, n_layers=depth)
        fapi = model_api(fcfg)
        mod = audio if fcfg.family == "audio" else transformer
        torch.cuda.synchronize()
        ts = time.perf_counter()
        fparams = fapi.init(torch.Generator(device="cuda")
                            .manual_seed(args.seed))
        for blk in fparams["layers"] if fcfg.family == "vlm" else []:
            for gate in ("gate_a", "gate_m"):
                blk["cross"][gate].fill_(float(rng.uniform(0.5, 1.5)))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - ts
        ftoks = torch.as_tensor(rng.integers(0, fcfg.vocab_size,
                                             (2, seq + 8)), device=dev)
        extra = {}
        if fcfg.family == "vlm":
            extra["patches"] = torch.as_tensor(rng.standard_normal(
                (2, fcfg.vision_tokens, fcfg.vision_dim), np.float32),
                device=dev).to(torch.bfloat16)
        if fcfg.family == "audio":
            extra["frames"] = torch.as_tensor(rng.standard_normal(
                (2, fcfg.audio_frames, fcfg.d_model), np.float32),
                device=dev).to(torch.bfloat16)
        ex = extra or None
        prompt = {**extra, "tokens": ftoks[:, :seq]}
        with torch.inference_mode():                          # warm-up
            fapi.prefill(fparams, prompt, max_seq=seq + 8)
        rec = MaskRecorder(kernel_ops)
        drops = MoEDrops(moe)
        try:
            with torch.inference_mode():
                (plog, pcache), fpre_s = drive_path(
                    by_path, f"generate-{arch}-prefill",
                    lambda: fapi.prefill(fparams, prompt, max_seq=seq + 8))
        finally:
            rec.restore()
            drops.restore()
        k7, want = (by_path[f"generate-{arch}-prefill"]["flash_attention"],
                    attention_layers(fcfg))
        check(k7 == want, f"[generate] {arch}: K7 launched {k7} times in "
              f"the prefill, want {want}")
        with torch.inference_mode():
            flog, aux = mod.forward_train(fparams, fcfg, ftoks[:, :seq],
                                          extra=ex)
            f_err = rel_err(plog, flog[:, -1], fcfg.vocab_size)
            check(f_err <= PREFILL_TOL, f"[generate] {arch}: prefill logits "
                  f"differ from the forward's last position by {f_err}")
            del flog, plog, pcache
        path = f"generate-{arch}-decode"
        tf = teacher_forced(fcfg, fparams, ftoks, extra, seq, by_path, path)
        k7 = by_path[path]["flash_attention"]
        check(k7 == 0, f"[generate] {arch}: K7 launched {k7} times in decode")
        held(arch, fcfg, tf, forced_tol(fcfg))
        scfg, sparams = shallow(fcfg, fparams)
        tf_shallow = teacher_forced(scfg, sparams, ftoks, extra, seq) \
            if scfg is not fcfg else tf
        held(f"{arch} first {scfg.n_layers} layers", scfg, tf_shallow,
             GENERATE_TOL)
        fdec_s, t_err = tf["decode_s"], tf["err"]
        rep = {"layers": fcfg.n_layers, "enc_layers": fcfg.enc_layers,
               "depth_cut": depth is not None, "params": sum(
                   t.numel() for t in _tensors(fparams)),
               "init_s": init_s, "prompt": seq, "prefill_s": fpre_s,
               "prefill_tokens_per_s": 2 * seq / fpre_s,
               "decode_ms_per_step": fdec_s / 8 * 1e3,
               "prefill_err": f_err, "teacher_forced_err": t_err,
               "teacher_forced_limit": forced_tol(fcfg),
               "teacher_forced_err_shallow": tf_shallow["err"],
               "shallow_layers": scfg.n_layers,
               "k7_prefill": by_path[f"generate-{arch}-prefill"][
                   "flash_attention"]}
        if fcfg.moe is not None:
            rep.update(dropped_slots=drops.stats.get("dropped", 0),
                       slots=drops.stats.get("slots", 0), aux=float(aux),
                       near_tie_reroutes=tf["reroutes"])
        out[arch] = rep
        print(f"[generate] {arch} ({fcfg.n_layers} layers"
              f"{' (cut)' if depth else ''}, d_model {fcfg.d_model}, "
              f"{rep['params']} parameters in {init_s:.2f}s): B=2 prompts of "
              f"{seq} tokens, prefill {fpre_s:.4f}s (K7 {rep['k7_prefill']}),"
              f" 8 decode steps {fdec_s / 8 * 1e3:.3f} ms a step (K7 0); "
              f"prefill vs forward {f_err:.3g}, teacher-forced vs forward "
              f"{t_err:.4g} (limit {forced_tol(fcfg):.4g}), on the first "
              f"{scfg.n_layers} layers {tf_shallow['err']:.4g} (limit "
              f"{GENERATE_TOL})"
              + (f"; MoE slots dropped over capacity {rep['dropped_slots']}"
                 f" of {rep['slots']}, aux loss {rep['aux']:.6g}; teacher-"
                 f"forced run at no drop on the forward's expert choices "
                 f"({tf['reroutes']} near-tie tokens routed otherwise on "
                 f"their own)" if fcfg.moe is not None else ""), flush=True)
        for (shape, kvh, causal, window), qkv in rec.first.items():
            cases.append((f"generate {arch}", qkv, window, causal))
        del fparams, sparams, rec
        gc.collect()
        torch.cuda.empty_cache()
    return cases


def examples_phase(args, report: dict) -> None:
    """[examples] ``examples/torch/quickstart.py --n 2000`` and
    ``examples/torch/ingest_corpus.py`` as child processes on the card (the
    default device), one after the other: each must exit 0. (Side by side,
    each engine's cost-model probe timed its joins while the other's ran,
    and once measured a negative slope and raised.)"""
    import os
    import subprocess
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {"quickstart.py": ["--n", "2000"], "ingest_corpus.py": []}
    out: dict = {}
    report["examples"] = out
    with tempfile.TemporaryDirectory(prefix="nks-examples-") as tmp:
        env["TMPDIR"] = tmp
        ts = time.perf_counter()
        for name, argv in runs.items():
            child = subprocess.run(
                [sys.executable, str(ROOT / "examples" / "torch" / name),
                 *argv], capture_output=True, text=True, env=env, cwd=tmp,
                timeout=600)
            out[name] = {"rc": child.returncode,
                         "s": time.perf_counter() - ts,
                         "last": child.stdout.strip().splitlines()[-1:]}
            check(child.returncode == 0, f"[examples] {name} exited "
                  f"{child.returncode}:\n{child.stderr[-2000:]}")
            print(f"[examples] {name} {' '.join(runs[name])}: exit 0 after "
                  f"{out[name]['s']:.1f}s; last line {out[name]['last']}",
                  flush=True)


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
                kept[path] = answers[tier]      # for [store] and [plane]
                served[5]["qps"][path] = rep[tier]["qps"]
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
            fq, pool = feasible_queries(ds, eligible, args.filter_feasible,
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
    """Wraps ``kernels.ops.flash_attention`` while an embed path runs:
    counts calls per q shape and keeps a copy of the first (q, k, v) of
    each, also when pipeline workers call it from several threads."""

    def __init__(self, ops):
        import threading
        self.ops, self.fn = ops, ops.flash_attention
        self.calls: dict[tuple, int] = {}
        self.first: dict[tuple, tuple] = {}
        self.lock = threading.Lock()
        ops.flash_attention = self

    def key(self, q, k, kw) -> tuple:
        return tuple(q.shape)

    def __call__(self, q, k, v, **kw):
        key = self.key(q, k, kw)
        with self.lock:
            self.calls[key] = self.calls.get(key, 0) + 1
            if key not in self.first:
                self.first[key] = (q.clone(), k.clone(), v.clone())
        return self.fn(q, k, v, **kw)

    def restore(self) -> None:
        self.ops.flash_attention = self.fn


class MaskRecorder(ShapeRecorder):
    """A :class:`ShapeRecorder` keyed by the attention's mask too: (q
    shape, kv heads, causal, window)."""

    def key(self, q, k, kw) -> tuple:
        return (tuple(q.shape), k.shape[2], kw.get("causal", True),
                kw.get("window"))


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
    return rec, k7, rec_diam, k6, rec_k5, k5, (cfg, api, params, engine,
                                                queries)


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


def profile_window(fn, owns: list[tuple[str, str, str]]) -> dict:
    """Run ``fn()`` once under torch.profiler (CPU and CUDA activity,
    every event kept): its wall, summed kernel time, busy share (kernel
    time / wall) and the share of kernel time of each hand-written kernel
    in ``owns`` = [(label, name mark, launch counter), ...], of matrix
    products (cuBLAS/CUTLASS kernels) and of everything else. Each own
    kernel's profiler events are counted against its launch counter over
    the window: where any differ, the figures are None beside the counts,
    since the profiler lost events. Returns ``{}`` if it saw no device
    time."""
    before = launch_counts()
    kernels, wall = profiled(fn, 1)
    after = launch_counts()
    total = sum(v[0] for v in kernels.values())
    if total <= 0.0:
        return {}
    counts = {"own_events": {label: marked(kernels, mark)[1]
                             for label, mark, _ in owns},
              "own_launches": {label: after[c] - before[c]
                               for label, _, c in owns},
              "kernel_events": sum(v[1] for v in kernels.values()),
              "kernel_names": sorted(k[:160] for k in kernels)}
    if counts["own_events"] != counts["own_launches"]:
        return {"wall_s": wall, "kernel_s": None, "busy_share": None,
                "share_of_kernel_time": None, "kernel_s_by_kind": None,
                **counts}
    kinds = {label: 0.0 for label, _, _ in owns}
    kinds.update(matmul=0.0, other=0.0)
    for name, (sec, _) in kernels.items():
        kind = next((label for label, mark, _ in owns if mark in name),
                    "matmul" if any(m in name.lower() for m in MATMUL_MARKS)
                    else "other")
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
    prof = profile_window(run, [("flash_attention (K7)", "flash_fwd",
                                 "flash_attention")])
    return {"batches": len(batches), **prof} if prof else {}


def flash_row(rec: ShapeRecorder, k7_by_path: dict,
              profiles: KernelProfiles, extra=()) -> dict:
    """K7 against its plain version at the embed path's shapes, two
    variants and the ``extra`` cases (label, (q, k, v), window, causal[,
    with_lse]) that other paths recorded; with ``with_lse`` (the train
    step's call) the row log-sum-exp too, within ``LSE_TOL`` of the plain
    version's; timings with CUDA events beside
    ``F.scaled_dot_product_attention`` on the same inputs, and the kernel's
    device time from the fresh-process profiler. Each case has its own
    numbers; the row's own are those of the shape the embed path launched
    most."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    def sdpa(q, k, v, window, causal):
        """The library's attention on the same inputs, under the same
        mask."""
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        mask = None
        if window is not None:
            i = torch.arange(q.shape[1], device=q.device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                  - window)
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
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
    cases = [("path", rec.first[sh], None, True) for sh in shapes]
    cases.append(("path+window", rec.first[longest], 1024, True))
    cases.append(("gqa", gqa, None, True))
    cases += list(extra)
    rows = []
    shared: dict = {}        # the row; the profiler fills its device_ms too
    for label, (q, k, v), window, causal, *with_lse in cases:
        b, s, h, hd = q.shape
        kw = dict(causal=causal, window=window, return_lse=any(with_lse))
        got = FA.flash_attention(q, k, v, **kw)
        want = ref.flash_attention(q, k, v, **kw)
        lse_err = None
        if kw["return_lse"]:
            (got, got_lse), (want, want_lse) = got, want
            lse_err = float((got_lse - want_lse).abs().max())
            check(lse_err <= LSE_TOL, f"K7 {label} {tuple(q.shape)}: the row "
                  f"log-sum-exp differs from the plain version's by {lse_err}")
            del got_lse, want_lse
        tol = ref.flash_attention_tolerance(q, k, v, want, causal=causal,
                                            window=window).clamp_min_(1e-30)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        max_err = float(err.max())
        err_over_tol = float((err / tol).max())
        check(err_over_tol <= 1.0,
              f"K7 {label} {tuple(q.shape)}: differs from the plain version "
              f"by {max_err} ({err_over_tol} of the bf16 tolerance)")
        fault = None
        if window is None and causal and s >= 128:
            fault = float(((dropped_tile(q, k, v).float()
                            - want[:, s - 64:].float()).abs()
                           / tol[:, s - 64:]).max())
            check(fault > 1.0, f"K7 {label}: a dropped key tile stays "
                               f"within the tolerance ({fault} of it)")
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) \
            + (4.0 * b * h * s if kw["return_lse"] else 0.0)
        b_ms, b_by = bound(attention_flops(b, s, h, hd, k.shape[1], causal,
                                           window), nbytes, PEAK_BF16_FLOPS)
        plain_abs = want.float().abs()
        stats = dict(max_abs_plain=float(plain_abs.max()),
                     rms_plain=float(plain_abs.square().mean().sqrt()),
                     median_row_rms_plain=float(
                         plain_abs.square().mean(-1).sqrt().median()),
                     max_err_over_tol=err_over_tol,
                     dropped_tile_err_over_tol=fault, lse=kw["return_lse"],
                     lse_max_abs_err=lse_err)
        del got, want, err, tol, plain_abs
        # kernel and library in turns: kernel, sdpa, sdpa, kernel
        ms_k = [cuda_ms(lambda: FA.flash_attention(q, k, v, **kw), 20)]
        ms_l = [cuda_ms(lambda: sdpa(q, k, v, window, causal), 20)
                for _ in range(2)]
        ms_k.append(cuda_ms(lambda: FA.flash_attention(q, k, v, **kw), 20))
        rows.append(dict(
            case=label, shape=list(q.shape), kv_heads=k.shape[2],
            window=window, causal=causal, max_abs_err=max_err, **stats,
            ms=sum(ms_k) / 2, ms_runs=ms_k,
            plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v, **kw), 3,
                             warmup=1),
            library_ms=sum(ms_l) / 2, library_ms_runs=ms_l,
            ratio_to_library=sum(ms_k) / sum(ms_l),
            bound_ms=b_ms, bound_by=b_by))
        targets = (rows[-1], shared) if len(rows) == 1 else (rows[-1],)
        profiles.add(f"K7 {label} {tuple(q.shape)}",
                     "flash_attention.flash_attention", (q, k, v), "flash_fwd",
                     "flash_attention", 20, *targets, **kw)
        torch.cuda.empty_cache()
        print(f"[kernel] flash_attention {label} {tuple(q.shape)} kv "
              f"{k.shape[2]} causal {causal} window {window} lse "
              f"{kw['return_lse']}: "
              f"{rows[-1]['ms']:.4f} ms "
              f"(runs {ms_k}; plain {rows[-1]['plain_ms']:.4f} ms, sdpa "
              f"{rows[-1]['library_ms']:.4f} ms (runs {ms_l}), kernel/sdpa "
              f"{rows[-1]['ratio_to_library']:.3f}, bound {b_ms:.4f} ms by "
              f"{b_by}); max_abs_err {rows[-1]['max_abs_err']}, max|plain| "
              f"{stats['max_abs_plain']}, rms(plain) {stats['rms_plain']}, "
              f"err/tol {err_over_tol}, dropped tile err/tol {fault}, lse "
              f"max_abs_err {lse_err}", flush=True)
    main_case = rows[0]
    shared.update(dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:99",
                launches=k7_by_path["embed"], path="embed",
                launches_by_path=k7_by_path,
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
    prof = profile_window(fn, [("anchor_star (K6)", "anchor_star_",
                                "anchor_star")])
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


def star_check(groups, mask, got, want, label: str,
               anchor_range=None) -> dict:
    """The fused kernel's outputs against the plain version's on the valid
    anchors (of ``anchor_range`` ``(a0, count)``, default all; phase 6):
    each neighbour's float64 distance to its anchor within the query's band
    of the plain one's, worst_nn likewise, and the diameters within rtol
    1e-5 plus the band of the plain diameters of the kernel's own tuples."""
    import torch
    from repro_torch.kernels import ref
    q, r, d = groups.shape
    a0, count = anchor_range or (0, r)
    pts = groups[mask].double()
    band = float(((64.0 + 4.0 * d) * EPS32 * (pts - pts.mean(0)).square()
                  .sum(-1).max()).sqrt()) if len(pts) else 0.0
    (nn, worst, diam), (nn_p, worst_p, _) = got, want
    valid = mask[0, a0:a0 + count]
    a64 = groups[0, a0:a0 + count].double()[valid]
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


def composition(groups, mask, anchor_range=None):
    """The device tier's neighbour stage as it was before the fused kernel:
    the plain version's cuBLAS products, torch passes and argmin, with the
    standalone K6 kernel for the diameters (the yardstick ``library_ms``)."""
    from repro_torch.kernels import diameter as D
    from repro_torch.kernels import ref
    plain = ref.tuple_diameters
    ref.tuple_diameters = D.tuple_diameters
    try:
        return ref.anchor_star(groups, mask, anchor_range=anchor_range)
    finally:
        ref.tuple_diameters = plain


def anchor_star_row(cases: list, launches_by_path: dict,
                    profiles: KernelProfiles) -> tuple[dict, list]:
    """The fused anchor-star kernel against its plain version at each
    recorded input (label, Recorder of ``ops.anchor_star``, shard): timings
    with CUDA events beside the plain version and the composition it
    replaced; the bound counts this input's valid anchors and points. A
    case with ``shard`` ``(i, n)`` scores only shard i's anchor range of n
    (a0 = i R / n, as the plane gives it); its valid rows must equal the
    same rows of the whole call bit for bit. Returns the row (its own
    numbers those of the first case, the main device batch's largest input)
    and, per whole case, the (R, q, d) tuples its neighbours form (the
    standalone K6's inputs)."""
    import torch
    from repro_torch.kernels import diameter as D
    from repro_torch.kernels import ref

    rows, tuples = [], []
    for label, rec, shard in cases:
        groups, mask = rec.best[:2]
        q, r, d = groups.shape
        rng = None if shard is None \
            else (shard[0] * r // shard[1], r // shard[1])
        a0, count = rng or (0, r)
        got = D.anchor_star(groups, mask, anchor_range=rng)
        want = ref.anchor_star(groups, mask, anchor_range=rng)
        torch.cuda.synchronize()
        res = star_check(groups, mask, got, want, label, rng)
        nn = got[0]
        if rng is None:
            tuples.append((label, torch.stack(
                [groups[j][nn[:, j].long()] for j in range(q)],
                1).contiguous()))
        else:
            whole = D.anchor_star(groups, mask)
            live = mask[0, a0:a0 + count]
            same = all(torch.equal(g[live], w[a0:a0 + count][live])
                       for g, w in zip(got, whole))
            check(a0 % 128 != 0 and same,
                  f"K6 {label}: the range ({a0}, {count}) rows differ from "
                  f"the same rows of the whole call, or a0 is a multiple "
                  f"of 128")
            res["rows_equal_whole_call"] = same
            res["anchor_range"] = [a0, count]
        a_valid = int(mask[0, a0:a0 + count].sum())
        r_valid = [int(mask[j].sum()) for j in range(1, q)]
        flops = 2.0 * a_valid * d * sum(r_valid) + 2.0 * a_valid * q * q * d
        nbytes = (a_valid + sum(r_valid)) * d * 4.0 + q * r \
            + count * (4.0 * q + 8)
        b_ms, b_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
        pad_ms, _ = bound(2.0 * count * d * (q - 1) * r,
                          q * r * (d * 4.0 + 1), PEAK_FP32_FLOPS)
        kernel = lambda: D.anchor_star(groups, mask,          # noqa: E731
                                       anchor_range=rng)
        plain = lambda: ref.anchor_star(groups, mask,         # noqa: E731
                                        anchor_range=rng)
        lib = lambda: composition(groups, mask, rng)          # noqa: E731
        reps_k, reps_p = adaptive_reps(kernel), adaptive_reps(plain, 3000.0)
        rows.append(dict(
            case=label, shape=[q, r, d], valid_anchors=a_valid,
            valid_points=r_valid, **res,
            ms=cuda_ms(kernel, reps_k), plain_ms=cuda_ms(plain, reps_p),
            library_ms=cuda_ms(lib, reps_p), bound_ms=b_ms, bound_by=b_by,
            padded_bound_ms=pad_ms, reps=reps_k))
        c = rows[-1]
        c["library_over_kernel"] = c["library_ms"] / c["ms"]
        print(f"[kernel] anchor_star {label} (q, R, d) {c['shape']}"
              f"{'' if rng is None else f', anchors {a0}..{a0 + count - 1}'}"
              f", valid anchors {a_valid}, valid points {r_valid}: "
              f"{c['ms']:.4f} ms "
              f"(plain {c['plain_ms']:.4f} ms, composition "
              f"{c['library_ms']:.4f} ms = {c['library_over_kernel']:.2f}x "
              f"the kernel, bound {b_ms:.5f} ms by {b_by}, at the padded "
              f"shape {pad_ms:.5f} ms); neighbour distance err "
              f"{res['nn_dist_err']:.3g} ({res['nn_differ']} neighbours "
              f"differ), worst err {res['worst_err']:.3g}, diameter err "
              f"{res['diam_err']:.3g}, band {res['band']:.3g}", flush=True)
        profiles.add(f"K6 anchor_star {label}", "diameter.anchor_star",
                     (groups, mask), "anchor_star_", "anchor_star",
                     max(3, min(50, int(1000.0 / c["ms"]))), c,
                     **({} if rng is None else {"anchor_range": rng}))
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


# [train]: K7b's cases (label, (B, S, H, Kv, hd), window), all causal:
# MiniCPM-2B's train shape, embedder-100m's, hymba's window and a hd-128
# grouped-query shape (llama4's heads).
K7B_CASES = (("minicpm-2b train", (2, 4096, 36, 36, 64), None),
             ("embedder-100m train", (8, 512, 12, 4, 64), None),
             ("hymba window", (2, 2048, 25, 5, 64), 1024),
             ("llama4 gqa hd128", (2, 512, 40, 8, 128), None),
             # [shard]: a (dp, tp) shard's heads of MiniCPM-2B, in the
             # sharded step (a) and in the launcher's child (d)
             ("shard step", (1, 512, 18, 18, 64), None),
             ("shard launcher", (1, 4096, 18, 18, 64), None))
# The CPU tests' training tolerances (tests/test_torch_train_grads.py,
# tests/test_torch_train.py): the loss within 2^-8; each gradient leaf
# within 2^-4 of its norm plus 2^-10 of the largest leaf's norm.
TRAIN_LOSS, TRAIN_LEAF, TRAIN_FLOOR = 2.0 ** -8, 2.0 ** -4, 2.0 ** -10
# A resumed run's losses against an uninterrupted run's, relative: the two
# runs differ only where the embedding's backward sums repeated tokens'
# bf16 gradients by atomics, in an order that changes from run to run (one
# bf16 rounding of a few rows of the table's gradient, then AdamW steps of
# lr <= 3e-4 from there).
RESUME_TOL = 2.0 ** -10
K7B_MARK = "bwd_"                 # K7b's kernels: bwd_prep, bwd_dkdv, bwd_dq
K7B_PARTS = ("bwd_prep", "bwd_dkdv", "bwd_dq")
# The previous K7b design's times at K7B_CASES (mma.sync from shared memory,
# no TMA; blocks of 64 keys or queries): ms by events and device ms by the
# profiler, on an H100 80GB HBM3 at 700 W.
K7B_WAS = {"minicpm-2b train": (3.9285, 3.8703),
           "embedder-100m train": (0.1809, 0.1742),
           "hymba window": (0.6866, 0.7077),
           "llama4 gqa hd128": (0.3990, 0.3906)}
# K7's row log-sum-exp (fp32) against the plain version's, absolute: the two
# sum the same fp32 exponentials in other orders (the kernel's exp the fast
# one), ~2^-20 relative of lse ~ log(T) <= 12.
LSE_TOL = 1e-4


def attention_bwd_flops(b, s, h, hd, causal=True, window=None) -> float:
    """With the row statistics given, the backward recomputes S = QK^T and
    takes dV, dP, dQ and dK over the live pairs: 10 hd flops per pair."""
    return 10.0 * hd * b * h * live_pairs(s, s, causal, window)


def tree_allclose(got, want, label: str) -> float:
    """Each leaf of ``got`` within ``TRAIN_LEAF`` of the norm of ``want``'s
    plus ``TRAIN_FLOOR`` of the largest leaf norm; returns the worst ratio
    of the difference to the leaf's norm."""
    from repro_torch.train.optimizer import tree_leaves
    g, w = tree_leaves(got), tree_leaves(want)
    check(len(g) == len(w), f"{label}: {len(g)} leaves against {len(w)}")
    norms = [float(x.float().norm()) for x in w]
    floor = TRAIN_FLOOR * max(norms)
    worst = 0.0
    for i, (a, b, n) in enumerate(zip(g, w, norms)):
        err = float((a.float().cpu() - b.float().cpu()).norm())
        check(bool(a.float().isfinite().all()), f"{label}: leaf {i} not "
              f"finite")
        check(err <= TRAIN_LEAF * n + floor, f"{label}: leaf {i} {tuple(b.shape)} "
              f"differs by {err} (norm {n}, floor {floor})")
        worst = max(worst, err / max(n, 1e-30))
    return worst


def train_full(args, report: dict, by_path: dict) -> None:
    """[train] (c) ``launch/train.py``'s entry point for MiniCPM-2B at full
    width and depth: 3 steps at global batch 2 and sequence 4,096 (cut from
    train_4k's 256 to one card), remat on, bf16 optimizer state, fp32
    master parameters; then one more step under the profiler."""
    import gc
    import os
    import tempfile
    import torch
    from repro_torch.data.token_pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.step import make_train_step
    from repro_torch.models.api import count_params, model_api
    from repro_torch.train.optimizer import OptimizerConfig, tree_leaves

    out = report.setdefault("train", {})
    steps, gb, seq = 3, 2, 4096
    tmp = tempfile.mkdtemp(prefix="chip-train-")
    argv = ["--arch", "minicpm-2b", "--steps", str(steps), "--global-batch",
            str(gb), "--seq-len", str(seq), "--ckpt-dir", tmp,
            "--ckpt-every", "1000"]
    torch.cuda.reset_peak_memory_stats()
    # one card, one shard: the production mesh's override at 1 x 1
    saved = os.environ.get("REPRO_MESH_OVERRIDE")
    os.environ["REPRO_MESH_OVERRIDE"] = "1,1"
    try:
        (cfg, state, hist), wall = drive_path(
            by_path, "train", lambda: train_launch.run(
                train_launch.parser().parse_args(argv)))
    finally:
        if saved is None:
            del os.environ["REPRO_MESH_OVERRIDE"]
        else:
            os.environ["REPRO_MESH_OVERRIDE"] = saved
    peak = torch.cuda.max_memory_allocated()
    c = by_path["train"]
    layers = cfg.n_layers
    check(c["flash_attention"] == 2 * layers * steps,
          f"[train] K7 launched {c['flash_attention']} times in {steps} "
          f"steps, want 2 x {layers} a step (forward and remat)")
    check(c["flash_attention_bwd"] == 3 * layers * steps,
          f"[train] K7b launched {c['flash_attention_bwd']} kernels in "
          f"{steps} steps, want one call (3 kernels) a layer a step")
    check([h["step"] for h in hist] == list(range(steps)),
          f"[train] steps {[h['step'] for h in hist]}")
    for h in hist:
        check(all(math.isfinite(h[k]) for k in ("loss", "grad_norm", "lr")),
              f"[train] a non-finite metric: {h}")
    check(all(t.dtype == torch.float32 for t in tree_leaves(state["params"]))
          and all(t.dtype == torch.bfloat16
                  for t in tree_leaves(state["opt"]["m"])),
          "[train] state types: want fp32 masters and bf16 moments")
    dev = state["params"]["final_norm"]["w"].device
    api = model_api(cfg)
    init = api.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    still = sum(torch.equal(p, i.float()) for p, i in
                zip(tree_leaves(state["params"]), tree_leaves(init)))
    del init
    check(still == 0, f"[train] {still} parameter leaves did not move")
    n_params = count_params(cfg)
    tokens = gb * seq
    attn = 3.0 * attention_flops(gb, seq, cfg.n_heads, cfg.resolved_head_dim) \
        * layers
    model_flops = 6.0 * n_params * tokens + attn
    step_s = [h["time_s"] for h in hist]
    steady = sum(step_s[1:]) / len(step_s[1:])
    opt_cfg = OptimizerConfig(total_steps=steps, schedule=cfg.schedule,
                              state_dtype="bfloat16")
    batch = train_launch.batch_to(TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=gb, seq_len=seq))
        .batch_at(steps), dev)
    step_fn = make_train_step(cfg, opt_cfg)
    prof = profile_window(
        lambda: step_fn(state["params"], state["opt"], batch),
        [("K7", "flash_fwd", "flash_attention"),
         ("K7b", K7B_MARK, "flash_attention_bwd")])
    out["minicpm"] = dict(
        argv=argv, steps=hist, step_s=step_s, steady_step_s=steady,
        tokens_per_step=tokens, tokens_per_s=tokens / steady,
        params=n_params, model_flops_per_step=model_flops,
        model_flop_share=model_flops / steady / PEAK_BF16_FLOPS,
        max_memory_allocated=peak, wall_s=wall, launches=c,
        profile=prof, card=card_line())
    del state, batch, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    m = out["minicpm"]
    print(f"[train] {cfg.name} ({layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters, fp32 masters, bf16 moments, remat): "
          f"{steps} steps at B={gb} S={seq}, losses "
          f"{[round(h['loss'], 5) for h in hist]}, grad norms "
          f"{[round(h['grad_norm'], 5) for h in hist]}; step seconds "
          f"{[round(s, 4) for s in step_s]} (steady {steady:.4f} s = "
          f"{tokens / steady:.0f} tokens/s, model-FLOP share "
          f"{m['model_flop_share']:.3f} of 989 TFLOP/s); "
          f"max_memory_allocated {peak} bytes; K7 {c['flash_attention']} "
          f"launches, K7b {c['flash_attention_bwd']} kernels; every leaf "
          f"moved; card {m['card']}", flush=True)
    print(f"[train] profiler, one more step: wall {prof.get('wall_s')} s, "
          f"kernels {prof.get('kernel_s')} s (busy {prof.get('busy_share')}), "
          f"seconds by kind {prof.get('kernel_s_by_kind')}; events "
          f"{prof.get('own_events')} for {prof.get('own_launches')} "
          f"launches", flush=True)


def train_grads(args, report: dict, by_path: dict) -> None:
    """[train] (b) MiniCPM-2B cut in depth to 2 layers at full width, B=1,
    S=512: the loss and every leaf's gradient on the card (K7, K7b) against
    the same parameters and batch on the CPU (the plain versions), then
    the AdamW update that follows on both."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.token_pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.step import value_and_grad
    from repro_torch.launch.train import batch_to
    from repro_torch.models.api import master_params, model_api
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                             init_opt_state, tree_leaves,
                                             tree_map)

    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=2)
    on_card = master_params(model_api(cfg).init(
        torch.Generator(device="cuda").manual_seed(args.seed + 27),
        device="cuda"))
    params = tree_map(lambda t: t.cpu(), on_card)
    host_batch = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=1, seq_len=512,
        seed=args.seed)).batch_at(0)
    (loss, metrics, grads), wall = drive_path(
        by_path, "train-grads", lambda: value_and_grad(
            cfg, on_card, batch_to(host_batch, "cuda")))
    c = by_path["train-grads"]
    check(c["flash_attention"] == 2 * cfg.n_layers
          and c["flash_attention_bwd"] == 3 * cfg.n_layers,
          f"[train] {cfg.n_layers}-layer gradients launched K7 "
          f"{c['flash_attention']} and K7b {c['flash_attention_bwd']} "
          f"kernels, want 2 and 3 a layer")
    ts = time.perf_counter()
    want_loss, _, want = value_and_grad(cfg, params,
                                        batch_to(host_batch, "cpu"))
    cpu_s = time.perf_counter() - ts
    check(abs(float(loss) - float(want_loss)) <= TRAIN_LOSS
          * abs(float(want_loss)), f"[train] 2-layer loss {float(loss)} "
          f"on the card, {float(want_loss)} on the CPU")
    grad_worst = tree_allclose(grads, want, "[train] 2-layer gradients")
    opt_cfg = OptimizerConfig(total_steps=10, warmup_steps=2,
                              schedule="wsd", peak_lr=1e-3)
    states = [init_opt_state(p, opt_cfg) for p in (on_card, params)]
    init = tree_map(torch.clone, params)
    _, _, om = adamw_update(on_card, grads, states[0], opt_cfg)
    _, _, om_cpu = adamw_update(params, want, states[1], opt_cfg)
    lr = float(om_cpu["lr"])
    # A first AdamW step moves each element by lr g/(|g| + eps) (plus the
    # decay): where the two gradients surely share a sign (|g| above twice
    # their difference) and |g| clipped is far above eps, the two moves
    # agree to 3% of lr (eps/|g| <= 1% on each side) plus fp32 roundings of
    # the parameter, and a move of the wrong sign is 2 lr off. The elements
    # held so must be a tenth of those with a gradient at least (0.309 in
    # a run on an H100: 0.88-0.99 of every layer's and norm's leaf, 0.027
    # of the tied table's).
    clip = min(1.0, 1.0 / float(om_cpu["grad_norm"]))
    sure_n = nonzero_n = 0
    by_leaf = []
    for a, b, ga, gb in zip(tree_leaves(on_card), tree_leaves(params),
                            tree_leaves(grads), tree_leaves(want)):
        ga, gb = ga.float().cpu(), gb.float()
        sure = (gb.abs() > 2 * (ga - gb).abs()) & (gb.abs() * clip > 1e-6)
        d = (a.cpu() - b).abs()[sure]
        check(bool((d <= 0.03 * lr + 2.0 ** -21 * b.abs()[sure]).all()),
              f"[train] 2-layer AdamW: a parameter "
              f"{float(d.max()) if d.numel() else 0.0} from "
              f"the CPU's where the gradients share a sign (lr {lr})")
        sure_n += int(sure.sum())
        nonzero_n += int((gb != 0).sum())
        by_leaf.append((list(gb.shape), int(sure.sum()) / max(
            int((gb != 0).sum()), 1)))
    sure_share = sure_n / max(nonzero_n, 1)
    check(sure_share >= 0.1, f"[train] 2-layer AdamW: the gradients share a "
          f"sure sign on {sure_share} of the elements only")
    step_worst = 0.0
    for a, b, p0 in zip(tree_leaves(on_card), tree_leaves(params),
                        tree_leaves(init)):
        ref_step = (b - p0).norm()
        err = float((a.cpu() - b).norm())
        check(err <= 0.25 * float(ref_step) + 1e-6,
              f"[train] 2-layer AdamW step differs by {err} (step "
              f"{float(ref_step)})")
        step_worst = max(step_worst, err / max(float(ref_step), 1e-30))
    m_worst = tree_allclose(states[0]["m"], states[1]["m"],
                            "[train] 2-layer AdamW m")
    report.setdefault("train", {})["grads"] = dict(
        loss_card=float(loss), loss_cpu=float(want_loss),
        grad_norm_card=float(om["grad_norm"]),
        grad_norm_cpu=float(om_cpu["grad_norm"]),
        worst_leaf_rel=grad_worst, worst_step_rel=step_worst,
        sure_sign_share=sure_share, sure_sign_share_by_leaf=by_leaf,
        worst_m_rel=m_worst, card_s=wall, cpu_s=cpu_s, launches=c)
    print(f"[train] minicpm-2b cut to 2 layers at full width, B=1 S=512: "
          f"loss {float(loss):.6f} on the card, {float(want_loss):.6f} on the "
          f"CPU; every gradient leaf within {TRAIN_LEAF} of its norm (worst "
          f"{grad_worst:.5f}); AdamW: moves within 3% of lr where the "
          f"gradients surely share a sign ({sure_share:.4f} of the nonzero "
          f"ones), steps within 1/4 (worst {step_worst:.5f}), m worst "
          f"{m_worst:.5f}; card "
          f"{wall:.3f}s, CPU {cpu_s:.3f}s", flush=True)
    del on_card, grads, states, params, want, init
    gc.collect()
    torch.cuda.empty_cache()


def load_example(name: str):
    """A module of ``examples/torch`` by file (the examples are scripts,
    not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_resume(args, report: dict, by_path: dict) -> None:
    """[train] (d) The fault-tolerant loop at embedder-100m's full size (12
    x 768, vocab 32,000; ``examples/torch/train_embedder.py``'s config,
    ``launch.train.trainer``), B=8, S=512, bf16 optimizer state: 6
    uninterrupted steps; then 6 checkpointed every 3 with a SIGTERM in step
    4 (the loop saves step 5 and stops); every leaf restored from that
    checkpoint hashes to its manifest's sha256; a second loop resumes at
    step 5. The interrupted and resumed losses equal the uninterrupted
    run's within ``RESUME_TOL``."""
    import gc
    import json
    import os
    import shutil
    import signal
    import tempfile
    import torch
    from repro_torch.ckpt.checkpoint import (find_latest, leaf_digests,
                                             load_checkpoint)
    from repro_torch.data.token_pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch.train import trainer
    from repro_torch.models.api import count_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_loop import LoopConfig, TrainLoop

    cfg = load_example("train_embedder").EMBEDDER
    steps, b, s = 6, 8, 512
    opt_cfg = OptimizerConfig(peak_lr=3e-4, warmup_steps=2, total_steps=steps,
                              schedule="wsd", state_dtype="bfloat16")
    init_state, stepper = trainer(cfg, opt_cfg, torch.device("cuda"))
    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        global_batch=b, seq_len=s,
                                        seed=args.seed))
    n_params = count_params(cfg)
    tmp = tempfile.mkdtemp(prefix="chip-train-ckpt-")
    disk_room(tmp, 3 * n_params * 8.0, "train")
    try:
        (_, straight), wall_a = drive_path(
            by_path, "train-embedder", TrainLoop(LoopConfig(
                total_steps=steps, ckpt_dir=os.path.join(tmp, "a"),
                ckpt_every=1000), stepper, pipe, init_state).run)
        c = by_path["train-embedder"]
        check(c["flash_attention"] == 2 * cfg.n_layers * steps
              and c["flash_attention_bwd"] == 3 * cfg.n_layers * steps,
              f"[train] embedder loop launches {c}")
        calls = [0]

        def preempted(state, batch):
            calls[0] += 1
            if calls[0] == 5:                      # during step 4
                os.kill(os.getpid(), signal.SIGTERM)
            return stepper(state, batch)
        ck = os.path.join(tmp, "b")
        ts = time.perf_counter()
        _, first = TrainLoop(LoopConfig(total_steps=steps, ckpt_dir=ck,
                                        ckpt_every=3), preempted, pipe,
                             init_state).run()
        wall_b = time.perf_counter() - ts
        check([h["step"] for h in first] == [0, 1, 2, 3, 4],
              f"[train] the preempted loop ran {[h['step'] for h in first]}")
        latest = find_latest(ck)
        check(latest is not None and latest.endswith("step_00000005"),
              f"[train] latest checkpoint {latest}")
        ts = time.perf_counter()
        restored, step, extra = load_checkpoint(latest, init_state())
        load_s = time.perf_counter() - ts
        with open(os.path.join(latest, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        digests = leaf_digests(restored)
        check(step == 5 and extra == {"next_step": 5}
              and set(digests) == set(manifest)
              and all(digests[k] == manifest[k]["sha256"] for k in digests),
              "[train] a restored leaf's sha256 differs from the manifest's")
        bf16 = sum(v["dtype"] == "bfloat16" for v in manifest.values())
        del restored
        (_, resumed), wall_c = drive_path(
            by_path, "train-embedder-resume", TrainLoop(LoopConfig(
                total_steps=steps, ckpt_dir=ck, ckpt_every=3), stepper, pipe,
                init_state).run)
        check([h["step"] for h in resumed] == [5],
              f"[train] the resumed loop ran {[h['step'] for h in resumed]}")
        got = [h["loss"] for h in first + resumed]
        want = [h["loss"] for h in straight]
        worst = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        check(all(math.isfinite(x) for x in got + want) and worst <= RESUME_TOL,
              f"[train] interrupted and resumed losses {got} against "
              f"uninterrupted {want} (worst {worst})")
        ckpt_bytes = sum(os.path.getsize(os.path.join(latest, f))
                         for f in os.listdir(latest))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    step_s = [h["time_s"] for h in straight]
    report.setdefault("train", {})["embedder"] = dict(
        params=n_params, losses_uninterrupted=want, losses_resumed=got,
        worst_rel=worst, step_s=step_s, walls_s=[wall_a, wall_b, wall_c],
        restore_s=load_s, checkpoint_bytes=ckpt_bytes, bf16_leaves=bf16,
        launches=c)
    print(f"[train] {cfg.name} ({n_params} parameters), B={b} S={s}, bf16 "
          f"moments: 6 steps in {wall_a:.3f}s (step seconds "
          f"{[round(x, 4) for x in step_s]}); SIGTERM in step 4 -> saved "
          f"step 5 ({ckpt_bytes} bytes, {bf16} bf16 leaves), restored in "
          f"{load_s:.3f}s with every leaf's sha256 equal to the manifest's; "
          f"resumed at step 5; losses within {worst:.3g} of the "
          f"uninterrupted run's (limit {RESUME_TOL:.3g})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()


# [shard] (a): each leaf's step (the parameter's move) within this share of
# the unsharded step's in norm. Readings on an H100 80GB HBM3 at 700 W: the
# sound step 0.0882 in three runs (near-zero gradients move either way); the
# control, the same step with one dp shard's gradient dropped, 0.8148 (its
# worst gradient leaf 0.518 of the norm, against 0.0074 sound). 1/4 lies
# near their geometric mean, 2.8x above the one and 3.3x below the other.
SHARD_STEP_TOL = 0.25

# [shard]: the sharded training side on a (pod, data, model) mesh dealt onto
# the one card. The launcher's child (d) reports its rows, steps and launch
# counters as its last line.
SHARD_CHILD = r'''
import json, sys, time
import torch
from repro_torch.data.token_pipeline import TokenPipeline
from repro_torch.kernels import diameter, flash_attention, pairwise_l2
from repro_torch.kernels import project_bin
from repro_torch.launch import train
rows = []
batch_at = TokenPipeline.batch_at
def recorded(self, step, dp_rank=0, dp_size=1):
    out = batch_at(self, step, dp_rank, dp_size)
    rows.append([step, dp_rank, dp_size, int(out["tokens"].shape[0])])
    return out
TokenPipeline.batch_at = recorded
torch.cuda.reset_peak_memory_stats()
ts = time.perf_counter()
cfg, state, hist = train.run(train.parser().parse_args(sys.argv[1:]))
wall = time.perf_counter() - ts
launches = {}
for mod in (pairwise_l2, diameter, project_bin, flash_attention):
    launches.update(mod.launches)
print(json.dumps({"rows": rows, "steps": hist, "wall_s": wall,
                  "n_layers": cfg.n_layers, "launches": launches,
                  "max_memory_allocated": torch.cuda.max_memory_allocated()}))
'''


def shard_step(args, report: dict, by_path: dict) -> tuple:
    """[shard] (a) MiniCPM-2B at full width cut to 2 layers on a (pod=2,
    data=2, model=2) mesh of eight ``cuda:0`` shards: the attention alone
    (4, 512, 36, 64), sharded (``models.common.attend`` under the mesh's
    hints: K7 once per (dp, tp) shard, (1, 512, 18, 64) each) against the
    whole call, the output bit for bit (and the gradients by K7b, reported);
    then one sharded train step (global batch 4, S=512, fp32 masters, bf16
    moments, seed-0 pipeline batch) against the unsharded step on the same
    parameters and batch: K7 8 a layer a forward (and the remat recompute),
    K7b 3 x 8 kernels a layer, the loss within 2^-8, the gradient norm
    within 2^-4, every gradient leaf within 2^-4 of the unsharded one in
    norm, every parameter's move within 3% of lr of the unsharded step's
    where the two gradients surely share a sign, each leaf's step within
    ``SHARD_STEP_TOL`` in norm; a control (one dp shard's gradient
    dropped) must fail the gradient and step limits. The counted
    all-gather and reduce-scatter bytes equal ``launch/dryrun.py``'s
    reckoning (a logical count: one collective a leaf a dp shard). Returns
    (cfg, mesh, parameters, batch) for (b)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.token_pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import dp_axes, make_local_mesh
    from repro_torch.launch import step as step_mod
    from repro_torch.launch.step import (make_train_step, shard_state,
                                         sharded_value_and_grad,
                                         value_and_grad)
    from repro_torch.launch.train import batch_to
    from repro_torch.models import hints
    from repro_torch.models.api import master_params, model_api
    from repro_torch.models.common import attend
    from repro_torch.train.optimizer import (OptimizerConfig,
                                             init_opt_state, tree_leaves,
                                             tree_map)

    out = report.setdefault("shard", {})
    mesh = make_local_mesh(2, 2, pod=2)
    cfg = dataclasses.replace(get_config("minicpm-2b"), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 29)
    q, k, v, do = (torch.randn((4, 512, cfg.n_heads, 64), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    want = ops.flash_attention(q, k, v, causal=True)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    hints.enable_hints_mesh(mesh, dp_axes(mesh), "model")
    try:
        got, _ = drive_path(by_path, "shard-attention", lambda: attend(
            q, k, v, causal=True, window=None))
        with torch.enable_grad():
            g_sh = torch.autograd.grad(attend(qg, kg, vg, causal=True,
                                              window=None), (qg, kg, vg), do)
    finally:
        hints.disable_hints()
    with torch.enable_grad():
        g_whole = torch.autograd.grad(ops.flash_attention(
            qg, kg, vg, causal=True), (qg, kg, vg), do)
    c = by_path["shard-attention"]
    check(c["flash_attention"] == 8 and c["flash_unsharded"] == 0,
          f"[shard] the sharded attention launched K7 {c['flash_attention']}"
          f" times ({c['flash_unsharded']} whole), want once per (dp, tp) "
          f"shard")
    check(torch.equal(got, want), "[shard] the sharded attention's output "
          "is not the unsharded K7 output bit for bit")
    bwd_bits = all(torch.equal(a, b) for a, b in zip(g_sh, g_whole))
    out["attention"] = dict(shape=list(q.shape), shard_shape=[1, 512, 18, 64],
                            forward_bit_for_bit=True,
                            backward_bit_for_bit=bwd_bits)
    del q, k, v, do, qg, kg, vg, got, want, g_sh, g_whole

    params0 = master_params(model_api(cfg).init(
        torch.Generator(device="cuda").manual_seed(args.seed + 29),
        device="cuda"))
    opt_cfg = OptimizerConfig(total_steps=10, warmup_steps=2,
                              schedule="wsd", peak_lr=1e-3,
                              state_dtype="bfloat16")
    host = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=4, seq_len=512,
        seed=args.seed)).batch_at(0)
    batch = batch_to(host, "cuda")
    # a warm-up step of each kind (cuBLAS and allocator set-up), discarded
    for mesh_ in (None, mesh):
        warm = tree_map(torch.clone, params0)
        make_train_step(cfg, opt_cfg, mesh=mesh_)(
            warm, init_opt_state(warm, opt_cfg), batch)
        del warm
    torch.cuda.synchronize()
    plain_p = tree_map(torch.clone, params0)
    plain_s = init_opt_state(plain_p, opt_cfg)
    (_, _, m_plain), plain_wall = drive_path(
        by_path, "shard-unsharded-step",
        lambda: make_train_step(cfg, opt_cfg)(plain_p, plain_s, batch))
    del plain_s
    pieces = shard_state(params0, init_opt_state(params0, opt_cfg), mesh)
    step = make_train_step(cfg, opt_cfg, mesh=mesh)
    sh.census.reset()
    torch.cuda.reset_peak_memory_stats()
    (p_sh, _, m_sh), wall = drive_path(by_path, "shard-step",
                                       lambda: step(*pieces, batch))
    peak = torch.cuda.max_memory_allocated()
    census = sh.census.totals()
    want_census = dryrun.train_collectives(cfg, mesh, 4)
    n = cfg.n_layers
    c = by_path["shard-step"]
    check(c["flash_attention"] == 2 * 8 * n
          and c["flash_attention_bwd"] == 3 * 8 * n
          and c["flash_unsharded"] == 0,
          f"[shard] the sharded step launched K7 {c['flash_attention']}, "
          f"K7b {c['flash_attention_bwd']} kernels ({c['flash_unsharded']} "
          f"whole), want 2 x 8 and 3 x 8 a layer")
    check(census == want_census, f"[shard] counted collectives {census}, "
          f"the dry run reckons {want_census}")
    loss, ref_loss = float(m_sh["loss"]), float(m_plain["loss"])
    check(abs(loss - ref_loss) <= TRAIN_LOSS * abs(ref_loss),
          f"[shard] loss {loss} sharded, {ref_loss} unsharded")
    gn, ref_gn = float(m_sh["grad_norm"]), float(m_plain["grad_norm"])
    check(abs(gn - ref_gn) <= TRAIN_LEAF * ref_gn,
          f"[shard] gradient norm {gn} sharded, {ref_gn} unsharded")
    # the gradients of both steps (K7b is deterministic: the same bits as
    # inside them), and a control: the sharded step with one dp shard's
    # gradient dropped, which the gradient and step checks must refuse
    _, _, g_plain = value_and_grad(cfg, params0, batch)
    pspecs = sh.param_specs(params0, mesh)
    g_sh = sh.gather_tree(sharded_value_and_grad(
        cfg, shard_state(params0, init_opt_state(params0, opt_cfg),
                         mesh)[0], batch, mesh)[2], pspecs, mesh)
    calls = [0]

    def dropped(*a, **kw):
        loss_, metrics_, g_ = value_and_grad(*a, **kw)
        calls[0] += 1
        return loss_, metrics_, (tree_map(torch.zeros_like, g_)
                                 if calls[0] == 4 else g_)
    step_mod.value_and_grad = dropped
    try:
        ctl_p, _, _ = make_train_step(cfg, opt_cfg, mesh=mesh)(
            *shard_state(params0, init_opt_state(params0, opt_cfg), mesh),
            batch)
        calls[0] = 0
        g_ctl = sh.gather_tree(sharded_value_and_grad(
            cfg, shard_state(params0, init_opt_state(params0, opt_cfg),
                             mesh)[0], batch, mesh)[2], pspecs, mesh)
    finally:
        step_mod.value_and_grad = value_and_grad
    ctl_p = sh.gather_tree(ctl_p, pspecs, mesh)
    grad_worst = tree_allclose(g_sh, g_plain, "[shard] sharded gradients")
    ctl_grad = max(float((a - b).norm()) / max(float(b.norm()), 1e-30)
                   for a, b in zip(tree_leaves(g_ctl), tree_leaves(g_plain)))
    del g_ctl
    lr = float(m_plain["lr"])
    full = sh.gather_tree(p_sh, pspecs, mesh)
    # A first AdamW step moves each element by about lr sign(g): where the
    # two gradients surely share a sign (|g| above twice their difference,
    # |g| clipped far above eps) the moves agree to 3% of lr plus fp32
    # roundings, and a wrong sign is 2 lr off ([train] (b)'s check).
    clip = min(1.0, 1.0 / float(m_plain["grad_norm"]))
    sure_n = nonzero_n = 0
    worst_step = ctl_step = 0.0
    for a, b, c_, p0, ga, gb in zip(
            tree_leaves(full), tree_leaves(plain_p), tree_leaves(ctl_p),
            tree_leaves(params0), tree_leaves(g_sh), tree_leaves(g_plain)):
        sure = (gb.abs() > 2 * (ga - gb).abs()) & (gb.abs() * clip > 1e-6)
        d = (a - b).abs()[sure]
        check(bool((d <= 0.03 * lr + 2.0 ** -21 * b.abs()[sure]).all()),
              f"[shard] a parameter {float(d.max()) if d.numel() else 0.0}"
              f" from the unsharded step's where the gradients share a sign "
              f"(lr {lr})")
        sure_n += int(sure.sum())
        nonzero_n += int((gb != 0).sum())
        ref_step = float((b - p0).norm())
        worst_step = max(worst_step,
                         float((a - b).norm()) / max(ref_step, 1e-30))
        ctl_step = max(ctl_step,
                       float((c_ - b).norm()) / max(ref_step, 1e-30))
    sure_share = sure_n / max(nonzero_n, 1)
    check(sure_share >= 0.1, f"[shard] the gradients share a sure sign on "
          f"{sure_share} of the elements only")
    check(worst_step <= SHARD_STEP_TOL, f"[shard] a leaf's step differs by "
          f"{worst_step} of the unsharded step's")
    check(ctl_grad > TRAIN_LEAF and ctl_step > SHARD_STEP_TOL,
          f"[shard] the control (one dp shard's gradient dropped) passes: "
          f"gradient {ctl_grad}, step {ctl_step}")
    out["step"] = dict(
        mesh=mesh.shape, layers=n, global_batch=4, seq=512,
        loss=loss, loss_unsharded=ref_loss, grad_norm=gn,
        grad_norm_unsharded=ref_gn, worst_grad_leaf_rel=grad_worst,
        sure_sign_share=sure_share, worst_step_rel=worst_step,
        control_grad_leaf_rel=ctl_grad, control_step_rel=ctl_step,
        wall_s=wall, unsharded_wall_s=plain_wall,
        max_memory_allocated=peak, census=census, launches=c,
        card=card_line())
    print(f"[shard] (a) attention (4, 512, 36, 64) over (pod 2, data 2, "
          f"model 2) on cuda:0: K7 8 launches of (1, 512, 18, 64), output "
          f"bit for bit the whole call's; K7b's gradients bit for bit "
          f"{bwd_bits}", flush=True)
    print(f"[shard] (a) minicpm-2b at full width, 2 layers, global batch 4, "
          f"S=512: sharded step {wall:.4f} s (unsharded {plain_wall:.4f} s), "
          f"loss {loss:.6f} (unsharded {ref_loss:.6f}), grad norm {gn:.6f} "
          f"({ref_gn:.6f}); gradient leaves within {grad_worst:.5f}, moves "
          f"within 3% of lr where the gradients surely share a sign "
          f"({sure_share:.4f} of the nonzero ones), steps within "
          f"{worst_step:.5f} of the unsharded (limit {SHARD_STEP_TOL}); "
          f"control with one dp shard's gradient dropped: gradient "
          f"{ctl_grad:.5f}, steps {ctl_step:.5f}; K7 "
          f"{c['flash_attention']}, K7b {c['flash_attention_bwd']} kernels; "
          f"census {census} = the dry run's; max_memory_allocated {peak}; "
          f"card {out['step']['card']}", flush=True)
    del p_sh, pieces, full, plain_p, step, ctl_p, g_sh, g_plain
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, mesh, params0, batch


def shard_compress(args, report: dict, by_path: dict, cfg, mesh, params0,
                   batch) -> None:
    """[shard] (b) ``compressed_psum`` over ``pod`` on the two pods' mean
    gradients (pod p: rows 2p, 2p+1 of (a)'s batch): every element within
    amax / 127 of the exact mean (amax the leaf's largest magnitude over
    both pods), the result identical on both pods, each new error buffer
    exactly ``g32 - deq``."""
    import gc
    import torch
    from repro_torch.launch.step import value_and_grad
    from repro_torch.train.grad_compress import (_quantize,
                                                 compressed_psum,
                                                 init_error_buf)
    from repro_torch.train.optimizer import tree_leaves

    pods = []
    for p in range(2):
        rows = {k: t[2 * p:2 * p + 2] for k, t in batch.items()}
        pods.append(value_and_grad(cfg, params0, rows)[2])
    bufs = [init_error_buf(g) for g in pods]
    (red, err), wall = drive_path(by_path, "shard-compress",
                                  lambda: compressed_psum(pods, bufs, mesh))
    worst, n_el = 0.0, 0
    for i, (g0, g1) in enumerate(zip(tree_leaves(pods[0]),
                                     tree_leaves(pods[1]))):
        exact = (g0.float() + g1.float()) / 2
        amax = max(float(g0.abs().max()), float(g1.abs().max()))
        r0, r1 = tree_leaves(red[0])[i], tree_leaves(red[1])[i]
        d = float((r0.float() - exact).abs().max())
        check(d <= amax / 127.0, f"[shard] compressed_psum leaf {i}: {d} "
              f"from the exact mean (amax/127 {amax / 127.0})")
        check(torch.equal(r0, r1), f"[shard] compressed_psum leaf {i} "
              f"differs between the pods")
        for p, g in enumerate((g0, g1)):
            g32 = g.float() + tree_leaves(bufs[p])[i]
            qq, scale = _quantize(g32)
            check(torch.equal(tree_leaves(err[p])[i],
                              g32 - qq.float() * scale),
                  f"[shard] error buffer of leaf {i}, pod {p}")
        worst = max(worst, d / max(amax / 127.0, 1e-30))
        n_el += g0.numel()
    n_leaves = len(tree_leaves(pods[0]))
    report.setdefault("shard", {})["compress"] = dict(
        leaves=n_leaves, elements=n_el, worst_over_amax_127=worst,
        wall_s=wall, payload_bytes=n_el + 4 * n_leaves,
        fp32_bytes=4 * n_el, card=card_line())
    print(f"[shard] (b) compressed_psum over pod on the two pods' mean "
          f"gradients ({n_leaves} leaves, {n_el} elements): within "
          f"{worst:.4f} of amax/127 of the exact mean, identical on both "
          f"pods, error buffers g32 - deq exactly; {wall:.4f} s; int8 "
          f"payload {n_el + 4 * n_leaves} bytes a pod against {4 * n_el} in "
          f"fp32", flush=True)
    del pods, bufs, red, err
    gc.collect()
    torch.cuda.empty_cache()


def shard_pipeline(args, report: dict, by_path: dict) -> None:
    """[shard] (c) ``pipeline_forward`` on a (pod=4, data=1, model=1) mesh
    of ``cuda:0`` stages, each one MiniCPM-2B decoder layer at full width
    (fp32 masters), M=8 microbatches of (1, 512): the outputs bit for bit
    the sequential application of the same four layers to each
    microbatch; a backward through the schedule (K7b once per stage per
    microbatch) against the sequential backward's gradients, bit for bit
    or within the CPU tests' gradient tolerance; the schedule's wall
    against the sequential one's, and the bubble (S-1)/(M+S-1) = 3/11."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import master_params
    from repro_torch.models.transformer import (apply_self_layer,
                                                init_self_layer)
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.pipeline_parallel import pipeline_forward

    cfg = get_config("minicpm-2b")
    n_stages, m, seq = 4, 8, 512
    mesh = make_local_mesh(1, 1, pod=n_stages)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 31)
    layers = [master_params(init_self_layer(gen, cfg))
              for _ in range(n_stages)]
    x = torch.randn((m, 1, seq, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    positions = torch.arange(seq, dtype=torch.int32,
                             device="cuda").expand(1, seq)

    def stage(p, h):
        return apply_self_layer(p, cfg, h, positions)[0]

    def piped():
        return pipeline_forward(stage, layers, x, mesh=mesh)

    def sequential():
        outs = []
        for h in x:
            for p in layers:
                h = stage(p, h)
            outs.append(h)
        return torch.stack(outs)

    with torch.no_grad():
        got, pipe_s = drive_path(by_path, "shard-pipeline-forward", piped)
        want, seq_s = drive_path(by_path, "shard-sequential-forward",
                                 sequential)
    check(torch.equal(got, want), "[shard] the pipeline's outputs are not "
          "the sequential application's bit for bit")
    c = by_path["shard-pipeline-forward"]
    check(c["flash_attention"] == n_stages * m, f"[shard] the pipeline "
          f"launched K7 {c['flash_attention']} times, want {n_stages * m}")
    leaves = tree_leaves(layers)

    def grads(fn):
        for t in leaves:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = fn().float().square().mean()
                return torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
    g_pipe, bwd_s = drive_path(by_path, "shard-pipeline",
                               lambda: grads(piped))
    g_seq = grads(sequential)
    c = by_path["shard-pipeline"]
    check(c["flash_attention"] == n_stages * m
          and c["flash_attention_bwd"] == 3 * n_stages * m,
          f"[shard] the pipeline's backward launched K7 "
          f"{c['flash_attention']} and K7b {c['flash_attention_bwd']} "
          f"kernels, want {n_stages * m} and 3 x {n_stages * m}")
    bits = all(torch.equal(a, b) for a, b in zip(g_pipe, g_seq))
    worst = 0.0 if bits else tree_allclose(list(g_pipe), list(g_seq),
                                           "[shard] pipeline gradients")
    bubble = (n_stages - 1) / (m + n_stages - 1)
    report.setdefault("shard", {})["pipeline"] = dict(
        stages=n_stages, microbatches=m, microbatch=[1, seq, cfg.d_model],
        forward_bit_for_bit=True, gradients_bit_for_bit=bits,
        worst_grad_rel=worst, pipeline_forward_s=pipe_s,
        sequential_forward_s=seq_s, pipeline_backward_s=bwd_s,
        bubble=bubble, launches=c, card=card_line())
    print(f"[shard] (c) pipeline_forward over pod=4 stages of one "
          f"minicpm-2b layer each, M={m} microbatches of (1, {seq}): outputs "
          f"bit for bit the sequential application; gradients through the "
          f"schedule bit for bit {bits} (worst leaf {worst}); forward "
          f"{pipe_s:.4f} s against sequential {seq_s:.4f} s (stages share "
          f"one card), forward and backward {bwd_s:.4f} s; bubble "
          f"(S-1)/(M+S-1) = 3/11 = {bubble:.4f}; K7 {c['flash_attention']}, "
          f"K7b {c['flash_attention_bwd']} kernels", flush=True)
    del layers, x, got, want, g_pipe, g_seq
    gc.collect()
    torch.cuda.empty_cache()


def shard_launcher(args, report: dict, by_path: dict) -> None:
    """[shard] (d) ``REPRO_MESH_OVERRIDE=2,2,2 python -m
    repro_torch.launch.train --arch minicpm-2b --multi-pod --global-batch
    16 --seq-len 4096 --steps 2`` at full depth in a child process (its
    entry point run under a recorder of the pipeline's rows): two finite
    steps, each given rank 0's 16 / 4 = 4 rows (the reference's
    ``dp_rank=0`` defect), K7 and K7b once per (dp, tp) shard a layer;
    seconds a step, tokens/s over the rows trained, peak memory. The loop
    checkpoints only every ``--ckpt-every`` (1000) steps or when
    preempted, so it saves nothing here."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip-shard-")
    argv = ["--arch", "minicpm-2b", "--multi-pod", "--global-batch", "16",
            "--seq-len", "4096", "--steps", "2", "--ckpt-dir", tmp,
            "--ckpt-every", "1000"]
    env = {**os.environ, "REPRO_MESH_OVERRIDE": "2,2,2",
           "PYTHONPATH": str(ROOT / "src")}
    ts = time.perf_counter()
    try:
        child = subprocess.run([sys.executable, "-c", SHARD_CHILD, *argv],
                               env=env, cwd=str(ROOT), capture_output=True,
                               text=True, timeout=600)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    child_s = time.perf_counter() - ts
    check(child.returncode == 0, f"[shard] the launcher exited "
          f"{child.returncode}:\n{child.stderr[-3000:]}")
    res = json.loads(child.stdout.strip().splitlines()[-1])
    steps, n = res["steps"], res["n_layers"]
    check([h["step"] for h in steps] == [0, 1]
          and all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                  for h in steps), f"[shard] launcher steps {steps}")
    check(res["rows"] == [[0, 0, 4, 4], [1, 0, 4, 4]], f"[shard] the "
          f"launcher's rows {res['rows']}, want rank 0's 4 of 16 a step")
    c = res["launches"]
    check(c["flash_attention"] == 2 * 2 * 8 * n
          and c["flash_attention_bwd"] == 2 * 3 * 8 * n
          and c["flash_unsharded"] == 0,
          f"[shard] the launcher launched K7 {c['flash_attention']}, K7b "
          f"{c['flash_attention_bwd']} ({c['flash_unsharded']} whole)")
    by_path["shard-launcher"] = c
    step_s = [h["time_s"] for h in steps]
    steady = step_s[-1]               # the first step sets up cuBLAS
    tokens = 4 * 4096
    report.setdefault("shard", {})["launcher"] = dict(
        argv=argv, rows=res["rows"], steps=steps, step_s=step_s,
        steady_step_s=steady, tokens_per_step=tokens,
        tokens_per_s=tokens / steady,
        max_memory_allocated=res["max_memory_allocated"],
        run_s=res["wall_s"], child_s=child_s, launches=c, card=card_line())
    print(f"[shard] (d) the launcher, REPRO_MESH_OVERRIDE=2,2,2 --multi-pod "
          f"minicpm-2b ({n} layers) global batch 16, S=4096: losses "
          f"{[round(h['loss'], 5) for h in steps]}, each step given rows "
          f"{res['rows']} (rank 0's 4 of 16); step seconds "
          f"{[round(s, 4) for s in step_s]} (steady {steady:.4f} s = "
          f"{tokens / steady:.1f} tokens/s trained); "
          f"max_memory_allocated {res['max_memory_allocated']} bytes; run "
          f"{res['wall_s']:.1f} s, child {child_s:.1f} s; K7 "
          f"{c['flash_attention']}, K7b {c['flash_attention_bwd']} kernels",
          flush=True)


def shard_phase(args, report: dict, by_path: dict) -> None:
    """[shard] (a) the sharded step, (b) the compressed reduce, (c) the
    pipeline, (d) the launcher on a mesh."""
    import gc
    import torch
    cfg, mesh, params0, batch = shard_step(args, report, by_path)
    shard_compress(args, report, by_path, cfg, mesh, params0, batch)
    del params0, batch
    gc.collect()
    torch.cuda.empty_cache()
    shard_pipeline(args, report, by_path)
    shard_launcher(args, report, by_path)


def k7b_row(by_path: dict, profiles: KernelProfiles) -> tuple[dict, list]:
    """[train] (a) K7b against its plain twin (``ref.flash_attention_bwd``)
    at ``K7B_CASES`` on random bf16 inputs, from the plain forward's output
    and row statistics (K7's own, which the train step hands K7b, are held
    to those in K7's row: the cases returned): every element of dq, dk, dv
    within
    ``ref.flash_attention_bwd_tolerance``; two calls identical bit for bit;
    at the embedder shape a planted fault (the plain twin with key tile
    [64, 128) dropped) outside the tolerance. Times by CUDA events (kernel,
    SDPA's backward, SDPA's backward, kernel), the plain twin, and the
    kernel by the fresh-process profiler; SDPA's backward is
    ``torch.autograd.grad`` through ``F.scaled_dot_product_attention`` on
    the same inputs (its forward run once beforehand). The row's own
    numbers are MiniCPM-2B's; each case keeps the previous design's times
    (``K7B_WAS``) beside its own, and the row the kernels' registers and
    spills from nvcc's report, which must show none. Returns the row and K7's cases at
    these shapes with the log-sum-exp on, for :func:`flash_row`."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(27)
    rows, shared, k7_cases = [], {}, []
    for label, (b, s, h, kv, hd), window in K7B_CASES:
        q, do = (torch.randn((b, s, h, hd), generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((b, s, kv, hd), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        o, lse = ref.flash_attention(q, k, v, causal=True, window=window,
                                     return_lse=True)
        o, lse = o.contiguous(), lse.contiguous()
        k7_cases.append((f"lse {label}", (q, k, v), window, True, True))

        def kernel():
            return FA.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                          window=window)
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        check(same, f"K7b {label}: two calls on the same inputs differ")
        want = ref.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                       window=window)
        tols = ref.flash_attention_bwd_tolerance(q, k, v, o, do, lse, want,
                                                 causal=True, window=window)
        errs, ratio = {}, 0.0
        for name, g_, w_, t_ in zip(("dq", "dk", "dv"), got, want, tols):
            check(bool(g_.float().isfinite().all()),
                  f"K7b {label}: a non-finite {name}")
            e = (g_.float() - w_.float()).abs()
            errs[name] = float(e.max())
            ratio = max(ratio, float((e / t_.clamp_min(1e-30)).max()))
            del e
        check(ratio <= 1.0, f"K7b {label} {(b, s, h, hd)}: differs from the "
              f"plain version by {errs} ({ratio} of the tolerance)")
        fault = None
        if label.startswith("embedder"):
            k2, v2 = k.clone(), v.clone()
            k2[:, 64:128], v2[:, 64:128] = 0, 0
            bad = ref.flash_attention_bwd(q, k2, v2, o, do, lse, causal=True,
                                          window=window)
            fault = min(float(((x.float() - w_.float()).abs()
                               / t_.clamp_min(1e-30)).max())
                        for x, w_, t_ in zip(bad, want, tols))
            check(fault > 1.0, f"K7b {label}: a dropped key tile stays "
                  f"within the tolerance ({fault} of it)")
            del bad, k2, v2
        del got, again, want, tols
        torch.cuda.empty_cache()

        qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_(True)
                      for a in (q, k, v))
        mask = None
        if window is not None:
            i = torch.arange(s, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                  - window)
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            enable_gqa=kv != h)
        dot = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                       retain_graph=True)
        ms_k = [cuda_ms(kernel, 10)]
        ms_l = [cuda_ms(library, 10) for _ in range(2)]
        ms_k.append(cuda_ms(kernel, 10))
        plain_ms = cuda_ms(lambda: ref.flash_attention_bwd(
            q, k, v, o, do, lse, causal=True, window=window), 2, warmup=1)
        del lib_out, qt, kt, vt
        torch.cuda.empty_cache()
        nbytes = 2.0 * (4 * q.numel() + 4 * k.numel()) + 4.0 * lse.numel()
        b_ms, b_by = bound(attention_bwd_flops(b, s, h, hd, True, window),
                           nbytes, PEAK_BF16_FLOPS)
        was_ms, was_device_ms = K7B_WAS.get(label, (None, None))
        rows.append(dict(
            case=label, shape=[b, s, h, hd], kv_heads=kv, window=window,
            causal=True, was_ms=was_ms, was_device_ms=was_device_ms,
            max_abs_err=max(errs.values()), errs=errs,
            max_err_over_tol=ratio, dropped_tile_err_over_tol=fault,
            deterministic=same, ms=sum(ms_k) / 2, ms_runs=ms_k,
            plain_ms=plain_ms, library_ms=sum(ms_l) / 2,
            library_ms_runs=ms_l, ratio_to_library=sum(ms_k) / sum(ms_l),
            bound_ms=b_ms, bound_by=b_by))
        targets = (rows[-1], shared) if len(rows) == 1 else (rows[-1],)
        profiles.add(f"K7b {label} {(b, s, h, hd)}",
                     "flash_attention.flash_attention_bwd",
                     (q, k, v, o, do, lse), K7B_MARK, "flash_attention_bwd",
                     10, *targets, parts=K7B_PARTS,
                     causal=True, window=window)
        print(f"[kernel] flash_attention_bwd {label} {(b, s, h, hd)} kv {kv} "
              f"window {window}: {rows[-1]['ms']:.4f} ms (runs {ms_k}; plain "
              f"{plain_ms:.4f} ms, SDPA backward {rows[-1]['library_ms']:.4f} "
              f"ms (runs {ms_l}), kernel/SDPA "
              f"{rows[-1]['ratio_to_library']:.3f}, bound {b_ms:.4f} ms by "
              f"{b_by}; was {was_ms} ms); max_abs_err {errs}, err/tol "
              f"{ratio}, dropped tile err/tol {fault}, two calls bit for "
              f"bit {same}", flush=True)
    main_case = rows[0]
    ptxas = ptxas_report("flash_attention_bwd")
    spills = [ln for ln in ptxas if "spill" in ln]
    for ln in ptxas:
        print(f"[K7b] ptxas {ln}", flush=True)
    check(bool(spills) and all(
        "0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills),
        f"K7b's kernels spill: {spills}")
    paths = {p: n["flash_attention_bwd"] for p, n in by_path.items()
             if n.get("flash_attention_bwd")}
    shared.update(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/common.py:177",
        replaces_note="no pallas_call: the gradient the reference takes by "
                      "XLA autodiff of blockwise_attention's direct path",
        launches=by_path["train"]["flash_attention_bwd"], path="train",
        launches_by_path=paths,
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_err_over_tol=max(r["max_err_over_tol"] for r in rows),
        shape=main_case["shape"], ms=main_case["ms"],
        plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
        bound_by=main_case["bound_by"], library_ms=main_case["library_ms"],
        ratio_to_library=main_case["ratio_to_library"], ptxas=ptxas,
        cases=rows))
    return shared, k7_cases


def train_phase(args, report: dict, by_path: dict) -> None:
    """[train] (c), (d), (b); (a), K7b's row, runs after [shard]."""
    train_full(args, report, by_path)
    train_resume(args, report, by_path)
    train_grads(args, report, by_path)


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
              f"causal {case['causal']} window {case['window']}: "
              f"{case['ms']:.4f} ms by events, "
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
    k7b = next(r for r in rows if r["name"] == "flash_attention_bwd")
    for case in k7b["cases"]:
        dev = case.get("device_ms")
        share = f", the bound {case['bound_ms'] / dev:.1%} of it" if dev \
            else ""
        print(f"[K7b] {case['case']} {case['shape']} kv {case['kv_heads']} "
              f"window {case['window']}: {case['ms']:.4f} ms by events, "
              f"{dev} ms device{share}, parts "
              f"{case.get('device', {}).get('parts')}, SDPA backward "
              f"{case['library_ms']:.4f} ms, kernel/SDPA "
              f"{case['ratio_to_library']:.3f}, plain {case['plain_ms']:.4f} "
              f"ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']}); "
              f"was {case['was_ms']} ms by events, {case['was_device_ms']} "
              f"ms device (the mma.sync design)", flush=True)
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
    ap.add_argument("--semantics-queries", type=int, default=8,
                    help="queries of the batch run under each semantics "
                         "variant on both backends")
    ap.add_argument("--filter-feasible", type=int, default=16,
                    help="feasible queries drawn per filter")
    ap.add_argument("--compare", type=int, default=8,
                    help="queries per tier held to the numpy backend")
    ap.add_argument("--embed-docs", type=int, default=2048,
                    help="documents of 512 tokens to embed (batches of 32)")
    ap.add_argument("--embed-long-docs", type=int, default=8,
                    help="documents of 4096 tokens to embed (batches of 2)")
    ap.add_argument("--stream-points", type=int, default=10_000,
                    help="points inserted in the streaming phase (8 batches)")
    ap.add_argument("--stream-deletes", type=int, default=1_000,
                    help="points deleted there, half bulk and half delta")
    ap.add_argument("--tenant-points", type=int, default=25_000,
                    help="points per tenant of the tenant-scoped check")
    ap.add_argument("--runtime-points", type=int, default=10_000,
                    help="points churned through the serving runtime (8 "
                         "insert ops; a tenth deleted): its compaction "
                         "threshold")
    ap.add_argument("--ingest-docs", type=int, default=2_500,
                    help="documents through the ingest pipeline into the "
                         "runtime (keep it under the threshold left after "
                         "the runtime's compactions)")
    ap.add_argument("--launch-docs", type=int, default=1_000,
                    help="documents the launcher ingests before serving")
    ap.add_argument("--launch-points", type=int, default=50_000,
                    help="corpus points of the launcher's child process")
    ap.add_argument("--model-docs", type=int, default=64,
                    help="documents of 512 tokens embedded by MiniCPM-2B "
                         "through the ingest pipeline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                          / "chip_smoke.json"))
    ap.add_argument("--profile-jobs", help=argparse.SUPPRESS)
    ap.add_argument("--host-build-job", help=argparse.SUPPRESS)
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
    if args.host_build_job:
        return run_host_build_job(args.host_build_job)
    from repro_torch.kernels import build

    report: dict = {}
    host_build = None
    try:
        t0 = time.perf_counter()
        # one nvcc per source, all started together
        with concurrent.futures.ThreadPoolExecutor() as pool:
            list(pool.map(build.build, ("pairwise_l2", "flash_attention",
                                        "flash_attention_bwd", "diameter",
                                        "project_bin")))
        report["build_s"] = time.perf_counter() - t0
        card = card_line()
        report["card"] = card
        print(f"[build] kernels built in {report['build_s']:.1f}s; card: "
              f"{card}", flush=True)
        report["ptxas"] = {n: ptxas_report(n) for n in
                           ("flash_attention", "flash_attention_bwd",
                            "pairwise_l2", "diameter")}
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
        phase_s = report["phase_s"] = {"kernel-build": report["build_s"]}

        def phase(name, fn, *a):
            ts = time.perf_counter()
            try:
                return fn(*a)
            finally:
                phase_s[name] = time.perf_counter() - ts

        recs, by_path, diam_recs, served = phase("serve", serve, args,
                                                 report)
        phase("semantics", semantics, args, report, served, by_path)
        elig_recs = phase("filter", filtered, args, report, served, by_path)
        phase("plane", plane_phase, args, report, served, by_path)
        compacted = phase("stream", stream, args, report, served, by_path)
        phase("store", store_phase, args, report, served, by_path)
        phase("wal", wal_phase, args, report, served, by_path)
        rt, rt_tmp = phase("runtime", runtime_phase, args, report, served,
                           by_path)
        rec_k5_ingest = phase("ingest", ingest_phase, args, report, rt,
                              rt_tmp, by_path)
        del rt
        # the compacted indices' host oracle beside [examples], which
        # reports no time, and waited for before the next phase
        host_build = HostBuild(compacted[0], compacted[2], "compacted")
        phase("examples", examples_phase, args, report)
        ts = time.perf_counter()
        report["stream"]["host_build_s"] = host_build.check(compacted[1])
        phase_s["stream-host-build-wait"] = time.perf_counter() - ts
        del compacted
        host_build = None
        print(f"[stream] the compacted indices equal the pinned host build "
              f"bit for bit ({report['stream']['host_build_s']:.1f}s in the "
              f"longest of its child processes, waited "
              f"{phase_s['stream-host-build-wait']:.1f}s)", flush=True)
        phase("launch", launch_phase, args, report, served, by_path)
        phase("tenant", tenants, args, report, by_path)
        ts = time.perf_counter()
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
        phase_s["kernel-rows"] = time.perf_counter() - ts
        rec, k7, rec_diam, k6, rec_k5_embed, k5_embed, model = phase(
            "embed", embed, args, report)
        rec_k7_model, rec_k5_model = phase(
            "ingest-model", ingest_model_phase, args, report, model, by_path)
        k7_generate = phase("generate", generate_phase, args, report, model,
                            by_path)
        del model
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        phase("train", train_phase, args, report, by_path)
        phase("shard", shard_phase, args, report, by_path)
        k7b, k7_train = phase("k7b-row", k7b_row, by_path, profiles)
        ts = time.perf_counter()
        rows.append(flash_row(rec, {
            "embed": k7, **{p: c["flash_attention"] for p, c in by_path.items()
                            if c["flash_attention"]}}, profiles,
            [("ingest-model", qkv, None, True)
             for qkv in rec_k7_model.first.values()] + k7_generate
            + k7_train))
        del rec, rec_k7_model, k7_generate, k7_train
        rows.append(k7b)
        star_by, k6_by = ({p: c[n] for p, c in by_path.items()}
                          for n in ("anchor_star", "tuple_diameters"))
        star_by["embed-device"] = k6["anchor_star"]
        k6_by["embed-device"] = k6["tuple_diameters"]
        star_row, tuples = anchor_star_row(
            [("path", diam_recs["device-q3"], None),
             ("q9", diam_recs["device-q9"], None),
             ("q9 shard 1 of 8", diam_recs["device-q9"], (1, 8)),
             ("d2304", rec_diam, None)], star_by, profiles)
        rows.append(star_row)
        rows.append(diameter_row(tuples, k6_by, profiles))
        k5_by_path = {p: c["project_and_bin"] for p, c in by_path.items()}
        k5_by_path["embed-build"] = k5_embed
        rec_k5 = served[4]
        rows.append(k5_row([
            ("path", *rec_k5.first[:2], rec_k5.widths),
            ("d2304", *rec_k5_embed.first[:2], rec_k5_embed.widths),
            ("ingest", *rec_k5_ingest.first[:2],
             rec_k5_ingest.first_widths()),
            ("ingest-model", *rec_k5_model.first[:2],
             rec_k5_model.first_widths())],
            k5_by_path, profiles))
        phase_s["kernel-rows"] += time.perf_counter() - ts
        report["kernel_profiles"] = phase("profiles", profiles.run)
        redesigned_summary(rows, elig_rows)
        print(f"[phases] seconds of every phase: "
              f"{ {k: round(v, 3) for k, v in phase_s.items()} }, "
              f"{sum(phase_s.values()):.3f} in all", flush=True)
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        if host_build is not None:
            host_build.close()
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
