// Flash attention backward for Hopper (sm_90a): K7b.
//
// Replaces no TPU kernel: the reference package's Pallas flash kernel
// (kernels/flash_attention.py) is forward only, and its training takes the
// gradient of attention by XLA autodiff of the direct path of
// models/common.py's blockwise_attention. On the card the forward is K7
// (csrc/flash_attention.cu), which keeps no score block; its gradient reads
// K7's saved statistics instead of a (B, H, S, T) probability block (4.8 GB
// at MiniCPM-2B's train shape (2, 4096, 36, 64), for every layer).
//
// Function: given bf16 q, o, do (B, S, H, hd), k, v (B, T, Kv, hd) and the
// forward's fp32 row log-sum-exp lse (B, H, S), the gradients dq (B, S, H,
// hd), dk, dv (B, T, Kv, hd) in bf16, under K7's contract: causal, windowed
// or non-causal masks (key j visible to query i iff j < T, j <= i when
// causal, j > i - window with a window), hd 64 or 128, H a multiple of Kv
// with query head h reading kv head h / (H / Kv), any S and T.
//
// Arithmetic (the plain twin kernels/ref.py:flash_attention_bwd rounds at
// the same places):
//   * qs = bf16(q * scale) (K7's scaled query; exact at hd = 64);
//   * s = qs . k with fp32 sums, P = exp(s - lse) in fp32, 0 where masked;
//   * D = rowsum(do * o) in fp32;
//   * dv = sum over queries of bf16(P) do, dP = do . v in fp32,
//     dS = P (dP - D) in fp32;
//   * dq = scale * (bf16(dS) k), dk = bf16(dS)^T qs, fp32 sums, each
//     rounded to bf16 once at the end; grouped query heads summed into
//     their kv head in fp32 registers.
//
// Design: three launches on the caller's stream, no floating-point atomics:
// every output element is written once, by one CTA, after sums in a fixed
// order, so two calls on the same inputs give the same bits.
//   1. bwd_prep: one 16-byte load of o and do a thread, HD / 8 threads a
//      row. It writes each row's (lse log2(e), D) pair into a (B, H, S
//      rounded up to 64) fp32 scratch, zeros past S, so that a query tile's
//      statistics are one 512-byte bulk copy; zeroes the two kernels' unit
//      counters; and at hd = 128 writes the scaled query qs into a (B, S, H,
//      128) bf16 scratch, read by TMA from then on. At hd = 64 the scale 1/8
//      is exact and commutes with every fp32 rounding, so, as in K7, q itself
//      is read, the scale is folded into the softmax argument (one FFMA and
//      one EX2 a score) and dk is scaled in its epilogue.
//   2. bwd_dkdv and 3. bwd_dq: persistent and warp-specialised, one
//      384-thread CTA an SM: two consumer warpgroups of 64 rows each (keys
//      for dk/dv, queries for dq) and a producer warpgroup, one thread of
//      which issues every copy; setmaxnreg gives the consumers 224 registers
//      a thread and the producer 56. A unit is 128 rows of one (batch, head):
//      dk/dv's a kv head's keys with the query tiles that see them (from the
//      diagonal on when causal, up to the window), dq's a query head's rows
//      with the key tiles they see. Units are numbered heaviest first within
//      a head (the first key tiles, the last query tiles), the tiles of one
//      head adjacent and, for dq, the heads of one kv head adjacent, so that
//      the CTAs running at once share the streamed tiles in L2; a CTA's
//      producer takes its next unit from an atomic counter (integer, for
//      scheduling only), so that a CTA that drew light units draws more.
//      The producer loads the unit's pair of tile sets by TMA into one of
//      two slots (K and V, or q and do), then streams the tiles the unit
//      needs into a ring of stages with full/empty mbarriers (for dk/dv the
//      q (or qs) and do tiles of each of the group's H / Kv heads, and each
//      query tile's statistics by a bulk copy; for dq the K and V tiles),
//      running ahead into the next unit.
//      dk/dv, per tile and warpgroup: S^T = K q^T and dP^T = V do^T by
//      wgmma (both K-major in shared memory, two commit groups), P^T while
//      dP^T computes, dV += bf16(P^T) do by wgmma with the packed
//      accumulator as the A fragment and do read MN-major (the transpose
//      bit) while dS^T = P^T (dP^T - D) is formed, then dK += bf16(dS^T) q
//      likewise. At hd = 64 the tile's dV and dK retire behind the next
//      tile's S^T, which is when the stage is released; at hd = 128, where
//      the 128 accumulators of dK and dV leave no registers for that, a
//      stage's 64 queries go 32 at a time and both products retire within
//      each half.
//      dq, per tile and warpgroup: S = q K^T and dP = do V^T, P, then dS,
//      and dQ += bf16(dS) K from registers with K MN-major, retiring behind
//      the next tile's S; dq = bf16(scale dQ) at the end.
//   In both the mask predicate runs only on tiles that hold a masked cell
//   (the causal diagonal, the window's edge, the tile holding row S or key
//   T); tiles wholly outside the causal or window range are never loaded,
//   and a warpgroup skips a tile none of whose cells is live. Tiles are [64
//   rows][64 features] blocks of 128-byte rows, 128-byte swizzled (hd = 128
//   is two blocks), as TMA writes them.
//
// Occupancy (ptxas' report, printed by chip_smoke.py's [ptxas] and [K7b]
// lines; PERF.md keeps it): 168 registers a thread at launch, 224 after
// setmaxnreg, no spills; shared memory 134,400 bytes for dk/dv at hd = 64
// (two K/V slots, 4 stages), 232,192 at hd = 128 (3 stages); 132,352 and
// 230,656 for dq (4 and 3 stages). Tried against this design and measured
// on the card (PERF.md): ping-pong turns between the two warpgroups, a
// software-pipelined dq (the next tile's S and dP issued before this tile's
// dQ; ptxas then serialises the wgmma), dQ as a wgmma from dS staged in
// shared memory, two accumulator chains for dQ: none was faster; three dq
// warpgroups were faster at MiniCPM-2B's shape and slower at the smaller
// ones.
//
// Bound on the card: with lse given, the function needs S = QK^T, dV, dP,
// dQ and dK: 10 hd flops per live (query, key) pair on the bf16 tensor
// cores (989 TFLOP/s dense on an H100 SXM), against reading q, k, v, o, do
// and lse and writing dq, dk, dv once (3.35 TB/s). At MiniCPM-2B's train
// shape (2, 4096, 36, 64) causal that is 3.9e11 flops, 0.39 ms. This design
// computes S and dP in both passes (14 hd flops a pair): a single pass
// whose dk/dv CTAs also produce dQ needs floating-point atomics, or a turn
// counter per query tile, to keep the bits repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;                 // rows of a box and of a warpgroup's
                                         // keys or queries
constexpr int WG = 128;                  // threads of a warpgroup
constexpr int SMEM_BUDGET = 232448;      // bytes one CTA may use
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int PREP_THREADS = 256;
constexpr int STATS_BYTES = TILE * 8;    // a query tile's (lse log2e, D)

// The CTA of bwd_dkdv and bwd_dq: WGS consumer warpgroups of TILE rows each
// (keys for dk/dv, queries for dq) share every tile the producer streams;
// then a producer warpgroup, one of whose threads issues the copies.
// setmaxnreg moves registers from the producer to the consumers: the
// LAUNCH_REGS a thread of the launch (65,536 over 384 threads) become
// PRODUCER_REGS and CONSUMER_REGS.
constexpr int WGS = 2;
constexpr int ROWS = WGS * TILE;         // keys or queries of a unit
constexpr int CONSUMERS = WGS * WG;
constexpr int THREADS = CONSUMERS + WG;
constexpr int LAUNCH_REGS = 168;
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
static_assert(CONSUMERS * CONSUMER_REGS + WG * PRODUCER_REGS
                  <= THREADS * LAUNCH_REGS,
              "the register split exceeds the launch's allocation");

template <int HD>
struct Cfg {
  static constexpr int CHUNKS = HD / 64;             // 128-byte column blocks
  static constexpr int TILE_BYTES = TILE * HD * 2;   // one bf16 tile
  // a unit's pair of tile sets (K and V, or q and do)
  static constexpr int UNIT_BYTES = 2 * WGS * TILE_BYTES;
  // bwd_dkdv: two slots of a unit's K and V tiles, then a ring of stages of
  // a query tile's q (or qs) and do, then their statistics, then barriers.
  static constexpr int KV_FIXED = 1024 + 2 * UNIT_BYTES + 256;
  static constexpr int KV_FIT =
      (SMEM_BUDGET - KV_FIXED) / (2 * TILE_BYTES + STATS_BYTES);
  static constexpr int KV_STAGES = KV_FIT < 4 ? KV_FIT : 4;
  static constexpr int KV_SMEM =
      KV_FIXED + KV_STAGES * (2 * TILE_BYTES + STATS_BYTES);
  // bwd_dq: two slots of a unit's q (or qs) and do tiles, then a ring of
  // stages of a key tile's K and V, then barriers.
  static constexpr int DQ_FIXED = 1024 + 2 * UNIT_BYTES + 256;
  static constexpr int DQ_FIT = (SMEM_BUDGET - DQ_FIXED) / (2 * TILE_BYTES);
  static constexpr int DQ_STAGES = DQ_FIT < 4 ? DQ_FIT : 4;
  static constexpr int DQ_SMEM = DQ_FIXED + DQ_STAGES * 2 * TILE_BYTES;
  static_assert(DQ_SMEM <= SMEM_BUDGET, "bwd_dq's shared memory");
  // dk/dv issues dV before it forms dS, and carries the tile's dV and dK
  // products into the next tile, at hd = 64; that keeps their A fragments
  // (32 registers) live beside the next S and dP, for which hd = 128's
  // accumulators leave no room: there both products go together, after dS,
  // and retire within the tile.
  static constexpr bool KV_CARRY = HD == 64;
  // dk/dv takes a stage's 64 queries QN at a time: at hd = 128, 32, so that
  // S^T and dP^T take 32 registers beside the 128 of dK and dV; KS k-steps
  // of dV and dK a sub-tile.
  static constexpr int QN = HD == 64 ? 64 : 32;
  static constexpr int KS = QN / 16;
  static_assert(KV_STAGES >= 2 && DQ_STAGES >= 2, "a ring needs 2 stages");
};

// The shared memory of both kernels: two slots of a unit's tiles
// (UNIT_BYTES each), a ring of STAGES stages of STAGE_BYTES each, EXTRA
// bytes a stage (dk/dv's statistics), then the barriers. Every address is
// the 1024-aligned base plus a constant: one register holds the layout.
template <int UNIT_BYTES, int STAGES, int STAGE_BYTES, int EXTRA = 0>
struct Layout {
  static constexpr uint32_t RING = 2 * UNIT_BYTES;
  static constexpr uint32_t EXTRAS = RING + STAGES * STAGE_BYTES;
  static constexpr uint32_t BARS = EXTRAS + STAGES * EXTRA;
  uint32_t slots;                  // 128-byte swizzled tiles: 1024-aligned
  __device__ explicit Layout(const unsigned char* smem)
      : slots((smem_addr(smem) + 1023u) & ~1023u) {}
  __device__ uint32_t slot(int q) const { return slots + q * UNIT_BYTES; }
  __device__ uint32_t stage(int s) const {
    return slots + RING + s * STAGE_BYTES;
  }
  __device__ uint32_t extra(int s) const { return slots + EXTRAS + s * EXTRA; }
  __device__ uint32_t full(int s) const { return slots + BARS + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return slots + BARS + 8 * (STAGES + s);
  }
  __device__ uint32_t slot_full(int q) const {
    return slots + BARS + 8 * (2 * STAGES + q);
  }
  __device__ uint32_t slot_empty(int q) const {
    return slots + BARS + 8 * (2 * STAGES + 2 + q);
  }
  // The unit a slot holds, as the producer took it from the counter; one
  // past the last unit ends the walk.
  __device__ volatile int* slot_unit(unsigned char* smem, int q) const {
    return reinterpret_cast<volatile int*>(
        smem + (slots - smem_addr(smem)) + BARS + 128 + 4 * q);
  }
  // One thread; every empty barrier takes one arrival per consumer warp.
  __device__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);
    }
    for (int q = 0; q < 2; ++q) {
      mbar_init(slot_full(q), 1);
      mbar_init(slot_empty(q), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of the 64 x 16 KS accumulator `x` rounded to bf16: those
// of columns [16 kk, 16 kk + 16) are the kk-th k-step's.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4],
                                       const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// Keeps the A fragments of a wgmma in flight in their registers until here.
template <int KS>
__device__ __forceinline__ void keep(const uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(a[kk][e]) : "memory");
}

__device__ __forceinline__ bool live(int i, int j, int T, int causal,
                                     int window) {
  return j < T && (!causal || j <= i) && (window <= 0 || j > i - window);
}

// Whether no cell of the qn queries at m0 and the 64 keys at n0 is live, or
// some cell is masked (the tile holding row S or key T included).
__device__ __forceinline__ bool tile_dead(int m0, int qn, int n0, int S,
                                          int T, int causal, int window) {
  return m0 >= S || n0 >= T || (causal && n0 > m0 + qn - 1)
         || (window > 0 && n0 + TILE - 1 <= m0 - window);
}

__device__ __forceinline__ bool tile_edge(int m0, int qn, int n0, int S,
                                          int T, int causal, int window) {
  return (causal && n0 + TILE - 1 > m0)
         || (window > 0 && n0 <= m0 + qn - 1 - window) || n0 + TILE > T
         || m0 + qn > S;
}

// A dk/dv unit: keys [n0, n0 + ROWS) of (b, kvh), heaviest first (the key
// tiles of one kv head adjacent), and the query tiles [i0, i1) that see one
// of them (from the first key on when causal, before the last key + window
// with a window).
struct KvUnit {
  int n0, b, kvh, i0, i1;
  __device__ KvUnit(int u, int n_kt, int KVH, int S, int causal, int window) {
    n0 = (u % n_kt) * ROWS;
    const int bk = u / n_kt;
    b = bk / KVH;
    kvh = bk % KVH;
    const int m_lo = causal ? n0 : 0;
    const int m_hi = window > 0 ? min(S, n0 + ROWS - 1 + window) : S;
    i0 = m_lo / TILE;
    i1 = max(i0, (m_hi + TILE - 1) / TILE);
  }
};

// A dq unit: queries [m0, m0 + ROWS) of (b, h), heaviest first (the query
// tiles of one head adjacent, the heads of one kv head adjacent, so that the
// CTAs running at once share K/V tiles in L2), and the key tiles [j0, j1)
// they see (keys < T, <= the last query when causal, > the first query -
// window with a window).
struct QUnit {
  int m0, b, h, j0, j1;
  __device__ QUnit(int u, int n_mt, int H, int T, int causal, int window) {
    m0 = (n_mt - 1 - u % n_mt) * ROWS;
    const int bh = u / n_mt;
    b = bh / H;
    h = bh % H;
    const int n_end = causal ? min(T, m0 + ROWS) : T;
    const int n_begin = window > 0 ? max(0, m0 - window + 1) : 0;
    j0 = n_begin / TILE;
    j1 = max(j0, (n_end + TILE - 1) / TILE);
  }
};

// stats[(b H + h) S_pad + i] = (lse[b, h, i] log2(e), rowsum(do * o)[b, i,
// h]) for i < S, zeros up to S_pad; at hd = 128 (qs not null) also qs =
// bf16(q * scale); and the dk/dv and dq unit counters to 0. Rows numbered
// (b, h, i), HD / 8 threads a row.
template <int HD>
__global__ void __launch_bounds__(PREP_THREADS)
bwd_prep(const bf16* __restrict__ q, const bf16* __restrict__ o,
         const bf16* __restrict__ dout, const float* __restrict__ lse,
         float2* __restrict__ stats, unsigned* __restrict__ counters,
         bf16* __restrict__ qs, int64_t rows, int S, int S_pad, int H,
         float scale) {
  if (blockIdx.x == 0 && threadIdx.x < 2) counters[threadIdx.x] = 0u;
  constexpr int TPR = HD / 8;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (PREP_THREADS / TPR)
                    + threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const int64_t bh = r / S_pad;
  const int i = static_cast<int>(r % S_pad);
  const bool in = r < rows && i < S;
  float acc = 0.f;
  if (in) {
    const int64_t b = bh / H, h = bh % H;
    const int64_t at = ((b * S + i) * H + h) * HD + sub * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + at);
    const uint4 d = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(a2[e]);
      const float2 fd = __bfloat1622float2(d2[e]);
      acc = fmaf(fa.x, fd.x, acc);
      acc = fmaf(fa.y, fd.y, acc);
    }
    if (qs != nullptr) {
      uint4 v = *reinterpret_cast<const uint4*>(q + at);
      __nv_bfloat162* two = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(two[e]);
        two[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      *reinterpret_cast<uint4*>(qs + at) = v;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (sub == 0 && r < rows)
    stats[r] = in ? make_float2(lse[bh * S + i] * LOG2E, acc)
                  : make_float2(0.f, 0.f);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tdo,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv,
         const float2* __restrict__ stats, unsigned* __restrict__ next_unit,
         bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int S,
         int S_pad, int T, int H, int KVH, int causal, int window, float l2e,
         float dk_scale) {
  using C = Cfg<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // slot: K tiles, then V tiles; stage: q tile, do tile; then statistics
  const Layout<C::UNIT_BYTES, C::KV_STAGES, 2 * C::TILE_BYTES, STATS_BYTES>
      L(smem_raw);
  if (threadIdx.x == 0) L.init();
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: one thread issues every copy, running ahead into
    // the next unit while the consumers finish this one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x != CONSUMERS) return;
    const int grp = H / KVH, n_kt = (T + ROWS - 1) / ROWS;
    const int units = n_kt * B * KVH;
    int it = 0;             // query tiles issued by this CTA
    for (int n = 0;; ++n) { // the CTA's n-th unit, taken from the counter
      const int slot = n & 1;
      mbar_wait(L.slot_empty(slot), ((n >> 1) & 1) ^ 1);
      // unsigned: every CTA takes one past the last unit
      const unsigned next = atomicAdd(next_unit, 1u);
      const int u = next < static_cast<unsigned>(units) ? next : units;
      *L.slot_unit(smem_raw, slot) = u;
      if (u == units) {
        mbar_arrive(L.slot_full(slot));           // the consumers stop
        return;
      }
      const KvUnit w(u, n_kt, KVH, S, causal, window);
      const uint32_t sk = L.slot(slot);
      // the key tiles holding a key < T (a warpgroup whose keys all lie
      // past T reads none)
      const int tiles = min(WGS, (T - w.n0 + TILE - 1) / TILE);
      mbar_expect_tx(L.slot_full(slot), tiles * 2 * C::TILE_BYTES);
      for (int g = 0; g < tiles; ++g)
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          const uint32_t at = (g * C::CHUNKS + c) * TILE * 128;
          tma_load_4d(sk + at, &tk, L.slot_full(slot), c * 64, w.kvh,
                      w.n0 + g * TILE, w.b);
          tma_load_4d(sk + C::UNIT_BYTES / 2 + at, &tv, L.slot_full(slot),
                      c * 64, w.kvh, w.n0 + g * TILE, w.b);
        }
      for (int h = w.kvh * grp; h < (w.kvh + 1) * grp; ++h) {
        const float2* src = stats + (static_cast<int64_t>(w.b) * H + h) * S_pad;
        for (int i = w.i0; i < w.i1; ++i, ++it) {
          const int st = it % C::KV_STAGES;
          mbar_wait(L.empty(st), ((it / C::KV_STAGES) & 1) ^ 1);
          mbar_expect_tx(L.full(st), 2 * C::TILE_BYTES + STATS_BYTES);
          const uint32_t sq = L.stage(st);
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c) {
            tma_load_4d(sq + c * TILE * 128, &tq, L.full(st), c * 64, h,
                        i * TILE, w.b);
            tma_load_4d(sq + C::TILE_BYTES + c * TILE * 128, &tdo, L.full(st),
                        c * 64, h, i * TILE, w.b);
          }
          bulk_load(L.extra(st), src + i * TILE, STATS_BYTES,
                    L.full(st));
        }
      }
    }
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
               : "memory");
  const int grp = H / KVH, n_kt = (T + ROWS - 1) / ROWS;
  const int units = n_kt * B * KVH;
  const int wg = threadIdx.x / WG;
  const int warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  int it = 0;               // query tiles consumed by this CTA
  uint32_t pa[C::KS][4], sa[C::KS][4];   // A fragments of dV's, dK's
  int held = -1;                 // the stage those products read, if any
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(L.empty(st));   // the stage may be refilled
  };
  for (int n = 0;; ++n) {   // the CTA's n-th unit
    const int slot = n & 1;
    mbar_wait(L.slot_full(slot), (n >> 1) & 1);
    const int u = *L.slot_unit(smem_raw, slot);
    if (u >= units) break;
    const KvUnit w(u, n_kt, KVH, S, causal, window);
    const int kb = w.n0 + wg * TILE;              // this warpgroup's keys
    const int key0 = kb + warp * 16 + g;          // rows key0, key0 + 8
    const uint32_t sk =
        L.slot(slot) + wg * C::CHUNKS * TILE * 128;
    const uint32_t sv = sk + C::UNIT_BYTES / 2;

    float acc_k[C::CHUNKS][32], acc_v[C::CHUNKS][32];
#pragma unroll
    for (int c = 0; c < C::CHUNKS; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_k[c][i] = acc_v[c][i] = 0.f;
    auto fence_acc = [&] {
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c) {
        fence_regs(acc_v[c]);
        fence_regs(acc_k[c]);
      }
    };
    // once the products in flight have retired: their stage may be refilled
    auto release_held = [&] {
      fence_acc();
      if (held >= 0) {
        keep(pa);
        keep(sa);
        release(held);
        held = -1;
      }
    };
    auto retire = [&] {
      wgmma_wait_all();
      release_held();
    };

    for (int hh = 0; hh < grp; ++hh) {
      for (int i = w.i0; i < w.i1; ++i, ++it) {
        const int st = it % C::KV_STAGES;
        mbar_wait(L.full(st), (it / C::KV_STAGES) & 1);
        if (tile_dead(i * TILE, TILE, kb, S, T, causal, window)) {
          release(st);
          continue;
        }
        const uint32_t sq = L.stage(st);
        const uint32_t so = sq + C::TILE_BYTES;
        const float4* sd = reinterpret_cast<const float4*>(
            smem_raw + (L.extra(st) - smem_addr(smem_raw)));
#pragma unroll
        for (int sub = 0; sub < TILE / C::QN; ++sub) {
          const int m0 = i * TILE + sub * C::QN;  // the sub-tile's queries
          if (C::QN < TILE && tile_dead(m0, C::QN, kb, S, T, causal, window))
            continue;
          // S^T = K q^T, then dP^T = V do^T: 64 keys x QN queries each, two
          // groups behind the last tile's dV and dK when those are carried.
          float s[C::QN / 2], dp[C::QN / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk / 4) * TILE * 128 + (kk % 4) * 32;
            const uint64_t da = desc_k_major(sk + off);
            const uint64_t db = desc_k_major(sq + sub * C::QN * 128 + off);
            if constexpr (C::QN == 64) wgmma_ss_n64(s, da, db, kk > 0);
            else wgmma_ss_n32(s, da, db, kk > 0);
          }
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t off = (kk / 4) * TILE * 128 + (kk % 4) * 32;
            const uint64_t da = desc_k_major(sv + off);
            const uint64_t db = desc_k_major(so + sub * C::QN * 128 + off);
            if constexpr (C::QN == 64) wgmma_ss_n64(dp, da, db, kk > 0);
            else wgmma_ss_n32(dp, da, db, kk > 0);
          }
          wgmma_commit();
          wgmma_wait<1>();                        // S^T and all before it
          fence_regs(s);
          if (C::KV_CARRY) release_held();

          // P^T while dP^T computes; element e of column block jn is key
          // key0 + 8 (e >> 1), query m0 + 8 jn + 2 t4 + (e & 1), whose
          // (lse log2e, D) pairs are one float4.
          const bool edge = tile_edge(m0, C::QN, kb, S, T, causal, window);
          const float4* sdq = sd + sub * C::QN / 2;
#pragma unroll
          for (int jn = 0; jn < C::QN / 8; ++jn) {
            const float4 c = sdq[jn * 4 + t4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int x = jn * 4 + e;
              const int qi = m0 + jn * 8 + 2 * t4 + (e & 1);
              float p = ex2(fmaf(s[x], l2e, (e & 1) ? -c.z : -c.x));
              if (edge && !(qi < S && live(qi, key0 + 8 * (e >> 1), T,
                                           causal, window)))
                p = 0.f;
              s[x] = p;
            }
          }
          // dV += bf16(P^T) do (at hd = 64 while dS^T = P^T (dP^T - D) is
          // formed), dK += bf16(dS^T) q: the k-step kk covers queries
          // [16 kk, 16 kk + 16) of the sub-tile, rows of the MN-major tiles.
          auto issue_dv = [&] {
            pack_a(pa, s);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < C::KS; ++kk)
#pragma unroll
              for (int c = 0; c < C::CHUNKS; ++c)
                wgmma_rs_n64_tb(acc_v[c], pa[kk],
                                desc_mn_major(so + c * TILE * 128 +
                                              (sub * C::QN + kk * 16) * 128));
          };
          if (C::KV_CARRY) {
            issue_dv();
            wgmma_commit();
            wgmma_wait<1>();                      // dP^T
          } else {
            wgmma_wait<0>();
          }
          fence_regs(dp);
#pragma unroll
          for (int jn = 0; jn < C::QN / 8; ++jn) {
            const float4 c = sdq[jn * 4 + t4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int x = jn * 4 + e;
              dp[x] = s[x] * (dp[x] - ((e & 1) ? c.w : c.y));
            }
          }
          if (!C::KV_CARRY) issue_dv();
          pack_a(sa, dp);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C::KS; ++kk)
#pragma unroll
            for (int c = 0; c < C::CHUNKS; ++c)
              wgmma_rs_n64_tb(acc_k[c], sa[kk],
                              desc_mn_major(sq + c * TILE * 128 +
                                            (sub * C::QN + kk * 16) * 128));
          wgmma_commit();
          fence_acc();
          if (!C::KV_CARRY) {                     // retire within the sub-tile
            wgmma_wait_all();
            fence_acc();
            keep(pa);
            keep(sa);
          }
        }
        // the stage is refilled once the products reading it have retired:
        // now, or after the next tile's S^T when carried
        if (C::KV_CARRY)
          held = st;
        else
          release(st);
      }
    }
    retire();
    __syncwarp();
    if (lane == 0) mbar_arrive(L.slot_empty(slot));  // K, V may be refilled

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= T) continue;
      const int64_t at =
          ((static_cast<int64_t>(w.b) * T + key) * KVH + w.kvh) * HD + 2 * t4;
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c)
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int x = jn * 4 + 2 * r;
          *reinterpret_cast<uint32_t*>(dk + at + c * 64 + jn * 8) =
              pack_bf16(acc_k[c][x] * dk_scale, acc_k[c][x + 1] * dk_scale);
          *reinterpret_cast<uint32_t*>(dv + at + c * 64 + jn * 8) =
              pack_bf16(acc_v[c][x], acc_v[c][x + 1]);
        }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq(const __grid_constant__ CUtensorMap tq,
       const __grid_constant__ CUtensorMap tdo,
       const __grid_constant__ CUtensorMap tk,
       const __grid_constant__ CUtensorMap tv,
       const float2* __restrict__ stats, unsigned* __restrict__ next_unit,
       bf16* __restrict__ dq, int B, int S, int S_pad, int T, int H, int KVH,
       int causal, int window, float l2e, float scale) {
  using C = Cfg<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // slot: q tiles, then do tiles; stage: K tile, V tile
  const Layout<C::UNIT_BYTES, C::DQ_STAGES, 2 * C::TILE_BYTES> L(smem_raw);
  if (threadIdx.x == 0) L.init();
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x != CONSUMERS) return;
    const int n_mt = (S + ROWS - 1) / ROWS, units = n_mt * B * H;
    int it = 0;             // key tiles issued by this CTA
    for (int n = 0;; ++n) { // the CTA's n-th unit, taken from the counter
      const int slot = n & 1;
      mbar_wait(L.slot_empty(slot), ((n >> 1) & 1) ^ 1);
      // unsigned: every CTA takes one past the last unit
      const unsigned next = atomicAdd(next_unit, 1u);
      const int u = next < static_cast<unsigned>(units) ? next : units;
      *L.slot_unit(smem_raw, slot) = u;
      if (u == units) {
        mbar_arrive(L.slot_full(slot));           // the consumers stop
        return;
      }
      const QUnit w(u, n_mt, H, T, causal, window);
      const int kvh = w.h / (H / KVH);
      const uint32_t sq = L.slot(slot);
      // the query tiles holding a row < S
      const int tiles = min(WGS, (S - w.m0 + TILE - 1) / TILE);
      mbar_expect_tx(L.slot_full(slot), tiles * 2 * C::TILE_BYTES);
      for (int g = 0; g < tiles; ++g)
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          const uint32_t at = (g * C::CHUNKS + c) * TILE * 128;
          tma_load_4d(sq + at, &tq, L.slot_full(slot), c * 64, w.h,
                      w.m0 + g * TILE, w.b);
          tma_load_4d(sq + C::UNIT_BYTES / 2 + at, &tdo, L.slot_full(slot),
                      c * 64, w.h, w.m0 + g * TILE, w.b);
        }
      for (int j = w.j0; j < w.j1; ++j, ++it) {
        const int st = it % C::DQ_STAGES;
        mbar_wait(L.empty(st), ((it / C::DQ_STAGES) & 1) ^ 1);
        mbar_expect_tx(L.full(st), 2 * C::TILE_BYTES);
        const uint32_t sk = L.stage(st);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load_4d(sk + c * TILE * 128, &tk, L.full(st), c * 64, kvh,
                      j * TILE, w.b);
          tma_load_4d(sk + C::TILE_BYTES + c * TILE * 128, &tv, L.full(st),
                      c * 64, kvh, j * TILE, w.b);
        }
      }
    }
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
               : "memory");
  const int n_mt = (S + ROWS - 1) / ROWS, units = n_mt * B * H;
  const int wg = threadIdx.x / WG;
  const int warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  int it = 0;               // key tiles consumed by this CTA
  uint32_t da[4][4];        // A fragments of the dQ product
  int held = -1;            // the stage that product reads, if any
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(L.empty(st));   // the stage may be refilled
  };
  for (int n = 0;; ++n) {   // the CTA's n-th unit
    const int slot = n & 1;
    mbar_wait(L.slot_full(slot), (n >> 1) & 1);
    const int u = *L.slot_unit(smem_raw, slot);
    if (u >= units) break;
    const QUnit w(u, n_mt, H, T, causal, window);
    const int m0 = w.m0 + wg * TILE;              // this warpgroup's queries
    const int row0 = m0 + warp * 16 + g;          // rows row0, row0 + 8
    const uint32_t sq =
        L.slot(slot) + wg * C::CHUNKS * TILE * 128;
    const uint32_t so = sq + C::UNIT_BYTES / 2;
    // the rows' (lse log2e, D); rows past S read the zero padding, or none
    // where the warpgroup's rows all lie past S
    float nl[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
    if (m0 < S) {
      const float2* src =
          stats + (static_cast<int64_t>(w.b) * H + w.h) * S_pad + row0;
      const float2 st0 = src[0], st1 = src[8];
      nl[0] = -st0.x;
      nl[1] = -st1.x;
      dd[0] = st0.y;
      dd[1] = st1.y;
    }

    float acc[C::CHUNKS][32];
#pragma unroll
    for (int c = 0; c < C::CHUNKS; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    auto fence_acc = [&] {
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c) fence_regs(acc[c]);
    };
    // once the dQ product in flight has retired: its stage may be refilled
    auto release_held = [&] {
      fence_acc();
      if (held >= 0) {
        keep(da);
        release(held);
        held = -1;
      }
    };

    for (int j = w.j0; j < w.j1; ++j, ++it) {
      const int st = it % C::DQ_STAGES;
      const int n0 = j * TILE;
      mbar_wait(L.full(st), (it / C::DQ_STAGES) & 1);
      if (tile_dead(m0, TILE, n0, S, T, causal, window)) {
        release(st);
        continue;
      }
      const uint32_t sk = L.stage(st);
      const uint32_t sv = sk + C::TILE_BYTES;
      // S = q K^T, then dP = do V^T: 64 queries x 64 keys each, two groups
      // behind the last tile's dQ.
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * TILE * 128 + (kk % 4) * 32;
        wgmma_ss_n64(s, desc_k_major(sq + off), desc_k_major(sk + off),
                     kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * TILE * 128 + (kk % 4) * 32;
        wgmma_ss_n64(dp, desc_k_major(so + off), desc_k_major(sv + off),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();                            // S and all before it
      fence_regs(s);
      release_held();                             // the last tile's dQ

      // P while dP computes, then dS = P (dP - D); element e of column
      // block jn is row row0 + 8 (e >> 1), key n0 + 8 jn + 2 t4 + (e & 1).
      const bool edge = tile_edge(m0, TILE, n0, S, T, causal, window);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int r = (x >> 1) & 1;
        float p = ex2(fmaf(s[x], l2e, nl[r]));
        if (edge && !live(row0 + 8 * r, n0 + (x >> 2) * 8 + 2 * t4 + (x & 1),
                          T, causal, window))
          p = 0.f;
        s[x] = p;
      }
      wgmma_wait<0>();                            // dP
      fence_regs(dp);
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] *= dp[x] - dd[(x >> 1) & 1];
      pack_a(da, s);

      // dQ += bf16(dS) K: the k-step kk covers keys [16 kk, 16 kk + 16),
      // rows of the MN-major K tile.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c)
          wgmma_rs_n64_tb(acc[c], da[kk],
                          desc_mn_major(sk + c * TILE * 128
                                        + kk * 16 * 128));
      wgmma_commit();
      fence_acc();
      held = st;
    }
    wgmma_wait_all();
    release_held();
    __syncwarp();
    if (lane == 0) mbar_arrive(L.slot_empty(slot));  // q, do may be refilled

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      bf16* dst = dq + ((static_cast<int64_t>(w.b) * S + row) * H + w.h) * HD
                  + 2 * t4;
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c)
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int x = jn * 4 + 2 * r;
          *reinterpret_cast<uint32_t*>(dst + c * 64 + jn * 8) =
              pack_bf16(acc[c][x] * scale, acc[c][x + 1] * scale);
        }
    }
  }
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float2* stats, bf16* qs,
           bf16* dq, bf16* dk, bf16* dv, int B, int S, int T, int H, int KVH,
           int causal, int window, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  int exp2 = 0;
  const bool pow2 = scale > 0.f && std::frexp(scale, &exp2) == 0.5f;
  if (!pow2 && qs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int S_pad = (S + TILE - 1) / TILE * TILE;
  const int64_t rows = static_cast<int64_t>(B) * H * S_pad;
  unsigned* counters = reinterpret_cast<unsigned*>(stats + rows);  // dk/dv, dq
  constexpr int RPB = PREP_THREADS / (HD / 8);       // rows a block
  bwd_prep<HD><<<static_cast<unsigned>((rows + RPB - 1) / RPB), PREP_THREADS,
                 0, stream>>>(q, o, dout, lse, stats, counters,
                              pow2 ? nullptr : qs, rows, S, S_pad, H, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // q itself at a power-of-two scale (folded into l2e and dk), else qs
  CUtensorMap mq, mdo, mk, mv;
  int res = encode_heads(&mq, pow2 ? static_cast<const void*>(q) : qs, B, S,
                         H, HD, TILE);
  if (res == CUDA_SUCCESS) res = encode_heads(&mdo, dout, B, S, H, HD, TILE);
  if (res == CUDA_SUCCESS) res = encode_heads(&mk, k, B, T, KVH, HD, TILE);
  if (res == CUDA_SUCCESS) res = encode_heads(&mv, v, B, T, KVH, HD, TILE);
  if (res != CUDA_SUCCESS) return -res;
  const float l2e = pow2 ? LOG2E * scale : LOG2E;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // setmaxnreg.inc would wait forever for registers the launch never had;
  // ptxas' register counts are asked once
  static const cudaError_t regs = [] {
    for (const void* fn : {reinterpret_cast<const void*>(bwd_dkdv<HD>),
                           reinterpret_cast<const void*>(bwd_dq<HD>)}) {
      cudaFuncAttributes attr;
      const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
      if (e != cudaSuccess) return e;
      if (attr.numRegs < LAUNCH_REGS) return cudaErrorInvalidConfiguration;
    }
    return cudaSuccess;
  }();
  if (regs != cudaSuccess) return static_cast<int>(regs);

  // As many CTAs as fit on the card at once (one an SM) walk the units.
  err = cudaFuncSetAttribute(bwd_dkdv<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::KV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_units = (T + ROWS - 1) / ROWS * B * KVH;
  bwd_dkdv<HD><<<min(kv_units, sms), THREADS, C::KV_SMEM, stream>>>(
      mq, mdo, mk, mv, stats, counters, dk, dv, B, S, S_pad, T, H, KVH,
      causal, window, l2e, pow2 ? scale : 1.f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(bwd_dq<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dq_units = (S + ROWS - 1) / ROWS * B * H;
  bwd_dq<HD><<<min(dq_units, sms), THREADS, C::DQ_SMEM, stream>>>(
      mq, mdo, mk, mv, stats, counters + 1, dq, B, S, S_pad, T, H, KVH,
      causal, window, l2e, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq (B, S, H, hd) and k, v, dk, dv (B, T, KVH, hd): contiguous
// bf16 on the device with 16-byte aligned bases; lse (B, H, S) fp32; the
// scratch stats: (B, H, S rounded up to 64, 2) fp32, then two int32 unit
// counters; qs (B, S, H, hd) bf16 scratch where the scale is not a power of
// two (hd = 128; null otherwise); H a multiple of KVH; hd 64 or 128;
// window <= 0 means none; the work units ceil(T / 128) B KVH and ceil(S /
// 128) B H below 2^31. The caller validates shapes. Launches three kernels
// on `stream`; returns the CUDA error of the first launch that failed (0 if
// none), or minus the CUresult of a tensor map that could not be encoded.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* stats, void* qs, void* dq, void* dk,
                                   void* dv, int B, int S, int T, int H,
                                   int KVH, int hd, int causal, int window,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto bq = [](const void* p) { return static_cast<const bf16*>(p); };
  auto bw = [](void* p) { return static_cast<bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float2* sd = static_cast<float2*>(stats);
  if (hd == 64)
    return launch<64>(bq(q), bq(k), bq(v), bq(o), bq(dout), l, sd, bw(qs),
                      bw(dq), bw(dk), bw(dv), B, S, T, H, KVH, causal,
                      window, scale, st);
  if (hd == 128)
    return launch<128>(bq(q), bq(k), bq(v), bq(o), bq(dout), l, sd, bw(qs),
                       bw(dq), bw(dk), bw(dv), B, S, T, H, KVH, causal,
                       window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
