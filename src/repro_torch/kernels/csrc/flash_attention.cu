// Flash attention forward for Hopper (sm_90a): K7.
//
// Replaces the Pallas TPU kernel of the reference package's
// kernels/flash_attention.py (flash_attention and its _kernel body): causal
// or sliding-window online-softmax attention of bf16 q (B, S, H, hd) over
// bf16 k, v (B, T, Kv, hd), fp32 statistics and accumulation, bf16 output.
//
// Contract (the TPU kernel's arithmetic):
//   * q is multiplied by scale = 1/sqrt(hd) in fp32 and rounded to bf16
//     before the QK^T dot;
//   * bf16 x bf16 products accumulate in fp32; masked scores are -1e30
//     (key j is visible to query i iff j < T, j <= i when causal, and
//     j > i - window with a window);
//   * online softmax with fp32 running max m, denominator l and
//     accumulator; the numerators p = exp(s - m) are rounded to bf16 before
//     the PV dot, l sums them unrounded;
//   * out = acc / max(l, 1e-30), rounded to bf16;
//   * optionally the row's log-sum-exp lse = m + log(l) in fp32 (B, H, S),
//     in the units of the scaled scores: the statistics the backward (K7b,
//     csrc/flash_attention_bwd.cu) recomputes the softmax from. A null lse
//     pointer writes nothing (serving).
// GQA: query head h reads kv head h / (H / Kv) in place (the reference
// repeats K and V per query head first; the values are the same).
//
// Design: a persistent, warp-specialised CTA of one consumer warpgroup and
// one producer warp.
//   * Work units are (64 query rows, batch x head). The query tiles of one
//     head are adjacent in the unit order, so that the CTAs running at once
//     share their K/V tiles in L2, and the heaviest come first. As many CTAs
//     as fit on the card at once walk the units: round r gives CTA c unit
//     rG + c, or rG + G - 1 - c in odd rounds, so two rounds pair a heavy
//     causal tile with a light one.
//   * The producer warp lowers its registers (setmaxnreg) and one of its
//     threads issues every copy as TMA (cp.async.bulk.tensor) through 4-d
//     tensor maps over (B, S, H, hd) and (B, T, Kv, hd) with boxes of
//     (64, 1, 64, 1): each unit's Q tile into one of two buffers, its live
//     K/V tiles into a ring of STAGES stages, all with full/empty mbarriers.
//     It runs ahead into the next unit while the consumers finish this one.
//     A box never crosses into the next batch or head, and rows past S or T
//     arrive as zeros. Tiles are [rows][64] blocks of 128-byte rows,
//     128-byte swizzled, so hd = 128 is two blocks.
//   * The consumer warpgroup computes S = Q K^T by wgmma m64n64k16 with
//     both operands K-major in shared memory; the online softmax in
//     registers; O += P V by wgmma m64n64k16 with P from registers (the fp32
//     S accumulator layout is the bf16 A-fragment layout once pairs are
//     packed) and V read MN-major (the transpose bit). It releases a stage
//     when its wgmma have retired.
//   * The scale: at hd = 64, 1/sqrt(hd) = 1/8 is exact in bf16 and commutes
//     with every fp32 rounding of the dot, so it is folded into the softmax
//     (exp(s - m) = 2^((s - m) log2e / 8), one FFMA and one EX2 a score);
//     otherwise Q is scaled and rounded in shared memory once per unit
//     (fence.proxy.async before wgmma reads it).
//   * The mask predicate runs only on tiles that hold a masked cell (the
//     causal diagonal, the window's first tile, the tile holding key T);
//     tiles wholly outside the causal or window range are not loaded.
//
// Occupancy, as measured on an H100 (PERF.md): three 160-thread CTAs per SM
// at hd = 64 (128 registers a thread, no spills; 67 KB of shared memory
// each: two Q tiles and 3 stages). Query tiles of 128 rows (two consumer
// warpgroups) halve the K/V reads from L2 but leave 96 registers a thread at
// two CTAs per SM and spill; one such CTA per SM leaves too few warps to
// hide the per-tile latency. Key tiles of 128 double the score registers,
// with the same effect. hd = 128 runs two CTAs per SM (168 registers).
//
// Bound on the card. 4 hd flops per live (query, key) pair (QK^T and PV) on
// the bf16 tensor cores (989 TFLOP/s dense on an H100 SXM), and Q, K, V and O
// read or written once (3.35 TB/s): at the embed path's (32, 512, 36, 64) the
// 302 MB of bytes bound it (0.090 ms), at (2, 4096, 36, 64) the 1.55e11
// flops (0.157 ms). Each warpgroup runs S, the softmax and P V of a tile one
// after the other; overlapping them (two warpgroups ping-ponging, or a
// software pipeline within one) is not done here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;                   // query rows per CTA (one warpgroup)
constexpr int BN = 64;                   // keys per K/V tile
constexpr int CONSUMERS = 128;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int SMEM_BUDGET = 232448;      // bytes one CTA may use
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
struct Cfg {
  // CTAs per SM: 3 x 5 warps leave 128 registers a thread at hd = 64; at
  // hd = 128 the 64 output accumulators want 2 (168 registers).
  static constexpr int MIN_BLOCKS = HD == 64 ? 3 : 2;
  static constexpr int CHUNKS = HD / 64;              // 128-byte column blocks
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;        // one of K or V
  static constexpr int FIXED = 1024 + 2 * Q_BYTES + 128;  // slack, 2 Q, bars
  static constexpr int FIT =
      (SMEM_BUDGET / MIN_BLOCKS - 1024 - FIXED) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = FIXED + STAGES * 2 * KV_BYTES;
  static_assert(STAGES >= 2, "the K/V ring needs two stages");
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

template <int HD>
__global__ void __launch_bounds__(THREADS, Cfg<HD>::MIN_BLOCKS)
flash_fwd(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
          float* __restrict__ lse, int B, int S, int T, int H, int KVH,
          int causal, int window, float scale, int pow2_scale) {
  using C = Cfg<HD>;
  // log2(e) times the factor the scores still need: exp(x) = 2^(x log2e).
  const float l2e = pow2_scale ? LOG2E * scale : LOG2E;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte alignment.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sQ0 = (raw + 1023u) & ~1023u;      // 2 x CHUNKS x [BM][64]
  const uint32_t sKV = sQ0 + 2 * C::Q_BYTES;        // stage s: K, then V
  const uint32_t bars = sKV + C::STAGES * 2 * C::KV_BYTES;
  // full[s], empty[s] of the K/V ring; qfull[q], qempty[q] of the two Q
  // buffers.
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };
  auto qfull = [&](int q) { return bars + 8 * (2 * C::STAGES + q); };
  auto qempty = [&](int q) { return bars + 8 * (2 * C::STAGES + 2 + q); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);   // one arrival per warp
    }
    for (int q = 0; q < 2; ++q) {
      mbar_init(qfull(q), 1);
      mbar_init(qempty(q), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Work units (query tile, batch x head): the query tiles of one head are
  // adjacent, so that the CTAs running at once share K/V tiles in L2, and
  // the heaviest come first.
  const int n_mt = (S + BM - 1) / BM, BH = B * H;
  const int units = n_mt * BH;
  // Round rd of a persistent grid gives CTA c unit rd * G + c, or
  // rd * G + G - 1 - c in odd rounds: two rounds then pair a heavy query
  // tile with a light one.
  auto unit_of = [&](int rd) {
    const int c = (rd & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return rd * gridDim.x + c;
  };
  struct Unit { int m0, b, h, j0, j1; };
  auto unit = [&](int u) {
    Unit w;
    w.m0 = (n_mt - 1 - u % n_mt) * BM;
    const int bh = u / n_mt;
    w.b = bh / H;
    w.h = bh % H;
    // Live key tiles [j0, j1): keys < T, <= the unit's last query when
    // causal, > its first query - window with a window.
    const int n_end = causal ? min(T, w.m0 + BM) : T;
    const int n_begin = window > 0 ? max(0, w.m0 - window + 1) : 0;
    w.j0 = n_begin / BN;
    // none when every key is out of the window (non-causal, S > T + window):
    // the unit's rows then count no tiles on either side
    w.j1 = max(w.j0, (n_end + BN - 1) / BN);
    return w;
  };

  if (threadIdx.x >= CONSUMERS) {
    // Producer warp: it needs few registers; one thread issues every copy,
    // running ahead into the next unit while the consumers finish this one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS) {
      int it = 0, n = 0;    // K/V tiles and units issued by this CTA
      for (int rd = 0; rd * gridDim.x < units; ++rd) {
        const int u = unit_of(rd);
        if (u >= units) continue;
        const Unit w = unit(u);
        const int kvh = w.h / (H / KVH);
        const int qb = n & 1;
        const uint32_t sQ = sQ0 + qb * C::Q_BYTES;
        mbar_wait(qempty(qb), ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(qfull(qb), C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c)
          tma_load_4d(sQ + c * BM * 128, &tq, qfull(qb), c * 64, w.h, w.m0,
                      w.b);
        for (int j = w.j0; j < w.j1; ++j, ++it) {
          const int st = it % C::STAGES;
          mbar_wait(empty(st), ((it / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(full(st), 2 * C::KV_BYTES);
          const uint32_t dk = sKV + st * 2 * C::KV_BYTES;
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c) {
            tma_load_4d(dk + c * BN * 128, &tk, full(st), c * 64, kvh,
                        j * BN, w.b);
            tma_load_4d(dk + C::KV_BYTES + c * BN * 128, &tv, full(st),
                        c * 64, kvh, j * BN, w.b);
          }
        }
        ++n;
      }
    }
  } else {
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    int it0 = 0, n = 0;     // K/V tiles and units consumed by this CTA
    for (int rd = 0; rd * gridDim.x < units; ++rd) {
      const int u = unit_of(rd);
      if (u >= units) continue;
      const Unit w = unit(u);
      const int j0 = w.j0, j1 = w.j1, b = w.b, h = w.h;
      const int r0 = w.m0;                         // the unit's rows
      const int row0 = r0 + warp * 16 + g;         // rows row0, row0 + 8
      const int qb = n & 1;
      const uint32_t qa = sQ0 + qb * C::Q_BYTES;

      // q * scale in fp32, rounded to bf16, in place (element-wise, so the
      // swizzle does not matter); then hand the rows to the async proxy.
      // A power-of-two scale (hd = 64) is exact in bf16 and commutes with
      // every fp32 rounding of the dot: it is applied to the scores instead.
      mbar_wait(qfull(qb), (n >> 1) & 1);
      if (!pow2_scale) {
        unsigned char* q_gen = smem_raw + (qa - raw);
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) {
#pragma unroll
          for (int i = tid; i < 64 * 8; i += 128) {
            uint4* p = reinterpret_cast<uint4*>(q_gen + c * BM * 128) + i;
            uint4 v = *p;
            __nv_bfloat162* two = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(two[e]);
              two[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
            }
            *p = v;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
      }

      float m_run[2] = {-INFINITY, -INFINITY};
      float l_run[2] = {0.f, 0.f};
      float acc[C::CHUNKS][32];
#pragma unroll
      for (int c = 0; c < C::CHUNKS; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

      for (int j = j0; j < j1; ++j) {
        const int it = it0 + j - j0, st = it % C::STAGES;
        mbar_wait(full(st), (it / C::STAGES) & 1);
        const uint32_t sk = sKV + st * 2 * C::KV_BYTES;
        const uint32_t sv = sk + C::KV_BYTES;
        const int n0 = j * BN;
        // S = Q K^T (Q scaled above, or the scale folded into l2e): 64 rows
        // x BN keys.
        float s[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;   // 16 bf16 of a 128-byte row
          wgmma_ss_n64(s, desc_k_major(qa + (kk / 4) * BM * 128 + off),
                      desc_k_major(sk + (kk / 4) * BN * 128 + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // The mask, only where a cell of these rows is masked; then the
        // online-softmax update of rows row0 (i = 0) and row0 + 8 (i = 1).
        if ((causal && n0 + BN - 1 > r0) || n0 + BN > T
            || (window > 0 && n0 <= r0 + 63 - window)) {
#pragma unroll
          for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = n0 + jn * 8 + t4 * 2 + (e & 1);
              const int row = row0 + (e >> 1) * 8;
              const bool live = col < T && (!causal || col <= row)
                                && (window <= 0 || col > row - window);
              if (!live) s[jn * 4 + e] = MASKED;
            }
          }
        }
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        // exp(s - m) = 2^(s l2e - m l2e), one FFMA and one EX2 a score (s
        // and m in the product's units, l2e holding a folded scale). A row
        // that has seen only masked scores (m = -1e30) takes exp(0) = 1 for
        // each, as exp(s - m) does.
        float alpha[2], sc[2], ms[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
          alpha[i] = ex2((m_run[i] - mx[i]) * l2e);
          m_run[i] = mx[i];
          l_run[i] *= alpha[i];
          sc[i] = mx[i] == MASKED ? 0.f : l2e;
          ms[i] = mx[i] * sc[i];
        }
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int r = (i >> 1) & 1;
          const float p = ex2(fmaf(s[i], sc[r], -ms[r]));
          l_run[r] += p;
          s[i] = p;
        }
        // bf16(P): the accumulators of keys [16 kk, 16 kk + 16) are the A
        // fragment of the kk-th k-step.
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }

        // O += bf16(P) V, per 64-column block of hd.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int c = 0; c < C::CHUNKS; ++c)
            wgmma_rs_n64_tb(acc[c], pa[kk],
                            desc_mn_major(sv + c * BN * 128 + kk * 16 * 128));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c) fence_regs(acc[c]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));   // the stage may be refilled
      }

      it0 += j1 - j0;
      __syncwarp();
      if (lane == 0) mbar_arrive(qempty(qb));      // Q may be refilled

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = l_run[i];
        l += __shfl_xor_sync(FULL, l, 1);
        l += __shfl_xor_sync(FULL, l, 2);
        l = fmaxf(l, 1e-30f);
        const int row = row0 + i * 8;
        if (row >= S) continue;
        // m is in the product's units: times the scale folded into l2e
        if (lse != nullptr && t4 == 0)
          lse[(static_cast<int64_t>(b) * H + h) * S + row] =
              m_run[i] * (pow2_scale ? scale : 1.f) + logf(l);
        bf16* dst = o + ((static_cast<int64_t>(b) * S + row) * H + h) * HD
                    + t4 * 2;
#pragma unroll
        for (int c = 0; c < C::CHUNKS; ++c)
#pragma unroll
          for (int jn = 0; jn < 8; ++jn)
            *reinterpret_cast<uint32_t*>(dst + c * 64 + jn * 8) = pack_bf16(
                acc[c][jn * 4 + 2 * i] / l, acc[c][jn * 4 + 2 * i + 1] / l);
      }
      ++n;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int T, int H, int KVH, int causal, int window,
           float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap mq, mk, mv;
  int res = encode_heads(&mq, q, B, S, H, HD, BM);
  if (res == CUDA_SUCCESS) res = encode_heads(&mk, k, B, T, KVH, HD, BN);
  if (res == CUDA_SUCCESS) res = encode_heads(&mv, v, B, T, KVH, HD, BN);
  if (res != CUDA_SUCCESS) return -res;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // As many CTAs as fit on the card at once walk the units.
  const int units = (S + BM - 1) / BM * B * H;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int ctas = min(units, sms * C::MIN_BLOCKS);
  int exp2 = 0;
  const int pow2_scale = scale > 0.f && std::frexp(scale, &exp2) == 0.5f;
  flash_fwd<HD><<<ctas, THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, B, S, T, H, KVH, causal,
      window, scale, pow2_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o (B, S, H, hd) and k, v (B, T, KVH, hd), all contiguous bf16 on the
// device with 16-byte aligned bases; lse (B, H, S) fp32 or null; H a
// multiple of KVH; hd 64 or 128; window <= 0 means none. The caller
// validates shapes. Returns the CUDA error of the launch (0 if none), or
// minus the CUresult of a tensor map that could not be encoded.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int S, int T, int H, int KVH, int hd,
                                   int causal, int window, float scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd == 64)
    return launch<64>(q, k, v, o, l, B, S, T, H, KVH, causal, window, scale,
                      st);
  if (hd == 128)
    return launch<128>(q, k, v, o, l, B, S, T, H, KVH, causal, window,
                       scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
