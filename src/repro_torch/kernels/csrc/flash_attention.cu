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
//   * out = acc / max(l, 1e-30), rounded to bf16.
// GQA: query head h reads kv head h / (H / Kv) in place (the reference
// repeats K and V per query head first; the values are the same).
//
// Design. One block of 4 warps owns 64 query rows of one (batch, head); each
// warp owns 16 rows and keeps them to the end: its Q fragments, its fp32
// output accumulator and its softmax statistics live in registers. The block
// walks the key/value tiles of 64 rows that the mask leaves live (in the
// causal case the tiles wholly after the query tile are skipped, as the TPU
// kernel skips them; with a window also the tiles wholly before it), staging
// each in shared memory with cp.async, double-buffered so the next tile loads
// while this one computes. Both products are warp-level mma.sync
// m16n8k16 bf16 -> fp32: S = Q K^T with K fragments read by ldmatrix, then
// the S accumulators are rescaled, exponentiated and repacked in registers as
// the A fragments of P V (the m16n8 accumulator layout is the m16k16 operand
// layout), with V fragments read by ldmatrix.trans. Shared-memory rows are
// padded by 16 bytes so that ldmatrix's eight row addresses hit distinct
// banks. Query tiles are issued heaviest first (reverse order), since causal
// tiles near the end of the sequence see the most keys.
//
// Bound on the card. 4 hd flops per live (query, key) pair (QK^T and PV) on
// the bf16 tensor cores (989 TFLOP/s dense on an H100 SXM), and Q, K, V and O
// read or written once (3.35 TB/s): at the embed path's (32, 512, 36, 64) the
// 302 MB of bytes bound it (0.090 ms), at (2, 4096, 36, 64) the 1.55e11
// flops (0.157 ms). This first version uses mma.sync, not wgmma, and no TMA;
// its softmax runs on the CUDA cores between the two products of each tile,
// with no overlap inside a warp: both are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;                  // query rows per block
constexpr int BN = 64;                  // key/value rows per tile
constexpr int WARPS = BM / 16;          // 16 query rows per warp
constexpr int THREADS = 32 * WARPS;
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
struct Shape {
  static constexpr int LD = HD + 8;                  // padded smem row
  static constexpr int TILE = BN * LD;               // elements per tile
  static constexpr int CHUNKS = HD / 8;              // 16-byte chunks per row
  // Q, then two stages of K, then two stages of V
  static constexpr size_t SMEM = 5 * TILE * sizeof(bf16);
  static_assert(BM == BN, "Q and K/V tiles share one layout");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [0, BN) of a K or V tile (row stride `stride` elements); rows
// at or past `valid` are zero-filled, so that masked keys multiply zeros.
template <int HD>
__device__ __forceinline__ void load_kv(bf16* dst, const bf16* src,
                                        int64_t stride, int valid) {
  using L = Shape<HD>;
  for (int c = threadIdx.x; c < BN * L::CHUNKS; c += THREADS) {
    const int r = c / L::CHUNKS, col = (c % L::CHUNKS) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * L::LD + col, ok ? src + r * stride + col : src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o, int S, int T,
          int H, int KVH, int causal, int window, float scale) {
  using L = Shape<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + L::TILE;
  bf16* sV = sK + 2 * L::TILE;

  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KVH);
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KVH) * HD;
  const bf16* gq = q + (static_cast<int64_t>(b) * S + m0) * q_stride + h * HD;
  bf16* go = o + (static_cast<int64_t>(b) * S + m0) * q_stride + h * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * T * kv_stride + kvh * HD;
  const bf16* gk = k + kv_base;
  const bf16* gv = v + kv_base;

  // Live key tiles [j0, j1): keys < T, <= the tile's last query when
  // causal, > its first query - window with a window.
  const int n_end = causal ? min(T, m0 + BM) : T;
  const int n_begin = window > 0 ? max(0, m0 - window + 1) : 0;
  const int j0 = n_begin / BN;
  const int j1 = (n_end + BN - 1) / BN;

  if (j0 < j1) {
    load_kv<HD>(sK, gk + j0 * BN * kv_stride, kv_stride, T - j0 * BN);
    load_kv<HD>(sV, gv + j0 * BN * kv_stride, kv_stride, T - j0 * BN);
  }
  cp_async_commit();

  // Q tile, scaled in fp32 and rounded to bf16 (rows past S are zero).
  for (int c = threadIdx.x; c < BM * L::CHUNKS; c += THREADS) {
    const int r = c / L::CHUNKS, col = (c % L::CHUNKS) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < S)
      raw = *reinterpret_cast<const uint4*>(gq + r * q_stride + col);
    __nv_bfloat162* two = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(two[i]);
      two[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(sQ + r * L::LD + col) = raw;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;

  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    ldsm_x4(qf[ks], sQ + (warp * 16 + (lane & 15)) * L::LD + ks * 16
                        + (lane >> 4) * 8);

  // Rows g and g + 8 of this warp's 16: running max, this thread's share of
  // the denominator, and the output accumulator (HD/8 tiles of 16x8).
  const int row0 = m0 + warp * 16 + g;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) & 1;
    if (j + 1 < j1) {
      const int64_t off = static_cast<int64_t>(j + 1) * BN * kv_stride;
      load_kv<HD>(sK + (stage ^ 1) * L::TILE, gk + off, kv_stride,
                  T - (j + 1) * BN);
      load_kv<HD>(sV + (stage ^ 1) * L::TILE, gv + off, kv_stride,
                  T - (j + 1) * BN);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK + stage * L::TILE;
    const bf16* cV = sV + stage * L::TILE;

    // S = (q * scale) K^T for 16 rows x 64 keys: 8 accumulators of 16x8.
    float sc[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; nt += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, cK + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) * L::LD
                        + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[nt], qf[ks], kb[0], kb[1]);
        mma_bf16(sc[nt + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // Mask, then the online-softmax update of rows g (i = 0), g + 8 (i = 1).
    const int n0 = j * BN;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + tq * 2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool live = col < T && (!causal || col <= row)
                          && (window <= 0 || col > row - window);
        if (!live) sc[nt][e] = MASKED;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      alpha[i] = __expf(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sc[nt][e] - m_run[e >> 1]);
        l_run[e >> 1] += p;
        sc[nt][e] = p;
      }
    }

    // acc += bf16(P) V: the accumulators of key tiles 2kk and 2kk + 1 are
    // the A operand of keys [16kk, 16kk + 16).
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < HD / 8; dt += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                 * L::LD + dt * 8 + (lane >> 4) * 8);
        mma_bf16(acc[dt], pa, vb[0], vb[1]);
        mma_bf16(acc[dt + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // this stage is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(FULL, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(FULL, l_run[i], 2);
    l_run[i] = fmaxf(l_run[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row0 + i * 8 >= S) continue;
    bf16* dst = go + (warp * 16 + g + i * 8) * q_stride + tq * 2;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(acc[dt][2 * i] / l_run[i], acc[dt][2 * i + 1] / l_run[i]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T, int H, int KVH, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = Shape<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, T, H, KVH,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o (B, S, H, hd) and k, v (B, T, KVH, hd), all contiguous bf16 on the
// device; H a multiple of KVH; hd 64 or 128; window <= 0 means none. The
// caller validates shapes. Returns the CUDA error of the launch (0 if none).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int T, int H, int KVH, int hd, int causal,
                                   int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(q, k, v, o, B, S, T, H, KVH, causal, window, scale, st);
  if (hd == 128)
    return launch<128>(q, k, v, o, B, S, T, H, KVH, causal, window, scale,
                       st);
  return static_cast<int>(cudaErrorInvalidValue);
}
