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
// Design: three launches on the caller's stream, no floating-point atomics,
// so that two calls on the same inputs give the same bits.
//   1. bwd_rowdot: D, one warp a (batch, query, head) row.
//   2. bwd_dkdv: one 128-thread block a (batch, kv head, 64-key tile); each
//      warp owns 16 keys. It walks the H / Kv query heads of its group and,
//      for each, the query tiles that can see its keys (past the diagonal
//      when causal, inside the window), staging each query tile's qs and do
//      in shared memory. It recomputes S^T and dP^T for its keys by
//      mma.sync m16n8k16 (bf16 in, fp32 out), and accumulates dv += bf16(P)^T
//      do and dk += bf16(dS)^T qs in registers; the accumulator fragments of
//      S^T are the A fragments of the next product once pairs are packed.
//   3. bwd_dq: one block a (batch, head, 64-query tile), each warp 16
//      queries, walking the key tiles its queries see: S and dP again, then
//      dq += bf16(dS) k.
//   Blocks are numbered heaviest first under a causal mask (the last query
//   tiles, the first key tiles). Shared rows are padded by 16 bytes, so
//   that the fragment loads, row-wise and column-wise, meet no bank
//   conflicts.
//
// Bound on the card: with lse given, the function needs S = QK^T, dV, dP,
// dQ and dK: 10 hd flops per live (query, key) pair on the bf16 tensor
// cores (989 TFLOP/s dense on an H100 SXM), against reading q, k, v, o, do
// and lse and writing dq, dk, dv once (3.35 TB/s). At MiniCPM-2B's train
// shape (2, 4096, 36, 64) causal that is 3.9e11 flops, 0.39 ms. This first
// K7b computes S and dP in both passes (14 hd flops a pair), with
// mma.sync from registers and shared memory staged synchronously by the
// block's own loads: no TMA, no wgmma, no pipelining across tiles. Those
// are the work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;   // four warps
constexpr int BK = 64;         // keys of a dk/dv block, of a dq key tile
constexpr int BQ = 64;         // queries of a dq block
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
struct Cfg {
  static constexpr int LD = HD + 8;         // padded shared row, elements
  // query tile of the dk/dv block: at hd = 128 the dk and dv accumulators
  // take 128 registers a thread, so its S^T and dP^T tiles are halved
  static constexpr int BQ_KV = HD == 128 ? 32 : 64;
  static constexpr int DQ_SMEM = (2 * BQ + 2 * BK) * LD * 2;
  static constexpr int KV_SMEM = (2 * BK + 2 * BQ_KV) * LD * 2
                                 + 2 * BQ_KV * 4;
};

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
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

// Two bf16 of shared memory, at element offsets lo and hi, as one register.
__device__ __forceinline__ uint32_t pair(const bf16* s, int lo, int hi) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(s);
  return static_cast<uint32_t>(u[lo]) | (static_cast<uint32_t>(u[hi]) << 16);
}

__device__ __forceinline__ uint32_t word(const bf16* s, int at) {
  return *reinterpret_cast<const uint32_t*>(s + at);
}

// The A fragment (16 rows x 16 columns at column c0) of a row-major shared
// tile whose rows are LD elements apart, rows r0 .. r0 + 15.
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t a[4], const bf16* s, int r0,
                                       int c0, int g, int t4) {
  const bf16* p = s + (r0 + g) * LD + c0 + 2 * t4;
  a[0] = word(p, 0);
  a[1] = word(p, 8 * LD);
  a[2] = word(p, 8);
  a[3] = word(p, 8 * LD + 8);
}

// Stage `rows` rows of a (.., rows, heads, HD) bf16 tensor, `stride`
// elements apart, into a padded shared tile of `tile` rows; rows past
// `valid` are zeros. With `scale` > 0 each element is multiplied by it in
// fp32 and rounded to bf16 (K7's scaled query).
template <int HD>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      int64_t stride, int tile, int valid,
                                      float scale) {
  constexpr int LD = Cfg<HD>::LD;
  constexpr int CH = HD / 8;                 // 16-byte chunks a row
  for (int i = threadIdx.x; i < tile * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid) {
      v = *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
      if (scale > 0.f) {
        __nv_bfloat162* two = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(two[e]);
          two[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = v;
  }
}

__device__ __forceinline__ bool live(int i, int j, int S, int T, int causal,
                                     int window) {
  return i < S && j < T && (!causal || j <= i)
         && (window <= 0 || j > i - window);
}

// D[b, h, i] = sum_d do[b, i, h, d] o[b, i, h, d] in fp32: one warp a row,
// rows numbered as the (b, i, h) order of o.
template <int HD>
__global__ void __launch_bounds__(256)
bwd_rowdot(const bf16* __restrict__ o, const bf16* __restrict__ dout,
           float* __restrict__ dvec, int64_t rows, int S, int H) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < HD / 64; ++c) {
    const int64_t at = row * HD + c * 64 + lane * 2;
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + at));
    const float2 d = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + at));
    acc = fmaf(a.x, d.x, acc);
    acc = fmaf(a.y, d.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const int64_t bi = row / H;                // b * S + i
    const int64_t b = bi / S, i = bi % S;
    dvec[(b * H + h) * S + i] = acc;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, const bf16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ dvec,
         bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int T, int H,
         int KVH, int causal, int window, float scale) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, BQK = C::BQ_KV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sO = sQ + BQK * LD;                  // the query tile's do
  float* sL = reinterpret_cast<float*>(sO + BQK * LD);
  float* sD = sL + BQK;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
  const int grp = H / KVH;
  const int n0 = blockIdx.y * BK;            // heaviest (first keys) first
  const int kw = warp * 16;                  // this warp's keys in the tile
  const int key0 = n0 + kw + g, key1 = key0 + 8;

  const int64_t kv_stride = static_cast<int64_t>(KVH) * HD;
  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_base = ((static_cast<int64_t>(b) * T + n0) * KVH + kvh) * HD;
  stage<HD>(sK, k + kv_base, kv_stride, BK, T - n0, 0.f);
  stage<HD>(sV, v + kv_base, kv_stride, BK, T - n0, 0.f);

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  // queries that see a key of this tile
  const int i_lo = causal ? n0 : 0;
  const int i_hi = window > 0 ? min(S, n0 + BK - 1 + window) : S;
  for (int hh = 0; hh < grp; ++hh) {
    const int h = kvh * grp + hh;
    const int64_t bh = static_cast<int64_t>(b) * H + h;
    for (int m0 = (i_lo / BQK) * BQK; m0 < i_hi; m0 += BQK) {
      __syncthreads();                       // the last tile's readers
      const int64_t q_base = ((static_cast<int64_t>(b) * S + m0) * H + h) * HD;
      stage<HD>(sQ, q + q_base, q_stride, BQK, S - m0, scale);
      stage<HD>(sO, dout + q_base, q_stride, BQK, S - m0, 0.f);
      for (int i = threadIdx.x; i < BQK; i += THREADS) {
        const bool in = m0 + i < S;
        sL[i] = in ? lse[bh * S + m0 + i] : 0.f;
        sD[i] = in ? dvec[bh * S + m0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K qs^T and dP^T = V do^T: this warp's 16 keys x BQK queries
      float st[BQK / 8][4], dpt[BQK / 8][4];
#pragma unroll
      for (int n = 0; n < BQK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ka[4], va[4];
        a_frag<LD>(ka, sK, kw, kk * 16, g, t4);
        a_frag<LD>(va, sV, kw, kk * 16, g, t4);
#pragma unroll
        for (int n = 0; n < BQK / 8; ++n) {
          const int at = (n * 8 + g) * LD + kk * 16 + 2 * t4;
          mma(st[n], ka, word(sQ, at), word(sQ, at + 8));
          mma(dpt[n], va, word(sO, at), word(sO, at + 8));
        }
      }
      // P^T and dS^T = P^T (dP^T - D), in place
#pragma unroll
      for (int n = 0; n < BQK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + 2 * t4 + (e & 1);
          const int key = (e < 2) ? key0 : key1;
          const float p = live(m0 + qi, key, S, T, causal, window)
                              ? __expf(st[n][e] - sL[qi]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - sD[qi]);
        }
      // dv += bf16(P^T) do, dk += bf16(dS^T) qs: the k-step kk covers
      // queries [16 kk, 16 kk + 16)
#pragma unroll
      for (int kk = 0; kk < BQK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(st[2 * kk][0], st[2 * kk][1]),
            pack_bf16(st[2 * kk][2], st[2 * kk][3]),
            pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
            pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t sa[4] = {
            pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
            pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
            pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
            pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
        const int r0 = (kk * 16 + 2 * t4) * LD;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const int c = r0 + n * 8 + g;
          mma(acc_v[n], pa, pair(sO, c, c + LD),
              pair(sO, c + 8 * LD, c + 9 * LD));
          mma(acc_k[n], sa, pair(sQ, c, c + LD),
              pair(sQ, c + 8 * LD, c + 9 * LD));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = i ? key1 : key0;
    if (key >= T) continue;
    const int64_t at =
        ((static_cast<int64_t>(b) * T + key) * KVH + kvh) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + n * 8) =
          pack_bf16(acc_k[n][2 * i], acc_k[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + n * 8) =
          pack_bf16(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, const bf16* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ dvec,
       bf16* __restrict__ dq, int S, int T, int H, int KVH, int causal,
       int window, float scale) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + BQ * LD;
  bf16* sK = sO + BQ * LD;
  bf16* sV = sK + BK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KVH);
  const int n_mt = (S + BQ - 1) / BQ;
  const int m0 = (n_mt - 1 - blockIdx.y) * BQ;   // heaviest (last rows) first
  const int qw = warp * 16;
  const int row0 = m0 + qw + g, row1 = row0 + 8;
  const int64_t bh = static_cast<int64_t>(b) * H + h;

  const int64_t q_stride = static_cast<int64_t>(H) * HD;
  const int64_t kv_stride = static_cast<int64_t>(KVH) * HD;
  const int64_t q_base = ((static_cast<int64_t>(b) * S + m0) * H + h) * HD;
  stage<HD>(sQ, q + q_base, q_stride, BQ, S - m0, scale);
  stage<HD>(sO, dout + q_base, q_stride, BQ, S - m0, 0.f);
  const float l0 = row0 < S ? lse[bh * S + row0] : 0.f;
  const float l1 = row1 < S ? lse[bh * S + row1] : 0.f;
  const float d0 = row0 < S ? dvec[bh * S + row0] : 0.f;
  const float d1 = row1 < S ? dvec[bh * S + row1] : 0.f;

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // key tiles these queries see
  const int n_end = causal ? min(T, m0 + BQ) : T;
  const int n_begin = window > 0 ? max(0, m0 - window + 1) : 0;
  for (int n0 = (n_begin / BK) * BK; n0 < n_end; n0 += BK) {
    __syncthreads();                         // the last tile's readers
    const int64_t kv_base =
        ((static_cast<int64_t>(b) * T + n0) * KVH + kvh) * HD;
    stage<HD>(sK, k + kv_base, kv_stride, BK, T - n0, 0.f);
    stage<HD>(sV, v + kv_base, kv_stride, BK, T - n0, 0.f);
    __syncthreads();

    // S = qs K^T and dP = do V^T: this warp's 16 queries x BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], oa[4];
      a_frag<LD>(qa, sQ, qw, kk * 16, g, t4);
      a_frag<LD>(oa, sO, qw, kk * 16, g, t4);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int at = (n * 8 + g) * LD + kk * 16 + 2 * t4;
        mma(s[n], qa, word(sK, at), word(sK, at + 8));
        mma(dp[n], oa, word(sV, at), word(sV, at + 8));
      }
    }
    // dS = P (dP - D), P = exp(s - lse), in place
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + n * 8 + 2 * t4 + (e & 1);
        const bool lo = e < 2;
        const int row = lo ? row0 : row1;
        const float p = live(row, key, S, T, causal, window)
                            ? __expf(s[n][e] - (lo ? l0 : l1)) : 0.f;
        s[n][e] = p * (dp[n][e] - (lo ? d0 : d1));
      }
    // dq += bf16(dS) K: the k-step kk covers keys [16 kk, 16 kk + 16)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t sa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int r0 = (kk * 16 + 2 * t4) * LD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int c = r0 + n * 8 + g;
        mma(acc[n], sa, pair(sK, c, c + LD),
            pair(sK, c + 8 * LD, c + 9 * LD));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? row1 : row0;
    if (row >= S) continue;
    bf16* dst = dq + ((static_cast<int64_t>(b) * S + row) * H + h) * HD
                + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack_bf16(
          acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* dvec, bf16* dq,
           bf16* dk, bf16* dv, int B, int S, int T, int H, int KVH,
           int causal, int window, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int64_t rows = static_cast<int64_t>(B) * S * H;
  bwd_rowdot<HD><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      o, dout, dvec, rows, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(bwd_dkdv<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::KV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(B * KVH, (T + BK - 1) / BK);
  bwd_dkdv<HD><<<grid_kv, THREADS, C::KV_SMEM, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, S, T, H, KVH, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(bwd_dq<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q(B * H, (S + BQ - 1) / BQ);
  bwd_dq<HD><<<grid_q, THREADS, C::DQ_SMEM, stream>>>(
      q, k, v, dout, lse, dvec, dq, S, T, H, KVH, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq (B, S, H, hd) and k, v, dk, dv (B, T, KVH, hd): contiguous
// bf16 on the device with 16-byte aligned bases; lse and the scratch dvec
// (B, H, S) fp32; H a multiple of KVH; hd 64 or 128; window <= 0 means none;
// B * max(H, KVH) and the tile counts ceil(S / 64), ceil(T / 64) within a
// grid's limits. The caller validates shapes. Launches three kernels on
// `stream`; returns the CUDA error of the first launch that failed (0 if
// none).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dvec, void* dq, void* dk, void* dv,
                                   int B, int S, int T, int H, int KVH,
                                   int hd, int causal, int window,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto bq = [](const void* p) { return static_cast<const bf16*>(p); };
  auto bw = [](void* p) { return static_cast<bf16*>(p); };
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(dvec);
  if (hd == 64)
    return launch<64>(bq(q), bq(k), bq(v), bq(o), bq(dout), l, d, bw(dq),
                      bw(dk), bw(dv), B, S, T, H, KVH, causal, window, scale,
                      st);
  if (hd == 128)
    return launch<128>(bq(q), bq(k), bq(v), bq(o), bq(dout), l, d, bw(dq),
                       bw(dk), bw(dv), B, S, T, H, KVH, causal, window,
                       scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
