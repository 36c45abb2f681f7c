// Threshold-join kernels for Hopper (sm_90a): the batched fp32 self-join with
// a packed adjacency mask (K1), its bf16 coarse-count twin (K2), and the
// single (M, d) x (N, d) join (K3).
//
// Replaces the Pallas TPU kernels of the reference package's
// kernels/pairwise_l2.py:
//   join_batched_masked  <- pairwise_l2_join_batched_masked (+ the
//                           ops._fold_eligibility epilogue)
//   join_batched_prune   <- pairwise_l2_join_batched_prune
//   pairwise_join        <- pairwise_l2_join
//
// Contract (all three): sq = max(|a|^2 + |b|^2 - 2 a.b, 0) in fp32, a pair
// joins iff sq <= r*r (r squared in fp32). Mask words are LSB-first: bit
// j % 32 of word j / 32 of row i is the pair (i, j). Counts include the
// diagonal.
//
// Design. One block of 256 threads (8 warps) owns a 32-row x 128-column tile
// of one subset. It stages 32-feature slices of the row and column points in
// shared memory and each thread keeps 16 fp32 accumulators: one column, 16
// rows.
// The Gram term is a plain FMA loop — no tensor cores and no TF32, because the
// host's error bound (the backend's slack) covers fp32 rounding only. In the
// epilogue lane j of a warp holds column j of a 32-column word, so
// __ballot_sync over the join predicate *is* the packed mask word (the TPU
// kernel needed an MXU matmul against powers of two for the same packing).
// Counts are __popc per word, a shared-memory sum per block and one integer
// atomicAdd per block: integer atomics give the same total in any order.
// Tiles wholly past a subset's length skip the Gram loop and only write their
// zero words.
//
// Bound on the card. The Gram term of a self-join needs 2d flops per distinct
// pair (it is symmetric: L(L+1)/2 pairs for L points, though this version
// computes both halves) and moves d*4 bytes per point read once plus 1/8 byte
// of mask per padded cell. K1 and K3 must round as fp32 FMA does, so their
// peak is fp32 outside the tensor cores (67 TFLOP/s on an H100 SXM): at the
// main path's d = 64 and subsets of hundreds to thousands of points they are
// bound by operations. K2 multiplies bf16 by bf16 into fp32 — the bf16
// tensor cores' contract (989 TFLOP/s dense) — so at those shapes it is bound
// by the bytes of its fp32 tile, and this FMA version of it runs far off that
// bound. This first version is further bound by shared-memory issue: every 16
// FMAs read five shared-memory words (four float4 row broadcasts and one
// column value). Register tiling over columns too, half the tiles by
// symmetry, and wgmma for the bf16 tier are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int TM = 32;                     // rows per block
constexpr int WPB = 4;                     // 32-column mask words per block
constexpr int TN = 32 * WPB;               // columns per block
constexpr int DK = 32;                     // features staged per pass
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RPW = TM * WPB / WARPS;      // rows per thread (one column each)

static_assert(RPW * (WARPS / WPB) == TM, "warps must tile the rows");
static_assert(RPW % 4 == 0, "rows are read as float4");

// Row points are stored transposed (feature-major, rows padded to 36 floats)
// so a thread reads its 16 rows of one feature as four float4 broadcasts;
// column points keep point-major rows of 33 floats, so a warp's 32 columns of
// one feature fall in 32 distinct banks.
struct alignas(16) Smem {
  float at[DK][TM + 4];
  float b[TN][DK + 1];
  float an[TM];
  float bn[TN];
  int count;
};

template <bool BF16>
__device__ __forceinline__ float load_coord(const float* p) {
  float v = __ldg(p);
  if (BF16) v = __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// acc[i] = <a[row0 + rbase + i], b[col0 + c]> for this thread's column c, and
// the squared norms of the tile's rows (sm.an) and columns (sm.bn). Rows at or
// past a_rows and columns at or past b_rows read as zero.
template <bool BF16>
__device__ void gram_tile(Smem& sm, const float* __restrict__ a, int a_rows,
                          int row0, const float* __restrict__ b, int b_rows,
                          int col0, int d, float (&acc)[RPW]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int c = (warp % WPB) * 32 + (tid & 31);
  const int rbase = (warp / WPB) * RPW;
  if (tid < TM) sm.an[tid] = 0.f;
  if (tid < TN) sm.bn[tid] = 0.f;
#pragma unroll
  for (int i = 0; i < RPW; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < d; k0 += DK) {
    for (int e = tid; e < TM * DK; e += THREADS) {
      const int r = e / DK, k = e % DK;
      const int gr = row0 + r, gk = k0 + k;
      sm.at[k][r] = (gr < a_rows && gk < d)
                       ? load_coord<BF16>(a + (size_t)gr * d + gk) : 0.f;
    }
    for (int e = tid; e < TN * DK; e += THREADS) {
      const int r = e / DK, k = e % DK;
      const int gr = col0 + r, gk = k0 + k;
      sm.b[r][k] = (gr < b_rows && gk < d)
                       ? load_coord<BF16>(b + (size_t)gr * d + gk) : 0.f;
    }
    __syncthreads();
    if (tid < TM) {
      float s = sm.an[tid];
#pragma unroll
      for (int k = 0; k < DK; ++k) s = fmaf(sm.at[k][tid], sm.at[k][tid], s);
      sm.an[tid] = s;
    } else if (tid < TM + TN) {
      const int j = tid - TM;
      float s = sm.bn[j];
#pragma unroll
      for (int k = 0; k < DK; ++k) s = fmaf(sm.b[j][k], sm.b[j][k], s);
      sm.bn[j] = s;
    }
#pragma unroll 8
    for (int k = 0; k < DK; ++k) {
      const float bv = sm.b[c][k];
      const float4* ap = reinterpret_cast<const float4*>(&sm.at[k][rbase]);
#pragma unroll
      for (int j = 0; j < RPW / 4; ++j) {
        const float4 av = ap[j];
        acc[4 * j + 0] = fmaf(av.x, bv, acc[4 * j + 0]);
        acc[4 * j + 1] = fmaf(av.y, bv, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(av.z, bv, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(av.w, bv, acc[4 * j + 3]);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ bool elig_bit(const int* __restrict__ words, int i) {
  return (static_cast<unsigned>(words[i >> 5]) >> (i & 31)) & 1u;
}

// K1 (MASK) and K2 (!MASK, BF16). Grid (S, ceil(P/TM), ceil(P/TN)).
template <bool BF16, bool MASK>
__global__ void __launch_bounds__(THREADS)
batched_join_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                    const float* __restrict__ radii, const int* __restrict__ elig,
                    int P, int d, int W, int* __restrict__ mask,
                    int* __restrict__ counts, float* __restrict__ sq_out) {
  __shared__ Smem sm;
  const int s = blockIdx.x;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.z * TN;
  const int L = min(max(lengths[s], 0), P);
  const float* xs = x + (size_t)s * P * d;
  const int* es = elig ? elig + (size_t)s * W : nullptr;
  float acc[RPW];
  if (threadIdx.x == 0) sm.count = 0;
  const bool live = row0 < L && col0 < L;     // block-uniform
  if (live) {
    gram_tile<BF16>(sm, xs, L, row0, xs, L, col0, d, acc);
  } else {
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc[i] = 0.f;
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wl = warp % WPB;
  const int rbase = (warp / WPB) * RPW;
  const int c = wl * 32 + lane;
  const int col = col0 + c;
  const int word = blockIdx.z * WPB + wl;
  const float r = radii[s];
  const float r2 = r * r;
  const bool col_ok = col < L && (es == nullptr || elig_bit(es, col));
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = row0 + rbase + i;
    const bool valid = row < L && col < L;
    float v = FLT_MAX;
    bool joined = false;
    if (valid) {
      v = fmaxf(sm.an[rbase + i] + sm.bn[c] - 2.0f * acc[i], 0.0f);
      joined = v <= r2 && col_ok && (es == nullptr || elig_bit(es, row));
    }
    const unsigned bits = __ballot_sync(0xffffffffu, joined);
    if (MASK) {
      if (sq_out != nullptr && row < P && col < P)
        sq_out[((size_t)s * P + row) * P + col] = v;
      if (lane == 0 && row < P && word < W)
        mask[((size_t)s * P + row) * W + word] = static_cast<int>(bits);
    }
    if (lane == 0) cnt += __popc(bits);
  }
  if (lane == 0 && cnt) atomicAdd(&sm.count, cnt);
  __syncthreads();
  if (threadIdx.x == 0 && sm.count) atomicAdd(counts + s, sm.count);
}

// K3. Grid (ceil(N/TN), ceil(M/TM)); counts[(by, bx)] is the block's join size.
__global__ void __launch_bounds__(THREADS)
pairwise_join_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     int M, int N, int d, float r, float* __restrict__ sq,
                     int* __restrict__ counts) {
  __shared__ Smem sm;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;
  float acc[RPW];
  if (threadIdx.x == 0) sm.count = 0;
  gram_tile<false>(sm, a, M, row0, b, N, col0, d, acc);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rbase = (warp / WPB) * RPW;
  const int c = (warp % WPB) * 32 + lane;
  const int col = col0 + c;
  const float r2 = r * r;
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = row0 + rbase + i;
    bool joined = false;
    if (row < M && col < N) {
      const float v = fmaxf(sm.an[rbase + i] + sm.bn[c] - 2.0f * acc[i], 0.0f);
      sq[(size_t)row * N + col] = v;
      joined = v <= r2;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, joined);
    if (lane == 0) cnt += __popc(bits);
  }
  if (lane == 0 && cnt) atomicAdd(&sm.count, cnt);
  __syncthreads();
  if (threadIdx.x == 0) counts[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = sm.count;
}

}  // namespace

// Plain C interface (bound with ctypes). Each returns cudaGetLastError() after
// its launch; 0 is success. Pointers are device pointers; elig and sq may be
// null. The caller zeroes counts for the two batched kernels.
extern "C" {

int join_batched_masked(const float* x, const int* lengths, const float* radii,
                        const int* elig, int S, int P, int d, int* mask,
                        int* counts, float* sq, void* stream) {
  const int W = (P + 31) / 32;
  const dim3 grid(S, (P + TM - 1) / TM, (P + TN - 1) / TN);
  batched_join_kernel<false, true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, lengths, radii, elig, P, d, W, mask, counts, sq);
  return static_cast<int>(cudaGetLastError());
}

int join_batched_prune(const float* x, const int* lengths, const float* radii,
                       int S, int P, int d, int* counts, void* stream) {
  const int W = (P + 31) / 32;
  const dim3 grid(S, (P + TM - 1) / TM, (P + TN - 1) / TN);
  batched_join_kernel<true, false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, lengths, radii, nullptr, P, d, W, nullptr, counts, nullptr);
  return static_cast<int>(cudaGetLastError());
}

int pairwise_join(const float* a, const float* b, int M, int N, int d, float r,
                  float* sq, int* counts, void* stream) {
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  pairwise_join_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, M, N, d, r, sq, counts);
  return static_cast<int>(cudaGetLastError());
}

int join_tile_rows() { return TM; }
int join_tile_cols() { return TN; }

}  // extern "C"
