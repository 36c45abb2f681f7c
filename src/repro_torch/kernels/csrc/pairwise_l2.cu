// Threshold-join kernels for Hopper (sm_90a): the batched fp32 self-join with
// a packed adjacency mask (K1), its bf16 coarse-count twin (K2), the single
// (M, d) x (N, d) join (K3), and the batched self-join with the dense block
// and per-tile counts (K4).
//
// Replaces the Pallas TPU kernels of the reference package's
// kernels/pairwise_l2.py:
//   join_batched_masked  <- pairwise_l2_join_batched_masked (+ the
//                           ops._fold_eligibility epilogue)
//   join_batched_prune   <- pairwise_l2_join_batched_prune (its dense 0/1
//                           eligibility row arrives as K1's packed words)
//   pairwise_join        <- pairwise_l2_join
//   join_batched_tiles   <- pairwise_l2_join_batched
//
// Contract (all four): sq = max(|a|^2 + |b|^2 - 2 a.b, 0) in fp32, a pair
// joins iff sq <= r*r (r squared in fp32). Mask and eligibility words are
// LSB-first: bit j % 32 of word j / 32 of row i is the pair (i, j). Counts
// include the diagonal.
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
//
// K4 is K1's body without the mask: it always writes the dense sq block and
// counts joined pairs per tile of the *caller's* (bm, bn) grid, which need
// not match the kernel's 32 x 128 block. A row's ballot word spans 32
// columns and may straddle a bn boundary, so it is split by shifts into the
// grid cells it touches; a block sums its cells in shared memory (at most
// 32 x 128 of them, for bm = bn = 1) and adds each nonzero cell to the
// output once. Per valid cell it needs 2d fp32 flops (1.9 ps at d = 64 and
// 67 TFLOP/s) against 4 written bytes (1.2 ps at 3.35 TB/s), so a block full
// of valid cells is bound by operations; at K1's path input most cells lie
// past the subsets' lengths and cost bytes only, and the S P^2 4-byte sq
// write bounds it. This version computes both halves of the symmetric block.

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

// The body K1, K2 and K4 share: the Gram tile of block (s, blockIdx.y,
// blockIdx.z) over a subset of L valid points, then for each of this
// thread's RPW rows epi(row, col, v, valid) with v = the cell's sq (FLT_MAX
// where row or col is at or past L). Tiles wholly past L skip the Gram loop.
template <bool BF16, class Epi>
__device__ __forceinline__ void self_join_rows(Smem& sm, const float* xs,
                                               int L, int d, Epi&& epi) {
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.z * TN;
  float acc[RPW];
  if (row0 < L && col0 < L) {                 // block-uniform
    gram_tile<BF16>(sm, xs, L, row0, xs, L, col0, d, acc);
  } else {
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc[i] = 0.f;
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5;
  const int rbase = (warp / WPB) * RPW;
  const int c = (warp % WPB) * 32 + (threadIdx.x & 31);
  const int col = col0 + c;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = row0 + rbase + i;
    const bool valid = row < L && col < L;
    const float v = valid
        ? fmaxf(sm.an[rbase + i] + sm.bn[c] - 2.0f * acc[i], 0.0f) : FLT_MAX;
    epi(row, col, v, valid);
  }
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
  const int L = min(max(lengths[s], 0), P);
  const int* es = elig ? elig + (size_t)s * W : nullptr;
  if (threadIdx.x == 0) sm.count = 0;
  const int lane = threadIdx.x & 31;
  const int word = blockIdx.z * WPB + (threadIdx.x >> 5) % WPB;
  const float r = radii[s];
  const float r2 = r * r;
  int cnt = 0;
  self_join_rows<BF16>(sm, x + (size_t)s * P * d, L, d,
                       [&](int row, int col, float v, bool valid) {
    const bool joined = valid && v <= r2
        && (es == nullptr || (elig_bit(es, col) && elig_bit(es, row)));
    const unsigned bits = __ballot_sync(0xffffffffu, joined);
    if (MASK) {
      if (sq_out != nullptr && row < P && col < P)
        sq_out[((size_t)s * P + row) * P + col] = v;
      if (lane == 0 && row < P && word < W)
        mask[((size_t)s * P + row) * W + word] = static_cast<int>(bits);
    }
    if (lane == 0) cnt += __popc(bits);
  });
  if (lane == 0 && cnt) atomicAdd(&sm.count, cnt);
  __syncthreads();
  if (threadIdx.x == 0 && sm.count) atomicAdd(counts + s, sm.count);
}

// K4: K1's body with per-tile counts of the caller's (bm, bn) grid in place
// of the mask. Grid (S, ceil(P/TM), ceil(P/TN)); counts (S, ceil(P/bm),
// ceil(P/bn)).
__global__ void __launch_bounds__(THREADS)
batched_tiles_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                     const float* __restrict__ radii, int P, int d, int bm,
                     int bn, float* __restrict__ sq_out,
                     int* __restrict__ counts) {
  __shared__ Smem sm;
  __shared__ int cells[TM * TN];
  const int s = blockIdx.x;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.z * TN;
  const int L = min(max(lengths[s], 0), P);
  const int gm = (P + bm - 1) / bm, gn = (P + bn - 1) / bn;
  // This block's cells: rows [cr0, cr1], columns [cc0, cc1] of the grid.
  const int cr0 = row0 / bm, cr1 = min(row0 + TM, P) - 1;
  const int cc0 = col0 / bn, cc1 = min(col0 + TN, P) - 1;
  const int ncc = cc1 / bn - cc0 + 1;
  const int ncells = (cr1 / bm - cr0 + 1) * ncc;
  for (int e = threadIdx.x; e < ncells; e += THREADS) cells[e] = 0;
  const int lane = threadIdx.x & 31;
  const int wc0 = col0 + ((threadIdx.x >> 5) % WPB) * 32;  // warp's 1st column
  const float r = radii[s];
  const float r2 = r * r;
  self_join_rows<false>(sm, x + (size_t)s * P * d, L, d,
                        [&](int row, int col, float v, bool valid) {
    if (row < P && col < P) sq_out[((size_t)s * P + row) * P + col] = v;
    const unsigned bits = __ballot_sync(0xffffffffu, valid && v <= r2);
    if (lane == 0 && bits) {
      const int base = (row / bm - cr0) * ncc;
      // Split the word at every bn boundary it crosses.
      for (int lo = wc0; lo < wc0 + 32;) {
        const int cell = lo / bn;
        const int hi = min((cell + 1) * bn, wc0 + 32);
        const int w = hi - lo;
        const unsigned part = (bits >> (lo - wc0))
            & (w == 32 ? 0xffffffffu : ((1u << w) - 1u));
        if (part) atomicAdd(&cells[base + cell - cc0], __popc(part));
        lo = hi;
      }
    }
  });
  __syncthreads();
  for (int e = threadIdx.x; e < ncells; e += THREADS) {
    const int v = cells[e];
    if (v) {
      const int gr = cr0 + e / ncc, gc = cc0 + e % ncc;
      atomicAdd(counts + ((size_t)s * gm + gr) * gn + gc, v);
    }
  }
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
// its launch; 0 is success. Pointers are device pointers; elig and (K1) sq
// may be null. The caller zeroes counts for the batched kernels.
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
                       const int* elig, int S, int P, int d, int* counts,
                       void* stream) {
  const int W = (P + 31) / 32;
  const dim3 grid(S, (P + TM - 1) / TM, (P + TN - 1) / TN);
  batched_join_kernel<true, false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, lengths, radii, elig, P, d, W, nullptr, counts, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The caller zeroes counts (S, ceil(P/bm), ceil(P/bn)); bm, bn >= 1.
int join_batched_tiles(const float* x, const int* lengths, const float* radii,
                       int S, int P, int d, int bm, int bn, float* sq,
                       int* counts, void* stream) {
  const dim3 grid(S, (P + TM - 1) / TM, (P + TN - 1) / TN);
  batched_tiles_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, lengths, radii, P, d, bm, bn, sq, counts);
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
