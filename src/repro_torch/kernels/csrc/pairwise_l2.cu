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
// include the diagonal. K2 takes the coordinates rounded to bf16 (round to
// nearest even); its norms and products are summed in fp32 (a product of
// two bf16 values is exact in fp32).
//
// The served self-joins, K1 and K2. A subset of L live points has a
// symmetric join, so only the 64 x 64 tiles (ti, tj) with ti <= tj of the
// live region are computed, 128 threads a tile, and an off-diagonal tile
// counts its joined cells twice.
//
// Design of K1. A persistent grid (five blocks an SM) walks the upper triangle of tiles of P of every subset and
// gives the tiles wholly past L a few instructions: they write the zeros of
// their mask words, so the mask needs no clearing pass, and the host reads
// no lengths back. Both tiles' points are staged point-major in shared
// memory, 64 features per pass, by 16-byte cp.async copies all in flight at
// once; each thread keeps an 8-row x 4-column register tile (32 fp32 accumulators) and
// per 4 features reads each of its rows and columns as one float4: 12
// shared loads per 128 FMAs. The Gram term is a plain FMA loop over the
// features in order — no tensor cores and no TF32, because the host's error
// bound (the backend's slack) covers fp32 rounding only. sq(i, j) and
// sq(j, i) are the same bits: fmaf's product commutes and so does
// |a|^2 + |b|^2, the norms being taken in the same order. So the mirrored
// half is exact: an off-diagonal tile writes its row words, then the
// transposed words (a 32 x 32 bit transpose by shuffles of its words in
// shared memory), and counts its joined cells twice. A warp holds 2 rows x
// 64 columns of a tile at a time; two ballots over its 4 column groups make
// the 32-column mask words (LSB-first) of both rows. A tile inside the live
// square with no eligibility words tests only the threshold. Counts are
// __popc per word and integer atomics per warp: the same total in any order.
//
// Design of K2 (no mask, so a dead tile costs only its index arithmetic).
// One warpgroup a tile: per 64-feature panel it converts 16-byte fp32 loads
// to bf16 in registers, summing each point's squared norm over the rounded
// values, and stores them in the 128-byte swizzled K-major layout
// (wgmma.cuh) — TMA cannot round fp32 to bf16, and a separate cast pass
// would cost a launch and two passes over x. Four
// wgmma.m64n64k16.f32.bf16.bf16 then sum the panel's products into 32 fp32
// accumulators a thread, while the next panel's or tile's loads are in
// flight. The epilogue reads the accumulator layout directly and sums the
// joined cells as integers, one atomic a warp. At d = 64 a tile is four
// wgmma, so the staging (loads, rounding, norms, stores) and the share of
// tiles each block gets are what take the time: a block takes runs of up to
// 4 consecutive tiles of a column, whose column points stay staged from
// tile to tile, the runs being shared out through a prefix table of the
// subsets' live runs (a batch of few subsets, often padded with empty
// ones) or interleaved subset by subset (many small subsets), and the grid
// holds twice the resident blocks, so that the block scheduler evens out
// the tail.
//
// K3 and K4 keep the first version's tile: one block of 256 threads (8 warps)
// owns a 32-row x 128-column tile, stages 32-feature slices of the row and
// column points in shared memory, and each thread keeps 16 fp32
// accumulators (one column, 16 rows). In the epilogue lane j of a warp holds
// column j of a 32-column word, so __ballot_sync over the join predicate is
// the packed word (the TPU kernel needed an MXU matmul against powers of two
// for the same packing).
//
// Bound on the card. The Gram term of a self-join needs 2d flops per distinct
// pair (L(L+1)/2 pairs for L points) and moves d*4 bytes per point read once
// plus 1/8 byte of mask per padded cell. K1 and K3 must round as fp32 FMA
// does, so their peak is fp32 outside the tensor cores (67 TFLOP/s on an
// H100 SXM): at the main path's d = 64 and subsets of hundreds to thousands
// of points they are bound by operations. K2 multiplies bf16 by bf16 into
// fp32 — the bf16 tensor cores' contract (989 TFLOP/s dense) — so at those
// shapes its least time is a microsecond or two, well under the latency of
// reading a tile's points from L2: what the kernel has to do is keep loads
// in flight (several warpgroups an SM, the next tile's loads issued before
// the wait for this tile's products).
//
// K4 is K3's tile over a batch of self-joins without the mask: it always
// writes the dense sq block and counts joined pairs per tile of the
// *caller's* (bm, bn) grid, which need not match the kernel's 32 x 128
// block. A row's ballot word spans 32 columns and may straddle a bn
// boundary, so it is split by shifts into the grid cells it touches; a block
// sums its cells in shared memory (at most 32 x 128 of them, for bm = bn = 1)
// and adds each nonzero cell to the output once. Per valid cell it needs 2d
// fp32 flops (1.9 ps at d = 64 and 67 TFLOP/s) against 4 written bytes (1.2
// ps at 3.35 TB/s), so a block full of valid cells is bound by operations;
// at K1's path input most cells lie past the subsets' lengths and cost bytes
// only, and the S P^2 4-byte sq write bounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

#include "wgmma.cuh"

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

// acc[i] = <a[row0 + rbase + i], b[col0 + c]> for this thread's column c, and
// the squared norms of the tile's rows (sm.an) and columns (sm.bn). Rows at or
// past a_rows and columns at or past b_rows read as zero.
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
                       ? __ldg(a + (size_t)gr * d + gk) : 0.f;
    }
    for (int e = tid; e < TN * DK; e += THREADS) {
      const int r = e / DK, k = e % DK;
      const int gr = col0 + r, gk = k0 + k;
      sm.b[r][k] = (gr < b_rows && gk < d)
                       ? __ldg(b + (size_t)gr * d + gk) : 0.f;
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

// K4's body: the Gram tile of block (s, blockIdx.y, blockIdx.z) over a
// subset of L valid points, then for each of this thread's RPW rows
// epi(row, col, v, valid) with v = the cell's sq (FLT_MAX where row or col
// is at or past L). Tiles wholly past L skip the Gram loop.
template <class Epi>
__device__ __forceinline__ void self_join_rows(Smem& sm, const float* xs,
                                               int L, int d, Epi&& epi) {
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.z * TN;
  float acc[RPW];
  if (row0 < L && col0 < L) {                 // block-uniform
    gram_tile(sm, xs, L, row0, xs, L, col0, d, acc);
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

// ---- K1: square tiles over the upper triangle ------------------------------

constexpr int ST = 64;                     // square tile (rows = columns)
constexpr int ST_THREADS = 128;
constexpr int ST_RG = 8;                   // row groups: thread rows rg + 8 i
constexpr int ST_CG = 16;                  // column groups: columns cg + 16 u
constexpr int ST_RT = ST / ST_RG;          // rows per thread
constexpr int ST_CT = ST / ST_CG;          // columns per thread
constexpr int ST_K = 64;                   // features staged per pass
constexpr int ST_LD = ST_K + 4;            // padded point rows (float4-aligned)
constexpr int ST_WORDS = ST / 32;          // mask words per tile row

static_assert(ST_RG * ST_CG == ST_THREADS, "threads tile the square");
static_assert(ST_CG == 16 && ST_CT == 4, "a warp is 2 row groups x 16 lanes");

struct alignas(16) TriSmem {
  float a[ST][ST_LD];                      // row points, point-major
  float b[ST][ST_LD];                      // column points
  float an[ST];                            // squared norms of the rows
  float bn[ST];                            // and of the columns
  unsigned words[ST][ST_WORDS + 1];        // the tile's row words (padded)
};

// Tile t of the upper triangle, enumerated column by column:
// (0,0), (0,1), (1,1), (0,2), ... Returns tj and sets ti <= tj.
__device__ __forceinline__ int triangle_tile(int t, int& ti) {
  auto first = [](long long j) { return j * (j + 1) / 2; };  // of column j
  int tj = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (first(tj + 1) <= t) ++tj;
  while (first(tj) > t) --tj;
  ti = static_cast<int>(t - first(tj));
  return tj;
}

// 16 bytes global -> shared without a register round trip; zeros when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Stages features [k0, k0 + ST_K) of points [p0, p0 + ST) into dst; points
// at or past L and features at or past d are zero. When every row is
// 16-byte aligned (d % 4 == 0 and an aligned base) the copies are cp.async
// of 16 bytes, all in flight at once, and the caller waits for them
// (stage_wait); else scalar loads.
__device__ __forceinline__ void stage_points(float (*dst)[ST_LD],
                                             const float* __restrict__ xs,
                                             int p0, int L, int d, int k0,
                                             bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < ST * ST_K / 4; e += ST_THREADS) {
      const int r = e / (ST_K / 4), k = (e % (ST_K / 4)) * 4;
      const bool ok = p0 + r < L && k0 + k < d;
      cp_async16(&dst[r][k], ok ? xs + (size_t)(p0 + r) * d + k0 + k : xs,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < ST * ST_K; e += ST_THREADS) {
      const int r = e / ST_K, k = e % ST_K;
      dst[r][k] = (p0 + r < L && k0 + k < d)
          ? __ldg(xs + (size_t)(p0 + r) * d + k0 + k) : 0.f;
    }
  }
}

// Transposes the 32 x 32 bit matrix whose row b is lane b's word (bit c =
// column c): afterwards lane j holds column j. Five rounds each swap the
// off-diagonal blocks of size 16, 8, 4, 2, 1 with the partner lane.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  const unsigned hi[5] = {0xffff0000u, 0xff00ff00u, 0xf0f0f0f0u, 0xccccccccu,
                          0xaaaaaaaau};     // columns c with (c & j) != 0
#pragma unroll
  for (int st = 0; st < 5; ++st) {
    const int j = 16 >> st;
    const unsigned t = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? (x & hi[st]) | ((t >> j) & ~hi[st])
                   : (x & ~hi[st]) | ((t << j) & hi[st]);
  }
  return x;
}

// One live tile (ti <= tj, tj * ST < L) of subset s of K1. Thread (rg, cg) holds rows rg + 8 i and columns cg + 16 u
// of the tile, so a warp's two row groups read two rows one apart (distinct
// banks) and its 16 column groups 16 consecutive points.
__device__ __forceinline__ void join_tile(
    TriSmem& sm, const float* __restrict__ x, const float* __restrict__ radii,
    const int* __restrict__ elig, int s, int ti, int tj, int L, int P, int d,
    int W, int* __restrict__ mask, int* __restrict__ counts,
    float* __restrict__ sq_out) {
  const int row0 = ti * ST, col0 = tj * ST;
  const bool diag = ti == tj;
  const float* xs = x + (size_t)s * P * d;
  const bool vec = (d % 4 == 0)
                   && (reinterpret_cast<uintptr_t>(x) % 16 == 0);

  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = tid / ST_CG, cg = tid % ST_CG;
  float acc[ST_RT][ST_CT];
#pragma unroll
  for (int i = 0; i < ST_RT; ++i)
#pragma unroll
    for (int u = 0; u < ST_CT; ++u) acc[i][u] = 0.f;
  float norm = 0.f;                          // of row tid or column tid - ST

  for (int k0 = 0; k0 < d; k0 += ST_K) {
    stage_points(sm.a, xs, row0, L, d, k0, vec);
    stage_points(sm.b, xs, col0, L, d, k0, vec);
    if (vec) cp_async_wait_all();
    __syncthreads();
    // Norms over the features in order, as the Gram terms below sum them.
    const float* np = tid < ST ? sm.a[tid] : sm.b[tid - ST];
#pragma unroll 4
    for (int k = 0; k < ST_K; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(np + k);
      norm = fmaf(v.x, v.x, norm);
      norm = fmaf(v.y, v.y, norm);
      norm = fmaf(v.z, v.z, norm);
      norm = fmaf(v.w, v.w, norm);
    }
#pragma unroll 1
    for (int k = 0; k < ST_K; k += 4) {
      float4 av[ST_RT], bv[ST_CT];
#pragma unroll
      for (int i = 0; i < ST_RT; ++i)
        av[i] = *reinterpret_cast<const float4*>(&sm.a[rg + ST_RG * i][k]);
#pragma unroll
      for (int u = 0; u < ST_CT; ++u)
        bv[u] = *reinterpret_cast<const float4*>(&sm.b[cg + ST_CG * u][k]);
#pragma unroll
      for (int i = 0; i < ST_RT; ++i)
#pragma unroll
        for (int u = 0; u < ST_CT; ++u) {
          acc[i][u] = fmaf(av[i].x, bv[u].x, acc[i][u]);
          acc[i][u] = fmaf(av[i].y, bv[u].y, acc[i][u]);
          acc[i][u] = fmaf(av[i].z, bv[u].z, acc[i][u]);
          acc[i][u] = fmaf(av[i].w, bv[u].w, acc[i][u]);
        }
    }
    __syncthreads();
  }
  if (tid < ST) sm.an[tid] = norm;
  else sm.bn[tid - ST] = norm;
  __syncthreads();

  const float r = radii[s];
  const float r2 = r * r;
  const int* es = elig ? elig + (size_t)s * W : nullptr;
  // A tile inside the live square without eligibility words needs no
  // predicate but the threshold (rows start at or before its columns).
  const bool interior = es == nullptr && col0 + ST <= L;
  float an[ST_RT], bn[ST_CT];
  bool ecol[ST_CT];
#pragma unroll
  for (int u = 0; u < ST_CT; ++u) {
    const int col = col0 + cg + ST_CG * u;
    bn[u] = sm.bn[cg + ST_CG * u];
    ecol[u] = interior
              || (col < L && (es == nullptr || elig_bit(es, col)));
  }
#pragma unroll
  for (int i = 0; i < ST_RT; ++i) an[i] = sm.an[rg + ST_RG * i];
  // Lanes 0-15 hold row rg = 2 warp, lanes 16-31 the next row group;
  // ballot(u) packs columns cg + 16 u of both rows, so two ballots make one
  // 32-column word of each row. Lane 4 i + 2 h + c keeps word c of row
  // 2 warp + h + 8 i.
  const int warp = tid >> 5;
  unsigned word = 0;
  int wtr = 0, wc = 0;
#pragma unroll
  for (int i = 0; i < ST_RT; ++i) {
    const int row = row0 + rg + ST_RG * i;
    const bool erow = interior
                      || (row < L && (es == nullptr || elig_bit(es, row)));
    unsigned bal[ST_CT];
#pragma unroll
    for (int u = 0; u < ST_CT; ++u) {
      // explicit roundings: the mirrored cell computes the same bits; the
      // clamp at 0 does not change the comparison with r^2 >= 0
      const float e = __fmaf_rn(-2.0f, acc[i][u], __fadd_rn(an[i], bn[u]));
      bal[u] = __ballot_sync(0xffffffffu, erow && ecol[u] && e <= r2);
      const int col = col0 + cg + ST_CG * u;
      if (sq_out != nullptr && row < P && col < P) {
        const float v = row < L && col < L ? fmaxf(e, 0.0f) : FLT_MAX;
        sq_out[((size_t)s * P + row) * P + col] = v;
        if (!diag) sq_out[((size_t)s * P + col) * P + row] = v;
      }
    }
    const int k = lane - 4 * i;
    if (k >= 0 && k < 4) {
      const int h = k >> 1, c = k & 1;
      const unsigned lo = c ? bal[2] : bal[0], hi = c ? bal[3] : bal[1];
      word = h ? (lo >> 16) | (hi & 0xffff0000u) : (lo & 0xffffu) | (hi << 16);
      wtr = 2 * warp + h + ST_RG * i;
      wc = c;
    }
  }
  int cnt = __popc(word) * (diag ? 1 : 2);   // and the mirrored half
  cnt += __shfl_xor_sync(0xffffffffu, cnt, 16);
  cnt += __shfl_xor_sync(0xffffffffu, cnt, 8);
  cnt += __shfl_xor_sync(0xffffffffu, cnt, 4);
  cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
  cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
  if (lane == 0 && cnt) atomicAdd(counts + s, cnt);
  const int wrow = row0 + wtr, wi = (col0 >> 5) + wc;
  if (wrow < P && wi < W)
    mask[((size_t)s * P + wrow) * W + wi] = static_cast<int>(word);
  if (!diag) {
    // The mirrored words: warp w transposes the 32 x 32 bit block of tile
    // rows 32 q.. and columns 32 c.. (lane b holds row 32 q + b; after
    // the transpose lane j holds column 32 c + j).
    sm.words[wtr][wc] = word;
    __syncthreads();
    const int c = warp >> 1, q = warp & 1;
    const unsigned out = transpose32(sm.words[32 * q + lane][c], lane);
    const int col = col0 + 32 * c + lane, twi = (row0 >> 5) + q;
    if (col < P && twi < W)
      mask[((size_t)s * P + col) * W + twi] = static_cast<int>(out);
  }
}

constexpr int ST_BLOCKS_PER_SM = 5;   // 96 registers a thread

// The mask words of tile (ti, tj) and of its mirror, for a tile wholly past
// the subset's length: zero. With the live tiles' words they cover the mask.
__device__ __forceinline__ void zero_tile_words(int* __restrict__ mask, int s,
                                                int ti, int tj, int P, int W) {
  const int r = threadIdx.x / ST_WORDS, c = threadIdx.x % ST_WORDS;
  static_assert(ST * ST_WORDS == ST_THREADS, "one word a thread");
  int row = ti * ST + r, wi = tj * ST_WORDS + c;
  if (row < P && wi < W) mask[((size_t)s * P + row) * W + wi] = 0;
  if (ti == tj) return;
  row = tj * ST + r;
  wi = ti * ST_WORDS + c;
  if (row < P && wi < W) mask[((size_t)s * P + row) * W + wi] = 0;
}

// K1: a persistent grid whose blocks walk the
// T(T+1)/2 triangle tiles of each of the S subsets (T = ceil(P/ST) tiles a
// side; index u = s T(T+1)/2 + t) and compute the live ones: a tile wholly
// past the subset's length costs a few instructions, not a block, and
// writes only its zero mask words. The caller zeroes counts and fills sq
// with FLT_MAX.
__global__ void __launch_bounds__(ST_THREADS, ST_BLOCKS_PER_SM)
triangle_join_kernel(const float* __restrict__ x,
                     const int* __restrict__ lengths,
                     const float* __restrict__ radii,
                     const int* __restrict__ elig, int S, int P, int d,
                     int W, int* __restrict__ mask, int* __restrict__ counts,
                     float* __restrict__ sq_out) {
  __shared__ TriSmem sm;
  const long long nt = (P + ST - 1) / ST, ntri = nt * (nt + 1) / 2;
  for (long long u = blockIdx.x; u < ntri * S; u += gridDim.x) {
    const int s = static_cast<int>(u / ntri);
    const int L = min(max(lengths[s], 0), P);
    int ti;
    const int tj = triangle_tile(static_cast<int>(u % ntri), ti);
    if (tj * ST >= L) {                      // block-uniform: a dead tile
      zero_tile_words(mask, s, ti, tj, P, W);
      continue;
    }
    join_tile(sm, x, radii, elig, s, ti, tj, L, P, d, W, mask, counts,
              sq_out);
  }
}

// ---- K2: bf16 coarse counts on the tensor cores ----------------------------

constexpr int PR_THREADS = 128;            // one warpgroup: one wgmma tile
constexpr int PR_K = 64;                   // features a panel: one 128-byte
                                           // bf16 row a point
constexpr int PR_LANES = 8;                // lanes a row: a 16-byte bf16 chunk
                                           // (8 features) each
constexpr int PR_PASSES = ST * PR_LANES / PR_THREADS;   // rows a thread
constexpr int PR_STEP = PR_THREADS / PR_LANES;          // rows a pass
constexpr int PR_PANEL = ST * PR_K * 2;    // bytes of one bf16 panel
// slack, panels A and B, their norms, the walk's prefix table (scan_runs)
constexpr int PR_SMEM = 1024 + 2 * PR_PANEL + 2 * ST * 4
                        + (3 * PR_THREADS + 8) * 4;
constexpr int PR_MIN_BLOCKS = 3;           // 164 registers a thread
constexpr int PR_RUN = 4;                  // triangle tiles a unit of work
constexpr int PR_SCAN_MAX = PR_THREADS;    // subsets a walk table holds

static_assert(PR_PANEL % 1024 == 0, "panels keep the swizzle's alignment");

// One panel's fp32 coordinates in flight to this thread: pass p holds
// features k0 + 8 c .. k0 + 8 c + 7 (c = tid % 8) of row tid / 8 + 16 p, as
// two 16-byte loads.
struct PanelRegs {
  float4 v[PR_PASSES][2];
};

// Issues the loads of features [k0, k0 + PR_K) of points [p0, p0 + ST).
// Points at or past L and features at or past d read as zero. With vec (d a
// multiple of 4 and a 16-byte aligned base) the loads are 16 bytes wide.
__device__ __forceinline__ void load_panel(PanelRegs& R,
                                           const float* __restrict__ xs,
                                           int p0, int L, int d, int k0,
                                           bool vec) {
  const int f = k0 + 8 * (threadIdx.x % PR_LANES);
#pragma unroll
  for (int p = 0; p < PR_PASSES; ++p) {
    const int row = p0 + threadIdx.x / PR_LANES + PR_STEP * p;
    const float* src = xs + (size_t)row * d + f;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (row < L) {
      if (vec) {
        if (f < d) lo = __ldg(reinterpret_cast<const float4*>(src));
        if (f + 4 < d) hi = __ldg(reinterpret_cast<const float4*>(src + 4));
      } else {
        float t[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) t[e] = f + e < d ? __ldg(src + e) : 0.f;
        lo = make_float4(t[0], t[1], t[2], t[3]);
        hi = make_float4(t[4], t[5], t[6], t[7]);
      }
    }
    R.v[p][0] = lo;
    R.v[p][1] = hi;
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float a, float b,
                                              float& norm) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(v);
  norm = fmaf(f.x, f.x, norm);
  norm = fmaf(f.y, f.y, norm);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rounds the staged coordinates to bf16 (round to nearest even) into the
// panel at `panel` in the 128-byte swizzled K-major layout wgmma reads, and
// adds each row's squared norm over this panel's rounded values to
// norm[p]: each chunk's features in order, then the row's 8 chunks by a
// butterfly over the 8 lanes that hold them (every lane gets the same bits).
__device__ __forceinline__ void store_panel(unsigned char* panel,
                                            const PanelRegs& R,
                                            float (&norm)[PR_PASSES],
                                            bool first) {
  const int c = threadIdx.x % PR_LANES;
#pragma unroll
  for (int p = 0; p < PR_PASSES; ++p) {
    const int row = threadIdx.x / PR_LANES + PR_STEP * p;
    const float4 lo = R.v[p][0], hi = R.v[p][1];
    float s = 0.f;
    uint4 w;
    w.x = bf16_pair(lo.x, lo.y, s);
    w.y = bf16_pair(lo.z, lo.w, s);
    w.z = bf16_pair(hi.x, hi.y, s);
    w.w = bf16_pair(hi.z, hi.w, s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    norm[p] = first ? s : norm[p] + s;
    *reinterpret_cast<uint4*>(panel + row * 128 + ((c ^ (row & 7)) << 4)) = w;
  }
}

// The live points of tile rows (or columns) [p0, p0 + ST) as bits: index <
// L (p0 < L) and, with eligibility words, eligible.
__device__ __forceinline__ unsigned long long live_bits(
    const int* __restrict__ es, int p0, int L, int W) {
  const int n = L - p0;
  unsigned long long m = n >= 64 ? ~0ull : (1ull << n) - 1;
  if (es != nullptr) {
    const int w = p0 >> 5;
    unsigned long long e = static_cast<unsigned>(es[w]);
    if (w + 1 < W) e |= static_cast<unsigned long long>(
                            static_cast<unsigned>(es[w + 1])) << 32;
    m &= e;
  }
  return m;
}

// A block's place in the walk: unit i (run c of subset s: its `run`
// consecutive tiles of the subset's column-by-column enumeration), tile t of
// the subset and the run's end, (ti, tj) and the subset's length. The live
// tiles of a subset are the first T(T+1)/2 of its enumeration (T =
// ceil(L / ST)). A block takes units i = blockIdx.x, + gridDim.x, ...
struct PruneTile {
  int i, s, t, end, ti, tj, L;
};

// The walk's table for S <= PR_SCAN_MAX subsets, in shared memory: pre[s]
// live runs before subset s (pre[S] in all), each subset's live tiles and
// length. With it unit i is the i-th live run, so that the live runs are
// shared out evenly whatever the lengths (a batch padded with empty subsets
// included).
struct RunTable {
  int* pre;
  int* live;
  int* len;
};

// Block-wide inclusive sum of x over threads (wsum: a word a warp).
__device__ __forceinline__ int block_scan(int x, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) x += wsum[w];
  __syncthreads();                                   // wsum may be reused
  return x;
}

// Fills the table and returns the run length: PR_RUN tiles, whose column
// panels stay staged, or single tiles where the batch has fewer live tiles
// than the grid has blocks (runs would then leave blocks idle while others
// work through several tiles each).
__device__ __forceinline__ int scan_runs(const int* __restrict__ lengths,
                                         int S, int P, RunTable tab) {
  const int tid = threadIdx.x;
  int* wsum = tab.len + PR_THREADS;
  const int L = tid < S ? min(max(lengths[tid], 0), P) : 0;
  const int T = (L + ST - 1) / ST, live = T * (T + 1) / 2;
  const int tiles = block_scan(live, wsum);
  if (tid == PR_THREADS - 1) wsum[4] = tiles;        // the batch's live tiles
  __syncthreads();
  const int run = wsum[4] >= static_cast<int>(gridDim.x) ? PR_RUN : 1;
  const int x = block_scan((live + run - 1) / run, wsum);
  if (tid == 0) tab.pre[0] = 0;
  if (tid < S) {
    tab.pre[tid + 1] = x;
    tab.live[tid] = live;
    tab.len[tid] = L;
  }
  __syncthreads();
  return run;
}

// The block's first live unit at or after index i (stepping by the grid):
// from the table where there is one, else from the interleaved order i =
// c S + s over all runs (batches of many subsets have few runs each).
__device__ __forceinline__ bool next_unit(int i,
                                          const int* __restrict__ lengths,
                                          int S, int P, int runs, int run,
                                          const RunTable& tab, PruneTile& t) {
  for (;; i += gridDim.x) {
    int s, c, L, live;
    if (S <= PR_SCAN_MAX) {
      if (i >= tab.pre[S]) return false;
      int lo = 0, hi = S - 1;           // the s with pre[s] <= i < pre[s + 1]
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (tab.pre[mid] <= i) lo = mid;
        else hi = mid - 1;
      }
      s = lo;
      c = i - tab.pre[s];
      L = tab.len[s];
      live = tab.live[s];
    } else {
      if (i >= runs * S) return false;
      s = i % S;
      c = i / S;
      L = min(max(lengths[s], 0), P);
      const int T = (L + ST - 1) / ST;
      live = T * (T + 1) / 2;
      if (c * run >= live) continue;
    }
    t.i = i;
    t.s = s;
    t.t = c * run;
    t.end = min(t.t + run, live);
    t.tj = triangle_tile(t.t, t.ti);
    t.L = L;
    return true;
  }
}

// K2: the bf16 coarse counts of the prune tier. A persistent grid of single
// warpgroups walks the upper triangle of 64 x 64 tiles, runs of consecutive
// tiles of a column-by-column enumeration a unit, so that consecutive tiles
// mostly share their column points: with one feature panel (d <= 64) these
// stay staged from one tile to the next. Per live tile and 64-feature
// panel the block stages the row (and where needed the column) points as
// bf16 in shared memory (a diagonal tile stages its points twice, so the
// descriptors stay fixed), runs four wgmma.m64n64k16.f32.bf16.bf16, and
// issues the next panel's or tile's global loads before it waits for them.
// The epilogue works from the accumulator layout: thread t of warp w holds
// rows 16 w + t / 4 and + 8, columns 8 j + 2 (t % 4) and + 1. The caller
// zeroes counts.
__global__ void __launch_bounds__(PR_THREADS, PR_MIN_BLOCKS)
prune_join_kernel(const float* __restrict__ x,
                  const int* __restrict__ lengths,
                  const float* __restrict__ radii,
                  const int* __restrict__ elig, int S, int P, int d, int W,
                  int* __restrict__ counts) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sa = (raw + 1023u) & ~1023u;          // swizzle alignment
  unsigned char* pa = smem_raw + (sa - raw);
  unsigned char* pb = pa + PR_PANEL;
  float* an = reinterpret_cast<float*>(pb + PR_PANEL);  // row norms
  float* bn = an + ST;                                  // column norms
  int* table = reinterpret_cast<int*>(bn + ST);
  const RunTable tab{table, table + PR_THREADS + 1,
                     table + 2 * PR_THREADS + 1};

  const int nt = (P + ST - 1) / ST;
  const int runs = (nt * (nt + 1) / 2 + PR_RUN - 1) / PR_RUN;
  const int panels = (d + PR_K - 1) / PR_K;
  const bool vec = (d % 4 == 0)
                   && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int run = S <= PR_SCAN_MAX ? scan_runs(lengths, S, P, tab) : PR_RUN;
  PruneTile cur;
  if (!next_unit(blockIdx.x, lengths, S, P, runs, run, tab, cur)) return;
  int k = 0;                                   // the panel of cur
  bool staged = false;                 // cur's column panel is in place
  PanelRegs ra, rb;
  load_panel(ra, x + (size_t)cur.s * P * d, cur.ti * ST, cur.L, d, 0, vec);
  if (cur.ti != cur.tj)
    load_panel(rb, x + (size_t)cur.s * P * d, cur.tj * ST, cur.L, d, 0, vec);
  float na[PR_PASSES], nb[PR_PASSES];
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (;;) {
    const bool diag = cur.ti == cur.tj, last = k + 1 == panels;
    __syncthreads();             // the previous panel's readers are done
    store_panel(pa, ra, na, k == 0);
    if (!staged) {
      if (diag) store_panel(pb, ra, nb, k == 0);
      else store_panel(pb, rb, nb, k == 0);
    }
    if (last && tid % PR_LANES == 0) {
#pragma unroll
      for (int p = 0; p < PR_PASSES; ++p) {
        an[tid / PR_LANES + PR_STEP * p] = na[p];
        if (!staged) bn[tid / PR_LANES + PR_STEP * p] = nb[p];
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PR_K / 16; ++kk)
      wgmma_ss_n64(acc, desc_k_major(sa + kk * 32),
                   desc_k_major(sa + PR_PANEL + kk * 32), k > 0 || kk > 0);
    wgmma_commit();

    // The epilogue's radius and live points, then the next panel's or tile's
    // loads: all in flight while the tensor cores run.
    const int* es = elig ? elig + (size_t)cur.s * W : nullptr;
    const bool interior = es == nullptr && (cur.tj + 1) * ST <= cur.L;
    float r2 = 0.f;
    unsigned long long rl = 0, cl = 0;
    if (last) {
      const float r = radii[cur.s];
      r2 = r * r;
      if (!interior) {
        rl = live_bits(es, cur.ti * ST, cur.L, W);
        cl = live_bits(es, cur.tj * ST, cur.L, W);
      }
    }
    PruneTile nxt = cur;
    int nk = k + 1;
    bool more = true, nstaged = false;
    if (last) {
      nk = 0;
      if (cur.t + 1 < cur.end) {               // the unit's next tile
        ++nxt.t;
        if (++nxt.ti > nxt.tj) {
          nxt.ti = 0;
          ++nxt.tj;
        }
        nstaged = panels == 1 && nxt.tj == cur.tj;
      } else {
        more = next_unit(cur.i + gridDim.x, lengths, S, P, runs, run, tab,
                         nxt);
      }
    }
    if (more) {
      const float* xs = x + (size_t)nxt.s * P * d;
      load_panel(ra, xs, nxt.ti * ST, nxt.L, d, nk * PR_K, vec);
      if (!nstaged && nxt.ti != nxt.tj)
        load_panel(rb, xs, nxt.tj * ST, nxt.L, d, nk * PR_K, vec);
    }
    wgmma_wait_all();
    fence_regs(acc);

    if (last) {
      const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
      const float a0 = an[r0], a1 = an[r0 + 8];
      // explicit roundings, as K1: e = (|a|^2 + |b|^2) - 2 a.b
      auto joined = [&](float a, float b, float g) {
        return __fmaf_rn(-2.0f, g, __fadd_rn(a, b)) <= r2;
      };
      int cnt = 0;
      if (interior) {                          // the threshold alone
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(bn + 8 * j + c0);
          cnt += joined(a0, b.x, acc[4 * j]) + joined(a0, b.y, acc[4 * j + 1])
                 + joined(a1, b.x, acc[4 * j + 2])
                 + joined(a1, b.y, acc[4 * j + 3]);
        }
      } else {
        const bool l0 = (rl >> r0) & 1, l1 = (rl >> (r0 + 8)) & 1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + c0;
          const bool e0 = (cl >> c) & 1, e1 = (cl >> (c + 1)) & 1;
          const float2 b = *reinterpret_cast<const float2*>(bn + c);
          cnt += (l0 && e0 && joined(a0, b.x, acc[4 * j]))
                 + (l0 && e1 && joined(a0, b.y, acc[4 * j + 1]))
                 + (l1 && e0 && joined(a1, b.x, acc[4 * j + 2]))
                 + (l1 && e1 && joined(a1, b.y, acc[4 * j + 3]));
        }
      }
      cnt *= diag ? 1 : 2;                     // and the mirrored half
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 16);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 8);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 4);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
      if (lane == 0 && cnt) atomicAdd(counts + cur.s, cnt);
    }
    if (!more) break;
    cur = nxt;
    k = nk;
    staged = nstaged;
  }
}

// K4: the dense sq block and per-tile counts of the caller's (bm, bn) grid.
// Grid (S, ceil(P/TM), ceil(P/TN)); counts (S, ceil(P/bm), ceil(P/bn)).
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
  self_join_rows(sm, x + (size_t)s * P * d, L, d,
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
  gram_tile(sm, a, M, row0, b, N, col0, d, acc);

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

// Blocks of a K1 launch: as many as the card holds at once, or one per
// triangle tile of all subsets if there are fewer.
int triangle_blocks(int S, int P) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long nt = (P + ST - 1) / ST;
  const long long tiles = nt * (nt + 1) / 2 * S;
  const long long resident = static_cast<long long>(sms) * ST_BLOCKS_PER_SM;
  return static_cast<int>(tiles < resident ? tiles : resident);
}

// Blocks of a K2 launch: twice as many as the card holds at once (by the
// occupancy of its registers and shared memory), so that the hardware's
// block scheduler evens out the tail of a walk whose live tiles are uneven
// across blocks; or one per unit of work if there are fewer.
int prune_blocks(int S, int P) {
  static int per_sm = 0;               // a property of the kernel: asked once
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prune_join_kernel,
                                                  PR_THREADS, PR_SMEM);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long nt = (P + ST - 1) / ST;
  const long long units = (nt * (nt + 1) / 2 + PR_RUN - 1) / PR_RUN * S;
  const long long blocks =
      2 * static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(units < blocks ? units : blocks);
}

}  // namespace

// Plain C interface (bound with ctypes). Each returns cudaGetLastError() after
// its launch; 0 is success. Pointers are device pointers; elig and (K1) sq
// may be null. The caller zeroes counts for the batched kernels, and for K1
// fills sq with FLT_MAX.
extern "C" {

int join_batched_masked(const float* x, const int* lengths, const float* radii,
                        const int* elig, int S, int P, int d, int* mask,
                        int* counts, float* sq, void* stream) {
  triangle_join_kernel
      <<<triangle_blocks(S, P), ST_THREADS, 0, (cudaStream_t)stream>>>(
          x, lengths, radii, elig, S, P, d, (P + 31) / 32, mask, counts, sq);
  return static_cast<int>(cudaGetLastError());
}

int join_batched_prune(const float* x, const int* lengths, const float* radii,
                       const int* elig, int S, int P, int d, int* counts,
                       void* stream) {
  prune_join_kernel
      <<<prune_blocks(S, P), PR_THREADS, PR_SMEM, (cudaStream_t)stream>>>(
          x, lengths, radii, elig, S, P, d, (P + 31) / 32, counts);
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
int join_square_tile() { return ST; }

}  // extern "C"
