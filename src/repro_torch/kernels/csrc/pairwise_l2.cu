// Threshold-join kernels for Hopper (sm_90a): the batched fp32 self-join with
// a packed adjacency mask (K1), its bf16 and int8 coarse-count twins (K2,
// K2i), the single (M, d) x (N, d) join (K3), and the batched self-join with
// the dense block and per-tile counts (K4).
//
// Replaces the Pallas TPU kernels of the reference package's
// kernels/pairwise_l2.py:
//   join_batched_masked  <- pairwise_l2_join_batched_masked (+ the
//                           ops._fold_eligibility epilogue)
//   join_batched_prune   <- pairwise_l2_join_batched_prune (its dense 0/1
//                           eligibility row arrives as K1's packed words)
//   join_batched_prune_int8 <- ops._xla_join_batched_counts(dtype="int8")
//                           (XLA code in the reference, no pallas_call)
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
// K3 and K4 share one engine of 128 x 128 output tiles (rt_run). A
// persistent grid of 128-thread blocks, two an SM, walks the tiles; each
// thread keeps a 16 x 8 register tile (rows rg + 8 i, columns cg + 16 u)
// and per 4 features reads its 16 rows and 8 columns as float4: 24 shared
// loads a 512 FMAs (an 8 x 8 tile's 16 a 256 spill at two blocks an SM
// and ran K3 10% slower on an H100 80GB HBM3 at 700 W, by
// tools/join_breakdown.py). Points are staged point-major by 16-byte cp.async (K1's
// stage_points), 32 features a stage, double-buffered, so the next stage's
// or the next tile's copies fly during the FMAs and the epilogue; the
// squared norms are summed from the staged points. The Gram term is a plain
// fp32 FMA chain in feature order (no TF32, no tensor cores: the backend's
// slack covers fp32 rounding only). The epilogue writes the clamped sq
// through shared memory, 64 rows at a time, so that a warp stores each
// output row whole with 16-byte streaming stores (st.global.cs: the block
// exceeds L2 and is never read back; single floats only where N is not a
// multiple of 4). Counts land on the caller's (bm, bn) grid: where a pass
// (a tile or its transpose) lies in one grid cell, as on the default 128 x
// 128 grid, each lane sums its cells' predicates and a warp adds its total
// once; else four ballots a row give the joined bits of its 4-column
// float4 lanes, split at every bn boundary (a lane a grid cell), summed per
// lane while the cell stays the same, then in shared memory, then one
// atomic per nonzero cell.
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
// K3 is bound by operations (2d flops per cell, 1.9 ps at d = 64 and 67
// TFLOP/s, against 4 written bytes, 1.2 ps at 3.35 TB/s). K4 is the engine
// over a batch of self-joins, always writing the dense sq block: it walks
// the upper triangle of each subset's live tiles (through a table of live
// tiles a subset for batches of up to 128), and an off-diagonal tile also
// writes its transpose, staged transposed so that its rows go out whole
// too: sq(i, j) and sq(j, i) are the same bits, as in K1. The mirrored
// half counts in its own orientation (cell (j / bm, i / bn)), which is not
// the direct half's transpose when bm != bn. Cells outside the live square
// (empty subsets, padded rows and columns) take FLT_MAX from the same
// launch, by each warp's share of rows in 16-byte streaming stores spread
// between its block's tiles, with no Gram term and no shared memory. At
// K1's path input most cells are dead, and the S P^2 4-byte write bounds
// it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cstddef>
#include <cstdint>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

__device__ __forceinline__ bool elig_bit(const int* __restrict__ words, int i) {
  return (static_cast<unsigned>(words[i >> 5]) >> (i & 31)) & 1u;
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

// Stages features [k0, k0 + KC) of points [p0, p0 + ROWS) into dst (rows of
// LD floats), NT threads together; points at or past L and features at or
// past d are zero. When every row is 16-byte aligned (d % 4 == 0 and an
// aligned base) the copies are cp.async of 16 bytes, all in flight at once,
// and the caller waits for them; else scalar loads. K1 takes the defaults.
template <int ROWS = ST, int KC = ST_K, int NT = ST_THREADS, int LD>
__device__ __forceinline__ void stage_points(float (*dst)[LD],
                                             const float* __restrict__ xs,
                                             int p0, int L, int d, int k0,
                                             bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < ROWS * KC / 4; e += NT) {
      const int r = e / (KC / 4), k = (e % (KC / 4)) * 4;
      const bool ok = p0 + r < L && k0 + k < d;
      cp_async16(&dst[r][k], ok ? xs + (size_t)(p0 + r) * d + k0 + k : xs,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * KC; e += NT) {
      const int r = e / KC, k = e % KC;
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
constexpr int PR_MIN_BLOCKS = 3;           // 164 registers a thread
constexpr int PR_RUN = 4;                  // triangle tiles a unit of work

static_assert(PR_PANEL % 1024 == 0, "panels keep the swizzle's alignment");

// Ints of a RunTable for a block of NT threads: pre (NT + 1), live, len
// (NT each), a sum a warp and the total.
__host__ __device__ constexpr int run_table_ints(int nt) {
  return 3 * nt + 1 + nt / 32 + 1;
}

// slack, panels A and B, their norms, the walk's prefix table (scan_runs)
constexpr int PR_SMEM = 1024 + 2 * PR_PANEL + 2 * ST * 4
                        + run_table_ints(PR_THREADS) * 4;

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

// The live points of rows (or columns) [p0, p0 + 64) as bits: index < L
// and, with eligibility words, eligible.
__device__ __forceinline__ unsigned long long live_bits(
    const int* __restrict__ es, int p0, int L, int W) {
  const int n = L - p0;
  if (n <= 0) return 0;
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
// ceil(L / TS), TS the tile's side: ST for K2, QI_T for K2i). A block takes
// units i = blockIdx.x, + gridDim.x, ...
struct PruneTile {
  int i, s, t, end, ti, tj, L;
};

// The walk's table for S <= NT subsets (NT: the block's threads), in shared
// memory: pre[s] live runs before subset s (pre[S] in all), each subset's
// live tiles and length, then the scan's warp sums. With it unit i is the
// i-th live run, so that the live runs are shared out evenly whatever the
// lengths (a batch padded with empty subsets included).
struct RunTable {
  int* pre;
  int* live;
  int* len;
};

__device__ __forceinline__ RunTable run_table(int* t, int nt) {
  return RunTable{t, t + nt + 1, t + 2 * nt + 1};
}

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

// Fills the table and returns the run length: `run` tiles, whose column
// panels stay staged, or single tiles where the batch has fewer live tiles
// than `run_at` (runs would then leave blocks idle while others work through
// several tiles each). TS: the tile's side; NT: the block's threads.
template <int TS, int NT>
__device__ __forceinline__ int scan_runs(const int* __restrict__ lengths,
                                         int S, int P, RunTable tab, int run,
                                         int run_at) {
  const int tid = threadIdx.x;
  int* wsum = tab.len + NT;
  if (S <= 32) {              // one warp, by shuffles: no block-wide scans
    if (tid < 32) {
      const int L = tid < S ? min(max(lengths[tid], 0), P) : 0;
      const int T = (L + TS - 1) / TS, live = T * (T + 1) / 2;
      auto scan = [&](int x) {
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (tid >= o) x += y;
        }
        return x;
      };
      const int tiles = __shfl_sync(0xffffffffu, scan(live), 31);
      const int r = tiles < run_at ? 1 : run;
      const int x = scan((live + r - 1) / r);
      if (tid == 0) {
        tab.pre[0] = 0;
        wsum[NT / 32] = r;
      }
      if (tid < S) {
        tab.pre[tid + 1] = x;
        tab.live[tid] = live;
        tab.len[tid] = L;
      }
    }
    __syncthreads();
    return wsum[NT / 32];
  }
  const int L = tid < S ? min(max(lengths[tid], 0), P) : 0;
  const int T = (L + TS - 1) / TS, live = T * (T + 1) / 2;
  const int tiles = block_scan(live, wsum);
  if (tid == NT - 1) wsum[NT / 32] = tiles;       // the batch's live tiles
  __syncthreads();
  if (wsum[NT / 32] < run_at) run = 1;
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
// from the table where there is one (S <= NT), else from the interleaved
// order i = c S + s over all runs (batches of many subsets have few runs
// each).
template <int TS, int NT>
__device__ __forceinline__ bool next_unit(int i,
                                          const int* __restrict__ lengths,
                                          int S, int P, int runs, int run,
                                          const RunTable& tab, PruneTile& t) {
  for (;; i += gridDim.x) {
    int s, c, L, live;
    if (S <= NT) {
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
      const int T = (L + TS - 1) / TS;
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
  const RunTable tab = run_table(reinterpret_cast<int*>(bn + ST), PR_THREADS);

  const int nt = (P + ST - 1) / ST;
  const int runs = (nt * (nt + 1) / 2 + PR_RUN - 1) / PR_RUN;
  const int panels = (d + PR_K - 1) / PR_K;
  const bool vec = (d % 4 == 0)
                   && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int run = S <= PR_THREADS
      ? scan_runs<ST, PR_THREADS>(lengths, S, P, tab, PR_RUN, gridDim.x)
      : PR_RUN;
  PruneTile cur;
  if (!next_unit<ST, PR_THREADS>(blockIdx.x, lengths, S, P, runs, run, tab,
                                 cur))
    return;
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
        more = next_unit<ST, PR_THREADS>(cur.i + gridDim.x, lengths, S, P,
                                         runs, run, tab, nxt);
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

// ---- K2i: int8 coarse counts on the tensor cores --------------------------
//
// The reference's int8 arm of the prune tier (ops._xla_join_batched_counts
// with dtype "int8", XLA code there, no pallas_call). Two launches a call:
//   int8_prep_kernel   one cooperative launch on a resident grid. Each
//                      subset's largest |x| over its whole padded (P, d)
//                      block, folded into fp32 bits by atomicMax (|x| >= 0
//                      orders as its bits); one grid-wide barrier; then
//                      q = round_half_even(x * scale) as int8 into rows of
//                      `pitch` = ceil(d / 32) * 32 bytes (zeros past d) with
//                      each row's exact int32 norm, for the live rows only
//                      (the join masks the others; their norms are 0).
//                      Subsets with no live point are neither read nor
//                      written: their counts are 0 whatever their scale.
//   prune_int8_kernel  K2's triangle walk and prefix table over 128 x 128
//                      tiles, warp-specialised, one block an SM. A producer
//                      warp copies the int8 rows (and, with a tile's last
//                      panel, their norms) by TMA into a ring of QI_STAGES
//                      row panels and one of column panels, 128 features
//                      of 128 points each, 128-byte swizzled and K-major,
//                      guarded by full/empty mbarriers; two consumer
//                      warpgroups each sum a 64 x 128 half of the exact
//                      int32 Gram with wgmma.m64n128k32.s32.s8.s8 (the next
//                      panels' copies in flight) and compare sq = n_i + n_j
//                      - 2 g with the subset's integer threshold (taken
//                      once a block), counting as K2 does (the mirrored
//                      half twice) into per-subset sums in shared memory,
//                      one global atomic a subset a block. A run's tiles
//                      of one column share their column panel where
//                      d <= 128: it is copied once.
// scale = 127 / max(maxabs, 1e-30) and thr = ceil((r scale + sqrt(d))^2) + 1
// are fp32 with one rounding an operation (__fdiv_rn, __fmul_rn,
// __fadd_rn: no contraction into an FMA), so everything but those two
// roundings is exact: the counts equal kernels.ref's bit for bit under any
// tiling.
// Why two launches: the scale spans the whole padded block, so the int8
// rows cannot be made while staging (as K2 rounds to bf16) before every
// block has seen its subset's largest magnitude. Once made, they are the
// tensor cores' operand type, so TMA feeds them to wgmma with no register
// pass.
// Bound: 2 d int8 operations a distinct live pair at 1,979 TOP/s against
// the live subsets' fp32 blocks read once at 3.35 TB/s: at the main path's
// (8, 2880, 64) about half a microsecond each, so latency (two launches, a
// grid barrier, the walk's set-up, a TMA round trip, each tile's epilogue
// with one tile in flight an SM) is what the time is made of (PERF.md).

constexpr int QI_T = 128;                  // tile rows = tile columns
constexpr int QI_K = 128;                  // int8 features a panel
constexpr int QI_KSTEP = 32;               // int8 features a wgmma k-step
constexpr int QI_CONSUMERS = 256;          // two warpgroups, 64 rows each
constexpr int QI_THREADS = QI_CONSUMERS + 32;   // + the producer warp
constexpr int QI_STAGES = 4;               // panels a ring holds
constexpr int QI_PANEL = QI_T * QI_K;      // bytes of a panel (16 KB)
constexpr int QI_NORMS = QI_T * 4;         // bytes of a panel's norms
constexpr int QI_RUN = 4;                  // triangle tiles a unit of work
// One block an SM: at two, ptxas allots 96 registers a thread (9 warps a
// block: 5 on one of the SM's four register quarters) and the 64 int32
// accumulators spill.
constexpr int QI_MIN_BLOCKS = 1;
// slack, the two rings' panels and norms, their full and empty barriers,
// the walk's table, and a threshold and a count a subset (S <= QI_THREADS)
constexpr int QI_SMEM = 1024 + 2 * QI_STAGES * (QI_PANEL + QI_NORMS)
                        + 4 * QI_STAGES * 8
                        + (run_table_ints(QI_THREADS) + 2 * QI_THREADS) * 4;
constexpr int QP_THREADS = 256;            // the prep kernel's block
// Prep blocks an SM: fewer than the 8 that fit shorten its launch and its
// grid barrier by more than its row pass loses (measured at K2's path input)
constexpr int QP_BLOCKS_PER_SM = 4;
constexpr int QP_CHUNK = QP_THREADS * 16;  // values a block folds at a time

static_assert(QI_PANEL % 1024 == 0, "panels keep the swizzle's alignment");
static_assert(QI_K == 128, "a panel row is one 128-byte swizzle row");

__device__ __forceinline__ float int8_scale(unsigned maxbits) {
  return __fdiv_rn(127.0f, fmaxf(__uint_as_float(maxbits), 1e-30f));
}

__device__ __forceinline__ int f2i_sat(float v) {
  if (v >= 2147483648.0f) return INT_MAX;
  if (v < -2147483648.0f) return INT_MIN;
  return static_cast<int>(v);
}

__device__ __forceinline__ int subset_len(const int* __restrict__ lengths,
                                          int s, int P) {
  return min(max(lengths[s], 0), P);
}

// A subset's integer join threshold, ceil((r scale + sqrt(d))^2) + 1, in
// fp32 with one rounding an operation.
__device__ __forceinline__ int int8_threshold(unsigned maxbits, float r,
                                              float sqrtd) {
  const float rq = __fadd_rn(__fmul_rn(r, int8_scale(maxbits)), sqrtd);
  return f2i_sat(__fadd_rn(ceilf(__fmul_rn(rq, rq)), 1.0f));
}

// The caller zeroes maxbits (S,). Writes q (S, P, pitch) int8 and n2 (S, pn)
// int32 for the subsets with a live point. S P < 2^31 (the launcher checks).
__global__ void __launch_bounds__(QP_THREADS)
int8_prep_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                 int S, int P, int d, int pitch, int pn,
                 unsigned* __restrict__ maxbits, signed char* __restrict__ q,
                 int* __restrict__ n2) {
  __shared__ float wmax[QP_THREADS / 32];
  __shared__ float scale_of[QP_THREADS];  // S <= QP_THREADS: each subset's
  __shared__ int len_of[QP_THREADS];      // scale and length
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;

  // 1. Grid-stride over (subset, chunk of QP_CHUNK values): a block folds a
  // chunk's largest magnitude and adds it by one atomic.
  const long long n = static_cast<long long>(P) * d;
  const int per_s = static_cast<int>((n + QP_CHUNK - 1) / QP_CHUNK);
  const bool vec = aligned && n % 4 == 0;
  for (int u = blockIdx.x; u < per_s * S; u += gridDim.x) {
    const int s = u / per_s;
    if (subset_len(lengths, s, P) == 0) continue;       // block-uniform
    const float* xs = x + s * n;
    const long long c0 = static_cast<long long>(u % per_s) * QP_CHUNK;
    float m = 0.f;
    if (vec) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long i = c0 + (e * QP_THREADS + tid) * 4;
        if (i < n) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(xs + i));
          m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
        }
      }
    } else {
#pragma unroll 4
      for (int e = 0; e < 16; ++e) {
        const long long i = c0 + e * QP_THREADS + tid;
        if (i < n) m = fmaxf(m, fabsf(__ldg(xs + i)));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) wmax[warp] = m;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < QP_THREADS / 32; ++w) m = fmaxf(m, wmax[w]);
      if (m > 0.f) atomicMax(maxbits + s, __float_as_uint(m));
    }
    __syncthreads();                              // wmax may be reused
  }

  cooperative_groups::this_grid().sync();

  const bool small = S <= QP_THREADS;
  if (small && tid < S) {
    scale_of[tid] = int8_scale(__ldcg(maxbits + tid));
    len_of[tid] = subset_len(lengths, tid, P);
  }
  __syncthreads();
  // 2. The rows, G lanes a row (a 4-feature word each per pass), 32 / G
  // rows a warp; each row's norm by a butterfly over its G lanes.
  const int words = pitch / 4;
  const int G = words <= 8 ? 8 : words <= 16 ? 16 : 32;
  const int sub = lane / G, gl = lane % G;
  const bool vrow = aligned && d % 4 == 0;
  const int rows = S * P;
  const int nw = gridDim.x * (QP_THREADS / 32);
  for (int w = blockIdx.x * (QP_THREADS / 32) + warp; w * (32 / G) < rows;
       w += nw) {                                    // warp-uniform
    const int row = w * (32 / G) + sub;
    const bool ok = row < rows;
    const int s = ok ? row / P : 0, p = ok ? row - s * P : 0;
    int acc = 0;
    if (ok && p < (small ? len_of[s] : subset_len(lengths, s, P))) {
      const float scale = small ? scale_of[s]
                                : int8_scale(__ldcg(maxbits + s));
      const float* src = x + static_cast<long long>(row) * d;
      unsigned* dst = reinterpret_cast<unsigned*>(
          q + static_cast<long long>(row) * pitch);
      for (int wd = gl; wd < words; wd += G) {
        const int f = 4 * wd;
        float v[4];
        if (vrow) {
          const float4 t = f < d
              ? __ldg(reinterpret_cast<const float4*>(src + f))
              : make_float4(0.f, 0.f, 0.f, 0.f);
          v[0] = t.x;
          v[1] = t.y;
          v[2] = t.z;
          v[3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = f + e < d ? __ldg(src + f + e) : 0.f;
        }
        unsigned word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = __float2int_rn(__fmul_rn(v[e], scale));
          acc += qi * qi;
          word |= (static_cast<unsigned>(qi) & 0xffu) << (8 * e);
        }
        dst[wd] = word;
      }
    }
    for (int o = G / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (ok && gl == 0) n2[static_cast<size_t>(s) * pn + p] = acc;
  }
}

// Whether tile `t`'s column panel stays staged for its unit's next tile:
// one panel, and that tile lies off the diagonal in the same column.
__device__ __forceinline__ bool keeps_column(const PruneTile& t, int panels) {
  return panels == 1 && t.ti + 1 < t.tj && t.t + 1 < t.end;
}

// The unit's next tile of the column-by-column enumeration.
__device__ __forceinline__ void next_tile(PruneTile& t) {
  ++t.t;
  if (++t.ti > t.tj) {
    t.ti = 0;
    ++t.tj;
  }
}

__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// K2i's join: the caller zeroes counts. tq maps the (S, P, pitch) int8 block
// (boxes of 128 features x 128 rows x 1 subset, 128-byte swizzled), tn the
// (S, P) norms (boxes of 128 rows x 1 subset); rows past P arrive as zeros.
__global__ void __launch_bounds__(QI_THREADS, QI_MIN_BLOCKS)
prune_int8_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tn,
                  const unsigned* __restrict__ maxbits,
                  const int* __restrict__ lengths,
                  const float* __restrict__ radii,
                  const int* __restrict__ elig, int S, int P, int d, int W,
                  int* __restrict__ counts) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;        // swizzle alignment
  // row panels [QI_STAGES], column panels [QI_STAGES], their norms in the
  // same order, the barriers, the walk's table
  const uint32_t panel_a = base, panel_b = base + QI_STAGES * QI_PANEL;
  const uint32_t norm_a = base + 2 * QI_STAGES * QI_PANEL;
  const uint32_t norm_b = norm_a + QI_STAGES * QI_NORMS;
  const uint32_t bars = norm_b + QI_STAGES * QI_NORMS;
  const int* norms = reinterpret_cast<const int*>(smem_raw + (norm_a - raw));
  // full and empty barriers of ring r (0: rows, 1: columns) at stage st
  auto full = [&](int r, int st) { return bars + 8 * (r * QI_STAGES + st); };
  auto empty = [&](int r, int st) {
    return bars + 8 * ((2 + r) * QI_STAGES + st);
  };
  int* table =
      reinterpret_cast<int*>(smem_raw + (bars - raw) + 4 * QI_STAGES * 8);
  const RunTable tab = run_table(table, QI_THREADS);
  int* thr_of = table + run_table_ints(QI_THREADS);  // per subset, S <= NT
  int* cnt_of = thr_of + QI_THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float sqrtd = __fsqrt_rn(static_cast<float>(d));
  const bool tabled = S <= QI_THREADS;
  unsigned mb0 = 0;
  float r0v = 0.f;
  if (tabled && tid < S) {               // issued ahead of the walk's scan
    mb0 = __ldg(maxbits + tid);
    r0v = radii[tid];
  }
  if (tid == QI_CONSUMERS) {          // the descriptors' fetch, early
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tq)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tn)) : "memory");
  }
  if (tid == 0) {
    for (int i = 0; i < 2 * QI_STAGES; ++i) {
      mbar_init(bars + 8 * i, 1);                      // the producer's
      mbar_init(bars + 8 * (2 * QI_STAGES + i), QI_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nt = (P + QI_T - 1) / QI_T;
  const int runs = (nt * (nt + 1) / 2 + QI_RUN - 1) / QI_RUN;
  const int panels = (d + QI_K - 1) / QI_K;
  // runs only where every block gets two or more: with fewer, a block's
  // second run would double the tail that single tiles spread evenly
  const int run = tabled
      ? scan_runs<QI_T, QI_THREADS>(lengths, S, P, tab, QI_RUN,
                                    2 * QI_RUN * static_cast<int>(gridDim.x))
      : QI_RUN;
  // With the table, each subset's threshold once, and its count summed in
  // shared memory: one global atomic a subset a block.
  if (tabled) {
    if (tid < S) {
      thr_of[tid] = int8_threshold(mb0, r0v, sqrtd);
      cnt_of[tid] = 0;
    }
    __syncthreads();
  }
  // Both roles walk the same tiles: unit by unit, tile by tile, panel by
  // panel. A diagonal tile's column panel is its row panel; a held column
  // panel (keeps_column) is not copied again.
  int ia = 0, ib = 0;                 // panels taken from each ring
  bool held = false;
  PruneTile cur;

  if (warp == QI_CONSUMERS / 32) {
    // The producer warp: few registers; one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (lane != 0) return;
    for (int i = blockIdx.x;
         next_unit<QI_T, QI_THREADS>(i, lengths, S, P, runs, run, tab, cur);
         i = cur.i + gridDim.x) {
      for (;;) {
        const bool diag = cur.ti == cur.tj;
        for (int k = 0; k < panels; ++k) {
          const uint32_t tx = QI_PANEL + (k + 1 == panels ? QI_NORMS : 0);
          for (int r = 0; r < 2; ++r) {
            if (r == 1 && (diag || held)) break;
            int& it = r == 0 ? ia : ib;
            const int st = it % QI_STAGES;
            const int p0 = (r == 0 ? cur.ti : cur.tj) * QI_T;
            mbar_wait(empty(r, st), ((it / QI_STAGES) & 1) ^ 1);
            mbar_expect_tx(full(r, st), tx);
            tma_load_3d((r == 0 ? panel_a : panel_b) + st * QI_PANEL, &tq,
                        full(r, st), k * QI_K, p0, cur.s);
            if (k + 1 == panels)
              tma_load_2d((r == 0 ? norm_a : norm_b) + st * QI_NORMS, &tn,
                          full(r, st), p0, cur.s);
            ++it;
          }
        }
        held = keeps_column(cur, panels);
        if (cur.t + 1 >= cur.end) break;
        next_tile(cur);
      }
    }
    return;
  }

  // The consumers: warpgroup wg takes tile rows 64 wg .. 64 wg + 63. Thread
  // t of warp w of it holds rows r0 = 64 wg + 16 (w % 4) + t / 4 and r0 + 8,
  // columns 8 j + 2 (t % 4) and + 1 (j < 16) of the accumulator.
  const int wg = warp / 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + (lane >> 2), c0 = 2 * (lane & 3);
  int sb = 0;                                  // the column panel's stage
  for (int i = blockIdx.x;
       next_unit<QI_T, QI_THREADS>(i, lengths, S, P, runs, run, tab, cur);
       i = cur.i + gridDim.x) {
    for (;;) {
      const bool diag = cur.ti == cur.tj;
      // the threshold's loads issued ahead of the products
      const int thr = tabled ? thr_of[cur.s]
                             : int8_threshold(__ldg(maxbits + cur.s),
                                              radii[cur.s], sqrtd);
      int acc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0;
      int sa = 0;
      for (int k = 0; k < panels; ++k) {
        sa = ia % QI_STAGES;
        mbar_wait(full(0, sa), (ia / QI_STAGES) & 1);
        ++ia;
        if (!diag && !held) {
          sb = ib % QI_STAGES;
          mbar_wait(full(1, sb), (ib / QI_STAGES) & 1);
          ++ib;
        }
        const uint32_t da = panel_a + sa * QI_PANEL + wg * 64 * QI_K;
        const uint32_t db = diag ? panel_a + sa * QI_PANEL
                                 : panel_b + sb * QI_PANEL;
        // Every k-step of the panel, unconditionally: those past d multiply
        // the copies' zero fill (at d = 64, two of four; a two-step build
        // timed within noise of this). A k-step count known only at run time,
        // or a branch with wgmma in flight, makes ptxas serialise every
        // wgmma (C7520), so a panel's products retire before the next
        // branch; the next panels' copies fly meanwhile.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QI_K / QI_KSTEP; ++kk)
          wgmma_s8_n128(acc, desc_k_major(da + kk * QI_KSTEP),
                        desc_k_major(db + kk * QI_KSTEP), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        if (k + 1 < panels) {
          release(empty(0, sa));
          if (!diag) release(empty(1, sb));
        }
      }

      // The epilogue, from the last panel's norms (copied with it): pair
      // (i, j) joins iff n_j - 2 g <= thr - n_i, the same integers moved
      // across (no term overflows int32 for d <= INT8_MAX_D). A dead or
      // ineligible row takes INT_MIN as its bound (n_j - 2 g never reaches
      // it); four counters keep the sums' chains short.
      const int* na = norms + sa * QI_T;
      const int* nb = diag ? na : norms + (QI_STAGES + sb) * QI_T;
      const int* es = elig ? elig + static_cast<size_t>(cur.s) * W : nullptr;
      const bool interior = es == nullptr && (cur.tj + 1) * QI_T <= cur.L;
      auto live = [&](int p) {
        return p < cur.L && (es == nullptr || elig_bit(es, p));
      };
      const int t0 = interior || live(cur.ti * QI_T + r0) ? thr - na[r0]
                                                          : INT_MIN;
      const int t1 = interior || live(cur.ti * QI_T + r0 + 8)
          ? thr - na[r0 + 8] : INT_MIN;
      int c4[4] = {0, 0, 0, 0};
      if (interior) {                          // the threshold alone
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int2 b = *reinterpret_cast<const int2*>(nb + 8 * j + c0);
          c4[0] += b.x - 2 * acc[4 * j] <= t0;
          c4[1] += b.y - 2 * acc[4 * j + 1] <= t0;
          c4[2] += b.x - 2 * acc[4 * j + 2] <= t1;
          c4[3] += b.y - 2 * acc[4 * j + 3] <= t1;
        }
      } else {
        const unsigned long long cl[2] = {
            live_bits(es, cur.tj * QI_T, cur.L, W),
            live_bits(es, cur.tj * QI_T + 64, cur.L, W)};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int e = static_cast<int>(cl[j / 8] >> ((8 * j + c0) & 63));
          const int2 b = *reinterpret_cast<const int2*>(nb + 8 * j + c0);
          c4[0] += (b.x - 2 * acc[4 * j] <= t0) & e;
          c4[1] += (b.y - 2 * acc[4 * j + 1] <= t0) & (e >> 1);
          c4[2] += (b.x - 2 * acc[4 * j + 2] <= t1) & e;
          c4[3] += (b.y - 2 * acc[4 * j + 3] <= t1) & (e >> 1);
        }
      }
      int cnt = (c4[0] + c4[1] + c4[2] + c4[3]) * (diag ? 1 : 2);  // mirror
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 16);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 8);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 4);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
      if (lane == 0 && cnt)
        atomicAdd(tabled ? cnt_of + cur.s : counts + cur.s, cnt);

      release(empty(0, sa));
      held = keeps_column(cur, panels);
      if (!diag && !held) release(empty(1, sb));
      if (cur.t + 1 >= cur.end) break;
      next_tile(cur);
    }
  }
  if (tabled) {                 // the block's counts, once a subset
    asm volatile("bar.sync 1, %0;\n" ::"n"(QI_CONSUMERS) : "memory");
    for (int i = tid; i < S; i += QI_CONSUMERS)
      if (cnt_of[i]) atomicAdd(counts + i, cnt_of[i]);
  }
}

// ---- K3 and K4: 128 x 128 register tiles written out whole ----------------

constexpr int RT = 128;                    // tile rows = tile columns
constexpr int RT_RG = 8;                   // row groups
constexpr int RT_CG = 16;                  // column groups
constexpr int RT_THREADS = RT_RG * RT_CG;
constexpr int RT_WARPS = RT_THREADS / 32;
constexpr int RT_NI = RT / RT_RG;          // a thread's rows rg + RT_RG i
constexpr int RT_NU = RT / RT_CG;          // and columns cg + RT_CG u
constexpr int RT_NPT = 2 * RT / RT_THREADS;  // norms a thread sums
constexpr int RT_KC = 32;                  // features a stage
constexpr int RT_LD = RT_KC + 4;           // padded point rows (144 bytes)
constexpr int RT_STAGE = 2 * RT * RT_LD;   // floats of a stage: rows, columns
constexpr int RT_HALF = RT / 2;            // output rows staged at a time
constexpr int OUT_LD = RT + 8;             // staged direct rows (8 mod 32)
constexpr int MIR_LD = RT + 4;             // staged mirrored rows (4 mod 32)
constexpr int CELL_CAP = 1024;             // grid cells a pass sums in smem
constexpr int RT_BLOCKS_PER_SM = 2;        // at most 255 registers a thread
// Dynamic shared memory: two stage buffers, the tile's squared norms, the
// pass's count cells, K4's walk table (pre[S + 1], len[S], 8 warp sums).
constexpr int RT_SMEM =
    (2 * RT_STAGE + 2 * RT + CELL_CAP + 2 * RT_THREADS + 1 + 8) * 4;

static_assert(RT_CG == 16 && RT_RG % 4 == 0 && RT_WARPS <= 8,
              "warps of 4 row groups x 8 column groups");
static_assert(RT_HALF * OUT_LD <= RT_STAGE && RT_HALF * MIR_LD <= RT_STAGE,
              "a staged half of the output fits one stage buffer");
static_assert(RT_HALF % RT_WARPS == 0 && 2 * RT % RT_THREADS == 0,
              "warps share a half's rows, threads the norms");

// A warp holds 4 row groups x 8 column groups: per float4 load it reads 4
// rows or 8 consecutive column rows (distinct banks), and its writes of a
// staged output half, direct or transposed, fall in 32 distinct banks.
__device__ __forceinline__ int rt_rg() {
  return (threadIdx.x >> 6) * 4 + ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int rt_cg() {
  return ((threadIdx.x >> 5) & 1) * 8 + (threadIdx.x & 7);
}

// One output tile: rows [row0, row0 + RT) of a (na points) against columns
// [col0, col0 + RT) of b (nb points); points past na, nb read as zero.
struct RtTile {
  const float* a;
  const float* b;
  int na, nb, row0, col0;
  int s;                                   // K4: the subset
  bool diag;                               // K4: b's tile is a's, staged once
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copies of features [k0, k0 + RT_KC) of the tile's row points
// and (off the diagonal) column points into a stage buffer.
__device__ __forceinline__ void rt_load(float* buf, const RtTile& t, int d,
                                         int k0, bool vec) {
  using Rows = float (*)[RT_LD];
  stage_points<RT, RT_KC, RT_THREADS>(reinterpret_cast<Rows>(buf), t.a,
                                      t.row0, t.na, d, k0, vec);
  if (!t.diag)
    stage_points<RT, RT_KC, RT_THREADS>(reinterpret_cast<Rows>(buf + RT * RT_LD),
                                        t.b, t.col0, t.nb, d, k0, vec);
}

// s plus the squares of a staged point's RT_KC features, in feature order.
__device__ __forceinline__ float rt_norm(const float* p, float s) {
#pragma unroll
  for (int k = 0; k < RT_KC; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  return s;
}

// acc[i][u] += <row rg + RT_RG i, column cg + RT_CG u> over a stage's
// features, in feature order: per 4 features the thread's 8 columns as one
// float4 each, then each of its 16 rows as one float4 against all of them,
// 24 shared loads a 512 FMAs. 144-byte rows put 8 consecutive points in
// distinct banks.
__device__ __forceinline__ void rt_gram(float (&acc)[RT_NI][RT_NU],
                                        const float* A, const float* B,
                                        int rg, int cg) {
#pragma unroll 1
  for (int k = 0; k < RT_KC; k += 4) {
    float4 bv[RT_NU];
#pragma unroll
    for (int u = 0; u < RT_NU; ++u)
      bv[u] = *reinterpret_cast<const float4*>(B + (cg + RT_CG * u) * RT_LD + k);
#pragma unroll
    for (int i = 0; i < RT_NI; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(A + (rg + RT_RG * i) * RT_LD + k);
#pragma unroll
      for (int u = 0; u < RT_NU; ++u) {
        acc[i][u] = fmaf(av.x, bv[u].x, acc[i][u]);
        acc[i][u] = fmaf(av.y, bv[u].y, acc[i][u]);
        acc[i][u] = fmaf(av.z, bv[u].z, acc[i][u]);
        acc[i][u] = fmaf(av.w, bv[u].w, acc[i][u]);
      }
    }
  }
}

// Bits a..b of a word, none when a > b (then a may be 32).
__device__ __forceinline__ unsigned bit_span(int a, int b) {
  if (a > b) return 0u;
  return (b >= 31 ? 0xffffffffu : (2u << b) - 1u) & (0xffffffffu << a);
}

// The lanes l whose float4 column 4 l + j lies in [lo, hi): bits of word j.
__device__ __forceinline__ unsigned lanes_in(int lo, int hi, int j) {
  return bit_span((lo - j + 3) >> 2, (hi - 1 - j) >> 2);
}

// The join counts of one pass on the caller's (bm, bn) grid: output rows
// [grow0, grow0 + RT) by columns [gcol0, gcol0 + RT), rows < nr and columns
// < nc valid. The pass's cells sum in shared memory where there are at most
// CELL_CAP of them (each nonzero cell then takes one atomic), else straight
// into the output counts. Lane l counts grid column cc0 + l of every row:
// its four lane masks are fixed for the pass, so a row costs four ANDs and
// popcounts (a pass with more than 32 grid columns, bn < 4, splits each row
// in a loop). A lane keeps one pending (row cell, column cell, count) and
// adds it where it moves on.
struct RtCounts {
  int* cells;                              // shared, or nullptr
  int* out;                                // (gm, gn) counts of the output
  int gn, bm, bn;
  int rc0, cc0, ncc, ncells;
  int my_cc;                               // this lane's grid column, or -1
  unsigned m[4];
  bool single;                             // the pass lies in one grid cell
  int prc, pcc, pend;

  __device__ __forceinline__ RtCounts(int* s_cells, int* out_, int gn_,
                                      int bm_, int bn_, int grow0, int gcol0,
                                      int nr, int nc)
      : out(out_), gn(gn_), bm(bm_), bn(bn_), prc(-1), pcc(-1), pend(0) {
    rc0 = grow0 / bm;
    cc0 = gcol0 / bn;
    ncc = (min(gcol0 + RT, nc) - 1) / bn - cc0 + 1;
    ncells = ((min(grow0 + RT, nr) - 1) / bm - rc0 + 1) * ncc;
    cells = ncells <= CELL_CAP ? s_cells : nullptr;
    single = ncells == 1;
    const int lane = threadIdx.x & 31;
    my_cc = lane < ncc ? cc0 + lane : -1;
    const int lo = max(my_cc * bn - gcol0, 0);
    const int hi = min((my_cc + 1) * bn - gcol0, RT);
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = my_cc >= 0 ? lanes_in(lo, hi, j) : 0u;
  }

  __device__ __forceinline__ void flush() {
    if (pend) {
      if (cells) atomicAdd(cells + (prc - rc0) * ncc + (pcc - cc0), pend);
      else atomicAdd(out + (size_t)prc * gn + pcc, pend);
    }
    pend = 0;
  }

  __device__ __forceinline__ void add(int rc, int cc, int n) {
    if (n == 0) return;
    if (rc != prc || cc != pcc) {
      flush();
      prc = rc;
      pcc = cc;
    }
    pend += n;
  }

  // Row cell rc's joined cells: bit l of w[j] is column gcol0 + 4 l + j.
  __device__ __forceinline__ void row(const unsigned (&w)[4], int rc,
                                      int gcol0) {
    if (ncc <= 32) {
      add(rc, my_cc, __popc(w[0] & m[0]) + __popc(w[1] & m[1])
                         + __popc(w[2] & m[2]) + __popc(w[3] & m[3]));
      return;
    }
    for (int cc = cc0 + (threadIdx.x & 31); cc < cc0 + ncc; cc += 32) {
      const int lo = max(cc * bn - gcol0, 0);
      const int hi = min((cc + 1) * bn - gcol0, RT);
      add(rc, cc, __popc(w[0] & lanes_in(lo, hi, 0))
                      + __popc(w[1] & lanes_in(lo, hi, 1))
                      + __popc(w[2] & lanes_in(lo, hi, 2))
                      + __popc(w[3] & lanes_in(lo, hi, 3)));
    }
  }
};

// Writes staged rows [0, RT_HALF) (stride ld) to output rows grow0 + r,
// columns gcol0 + [0, RT) (row stride out_ld): warp w takes rows 8 w .. 8 w
// + 7, a row at a time, lane l its columns 4 l .. 4 l + 3 as one 16-byte
// streaming store (st.global.cs: the block is not read back) where all four
// are valid and aligned, else one by one. Rows >= nr and columns >= nc are
// not written. Counts the valid cells with sq <= r2.
__device__ __forceinline__ void rt_store_half(const float* st, int ld,
                                              float* out, size_t out_ld,
                                              int grow0, int gcol0, int nr,
                                              int nc, bool vec_out, float r2,
                                              RtCounts& cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gc = gcol0 + 4 * lane;
  constexpr int ROWS = RT_HALF / RT_WARPS;
  int grow = grow0 + ROWS * warp;
  int rc = grow / cnt.bm, next = (rc + 1) * cnt.bm;   // the row's grid cell
  int joined = 0;                          // (single) this lane's count
#pragma unroll 2
  for (int q = 0; q < ROWS; ++q, ++grow) {
    if (grow >= nr) break;                   // warp-uniform
    if (grow == next) {
      ++rc;
      next += cnt.bm;
    }
    const float4 v =
        *reinterpret_cast<const float4*>(st + (ROWS * warp + q) * ld + 4 * lane);
    float* dst = out + (size_t)grow * out_ld + gc;
    if (vec_out && gc + 3 < nc) {
      __stcs(reinterpret_cast<float4*>(dst), v);
    } else {
      if (gc < nc) __stcs(dst, v.x);
      if (gc + 1 < nc) __stcs(dst + 1, v.y);
      if (gc + 2 < nc) __stcs(dst + 2, v.z);
      if (gc + 3 < nc) __stcs(dst + 3, v.w);
    }
    const bool p0 = gc < nc && v.x <= r2, p1 = gc + 1 < nc && v.y <= r2;
    const bool p2 = gc + 2 < nc && v.z <= r2, p3 = gc + 3 < nc && v.w <= r2;
    if (cnt.single) {                        // warp-uniform
      joined += p0 + p1 + p2 + p3;
    } else {
      const unsigned w[4] = {__ballot_sync(0xffffffffu, p0),
                             __ballot_sync(0xffffffffu, p1),
                             __ballot_sync(0xffffffffu, p2),
                             __ballot_sync(0xffffffffu, p3)};
      if (w[0] | w[1] | w[2] | w[3]) cnt.row(w, rc, gcol0);
    }
  }
  if (cnt.single) {
#pragma unroll
    for (int o = 16; o; o >>= 1) joined += __shfl_xor_sync(0xffffffffu, joined, o);
    if (lane == 0) cnt.add(cnt.rc0, cnt.cc0, joined);
  }
  cnt.flush();
}

// One orientation of a finished tile (v[i][u]: sq of tile row rg + RT_RG i,
// column cg + RT_CG u): direct (output rows row0 + .., columns col0 + ..) or,
// for MIRROR, its transpose (rows col0 + .., columns row0 + ..). Two halves,
// each staged through `st` (a stage buffer) so that output rows go out
// whole: the direct half h holds tile rows 64 h.., the mirrored half h tile
// columns 64 h... Counts are summed per pass and added to counts (gm, gn).
template <bool MIRROR>
__device__ __forceinline__ void rt_pass(float* st, int* s_cells,
                                        const float (&v)[RT_NI][RT_NU],
                                        int row0, int col0, int nr, int nc,
                                        float* out, size_t out_ld,
                                        bool vec_out, float r2, int* counts,
                                        int gn, int bm, int bn) {
  const int tid = threadIdx.x, rg = rt_rg(), cg = rt_cg();
  const int grow0 = MIRROR ? col0 : row0, gcol0 = MIRROR ? row0 : col0;
  const int ld = MIRROR ? MIR_LD : OUT_LD;
  RtCounts cnt(s_cells, counts, gn, bm, bn, grow0, gcol0, MIRROR ? nc : nr,
               MIRROR ? nr : nc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __syncthreads();                       // the buffer's readers are done
    if (h == 0 && cnt.cells)
      for (int e = tid; e < cnt.ncells; e += RT_THREADS) cnt.cells[e] = 0;
#pragma unroll
    for (int a = 0; a < (MIRROR ? RT_NU : RT_NI) / 2; ++a)
#pragma unroll
      for (int b = 0; b < (MIRROR ? RT_NI : RT_NU); ++b) {
        if (MIRROR)
          st[(cg + RT_CG * a) * MIR_LD + rg + RT_RG * b] =
              v[b][RT_NU / 2 * h + a];
        else
          st[(rg + RT_RG * a) * OUT_LD + cg + RT_CG * b] =
              v[RT_NI / 2 * h + a][b];
      }
    __syncthreads();
    rt_store_half(st, ld, out, out_ld, grow0 + RT_HALF * h, gcol0,
                  MIRROR ? nc : nr, MIRROR ? nr : nc, vec_out, r2, cnt);
  }
  __syncthreads();
  if (cnt.cells)
    for (int e = tid; e < cnt.ncells; e += RT_THREADS) {
      const int n = cnt.cells[e];
      if (n)
        atomicAdd(counts + (size_t)(cnt.rc0 + e / cnt.ncc) * gn + cnt.cc0
                      + e % cnt.ncc, n);
    }
}

// The engine of K3 and K4: a persistent block walks its units u (walk.next:
// the first live unit at or after u, stepping by the grid; walk.tile: its
// tile), each tile computed in stages of RT_KC features through two stage
// buffers: the next stage's copies (or the next tile's first) start right
// after the wait for the current one, so they fly during its FMAs and, at
// a tile's end, during its epilogue. One barrier a stage. Only the unit
// indices live across the FMA loop; tiles are rebuilt from them. The
// squared norms are summed from the staged points (thread t: points t and
// t + RT_THREADS, rows below RT, then columns), in feature order as the
// Gram terms are, so a point's norm has the same bits as a row and as a
// column. Then epi(tile, sq, a
// free stage buffer) with sq = max((|a|^2 + |b|^2) - 2 a.b, 0) rounded as
// K1 rounds it, and slot() between tiles (and once before the first).
template <class Walk, class Epi, class Slot>
__device__ __forceinline__ void rt_run(float* smem, const Walk& walk, int d,
                                       bool vec, Epi&& epi, Slot&& slot) {
  float* s_an = smem + 2 * RT_STAGE;
  float* s_bn = s_an + RT;
  const int tid = threadIdx.x, rg = rt_rg(), cg = rt_cg();
  const int stages = (d + RT_KC - 1) / RT_KC;
  long long u = walk.next(blockIdx.x);
  if (u >= 0) rt_load(smem, walk.tile(u), d, 0, vec);
  cp_async_commit();
  slot();
  if (u < 0) return;
  int g = 0;                               // stages so far: buffer g & 1
  for (;;) {
    float acc[RT_NI][RT_NU];
#pragma unroll
    for (int i = 0; i < RT_NI; ++i)
#pragma unroll
      for (int v = 0; v < RT_NU; ++v) acc[i][v] = 0.f;
    float norm[RT_NPT] = {};
    long long un = -1;
    for (int ks = 0; ks < stages; ++ks, ++g) {
      float* cb = smem + (g & 1) * RT_STAGE;
      float* nb = smem + ((g + 1) & 1) * RT_STAGE;
      cp_async_wait0();                    // this stage has landed
      __syncthreads();                     // ... for all; nb is free
      if (ks + 1 < stages) {
        rt_load(nb, walk.tile(u), d, (ks + 1) * RT_KC, vec);
      } else {
        un = walk.next(u + gridDim.x);
        if (un >= 0) rt_load(nb, walk.tile(un), d, 0, vec);
      }
      cp_async_commit();
      const float* A = cb;
      const float* B = walk.diag(u) ? cb : cb + RT * RT_LD;
#pragma unroll
      for (int j = 0; j < RT_NPT; ++j) {
        const int pt = tid + RT_THREADS * j;   // row pt, or column pt - RT
        norm[j] = rt_norm(pt < RT ? A + pt * RT_LD : B + (pt - RT) * RT_LD,
                          norm[j]);
      }
      rt_gram(acc, A, B, rg, cg);
    }
#pragma unroll
    for (int j = 0; j < RT_NPT; ++j) s_an[tid + RT_THREADS * j] = norm[j];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RT_NI; ++i) {
      const float an = s_an[rg + RT_RG * i];
#pragma unroll
      for (int v = 0; v < RT_NU; ++v) {
        // explicit roundings: the mirrored cell has the same bits
        const float e = __fmaf_rn(-2.0f, acc[i][v],
                                  __fadd_rn(an, s_bn[cg + RT_CG * v]));
        acc[i][v] = e > 0.f ? e : 0.f;      // +0, never -0
      }
    }
    epi(walk.tile(u), acc, smem + ((g - 1) & 1) * RT_STAGE);
    slot();
    if (un < 0) break;
    u = un;
  }
}

// FLT_MAX into p[0, n) by the calling warp: single floats up to a 16-byte
// boundary, then 16-byte streaming stores, then the tail.
__device__ __forceinline__ void fill_span(float* p, int n) {
  const int lane = threadIdx.x & 31;
  const int head = min(
      n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15)
             / 4);
  if (lane < head) __stcs(p + lane, FLT_MAX);
  float4* body = reinterpret_cast<float4*>(p + head);
  const int nv = (n - head) / 4;
  const float4 f = make_float4(FLT_MAX, FLT_MAX, FLT_MAX, FLT_MAX);
  for (int e = lane; e < nv; e += 32) __stcs(body + e, f);
  if (lane < n - head - 4 * nv) __stcs(p + head + 4 * nv + lane, FLT_MAX);
}

// K3's walk: output tile u = ti * ntn + tj, row-major; every unit is live.
struct PairWalk {
  const float* a;
  const float* b;
  int M, N, ntn;
  long long end;

  __device__ __forceinline__ long long next(long long u) const {
    return u < end ? u : -1;
  }
  __device__ __forceinline__ bool diag(long long) const { return false; }
  __device__ __forceinline__ RtTile tile(long long u) const {
    return RtTile{a, b, M, N, static_cast<int>(u / ntn) * RT,
                  static_cast<int>(u % ntn) * RT, 0, false};
  }
};

// K4's walk: the live tiles (ti <= tj < ceil(L / RT)) of every subset, in
// the column-by-column order of triangle_tile. With a table of the live
// tiles before each subset (pre, S + 1 entries; len, the lengths) unit u
// is the batch's u-th live tile; without (S > RT_THREADS), u = s ntri + t
// over all ntri tiles of P, those past L skipped.
struct SelfWalk {
  const float* x;
  const int* lengths;
  const int* pre;
  const int* len;
  int S, P, d, ntri;
  long long end;

  // (s, t): the subset of unit u and the tile's index in its triangle.
  __device__ __forceinline__ int subset(long long u, int& t) const {
    if (pre) {
      int lo = 0, hi = S - 1;              // the last s with pre[s] <= u
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pre[mid] <= u) lo = mid;
        else hi = mid - 1;
      }
      t = static_cast<int>(u - pre[lo]);
      return lo;
    }
    t = static_cast<int>(u % ntri);
    return static_cast<int>(u / ntri);
  }
  __device__ __forceinline__ int length(int s) const {
    return pre ? len[s] : min(max(lengths[s], 0), P);
  }
  __device__ __forceinline__ long long next(long long u) const {
    for (; u < end; u += gridDim.x) {
      if (pre) return u;
      int t;
      const int T = (length(subset(u, t)) + RT - 1) / RT;
      if (t < T * (T + 1) / 2) return u;
    }
    return -1;
  }
  __device__ __forceinline__ bool diag(long long u) const {
    int t, ti;
    subset(u, t);
    return triangle_tile(t, ti) == ti;
  }
  __device__ __forceinline__ RtTile tile(long long u) const {
    int t, ti;
    const int s = subset(u, t);
    const int tj = triangle_tile(t, ti);
    const int L = length(s);
    const float* xs = x + (size_t)s * P * d;
    return RtTile{xs, xs, L, L, ti * RT, tj * RT, s, ti == tj};
  }
};

// K3. counts (ceil(M / bm), ceil(N / bn)) are zero on entry; bm <= M, bn <= N.
__global__ void __launch_bounds__(RT_THREADS, RT_BLOCKS_PER_SM)
pairwise_join_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     int M, int N, int d, float r, int bm, int bn,
                     float* __restrict__ sq, int* __restrict__ counts) {
  extern __shared__ __align__(16) float rt_smem[];
  int* cells = reinterpret_cast<int*>(rt_smem + 2 * RT_STAGE + 2 * RT);
  const int ntn = (N + RT - 1) / RT;
  const PairWalk walk{a, b, M, N, ntn,
                      static_cast<long long>((M + RT - 1) / RT) * ntn};
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0
                   && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const bool vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(sq) % 16 == 0;
  rt_run(rt_smem, walk, d, vec,
         [&](const RtTile& t, const float (&v)[RT_NI][RT_NU], float* st) {
           rt_pass<false>(st, cells, v, t.row0, t.col0, M, N, sq, N, vec_out,
                          r * r, counts, (N + bn - 1) / bn, bm, bn);
         },
         [] {});
}

// K4. counts (S, ceil(P / bm), ceil(P / bn)) are zero on entry; bm, bn <= P.
// Live tiles write their cells of the live square, an off-diagonal one also
// its transpose; every warp fills its share of the rows' other cells
// (every column of a row at or past L, columns L.. of a row before it) with
// FLT_MAX, spread over slots between the block's tiles so that the writes
// overlap other blocks' FMAs.
__global__ void __launch_bounds__(RT_THREADS, RT_BLOCKS_PER_SM)
batched_tiles_kernel(const float* __restrict__ x,
                     const int* __restrict__ lengths,
                     const float* __restrict__ radii, int S, int P, int d,
                     int bm, int bn, float* __restrict__ sq,
                     int* __restrict__ counts) {
  extern __shared__ __align__(16) float rt_smem[];
  int* cells = reinterpret_cast<int*>(rt_smem + 2 * RT_STAGE + 2 * RT);
  int* pre = cells + CELL_CAP;
  int* len = pre + RT_THREADS + 1;
  int* wsum = len + RT_THREADS;
  const int tid = threadIdx.x;
  const int nt = (P + RT - 1) / RT, ntri = nt * (nt + 1) / 2;
  SelfWalk walk{x, lengths, nullptr, nullptr, S, P, d, ntri,
                static_cast<long long>(ntri) * S};
  if (S <= RT_THREADS) {
    const int L = tid < S ? min(max(lengths[tid], 0), P) : 0;
    const int T = (L + RT - 1) / RT;
    const int incl = block_scan(T * (T + 1) / 2, wsum);
    if (tid == 0) pre[0] = 0;
    if (tid < S) {
      pre[tid + 1] = incl;
      len[tid] = L;
    }
    __syncthreads();
    walk.pre = pre;
    walk.len = len;
    walk.end = pre[S];
  }
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = P % 4 == 0 && reinterpret_cast<uintptr_t>(sq) % 16 == 0;
  const int gm = (P + bm - 1) / bm, gn = (P + bn - 1) / bn;

  // The fill: warp gw of GW takes rows q = gw + k GW (k < nk) of the S P,
  // in `slots` slices: one before the block's first tile and one after
  // each.
  int slots = 1;
  for (long long u = walk.next(blockIdx.x); u >= 0;
       u = walk.next(u + gridDim.x))
    ++slots;
  int slot = 0;
  auto fill = [&] {
    const long long rows = static_cast<long long>(S) * P;
    const long long GW = static_cast<long long>(gridDim.x) * RT_WARPS;
    const long long gw =
        static_cast<long long>(blockIdx.x) * RT_WARPS + (tid >> 5);
    const long long nk = gw < rows ? (rows - gw + GW - 1) / GW : 0;
    const long long k1 = nk * (slot + 1) / slots;
    for (long long k = nk * slot / slots; k < k1; ++k) {
      const long long q = gw + k * GW;
      const int s = static_cast<int>(q / P), row = static_cast<int>(q % P);
      const int L = walk.length(s);
      const int c0 = row < L ? L : 0;
      fill_span(sq + ((size_t)s * P + row) * P + c0, P - c0);
    }
    ++slot;
  };
  rt_run(rt_smem, walk, d, vec,
         [&](const RtTile& t, const float (&v)[RT_NI][RT_NU], float* st) {
           const float r = radii[t.s];
           float* out = sq + (size_t)t.s * P * P;
           int* cnt = counts + (size_t)t.s * gm * gn;
           rt_pass<false>(st, cells, v, t.row0, t.col0, t.na, t.na, out, P,
                          vec_out, r * r, cnt, gn, bm, bn);
           if (!t.diag)
             rt_pass<true>(st, cells, v, t.row0, t.col0, t.na, t.na, out, P,
                           vec_out, r * r, cnt, gn, bm, bn);
         },
         fill);
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
// per_sm: the caller's memo of the kernel's occupancy (asked once).
template <class Kernel>
int walk_blocks(Kernel kernel, int smem, int S, int P, int& per_sm) {
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  PR_THREADS, smem);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long nt = (P + ST - 1) / ST;
  const long long units = (nt * (nt + 1) / 2 + PR_RUN - 1) / PR_RUN * S;
  const long long blocks =
      2 * static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(units < blocks ? units : blocks);
}

// Blocks of a K3 or K4 launch: as many as the card holds at once, by the
// kernel's occupancy (registers and its dynamic shared memory, raised past
// 48 KB once a device).
template <class Kernel>
int resident_blocks(Kernel kernel) {
  static int per_sm[64] = {};
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int& n = per_sm[dev % 64];
  if (n == 0) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         RT_SMEM);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, RT_THREADS,
                                                  RT_SMEM);
  }
  return sms * (n > 0 ? n : 1);
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
  static int per_sm = 0;
  prune_join_kernel<<<walk_blocks(prune_join_kernel, PR_SMEM, S, P, per_sm),
                      PR_THREADS, PR_SMEM, (cudaStream_t)stream>>>(
      x, lengths, radii, elig, S, P, d, (P + 31) / 32, counts);
  return static_cast<int>(cudaGetLastError());
}

// K2i: counts and maxbits (S each) zeroed by the caller; q (S, P, pitch)
// int8 and n2 (S, pn) int32 are scratch, pitch = ceil(d / 32) * 32 and pn =
// ceil(P / 4) * 4 (every TMA stride a multiple of 16 bytes). Two launches:
// the cooperative prep kernel, then the join. Returns a CUDA error, or
// minus the CUresult of a tensor map that could not be encoded.
int join_batched_prune_int8(const float* x, const int* lengths,
                            const float* radii, const int* elig, int S, int P,
                            int d, int pitch, int pn, signed char* q, int* n2,
                            unsigned* maxbits, int* counts, void* stream) {
  if (pitch != (d + QI_KSTEP - 1) / QI_KSTEP * QI_KSTEP
      || pn != (P + 3) / 4 * 4 || static_cast<long long>(S) * P > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  static int prep_per_sm = 0, join_per_sm = 0;
  if (prep_per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &prep_per_sm, int8_prep_kernel, QP_THREADS, 0);
  // The prep grid: resident blocks (a cooperative launch must be), or fewer
  // where the work is smaller.
  const long long n = static_cast<long long>(P) * d;
  const long long chunks = (n + QP_CHUNK - 1) / QP_CHUNK * S;
  const long long row_blocks =
      (static_cast<long long>(S) * P + QP_THREADS / 32 - 1) / (QP_THREADS / 32);
  const int prep_blocks = static_cast<int>(std::min(
      std::max(chunks, row_blocks),
      static_cast<long long>(sms)
          * std::min(std::max(prep_per_sm, 1), QP_BLOCKS_PER_SM)));
  void* args[] = {&x, &lengths, &S, &P, &d, &pitch, &pn, &maxbits, &q, &n2};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(int8_prep_kernel), prep_blocks, QP_THREADS,
      args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  CUtensorMap tq, tn;
  const cuuint32_t unit[3] = {1, 1, 1};
  const cuuint64_t qdims[3] = {static_cast<cuuint64_t>(pitch),
                               static_cast<cuuint64_t>(P),
                               static_cast<cuuint64_t>(S)};
  const cuuint64_t qstrides[2] = {static_cast<cuuint64_t>(pitch),
                                  static_cast<cuuint64_t>(P) * pitch};
  const cuuint32_t qbox[3] = {QI_K, QI_T, 1};
  CUresult res = encode(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, q, qdims,
                        qstrides, qbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const cuuint64_t ndims[2] = {static_cast<cuuint64_t>(P),
                               static_cast<cuuint64_t>(S)};
  const cuuint64_t nstrides[1] = {static_cast<cuuint64_t>(pn) * 4};
  const cuuint32_t nbox[2] = {QI_T, 1};
  res = encode(&tn, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, n2, ndims, nstrides,
               nbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);

  err = cudaFuncSetAttribute(prune_int8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QI_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (join_per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &join_per_sm, prune_int8_kernel, QI_THREADS, QI_SMEM);
  // As many blocks as the card holds at once, or one a live tile if fewer.
  const long long tside = (P + QI_T - 1) / QI_T;
  const long long tiles = tside * (tside + 1) / 2 * S;
  const int blocks = static_cast<int>(std::min(
      tiles, static_cast<long long>(sms) * std::max(join_per_sm, 1)));
  prune_int8_kernel<<<blocks, QI_THREADS, QI_SMEM, st>>>(
      tq, tn, maxbits, lengths, radii, elig, S, P, d, (P + 31) / 32, counts);
  return static_cast<int>(cudaGetLastError());
}

// The caller zeroes counts (S, ceil(P/bm), ceil(P/bn)); bm, bn >= 1.
int join_batched_tiles(const float* x, const int* lengths, const float* radii,
                       int S, int P, int d, int bm, int bn, float* sq,
                       int* counts, void* stream) {
  batched_tiles_kernel<<<resident_blocks(batched_tiles_kernel), RT_THREADS,
                         RT_SMEM, (cudaStream_t)stream>>>(
      x, lengths, radii, S, P, d, std::min(bm, P), std::min(bn, P), sq,
      counts);
  return static_cast<int>(cudaGetLastError());
}

// The caller zeroes counts (ceil(M/bm), ceil(N/bn)); bm, bn >= 1.
int pairwise_join(const float* a, const float* b, int M, int N, int d, float r,
                  int bm, int bn, float* sq, int* counts, void* stream) {
  const long long tiles =
      static_cast<long long>((M + RT - 1) / RT) * ((N + RT - 1) / RT);
  const int blocks = static_cast<int>(
      std::min(tiles, static_cast<long long>(
                          resident_blocks(pairwise_join_kernel))));
  pairwise_join_kernel<<<blocks, RT_THREADS, RT_SMEM, (cudaStream_t)stream>>>(
      a, b, M, N, d, r, std::min(bm, M), std::min(bn, N), sq, counts);
  return static_cast<int>(cudaGetLastError());
}

int join_square_tile() { return ST; }
// Dynamic shared memory a K3 or K4 block takes (ptxas reports static only).
int join_engine_smem() { return RT_SMEM; }

}  // extern "C"
