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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cstddef>
#include <cstdint>

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

// ---- K2i: int8 coarse counts on the tensor cores --------------------------
//
// The reference's int8 arm of the prune tier (ops._xla_join_batched_counts
// with dtype "int8", XLA code there, no pallas_call). Three launches a call:
//   int8_maxabs_kernel   each subset's largest |x| over its whole padded
//                        (P, d) block, as fp32 bits by atomicMax (|x| >= 0
//                        orders as its bits);
//   int8_quantize_kernel q = round_half_even(x * scale) as int8, a warp a
//                        row, into rows of dq = ceil(d / 128) * 128 bytes
//                        (zeros past d), and each row's exact int32 norm;
//   prune_int8_kernel    K2's triangle walk and prefix table; per 64 x 64
//                        tile and 128-feature panel the row and column
//                        points' int8 rows are copied as 16-byte chunks into
//                        128-byte swizzled K-major panels, and up to four
//                        wgmma.m64n64k32.s32.s8.s8 sum the exact int32
//                        Gram; the epilogue compares sq = n_i + n_j - 2 g
//                        with the integer threshold and counts as K2 does.
// scale = 127 / max(maxabs, 1e-30) and thr = ceil((r scale + sqrt(d))^2) + 1
// are fp32 with one rounding an operation (__fdiv_rn, __fmul_rn,
// __fadd_rn: no contraction into an FMA), so everything but those two
// roundings is exact and the counts equal kernels.ref's bit for bit.
// Bound: 2 d int8 operations a distinct live pair at 1,979 TOP/s against
// the live points' fp32 rows read once at 3.35 TB/s: about half a
// microsecond each at the main path's (8, 2880, 64), far under three
// launches' latency. This first design stages synchronously (no loads in
// flight behind the tensor cores) and passes the int8 block through device
// memory between launches.

constexpr int QI_K = 128;                  // int8 features a panel
constexpr int QI_PANEL = ST * QI_K;        // bytes of one int8 panel
constexpr int QI_SMEM = 1024 + 2 * QI_PANEL + 2 * ST * 4
                        + (3 * PR_THREADS + 8) * 4;
constexpr int QI_MAX_THREADS = 256;        // the maxabs pass's block

static_assert(QI_PANEL % 1024 == 0, "panels keep the swizzle's alignment");

__device__ __forceinline__ float int8_scale(unsigned maxbits) {
  return __fdiv_rn(127.0f, fmaxf(__uint_as_float(maxbits), 1e-30f));
}

__device__ __forceinline__ int f2i_sat(float v) {
  if (v >= 2147483648.0f) return INT_MAX;
  if (v < -2147483648.0f) return INT_MIN;
  return static_cast<int>(v);
}

// Grid (S, chunks): block (s, c) folds a strided share of subset s's P d
// values into maxbits[s]. The caller zeroes maxbits (S,).
__global__ void __launch_bounds__(QI_MAX_THREADS)
int8_maxabs_kernel(const float* __restrict__ x, long long n,
                   unsigned* __restrict__ maxbits) {
  __shared__ float wmax[QI_MAX_THREADS / 32];
  const float* xs = x + static_cast<size_t>(blockIdx.x) * n;
  float m = 0.f;
  for (long long i = blockIdx.y * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.y) * blockDim.x)
    m = fmaxf(m, fabsf(__ldg(xs + i)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < QI_MAX_THREADS / 32; ++w) m = fmaxf(m, wmax[w]);
    if (m > 0.f) atomicMax(maxbits + blockIdx.x, __float_as_uint(m));
  }
}

// A warp a row of the (S, P) rows: q (S, P, dq) int8 and n2 (S, P) int32.
__global__ void __launch_bounds__(PR_THREADS)
int8_quantize_kernel(const float* __restrict__ x,
                     const unsigned* __restrict__ maxbits, int S, int P,
                     int d, int dq, signed char* __restrict__ q,
                     int* __restrict__ n2) {
  const long long row = static_cast<long long>(blockIdx.x) * (PR_THREADS / 32)
                        + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(S) * P) return;
  const int lane = threadIdx.x & 31;
  const float scale = int8_scale(maxbits[row / P]);
  const float* src = x + row * d;
  signed char* dst = q + row * dq;
  int acc = 0;
  for (int f = lane; f < dq; f += 32) {
    const int v = f < d ? __float2int_rn(__fmul_rn(__ldg(src + f), scale)) : 0;
    dst[f] = static_cast<signed char>(v);
    acc += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) n2[row] = acc;
}

// Rows [p0, p0 + ST) of one subset's int8 block, features [k0, k0 + QI_K),
// into a 128-byte swizzled K-major panel; rows at or past L stage zeros.
__device__ __forceinline__ void stage_int8(unsigned char* panel,
                                           const signed char* __restrict__ qs,
                                           int p0, int L, int dq, int k0) {
  for (int e = threadIdx.x; e < ST * 8; e += PR_THREADS) {
    const int r = e >> 3, c = e & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p0 + r < L)
      v = __ldg(reinterpret_cast<const uint4*>(
          qs + static_cast<size_t>(p0 + r) * dq + k0 + 16 * c));
    *reinterpret_cast<uint4*>(panel + r * 128 + ((c ^ (r & 7)) << 4)) = v;
  }
}

// K2i's join: the caller zeroes counts.
__global__ void __launch_bounds__(PR_THREADS, PR_MIN_BLOCKS)
prune_int8_kernel(const signed char* __restrict__ q,
                  const int* __restrict__ n2,
                  const unsigned* __restrict__ maxbits,
                  const int* __restrict__ lengths,
                  const float* __restrict__ radii,
                  const int* __restrict__ elig, int S, int P, int d, int dq,
                  int W, int* __restrict__ counts) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sa = (raw + 1023u) & ~1023u;          // swizzle alignment
  unsigned char* pa = smem_raw + (sa - raw);
  unsigned char* pb = pa + QI_PANEL;
  int* an = reinterpret_cast<int*>(pb + QI_PANEL);      // row norms
  int* bn = an + ST;                                    // column norms
  int* table = bn + ST;
  const RunTable tab{table, table + PR_THREADS + 1,
                     table + 2 * PR_THREADS + 1};

  const int nt = (P + ST - 1) / ST;
  const int runs = (nt * (nt + 1) / 2 + PR_RUN - 1) / PR_RUN;
  const int panels = dq / QI_K, steps = (d + 31) / 32;
  const float sqrtd = __fsqrt_rn(static_cast<float>(d));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int run = S <= PR_SCAN_MAX ? scan_runs(lengths, S, P, tab) : PR_RUN;
  PruneTile cur;
  for (int i = blockIdx.x;
       next_unit(i, lengths, S, P, runs, run, tab, cur);
       i = cur.i + gridDim.x) {
    for (;;) {
      const bool diag = cur.ti == cur.tj;
      const signed char* qs = q + static_cast<size_t>(cur.s) * P * dq;
      int acc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0;
      for (int k = 0; k < panels; ++k) {
        __syncthreads();           // the previous panel's readers are done
        stage_int8(pa, qs, cur.ti * ST, cur.L, dq, k * QI_K);
        if (!diag) stage_int8(pb, qs, cur.tj * ST, cur.L, dq, k * QI_K);
        if (k == 0) {
          const int p = (tid < ST ? cur.ti : cur.tj) * ST + (tid % ST);
          (tid < ST ? an : bn)[tid % ST] =
              p < cur.L ? n2[static_cast<size_t>(cur.s) * P + p] : 0;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        // a diagonal tile reads panel A as both operands
        const uint32_t da = sa, db = diag ? sa : sa + QI_PANEL;
        const int ks = min(QI_K / 32, steps - k * (QI_K / 32));
        wgmma_fence();
        for (int kk = 0; kk < ks; ++kk)
          wgmma_s8_n64(acc, desc_k_major(da + kk * 32),
                       desc_k_major(db + kk * 32), k > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }

      const int* es = elig ? elig + static_cast<size_t>(cur.s) * W : nullptr;
      const bool interior = es == nullptr && (cur.tj + 1) * ST <= cur.L;
      const float scale = int8_scale(maxbits[cur.s]);
      const float rq = __fadd_rn(__fmul_rn(radii[cur.s], scale), sqrtd);
      const int thr = f2i_sat(__fadd_rn(ceilf(__fmul_rn(rq, rq)), 1.0f));
      const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
      const int a0 = an[r0], a1 = an[r0 + 8];
      auto joined = [&](int a, int b, int g) { return a + b - 2 * g <= thr; };
      int cnt = 0;
      if (interior) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + c0;
          cnt += joined(a0, bn[c], acc[4 * j])
                 + joined(a0, bn[c + 1], acc[4 * j + 1])
                 + joined(a1, bn[c], acc[4 * j + 2])
                 + joined(a1, bn[c + 1], acc[4 * j + 3]);
        }
      } else {
        const unsigned long long rl = live_bits(es, cur.ti * ST, cur.L, W);
        const unsigned long long cl = live_bits(es, cur.tj * ST, cur.L, W);
        const bool l0 = (rl >> r0) & 1, l1 = (rl >> (r0 + 8)) & 1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + c0;
          const bool e0 = (cl >> c) & 1, e1 = (cl >> (c + 1)) & 1;
          cnt += (l0 && e0 && joined(a0, bn[c], acc[4 * j]))
                 + (l0 && e1 && joined(a0, bn[c + 1], acc[4 * j + 1]))
                 + (l1 && e0 && joined(a1, bn[c], acc[4 * j + 2]))
                 + (l1 && e1 && joined(a1, bn[c + 1], acc[4 * j + 3]));
        }
      }
      cnt *= diag ? 1 : 2;                     // and the mirrored half
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 16);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 8);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 4);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
      if (lane == 0 && cnt) atomicAdd(counts + cur.s, cnt);

      if (cur.t + 1 >= cur.end) break;         // the unit's next tile
      ++cur.t;
      if (++cur.ti > cur.tj) {
        cur.ti = 0;
        ++cur.tj;
      }
    }
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

// Blocks of a K2 or K2i join launch: twice as many as the card holds at
// once (by the
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

// K2i: maxbits (S,) and counts zeroed by the caller; q (S, P, dq) int8 and
// n2 (S, P) int32 are scratch, dq = ceil(d / 128) * 128.
int join_batched_prune_int8(const float* x, const int* lengths,
                            const float* radii, const int* elig, int S, int P,
                            int d, unsigned* maxbits, signed char* q, int* n2,
                            int* counts, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = static_cast<long long>(P) * d;
  const long long per_block = QI_MAX_THREADS * 16;    // values a block folds
  const long long chunks = (n + per_block - 1) / per_block;
  int8_maxabs_kernel<<<dim3(S, static_cast<unsigned>(
                                   std::min(chunks, 1024LL))),
                       QI_MAX_THREADS, 0, st>>>(x, n, maxbits);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int dq = (d + QI_K - 1) / QI_K * QI_K;
  const long long rows = static_cast<long long>(S) * P;
  const long long qblocks = (rows + PR_THREADS / 32 - 1) / (PR_THREADS / 32);
  int8_quantize_kernel<<<static_cast<unsigned>(qblocks), PR_THREADS, 0, st>>>(
      x, maxbits, S, P, d, dq, q, n2);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  static int per_sm = 0;
  prune_int8_kernel<<<walk_blocks(prune_int8_kernel, QI_SMEM, S, P, per_sm),
                      PR_THREADS, QI_SMEM, st>>>(
      q, n2, maxbits, lengths, radii, elig, S, P, d, dq, (P + 31) / 32,
      counts);
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
// Features of a K2i panel: the caller pads the int8 rows to a multiple.
int join_int8_panel() { return QI_K; }
// Dynamic shared memory a K3 or K4 block takes (ptxas reports static only).
int join_engine_smem() { return RT_SMEM; }

}  // extern "C"
