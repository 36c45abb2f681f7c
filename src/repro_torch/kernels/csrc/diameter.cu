// The anchor-star device tier and candidate-tuple diameters for Hopper
// (sm_90a): K6.
//
// Replaces the Pallas TPU kernel tuple_diameters of the reference package's
// kernels/diameter.py, together with the neighbour stage that builds its
// input in the reference's core/distributed.py (_masked_sq_dists and the
// per-keyword argmin loop of nks_anchor_topk, XLA code there). Two entry
// points share one diameter routine:
//
//   anchor_star     <- the anchor-star search of one query: for every anchor
//                      (a point of group 0) the nearest valid point of each
//                      other group, the worst of those squared distances,
//                      and the diameter r(A) of the tuple they form;
//   tuple_diameters <- the TPU kernel itself, r(A) of given (T, q, d) tuples.
//
// Contract. sq(a, b) = max((|a|^2 + |b|^2) - 2 a.b, 0) in fp32; the nearest
// point of group j is the one of least sq among the valid ones, the lowest
// index among equal minima (torch.argmin's rule); a group with no valid
// point gives index 0 at 3.4e38 (the reference's BIG), so the anchor is
// invalid. The diameter is the largest max(g_ii + g_jj - 2 g_ij, 0) over the
// tuple's Gram matrix g, square-rooted: the squared norms are the Gram
// diagonal itself, so a member repeated in a tuple gives exactly 0 against
// its copy and a one-point tuple has diameter 0.
//
// Design of anchor_star (two launches; no (A, R) block ever exists). The
// neighbour stage is a product of the anchors against each group with a
// row-wise argmin for epilogue: A * R * d fp32 FMAs per group, which the
// plain version spends a cuBLAS product and ten passes over an (A, R) fp32
// block on. Here a persistent grid walks units of (group j, a run of up to
// 32 column tiles of 128 points of group j, a tile of 128 anchors). A block
// of 256 threads stages the anchor tile once a unit (d <= 128: all
// features, point-major, rows padded to 4 mod 32 floats) and streams the
// column tiles through a ring of two or three stages filled by 16-byte
// cp.async copies (4-byte copies when d is not a multiple of 4), issued
// stages ahead, one barrier a stage; for d > 128 anchors and columns are
// staged 64 features at a time (half the stages, and barriers, of 32 at
// the embedded corpus's d = 2304). Each thread holds an 8 x 8 register tile
// of dot products and, per 4 features, reads its 8 rows and 8 columns as
// float4: 16 shared loads per 256 FMAs. The epilogue stays in registers:
// per row a running (value, index), which visits its columns in increasing
// index order and so keeps the lowest index among equal minima by a strict
// <; the 16 threads of a row merge by shuffles, and a unit's result is
// merged with the other units of its row by atomicMin on the key
// (float bits << 32) | index in a (A, q - 1) uint64 buffer, whose order is
// exactly "least value, then lowest index", since non-negative floats order
// as their bits (the clamp writes +0, never -0). The wrapper sets the keys
// to all ones with a memset before the launch.
//
// Sparse groups. The served queries pair thousands of anchors with groups
// of a handful of points padded to R (a q=9 query: 40,129 anchors against
// groups of 2,961, 23, 4, 2, 2, 1, 2 and 1 points in R = 40,192), so the
// kernel works by what is valid, read from the mask: a block votes the
// liveness of every anchor tile, and of every column tile of the other
// groups, into shared bitmaps at its start, skips a run of column tiles
// with no valid point in one step (to its first unit of the next run),
// walks only the live tiles of a run, and within a tile multiplies only the
// live 32-column sub-tiles (a warp holds all 128 columns, so its votes need
// no barrier). Where few runs are live (the q=9 query's groups fill 8 of
// 80 runs of 32 column tiles, one of them with 24 live tiles), a unit
// takes one of S parts of its run's live tiles, split by rank: S is the
// least that gives NN_UNITS_PER_BLOCK live units a resident block, counted
// from the votes, so a shard's eighth of the anchors still fills the card.
// Every block computes the same S from the same votes, and the split
// changes no result. A tile with no valid anchor
// keeps the all-ones keys and reads as index 0 at BIG, so those anchors are
// ranked out as invalid. The second launch decodes the keys, one warp an
// anchor, and computes the tuple's diameter straight from the group rows
// (no (A, q, d) tuple tensor).
//
// Exact ties. A point's squared norm and its dot products are fp32 FMA
// chains over the features in order, the same for every column, tile and
// unit, so equal points give equal sq bits wherever they lie, and a point
// equal to the anchor gives exactly 0. The units of a row may run in any
// order; atomicMin on the key is order-free.
//
// Anchor ranges. A call may score only anchors a0 .. a0 + A - 1 of group 0
// (a shard's slice on the serving plane): its anchor tiles start at a0,
// which need not be a multiple of 128, while the other groups stay whole.
// An anchor's arithmetic depends on nothing but its own row and the
// columns, so the rows of a range equal the same rows of the whole call bit
// for bit, wherever its valid anchors fall; only the rows of anchors whose
// whole tile is masked, which the caller ranks out, may differ.
//
// Bound on the card. The neighbour stage needs 2 d flops per (valid anchor,
// valid point of another group) pair: at d = 64 that is 1.9 ps per pair at
// 67 TFLOP/s (fp32 outside the tensor cores: the host's band is fp32's),
// against 4 d bytes read once per valid point, so it is bound by operations
// once the other groups hold a few dozen valid points (the served q=9 and
// d=2304 inputs), by bytes below that (the served q=3 input, two groups of
// 4 points). The diameter stage adds 2 q^2 d flops and q d * 4 bytes per
// anchor: bound by bytes.
//
// tuple_diameters, the standalone entry: one warp owns one tuple. Its lanes
// stride over the d features, so for each member the warp's 32 loads fall on
// 32 consecutive floats (coalesced), and each lane keeps the q(q+1)/2 <= 45
// partial dot products of the Gram triangle in registers (q is a template
// parameter); a butterfly of shuffles sums each partial over the warp. Its
// work is under one flop per byte, far below the H100's fp32 ridge (67
// TFLOP/s over 3.35 TB/s = 20): bound by the bytes of its input.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "occupancy.cuh"

namespace {

constexpr int WARPS = 8;                   // tuples (anchors) per block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_Q = 9;
constexpr float BIG = 3.4e38f;             // the score of a masked point

// Index of Gram entry (i, j), i <= j, in the row-major upper triangle.
__host__ __device__ constexpr int tri(int q, int i, int j) {
  return i * q - i * (i - 1) / 2 + (j - i);
}

// r(A) of the Q rows (each d floats) by the calling warp: the Gram triangle
// summed over lanes striding the features, then the norms identity. Every
// lane returns the same value.
template <int Q>
__device__ __forceinline__ float warp_diameter(const float* const (&rows)[Q],
                                               int d, int lane) {
  constexpr int NP = Q * (Q + 1) / 2;
  float acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0.0f;
#pragma unroll 4
  for (int k = lane; k < d; k += 32) {
    float v[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) v[i] = __ldg(rows[i] + k);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
#pragma unroll
      for (int j = i; j < Q; ++j) {
        const int p = tri(Q, i, j);
        acc[p] = fmaf(v[i], v[j], acc[p]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], off);
  }
  float best = 0.0f;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
#pragma unroll
    for (int j = i + 1; j < Q; ++j) {
      const float d2 = acc[tri(Q, i, i)] + acc[tri(Q, j, j)]
                       - 2.0f * acc[tri(Q, i, j)];
      best = fmaxf(best, d2);              // fmaxf(0, d2) is the clamp
    }
  }
  return sqrtf(best);
}

template <int Q>
__global__ void __launch_bounds__(THREADS)
tuple_diameters_kernel(const float* __restrict__ pts, long long T, int d,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;                      // the whole warp leaves together
  const float* rows[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) rows[i] = pts + ((size_t)t * Q + i) * d;
  const float r = warp_diameter<Q>(rows, d, lane);
  if (lane == 0) out[t] = r;
}

// ---- anchor_star: the neighbour stage -------------------------------------

constexpr int NN_TILE = 128;               // anchors a tile, points a column
constexpr int NN_THREADS = 256;
constexpr int NN_CG = 16;                  // column groups (threads a row)
constexpr int NN_RG = NN_THREADS / NN_CG;  // row groups
constexpr int NN_RT = NN_TILE / NN_RG;     // rows a thread: rg + 16 i
constexpr int NN_CT = NN_TILE / NN_CG;     // columns a thread: cg + 16 u
constexpr int NN_PANEL = 64;               // features a stage for d > 128

static_assert(NN_RT == 8 && NN_CT == 8, "an 8 x 8 register tile a thread");

// Words of the block's bitmap of live anchor tiles: 65,536 tiles, so R is
// at most 2^23 points (8,388,608).
constexpr int NN_MAP_WORDS = 2048;
constexpr int NN_MAX_R = 32 * NN_MAP_WORDS * NN_TILE;
// Words of the block's table of live column tiles, one a run of each other
// group: the table (and the split of runs into parts) is used where the
// runs fit, else each run is voted when a block reaches it, in one part.
constexpr int NN_RUN_WORDS = 512;
// The live units a resident block that the split of runs aims at.
constexpr int NN_UNITS_PER_BLOCK = 4;

// Shared memory of anchor_star_nn_kernel<KP, RES>: the anchor tile (one
// copy of all KP features if RES, else a ring of KP-feature panels), a ring
// of STAGES column-tile stages, the squared norms of the anchors and of
// the current column tile, the bitmap of live anchor tiles, the table of
// live column tiles a run and a histogram of its counts. Rows are
// KP + 4 floats (4 mod 32 for KP a multiple of 32): a warp's 16 column rows
// read as float4 fall in distinct banks, two wavefronts. The ring is as
// deep as 227 KB allows.
template <int KP, bool RES>
struct NnLayout {
  static constexpr int LD = KP + 4;
  static constexpr int STAGES = KP <= 64 ? 3 : 2;
  static constexpr int A_ROWS = (RES ? 1 : STAGES) * NN_TILE;
  static constexpr int B_ROWS = STAGES * NN_TILE;
  static constexpr int BYTES =
      ((A_ROWS + B_ROWS) * LD + 2 * NN_TILE + NN_MAP_WORDS + NN_RUN_WORDS
       + 33) * 4;
};

// A unit's stages in order: panel p of column tile t, for each live tile
// (the bits of `live`, relative to tile t0, not yet visited) and each of
// the tile's `panels` panels.
struct StageWalk {
  int t, p;
  unsigned live;
  bool valid;

  __device__ __forceinline__ void advance(int t0, int panels) {
    if (++p < panels) return;
    p = 0;
    valid = live != 0;
    t = t0 + __ffs(live) - 1;
    live &= live - 1;
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of features [k0, k0 + KP) of points [p0, p0 + 128) of
// a point-major (R, d) group into dst (rows of LD floats); points at or past
// R and features at or past d are zero. vec: d % 4 == 0 and a 16-byte
// aligned base, so each copy moves 4 features.
template <int KP, int LD>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ g,
                                           int p0, int R, int d, int k0,
                                           bool vec) {
  if (vec) {
    constexpr int CH = KP / 4;
    for (int e = threadIdx.x; e < NN_TILE * CH; e += NN_THREADS) {
      const int r = e / CH, k = (e % CH) * 4;
      const bool ok = p0 + r < R && k0 + k < d;
      cp_async16(dst + r * LD + k, ok ? g + (size_t)(p0 + r) * d + k0 + k : g,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < NN_TILE * KP; e += NN_THREADS) {
      const int r = e / KP, k = e % KP;
      const bool ok = p0 + r < R && k0 + k < d;
      cp_async4(dst + r * LD + k, ok ? g + (size_t)(p0 + r) * d + k0 + k : g,
                ok);
    }
  }
}

// Whether the tile of 128 points at p0 has a valid point, by one thread:
// eight 16-byte loads where the tile is whole and aligned.
__device__ __forceinline__ bool tile_has_valid(
    const unsigned char* __restrict__ m, int p0, int R) {
  const unsigned char* p = m + p0;
  if (p0 + NN_TILE <= R && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
    uint4 v = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < NN_TILE / 16; ++e) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + e);
      v.x |= w.x;
      v.y |= w.y;
      v.z |= w.z;
      v.w |= w.w;
    }
    return (v.x | v.y | v.z | v.w) != 0;
  }
  bool any = false;
  for (int e = 0; e < NN_TILE && p0 + e < R; ++e) any |= __ldg(p + e) != 0;
  return any;
}

// The live column tiles among [t0, t0 + n), n <= 32, as bits (bit l: tile
// t0 + l has a valid point), lane l testing tile t0 + l, one ballot a warp.
// Every warp computes the same bits.
__device__ __forceinline__ unsigned live_tiles(
    const unsigned char* __restrict__ m, int t0, int n, int R) {
  const int lane = threadIdx.x & 31;
  const bool any = lane < n && tile_has_valid(m, (t0 + lane) * NN_TILE, R);
  return __ballot_sync(0xffffffffu, any);
}

// Column tiles a unit at most (one warp's ballot of live tiles).
constexpr int NN_MAX_TILES = 32;

// s plus the squares of the KP features at p, one FMA each, in order.
template <int KP>
__device__ __forceinline__ float norm_chain(const float* p, float s) {
#pragma unroll 4
  for (int k = 0; k < KP; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  return s;
}

// acc[i][v] += <anchor rg + 16 i, column cg + 16 v> over the KP features
// of a stage, for v in [V0, V1): per 4 features each column as one float4,
// then each row as one float4 against all of them.
template <int KP, int LD, int V0, int V1>
__device__ __forceinline__ void gram_step(float (&acc)[NN_RT][NN_CT],
                                          const float* A, const float* B,
                                          int rg, int cg) {
#pragma unroll 2
  for (int k = 0; k < KP; k += 4) {
    float4 bv[NN_CT];
#pragma unroll
    for (int v = V0; v < V1; ++v)
      bv[v] = *reinterpret_cast<const float4*>(B + (cg + NN_CG * v) * LD + k);
#pragma unroll
    for (int i = 0; i < NN_RT; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(A + (rg + NN_RG * i) * LD + k);
#pragma unroll
      for (int v = V0; v < V1; ++v) {
        acc[i][v] = fmaf(av.x, bv[v].x, acc[i][v]);
        acc[i][v] = fmaf(av.y, bv[v].y, acc[i][v]);
        acc[i][v] = fmaf(av.z, bv[v].z, acc[i][v]);
        acc[i][v] = fmaf(av.w, bv[v].w, acc[i][v]);
      }
    }
  }
}

// gram_step over sub-tile h only (columns 32 h .. 32 h + 31: v = 2h, 2h+1),
// h a compile-time index after unrolling, so acc stays in registers.
template <int KP, int LD>
__device__ __forceinline__ void gram_sub(float (&acc)[NN_RT][NN_CT],
                                         const float* A, const float* B,
                                         int rg, int cg, int h) {
  switch (h) {
    case 0: gram_step<KP, LD, 0, 2>(acc, A, B, rg, cg); break;
    case 1: gram_step<KP, LD, 2, 4>(acc, A, B, rg, cg); break;
    case 2: gram_step<KP, LD, 4, 6>(acc, A, B, rg, cg); break;
    default: gram_step<KP, LD, 6, 8>(acc, A, B, rg, cg); break;
  }
}

// The neighbour stage over the anchor range [a0, a0 + A) of group 0, in
// tiles of 128 anchors that start at a0 (n_at = ceil(A / 128) of them).
// Unit u = (((j - 1) n_chunks + c) S + s) n_at + at covers anchor tile at
// against part s of S of the live tiles among column tiles [c ct,
// (c + 1) ct) of group j (ct <= NN_MAX_TILES), the parts split by rank;
// the column tiles cover all R points of group j whatever the range. A
// block takes units blockIdx.x + k gridDim.x. At its start it votes the
// liveness of every anchor tile into a bitmap and, where the (q - 1)
// n_chunks runs fit NN_RUN_WORDS, of every column tile into a table a run,
// from which it chooses S (else S = 1 and it votes a run when it reaches
// it); it skips a run with no valid point at once. KP is the features a stage holds; RES
// (d <= KP): the anchor tile is staged once a unit and a column tile is one
// stage; else (KP = 64) a tile takes ceil(d / 64) stages of both. The
// stages of a unit stream through the ring STAGES - 1 ahead of the one in
// use, one barrier a stage. keys (R, q - 1) hold all ones on entry.
template <int KP, bool RES>
__global__ void __launch_bounds__(NN_THREADS, 1)
anchor_star_nn_kernel(const float* __restrict__ groups,
                      const unsigned char* __restrict__ mask, int q, int R,
                      int d, int a0, int A, int ct, int n_chunks,
                      unsigned long long* __restrict__ keys) {
  using L = NnLayout<KP, RES>;
  constexpr int LD = L::LD;
  constexpr int NS = L::STAGES;
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                              // anchors
  float* sb = smem + L::A_ROWS * LD;             // column stages
  float* s_an = sb + L::B_ROWS * LD;
  float* s_bn = s_an + NN_TILE;

  const int tid = threadIdx.x;
  const int rg = tid / NN_CG, cg = tid % NN_CG;
  const int n_tiles = (R + NN_TILE - 1) / NN_TILE;
  const int n_at = (A + NN_TILE - 1) / NN_TILE;
  const int panels = RES ? 1 : (d + KP - 1) / KP;
  // vec holds for the anchors too: a0 d floats keep a 16-byte alignment
  // when d % 4 == 0.
  const bool vec = d % 4 == 0
                   && reinterpret_cast<uintptr_t>(groups) % 16 == 0;
  const int n_runs = (q - 1) * n_chunks;
  const bool table = n_runs <= NN_RUN_WORDS;
  const long long G = gridDim.x;
  const float* g0 = groups + (size_t)a0 * d;     // anchor a0 first
  const unsigned char* m0 = mask + a0;
  unsigned* s_map = reinterpret_cast<unsigned*>(s_bn + NN_TILE);
  unsigned* s_run = s_map + NN_MAP_WORDS;        // live tiles a run
  int* s_hist = reinterpret_cast<int*>(s_run + NN_RUN_WORDS);
  if (tid <= 32) s_hist[tid] = 0;                // runs by live tiles
  __syncthreads();
  for (int w = tid >> 5; w < (n_at + 31) / 32; w += NN_THREADS / 32)
    s_map[w] = live_tiles(m0, 32 * w, min(32, n_at - 32 * w), A);
  if (table) {
    for (int w = tid >> 5; w < n_runs; w += NN_THREADS / 32) {
      const int j = 1 + w / n_chunks, t0 = (w % n_chunks) * ct;
      const unsigned v =
          live_tiles(mask + (size_t)j * R, t0, min(ct, n_tiles - t0), R);
      if ((tid & 31) == 0) {
        s_run[w] = v;
        atomicAdd(&s_hist[__popc(v)], 1);
      }
    }
  }
  __syncthreads();
  // S: the least split whose live units, sum over runs of min(live tiles,
  // S) n_at, reach NN_UNITS_PER_BLOCK a block (at most ct, and at most the
  // live tiles of the fullest run: more parts would all be empty).
  int S = 1;
  if (table) {
    int max_l = 0;
    for (int l = 1; l <= 32; ++l)
      if (s_hist[l]) max_l = l;
    for (; S < ct && S < max_l; ++S) {
      long long live_units = 0;
      for (int l = 1; l <= 32; ++l)
        live_units += (long long)s_hist[l] * min(l, S);
      if (live_units * n_at >= NN_UNITS_PER_BLOCK * G) break;
    }
  }
  const long long units = (long long)n_runs * S * n_at;

  long long cached = -1;                         // the run `live` is of
  unsigned live = 0;
  for (long long u = blockIdx.x; u < units; u += G) {
    const long long js = u / n_at;               // jc S + s
    const int at = static_cast<int>(u - js * n_at);
    const long long jc = js / S;                 // (j - 1) n_chunks + c
    const int s = static_cast<int>(js - jc * S);
    const int c = static_cast<int>(jc % n_chunks);
    const int j = 1 + static_cast<int>(jc / n_chunks);
    const int row0 = at * NN_TILE;
    const float* gj = groups + (size_t)j * R * d;
    const unsigned char* mj = mask + (size_t)j * R;
    const int t0 = c * ct;
    if (jc != cached) {
      live = table ? s_run[jc]
                   : live_tiles(mj, t0, min(ct, n_tiles - t0), R);
      cached = jc;
    }
    if (!live) {         // no valid point: on to our first unit of the next
      const long long base = (jc + 1) * S * n_at;      // run
      u = base + ((blockIdx.x - base) % G + G) % G - G;
      continue;
    }
    if (!(s_map[at >> 5] >> (at & 31) & 1)) continue;   // no valid anchor
    unsigned part = live;                        // the live tiles of rank
    if (S > 1) {                                 // [s L / S, (s + 1) L / S)
      const int L = __popc(live);
      const int lo = s * L / S, hi = (s + 1) * L / S;
      if (lo == hi) continue;
      for (int k = 0; k < lo; ++k) part &= part - 1;
      unsigned rest = part;
      for (int k = lo; k < hi; ++k) rest &= rest - 1;
      part ^= rest;
    }

    // Prologue: the anchor tile (RES) and the first NS - 1 stages, one
    // commit group each (empty past the last stage).
    StageWalk prod{t0 + __ffs(part) - 1, 0, part & (part - 1), true};
    StageWalk cons = prod;
    if (RES) stage_rows<KP, LD>(sa, g0, row0, A, d, 0, vec);
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) {
      if (prod.valid) {
        if (!RES)
          stage_rows<KP, LD>(sa + st * NN_TILE * LD, g0, row0, A, d,
                             prod.p * KP, vec);
        stage_rows<KP, LD>(sb + st * NN_TILE * LD, gj, prod.t * NN_TILE, R,
                           d, prod.p * KP, vec);
      }
      cp_async_commit();
      prod.advance(t0, panels);
    }

    float acc[NN_RT][NN_CT];
#pragma unroll
    for (int i = 0; i < NN_RT; ++i)
#pragma unroll
      for (int v = 0; v < NN_CT; ++v) acc[i][v] = 0.f;
    float best_v[NN_RT];
    int best_i[NN_RT];
#pragma unroll
    for (int i = 0; i < NN_RT; ++i) {
      best_v[i] = __int_as_float(0x7f800000);   // +inf: no candidate yet
      best_i[i] = 0x7fffffff;
    }
    // Squared norms of anchor and column tid (tid < 128), summed from the
    // staged features as chains of FMAs in feature order, as every dot
    // product below is: equal points get equal bits, and a point equal to
    // its anchor exactly 0.
    float anorm = 0.f, bnorm = 0.f;
    bool first_tile = true;
    bool ok[NN_CT];                              // this thread's columns
    unsigned sub = 0;                            // live 32-column sub-tiles
    int slot = 0;
    for (;;) {
      cp_async_wait<NS - 2>();                   // stage `cons` has landed
      __syncthreads();                           // ... for every thread
      {
        // The stage NS - 1 ahead, into the slot the previous one used.
        const int ps = slot == 0 ? NS - 1 : slot - 1;
        if (prod.valid) {
          if (!RES)
            stage_rows<KP, LD>(sa + ps * NN_TILE * LD, g0, row0, A, d,
                               prod.p * KP, vec);
          stage_rows<KP, LD>(sb + ps * NN_TILE * LD, gj, prod.t * NN_TILE,
                             R, d, prod.p * KP, vec);
        }
        cp_async_commit();
        prod.advance(t0, panels);
      }
      const bool last = cons.p == panels - 1;    // the tile completes here
      const int col0 = cons.t * NN_TILE;
      if (cons.p == 0) {
        // A warp holds all 128 columns (16 column groups x 8): its votes
        // give the tile's live sub-tiles, the same in every warp.
        sub = 0;
#pragma unroll
        for (int v = 0; v < NN_CT; ++v) {
          const int col = col0 + cg + NN_CG * v;
          ok[v] = col < R && __ldg(mj + col) != 0;
        }
#pragma unroll
        for (int h = 0; h < NN_CT / 2; ++h)
          sub |= __any_sync(0xffffffffu, ok[2 * h] || ok[2 * h + 1]) << h;
      }

      const float* A = RES ? sa : sa + slot * NN_TILE * LD;
      const float* B = sb + slot * NN_TILE * LD;
      if (tid < NN_TILE) {
        bnorm = norm_chain<KP>(B + tid * LD, bnorm);
        if (first_tile) anorm = norm_chain<KP>(A + tid * LD, anorm);
      }
      if (sub == (1u << NN_CT / 2) - 1) {
        gram_step<KP, LD, 0, NN_CT>(acc, A, B, rg, cg);
      } else {                 // sparse columns: only the live sub-tiles
#pragma unroll
        for (int h = 0; h < NN_CT / 2; ++h)
          if (sub >> h & 1) gram_sub<KP, LD>(acc, A, B, rg, cg, h);
      }

      if (last) {
        if (tid < NN_TILE) {
          s_bn[tid] = bnorm;
          bnorm = 0.f;
          if (first_tile) s_an[tid] = anorm;
        }
        first_tile = false;
        __syncthreads();
        float bn[NN_CT];
#pragma unroll
        for (int v = 0; v < NN_CT; ++v) bn[v] = s_bn[cg + NN_CG * v];
#pragma unroll
        for (int i = 0; i < NN_RT; ++i) {
          const float an = s_an[rg + NN_RG * i];
#pragma unroll
          for (int v = 0; v < NN_CT; ++v) {
            // one rounding after the sum, as (na + nb) - 2 a.b in fp32
            const float e = __fmaf_rn(-2.0f, acc[i][v], __fadd_rn(an, bn[v]));
            const float s = e > 0.f ? e : 0.f;    // +0, never -0
            if (ok[v] && s < best_v[i]) {          // columns ascend: the
              best_v[i] = s;                       // lowest index wins ties
              best_i[i] = col0 + cg + NN_CG * v;
            }
            acc[i][v] = 0.f;
          }
        }
      }
      cons.advance(t0, panels);
      if (!cons.valid) break;
      slot = slot + 1 == NS ? 0 : slot + 1;
    }
    cp_async_wait<0>();
    __syncthreads();                             // smem free for the next unit

    // The 16 threads of a row (lanes of one half-warp) merge, then one
    // atomic a row merges the units.
#pragma unroll
    for (int i = 0; i < NN_RT; ++i) {
      float bv = best_v[i];
      int bi = best_i[i];
#pragma unroll
      for (int off = NN_CG / 2; off; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov < bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      const int row = row0 + rg + NN_RG * i;     // in the range
      if (cg == 0 && row < A && bi < R) {        // bi < R: a candidate
        const unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(bv)) << 32)
            | static_cast<unsigned>(bi);
        atomicMin(keys + (size_t)row * (q - 1) + (j - 1), key);
      }
    }
  }
}

// The diameter stage: one warp an anchor of the range [a0, a0 + A). Decodes
// its q - 1 keys into the neighbour indices and the worst squared distance,
// and takes the tuple's diameter from the group rows themselves. Output row
// a is anchor a0 + a; nn holds indices into the groups (nn[a][0] = a0 + a).
template <int Q>
__global__ void __launch_bounds__(THREADS)
anchor_star_diam_kernel(const float* __restrict__ groups,
                        const unsigned long long* __restrict__ keys, int R,
                        int d, int a0, int A, int* __restrict__ nn,
                        float* __restrict__ worst, float* __restrict__ diam) {
  const int lane = threadIdx.x & 31;
  const long long a = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (a >= A) return;
  const float* rows[Q];
  int idx[Q];
  rows[0] = groups + (size_t)(a0 + a) * d;
  idx[0] = static_cast<int>(a0 + a);
  float w = 0.f;
#pragma unroll
  for (int j = 1; j < Q; ++j) {
    const unsigned long long key = __ldg(keys + (size_t)a * (Q - 1) + j - 1);
    const bool none = key == ~0ull;            // no valid point: BIG at 0
    idx[j] = none ? 0 : static_cast<int>(key & 0xffffffffu);
    w = fmaxf(w, none ? BIG
                      : __uint_as_float(static_cast<unsigned>(key >> 32)));
    rows[j] = groups + ((size_t)j * R + idx[j]) * d;
  }
  const float r = warp_diameter<Q>(rows, d, lane);
#pragma unroll
  for (int j = 0; j < Q; ++j)
    if (lane == j) nn[(size_t)a * Q + j] = idx[j];
  if (lane == 0) {
    worst[a] = w;
    diam[a] = r;
  }
}

template <int Q>
int launch_diameters(const float* pts, long long T, int d, float* out,
                     cudaStream_t stream) {
  const long long blocks = (T + WARPS - 1) / WARPS;
  if (blocks == 0) return 0;
  tuple_diameters_kernel<Q><<<(unsigned)blocks, THREADS, 0, stream>>>(
      pts, T, d, out);
  return static_cast<int>(cudaGetLastError());
}

// Column tiles a unit: about 2^18 floats of column points (32 tiles at
// d = 64, one at d >= 2048), fewer where that would leave under four units a
// resident block; a positive `ct` is taken as given; at most NN_MAX_TILES.
// The split changes no result: each anchor's value and index are the same
// whichever unit, tile or range holds its columns.
int tiles_per_unit(int ct, int q, int R, int A, int d, int resident) {
  if (ct > 0) return ct < NN_MAX_TILES ? ct : NN_MAX_TILES;
  const long long n = (R + NN_TILE - 1) / NN_TILE;
  const long long tiles = (long long)(q - 1) * ((A + NN_TILE - 1) / NN_TILE)
                          * n;
  long long c = (1 << 18) / ((long long)NN_TILE * d);
  c = c < tiles / (4LL * resident) ? c : tiles / (4LL * resident);
  c = c < n ? c : n;
  c = c < NN_MAX_TILES ? c : NN_MAX_TILES;
  return static_cast<int>(c > 1 ? c : 1);
}

template <int KP, bool RES>
int launch_nn(const float* groups, const unsigned char* mask, int q, int R,
              int d, int a0, int A, int ct, unsigned long long* keys,
              cudaStream_t stream) {
  using L = NnLayout<KP, RES>;
  auto kernel = anchor_star_nn_kernel<KP, RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int memo = 0;  // a property of the kernel, asked once
  const int per_sm = blocks_per_sm(memo, kernel, NN_THREADS, L::BYTES);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  ct = tiles_per_unit(ct, q, R, A, d, resident);
  const int n = (R + NN_TILE - 1) / NN_TILE;
  const int n_chunks = (n + ct - 1) / ct;
  // The kernel splits a run into at most ct parts.
  const long long units =
      (long long)(q - 1) * ((A + NN_TILE - 1) / NN_TILE) * n_chunks * ct;
  const int grid = static_cast<int>(units < resident ? units : resident);
  kernel<<<grid, NN_THREADS, L::BYTES, stream>>>(groups, mask, q, R, d, a0, A,
                                                 ct, n_chunks, keys);
  return static_cast<int>(cudaGetLastError());
}

template <int Q>
int launch_star(const float* groups, const unsigned char* mask, int R, int d,
                int a0, int A, int ct, unsigned long long* keys, int* nn,
                float* worst, float* diam, cudaStream_t stream) {
  if (Q > 1) {
    cudaError_t err = cudaMemsetAsync(
        keys, 0xff, (size_t)A * (Q - 1) * sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int res =
        d <= 64
            ? launch_nn<64, true>(groups, mask, Q, R, d, a0, A, ct, keys,
                                  stream)
        : d <= 128
            ? launch_nn<128, true>(groups, mask, Q, R, d, a0, A, ct, keys,
                                   stream)
            : launch_nn<NN_PANEL, false>(groups, mask, Q, R, d, a0, A, ct,
                                         keys, stream);
    if (res) return res;
  }
  anchor_star_diam_kernel<Q><<<(A + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      groups, keys, R, d, a0, A, nn, worst, diam);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers are device pointers; each
// function returns cudaGetLastError() after its launches (0 is success), or
// cudaErrorInvalidValue for q outside 1..9.
extern "C" {

// pts (T, q, d) fp32 contiguous, out (T,) fp32.
int tuple_diameters(const float* pts, long long T, int q, int d, float* out,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (q) {
    case 1: return launch_diameters<1>(pts, T, d, out, s);
    case 2: return launch_diameters<2>(pts, T, d, out, s);
    case 3: return launch_diameters<3>(pts, T, d, out, s);
    case 4: return launch_diameters<4>(pts, T, d, out, s);
    case 5: return launch_diameters<5>(pts, T, d, out, s);
    case 6: return launch_diameters<6>(pts, T, d, out, s);
    case 7: return launch_diameters<7>(pts, T, d, out, s);
    case 8: return launch_diameters<8>(pts, T, d, out, s);
    case 9: return launch_diameters<9>(pts, T, d, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// groups (q, R, d) fp32 contiguous, mask (q, R) bytes (0 or 1),
// 1 <= R <= anchor_star_max_r(); the anchors a0 .. a0 + A - 1 of group 0,
// 0 <= a0, 1 <= A, a0 + A <= R; keys (A, q - 1) uint64 scratch (unused for
// q = 1); outputs nn (A, q) int32, worst (A,) and diam (A,) fp32, row a for
// anchor a0 + a. ct > 0 fixes the column tiles a unit of the neighbour
// stage (at most 32; else chosen from the shape). Launches the neighbour
// stage (q >= 2, after a memset of keys) and the diameter stage.
int anchor_star(const float* groups, const unsigned char* mask, int q, int R,
                int d, int a0, int A, int ct, unsigned long long* keys,
                int* nn, float* worst, float* diam, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R < 1 || R > NN_MAX_R || a0 < 0 || A < 1 || a0 > R - A)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (q) {
#define STAR(Q) \
    case Q: return launch_star<Q>(groups, mask, R, d, a0, A, ct, keys, nn, \
                                  worst, diam, s);
    STAR(1) STAR(2) STAR(3) STAR(4) STAR(5) STAR(6) STAR(7) STAR(8) STAR(9)
#undef STAR
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int tuple_diameters_max_q() { return MAX_Q; }

int anchor_star_max_r() { return NN_MAX_R; }

}  // extern "C"
