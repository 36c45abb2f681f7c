// Candidate-tuple diameters for Hopper (sm_90a): K6.
//
// Replaces the Pallas TPU kernel tuple_diameters of the reference package's
// kernels/diameter.py (whose arithmetic the reference's anchor-star device
// tier inlines in core/distributed.py). For each tuple of q <= 9 points in d
// dimensions it returns r(A), the largest pairwise L2 distance, through the
// norms identity: d2_ij = max(g_ii + g_jj - 2 g_ij, 0) over the tuple's Gram
// matrix g, in fp32, then sqrt(max d2).
//
// Design. One warp owns one tuple. Its lanes stride over the d features, so
// for each member the warp's 32 loads fall on 32 consecutive floats
// (coalesced), and each lane keeps the q(q+1)/2 <= 45 partial dot products of
// the Gram triangle in registers (q is a template parameter, so the
// accumulators are registers, not local memory). A butterfly of shuffles
// sums each partial over the warp, and lane 0 takes the max over the pairs.
// The squared norms are the Gram diagonal itself, so a member repeated in a
// tuple (the padding the TPU kernel's callers use) gives exactly 0 against
// its copy and the tuple keeps its diameter; a one-point tuple has diameter
// 0. The plain version (kernels/ref.py) sums norms and Gram separately and
// in another order: the two agree to the fp32 band of the identity.
//
// Bound on the card. The work is 2 q^2 d flops per tuple (q(q+1) d with the
// symmetric half only) against q d * 4 bytes read, under one flop per byte:
// far below the fp32 ridge of an H100 (67 TFLOP/s over 3.35 TB/s = 20), so
// it is bound by the bytes of its input. Coalesced loads with no reuse are
// what that calls for; at the device tier's shapes (a few thousand tuples)
// the launch, not the bytes, takes most of its time.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int WARPS = 8;                   // tuples per block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_Q = 9;

// Index of Gram entry (i, j), i <= j, in the row-major upper triangle.
__host__ __device__ constexpr int tri(int q, int i, int j) {
  return i * q - i * (i - 1) / 2 + (j - i);
}

template <int Q>
__global__ void __launch_bounds__(THREADS)
tuple_diameters_kernel(const float* __restrict__ pts, long long T, int d,
                       float* __restrict__ out) {
  constexpr int NP = Q * (Q + 1) / 2;
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;                      // the whole warp leaves together
  const float* base = pts + (size_t)t * Q * d;

  float acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0.0f;
#pragma unroll 4
  for (int k = lane; k < d; k += 32) {
    float v[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) v[i] = __ldg(base + (size_t)i * d + k);
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
  if (lane == 0) {
    float best = 0.0f;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
#pragma unroll
      for (int j = i + 1; j < Q; ++j) {
        const float d2 = acc[tri(Q, i, i)] + acc[tri(Q, j, j)]
                         - 2.0f * acc[tri(Q, i, j)];
        best = fmaxf(best, d2);            // fmaxf(0, d2) is the clamp
      }
    }
    out[t] = sqrtf(best);
  }
}

template <int Q>
int launch(const float* pts, long long T, int d, float* out,
           cudaStream_t stream) {
  const long long blocks = (T + WARPS - 1) / WARPS;
  if (blocks == 0) return 0;
  tuple_diameters_kernel<Q><<<(unsigned)blocks, THREADS, 0, stream>>>(
      pts, T, d, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes). pts (T, q, d) fp32 contiguous and
// out (T,) fp32 are device pointers; returns cudaGetLastError() after the
// launch (0 is success), or cudaErrorInvalidValue for q outside 1..9.
extern "C" {

int tuple_diameters(const float* pts, long long T, int q, int d, float* out,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (q) {
    case 1: return launch<1>(pts, T, d, out, s);
    case 2: return launch<2>(pts, T, d, out, s);
    case 3: return launch<3>(pts, T, d, out, s);
    case 4: return launch<4>(pts, T, d, out, s);
    case 5: return launch<5>(pts, T, d, out, s);
    case 6: return launch<6>(pts, T, d, out, s);
    case 7: return launch<7>(pts, T, d, out, s);
    case 8: return launch<8>(pts, T, d, out, s);
    case 9: return launch<9>(pts, T, d, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int tuple_diameters_max_q() { return MAX_Q; }

}  // extern "C"
