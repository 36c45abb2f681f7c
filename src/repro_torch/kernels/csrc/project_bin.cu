// Fused random projection + dual-bin keys for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel project_and_bin of the reference package's
// kernels/project_bin.py (paper eqs. 1-2). For each point x (a row of an
// (N, d) fp32 or bf16 matrix) and each of m <= 8 unit vectors z_j it emits
//   p   = sum_i x_i z_ji                      (fp32; bf16 upcast on load)
//   h1  = floor(p * inv_w)                    (int32)
//   h2  = floor((p - half_w) * inv_w) + c     (int32, the add in fp32)
// with inv_w = fp32(1 / w) (the division in double) and half_w = fp32(w / 2),
// the TPU kernel's rounding points. Outputs are (N, m) row-major: the TPU
// kernel pads m to 128 lanes, which on this card would only multiply the
// bytes written by 64.
//
// Bound on the card. Each point is read once and used for 2 m d flops: at
// the index build's shape (10^6, 64, m = 2) that is 256 MB read and 24 MB
// written against 2.6e8 flops, under one flop per byte, so the kernel is
// bound by the bytes of x (0.084 ms at 3.35 TB/s; the flops take 0.004 ms).
// The design is what a byte-bound pass calls for: coalesced 16-byte loads of
// x with no reuse, z staged once per block in shared memory (m d 4 bytes),
// m accumulators per row in registers (m is a template parameter), and a
// shuffle reduction. A row is owned by a group of L = pow2ceil(d / 4) <= 32
// lanes, so at d = 64 a warp covers two rows per 16-byte step and no lane
// idles; each group carries ROWS rows per step, whose loads are independent
// and in flight together. Where d % 4 != 0 (rows not 16-byte aligned) the
// same loop runs on scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_M = 8;
constexpr int ROWS = 2;                    // rows per lane group per step
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ void load_vec(const float* x, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(x));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* x,
                                         float (&v)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(x));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
}

__device__ __forceinline__ float load_one(const float* x) { return __ldg(x); }

__device__ __forceinline__ float load_one(const __nv_bfloat16* x) {
  return __bfloat162float(*x);
}

// VEC = 4: every row starts 16-byte (fp32) or 8-byte (bf16) aligned and
// d % 4 == 0; VEC = 1: scalar loads for any d.
template <typename T, int M, int VEC>
__global__ void __launch_bounds__(THREADS)
project_bin_kernel(const T* __restrict__ x, const float* __restrict__ z,
                   long long n, int d, int lpr_log2, float inv_w,
                   float half_w, float cf, int* __restrict__ h1,
                   int* __restrict__ h2, float* __restrict__ p) {
  extern __shared__ float zs[];            // (M, d), row-major
  for (int i = threadIdx.x; i < M * d; i += THREADS) zs[i] = z[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int lpr = 1 << lpr_log2;           // lanes per row
  const int sub = lane & (lpr - 1);
  const int grp = lane >> lpr_log2;
  const int gpw = 32 >> lpr_log2;          // row groups per warp
  const int nvec = d / VEC;
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * WARPS;
  const long long per_warp = (long long)gpw * ROWS;

  for (long long row0 = warp * per_warp; row0 < n; row0 += n_warps * per_warp) {
    float acc[ROWS][M];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < M; ++j) acc[r][j] = 0.0f;
    // Rows of one step: consecutive rows go to consecutive lane groups, so
    // a warp's loads for one r cover gpw whole neighbouring rows.
    long long rows[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) rows[r] = row0 + (long long)r * gpw + grp;

    for (int k = sub; k < nvec; k += lpr) {
      float xv[ROWS][VEC];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (rows[r] < n) {
          const T* src = x + (size_t)rows[r] * d + (size_t)k * VEC;
          if constexpr (VEC == 4) {
            load_vec(src, xv[r]);
          } else {
            xv[r][0] = load_one(src);
          }
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) xv[r][e] = 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {
        float zv[VEC];
        if constexpr (VEC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(zs + j * d + k * 4);
          zv[0] = t.x; zv[1] = t.y; zv[2] = t.z; zv[3] = t.w;
        } else {
          zv[0] = zs[j * d + k];
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r][j] = fmaf(xv[r][e], zv[e], acc[r][j]);
      }
    }
    // Butterfly within each lane group: afterwards every lane of the group
    // holds the group's sums.
    for (int off = lpr >> 1; off; off >>= 1) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < M; ++j)
          acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (rows[r] >= n) continue;
      const size_t base = (size_t)rows[r] * M;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        if ((j & (lpr - 1)) != sub) continue;   // spread the stores
        const float pj = acc[r][j];
        p[base + j] = pj;
        h1[base + j] = (int)floorf(pj * inv_w);
        h2[base + j] = (int)(floorf((pj - half_w) * inv_w) + cf);
      }
    }
  }
}

int lanes_log2(int units) {
  int l = 0;
  while ((1 << l) < units && l < 5) ++l;
  return l;
}

template <typename T, int M>
int launch_m(const T* x, const float* z, long long n, int d, float inv_w,
             float half_w, float cf, int* h1, int* h2, float* p, int sms,
             cudaStream_t stream) {
  const bool vec = d % 4 == 0
      && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  const int lpr_log2 = lanes_log2(vec ? d / 4 : d);
  const size_t smem = (size_t)M * d * sizeof(float);
  if (smem > (size_t)MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vec ? project_bin_kernel<T, M, 4> : project_bin_kernel<T, M, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long per_block = (long long)WARPS * (32 >> lpr_log2) * ROWS;
  long long blocks = (n + per_block - 1) / per_block;
  const long long cap = (long long)sms * 8;    // z staged once per block
  if (blocks > cap) blocks = cap;
  if (blocks == 0) return 0;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      x, z, n, d, lpr_log2, inv_w, half_w, cf, h1, h2, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, const float* z, long long n, int d, int m,
           float inv_w, float half_w, float cf, int* h1, int* h2, float* p,
           int sms, cudaStream_t s) {
  switch (m) {
    case 1: return launch_m<T, 1>(x, z, n, d, inv_w, half_w, cf, h1, h2, p, sms, s);
    case 2: return launch_m<T, 2>(x, z, n, d, inv_w, half_w, cf, h1, h2, p, sms, s);
    case 3: return launch_m<T, 3>(x, z, n, d, inv_w, half_w, cf, h1, h2, p, sms, s);
    case 4: return launch_m<T, 4>(x, z, n, d, inv_w, half_w, cf, h1, h2, p, sms, s);
    case 5: return launch_m<T, 5>(x, z, n, d, inv_w, half_w, cf, h1, h2, p, sms, s);
    case 6: return launch_m<T, 6>(x, z, n, d, inv_w, half_w, cf, h1, h2, p, sms, s);
    case 7: return launch_m<T, 7>(x, z, n, d, inv_w, half_w, cf, h1, h2, p, sms, s);
    case 8: return launch_m<T, 8>(x, z, n, d, inv_w, half_w, cf, h1, h2, p, sms, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface (bound with ctypes). x (N, d) fp32 (bf16 = 0) or bf16
// (bf16 = 1), z (m, d) fp32, h1/h2 (N, m) int32 and p (N, m) fp32 are
// contiguous device pointers; sms is the card's multiprocessor count.
// Returns cudaGetLastError() after the launch (0 is success), or
// cudaErrorInvalidValue for m outside 1..8 or z beyond shared memory.
extern "C" {

int project_and_bin(const void* x, int bf16, const float* z, long long n,
                    int d, int m, float inv_w, float half_w, float cf,
                    int* h1, int* h2, float* p, int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), z, n, d, m, inv_w,
                  half_w, cf, h1, h2, p, sms, s);
  return launch(static_cast<const float*>(x), z, n, d, m, inv_w, half_w, cf,
                h1, h2, p, sms, s);
}

int project_and_bin_max_m() { return MAX_M; }

int project_and_bin_max_smem() { return MAX_SMEM; }

}  // extern "C"
