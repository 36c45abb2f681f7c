// Occupancy memos shared by the kernels' launchers (pairwise_l2.cu,
// diameter.cu). The serving runtime and the ingest pipeline launch from
// several host threads, so a memo is read and filled under a lock.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

std::mutex occupancy_mutex;

// Blocks of `kernel` an SM holds at once with `threads` threads and `smem`
// bytes of dynamic shared memory, asked once into the caller's memo (0
// until asked).
template <class Kernel>
int blocks_per_sm(int& memo, Kernel kernel, int threads, int smem) {
  std::lock_guard<std::mutex> lock(occupancy_mutex);
  if (memo == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&memo, kernel, threads,
                                                  smem);
  return memo;
}

}  // namespace
