// Block-wide exclusive scans of one int a thread, for blocks of
// kScanThreads threads (a multiple of 32): a warp scan by shuffles, then
// the warps' totals from `scratch` (kScanThreads / 32 ints of shared
// memory). Every thread of the block must call them; they synchronize
// the block, and `scratch` is free again when they return.
#pragma once

#include <cuda_runtime.h>

namespace ctts {

constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Sum of the values of the threads before this one; *total gets the
// block's sum.
__device__ __forceinline__ int block_excl_sum(int v, int* scratch,
                                              int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) {
    const int s = scratch[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// Max of the values of the threads before this one (-1 for thread 0);
// *total gets the block's max. Values are >= -1.
__device__ __forceinline__ int block_excl_max(int v, int* scratch,
                                              int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x = max(x, y);
  }
  int excl = __shfl_up_sync(kFullMask, x, 1);
  if (lane == 0) excl = -1;
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int all = -1;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) {
    const int s = scratch[w];
    if (w < warp) excl = max(excl, s);
    all = max(all, s);
  }
  __syncthreads();
  *total = all;
  return excl;
}

}  // namespace ctts
