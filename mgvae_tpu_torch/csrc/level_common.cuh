// Block-level helpers shared by the level kernels (level_slot.cuh,
// level_slot_bwd.cuh and the four level_*.cu that include them). Thread d of
// a block owns feature d; blockDim.x is the feature width rounded up to a
// warp, at most kMaxDim. The struct-tower kernels use kMaxDim and warp_sum
// (struct_common.cuh).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 128;
constexpr int kMaxExperts = 5;
constexpr int kMaxWarps = kMaxDim / 32;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of x over the block, returned to every thread. Two barriers.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  x = warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nwarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Calls f(j) for every row j in [begin, end) with pred(j), in row order.
// Every thread of the block sees the same sequence, so f may hold barriers.
template <class P, class F>
__device__ __forceinline__ void for_each_row(int begin, int end, unsigned* masks, P pred, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int base = begin; base < end; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const bool hit = j < end && pred(j);
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) masks[warp] = m;
    __syncthreads();
    for (int w = 0; w < nwarps; ++w) {
      unsigned mw = masks[w];
      while (mw) {
        const int b = __ffs(mw) - 1;
        mw &= mw - 1;
        f(base + w * 32 + b);
      }
    }
    __syncthreads();
  }
}

// Calls f(j) for every valid row j of a level's edge table whose
// destination slot is `slot`, in row order.
template <class F>
__device__ __forceinline__ void for_each_in_edge(const int* __restrict__ dslot,
                                                 const int* __restrict__ evalid,
                                                 int ep, int slot, unsigned* masks, F f) {
  for_each_row(0, ep, masks, [&](int j) { return evalid[j] != 0 && dslot[j] == slot; }, f);
}

}  // namespace
