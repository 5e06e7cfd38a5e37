// Layout and helpers shared by the struct-tower kernels (struct_towers.cu,
// struct_towers_bwd.cu).
//
// A block owns a tile of kTileRows node rows of one tower (blockIdx.y).
// Warp w owns rows w * kRowsPerWarp .. + kRowsPerWarp - 1 of the tile; lane
// l owns the feature columns d = l + 32 j (j < CPT, CPT = ceil(D / 32)), so
// a row's D features sit in one warp and a row reduction (LayerNorm) is a
// warp reduction.
#pragma once

#include <cuda_runtime.h>

#include "level_common.cuh"  // kMaxDim, warp_sum

namespace {

constexpr int kTileRows = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kRowsPerWarp = kTileRows / kWarpsPerBlock;
constexpr int kChunk = 32;  // weight rows (or columns) staged in shared memory at a time

// Neighbor lists of one direction: node v's neighbors are
// src[start[v]], ..., src[start[v] + count[v] - 1], in that order.
struct NbrList {
  const int* src;
  const int* start;
  const int* count;
};

// out[j] += sum of x[u, l + 32 j] over v's neighbors u, in list order.
template <int CPT>
__device__ __forceinline__ void add_neighbor_sum(const float* __restrict__ x, const NbrList nl,
                                                 int v, int dim, int lane, float (&out)[CPT]) {
  const int first = nl.start[v], count = nl.count[v];
  for (int e = 0; e < count; ++e) {
    const float* row = x + static_cast<size_t>(nl.src[first + e]) * dim;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      if (d < dim) out[j] += row[d];
    }
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

}  // namespace
