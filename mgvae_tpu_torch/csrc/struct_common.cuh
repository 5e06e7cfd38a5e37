// Layout and helpers shared by the struct-tower kernels (struct_towers.cu,
// struct_towers_bwd.cu).
//
// In both, lane l of a warp owns the feature columns d = l + 32 j (j < CPT,
// CPT = ceil(D / 32)) of the rows the warp owns, so a row's D features sit in
// one warp and a row reduction (LayerNorm) is a warp reduction. Each kernel
// sets its own tile (rows a warp, warps a block).
#pragma once

#include <cuda_runtime.h>

#include "level_common.cuh"  // kMaxDim, warp_sum

namespace {

// Neighbor lists of one direction: node v's neighbors are
// src[start[v]], ..., src[start[v] + count[v] - 1], in that order.
struct NbrList {
  const int* src;
  const int* start;
  const int* count;
};

// For one warp: add(u, v) for every neighbor w of the rows v0 + u (u <
// ROWS; rows >= n have none), v[j] = x[w, l + 32 j] in fp32 (0 past dim;
// x holds float or bf16, level_common.cuh), each
// row's neighbors in list order. Three round trips for all the rows
// together: lanes u < ROWS read the rows' start / count, lane e reads the
// index of the e-th entry of the rows' concatenated lists, and then every
// lane reads its columns of kGatherBatch neighbor rows at once. `u` is the
// same on every lane.
constexpr int kGatherBatch = 8;

template <int ROWS, int CPT, class T, class Add>
__device__ __forceinline__ void for_each_neighbor(const T* __restrict__ x, const NbrList nl,
                                                  int v0, int n, int dim, int lane, Add add) {
  static_assert(ROWS <= 32, "one lane per row");
  constexpr unsigned kAll = 0xffffffffu;
  int first = 0, cnt = 0;
  if (lane < ROWS && v0 + lane < n) {
    first = nl.start[v0 + lane];
    cnt = nl.count[v0 + lane];
  }
  int incl = cnt;  // inclusive prefix of the rows' counts
#pragma unroll
  for (int o = 1; o < ROWS; o <<= 1) {
    const int y = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += y;
  }
  const int total = __shfl_sync(kAll, incl, ROWS - 1);
  const int excl = incl - cnt;
  for (int e0 = 0; e0 < total; e0 += 32) {
    // entry e0 + lane belongs to the last row whose list starts at or before it
    const int e = e0 + lane;
    int row = 0;
#pragma unroll
    for (int u = 1; u < ROWS; ++u) row += e >= __shfl_sync(kAll, excl, u) ? 1 : 0;
    const int f = __shfl_sync(kAll, first, row), base = __shfl_sync(kAll, excl, row);
    const int idx = e < total ? nl.src[f + e - base] : 0;
    const int m = min(32, total - e0);
    for (int b = 0; b < m; b += kGatherBatch) {
      float val[kGatherBatch][CPT];
      int rw[kGatherBatch];
#pragma unroll
      for (int i = 0; i < kGatherBatch; ++i) {
        const int w = __shfl_sync(kAll, idx, (b + i) & 31);
        rw[i] = b + i < m ? __shfl_sync(kAll, row, (b + i) & 31) : -1;
        const T* xr = x + static_cast<size_t>(w) * dim;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int d = lane + 32 * j;
          val[i][j] = rw[i] >= 0 && d < dim ? to_float(xr[d]) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kGatherBatch; ++i) {
        if (rw[i] >= 0) add(rw[i], val[i]);
      }
    }
  }
}

// out[u][j] += sum of x[w, l + 32 j] over the neighbors w of row v0 + u, in
// registers: the row is matched against every u, so that each out[u][j]
// has a fixed register.
template <int ROWS, int CPT>
__device__ __forceinline__ void add_neighbor_sums(const float* __restrict__ x, const NbrList nl,
                                                  int v0, int n, int dim, int lane,
                                                  float (&out)[ROWS][CPT]) {
  for_each_neighbor<ROWS, CPT, float>(x, nl, v0, n, dim, lane, [&](int r, const float (&v)[CPT]) {
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (r == u) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) out[u][j] += v[j];
      }
    }
  });
}

}  // namespace
