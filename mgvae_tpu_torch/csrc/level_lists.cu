// The index lists that the level kernels read, built on the card: for Hopper
// (sm_90a), integers only.
//
// Replaces what the TPU kernels rebuilt inside every level, in VMEM: the
// [Ep, Np] edge-slot incidence and the expert and source one-hots
// (mgvae_tpu/ops/pallas/level_kernel.py:404, :673-682), which Mosaic needed
// because it has no dynamic row gather. On this card a slot's warp gathers
// rows by index, so the tables are sorted once per batch into lists and the
// level kernels scan nothing. Per level (ops/level_kernel.level_lists):
//   slot_rows [Np]   the updated slots, grouped by expert, ascending;
//   slot_off  [T+1]  expert e's slots are positions [off[e], off[e+1]);
//   in_rows   [Ep]   the live edge rows (valid, into an updated slot),
//                    grouped by their slot's position, in row order;
//   in_off    [Np+1] position p's in-edges are in_rows[off[p] : off[p+1]];
//   src_rows  [Ep]   the live edge rows grouped by source node, in row order;
// entries past the updated slots / the live rows: the other slots / rows,
// ascending (what a stable sort leaves there).
//
// What bounds it on this card: nothing worth naming: a few thousand
// integers per level. The plain version is five stable torch sorts and a
// dozen small launches, about forty enqueues where the host is what the
// training step waits for. What the design does about it: one launch, a block
// per level, the level's keys in shared memory; an entry's place is the count
// of entries that sort before it (smaller key, or equal key and earlier row),
// found by one pass over the keys: O(n^2 / threads) comparisons of values
// that every thread of the block reads at the same address, which for the
// widths of a level (hundreds to a few thousand) costs microseconds and needs
// neither atomics nor a scan. Equal keys keep row order, so the lists, and
// with them the order of every sum the level kernels take, are the same as
// the plain version's, entry for entry.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) level_lists_kernel(
    const int* __restrict__ lv_src,     // [R, Ep]
    const int* __restrict__ lv_dslot,   // [R, Ep]
    const int* __restrict__ lv_evalid,  // [R, Ep]
    const int* __restrict__ lv_upd,     // [R, Np]
    const int* __restrict__ lv_e_n,     // [R, Np]
    int* __restrict__ slot_rows, int* __restrict__ slot_off, int* __restrict__ in_rows,
    int* __restrict__ in_off, int* __restrict__ src_rows, int ep, int np, int num_experts) {
  extern __shared__ int keys[];
  int* slot_key = keys;               // [Np] an updated slot's expert, else T
  int* slot_pos = keys + np;          // [Np] a slot's position in slot_rows
  int* edge_key = keys + 2 * np;      // [Ep] a live row's slot position, else Np
  int* src_key = keys + 2 * np + ep;  // [Ep] a live row's source, else INT_MAX
  const size_t eo = (size_t)blockIdx.x * ep, no = (size_t)blockIdx.x * np;
  const int T = num_experts;

  for (int s = threadIdx.x; s < np; s += kThreads) {
    slot_key[s] = lv_upd[no + s] > 0 ? lv_e_n[no + s] : T;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < np; s += kThreads) {
    const int k = slot_key[s];
    int pos = 0;
    for (int o = 0; o < np; ++o) pos += slot_key[o] < k || (slot_key[o] == k && o < s);
    slot_rows[no + pos] = s;
    slot_pos[s] = pos;
  }
  for (int e = threadIdx.x; e <= T; e += kThreads) {
    int count = 0;
    for (int o = 0; o < np; ++o) count += slot_key[o] < e;
    slot_off[(size_t)blockIdx.x * (T + 1) + e] = count;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ep; j += kThreads) {
    const int d = min(max(lv_dslot[eo + j], 0), np - 1);
    const bool live = lv_evalid[eo + j] > 0 && slot_key[d] < T;
    edge_key[j] = live ? slot_pos[d] : np;
    src_key[j] = live ? lv_src[eo + j] : INT_MAX;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ep; j += kThreads) {
    const int ke = edge_key[j], ks = src_key[j];
    int pe = 0, ps = 0;
    for (int o = 0; o < ep; ++o) {
      pe += edge_key[o] < ke || (edge_key[o] == ke && o < j);
      ps += src_key[o] < ks || (src_key[o] == ks && o < j);
    }
    in_rows[eo + pe] = j;
    src_rows[eo + ps] = j;
  }
  for (int p = threadIdx.x; p <= np; p += kThreads) {
    int count = 0;
    for (int o = 0; o < ep; ++o) count += edge_key[o] < p;
    in_off[(size_t)blockIdx.x * (np + 1) + p] = count;
  }
}

}  // namespace

extern "C" {

// The lists of `rows` levels' tables, one launch on `stream`. Tables and
// lists are row-major int32 with a leading level axis. Returns 0, or the
// cudaError_t of the failed call: a launch that is refused never runs.
int mgvae_level_lists(
    const int* lv_src, const int* lv_dslot, const int* lv_evalid, const int* lv_upd,
    const int* lv_e_n, int* slot_rows, int* slot_off, int* in_rows, int* in_off, int* src_rows,
    int rows, int ep, int np, int num_experts, void* stream) {
  if (rows < 1 || ep < 1 || np < 1 || num_experts < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = sizeof(int) * 2 * (static_cast<size_t>(np) + ep);
  if (bytes > 48 * 1024) {   // past what a launch may have unasked: Np + Ep > 6144
    const cudaError_t err = cudaFuncSetAttribute(
        level_lists_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  level_lists_kernel<<<rows, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      lv_src, lv_dslot, lv_evalid, lv_upd, lv_e_n, slot_rows, slot_off, in_rows, in_off,
      src_rows, ep, np, num_experts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
