// Fused level-recurrence forward of DG_AE (num_rounds == 1), fp32, for
// Hopper (sm_90a).
//
// Replaces mgvae_tpu/ops/pallas/level_kernel.py::fused_level_scan (C == 1),
// with and without its residual outputs. Per DAG level and per destination
// slot: gather hf[src] of the slot's in-edges, the hf-side key/value of the
// destination's expert, the masked segment softmax over the in-edges,
// msg = sum attn * v, then a GRU step with h = 0, written to hf[node].
//
// What bounds it on this card: latency and launches. At bs16 / D = 64 a
// level has ~100 destinations of fan-in 1-3: a few hundred KFLOP and a few
// hundred KB of weights (L2-resident) per level, one launch per level, ~50
// launches per batch. Neither FLOPs nor bytes come near the card's limits.
//
// What the design does about it:
//   * The TPU kernel computed all T experts and selected with a mask, and
//     gathered/scattered rows with one-hot matmuls (Mosaic has no dynamic
//     row gather). Here a block owns one destination slot and so one
//     expert: it reads only that expert's [D, 2D] and [D, 3D] weight
//     columns (T times fewer FLOPs), gathers hf rows with plain indexed
//     loads and writes its row directly.
//   * CUDA blocks run in no order, so the level dependency is explicit: one
//     launch per real level on the caller's stream (the host loop below).
//     hf lives in global memory; the caller zeroes it.
//   * What a slot computes lives in level_slot.cuh, shared with the
//     single-level step (level_step.cu).
//   * Weights are read from global memory (L2). Staging them in shared
//     memory, one persistent launch with a grid-wide barrier, CUDA graphs
//     and wgmma are left for later work.
//
// Residuals (training): with res_e / res_n given, each updated slot also
// writes, for the backward kernel (level_scan_bwd.cu), per in-edge
// res_e [Ep, 3D+1] = hf_src | khf | v | attn and per slot
// res_n [Np, 4D] = msg | r | z | nw, unpadded. Rows of slots that are not
// updated, of padding edges and of padding levels are left as the caller
// gave them (zeroed) and are never read.
//
// Thread d of a block owns feature d (blockDim = D rounded up to a warp).
// An edge's expert is its destination's, so every in-edge of a slot uses the
// slot's expert e_n[slot] (the pack's expert column holds the same value).
// Each slot's in-edges are visited in row order, the same on every thread,
// so the result does not depend on scheduling.

#include <cuda_runtime.h>

#include "level_slot.cuh"

namespace {

// One level. Grid: one block per destination slot of the level.
__global__ void __launch_bounds__(kMaxDim) level_kernel(
    const float* __restrict__ pack,    // [Ep, D+2]: [vhs | score_static | expert]
    const int* __restrict__ src,       // [Ep] source node of each in-edge
    const int* __restrict__ dslot,     // [Ep] destination slot
    const int* __restrict__ evalid,    // [Ep] edge valid
    const int* __restrict__ nodes,     // [Np] node id of each slot
    const int* __restrict__ upd,       // [Np] update mask
    const int* __restrict__ e_n,       // [Np] expert of each slot
    const float* __restrict__ wkv_hf,  // [D, 2TD] = [wk_hf (TD) | wv_hf (TD)]
    const float* __restrict__ w_ih,    // [D, 3TD]
    const float* __restrict__ b_ih,    // [T, 3D]
    const float* __restrict__ b_hh,    // [T, 3D]
    const float* __restrict__ wa_k,    // [T, D]
    float* hf,                         // [N, D]: sources read, this level's rows written
    float* __restrict__ score_buf,     // [Ep] scratch
    float* __restrict__ v_buf,         // [Ep, D] scratch
    float* __restrict__ res_e,         // [Ep, 3D+1] or null
    float* __restrict__ res_n,         // [Np, 4D] or null
    int ep, int dim, int num_experts) {
  const int slot = blockIdx.x;
  if (upd[slot] == 0) return;  // block-uniform, before any barrier
  level_slot_forward(pack, src, dslot, evalid, slot, e_n[slot], wkv_hf, w_ih, b_ih, b_hh, wa_k,
                     hf, hf + (size_t)nodes[slot] * dim, score_buf, v_buf, res_e, res_n,
                     ep, dim, num_experts);
}

}  // namespace

extern "C" {

// Runs levels [0, num_levels) of the level tables, one launch per level on
// `stream`. Tables are [L, Ep] / [L, Np] row-major int32, pack_lv is
// [L, Ep, D+2]. res_e [L, Ep, 3D+1] and res_n [L, Np, 4D] are both given
// (training) or both null. Returns 0, or the cudaError_t of the first
// failed launch.
int mgvae_level_scan_forward(
    const float* pack_lv, const int* lv_src, const int* lv_dslot, const int* lv_evalid,
    const int* lv_nodes, const int* lv_upd, const int* lv_e_n,
    const float* wkv_hf, const float* w_ih, const float* b_ih, const float* b_hh,
    const float* wa_k, float* hf, float* score_buf, float* v_buf, float* res_e, float* res_n,
    int num_levels, int ep, int np, int dim, int num_experts, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || num_levels < 0 || (res_e == nullptr) != (res_n == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (dim + 31) / 32 * 32;
  const size_t ew = 3 * static_cast<size_t>(dim) + 1, nw = 4 * static_cast<size_t>(dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < num_levels; ++l) {
    const size_t eo = static_cast<size_t>(l) * ep, no = static_cast<size_t>(l) * np;
    level_kernel<<<np, threads, 0, s>>>(
        pack_lv + eo * (dim + 2), lv_src + eo, lv_dslot + eo, lv_evalid + eo,
        lv_nodes + no, lv_upd + no, lv_e_n + no,
        wkv_hf, w_ih, b_ih, b_hh, wa_k, hf, score_buf, v_buf,
        res_e ? res_e + eo * ew : nullptr, res_n ? res_n + no * nw : nullptr,
        ep, dim, num_experts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* mgvae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
