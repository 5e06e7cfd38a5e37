// Level-recurrence forward for one batch of any size (num_rounds == 1),
// fp32, for Hopper (sm_90a): the route of giant single graphs and of every
// plain batch too large for the fused route's size gate.
//
// Replaces mgvae_tpu/ops/pallas/level_kernel.py::fused_level_scan_hbm
// (_level_scan_hbm_padded, _level_kernel_hbm). It computes the recurrence of
// level_scan.cu over hf [N, D] in device memory, at any N, and has no
// residual outputs, in serving or in training: the training forward keeps hf
// alone, and the backward (level_scan_giant_bwd.cu) recomputes each level's
// intermediates from it. Memory beyond inputs and hf is one level's scratch,
// O(Ep * D), whatever the depth.
//
// What bounds it on this card: latency and launches. The giant example
// (one layered MIG circuit, width 512 x depth 200, D = 64) is ~200 dependent
// levels of 512 destinations of fan-in 2-3: ~30 MFLOP and under 1 MB of new
// bytes per level, every level waiting for the one below it.
//
// What the design does about it: the same as level_scan.cu, whose slot body
// it shares (level_slot.cuh). One launch per real level on the caller's
// stream, one block per destination slot, which reads only its own expert's
// weight columns and gathers its sources' rows with indexed loads. Row
// offsets are size_t: L * Ep * (D + 2) floats pass 2^31 bytes at depths this
// route is meant for. The TPU kernel's chunked DMA stream of hf through
// VMEM, its double buffers, lane padding, chunk picking and static / dynamic
// chunk loops have no counterpart: hf is read where it lies.
//
// Left for later work: each slot's block scans all Ep rows of the level's
// edge table for its in-edges (for_each_in_edge), 512 blocks x 1280 rows
// twice per level at the example's shape; a per-slot edge range would remove
// that. One persistent launch with a grid-wide barrier, and CUDA graphs.

#include <cuda_runtime.h>

#include "level_slot.cuh"

namespace {

// One level. Grid: one block per destination slot of the level.
__global__ void __launch_bounds__(kMaxDim) level_giant_kernel(
    const float* __restrict__ pack,    // [Ep, D+2]: [vhs | score_static | expert]
    const int* __restrict__ src,       // [Ep] source node of each in-edge
    const int* __restrict__ dslot,     // [Ep] destination slot
    const int* __restrict__ evalid,    // [Ep] edge valid
    const int* __restrict__ nodes,     // [Np] node id of each slot
    const int* __restrict__ upd,       // [Np] update mask
    const int* __restrict__ e_n,       // [Np] expert of each slot
    const float* __restrict__ wkv_hf,  // [D, 2TD]
    const float* __restrict__ w_ih,    // [D, 3TD]
    const float* __restrict__ b_ih,    // [T, 3D]
    const float* __restrict__ b_hh,    // [T, 3D]
    const float* __restrict__ wa_k,    // [T, D]
    float* hf,                         // [N, D]: sources read, this level's rows written
    float* __restrict__ score_buf,     // [Ep] scratch
    float* __restrict__ v_buf,         // [Ep, D] scratch
    int ep, int dim, int num_experts) {
  const int slot = blockIdx.x;
  if (upd[slot] == 0) return;  // block-uniform, before any barrier
  level_slot_forward(pack, src, dslot, evalid, slot, e_n[slot], wkv_hf, w_ih, b_ih, b_hh, wa_k,
                     hf, hf + (size_t)nodes[slot] * dim, score_buf, v_buf, nullptr, nullptr,
                     ep, dim, num_experts);
}

}  // namespace

extern "C" {

// Runs levels [0, num_levels) of the level tables, one launch per level on
// `stream`. Tables are [L, Ep] / [L, Np] row-major int32, pack_lv is
// [L, Ep, D+2]; hf [N, D] must be zeroed by the caller. Returns 0, or the
// cudaError_t of the first failed launch.
int mgvae_level_scan_giant_forward(
    const float* pack_lv, const int* lv_src, const int* lv_dslot, const int* lv_evalid,
    const int* lv_nodes, const int* lv_upd, const int* lv_e_n,
    const float* wkv_hf, const float* w_ih, const float* b_ih, const float* b_hh,
    const float* wa_k, float* hf, float* score_buf, float* v_buf,
    int num_levels, int ep, int np, int dim, int num_experts, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || num_levels < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (dim + 31) / 32 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < num_levels; ++l) {
    const size_t eo = static_cast<size_t>(l) * ep, no = static_cast<size_t>(l) * np;
    level_giant_kernel<<<np, threads, 0, s>>>(
        pack_lv + eo * (dim + 2), lv_src + eo, lv_dslot + eo, lv_evalid + eo,
        lv_nodes + no, lv_upd + no, lv_e_n + no,
        wkv_hf, w_ih, b_ih, b_hh, wa_k, hf, score_buf, v_buf, ep, dim, num_experts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
