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
// What the design does about it: the slot body of level_scan.cu
// (level_slot.cuh): a warp per destination slot, the slot's in-edges from
// the level's list (ops/level_kernel.level_lists) instead of a scan of the
// level's 1280 edge rows, a block per expert with that expert's weight
// slices in shared memory. It keeps its own launch structure: one launch per
// real level on the caller's stream, so each launch stages the slices anew.
// hf comes out bit for bit as level_scan.cu's. Row offsets are size_t:
// L * Ep * (D + 2) floats pass 2^31 bytes at depths this route is meant for.
// The TPU kernel's chunked DMA stream of hf through VMEM, its double buffers,
// lane padding, chunk picking and static / dynamic chunk loops have no
// counterpart: hf is read where it lies.
//
// Left for later work: one persistent launch as level_scan.cu's (a level of
// 512 slots needs no more blocks than can be co-resident), or CUDA graphs.

#include <cuda_runtime.h>

#include "level_slot.cuh"

extern "C" {

// Runs levels [0, num_levels) of the level tables, one launch per level on
// `stream`. Tables and lists are row-major int32 with a leading level axis,
// pack_lv is [L, Ep, D+2]; hf [N, D] must be zeroed by the caller. Returns 0,
// or the cudaError_t of the first failed launch.
int mgvae_level_scan_giant_forward(
    const float* pack_lv, const int* lv_src, const int* lv_nodes, const int* slot_rows,
    const int* slot_off, const int* in_rows, const int* in_off, const float* wkv_e,
    const float* wih_e, const float* b_ih, const float* b_hh, const float* wa_k, float* hf,
    float* score_buf, float* v_buf,
    int num_levels, int ep, int np, int dim, int num_experts, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || num_levels < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < num_levels; ++l) {
    const size_t eo = static_cast<size_t>(l) * ep, no = static_cast<size_t>(l) * np;
    const LevelFwd lv{pack_lv + eo * (dim + 2), lv_src + eo, slot_rows + no,
                      slot_off + static_cast<size_t>(l) * (num_experts + 1), in_rows + eo,
                      in_off + static_cast<size_t>(l) * (np + 1)};
    cudaError_t err = cudaSuccess;
    MGVAE_WITH_NF(dim, err = launch_level_forward<NF>(
        lv, wkv_e, wih_e, b_ih, b_hh, wa_k, hf, hf, lv_nodes + no, score_buf, v_buf, nullptr,
        nullptr, np, dim, num_experts, s));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
