// One level of the level recurrence from an explicit hf (num_rounds == 1),
// fp32, for Hopper (sm_90a).
//
// Replaces mgvae_tpu/ops/pallas/level_kernel.py::level_step_call
// (_level_step_kernel), with and without its residual outputs. It computes
// what one level of the fused scan computes (level_scan.cu) with two
// differences: hf [N, D] is an input that is only read, and the new rows go
// to h_new [Np, D] in slot order and are not scattered into hf. The caller
// scatters them between calls, so a batch whose chunks are too large for the
// fused route runs as one call per (chunk, level).
//
// What bounds it on this card: latency and launches. A level of a bs64 MIG
// chunk has a few hundred destinations of fan-in 1-3 at D = 64: under a
// MFLOP and a few hundred KB per call, far from the card's rates; a batch is
// ~100 dependent calls.
//
// What the design does about it: the slot body of level_scan.cu
// (level_slot.cuh) in one launch: a warp per destination slot, the slot's
// in-edges from the level's list (ops/level_kernel.level_lists), a block per
// expert with that expert's weight slices in shared memory. The TPU kernel's
// source windows (_step_prologue), one-hot gathers, lane padding of the
// residuals and chunk picking have no counterpart here. Folding the scatter
// and several levels into one launch is left for later work.
//
// Rows of h_new whose slot is not updated are left as the caller gave them
// (zeroed); the residual rows of such slots and of edges that are not live
// are not written and never read.

#include <cuda_runtime.h>

#include "level_slot.cuh"

extern "C" {

// One launch on `stream`. h_new [Np, D] must be zeroed by the caller. res_e
// [Ep, 3D+1] and res_n [Np, 4D] are both given (training) or both null. The
// lists are one level's. Returns 0, or the cudaError_t of the failed launch.
int mgvae_level_step_forward(
    const float* hf, const float* pack, const int* src, const int* slot_rows,
    const int* slot_off, const int* in_rows, const int* in_off, const float* wkv_e,
    const float* wih_e, const float* b_ih, const float* b_hh, const float* wa_k, float* h_new,
    float* score_buf, float* v_buf, float* res_e, float* res_n,
    int ep, int np, int dim, int num_experts, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || (res_e == nullptr) != (res_n == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LevelFwd lv{pack, src, slot_rows, slot_off, in_rows, in_off};
  cudaError_t err = cudaSuccess;
  MGVAE_WITH_NF(dim, err = launch_level_forward<NF>(
      lv, wkv_e, wih_e, b_ih, b_hh, wa_k, hf, h_new, nullptr, score_buf, v_buf, res_e, res_n,
      np, dim, num_experts, static_cast<cudaStream_t>(stream)));
  return static_cast<int>(err);
}

}  // extern "C"
