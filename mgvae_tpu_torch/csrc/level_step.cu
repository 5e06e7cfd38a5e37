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
// What the design does about it: the same as level_scan.cu, whose slot body
// it shares (level_slot.cuh). One block per destination slot reads only its
// own expert's weight columns and gathers its sources' rows with indexed
// loads. The TPU kernel's source windows (_step_prologue), one-hot gathers,
// lane padding of the residuals and chunk picking have no counterpart here.
// Folding the scatter and several levels into one launch is left for later
// work.
//
// Rows of h_new whose slot is not updated, and the residual rows of such
// slots and of padding edges, are left as the caller gave them (zeroed).

#include <cuda_runtime.h>

#include "level_slot.cuh"

namespace {

// Grid: one block per destination slot of the level.
__global__ void __launch_bounds__(kMaxDim) level_step_kernel(
    const float* __restrict__ hf,      // [N, D], read only
    const float* __restrict__ pack,    // [Ep, D+2]: [vhs | score_static | expert]
    const int* __restrict__ src,       // [Ep] source node of each in-edge
    const int* __restrict__ dslot,     // [Ep] destination slot
    const int* __restrict__ evalid,    // [Ep] edge valid
    const int* __restrict__ upd,       // [Np] update mask
    const int* __restrict__ e_n,       // [Np] expert of each slot
    const float* __restrict__ wkv_hf,  // [D, 2TD]
    const float* __restrict__ w_ih,    // [D, 3TD]
    const float* __restrict__ b_ih,    // [T, 3D]
    const float* __restrict__ b_hh,    // [T, 3D]
    const float* __restrict__ wa_k,    // [T, D]
    float* __restrict__ h_new,         // [Np, D]
    float* __restrict__ score_buf,     // [Ep] scratch
    float* __restrict__ v_buf,         // [Ep, D] scratch
    float* __restrict__ res_e,         // [Ep, 3D+1] or null
    float* __restrict__ res_n,         // [Np, 4D] or null
    int ep, int dim, int num_experts) {
  const int slot = blockIdx.x;
  if (upd[slot] == 0) return;  // block-uniform, before any barrier
  level_slot_forward(pack, src, dslot, evalid, slot, e_n[slot], wkv_hf, w_ih, b_ih, b_hh, wa_k,
                     hf, h_new + (size_t)slot * dim, score_buf, v_buf, res_e, res_n,
                     ep, dim, num_experts);
}

}  // namespace

extern "C" {

// One launch on `stream`. h_new [Np, D] must be zeroed by the caller, and so
// must res_e [Ep, 3D+1] and res_n [Np, 4D], which are both given (training)
// or both null. Returns 0, or the cudaError_t of the failed launch.
int mgvae_level_step_forward(
    const float* hf, const float* pack, const int* src, const int* dslot, const int* evalid,
    const int* upd, const int* e_n,
    const float* wkv_hf, const float* w_ih, const float* b_ih, const float* b_hh,
    const float* wa_k, float* h_new, float* score_buf, float* v_buf, float* res_e, float* res_n,
    int ep, int np, int dim, int num_experts, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || (res_e == nullptr) != (res_n == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (dim + 31) / 32 * 32;
  level_step_kernel<<<np, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      hf, pack, src, dslot, evalid, upd, e_n, wkv_hf, w_ih, b_ih, b_hh, wa_k,
      h_new, score_buf, v_buf, res_e, res_n, ep, dim, num_experts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
