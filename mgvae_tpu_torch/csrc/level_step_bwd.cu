// Backward of one level step (num_rounds == 1), fp32, for Hopper (sm_90a).
//
// Replaces mgvae_tpu/ops/pallas/level_kernel.py::level_step_bwd_call
// (_level_step_bwd_kernel, the backward of the custom VJP
// pallas_level_step). From the cotangent g [Np, D] of h_new and the
// forward's residuals (level_step.cu) it gives d_pack [Ep, D+2] =
// [dv | dscore | 0], the weight gradients d_wkv [D, 2TD], d_wih [D, 3TD],
// d_bih / d_bhh [T, 3D], d_wak [T, D], and d_hf [N, D]: the gradient of the
// hf that the step read, through its source gathers. The fused backward has
// no such output: it adds the sources' gradients into the ghf it carries.
//
// What bounds it on this card: latency and launches, as the forward. On top
// of that it writes a dense d_hf [N, D] (2.6 MB at N = 10240, D = 64) of
// which a level touches a few hundred rows, and full weight gradients, per
// call; the caller's autograd then adds ~100 of each per batch.
//
// What the design does about it: three launches on the caller's stream,
// with the bodies of level_scan_bwd.cu (level_slot_bwd.cuh). A warp per
// updated destination slot, in blocks that hold their expert's weight slices
// in shared memory: GRU backward, attention backward, dk | dv and dhf_src per
// in-edge of the level's list. Then the level's live rows, listed by source:
// the warp that finds a source's first row sums that source's dhf_src rows
// in row order into the zeroed d_hf: no atomics, the same result on every
// run. Then the weight gradients over this level's live rows. The TPU
// kernel's source windows, one-hot scatters and expert-stacked products are
// gone. A sparse d_hf, or gradients accumulated in place across the calls of
// a batch, are left for later work.

#include <cuda_runtime.h>

#include "level_slot_bwd.cuh"

extern "C" {

// Backward of mgvae_level_step_forward, three launches on `stream`. d_pack
// [Ep, D+2] and d_hf [N, D] must be zeroed by the caller; dkv [Ep, 2D],
// dg [Np, 6D] and dhf_buf [Ep, D] are scratch that needs no fill. grads holds
// the five weight gradients end to end (d_wkv, d_wih, d_bih, d_bhh, d_wak),
// written whole. The lists are one level's; wkv_e [T, 2, D, D] is the
// expert-major copy of wkv_hf, wvt_e [T, D, D] and wiht_e [T, 3D, D] the
// transposed slices of wv and w_ih. Returns 0, or the cudaError_t of the
// first failed launch.
int mgvae_level_step_backward(
    const float* g, const float* res_e, const float* res_n, const int* src,
    const int* slot_rows, const int* slot_off, const int* in_rows, const int* in_off,
    const int* src_rows, const float* wkv_e, const float* wvt_e, const float* wiht_e,
    const float* b_hh, const float* wa_k, float* d_pack, float* dkv, float* dg, float* dhf_buf,
    float* grads, float* d_hf, int ep, int np, int dim, int num_experts, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LevelBwd lv{src, slot_rows, slot_off, in_rows, in_off, src_rows};
  cudaError_t err = cudaSuccess;
  MGVAE_WITH_NF(dim, err = launch_level_backward<NF>(
      lv, g, nullptr, res_e, res_n, wkv_e, wvt_e, wiht_e, b_hh, wa_k, d_pack, dkv, dg, dhf_buf,
      d_hf, ep, np, dim, num_experts, s));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_weight_grads(res_e, res_n, d_pack, dkv, dg, lv, grads, nullptr,
                                              1, 1, ep, np, dim, num_experts, false, s));
}

}  // extern "C"
