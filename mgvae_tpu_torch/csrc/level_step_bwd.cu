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
// with the bodies of level_scan_bwd.cu (level_slot_bwd.cuh). One block per
// updated destination slot: GRU backward, attention backward, dk | dv and
// dhf_src per in-edge. Then one block per distinct source sums that
// source's dhf_src rows in row order into the zeroed d_hf: no atomics, the
// same result on every run. Then the weight gradients over this level's
// rows. The TPU kernel's source windows, one-hot scatters and expert-stacked
// products are gone. A sparse d_hf, or gradients accumulated in place across
// the calls of a batch, are left for later work.

#include <cuda_runtime.h>

#include "level_slot_bwd.cuh"

namespace {

// Grid: one block per destination slot of the level.
__global__ void __launch_bounds__(kMaxDim) level_step_bwd_slot_kernel(
    const float* __restrict__ g,       // [Np, D] cotangent of h_new
    const float* __restrict__ res_e,   // [Ep, 3D+1]
    const float* __restrict__ res_n,   // [Np, 4D]
    const int* __restrict__ dslot,     // [Ep]
    const int* __restrict__ evalid,    // [Ep]
    const int* __restrict__ upd,       // [Np]
    const int* __restrict__ e_n,       // [Np]
    const float* __restrict__ wkv_hf,  // [D, 2TD]
    const float* __restrict__ w_ih,    // [D, 3TD]
    const float* __restrict__ b_hh,    // [T, 3D]
    const float* __restrict__ wa_k,    // [T, D]
    float* __restrict__ d_pack,        // [Ep, D+2]
    float* __restrict__ dkv,           // [Ep, 2D]
    float* __restrict__ dg,            // [Np, 6D]
    float* __restrict__ dhf_buf,       // [Ep, D]
    float* dattn_buf,                  // [Ep] scratch
    int ep, int dim, int num_experts) {
  const int slot = blockIdx.x;
  if (upd[slot] == 0) return;  // its cotangent is masked: block-uniform, before any barrier
  level_slot_backward(g + (size_t)slot * dim, res_e, res_n, dslot, evalid, slot, e_n[slot],
                      wkv_hf, w_ih, b_hh, wa_k, d_pack, dkv, dg, dhf_buf, dattn_buf,
                      ep, dim, num_experts);
}

}  // namespace

extern "C" {

// Backward of mgvae_level_step_forward, three launches on `stream`. d_pack
// [Ep, D+2], dkv [Ep, 2D], dg [Np, 6D] and d_hf [N, D] must be zeroed by the
// caller; dhf_buf [Ep, D] and dattn_buf [Ep] are scratch. The weight
// gradients are written whole. Returns 0, or the cudaError_t of the first
// failed launch.
int mgvae_level_step_backward(
    const float* g, const float* res_e, const float* res_n,
    const int* src, const int* dslot, const int* evalid, const int* upd, const int* e_n,
    const float* wkv_hf, const float* w_ih, const float* b_hh, const float* wa_k,
    float* d_pack, float* dkv, float* dg, float* dhf_buf, float* dattn_buf,
    float* d_wkv, float* d_wih, float* d_bih, float* d_bhh, float* d_wak, float* d_hf,
    int ep, int np, int dim, int num_experts, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (dim + 31) / 32 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  level_step_bwd_slot_kernel<<<np, threads, 0, s>>>(
      g, res_e, res_n, dslot, evalid, upd, e_n, wkv_hf, w_ih, b_hh, wa_k,
      d_pack, dkv, dg, dhf_buf, dattn_buf, ep, dim, num_experts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  level_bwd_source_kernel<<<ep, threads, 0, s>>>(d_hf, dhf_buf, src, dslot, evalid, upd, ep, dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_weight_grads(
      res_e, res_n, d_pack, dkv, dg, dslot, e_n, d_wkv, d_wih, d_bih, d_bhh, d_wak,
      1, ep, np, dim, num_experts, false, s));
}

}  // extern "C"
