// Backward of the fused level recurrence (num_rounds == 1), fp32, for
// Hopper (sm_90a).
//
// Replaces mgvae_tpu/ops/pallas/level_kernel.py::fused_level_scan_bwd (the
// backward of the custom VJP pallas_level_scan, C == 1). It reads the
// forward's residuals (level_scan.cu: res_e = hf_src | khf | v | attn per
// edge, res_n = msg | r | z | nw per slot) and recomputes nothing of the
// forward. Outputs: d_pack [L, Ep, D+2] = [dv | dscore | 0] per edge (the
// expert column gets no gradient) and the weight gradients d_wkv [D, 2TD],
// d_wih [D, 3TD], d_bih / d_bhh [T, 3D], d_wak [T, D].
//
// What bounds it on this card: latency. The reverse sweep is ~45 dependent
// levels of ~100 slots with fan-in 1-3 at bs16 / D = 64: a few hundred
// KFLOP per level, every level waiting for the one above it. The weight
// gradients are ~0.5 GFLOP in all, which no level needs before the end.
//
// What the design does about it:
//   * Phase A, the reverse sweep: per real level, from the last down to 0,
//     two launches on the caller's stream. The first has one block per
//     updated destination slot: GRU backward with h = 0, dmsg through the
//     slot's own expert columns of w_ih, then its in-edges in row order
//     (the forward's ballot scan): dv, dattn, the softmax backward, dk and
//     dhf_src through the expert's columns of wkv_hf. It saves dk | dv per
//     edge and dgi | dbh per slot for phase B. The second launch adds each
//     edge's dhf_src into ghf[src]. Several slots of a level can share a
//     source, so one block per distinct source (the first live row that
//     has it) sums that source's rows in row order and adds once: no
//     atomics, the same result on every run. A level's sources all sit at
//     lower levels, so this never races with the level's own reads of ghf.
//   * Phase B, the weight gradients: one launch after the sweep, no longer
//     inside each level as on the TPU (level_kernel.py:721-748). Each block
//     owns one (product, expert, output tile) and reduces over all saved
//     rows of the sweep in a fixed order, masking rows of other experts.
//     No atomics, deterministic.
//   * What a slot computes, the source sums and the weight-gradient kernel
//     live in level_slot_bwd.cuh, shared with the single-level step's
//     backward (level_step_bwd.cu).
//   * The TPU kernel's one-hot gathers and scatters, source windows, class
//     tiers and expert-stacked matmuls over all T experts are gone: a block
//     reads only its slot's expert.
//   * Weights are read from global memory (L2); shared-memory staging,
//     wgmma and one persistent launch are left for later work.
//
// Thread d of a block owns feature d (blockDim = D rounded up to a warp).

#include <cuda_runtime.h>

#include "level_slot_bwd.cuh"

extern "C" {

// Backward of mgvae_level_scan_forward over levels [0, num_levels), on
// `stream`. ghf [N, D] is a working copy of hf's cotangent: it is updated in
// place. res_e / res_n are the forward's residuals. d_pack [L, Ep, D+2],
// dkv [L, Ep, 2D] and dg [L, Np, 6D] must be zeroed by the caller; dhf_buf
// [Ep, D] and dattn_buf [Ep] are scratch. The weight gradients are written
// whole. Returns 0, or the cudaError_t of the first failed launch.
int mgvae_level_scan_backward(
    float* ghf, const float* res_e, const float* res_n,
    const int* lv_src, const int* lv_dslot, const int* lv_evalid,
    const int* lv_nodes, const int* lv_upd, const int* lv_e_n,
    const float* wkv_hf, const float* w_ih, const float* b_hh, const float* wa_k,
    float* d_pack, float* dkv, float* dg, float* dhf_buf, float* dattn_buf,
    float* d_wkv, float* d_wih, float* d_bih, float* d_bhh, float* d_wak,
    int num_levels, int ep, int np, int dim, int num_experts, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || num_levels < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = dim, T = num_experts;
  const int threads = (D + 31) / 32 * 32;
  const size_t ew = 3 * static_cast<size_t>(D) + 1, nw = 4 * static_cast<size_t>(D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = num_levels - 1; l >= 0; --l) {
    const size_t eo = static_cast<size_t>(l) * ep, no = static_cast<size_t>(l) * np;
    level_bwd_slot_kernel<<<np, threads, 0, s>>>(
        ghf, res_e + eo * ew, res_n + no * nw, lv_dslot + eo, lv_evalid + eo,
        lv_nodes + no, lv_upd + no, lv_e_n + no, wkv_hf, w_ih, b_hh, wa_k,
        d_pack + eo * (D + 2), dkv + eo * 2 * D, dg + no * 6 * D, dhf_buf, dattn_buf,
        ep, D, T);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    level_bwd_source_kernel<<<ep, threads, 0, s>>>(
        ghf, dhf_buf, lv_src + eo, lv_dslot + eo, lv_evalid + eo, lv_upd + no, ep, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_weight_grads(
      res_e, res_n, d_pack, dkv, dg, lv_dslot, lv_e_n, d_wkv, d_wih, d_bih, d_bhh, d_wak,
      num_levels, ep, np, D, T, false, s));
}

}  // extern "C"
