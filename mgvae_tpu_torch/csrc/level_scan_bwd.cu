// Backward of the fused level recurrence (num_rounds == 1), with fp32 or
// bf16 values, for Hopper (sm_90a).
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
//   * The reverse sweep is one persistent cooperative launch, as the forward
//     (level_scan.cu; the kernel, level_scan_bwd_kernel, is in
//     level_slot_bwd.cuh, where the giant backward runs it per chunk): a block serves one expert and keeps in shared memory
//     the transposed copies of its wv and w_ih slices that the wrapper made,
//     so that the transposed products read rows, without bank conflicts; a
//     warp owns a slot and takes its in-edges from the level's list; the
//     per-edge D x 2D product dk . wk^T + dv . wv^T collapses to one D x D
//     product per slot and one vector per expert (level_slot_bwd.cuh); the
//     next level's slot (indices, residuals) is loaded between the phases
//     of the current one. Per level,
//     from the last down to 0: the slot phase (GRU backward, dmsg, the
//     attention backward, dk | dv and dgi | dbh saved for the weight
//     gradients, dhf_src per in-edge), a grid barrier, the source sums
//     ghf[src] += dhf_src, a grid barrier. Several slots of a level can share
//     a source: the level's live rows are listed by source, and the warp
//     that finds a group's start sums the group in row order and adds once.
//     No atomics, the same result on every run. A level's sources all sit at
//     lower levels, so the sums never race with the level's own reads of
//     ghf; ghf and dhf_src are read past L1, since the same launch wrote them
//     on other SMs.
//   * The weight gradients follow in one or two more launches, no longer
//     inside each level as on the TPU (level_kernel.py:721-748): a block owns
//     one (product, expert, output tile, chunk of levels) and visits only
//     its expert's live rows, from the lists; the chunks' partials are
//     summed pairwise in a fixed order (level_slot_bwd.cuh).
//   * The TPU kernel's one-hot gathers and scatters, source windows, class
//     tiers and expert-stacked matmuls over all T experts are gone. fp32
//     FMA: tensor cores would mean TF32 or bf16.
//   * bf16 values (level_slot_bwd.cuh): the residuals, ghf and d_pack are
//     bf16 in memory and the values are rounded where the JAX kernel rounds
//     them; the dhf_src products of a slot's in-edges then run per edge
//     against wk_e^T (a copy the wrapper makes) and wv_e^T, D x 2D each, as
//     the forward's k and v products; dscore goes to an fp32 buffer for
//     d_wak. The weight gradients sum in fp32, as in fp32 mode.

#include <cuda_runtime.h>

#include "level_slot_bwd.cuh"

extern "C" {

// Backward of mgvae_level_scan_forward over levels [0, num_levels), on
// `stream`: the sweep, then the weight gradients (two launches in all when
// num_levels <= levels_per_block, else three). ghf [N, D] is a working copy
// of hf's cotangent: it is updated in place. res_e / res_n are the forward's
// residuals and the lists the forward's; wkv_e [T, 2, D, D] is the
// expert-major copy of wkv_hf, wvt_e [T, D, D] and wiht_e [T, 3D, D] the
// transposed slices of wv and w_ih. d_pack [L, Ep, D+2] must be zeroed
// by the caller; dkv [L, Ep, 2D], dg [L, Np, 6D], dhf_buf [Ep, D] and
// partial [ceil(num_levels / levels_per_block), weight-gradient floats] are
// scratch that needs no fill; grads holds the five weight gradients end to
// end (d_wkv, d_wih, d_bih, d_bhh, d_wak), written whole; `barrier`: one
// unsigned. With `bf16` ghf, res_e, res_n and d_pack hold bf16, and
// wkt_e [T, DP, DP] (wk_e transposed) and dscore [L, Ep] (fp32 scratch) are
// given; else they are null and those arrays fp32. Returns 0, or the
// cudaError_t of the failed call: a launch that is refused never runs.
int mgvae_level_scan_backward(
    void* ghf, const void* res_e, const void* res_n, const int* lv_src, const int* lv_nodes,
    const int* slot_rows, const int* slot_off, const int* in_rows, const int* in_off,
    const int* src_rows, const float* wkv_e, const float* wvt_e, const float* wiht_e,
    const float* b_hh, const float* wa_k, void* d_pack, float* dkv, float* dg, float* dhf_buf,
    float* grads, float* partial, const float* wkt_e, float* dscore, unsigned* barrier,
    int num_levels, int levels_per_block, int ep, int np, int dim, int num_experts, int bf16,
    void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || num_levels < 1 || levels_per_block < 1 ||
      (bf16 && (wkt_e == nullptr || dscore == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LevelBwd lists{lv_src, slot_rows, slot_off, in_rows, in_off, src_rows};
  cudaError_t err = cudaSuccess;
  MGVAE_WITH_VALUE(bf16, {
    ScanBackward<V, V> p{static_cast<V*>(ghf), static_cast<const V*>(res_e),
                         static_cast<const V*>(res_n), lv_nodes, lists, wkv_e, wvt_e, wiht_e,
                         b_hh, wa_k, static_cast<V*>(d_pack), dkv, dg, dhf_buf, wkt_e, dscore,
                         barrier, num_levels, ep, np, dim, num_experts};
    MGVAE_WITH_NF(dim, err = launch_sweep<NF, V, V>(p, s));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_weight_grads(res_e, res_n, d_pack, dkv, dg, lists, grads,
                                              partial, num_levels, levels_per_block, ep, np,
                                              dim, num_experts, false, s, nullptr, bf16, dscore));
}

}  // extern "C"
