// Backward of the level recurrence for one batch of any size
// (num_rounds == 1), fp32, for Hopper (sm_90a): it recomputes every level's
// forward intermediates from the saved hf.
//
// Replaces mgvae_tpu/ops/pallas/level_kernel.py::fused_level_scan_hbm_bwd
// (_level_bwd_kernel_hbm, the backward of the custom VJP
// pallas_level_scan_hbm). Inputs: the cotangent ghf [N, D] (a working copy,
// updated in place), the forward's hf [N, D], the level tables, pack_lv and
// the weights. No residuals exist: where level_scan_bwd.cu reads stacked
// res_e [L, Ep, 3D+1] and res_n [L, Np, 4D], this backward rebuilds one
// level's rows into a scratch of one level's size. Recomputing from the
// final hf is exact: with one round a source's row is final before any
// level that reads it runs, and a level never reads a row of its own or a
// later level as a source. Outputs: d_pack [L, Ep, D+2] = [dv | dscore | 0]
// per edge and the weight gradients d_wkv [D, 2TD], d_wih [D, 3TD],
// d_bih / d_bhh [T, 3D], d_wak [T, D].
//
// What bounds it on this card: latency, as the forward: ~200 dependent
// levels at the giant example's shape, each a recomputed forward, a slot
// backward, the source sums and the level's weight gradients. Memory is the
// point of the route: beyond inputs and outputs it needs O(N * D + Ep * D)
// (ghf's copy and one level's scratch), where the residual route needs
// O(L * Ep * D).
//
// What the design does about it: per real level, from the last down to 0,
// four launches on the caller's stream, with the bodies of level_scan.cu
// and level_scan_bwd.cu (level_slot.cuh, level_slot_bwd.cuh: a warp per
// slot, in-edges and sources from the level lists, a block per expert with
// its weight slices in shared memory), so a level's arithmetic exists once:
//   1. recompute: the forward's slot body on the saved hf with residual
//      outputs, the new row dropped: res_e = hf_src | khf | v | attn,
//      res_n = msg | r | z | nw;
//   2. the slot backward on those rows, its cotangent the row of ghf at the
//      slot's node: d_pack's rows, dk | dv, dgi | dbh and dhf_src;
//   3. the source sums: ghf[src] += dhf_src, one warp per distinct source,
//      in row order, no atomics;
//   4. the level's share of the five weight gradients, added into the
//      outputs. One level's scratch leaves nothing for a single launch over
//      all saved rows to read, so the sums run across launches: every
//      output entry belongs to one thread of one block, and launches on one
//      stream run in order, so the result is the same on every run with no
//      atomics.
// Recompute and backward stay two launches: the backward reads the
// recomputed rows through the read-only path. No scratch needs a fill: every
// launch visits live rows only. The TPU kernel's DMA streams of hf and ghf
// through VMEM, its read-modify-write scatter stream, lane padding and chunk
// loops have no counterpart.
//
// Left for later work: K levels per scratch block to cut the weight-gradient
// launches, one persistent launch as level_scan_bwd.cu's, CUDA graphs.

#include <cuda_runtime.h>

#include "level_slot.cuh"
#include "level_slot_bwd.cuh"

extern "C" {

// Backward of mgvae_level_scan_giant_forward over levels [0, num_levels), on
// `stream`. ghf [N, D] is a working copy of hf's cotangent, updated in
// place; hf [N, D] is the forward's result; the lists are the forward's;
// wkv_e [T, 2, D, D] and wih_e [T, D, 3D] are the expert-major copies of the
// weights, wvt_e [T, D, D] and wiht_e [T, 3D, D] the transposed slices.
// d_pack [L, Ep, D+2] and grads (the five weight gradients end to end: d_wkv,
// d_wih, d_bih, d_bhh, d_wak; they are added into) must be zeroed by the
// caller. One level's scratch, none of which needs a fill: res_e [Ep, 3D+1],
// res_n [Np, 4D], dkv [Ep, 2D], dg [Np, 6D], score_buf [Ep], v_buf [Ep, D],
// dhf_buf [Ep, D]. Returns 0, or the cudaError_t of the first failed call.
int mgvae_level_scan_giant_backward(
    float* ghf, const float* hf, const float* pack_lv, const int* lv_src, const int* lv_nodes,
    const int* slot_rows, const int* slot_off, const int* in_rows, const int* in_off,
    const int* src_rows, const float* wkv_e, const float* wih_e, const float* wvt_e,
    const float* wiht_e, const float* b_ih, const float* b_hh, const float* wa_k,
    float* d_pack, float* res_e, float* res_n, float* dkv, float* dg,
    float* score_buf, float* v_buf, float* dhf_buf, float* grads,
    int num_levels, int ep, int np, int dim, int num_experts, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || num_levels < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = dim, T = num_experts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LevelBwd all{lv_src, slot_rows, slot_off, in_rows, in_off, src_rows};
  for (int l = num_levels - 1; l >= 0; --l) {
    const size_t eo = static_cast<size_t>(l) * ep, no = static_cast<size_t>(l) * np;
    const LevelBwd lv = level_of(all, l, ep, np, T);
    const LevelFwd fwd{pack_lv + eo * (D + 2), lv.src, lv.slot_rows, lv.slot_off, lv.in_rows,
                       lv.in_off};
    float* d_pack_l = d_pack + eo * (D + 2);
    cudaError_t err = cudaSuccess;
    MGVAE_WITH_NF(D, err = launch_level_forward<NF>(
        fwd, wkv_e, wih_e, b_ih, b_hh, wa_k, hf, nullptr, nullptr, score_buf, v_buf, res_e,
        res_n, np, D, T, s));
    if (err != cudaSuccess) return static_cast<int>(err);
    MGVAE_WITH_NF(D, err = launch_level_backward<NF>(
        lv, ghf, lv_nodes + no, res_e, res_n, wkv_e, wvt_e, wiht_e, b_hh, wa_k, d_pack_l, dkv,
        dg, dhf_buf, ghf, ep, np, D, T, s));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_weight_grads(res_e, res_n, d_pack_l, dkv, dg, lv, grads, nullptr, 1, 1, ep, np,
                              D, T, true, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
