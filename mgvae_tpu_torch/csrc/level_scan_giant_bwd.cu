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
// and level_scan_bwd.cu (level_slot.cuh, level_slot_bwd.cuh), so a level's
// arithmetic exists once:
//   1. recompute: one block per updated destination slot runs the forward's
//      slot body on the saved hf with residual outputs and drops the new
//      row: res_e = hf_src | khf | v | attn, res_n = msg | r | z | nw;
//   2. the slot backward on those rows, its cotangent the row of ghf at the
//      slot's node: d_pack's rows, dk | dv, dgi | dbh and dhf_src;
//   3. the source sums: ghf[src] += dhf_src, one block per distinct source,
//      in row order, no atomics;
//   4. the level's share of the five weight gradients, added into the
//      outputs. One level's scratch leaves nothing for a single launch over
//      all saved rows to read, so the sums run across launches: every
//      output entry belongs to one thread of one block, and launches on one
//      stream run in order, so the result is the same on every run with no
//      atomics.
// dk | dv and dgi | dbh are zeroed before each level (the weight-gradient
// kernel reads every row and masks by expert only); the recomputed rows need
// no zeroing: a row the level did not write is multiplied by a zeroed one.
// The TPU kernel's DMA streams of hf and ghf through VMEM, its read-modify-
// write scatter stream, lane padding and chunk loops have no counterpart.
//
// Left for later work: K levels per scratch block to cut the weight-gradient
// launches, a per-slot edge range in place of the scan of all Ep rows (four
// scans per slot here), one persistent launch, CUDA graphs.

#include <cuda_runtime.h>

#include "level_slot.cuh"
#include "level_slot_bwd.cuh"

namespace {

// Launch 1 of a level: the forward's slot body for its residual rows only.
// Grid: one block per destination slot.
__global__ void __launch_bounds__(kMaxDim) level_giant_recompute_kernel(
    const float* __restrict__ pack,    // [Ep, D+2]
    const int* __restrict__ src,       // [Ep]
    const int* __restrict__ dslot,     // [Ep]
    const int* __restrict__ evalid,    // [Ep]
    const int* __restrict__ upd,       // [Np]
    const int* __restrict__ e_n,       // [Np]
    const float* __restrict__ wkv_hf,  // [D, 2TD]
    const float* __restrict__ w_ih,    // [D, 3TD]
    const float* __restrict__ b_ih,    // [T, 3D]
    const float* __restrict__ b_hh,    // [T, 3D]
    const float* __restrict__ wa_k,    // [T, D]
    const float* __restrict__ hf,      // [N, D] the forward's result, read only
    float* __restrict__ score_buf,     // [Ep] scratch
    float* __restrict__ v_buf,         // [Ep, D] scratch
    float* __restrict__ res_e,         // [Ep, 3D+1]
    float* __restrict__ res_n,         // [Np, 4D]
    int ep, int dim, int num_experts) {
  const int slot = blockIdx.x;
  if (upd[slot] == 0) return;  // block-uniform, before any barrier
  level_slot_forward(pack, src, dslot, evalid, slot, e_n[slot], wkv_hf, w_ih, b_ih, b_hh, wa_k,
                     hf, nullptr, score_buf, v_buf, res_e, res_n, ep, dim, num_experts);
}

}  // namespace

extern "C" {

// Backward of mgvae_level_scan_giant_forward over levels [0, num_levels), on
// `stream`. ghf [N, D] is a working copy of hf's cotangent, updated in
// place; hf [N, D] is the forward's result. d_pack [L, Ep, D+2] and the five
// weight gradients must be zeroed by the caller (the gradients are added
// into). One level's scratch: res_e [Ep, 3D+1] and res_n [Np, 4D] zeroed by
// the caller once; dkv [Ep, 2D], dg [Np, 6D] (zeroed here before each
// level), score_buf [Ep], v_buf [Ep, D], dhf_buf [Ep, D], dattn_buf [Ep].
// Returns 0, or the cudaError_t of the first failed call.
int mgvae_level_scan_giant_backward(
    float* ghf, const float* hf, const float* pack_lv,
    const int* lv_src, const int* lv_dslot, const int* lv_evalid,
    const int* lv_nodes, const int* lv_upd, const int* lv_e_n,
    const float* wkv_hf, const float* w_ih, const float* b_ih, const float* b_hh,
    const float* wa_k,
    float* d_pack, float* res_e, float* res_n, float* dkv, float* dg,
    float* score_buf, float* v_buf, float* dhf_buf, float* dattn_buf,
    float* d_wkv, float* d_wih, float* d_bih, float* d_bhh, float* d_wak,
    int num_levels, int ep, int np, int dim, int num_experts, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || num_levels < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = dim, T = num_experts;
  const int threads = (D + 31) / 32 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = num_levels - 1; l >= 0; --l) {
    const size_t eo = static_cast<size_t>(l) * ep, no = static_cast<size_t>(l) * np;
    const float* pack = pack_lv + eo * (D + 2);
    float* d_pack_l = d_pack + eo * (D + 2);
    cudaError_t err = cudaMemsetAsync(dkv, 0, sizeof(float) * ep * 2 * D, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemsetAsync(dg, 0, sizeof(float) * np * 6 * D, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    level_giant_recompute_kernel<<<np, threads, 0, s>>>(
        pack, lv_src + eo, lv_dslot + eo, lv_evalid + eo, lv_upd + no, lv_e_n + no,
        wkv_hf, w_ih, b_ih, b_hh, wa_k, hf, score_buf, v_buf, res_e, res_n, ep, D, T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    level_bwd_slot_kernel<<<np, threads, 0, s>>>(
        ghf, res_e, res_n, lv_dslot + eo, lv_evalid + eo, lv_nodes + no, lv_upd + no,
        lv_e_n + no, wkv_hf, w_ih, b_hh, wa_k, d_pack_l, dkv, dg, dhf_buf, dattn_buf,
        ep, D, T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    level_bwd_source_kernel<<<ep, threads, 0, s>>>(
        ghf, dhf_buf, lv_src + eo, lv_dslot + eo, lv_evalid + eo, lv_upd + no, ep, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_weight_grads(res_e, res_n, d_pack_l, dkv, dg, lv_dslot + eo, lv_e_n + no,
                              d_wkv, d_wih, d_bih, d_bhh, d_wak, 1, ep, np, D, T, true, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
