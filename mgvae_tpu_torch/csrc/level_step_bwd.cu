// Backward of the level recurrence one level per launch (num_rounds == 1),
// with fp32 or bf16 values, for Hopper (sm_90a): the single-level step's,
// and the step route's.
//
// Replaces mgvae_tpu/ops/pallas/level_kernel.py::level_step_bwd_call
// (_level_step_bwd_kernel, the backward of the custom VJP
// pallas_level_step), and what jax.vjp makes of the lax.scan over it in
// mgvae_tpu/models/dg_ae.py::_level_scan_step.
//   * mgvae_level_step_backward: one level. From the cotangent g [Np, D] of
//     h_new and the forward's residuals (level_step.cu) it gives d_pack
//     [Ep, D+2] = [dv | dscore | 0], the weight gradients d_wkv [D, 2TD],
//     d_wih [D, 3TD], d_bih / d_bhh [T, 3D], d_wak [T, D], and a dense
//     d_hf [N, D]: the gradient of the hf the step read.
//   * mgvae_level_scan_step_backward: the route's. A reverse sweep over the
//     level indices on a carried ghf, the contiguous copy of hf's cotangent
//     updated in place, as the fused backward's sweep: per level index l,
//     from the last down to 0, one launch of the slot backward for all
//     chunks (each slot's cotangent is ghf's row at its node) and one of the
//     source sums (each source's gradient added into ghf's row at the
//     source). The five weight gradients are added into one set of outputs.
//
// What bounds it on this card: latency, launches and the host. Driven a
// call per (chunk, level), each call writes a dense d_hf (2.6 MB at
// N_sub = 10240, D = 64) and five weight gradients that autograd then sums,
// ~100 of each per batch, at ~0.4 ms of host time a call; so the route
// makes one host call a pass and sums in place.
//
// What the design does about it: the bodies of level_scan_bwd.cu
// (level_slot_bwd.cuh), the chunk in blockIdx.y. A warp per updated
// destination slot, in blocks that hold their expert's weight slices in
// shared memory: GRU backward, attention backward, dk | dv and dhf_src per
// in-edge of the level's list. Then the level's live rows, listed by source:
// the warp that finds a source's first row sums that source's dhf_src rows
// in row order and adds once, no atomics. The route keeps the slot phase's
// dk | dv and dgi | dbh for K level indices at a time (chunk_levels: a byte
// budget, ops/level_kernel.step_chunk_levels), and after each K level
// indices runs the weight-gradient tiles once per chunk over that chunk's
// contiguous rows: a partial per level and their pairwise sum added into
// the outputs, chunks in order: a fixed order, the same result on every
// run. The TPU kernel's source windows, one-hot scatters and
// expert-stacked products are gone.
//
// bf16 values (the JAX package's step backward runs _level_bwd_body, as the
// fused backward does): g, the residuals, d_pack, d_hf and the route's
// carried ghf are bf16 in memory and rounded where kernel 2 rounds them
// (level_slot_bwd.cuh, R = V): a level's sources' sums are rounded before
// and after they are added into ghf, as where the JAX scan's transpose adds
// a level's bf16 d_hf into its bf16 carry (mgvae_tpu/models/dg_ae.py:
// 629-652). Each in-edge's dhf_src is then a D x 2D product against wk_e^T
// (a copy the wrapper makes) and wv_e^T, and dscore goes to an fp32 buffer
// for d_wak. The weight gradients sum in fp32.

#include <cuda_runtime.h>

#include "level_slot_bwd.cuh"

extern "C" {

// Backward of mgvae_level_step_forward, three launches on `stream`. d_pack
// [Ep, D+2] and d_hf [N, D] must be zeroed by the caller; dkv [Ep, 2D],
// dg [Np, 6D] and dhf_buf [Ep, D] are scratch that needs no fill. grads holds
// the five weight gradients end to end (d_wkv, d_wih, d_bih, d_bhh, d_wak),
// written whole. The lists are one level's; wkv_e [T, 2, D, D] is the
// expert-major copy of wkv_hf, wvt_e [T, D, D] and wiht_e [T, 3D, D] the
// transposed slices of wv and w_ih. With `bf16` g, res_e, res_n, d_pack and
// d_hf hold bf16, and wkt_e [T, DP, DP] (wk_e transposed) and dscore [Ep]
// (fp32 scratch) are given; else they are null and those arrays fp32.
// Returns 0, or the cudaError_t of the first failed launch.
int mgvae_level_step_backward(
    const void* g, const void* res_e, const void* res_n, const int* src,
    const int* slot_rows, const int* slot_off, const int* in_rows, const int* in_off,
    const int* src_rows, const float* wkv_e, const float* wvt_e, const float* wiht_e,
    const float* b_hh, const float* wa_k, void* d_pack, float* dkv, float* dg, float* dhf_buf,
    float* grads, void* d_hf, const float* wkt_e, float* dscore, int ep, int np, int dim,
    int num_experts, int bf16, void* stream) {
  if (bad_dims(ep, np, dim, num_experts) || (bf16 && (wkt_e == nullptr || dscore == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LevelBwd lv{src, slot_rows, slot_off, in_rows, in_off, src_rows};
  cudaError_t err = cudaSuccess;
  MGVAE_WITH_VALUE(bf16, {
    const StepBackward<V> p{lv, static_cast<const V*>(g), nullptr, static_cast<const V*>(res_e),
                            static_cast<const V*>(res_n), wkv_e, wvt_e, wiht_e, b_hh, wa_k,
                            static_cast<V*>(d_pack), dkv, dg, dhf_buf, static_cast<V*>(d_hf),
                            wkt_e, dscore, 0, 0, 0, 0, ep, np, dim, num_experts};
    MGVAE_WITH_NF(dim, err = launch_level_backward<NF, V>(p, 1, s));
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_weight_grads(res_e, res_n, d_pack, dkv, dg, lv, grads, nullptr,
                                              1, 1, ep, np, dim, num_experts, false, s, nullptr,
                                              bf16, bf16 ? dscore : nullptr));
}

// Backward of mgvae_level_scan_step_forward with residuals, on `stream`.
// ghf [chunks * n_sub, D] is a working copy of hf's cotangent, updated in
// place; res_e [R, Ep, 3D+1], res_n [R, Np, 4D], the tables (lv_src [R, Ep],
// lv_nodes [R, Np]) and the lists are all R = chunks * rows rows'; `levels`:
// each chunk's real level count (host memory), as the forward had it.
// d_pack [R, Ep, D+2] and grads (the five weight gradients end to end,
// added into) must be zeroed by the caller. The level indices are taken
// from the top in blocks of K = chunk_levels; scratch of one block, none of
// which needs a fill: dkv [chunks, K, Ep, 2D], dg [chunks, K, Np, 6D],
// dhf_buf [chunks, Ep, D] and, when K > 1, partial [K, weight-gradient
// floats]. With `bf16` ghf, res_e, res_n and d_pack hold bf16, and wkt_e
// [T, DP, DP] (wk_e transposed) and dscore [chunks, K, Ep] (fp32 scratch)
// are given; else they are null and those arrays fp32. Adds to *launched
// (host memory) one for each kernel it enqueues. Returns 0, or the
// cudaError_t of the first failed launch.
int mgvae_level_scan_step_backward(
    void* ghf, const void* res_e, const void* res_n, const int* lv_src, const int* lv_nodes,
    const int* slot_rows, const int* slot_off, const int* in_rows, const int* in_off,
    const int* src_rows, const float* wkv_e, const float* wvt_e, const float* wiht_e,
    const float* b_hh, const float* wa_k, void* d_pack, float* dkv, float* dg, float* dhf_buf,
    float* grads, float* partial, const float* wkt_e, float* dscore, const int* levels,
    int* launched, int chunks, int rows, int chunk_levels, int n_sub, int ep, int np, int dim,
    int num_experts, int bf16, void* stream) {
  if (bad_dims(ep, np, dim, num_experts) || chunks < 1 || rows < 1 || chunk_levels < 1 ||
      n_sub < 1 || levels == nullptr || launched == nullptr ||
      (chunk_levels > 1 && partial == nullptr) ||
      (bf16 && (wkt_e == nullptr || dscore == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int top_all = 0;
  for (int k = 0; k < chunks; ++k) {
    if (levels[k] < 0 || levels[k] > rows) return static_cast<int>(cudaErrorInvalidValue);
    top_all = levels[k] > top_all ? levels[k] : top_all;
  }
  const int D = dim, T = num_experts, K = chunk_levels;
  const size_t ew = 3 * (size_t)D + 1, vb = bf16 ? 2 : 4;   // bytes of a value
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LevelBwd all{lv_src, slot_rows, slot_off, in_rows, in_off, src_rows};
  // row r of a value array of row width `width` values
  const auto row_of = [&](const void* x, size_t r, size_t width) {
    return static_cast<const void*>(static_cast<const char*>(x) + r * width * vb);
  };
  for (int top = top_all; top > 0; top -= K) {
    const int l0 = top > K ? top - K : 0;
    for (int l = top - 1; l >= l0; --l) {
      cudaError_t err = cudaSuccess;
      MGVAE_WITH_VALUE(bf16, {
        const StepBackward<V> p{all, static_cast<const V*>(ghf), lv_nodes,
                                static_cast<const V*>(res_e), static_cast<const V*>(res_n),
                                wkv_e, wvt_e, wiht_e, b_hh, wa_k, static_cast<V*>(d_pack),
                                dkv + (size_t)(l - l0) * ep * 2 * D,
                                dg + (size_t)(l - l0) * np * 6 * D, dhf_buf,
                                static_cast<V*>(ghf), wkt_e,
                                dscore ? dscore + (size_t)(l - l0) * ep : nullptr,
                                l, rows, K, n_sub, ep, np, D, T};
        MGVAE_WITH_NF(D, err = launch_level_backward<NF, V>(p, chunks, s));
      });
      if (err != cudaSuccess) return static_cast<int>(err);
      *launched += 2;
    }
    // the weight gradients of this block's rows, chunk by chunk: rows
    // [l0, min(top, levels[k])) of chunk k, contiguous in every array
    for (int k = 0; k < chunks; ++k) {
      const int m = (levels[k] < top ? levels[k] : top) - l0;
      if (m < 1) continue;
      const size_t r = (size_t)k * rows + l0;
      const cudaError_t err = launch_weight_grads(
          row_of(res_e, r * ep, ew), row_of(res_n, r * np, 4 * D), row_of(d_pack, r * ep, D + 2),
          dkv + (size_t)k * K * ep * 2 * D, dg + (size_t)k * K * np * 6 * D,
          level_of(all, static_cast<int>(r), ep, np, T), grads, partial, m, 1, ep, np, D, T,
          true, s, launched, bf16, bf16 ? dscore + (size_t)k * K * ep : nullptr);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

}  // extern "C"
