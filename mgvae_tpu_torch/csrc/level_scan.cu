// Fused level-recurrence forward of DG_AE (num_rounds == 1), fp32, for
// Hopper (sm_90a).
//
// Replaces mgvae_tpu/ops/pallas/level_kernel.py::fused_level_scan (C == 1),
// with and without its residual outputs. Per DAG level and per destination
// slot: gather hf[src] of the slot's in-edges, the hf-side key/value of the
// destination's expert, the masked segment softmax over the in-edges,
// msg = sum attn * v, then a GRU step with h = 0, written to hf[node].
//
// What bounds it on this card: latency and launches. At bs16 / D = 64 a
// level has ~100 destinations of fan-in 1-3: a few hundred KFLOP and a few
// hundred KB of weights (L2-resident) per level, one launch per level, ~50
// launches per batch. Neither FLOPs nor bytes come near the card's limits.
//
// What the design does about it:
//   * The TPU kernel computed all T experts and selected with a mask, and
//     gathered/scattered rows with one-hot matmuls (Mosaic has no dynamic
//     row gather). Here a block owns one destination slot and so one
//     expert: it reads only that expert's [D, 2D] and [D, 3D] weight
//     columns (T times fewer FLOPs), gathers hf rows with plain indexed
//     loads and writes its row directly.
//   * CUDA blocks run in no order, so the level dependency is explicit: one
//     launch per real level on the caller's stream (the host loop below).
//     hf lives in global memory; the caller zeroes it.
//   * Weights are read from global memory (L2). Staging them in shared
//     memory, one persistent launch with a grid-wide barrier, CUDA graphs
//     and wgmma are left for later work.
//
// Residuals (training): with res_e / res_n given, each updated slot also
// writes, for the backward kernel (level_scan_bwd.cu), per in-edge
// res_e [Ep, 3D+1] = hf_src | khf | v | attn and per slot
// res_n [Np, 4D] = msg | r | z | nw, unpadded. Rows of slots that are not
// updated, of padding edges and of padding levels are left as the caller
// gave them (zeroed) and are never read.
//
// Thread d of a block owns feature d (blockDim = D rounded up to a warp).
// An edge's expert is its destination's, so every in-edge of a slot uses the
// slot's expert e_n[slot] (the pack's expert column holds the same value).
// Each slot's in-edges are visited in row order, the same on every thread,
// so the result does not depend on scheduling.

#include <cuda_runtime.h>

#include "level_common.cuh"

namespace {

// One level. Grid: one block per destination slot of the level.
__global__ void __launch_bounds__(kMaxDim) level_kernel(
    const float* __restrict__ pack,    // [Ep, D+2]: [vhs | score_static | expert]
    const int* __restrict__ src,       // [Ep] source node of each in-edge
    const int* __restrict__ dslot,     // [Ep] destination slot
    const int* __restrict__ evalid,    // [Ep] edge valid
    const int* __restrict__ nodes,     // [Np] node id of each slot
    const int* __restrict__ upd,       // [Np] update mask
    const int* __restrict__ e_n,       // [Np] expert of each slot
    const float* __restrict__ wkv_hf,  // [D, 2TD] = [wk_hf (TD) | wv_hf (TD)]
    const float* __restrict__ w_ih,    // [D, 3TD]
    const float* __restrict__ b_ih,    // [T, 3D]
    const float* __restrict__ b_hh,    // [T, 3D]
    const float* __restrict__ wa_k,    // [T, D]
    float* hf,                         // [N, D]: sources read, this level's rows written
    float* __restrict__ score_buf,     // [Ep] scratch
    float* __restrict__ v_buf,         // [Ep, D] scratch
    float* __restrict__ res_e,         // [Ep, 3D+1] or null
    float* __restrict__ res_n,         // [Np, 4D] or null
    int ep, int dim, int num_experts) {
  const int slot = blockIdx.x;
  if (upd[slot] == 0) return;  // block-uniform, before any barrier

  __shared__ float h_src[kMaxDim];
  __shared__ float msg_s[kMaxDim];
  __shared__ float red[kMaxWarps];
  __shared__ unsigned masks[kMaxWarps];

  const int D = dim, T = num_experts;
  const int d = threadIdx.x;
  const bool own = d < D;
  const int e = e_n[slot];
  const size_t pw = D + 2;
  const size_t ew = 3 * (size_t)D + 1;
  const size_t kv_stride = 2 * (size_t)T * D;
  const float* wk = wkv_hf + (size_t)e * D;           // expert e's key columns
  const float* wv = wkv_hf + (size_t)(T + e) * D;     // expert e's value columns
  const float wa = own ? wa_k[(size_t)e * D + d] : 0.f;

  // pass 1: score and value of each in-edge, and their max
  float smax = -1e30f;
  for_each_in_edge(dslot, evalid, ep, slot, masks, [&](int j) {
    if (own) h_src[d] = hf[(size_t)src[j] * D + d];
    __syncthreads();
    float k = 0.f, v = 0.f;
    if (own) {
      for (int i = 0; i < D; ++i) {
        const float h = h_src[i];
        k = fmaf(h, wk[i * kv_stride + d], k);
        v = fmaf(h, wv[i * kv_stride + d], v);
      }
    }
    // block_sum's barriers also keep h_src alive until every thread read it
    const float score = pack[j * pw + D] + block_sum(own ? k * wa : 0.f, red);
    if (own) {
      v += pack[j * pw + d];
      v_buf[(size_t)j * D + d] = v;
      if (res_e) {
        float* re = res_e + j * ew;
        re[d] = h_src[d];   // this thread's own write: no barrier needed
        re[D + d] = k;
        re[2 * D + d] = v;
      }
    }
    if (d == 0) score_buf[j] = score;
    smax = fmaxf(smax, score);
  });

  // pass 2: masked softmax over the slot's in-edges (shift clipped to
  // [-80, 0], +1e-16 on the normalizer) and the message
  float den = 0.f, acc = 0.f;
  for_each_in_edge(dslot, evalid, ep, slot, masks, [&](int j) {
    const float ex = expf(fminf(fmaxf(score_buf[j] - smax, -80.f), 0.f));
    den += ex;
    if (own) acc = fmaf(ex, v_buf[(size_t)j * D + d], acc);
  });
  const float msg = acc / (den + 1e-16f);
  if (own) msg_s[d] = msg;
  if (res_e) {  // block-uniform: every thread takes part in the row scan
    // pass 3 (training only): each in-edge's softmax weight
    for_each_in_edge(dslot, evalid, ep, slot, masks, [&](int j) {
      if (d == 0) {
        res_e[j * ew + 3 * D] = expf(fminf(fmaxf(score_buf[j] - smax, -80.f), 0.f)) /
                                (den + 1e-16f);
      }
    });
  }
  __syncthreads();

  // GRU step with h = 0: gi = msg @ w_ih[:, e] + b_ih[e], gh = b_hh[e]
  if (own) {
    const size_t g_stride = 3 * (size_t)T * D;
    const float* wi = w_ih + (size_t)e * 3 * D;
    float gr = 0.f, gz = 0.f, gn = 0.f;
    for (int i = 0; i < D; ++i) {
      const float m = msg_s[i];
      const float* row = wi + i * g_stride;
      gr = fmaf(m, row[d], gr);
      gz = fmaf(m, row[D + d], gz);
      gn = fmaf(m, row[2 * D + d], gn);
    }
    const float* bi = b_ih + (size_t)e * 3 * D;
    const float* bh = b_hh + (size_t)e * 3 * D;
    const float r = 1.f / (1.f + expf(-(gr + bi[d] + bh[d])));
    const float z = 1.f / (1.f + expf(-(gz + bi[D + d] + bh[D + d])));
    const float n = tanhf(gn + bi[2 * D + d] + r * bh[2 * D + d]);
    hf[(size_t)nodes[slot] * D + d] = (1.f - z) * n;
    if (res_n) {
      float* rn = res_n + (size_t)slot * 4 * D;
      rn[d] = msg;
      rn[D + d] = r;
      rn[2 * D + d] = z;
      rn[3 * D + d] = n;
    }
  }
}

}  // namespace

extern "C" {

// Runs levels [0, num_levels) of the level tables, one launch per level on
// `stream`. Tables are [L, Ep] / [L, Np] row-major int32, pack_lv is
// [L, Ep, D+2]. res_e [L, Ep, 3D+1] and res_n [L, Np, 4D] are both given
// (training) or both null. Returns 0, or the cudaError_t of the first
// failed launch.
int mgvae_level_scan_forward(
    const float* pack_lv, const int* lv_src, const int* lv_dslot, const int* lv_evalid,
    const int* lv_nodes, const int* lv_upd, const int* lv_e_n,
    const float* wkv_hf, const float* w_ih, const float* b_ih, const float* b_hh,
    const float* wa_k, float* hf, float* score_buf, float* v_buf, float* res_e, float* res_n,
    int num_levels, int ep, int np, int dim, int num_experts, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || num_levels < 0 || (res_e == nullptr) != (res_n == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (dim + 31) / 32 * 32;
  const size_t ew = 3 * static_cast<size_t>(dim) + 1, nw = 4 * static_cast<size_t>(dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < num_levels; ++l) {
    const size_t eo = static_cast<size_t>(l) * ep, no = static_cast<size_t>(l) * np;
    level_kernel<<<np, threads, 0, s>>>(
        pack_lv + eo * (dim + 2), lv_src + eo, lv_dslot + eo, lv_evalid + eo,
        lv_nodes + no, lv_upd + no, lv_e_n + no,
        wkv_hf, w_ih, b_ih, b_hh, wa_k, hf, score_buf, v_buf,
        res_e ? res_e + eo * ew : nullptr, res_n ? res_n + no * nw : nullptr,
        ep, dim, num_experts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* mgvae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
