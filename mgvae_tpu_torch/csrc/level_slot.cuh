// What one destination slot of one level computes in the forward, shared by
// the fused level scan (level_scan.cu) and the single-level step
// (level_step.cu): gather hf[src] of the slot's in-edges, the hf-side
// key/value of the slot's expert, the masked segment softmax over the
// in-edges, msg = sum attn * v, then a GRU step with h = 0. The two kernels
// differ only in where hf is read from and where the new row goes.
#pragma once

#include "level_common.cuh"

namespace {

// Called by every thread of the block that owns `slot` (thread d owns
// feature d; blockDim = D rounded up to a warp), with `e` the slot's expert.
// Reads the sources' rows from `hf` and writes the slot's new row to
// `out_row` [D]; `hf` and `out_row` may lie in one array (the fused scan
// writes a row of a higher level than any it reads); a null `out_row` drops
// the row (the giant backward recomputes a level for its residuals only,
// level_scan_giant_bwd.cu). With res_e / res_n given it also writes the
// slot's residual rows (see level_scan.cu).
__device__ __forceinline__ void level_slot_forward(
    const float* __restrict__ pack,    // [Ep, D+2]: [vhs | score_static | expert]
    const int* __restrict__ src,       // [Ep] source node of each in-edge
    const int* __restrict__ dslot,     // [Ep] destination slot
    const int* __restrict__ evalid,    // [Ep] edge valid
    int slot, int e,
    const float* __restrict__ wkv_hf,  // [D, 2TD] = [wk_hf (TD) | wv_hf (TD)]
    const float* __restrict__ w_ih,    // [D, 3TD]
    const float* __restrict__ b_ih,    // [T, 3D]
    const float* __restrict__ b_hh,    // [T, 3D]
    const float* __restrict__ wa_k,    // [T, D]
    const float* hf,                   // [N, D]
    float* out_row,                    // [D] or null
    float* __restrict__ score_buf,     // [Ep] scratch
    float* __restrict__ v_buf,         // [Ep, D] scratch
    float* __restrict__ res_e,         // [Ep, 3D+1] or null
    float* __restrict__ res_n,         // [Np, 4D] or null
    int ep, int D, int T) {
  __shared__ float h_src[kMaxDim];
  __shared__ float msg_s[kMaxDim];
  __shared__ float red[kMaxWarps];
  __shared__ unsigned masks[kMaxWarps];

  const int d = threadIdx.x;
  const bool own = d < D;
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
    if (out_row) out_row[d] = (1.f - z) * n;
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
