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
//   * The TPU kernel's one-hot gathers and scatters, source windows, class
//     tiers and expert-stacked matmuls over all T experts are gone: a block
//     reads only its slot's expert.
//   * Weights are read from global memory (L2); shared-memory staging,
//     wgmma and one persistent launch are left for later work.
//
// Thread d of a block owns feature d (blockDim = D rounded up to a warp).

#include <cuda_runtime.h>

#include "level_common.cuh"

namespace {

// Phase A, first launch of a level: one block per destination slot.
__global__ void __launch_bounds__(kMaxDim) level_bwd_slot_kernel(
    const float* __restrict__ ghf,     // [N, D] cotangent of hf (this level's nodes read)
    const float* __restrict__ res_e,   // [Ep, 3D+1] hf_src | khf | v | attn
    const float* __restrict__ res_n,   // [Np, 4D] msg | r | z | nw
    const int* __restrict__ dslot,     // [Ep]
    const int* __restrict__ evalid,    // [Ep]
    const int* __restrict__ nodes,     // [Np]
    const int* __restrict__ upd,       // [Np]
    const int* __restrict__ e_n,       // [Np]
    const float* __restrict__ wkv_hf,  // [D, 2TD]
    const float* __restrict__ w_ih,    // [D, 3TD]
    const float* __restrict__ b_hh,    // [T, 3D]
    const float* __restrict__ wa_k,    // [T, D]
    float* __restrict__ d_pack,        // [Ep, D+2]: dv | dscore written
    float* __restrict__ dkv,           // [Ep, 2D]: dk | dv, for phase B
    float* __restrict__ dg,            // [Np, 6D]: dgi | dbh, for phase B
    float* __restrict__ dhf_buf,       // [Ep, D]: dhf_src, for the source sums
    float* dattn_buf,                  // [Ep] scratch
    int ep, int dim, int num_experts) {
  const int slot = blockIdx.x;
  if (upd[slot] == 0) return;  // block-uniform, before any barrier

  __shared__ float dgi_s[3 * kMaxDim];
  __shared__ float dk_s[kMaxDim];
  __shared__ float dv_s[kMaxDim];
  __shared__ float red[kMaxWarps];
  __shared__ unsigned masks[kMaxWarps];

  const int D = dim, T = num_experts;
  const int d = threadIdx.x;
  const bool own = d < D;
  const int e = e_n[slot];
  const size_t pw = D + 2;
  const size_t ew = 3 * (size_t)D + 1;
  const size_t kv_stride = 2 * (size_t)T * D;
  const size_t g_stride = 3 * (size_t)T * D;

  // GRU backward with h = 0: h_new = (1 - z) * nw, nw = tanh(i_n + r * b_hn)
  if (own) {
    const float* rn = res_n + (size_t)slot * 4 * D;
    const float r = rn[D + d], z = rn[2 * D + d], nw = rn[3 * D + d];
    const float g = ghf[(size_t)nodes[slot] * D + d];
    const float dnw = g * (1.f - z);
    const float dz = -g * nw;
    const float dnu = dnw * (1.f - nw * nw);                  // pre-tanh
    const float dr = dnu * b_hh[(size_t)e * 3 * D + 2 * D + d];
    const float dzeta = dz * z * (1.f - z);                   // pre-sigmoid z
    const float drho = dr * r * (1.f - r);                    // pre-sigmoid r
    dgi_s[d] = drho;
    dgi_s[D + d] = dzeta;
    dgi_s[2 * D + d] = dnu;
    float* o = dg + (size_t)slot * 6 * D;
    o[d] = drho;
    o[D + d] = dzeta;
    o[2 * D + d] = dnu;
    o[3 * D + d] = drho;
    o[4 * D + d] = dzeta;
    o[5 * D + d] = dnu * r;
  }
  __syncthreads();

  // dmsg = dgi . w_ih[:, expert e]^T: thread d reads row d of the block
  float dmsg = 0.f;
  if (own) {
    const float* row = w_ih + (size_t)d * g_stride + (size_t)e * 3 * D;
    for (int c = 0; c < 3 * D; ++c) dmsg = fmaf(dgi_s[c], row[c], dmsg);
  }

  // pass 1: dv = attn * dmsg, dattn = v . dmsg, and sum attn * dattn
  float s_grp = 0.f;
  for_each_in_edge(dslot, evalid, ep, slot, masks, [&](int j) {
    const float* re = res_e + j * ew;
    const float a = re[3 * D];
    const float dattn = block_sum(own ? re[2 * D + d] * dmsg : 0.f, red);
    if (d == 0) dattn_buf[j] = dattn;
    s_grp = fmaf(a, dattn, s_grp);
    if (own) {
      const float dv = a * dmsg;
      d_pack[j * pw + d] = dv;
      dkv[(size_t)j * 2 * D + D + d] = dv;
    }
  });

  // pass 2: softmax backward, dk = dscore * wa_k[e], and
  // dhf_src = dk . wk_e^T + dv . wv_e^T
  const float wa = own ? wa_k[(size_t)e * D + d] : 0.f;
  const float* wk = wkv_hf + (size_t)e * D;
  const float* wv = wkv_hf + (size_t)(T + e) * D;
  for_each_in_edge(dslot, evalid, ep, slot, masks, [&](int j) {
    const float a = res_e[j * ew + 3 * D];
    const float dscore = a * (dattn_buf[j] - s_grp);
    if (d == 0) d_pack[j * pw + D] = dscore;
    if (own) {
      const float dk = dscore * wa;
      dkv[(size_t)j * 2 * D + d] = dk;
      dk_s[d] = dk;
      dv_s[d] = a * dmsg;
    }
    __syncthreads();
    if (own) {
      const float* wkr = wk + (size_t)d * kv_stride;
      const float* wvr = wv + (size_t)d * kv_stride;
      float h = 0.f;
      for (int c = 0; c < D; ++c) h = fmaf(dk_s[c], wkr[c], fmaf(dv_s[c], wvr[c], h));
      dhf_buf[(size_t)j * D + d] = h;
    }
    __syncthreads();  // dk_s / dv_s are rewritten by the next edge
  });
}

// Phase A, second launch of a level: ghf[src] += the level's dhf_src rows.
// One block per edge row; only the first live row of each distinct source
// works, summing all live rows of that source in row order.
__global__ void __launch_bounds__(kMaxDim) level_bwd_source_kernel(
    float* __restrict__ ghf,            // [N, D]
    const float* __restrict__ dhf_buf,  // [Ep, D]
    const int* __restrict__ src,        // [Ep]
    const int* __restrict__ dslot,      // [Ep]
    const int* __restrict__ evalid,     // [Ep]
    const int* __restrict__ upd,        // [Np]
    int ep, int dim) {
  // a row is live when the slot kernel wrote its dhf_src
  auto live = [&](int k) { return evalid[k] != 0 && upd[dslot[k]] != 0; };
  const int j = blockIdx.x;
  if (!live(j)) return;  // block-uniform
  const int s = src[j];
  for (int base = 0; base < j; base += blockDim.x) {
    const int k = base + threadIdx.x;
    if (__syncthreads_or(k < j && live(k) && src[k] == s)) return;  // not the first
  }
  __shared__ unsigned masks[kMaxWarps];
  const int d = threadIdx.x;
  const bool own = d < dim;
  float acc = 0.f;
  for_each_row(j, ep, masks, [&](int k) { return live(k) && src[k] == s; },
               [&](int k) { if (own) acc += dhf_buf[(size_t)k * dim + d]; });
  if (own) ghf[(size_t)s * dim + d] += acc;
}

// Phase B: out[i, col(e, c)] = sum over rows r of expert e of A[r, i] * B[r, c].
struct ExpertGemm {
  const float* a;        // A rows at a + r * lda, width wa; null: A = 1 (wa = 1)
  const float* b;        // B rows at b + r * ldb, width wb
  const int* row_slot;   // null: row r's expert is e_n[r]; else e_n[(r / ep) * np + row_slot[r]]
  float* out;            // out[i * ldo + (c / seg) * T * seg + e * seg + c % seg]
  int lda, wa, ldb, wb, rows, ldo, seg;
  int tiles_i, tiles_c, first_block;
};

constexpr int kMaxGemms = 5;
struct ExpertGemms {
  ExpertGemm g[kMaxGemms];
  const int* e_n;        // [L, Np]
  int count, ep, np, num_experts;
};

constexpr int kTileI = 8, kTileC = 32, kChunk = 64;

__global__ void __launch_bounds__(kTileI * kTileC) expert_gemm_kernel(const ExpertGemms p) {
  int gi = 0;
  while (gi + 1 < p.count && static_cast<int>(blockIdx.x) >= p.g[gi + 1].first_block) ++gi;
  const ExpertGemm& g = p.g[gi];
  int local = blockIdx.x - g.first_block;
  const int per_expert = g.tiles_i * g.tiles_c;
  const int e = local / per_expert;
  local %= per_expert;
  const int i0 = (local / g.tiles_c) * kTileI, c0 = (local % g.tiles_c) * kTileC;
  const int tc = threadIdx.x % kTileC, ti = threadIdx.x / kTileC;

  __shared__ float as[kChunk][kTileI];
  __shared__ float bs[kChunk][kTileC];
  __shared__ int ex[kChunk];
  float acc = 0.f;
  for (int r0 = 0; r0 < g.rows; r0 += kChunk) {
    if (threadIdx.x < kChunk) {
      const int r = r0 + threadIdx.x;
      int x = -1;
      if (r < g.rows) {
        x = g.row_slot ? p.e_n[(size_t)(r / p.ep) * p.np + g.row_slot[r]] : p.e_n[r];
      }
      ex[threadIdx.x] = x;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kChunk * kTileC; idx += blockDim.x) {
      const int rr = idx / kTileC, c = c0 + idx % kTileC;
      bs[rr][idx % kTileC] =
          (ex[rr] == e && c < g.wb) ? g.b[(size_t)(r0 + rr) * g.ldb + c] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kChunk * kTileI; idx += blockDim.x) {
      const int rr = idx / kTileI, i = i0 + idx % kTileI;
      float v = 0.f;
      if (ex[rr] == e && i < g.wa) v = g.a ? g.a[(size_t)(r0 + rr) * g.lda + i] : 1.f;
      as[rr][idx % kTileI] = v;
    }
    __syncthreads();
#pragma unroll 16
    for (int k = 0; k < kChunk; ++k) acc = fmaf(as[k][ti], bs[k][tc], acc);
    __syncthreads();
  }
  const int i = i0 + ti, c = c0 + tc;
  if (i < g.wa && c < g.wb) {
    g.out[(size_t)i * g.ldo + (size_t)(c / g.seg) * p.num_experts * g.seg +
          (size_t)e * g.seg + c % g.seg] = acc;
  }
}

ExpertGemm gemm(const float* a, int lda, int wa, const float* b, int ldb, int wb,
                const int* row_slot, int rows, float* out, int ldo, int seg) {
  ExpertGemm g{};
  g.a = a; g.lda = lda; g.wa = wa;
  g.b = b; g.ldb = ldb; g.wb = wb;
  g.row_slot = row_slot; g.rows = rows;
  g.out = out; g.ldo = ldo; g.seg = seg;
  g.tiles_i = (wa + kTileI - 1) / kTileI;
  g.tiles_c = (wb + kTileC - 1) / kTileC;
  return g;
}

}  // namespace

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

  const int erows = num_levels * ep, nrows = num_levels * np;
  ExpertGemms p{};
  p.e_n = lv_e_n;
  p.ep = ep;
  p.np = np;
  p.num_experts = T;
  // d_wkv[:, k | v block of expert e] = hf_src^T (dk | dv)
  p.g[0] = gemm(res_e, 3 * D + 1, D, dkv, 2 * D, 2 * D, lv_dslot, erows, d_wkv, 2 * T * D, D);
  // d_wak[e] = sum dscore * khf
  p.g[1] = gemm(d_pack + D, D + 2, 1, res_e + D, 3 * D + 1, D, lv_dslot, erows, d_wak, T * D, D);
  // d_wih[:, expert e block] = msg^T dgi
  p.g[2] = gemm(res_n, 4 * D, D, dg, 6 * D, 3 * D, nullptr, nrows, d_wih, 3 * T * D, 3 * D);
  // d_bih[e] = sum dgi, d_bhh[e] = sum dbh
  p.g[3] = gemm(nullptr, 0, 1, dg, 6 * D, 3 * D, nullptr, nrows, d_bih, 3 * T * D, 3 * D);
  p.g[4] = gemm(nullptr, 0, 1, dg + 3 * D, 6 * D, 3 * D, nullptr, nrows, d_bhh, 3 * T * D, 3 * D);
  p.count = kMaxGemms;
  int blocks = 0;
  for (int i = 0; i < p.count; ++i) {
    p.g[i].first_block = blocks;
    blocks += T * p.g[i].tiles_i * p.g[i].tiles_c;
  }
  expert_gemm_kernel<<<blocks, kTileI * kTileC, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : static_cast<int>(err);
}

}  // extern "C"
