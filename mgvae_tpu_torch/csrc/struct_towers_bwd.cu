// Backward of the struct-encoder towers (struct_towers.cu), fp32, for
// Hopper (sm_90a).
//
// Replaces mgvae_tpu/ops/pallas/struct_kernel.py::fused_struct_towers_bwd
// (the backward of the custom VJP pallas_struct_core). It reads the
// forward's residuals (nbr | state_in | r | z | nw | gh_n | pre-LN h per
// half-round, tower and node) and recomputes only the LayerNorm statistics.
// Outputs: dxi [2 dir, 2 tower, N, 3D], dwfold / dwhh [2, 2, D, 3D], dbhh
// [2, 2, 3D], dlnw / dlnb [2, D].
//
// What bounds it on this card: the reverse chain of 2R dependent half-rounds,
// each as much fp32 FMA work as a forward half-round (dnbr = dgi W_fold^T and
// dgh W_hh^T per tower), and the weight gradients, ~2 GFLOP of row
// reductions over 2R x N rows that no half-round needs before the end.
//
// What the design does about it:
//   * The reverse sweep is one row launch per half-round, k = 2R-1 .. 0. A
//     block owns kTileRows rows of one tower. It first completes the rows'
//     state cotangent: the direct part the previous launch left (dh z +
//     dgh W_hh^T, or the incoming cotangent for k = 2R-1) plus the
//     transposed neighbor sum of the next half-round's dnbr. That sum
//     gathers over this half-round's own direction lists (the next
//     half-round runs the opposite direction, and the two directions' lists
//     are each other's transpose), in list order: no atomics, where the TPU
//     kernel scattered with one-hot matmuls over the opposite direction's
//     tables. Then the LayerNorm backward (a warp reduction per row), the
//     GRU backward, dxi (+)= dgi in place (one writer per row; a
//     direction's R half-rounds are successive launches), dgi | dgh and
//     dh xhat | dh saved for the weight gradients, and dnbr / dh z + dgh
//     W_hh^T for the next launch (ping-pong buffers), with W_fold^T and
//     W_hh^T staged in shared memory kChunk columns at a time. The launch
//     for k = 0 stops before that last product: the initial state is a
//     constant.
//   * The weight gradients are no longer accumulated inside each step as on
//     the TPU. After the sweep one launch computes partials per (half-round,
//     tower, split of the rows), one block per (product, 32 x 64 output
//     tile) reducing its rows in order (the splits keep ~2.7k blocks in
//     flight at bs16 where whole columns of 5120 rows left the blocks
//     waiting on their loads); a second launch sums the partials over the
//     half-rounds and splits in a fixed order. No atomics: the result is
//     the same on every run.
//   * Tensor cores and one persistent launch are left for later work.

#include <cuda_runtime.h>

#include "struct_common.cuh"

namespace {

struct RowArgs {
  const float* res;      // [2, N, 7D] this half-round's residuals
  const float* dsi_in;   // [2, N, D] direct part of d state_out (or the incoming cotangent)
  const float* dnbr_in;  // [2, N, D] the next half-round's d nbr, or null (k = 2R-1)
  NbrList nbr;           // this half-round's direction lists (the next one's transpose)
  const float* wfold;    // [2, D, 3D] this direction's
  const float* w_hh;     // [2, D, 3D]
  const float* ln_w;     // [2, D], or null: no LayerNorm
  float* dxi;            // [2, N, 3D] this direction's
  int dxi_add;           // 0: the direction's first half-round in the sweep writes
  float* dg;             // [2, N, 6D] dgi | dgh of this half-round
  float* dln;            // [2, N, 2D] dh * xhat | dh of this half-round, or null
  float* dsi_out;        // [2, N, D] dh * z + dgh W_hh^T, or null (k = 0)
  float* dnbr_out;       // [2, N, D] dgi W_fold^T
  int n, dim;
};

template <int CPT>
__global__ void __launch_bounds__(kThreads) struct_bwd_row_kernel(const RowArgs p) {
  extern __shared__ float smem[];
  const int D = p.dim, D3 = 3 * D, N = p.n;
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kTileRows;
  const int ld = D + 1;                    // padded rows of the transposed weights
  float* dgi_s = smem;                     // [kTileRows][3D]
  float* dgh_s = dgi_s + kTileRows * D3;   // [kTileRows][3D]
  float* wft_s = dgh_s + kTileRows * D3;   // [kChunk][D + 1]: W_fold^T chunk
  float* wht_s = wft_s + kChunk * ld;      // [kChunk][D + 1]: W_hh^T chunk
  float dhz[kRowsPerWarp][CPT];

#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int lr = warp * kRowsPerWarp + u, v = row0 + lr;
    if (v >= N) {  // warp-uniform
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        dhz[u][j] = 0.f;
        const int d = lane + 32 * j;
        if (d < D) {
          for (int g = 0; g < 3; ++g) dgi_s[lr * D3 + g * D + d] = dgh_s[lr * D3 + g * D + d] = 0.f;
        }
      }
      continue;
    }
    const size_t o = static_cast<size_t>(t) * N + v;
    // d state_out of this half-round
    float dh[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      dh[j] = d < D ? p.dsi_in[o * D + d] : 0.f;
    }
    if (p.dnbr_in) {
      add_neighbor_sum<CPT>(p.dnbr_in + static_cast<size_t>(t) * N * D, p.nbr, v, D, lane, dh);
    }
    const float* rr = p.res + o * 7 * D;
    float st[CPT], r[CPT], z[CPT], nw[CPT], ghn[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      const bool own = d < D;
      st[j] = own ? rr[D + d] : 0.f;
      r[j] = own ? rr[2 * D + d] : 0.f;
      z[j] = own ? rr[3 * D + d] : 0.f;
      nw[j] = own ? rr[4 * D + d] : 0.f;
      ghn[j] = own ? rr[5 * D + d] : 0.f;
    }
    if (p.ln_w) {
      // y = xhat * w + b, xhat = (h - mean) * rstd; the statistics recomputed
      float pre[CPT], sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = lane + 32 * j;
        pre[j] = d < D ? rr[6 * D + d] : 0.f;
        sum += pre[j];
      }
      const float mean = warp_sum(sum) / D;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float c = pre[j] - mean;
        if (lane + 32 * j < D) sq += c * c;
      }
      const float rstd = rsqrtf(warp_sum(sq) / D + 1e-5f);
      float xhat[CPT], dxh[CPT], s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = lane + 32 * j;
        xhat[j] = d < D ? (pre[j] - mean) * rstd : 0.f;
        dxh[j] = d < D ? dh[j] * p.ln_w[t * D + d] : 0.f;
        if (d < D) {
          p.dln[o * 2 * D + d] = dh[j] * xhat[j];
          p.dln[o * 2 * D + D + d] = dh[j];
        }
        s1 += dxh[j];
        s2 += dxh[j] * xhat[j];
      }
      const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
      for (int j = 0; j < CPT; ++j) dh[j] = rstd * (dxh[j] - m1 - xhat[j] * m2);
    }
    // GRU backward: h = (1 - z) * nw + z * state_in
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      dhz[u][j] = dh[j] * z[j];
      if (d >= D) continue;
      const float dz = dh[j] * (st[j] - nw[j]);
      const float dnw = dh[j] * (1.f - z[j]);
      const float dnu = dnw * (1.f - nw[j] * nw[j]);           // pre-tanh
      const float drho = dnu * ghn[j] * r[j] * (1.f - r[j]);   // pre-sigmoid r
      const float dzeta = dz * z[j] * (1.f - z[j]);            // pre-sigmoid z
      const float dhn = dnu * r[j];
      float* g = p.dg + o * 6 * D;
      g[d] = drho;
      g[D + d] = dzeta;
      g[2 * D + d] = dnu;
      g[3 * D + d] = drho;
      g[4 * D + d] = dzeta;
      g[5 * D + d] = dhn;
      float* x = p.dxi + o * D3;
      if (p.dxi_add) {
        x[d] += drho;
        x[D + d] += dzeta;
        x[2 * D + d] += dnu;
      } else {
        x[d] = drho;
        x[D + d] = dzeta;
        x[2 * D + d] = dnu;
      }
      dgi_s[lr * D3 + d] = drho;
      dgi_s[lr * D3 + D + d] = dzeta;
      dgi_s[lr * D3 + 2 * D + d] = dnu;
      dgh_s[lr * D3 + d] = drho;
      dgh_s[lr * D3 + D + d] = dzeta;
      dgh_s[lr * D3 + 2 * D + d] = dhn;
    }
  }
  if (!p.dsi_out) return;  // block-uniform (k = 0)

  // dnbr = dgi W_fold^T, dsi = dh z + dgh W_hh^T
  float an[kRowsPerWarp][CPT], as[kRowsPerWarp][CPT];
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) an[u][j] = as[u][j] = 0.f;
  }
  const float* wf = p.wfold + static_cast<size_t>(t) * D * D3;
  const float* wh = p.w_hh + static_cast<size_t>(t) * D * D3;
  for (int c0 = 0; c0 < D3; c0 += kChunk) {
    const int kc = min(kChunk, D3 - c0);
    __syncthreads();  // dgi_s / dgh_s are written; the last chunk is read
    for (int i = threadIdx.x; i < D * kChunk; i += kThreads) {
      const int cc = i % kChunk, a = i / kChunk;
      if (cc < kc) {
        wft_s[cc * ld + a] = wf[static_cast<size_t>(a) * D3 + c0 + cc];
        wht_s[cc * ld + a] = wh[static_cast<size_t>(a) * D3 + c0 + cc];
      }
    }
    __syncthreads();
    for (int cc = 0; cc < kc; ++cc) {
      float g[kRowsPerWarp], gh[kRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        const int lr = warp * kRowsPerWarp + u;
        g[u] = dgi_s[lr * D3 + c0 + cc];
        gh[u] = dgh_s[lr * D3 + c0 + cc];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          const float wfv = wft_s[cc * ld + d], whv = wht_s[cc * ld + d];
#pragma unroll
          for (int u = 0; u < kRowsPerWarp; ++u) {
            an[u][j] = fmaf(g[u], wfv, an[u][j]);
            as[u][j] = fmaf(gh[u], whv, as[u][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int v = row0 + warp * kRowsPerWarp + u;
    if (v >= N) continue;
    const size_t o = static_cast<size_t>(t) * N + v;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        p.dnbr_out[o * D + d] = an[u][j];
        p.dsi_out[o * D + d] = dhz[u][j] + as[u][j];
      }
    }
  }
}

// Weight-gradient partials of one (half-round, tower) = blockIdx.y and one
// split of the rows = blockIdx.z: out[i, c] = sum over the split's rows r,
// in order, of A[r, i] * B[r, c] (A = 1 when a_off < 0).
struct GradJob {
  int a_off, lda, wa;      // A = res + a_off (row stride lda), width wa
  int b_dln, b_off, ldb, wb;  // B = (b_dln ? dln : dg) + b_off
  int o_off, ldo;          // out = part + o_off
  int tiles_c, first_block;
};

constexpr int kMaxJobs = 4;
struct GradArgs {
  const float* res;  // [2R, 2, N, 7D]
  const float* dg;   // [2R, 2, N, 6D]
  const float* dln;  // [2R, 2, N, 2D] or null
  float* part;       // [2R, 2, splits, part_size]
  GradJob job[kMaxJobs];
  int jobs, n, dim, part_size, split_rows;
};

constexpr int kGi = 32, kGc = 64, kGk = 32;

__global__ void __launch_bounds__(256) struct_grad_partial_kernel(const GradArgs p) {
  int ji = 0;
  while (ji + 1 < p.jobs && static_cast<int>(blockIdx.x) >= p.job[ji + 1].first_block) ++ji;
  const GradJob& g = p.job[ji];
  const int local = blockIdx.x - g.first_block;
  const int i0 = (local / g.tiles_c) * kGi, c0 = (local % g.tiles_c) * kGc;
  const size_t N = p.n, D = p.dim, kt = blockIdx.y;
  const float* A = g.a_off >= 0 ? p.res + kt * N * 7 * D + g.a_off : nullptr;
  const float* B = (g.b_dln ? p.dln + kt * N * 2 * D : p.dg + kt * N * 6 * D) + g.b_off;
  float* out = p.part + (kt * gridDim.z + blockIdx.z) * p.part_size + g.o_off;
  const int ti = threadIdx.x / 32, tc = threadIdx.x % 32;
  const int r_begin = blockIdx.z * p.split_rows, r_end = min(p.n, r_begin + p.split_rows);

  __shared__ float as[kGk][kGi];
  __shared__ float bs[kGk][kGc];
  float acc[4][2] = {};
  for (int r0 = r_begin; r0 < r_end; r0 += kGk) {
    for (int idx = threadIdx.x; idx < kGk * kGi; idx += 256) {
      const int rr = idx / kGi, ii = idx % kGi, r = r0 + rr, i = i0 + ii;
      float v = 0.f;
      if (r < r_end && i < g.wa) v = A ? A[static_cast<size_t>(r) * g.lda + i] : 1.f;
      as[rr][ii] = v;
    }
    for (int idx = threadIdx.x; idx < kGk * kGc; idx += 256) {
      const int rr = idx / kGc, cc = idx % kGc, r = r0 + rr, c = c0 + cc;
      bs[rr][cc] = (r < r_end && c < g.wb) ? B[static_cast<size_t>(r) * g.ldb + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kGk; ++rr) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = as[rr][ti + 8 * u];
        acc[u][0] = fmaf(a, bs[rr][tc], acc[u][0]);
        acc[u][1] = fmaf(a, bs[rr][tc + 32], acc[u][1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int i = i0 + ti + 8 * u, c = c0 + tc + 32 * v;
      if (i < g.wa && c < g.wb) out[static_cast<size_t>(i) * g.ldo + c] = acc[u][v];
    }
  }
}

GradJob job(int a_off, int lda, int wa, int b_dln, int b_off, int ldb, int wb, int o_off,
            int ldo) {
  GradJob g{};
  g.a_off = a_off; g.lda = lda; g.wa = wa;
  g.b_dln = b_dln; g.b_off = b_off; g.ldb = ldb; g.wb = wb;
  g.o_off = o_off; g.ldo = ldo;
  g.tiles_c = (wb + kGc - 1) / kGc;
  return g;
}

// Sums the partials over the half-rounds and splits, in order: a
// direction's products over its R half-rounds, the LayerNorm's over all 2R.
// One thread per output. Partial layout per (half-round, tower, split):
// [wf D x 3D | wh D x 3D | bh 3D | ln 2D].
__global__ void __launch_bounds__(256) struct_grad_sum_kernel(
    const float* __restrict__ part, float* __restrict__ dwfold, float* __restrict__ dwhh,
    float* __restrict__ dbhh, float* __restrict__ dlnw, float* __restrict__ dlnb,
    int half_rounds, int splits, int dim, int part_size, int layernorm) {
  const int D = dim, D3 = 3 * D, W = D * D3;
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_dir = 4 * (2 * W + D3);  // (dir, tower) outputs
  if (idx < n_dir) {
    const int per = 2 * W + D3;
    const int dt = idx / per, e = idx % per, dir = dt / 2, t = dt % 2;
    float acc = 0.f;
    for (int k = dir; k < half_rounds; k += 2) {
      for (int z = 0; z < splits; ++z) {
        acc += part[((static_cast<size_t>(k) * 2 + t) * splits + z) * part_size + e];
      }
    }
    if (e < W) dwfold[static_cast<size_t>(dt) * W + e] = acc;
    else if (e < 2 * W) dwhh[static_cast<size_t>(dt) * W + e - W] = acc;
    else dbhh[dt * D3 + e - 2 * W] = acc;
    return;
  }
  idx -= n_dir;
  if (idx >= 2 * 2 * D) return;
  const int t = idx / (2 * D), e = idx % (2 * D);
  float acc = 0.f;
  if (layernorm) {
    for (int k = 0; k < half_rounds; ++k) {
      for (int z = 0; z < splits; ++z) {
        acc += part[((static_cast<size_t>(k) * 2 + t) * splits + z) * part_size + 2 * W + D3 + e];
      }
    }
  }
  if (e < D) dlnw[t * D + e] = acc;
  else dlnb[t * D + e - D] = acc;
}

template <int CPT>
int run_sweep(RowArgs p, const float* dstate, const float* res, const float* wfold,
              const float* w_hh, const int* nbr_src, const int* nbr_start, const int* nbr_count,
              float* dxi, float* dg, float* dln, float* carry, int num_rounds, int src_len,
              cudaStream_t s) {
  const int N = p.n, D = p.dim;
  const size_t smem = (2 * static_cast<size_t>(kTileRows) * 3 * D +
                       2 * static_cast<size_t>(kChunk) * (D + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(struct_bwd_row_kernel<CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTileRows - 1) / kTileRows, 2);
  const size_t nd = static_cast<size_t>(N) * D, w = static_cast<size_t>(D) * 3 * D;
  const int R2 = 2 * num_rounds;
  // carry: two ping-pong slots of [dsi | dnbr], each [2, N, D]
  auto dsi = [&](int k) { return carry + static_cast<size_t>(k % 2) * 4 * nd; };
  auto dnbr = [&](int k) { return carry + static_cast<size_t>(k % 2) * 4 * nd + 2 * nd; };
  for (int k = R2 - 1; k >= 0; --k) {
    const int dir = k % 2;
    p.res = res + static_cast<size_t>(k) * 2 * nd * 7;
    p.dsi_in = k == R2 - 1 ? dstate : dsi(k + 1);
    p.dnbr_in = k == R2 - 1 ? nullptr : dnbr(k + 1);
    p.nbr = NbrList{nbr_src + static_cast<size_t>(dir) * src_len, nbr_start + dir * N,
                    nbr_count + dir * N};
    p.wfold = wfold + dir * 2 * w;
    p.w_hh = w_hh + dir * 2 * w;
    p.dxi = dxi + dir * 2 * nd * 3;
    p.dxi_add = k < R2 - 2;
    p.dg = dg + static_cast<size_t>(k) * 2 * nd * 6;
    p.dln = dln ? dln + static_cast<size_t>(k) * 2 * nd * 2 : nullptr;
    p.dsi_out = k > 0 ? dsi(k) : nullptr;
    p.dnbr_out = k > 0 ? dnbr(k) : nullptr;
    struct_bwd_row_kernel<CPT><<<grid, kThreads, smem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Backward of mgvae_struct_towers_forward, on `stream`. dstate [2, N, D] is
// the cotangent of the final state (read only); res [2R, 2, N, 7D] the
// forward's residuals; wfold / w_hh, ln_w (null without LayerNorm) and the
// neighbor lists as in the forward. Outputs, written whole: dxi
// [2, 2, N, 3D], dwfold / dwhh [2, 2, D, 3D], dbhh [2, 2, 3D], dlnw / dlnb
// [2, D] (zero without LayerNorm). Scratch: dg [2R, 2, N, 6D], dln
// [2R, 2, N, 2D] (unused without LayerNorm), carry [2, 2, 2, N, D], part
// [2R, 2, splits, 2 * 3D * D + 5D]; the weight gradients reduce the N rows
// in `splits` contiguous parts. Returns 0, or the cudaError_t of the first
// failed call.
int mgvae_struct_towers_backward(const float* dstate, const float* res, const float* wfold,
                                 const float* w_hh, const float* ln_w, const int* nbr_src,
                                 const int* nbr_start, const int* nbr_count, float* dxi,
                                 float* dwfold, float* dwhh, float* dbhh, float* dlnw, float* dlnb,
                                 float* dg, float* dln, float* carry, float* part, int num_rounds,
                                 int n, int dim, int src_len, int splits, void* stream) {
  if (dim < 1 || dim > kMaxDim || n < 1 || num_rounds < 1 || src_len < 1 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = dim, D3 = 3 * D;
  const bool ln = ln_w != nullptr;
  RowArgs p{};
  p.ln_w = ln_w;
  p.n = n;
  p.dim = dim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dl = ln ? dln : nullptr;
  int code;
  switch ((dim + 31) / 32) {
    case 1: code = run_sweep<1>(p, dstate, res, wfold, w_hh, nbr_src, nbr_start, nbr_count, dxi,
                                dg, dl, carry, num_rounds, src_len, s); break;
    case 2: code = run_sweep<2>(p, dstate, res, wfold, w_hh, nbr_src, nbr_start, nbr_count, dxi,
                                dg, dl, carry, num_rounds, src_len, s); break;
    case 3: code = run_sweep<3>(p, dstate, res, wfold, w_hh, nbr_src, nbr_start, nbr_count, dxi,
                                dg, dl, carry, num_rounds, src_len, s); break;
    default: code = run_sweep<4>(p, dstate, res, wfold, w_hh, nbr_src, nbr_start, nbr_count, dxi,
                                 dg, dl, carry, num_rounds, src_len, s); break;
  }
  if (code != 0) return code;

  const int part_size = 2 * D3 * D + 5 * D;
  GradArgs g{};
  g.res = res;
  g.dg = dg;
  g.dln = dl;
  g.part = part;
  g.n = n;
  g.dim = D;
  g.part_size = part_size;
  g.split_rows = (n + splits - 1) / splits;
  // nbr^T dgi, state_in^T dgh, sum dgh, and with LayerNorm sum [dh xhat | dh]
  g.job[0] = job(0, 7 * D, D, 0, 0, 6 * D, D3, 0, D3);
  g.job[1] = job(D, 7 * D, D, 0, D3, 6 * D, D3, D * D3, D3);
  g.job[2] = job(-1, 0, 1, 0, D3, 6 * D, D3, 2 * D * D3, D3);
  g.job[3] = job(-1, 0, 1, 1, 0, 2 * D, 2 * D, 2 * D * D3 + D3, 2 * D);
  g.jobs = ln ? 4 : 3;
  int blocks = 0;
  for (int i = 0; i < g.jobs; ++i) {
    g.job[i].first_block = blocks;
    blocks += ((g.job[i].wa + kGi - 1) / kGi) * g.job[i].tiles_c;
  }
  struct_grad_partial_kernel<<<dim3(blocks, 2 * 2 * num_rounds, splits), 256, 0, s>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outputs = 4 * (2 * D * D3 + D3) + 4 * D;
  struct_grad_sum_kernel<<<(outputs + 255) / 256, 256, 0, s>>>(
      part, dwfold, dwhh, dbhh, dlnw, dlnb, 2 * num_rounds, splits, D, part_size, ln ? 1 : 0);
  err = cudaGetLastError();
  return err == cudaSuccess ? 0 : static_cast<int>(err);
}

}  // extern "C"
