// Struct-encoder towers forward (DirectMultiGCN source and target towers),
// fp32, for Hopper (sm_90a).
//
// Replaces mgvae_tpu/ops/pallas/struct_kernel.py::fused_struct_towers, with
// and without its residual outputs. Per half-round k (direction k % 2:
// forward edges, then reversed) and per tower t, for every node v:
//   nbr[v] = sum of state[u] over v's neighbors u of this direction
//   gi = nbr @ W_fold + XI,   gh = state @ W_hh + b_hh       (AggConv folded)
//   r = sigmoid(gi_r + gh_r), z = sigmoid(gi_z + gh_z),
//   nw = tanh(gi_n + r * gh_n), h = (1 - z) * nw + z * state
//   state' = LayerNorm_t(h)   (the tower's one LayerNorm, after every half-round)
// The state starts as ones; the node features enter only through XI.
//
// What bounds it on this card: fp32 FMA issue and launches. At bs16 / D = 64
// (N = 5120) a half-round is two [N, D] x [D, 3D] products per tower, about
// 0.5 GFLOP, and ~10 MB of traffic (~30 MB with residuals): a few
// microseconds of memory time against ~8 us of the card's fp32 FMA peak
// (67 TFLOP/s). 2 * num_rounds dependent launches per call.
//
// What the design does about it:
//   * The TPU kernel summed neighbors with one-hot MXU matmuls over
//     triangular source windows (Mosaic has no dynamic row gather). Here a
//     warp sums its rows' neighbor rows with plain indexed loads, in list
//     order: no atomics, the same result on every run.
//   * The TPU kernel ran all half-rounds in one grid with the state resident
//     in VMEM. CUDA blocks run in no order and every node reads other
//     nodes' state, so here each half-round is one launch over both towers
//     (grid.y = tower), reading one state buffer and writing the other
//     (ping-pong).
//   * Both products run in the block's body from shared memory: the tile's
//     nbr and state rows, and W_fold / W_hh staged kChunk rows at a time
//     (all of D = 128 does not fit). Each thread keeps 4 rows x CPT columns
//     x 4 sums (r, z, gi_n, gh_n) in registers. Tensor cores (TF32 would
//     break parity) and one persistent launch are left for later work.
//   * The GRU, the residual rows and the LayerNorm are the epilogue; a row
//     lives in one warp, so its mean and variance are warp reductions.
//
// Residuals (training): res [2R, 2, N, 7D] = nbr | state_in | r | z | nw |
// gh_n | pre-LN h per half-round, tower and node, unpadded; the backward
// (struct_towers_bwd.cu) recomputes nothing of the forward from them but
// the LayerNorm statistics.

#include <cuda_runtime.h>

#include "struct_common.cuh"

namespace {

struct FwdArgs {
  const float* state_in;  // [2, N, D] tower-stacked
  float* state_out;       // [2, N, D]
  const float* xi;        // [2, N, 3D] this direction's XI
  const float* wfold;     // [2, D, 3D] this direction's W_aggr @ W_ih[:D]
  const float* w_hh;      // [2, D, 3D]
  const float* b_hh;      // [2, 3D]
  const float* ln_w;      // [2, D]; null: no LayerNorm
  const float* ln_b;      // [2, D]
  NbrList nbr;            // this direction's neighbor lists
  float* res;             // [2, N, 7D] this half-round's residuals, or null
  int n, dim;
};

template <int CPT>
__global__ void __launch_bounds__(kThreads) struct_fwd_kernel(const FwdArgs p) {
  extern __shared__ float smem[];
  const int D = p.dim, D3 = 3 * D, N = p.n;
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kTileRows;
  float* nbr_s = smem;                    // [kTileRows][D]
  float* st_s = nbr_s + kTileRows * D;    // [kTileRows][D]
  float* wf_s = st_s + kTileRows * D;     // [kChunk][3D]
  float* wh_s = wf_s + kChunk * D3;       // [kChunk][3D]
  const float* state = p.state_in + static_cast<size_t>(t) * N * D;

  // 1. the tile's neighbor sums and states
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int lr = warp * kRowsPerWarp + u, v = row0 + lr;
    float acc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
    if (v < N) add_neighbor_sum<CPT>(state, p.nbr, v, D, lane, acc);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        nbr_s[lr * D + d] = acc[j];
        st_s[lr * D + d] = v < N ? state[static_cast<size_t>(v) * D + d] : 0.f;
      }
    }
  }

  // 2. a_r = (nbr W_fold + state W_hh)[:, r], a_z likewise,
  //    a_n = (nbr W_fold)[:, n], a_hn = (state W_hh)[:, n]
  float a_r[kRowsPerWarp][CPT], a_z[kRowsPerWarp][CPT];
  float a_n[kRowsPerWarp][CPT], a_hn[kRowsPerWarp][CPT];
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) a_r[u][j] = a_z[u][j] = a_n[u][j] = a_hn[u][j] = 0.f;
  }
  const float* wf = p.wfold + static_cast<size_t>(t) * D * D3;
  const float* wh = p.w_hh + static_cast<size_t>(t) * D * D3;
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    const int kc = min(kChunk, D - k0);
    __syncthreads();  // the tiles of step 1 are written; the last chunk is read
    for (int i = threadIdx.x; i < kc * D3; i += kThreads) {
      wf_s[i] = wf[static_cast<size_t>(k0) * D3 + i];
      wh_s[i] = wh[static_cast<size_t>(k0) * D3 + i];
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float x[kRowsPerWarp], s[kRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        const int lr = warp * kRowsPerWarp + u;
        x[u] = nbr_s[lr * D + k0 + kk];
        s[u] = st_s[lr * D + k0 + kk];
      }
      const float* fr = wf_s + kk * D3;
      const float* hr = wh_s + kk * D3;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          const float fr_r = fr[d], fr_z = fr[D + d], fr_n = fr[2 * D + d];
          const float hr_r = hr[d], hr_z = hr[D + d], hr_n = hr[2 * D + d];
#pragma unroll
          for (int u = 0; u < kRowsPerWarp; ++u) {
            a_r[u][j] = fmaf(x[u], fr_r, fmaf(s[u], hr_r, a_r[u][j]));
            a_z[u][j] = fmaf(x[u], fr_z, fmaf(s[u], hr_z, a_z[u][j]));
            a_n[u][j] = fmaf(x[u], fr_n, a_n[u][j]);
            a_hn[u][j] = fmaf(s[u], hr_n, a_hn[u][j]);
          }
        }
      }
    }
  }

  // 3. GRU, residuals, LayerNorm, the new state
  const float* bh = p.b_hh + static_cast<size_t>(t) * D3;
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int lr = warp * kRowsPerWarp + u, v = row0 + lr;
    if (v >= N) continue;  // warp-uniform
    const size_t o = static_cast<size_t>(t) * N + v;
    const float* xr = p.xi + o * D3;
    float* res = p.res ? p.res + o * 7 * D : nullptr;
    float h[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      h[j] = 0.f;
      if (d < D) {
        const float r = sigmoid(a_r[u][j] + xr[d] + bh[d]);
        const float z = sigmoid(a_z[u][j] + xr[D + d] + bh[D + d]);
        const float gh_n = a_hn[u][j] + bh[2 * D + d];
        const float nw = tanhf(a_n[u][j] + xr[2 * D + d] + r * gh_n);
        const float st = st_s[lr * D + d];
        h[j] = (1.f - z) * nw + z * st;
        if (res) {
          res[d] = nbr_s[lr * D + d];
          res[D + d] = st;
          res[2 * D + d] = r;
          res[3 * D + d] = z;
          res[4 * D + d] = nw;
          res[5 * D + d] = gh_n;
          res[6 * D + d] = h[j];
        }
      }
    }
    if (p.ln_w) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) sum += h[j];
      const float mean = warp_sum(sum) / D;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float c = h[j] - mean;
        if (lane + 32 * j < D) sq += c * c;
      }
      const float rstd = rsqrtf(warp_sum(sq) / D + 1e-5f);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = lane + 32 * j;
        if (d < D) h[j] = (h[j] - mean) * rstd * p.ln_w[t * D + d] + p.ln_b[t * D + d];
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      if (d < D) p.state_out[o * D + d] = h[j];
    }
  }
}

template <int CPT>
int run_forward(FwdArgs p, const float* xi, const float* wfold, const float* w_hh,
                const float* b_hh, const int* nbr_src, const int* nbr_start,
                const int* nbr_count, float* state, float* scratch, float* res,
                int num_rounds, int src_len, cudaStream_t s) {
  const int N = p.n, D = p.dim;
  const size_t smem =
      (2 * static_cast<size_t>(kTileRows) * D + 2 * static_cast<size_t>(kChunk) * 3 * D) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(struct_fwd_kernel<CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTileRows - 1) / kTileRows, 2);
  const size_t nd = static_cast<size_t>(N) * D, w = static_cast<size_t>(D) * 3 * D;
  for (int k = 0; k < 2 * num_rounds; ++k) {
    const int dir = k % 2;
    p.state_in = k % 2 == 0 ? state : scratch;  // 2R half-rounds: the last writes `state`
    p.state_out = k % 2 == 0 ? scratch : state;
    p.xi = xi + dir * 2 * nd * 3;
    p.wfold = wfold + dir * 2 * w;
    p.w_hh = w_hh + dir * 2 * w;
    p.b_hh = b_hh + dir * 2 * 3 * D;
    p.nbr = NbrList{nbr_src + static_cast<size_t>(dir) * src_len, nbr_start + dir * N,
                    nbr_count + dir * N};
    p.res = res ? res + static_cast<size_t>(k) * 2 * nd * 7 : nullptr;
    struct_fwd_kernel<CPT><<<grid, kThreads, smem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Runs 2 * num_rounds half-rounds of both towers, one launch each, on
// `stream`. Layouts (dir 0 = forward edges, 1 = reversed; tower 0 = source,
// 1 = target): xi [2 dir, 2 tower, N, 3D]; wfold / w_hh [2, 2, D, 3D];
// b_hh [2, 2, 3D]; ln_w / ln_b [2 tower, D], both null without LayerNorm;
// nbr_src [2 dir, src_len], nbr_start / nbr_count [2 dir, N] int32. `state`
// [2, N, D] holds the initial state (ones) and receives the final one;
// `scratch` [2, N, D] is the other ping-pong buffer. res [2R, 2, N, 7D] is
// given (training) or null. Returns 0, or the cudaError_t of the first
// failed call.
int mgvae_struct_towers_forward(const float* xi, const float* wfold, const float* w_hh,
                                const float* b_hh, const float* ln_w, const float* ln_b,
                                const int* nbr_src, const int* nbr_start, const int* nbr_count,
                                float* state, float* scratch, float* res, int num_rounds, int n,
                                int dim, int src_len, void* stream) {
  if (dim < 1 || dim > kMaxDim || n < 1 || num_rounds < 1 || src_len < 1 ||
      (ln_w == nullptr) != (ln_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdArgs p{};
  p.ln_w = ln_w;
  p.ln_b = ln_b;
  p.n = n;
  p.dim = dim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((dim + 31) / 32) {
    case 1: return run_forward<1>(p, xi, wfold, w_hh, b_hh, nbr_src, nbr_start, nbr_count, state,
                                  scratch, res, num_rounds, src_len, s);
    case 2: return run_forward<2>(p, xi, wfold, w_hh, b_hh, nbr_src, nbr_start, nbr_count, state,
                                  scratch, res, num_rounds, src_len, s);
    case 3: return run_forward<3>(p, xi, wfold, w_hh, b_hh, nbr_src, nbr_start, nbr_count, state,
                                  scratch, res, num_rounds, src_len, s);
    default: return run_forward<4>(p, xi, wfold, w_hh, b_hh, nbr_src, nbr_start, nbr_count, state,
                                   scratch, res, num_rounds, src_len, s);
  }
}

}  // extern "C"
