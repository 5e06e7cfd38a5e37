// Struct-encoder towers forward (DirectMultiGCN source and target towers),
// with fp32 or bf16 values, for Hopper (sm_90a).
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
// What bounds it on this card: fp32 FMA throughput, and the latency of the
// gather and epilogue, which run on all SMs at once. At bs16 / D = 64
// (N = 5120) a half-round is two [N, D] x [D, 3D] products per tower, 0.50
// GFLOP, 7.5 us at the card's fp32 peak (67 TFLOP/s), against ~10 MB of
// traffic (~28 MB with residuals, 8 us at 3.35 TB/s); the half-rounds are
// 2R dependent launches. Measured (PERF.md, section 6): the one-row-at-a-
// time kernel this replaces spent 26 of its 44 us a half-round in the
// products, paced by shared-memory loads (2.4 FMAs a load) and run in 1.2
// waves (128 registers a thread, two 256-thread blocks an SM).
//
// What the design does about it:
//   * A warp owns kRows = 8 rows of one tower, kWarps = 4 warps a block
//     (grid.y = tower; one launch per half-round over both towers, reading
//     one state buffer and writing the other). At bs16 the 320 blocks (64
//     KB of shared memory, ~160 registers a thread) are resident at once,
//     up to three an SM. Blocks of 2, 3, 5 or 6 warps, chunks of 8 rows and
//     epilogue groups of 2 rows were slower; a 128-register limit with
//     8-row chunks (four blocks an SM) was faster on the giant batch and
//     slower at bs16.
//   * The neighbor sums of the warp's 8 rows are gathered together
//     (for_each_neighbor: three round trips for all rows, the neighbor rows
//     kGatherBatch at a time), the rows' own state loads beside them. Each
//     entry is added into its row's column of the warp's k-major tile in
//     shared memory, in list order (no atomics). Summed in a register array
//     (add_neighbor_sums, as the backward does) the compiler put the sums
//     in local memory (a stack frame, STL / LDL), which cost ~25 us a call
//     at bs16 and ~0.45 ms on the giant batch. The TPU kernel
//     summed neighbors with one-hot MXU products over triangular source
//     windows instead (Mosaic has no dynamic row gather).
//   * The products are a register tile: a lane holds 8 rows x CPT columns x
//     4 sums (r, z, gi_n, gh_n). The rows' nbr and state sit k-major in the
//     warp's tile, so two float4 broadcast loads give one feature of 4 rows
//     of each, and one weight load feeds 8 rows (6 FMAs a shared load).
//     W_fold and W_hh pass through shared memory Layout::kChunk rows at a
//     time, each gate padded to DP = 32 CPT columns (constant loop bounds
//     and offsets, no predicate), double-buffered with asynchronous copies:
//     the next chunk is in flight while this one is used, and the first is
//     started before the gather. Staging both matrices whole (96 KB at
//     D = 64) would allow two blocks an SM where the chunks allow three,
//     and bs16 needs 2.4.
//   * The GRU, the residual rows and the LayerNorm are the epilogue, G rows
//     at a time with their xi loads in flight together; a row lives in one
//     warp, so its mean and variance are warp reductions. nbr and state_in
//     go to the residuals right after the gather.
//   * The gates use the card's fast exponential and division (sigmoid,
//     tanh_gate below): 5-9% of the time, ~5e-6 on the state.
//   * Every output's sums are in a fixed order (neighbors in list order, k
//     ascending, the FMA chains of the kernel this replaces): bitwise
//     repeatable.
//   Tensor cores (TF32 would break parity with the plain version) are left
//   for a TF32 mode. Starting each launch early (programmatic dependent
//   launch, its index loads and first weight copy before the previous
//   half-round ends) saved 2-4% at bs16 and nothing on the giant batch;
//   not taken.
//
// Values: fp32, or bf16 (the JAX package's throughput mode,
// struct_kernel.py:158-162): xi, the state and the residuals are then bf16 in
// memory, nbr is rounded before its product (:144), the residuals (:158) and
// the new state (:162) as they are written; the neighbor sums, the products,
// the GRU and the LayerNorm stay fp32. The weights are the wrapper's fp32
// copies either way (exact for bf16 weights), staged as before.
//
// Residuals (training): res [2R, 2, N, 7D] = nbr | state_in | r | z | nw |
// gh_n | pre-LN h per half-round, tower and node, unpadded; the backward
// (struct_towers_bwd.cu) recomputes nothing of the forward from them but
// the LayerNorm statistics.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "struct_common.cuh"

namespace {

constexpr int kRows = 8;   // rows a warp owns
constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = kRows * kWarps;

// Shared-memory layout of one CPT = ceil(D / 32): weight rows a chunk holds,
// the padded width of a gate, the epilogue's row group, and the block's
// floats: two buffers of [2 matrix][kChunk][3][DP] weights, then each warp's
// [2][DP][kRows] nbr and state tile.
template <int CPT>
struct Layout {
  static constexpr int DP = 32 * CPT;
  static constexpr int kChunk = CPT <= 2 ? 16 : 8;
  static constexpr int kGroup = CPT <= 2 ? 4 : 2;
  static constexpr int kWFloats = 2 * kChunk * 3 * DP;  // one buffer
  static constexpr int kFloats = 2 * kWFloats + kWarps * 2 * DP * kRows;
};

// The GRU's gates from the card's fast exponential and division (__expf,
// __fdividef): the state within ~5e-6 of expf / tanhf's after 8
// half-rounds, and 5-9% less time a call (PERF.md, section 6). Both saturate
// to the right limits (__expf's inf and 0).
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }
__device__ __forceinline__ float tanh_gate(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}

template <class V>
struct FwdArgs {
  const V* state_in;      // [2, N, D] tower-stacked
  V* state_out;           // [2, N, D]
  const V* xi;            // [2, N, 3D] this direction's XI
  const float* wfold;     // [2, D, 3D] this direction's W_aggr @ W_ih[:D]
  const float* w_hh;      // [2, D, 3D]
  const float* b_hh;      // [2, 3D]
  const float* ln_w;      // [2, D]; null: no LayerNorm
  const float* ln_b;      // [2, D]
  NbrList nbr;            // this direction's neighbor lists
  V* res;                 // [2, N, 7D] this half-round's residuals, or null
  int n, dim;
};

template <int CPT, class V>
__global__ void __launch_bounds__(kThreads) struct_fwd_kernel(const FwdArgs<V> p) {
  using L = Layout<CPT>;
  constexpr int DP = L::DP, KC = L::kChunk, G = L::kGroup;
  extern __shared__ __align__(16) float smem[];
  const int D = p.dim, D3 = 3 * D, N = p.n, t = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v0 = blockIdx.x * kTileRows + warp * kRows;
  const bool live = v0 < N;  // warp-uniform; a warp past N still joins the block's barriers
  const size_t tN = static_cast<size_t>(t) * N;
  float* tile = smem + 2 * L::kWFloats + static_cast<size_t>(warp) * 2 * DP * kRows;
  const V* __restrict__ state = p.state_in + tN * D;
  const float* __restrict__ wf = p.wfold + static_cast<size_t>(t) * D * D3;
  const float* __restrict__ wh = p.w_hh + static_cast<size_t>(t) * D * D3;
  const int n_chunks = (D + KC - 1) / KC;

  // Weight rows [c KC, c KC + KC) of W_fold and W_hh into buffer c & 1 as
  // [matrix][row][gate][DP], zeros past D (columns, and rows in the last chunk).
  auto fetch_w = [&](int c) {
    float* dst = smem + (c & 1) * L::kWFloats;
    const size_t off = static_cast<size_t>(c) * KC * D3;
    if (D == DP) {  // rows of 3D floats, contiguous: 16-byte copies
      for (int i = 4 * threadIdx.x; i < KC * D3; i += 4 * kThreads) {
        __pipeline_memcpy_async(dst + i, wf + off + i, 4 * sizeof(float));
        __pipeline_memcpy_async(dst + KC * D3 + i, wh + off + i, 4 * sizeof(float));
      }
    } else {
      for (int i = threadIdx.x; i < KC * 3 * DP; i += kThreads) {
        const int k = c * KC + i / (3 * DP), q = i / DP % 3, d = i % DP;
        const size_t src = static_cast<size_t>(k) * D3 + q * D + d;
        if (k < D && d < D) {
          __pipeline_memcpy_async(dst + i, wf + src, sizeof(float));
          __pipeline_memcpy_async(dst + KC * 3 * DP + i, wh + src, sizeof(float));
        } else {
          dst[i] = dst[KC * 3 * DP + i] = 0.f;
        }
      }
    }
    __pipeline_commit();
  };
  fetch_w(0);  // lands during the gather

  // 1. the rows' states and neighbor sums (zeros past D and past N), the
  //    sums added into the warp's tile in list order; nbr and state_in to
  //    the residuals
  float* tile_n = tile + lane * kRows;  // column `lane` of the nbr half; + 32 kRows a j
  float* tile_s = tile_n + DP * kRows;  // ... of the state half
  float st[kRows][CPT];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      st[u][j] = v0 + u < N && d < D ? to_float(state[static_cast<size_t>(v0 + u) * D + d]) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    float4* tn = reinterpret_cast<float4*>(tile_n + 32 * j * kRows);
    tn[0] = tn[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const auto add_to_tile = [&](int r, const float (&v)[CPT]) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) tile_n[32 * j * kRows + r] += v[j];
  };
  for_each_neighbor<kRows, CPT, V>(state, p.nbr, v0, N, D, lane, add_to_tile);
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    if constexpr (IsBf16<V>::value) {   // nbr rounded before its product
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        tile_n[32 * j * kRows + u] = round_to<V>(tile_n[32 * j * kRows + u]);
      }
    }
    float4* ts = reinterpret_cast<float4*>(tile_s + 32 * j * kRows);
    ts[0] = make_float4(st[0][j], st[1][j], st[2][j], st[3][j]);
    ts[1] = make_float4(st[4][j], st[5][j], st[6][j], st[7][j]);
  }
  if (p.res) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      const float4* tn = reinterpret_cast<const float4*>(tile_n + 32 * j * kRows);
      const float4 lo = tn[0], hi = tn[1];
      const float nb[kRows] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (v0 + u < N && d < D) {
          V* res = p.res + (tN + v0 + u) * 7 * D;
          res[d] = from_float<V>(nb[u]);
          res[D + d] = from_float<V>(st[u][j]);
        }
      }
    }
  }

  // 2. a_r = (nbr W_fold + state W_hh)[:, r], a_z likewise,
  //    a_n = (nbr W_fold)[:, n], a_hn = (state W_hh)[:, n], k ascending
  float a_r[kRows][CPT], a_z[kRows][CPT], a_n[kRows][CPT], a_hn[kRows][CPT];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) a_r[u][j] = a_z[u][j] = a_n[u][j] = a_hn[u][j] = 0.f;
  }
  for (int c = 0; c < n_chunks; ++c) {
    __pipeline_wait_prior(0);
    __syncthreads();  // the chunk has landed (and the tiles are written); the other buffer is free
    if (c + 1 < n_chunks) fetch_w(c + 1);
    if (!live) continue;
    const float* wfs = smem + (c & 1) * L::kWFloats + lane;
    const float* whs = wfs + KC * 3 * DP;
    const float4* xs = reinterpret_cast<const float4*>(tile) + c * KC * 2;
    const float4* ss = reinterpret_cast<const float4*>(tile + DP * kRows) + c * KC * 2;
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float4 x0 = xs[2 * kk], x1 = xs[2 * kk + 1];
      const float4 s0 = ss[2 * kk], s1 = ss[2 * kk + 1];
      const float x[kRows] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float s[kRows] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float* fr = wfs + kk * 3 * DP;
      const float* hr = whs + kk * 3 * DP;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float fr_r = fr[32 * j], fr_z = fr[DP + 32 * j], fr_n = fr[2 * DP + 32 * j];
        const float hr_r = hr[32 * j], hr_z = hr[DP + 32 * j], hr_n = hr[2 * DP + 32 * j];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          a_r[u][j] = fmaf(x[u], fr_r, fmaf(s[u], hr_r, a_r[u][j]));
          a_z[u][j] = fmaf(x[u], fr_z, fmaf(s[u], hr_z, a_z[u][j]));
          a_n[u][j] = fmaf(x[u], fr_n, a_n[u][j]);
          a_hn[u][j] = fmaf(s[u], hr_n, a_hn[u][j]);
        }
      }
    }
  }
  if (!live) return;

  // 3. GRU, residuals, LayerNorm, the new state, G rows at a time
  const float* bh = p.b_hh + static_cast<size_t>(t) * D3;
  float b[3][CPT], lw[CPT], lb[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int d = lane + 32 * j;
#pragma unroll
    for (int q = 0; q < 3; ++q) b[q][j] = d < D ? bh[q * D + d] : 0.f;
    lw[j] = p.ln_w && d < D ? p.ln_w[t * D + d] : 0.f;
    lb[j] = p.ln_w && d < D ? p.ln_b[t * D + d] : 0.f;
  }
#pragma unroll
  for (int g0 = 0; g0 < kRows; g0 += G) {
    float xr[G][3][CPT], sv[G][CPT], h[G][CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {  // the group's state_in from the tile
      const float* ts = tile + (DP + lane + 32 * j) * kRows + g0;
      if constexpr (G == 4) {
        const float4 v = *reinterpret_cast<const float4*>(ts);
        sv[0][j] = v.x; sv[1][j] = v.y; sv[2][j] = v.z; sv[3][j] = v.w;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(ts);
        sv[0][j] = v.x; sv[1][j] = v.y;
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int v = v0 + g0 + u;
      const V* xrow = p.xi + (tN + v) * D3;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = lane + 32 * j;
#pragma unroll
        for (int q = 0; q < 3; ++q) xr[u][q][j] = v < N && d < D ? to_float(xrow[q * D + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int v = v0 + g0 + u, w = g0 + u;
      V* res = p.res && v < N ? p.res + (tN + v) * 7 * D : nullptr;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = lane + 32 * j;
        const float r = sigmoid(a_r[w][j] + xr[u][0][j] + b[0][j]);
        const float z = sigmoid(a_z[w][j] + xr[u][1][j] + b[1][j]);
        const float gh_n = a_hn[w][j] + b[2][j];
        const float nw = tanh_gate(a_n[w][j] + xr[u][2][j] + r * gh_n);
        h[u][j] = d < D ? (1.f - z) * nw + z * sv[u][j] : 0.f;
        if (res && d < D) {
          res[2 * D + d] = from_float<V>(r);
          res[3 * D + d] = from_float<V>(z);
          res[4 * D + d] = from_float<V>(nw);
          res[5 * D + d] = from_float<V>(gh_n);
          res[6 * D + d] = from_float<V>(h[u][j]);
        }
      }
    }
    if (p.ln_w) {
      float mean[G], rstd[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        mean[u] = 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) mean[u] += h[u][j];
      }
      warp_sums<G>(mean);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        mean[u] /= D;
        rstd[u] = 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float c = h[u][j] - mean[u];
          if (lane + 32 * j < D) rstd[u] += c * c;
        }
      }
      warp_sums<G>(rstd);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        rstd[u] = rsqrtf(rstd[u] / D + 1e-5f);
#pragma unroll
        for (int j = 0; j < CPT; ++j) h[u][j] = (h[u][j] - mean[u]) * rstd[u] * lw[j] + lb[j];
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int v = v0 + g0 + u;
      if (v >= N) continue;  // warp-uniform
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = lane + 32 * j;
        if (d < D) p.state_out[(tN + v) * D + d] = from_float<V>(h[u][j]);
      }
    }
  }
}

template <int CPT, class V>
int run_forward(FwdArgs<V> p, const V* xi, const float* wfold, const float* w_hh,
                const float* b_hh, const int* nbr_src, const int* nbr_start,
                const int* nbr_count, V* state, V* scratch, V* res,
                int num_rounds, int src_len, cudaStream_t s) {
  // past 48 KB of dynamic shared memory: allowed once per device (the layout
  // depends on CPT alone)
  constexpr size_t smem = Layout<CPT>::kFloats * sizeof(float);
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};  // 0: not yet; else the cudaError_t + 1
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[dev]) {
    allowed[dev] = 1 + static_cast<int>(cudaFuncSetAttribute(
        struct_fwd_kernel<CPT, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  }
  if (allowed[dev] != 1) return allowed[dev] - 1;
  const int N = p.n, D = p.dim;
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
    struct_fwd_kernel<CPT, V><<<grid, kThreads, smem, s>>>(p);
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
// given (training) or null. xi, state, scratch and res hold bf16 with `bf16`
// set, else fp32; the weights are fp32. Returns 0, or the cudaError_t of the
// first failed call.
int mgvae_struct_towers_forward(const void* xi, const float* wfold, const float* w_hh,
                                const float* b_hh, const float* ln_w, const float* ln_b,
                                const int* nbr_src, const int* nbr_start, const int* nbr_count,
                                void* state, void* scratch, void* res, int num_rounds, int n,
                                int dim, int src_len, int bf16, void* stream) {
  if (dim < 1 || dim > kMaxDim || n < 1 || num_rounds < 1 || src_len < 1 ||
      (ln_w == nullptr) != (ln_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = 0;
  MGVAE_WITH_VALUE(bf16, {
    FwdArgs<V> p{};
    p.ln_w = ln_w;
    p.ln_b = ln_b;
    p.n = n;
    p.dim = dim;
    MGVAE_WITH_NF(dim, code = run_forward<NF, V>(
                           p, static_cast<const V*>(xi), wfold, w_hh, b_hh, nbr_src, nbr_start,
                           nbr_count, static_cast<V*>(state), static_cast<V*>(scratch),
                           static_cast<V*>(res), num_rounds, src_len, s));
  });
  return code;
}

// The launch layout of mgvae_struct_towers_forward at (n, dim): out = {grid
// x, grid y, threads a block, dynamic shared memory bytes, weight rows a
// chunk, rows a warp}. Returns 0, or cudaErrorInvalidValue.
int mgvae_struct_towers_forward_layout(int n, int dim, int* out) {
  if (dim < 1 || dim > kMaxDim || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  MGVAE_WITH_NF(dim, {
    out[0] = (n + kTileRows - 1) / kTileRows;
    out[1] = 2;
    out[2] = kThreads;
    out[3] = static_cast<int>(Layout<NF>::kFloats * sizeof(float));
    out[4] = Layout<NF>::kChunk;
    out[5] = kRows;
  });
  return 0;
}

}  // extern "C"
