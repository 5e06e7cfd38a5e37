// Backward of the struct-encoder towers (struct_towers.cu), with fp32 or
// bf16 residuals, for Hopper (sm_90a).
//
// Replaces mgvae_tpu/ops/pallas/struct_kernel.py::fused_struct_towers_bwd
// (the backward of the custom VJP pallas_struct_core). It reads the
// forward's residuals (nbr | state_in | r | z | nw | gh_n | pre-LN h per
// half-round, tower and node) and recomputes only the LayerNorm statistics.
// Outputs: dxi [2 dir, 2 tower, N, 3D], dwfold / dwhh [2, 2, D, 3D], dbhh
// [2, 2, 3D], dlnw / dlnb [2, D].
//
// What bounds it on this card: fp32 FMA work. Per half-round and tower,
// two row products (dnbr = dgi W_fold^T, dgh W_hh^T: 2 x 3D x D per row)
// and two weight-gradient products of the same size (nbr^T dgi,
// state_in^T dgh), ~1 GFLOP a half-round at bs16, in a chain of 2R
// dependent half-rounds.
//
// What the design does about it:
//   * Per half-round k = 2R-1 .. 0, a row launch and then a partial launch;
//     one sum launch at the end (4R + 1 launches). The scratch holds one
//     half-round: dg = [drho | dzeta | dnu | dhn] [2, N, 4D] (dgi is its
//     first three blocks, dgh the first two and the fourth), each warp's
//     column sums [2, N / 8, 5D], and d nbr in two ping-pong slots; the
//     direct part of the state cotangent is updated in place in the
//     wrapper's copy of the incoming cotangent (each row's is read and
//     written by the warp that owns the row).
//   * Row launch: a warp owns kRows = 8 rows of one tower. It completes the
//     rows' state cotangent (the direct part, plus the transposed neighbor
//     sum of the next half-round's dnbr, gathered over this half-round's own
//     direction lists in list order, all the warp's rows batched:
//     add_neighbor_sums), then the LayerNorm and GRU backward with each
//     group of rows' residuals and dxi loaded at once. dxi (+)= dgi in place
//     (one writer per row; a direction's R half-rounds are successive
//     launches). The rows' dg go to global memory for the partials, their
//     sums over the warp's rows (db_hh's and the LayerNorm's terms) beside
//     them, and dg k-major into the warp's shared memory for the two
//     products: a lane holds 8 rows x CPT columns of each, one pair of
//     float4 loads of the rows feeds both products over the first 2D
//     columns, and the transposed weights (a copy the wrapper makes per
//     call) pass through shared memory kWChunk rows at a time with the next
//     chunk's asynchronous copy in flight (the first one during the row
//     work).
//   * Partial launch: the weight gradients of half-round k per split of
//     the rows, 64 x 64 output tiles with 8 x 8 outputs a thread from
//     16-row chunks staged in shared memory (the next chunk is loaded into
//     registers while the current one is used), and the column sums over
//     the split from the warps' sums. Each block adds its tile into the
//     partial [2 dir, 2 tower, splits, 6D^2 + 5D] of its direction in place,
//     in half-round order, as the TPU kernel accumulates into its outputs.
//   * Sum launch: the partials over the splits in order (the LayerNorm's
//     over both directions too). No atomics anywhere: every output is the
//     same on every run.
//   * bf16 values (the JAX package's throughput mode): the residuals are
//     bf16, and the state's cotangent is rounded to bf16 where it is
//     complete (the direct part plus the neighbor sum), as the JAX kernel
//     carries it (struct_kernel.py:335); everything else, dxi and the weight
//     gradients included, is summed in fp32 and rounded once by the wrapper
//     (:437-439). The JAX kernel's dxi accumulator is an fp32 output (:388),
//     so its `dxi_ref += dgi.astype(dxi_ref.dtype)` (:308) adds in fp32 too.

#include <cuda_runtime.h>

#include "struct_common.cuh"

namespace {

constexpr int kRows = 8;                  // rows a warp owns
constexpr int kRowWarps = 4;
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kRowTile = kRows * kRowWarps;
constexpr int kWChunk = 32;               // rows of W^T staged in shared memory at a time

template <class V>
struct RowArgs {
  const V* res;          // [2, N, 7D] this half-round's residuals
  float* dsi;            // [2, N, D] in: the direct part of d state_out (or the incoming
                         // cotangent); out: dh * z + dgh W_hh^T (k > 0)
  const float* dnbr_in;  // [2, N, D] the next half-round's d nbr, or null (k = 2R-1)
  NbrList nbr;           // this half-round's direction lists (the next one's transpose)
  const float* wft;      // [2, 3D, D] W_fold^T of this direction
  const float* wht;      // [2, 3D, D] W_hh^T
  const float* ln_w;     // [2, D], or null: no LayerNorm
  float* dxi;            // [2, N, 3D] this direction's
  int dxi_add;           // 0: the direction's first half-round in the sweep writes
  float* dg;             // [2, N, 4D] drho | dzeta | dnu | dhn
  float* colsum;         // [2, ceil(N / kRows), 5D] each warp's sums over its rows of
                         // drho | dzeta | dhn | dh * xhat | dh (the last two with LayerNorm)
  float* dnbr_out;       // [2, N, D] dgi W_fold^T, or null (k = 0)
  int n, dim;
};

// Rows whose residuals are in registers together: 4, or 2 at D > 64.
template <int CPT>
struct Group {
  static constexpr int kSize = CPT <= 2 ? 4 : 2;
};

// Dynamic shared memory of the row kernel: each warp's [4D][kRows] tile and
// two buffers of [2][kWChunk][D] weight rows.
__host__ __device__ constexpr size_t row_smem_floats(int dim) {
  return static_cast<size_t>(kRowWarps) * 4 * dim * kRows + 2 * 2 * kWChunk * dim;
}

template <int CPT, class V>
__global__ void __launch_bounds__(kRowThreads) struct_bwd_row_kernel(const RowArgs<V> p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int G = Group<CPT>::kSize;
  const int D = p.dim, D3 = 3 * D, N = p.n, t = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v0 = blockIdx.x * kRowTile + warp * kRows;
  const bool live = v0 < N;  // warp-uniform; a warp past N still joins the block's barriers
  float* a_s = smem + static_cast<size_t>(warp) * 4 * D * kRows;  // [4D][kRows]
  float* w_s = smem + static_cast<size_t>(kRowWarps) * 4 * D * kRows;
  const size_t tN = static_cast<size_t>(t) * N;
  const float* __restrict__ wf = p.wft + static_cast<size_t>(t) * D3 * D;
  const float* __restrict__ wh = p.wht + static_cast<size_t>(t) * D3 * D;
  const int n_chunks = (D3 + kWChunk - 1) / kWChunk;
  // W_fold^T and W_hh^T rows [c0, c0 + kWChunk) into buffer (chunk & 1)
  auto fetch_w = [&](int chunk) {
    float* dst = w_s + (chunk & 1) * 2 * kWChunk * D;
    const size_t off = static_cast<size_t>(chunk) * kWChunk * D;
    const int n = min(kWChunk, D3 - chunk * kWChunk) * D;
    if ((D & 3) == 0) {
      for (int i = 4 * threadIdx.x; i < n; i += 4 * kRowThreads) {
        __pipeline_memcpy_async(dst + i, wf + off + i, 4 * sizeof(float));
        __pipeline_memcpy_async(dst + kWChunk * D + i, wh + off + i, 4 * sizeof(float));
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kRowThreads) {
        __pipeline_memcpy_async(dst + i, wf + off + i, sizeof(float));
        __pipeline_memcpy_async(dst + kWChunk * D + i, wh + off + i, sizeof(float));
      }
    }
    __pipeline_commit();
  };
  if (p.dnbr_out) fetch_w(0);  // lands during the row phase

  float dh[kRows][CPT];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      dh[u][j] = v0 + u < N && d < D ? p.dsi[(tN + v0 + u) * D + d] : 0.f;
    }
  }
  if (p.dnbr_in) add_neighbor_sums<kRows, CPT>(p.dnbr_in + tN * D, p.nbr, v0, N, D, lane, dh);
  if constexpr (IsBf16<V>::value) {   // the complete cotangent of the state, in bf16
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) dh[u][j] = round_to<V>(dh[u][j]);
    }
  }

  float dhz[kRows][CPT], csum[5][CPT];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) csum[q][j] = 0.f;
  }
#pragma unroll
  for (int g0 = 0; g0 < kRows; g0 += G) {
    // the group's residuals and dxi, all loads issued before any use
    float st[G][CPT], r[G][CPT], z[G][CPT], nw[G][CPT], ghn[G][CPT], pre[G][CPT], x0[G][3][CPT];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int v = v0 + g0 + u;
      const V* rr = p.res + (tN + v) * 7 * D;
      const float* xr = p.dxi + (tN + v) * 3 * D;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = lane + 32 * j;
        const bool own = v < N && d < D;
        st[u][j] = own ? to_float(rr[D + d]) : 0.f;
        r[u][j] = own ? to_float(rr[2 * D + d]) : 0.f;
        z[u][j] = own ? to_float(rr[3 * D + d]) : 0.f;
        nw[u][j] = own ? to_float(rr[4 * D + d]) : 0.f;
        ghn[u][j] = own ? to_float(rr[5 * D + d]) : 0.f;
        pre[u][j] = own && p.ln_w ? to_float(rr[6 * D + d]) : 0.f;
#pragma unroll
        for (int q = 0; q < 3; ++q) x0[u][q][j] = own && p.dxi_add ? xr[q * D + d] : 0.f;
      }
    }
    if (p.ln_w) {
      // y = xhat * w + b, xhat = (h - mean) * rstd; the statistics
      // recomputed, the group's warp reductions issued together
      float mean[G], rstd[G], s[2 * G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        mean[u] = 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) mean[u] += pre[u][j];
      }
      warp_sums<G>(mean);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        mean[u] /= D;
        rstd[u] = 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float c = pre[u][j] - mean[u];
          if (lane + 32 * j < D) rstd[u] += c * c;
        }
      }
      warp_sums<G>(rstd);
      float xhat[G][CPT], dxh[G][CPT];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        rstd[u] = rsqrtf(rstd[u] / D + 1e-5f);
        s[2 * u] = s[2 * u + 1] = 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int d = lane + 32 * j;
          const float dy = dh[g0 + u][j];
          xhat[u][j] = d < D ? (pre[u][j] - mean[u]) * rstd[u] : 0.f;
          dxh[u][j] = d < D ? dy * p.ln_w[t * D + d] : 0.f;
          csum[3][j] += dy * xhat[u][j];
          csum[4][j] += dy;
          s[2 * u] += dxh[u][j];
          s[2 * u + 1] += dxh[u][j] * xhat[u][j];
        }
      }
      warp_sums<2 * G>(s);
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float m1 = s[2 * u] / D, m2 = s[2 * u + 1] / D;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          dh[g0 + u][j] = rstd[u] * (dxh[u][j] - m1 - xhat[u][j] * m2);
        }
      }
    }
    float gate[4][G][CPT];  // drho, dzeta, dnu, dhn of the group's rows
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int v = v0 + g0 + u;
      const size_t o = tN + v;
      // GRU backward: h = (1 - z) * nw + z * state_in
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = lane + 32 * j;
        const float dy = dh[g0 + u][j];
        dhz[g0 + u][j] = dy * z[u][j];
        const float dz = dy * (st[u][j] - nw[u][j]);
        const float dnw = dy * (1.f - z[u][j]);
        const float dnu = dnw * (1.f - nw[u][j] * nw[u][j]);             // pre-tanh
        const float drho = dnu * ghn[u][j] * r[u][j] * (1.f - r[u][j]);  // pre-sigmoid r
        const float dzeta = dz * z[u][j] * (1.f - z[u][j]);              // pre-sigmoid z
        gate[0][u][j] = drho;
        gate[1][u][j] = dzeta;
        gate[2][u][j] = dnu;
        gate[3][u][j] = dnu * r[u][j];
        csum[0][j] += drho;
        csum[1][j] += dzeta;
        csum[2][j] += gate[3][u][j];
        if (v < N && d < D) {
          float* g = p.dg + o * 4 * D;
          float* x = p.dxi + o * 3 * D;
#pragma unroll
          for (int q = 0; q < 4; ++q) g[q * D + d] = gate[q][u][j];
#pragma unroll
          for (int q = 0; q < 3; ++q) x[q * D + d] = x0[u][q][j] + gate[q][u][j];
        }
      }
    }
    // the group's rows into the warp's tile, G consecutive floats per column
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = lane + 32 * j;
        if (d >= D) continue;
        float* at = a_s + static_cast<size_t>(q * D + d) * kRows + g0;
        if constexpr (G == 4) {
          *reinterpret_cast<float4*>(at) =
              make_float4(gate[q][0][j], gate[q][1][j], gate[q][2][j], gate[q][3][j]);
        } else {
          *reinterpret_cast<float2*>(at) = make_float2(gate[q][0][j], gate[q][1][j]);
        }
      }
    }
  }
  if (live) {
    float* cs = p.colsum + (static_cast<size_t>(t) * ((N + kRows - 1) / kRows) + v0 / kRows) * 5 * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      if (d >= D) continue;
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        if (q < 3 || p.ln_w) cs[q * D + d] = csum[q][j];
      }
    }
  }
  if (!p.dnbr_out) return;  // block-uniform (k = 0): the initial state is a constant

  // dnbr = [drho | dzeta | dnu] W_fold^T, dsi = dh z + [drho | dzeta | dhn] W_hh^T,
  // the weights kWChunk rows at a time through shared memory, the next chunk
  // in flight while this one is used
  float an[kRows][CPT], as[kRows][CPT];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) an[u][j] = as[u][j] = 0.f;
  }
  auto rows = [&](int c, float (&a)[kRows]) {
    const float4 lo = *reinterpret_cast<const float4*>(a_s + static_cast<size_t>(c) * kRows);
    const float4 hi = *reinterpret_cast<const float4*>(a_s + static_cast<size_t>(c) * kRows + 4);
    a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
    a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
  };
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    __pipeline_wait_prior(0);
    __syncthreads();  // the chunk has landed; every warp is done with the other buffer
    if (chunk + 1 < n_chunks) fetch_w(chunk + 1);
    if (!live) continue;
    const float* wfs = w_s + (chunk & 1) * 2 * kWChunk * D;
    const float* whs = wfs + kWChunk * D;
    const int c0 = chunk * kWChunk, kc = min(kWChunk, D3 - c0);
#pragma unroll 2
    for (int cc = 0; cc < kc; ++cc) {
      const int c = c0 + cc;
      float a[kRows], b[kRows], wfv[CPT], whv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int d = lane + 32 * j;
        wfv[j] = d < D ? wfs[cc * D + d] : 0.f;
        whv[j] = d < D ? whs[cc * D + d] : 0.f;
      }
      rows(c, a);
      if (c < 2 * D) {  // drho, dzeta: the same rows feed both products
#pragma unroll
        for (int u = 0; u < kRows; ++u) b[u] = a[u];
      } else {          // dnu for W_fold, dhn for W_hh
        rows(c + D, b);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          an[u][j] = fmaf(a[u], wfv[j], an[u][j]);
          as[u][j] = fmaf(b[u], whv[j], as[u][j]);
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int v = v0 + u;
    if (v >= N) continue;
    const size_t o = tN + v;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        p.dnbr_out[o * D + d] = an[u][j];
        p.dsi[o * D + d] = dhz[u][j] + as[u][j];
      }
    }
  }
}

// Weight-gradient partials of one half-round: blockIdx.y = tower, blockIdx.z
// = split of the rows (a multiple of kRows). Blocks [0, w_tiles) each own a
// 64 x 64 tile of nbr^T [drho | dzeta | dnu] (dW_fold) or state_in^T
// [drho | dzeta | dhn] (dW_hh) and reduce the split's rows in order; the
// blocks after them own 64 columns each of the column sums [drho | dzeta |
// dhn | dh xhat | dh] (db_hh, and the LayerNorm's), from the row launch's
// per-warp sums. Each adds its result into the direction's partial
// [2 tower, splits, part_size] = [wf D x 3D | wh D x 3D | bh 3D | ln 2D] in
// place, or writes it for the direction's first half-round.
template <class V>
struct PartArgs {
  const V* res;         // [2, N, 7D] this half-round's
  const float* dg;      // [2, N, 4D]
  const float* colsum;  // [2, ceil(N / kRows), 5D]
  float* part;          // [2, splits, part_size] this direction's
  int n, dim, split_rows, splits, part_size, i_tiles, c_tiles, layernorm, accumulate;
};

constexpr int kPTile = 64;     // output tile edge
constexpr int kPChunk = 16;    // rows staged at a time
constexpr int kPThreads = 64;  // 8 x 8 threads of 8 x 8 outputs

template <class V>
__global__ void __launch_bounds__(kPThreads) struct_grad_partial_kernel(const PartArgs<V> p) {
  __shared__ __align__(16) float a_s[kPChunk][kPTile];
  __shared__ __align__(16) float b_s[kPChunk][kPTile];
  const int D = p.dim, D3 = 3 * D, t = blockIdx.y, tid = threadIdx.x;
  const size_t tN = static_cast<size_t>(t) * p.n;
  const int r_begin = blockIdx.z * p.split_rows, r_end = min(p.n, r_begin + p.split_rows);
  float* out = p.part + (static_cast<size_t>(t) * p.splits + blockIdx.z) * p.part_size;
  const int w_tiles = 2 * p.i_tiles * p.c_tiles;
  const int tile = blockIdx.x;

  if (tile >= w_tiles) {  // column sums: one column a thread, the warps' sums in order
    const int q = (tile - w_tiles) * kPTile + tid;
    if (q >= (p.layernorm ? 5 * D : D3)) return;
    const int n_warps = (p.n + kRows - 1) / kRows;
    const float* col = p.colsum + static_cast<size_t>(t) * n_warps * 5 * D + q;
    float acc = 0.f;
#pragma unroll 8
    for (int w = r_begin / kRows; w * kRows < r_end; ++w) {
      acc += col[static_cast<size_t>(w) * 5 * D];
    }
    float* o = out + 2 * D * D3 + q;
    *o = p.accumulate ? *o + acc : acc;
    return;
  }

  const int m = tile / (p.i_tiles * p.c_tiles);  // 0: dW_fold, 1: dW_hh
  const int i0 = (tile / p.c_tiles % p.i_tiles) * kPTile, c0 = (tile % p.c_tiles) * kPTile;
  // staging: thread tid loads column tid of each of the chunk's rows
  const int ia = i0 + tid, cb = c0 + tid;
  const bool a_ok = ia < D, b_ok = cb < D3;
  const V* a_col = p.res + tN * 7 * D + m * D + ia;
  const float* b_col = p.dg + tN * 4 * D + (cb < 2 * D ? cb : cb + m * D);
  float a_reg[kPChunk], b_reg[kPChunk];
  auto load = [&](int r0) {
#pragma unroll
    for (int i = 0; i < kPChunk; ++i) {
      const int r = r0 + i;
      a_reg[i] = a_ok && r < r_end ? to_float(a_col[static_cast<size_t>(r) * 7 * D]) : 0.f;
      b_reg[i] = b_ok && r < r_end ? b_col[static_cast<size_t>(r) * 4 * D] : 0.f;
    }
  };
  // thread (ti, tc) owns outputs i0 + {4 ti, 32 + 4 ti} + 0..3 by c0 + {4 tc, 32 + 4 tc} + 0..3
  const int ti = tid / 8, tc = tid % 8;
  float acc[8][8] = {};
  load(r_begin);
  for (int r0 = r_begin; r0 < r_end; r0 += kPChunk) {
#pragma unroll
    for (int i = 0; i < kPChunk; ++i) {
      a_s[i][tid] = a_reg[i];
      b_s[i][tid] = b_reg[i];
    }
    __syncthreads();
    if (r0 + kPChunk < r_end) load(r0 + kPChunk);
#pragma unroll
    for (int i = 0; i < kPChunk; ++i) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[i][4 * ti]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[i][32 + 4 * ti]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[i][4 * tc]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[i][32 + 4 * tc]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int x = 0; x < 8; ++x) {
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
      }
    }
    __syncthreads();
  }
  float* o = out + static_cast<size_t>(m) * D * D3;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int i = i0 + (x < 4 ? 4 * ti + x : 32 + 4 * ti + x - 4);
    if (i >= D) continue;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const int c = c0 + (y < 4 ? 4 * tc + y : 32 + 4 * tc + y - 4);
      if (c >= D3) continue;
      float* e = o + static_cast<size_t>(i) * D3 + c;
      *e = p.accumulate ? *e + acc[x][y] : acc[x][y];
    }
  }
}

// Sums the partials over the splits in order (the LayerNorm's over the
// directions, then the splits). One thread per output.
__global__ void __launch_bounds__(256) struct_grad_sum_kernel(
    const float* __restrict__ part, float* __restrict__ dwfold, float* __restrict__ dwhh,
    float* __restrict__ dbhh, float* __restrict__ dlnw, float* __restrict__ dlnb, int splits,
    int dim, int part_size, int layernorm) {
  const int D = dim, D3 = 3 * D, W = D * D3;
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int per = 2 * W + D3, n_dir = 4 * per;  // (dir, tower) outputs
  if (idx < n_dir) {
    const int dt = idx / per, e = idx % per;
    const float* src = part + static_cast<size_t>(dt) * splits * part_size + e;
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += src[static_cast<size_t>(z) * part_size];
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
    for (int dir = 0; dir < 2; ++dir) {
      const float* src = part + (static_cast<size_t>(dir) * 2 + t) * splits * part_size + per + e;
      for (int z = 0; z < splits; ++z) acc += src[static_cast<size_t>(z) * part_size];
    }
  }
  if (e < D) dlnw[t * D + e] = acc;
  else dlnb[t * D + e - D] = acc;
}

// The sweep, on `s`: per half-round the row launch and then its partial
// launch, so the partial of half-round k has read dg and colsum before row
// k - 1 overwrites them, and the in-place sums keep the half-round order.
template <int CPT, class V>
int run(RowArgs<V> p, PartArgs<V> g, const V* res, const float* wt, const int* nbr_src,
        const int* nbr_start, const int* nbr_count, float* dxi, float* dg, float* colsum,
        float* carry, float* part, int num_rounds, int src_len, cudaStream_t s) {
  // past 48 KB of dynamic shared memory at D > 48: allowed once per device for kMaxDim
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};  // 0: not yet; else the cudaError_t + 1
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[dev]) {
    allowed[dev] = 1 + static_cast<int>(cudaFuncSetAttribute(
        struct_bwd_row_kernel<CPT, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(row_smem_floats(kMaxDim) * sizeof(float))));
  }
  if (allowed[dev] != 1) return allowed[dev] - 1;
  const int N = p.n, D = p.dim, R2 = 2 * num_rounds;
  const size_t smem = row_smem_floats(D) * sizeof(float);
  const dim3 rows_grid((N + kRowTile - 1) / kRowTile, 2);
  const dim3 part_grid(2 * g.i_tiles * g.c_tiles + (5 * D + kPTile - 1) / kPTile, 2, g.splits);
  const size_t nd = static_cast<size_t>(N) * D, w = static_cast<size_t>(D) * 3 * D;
  // carry: the next half-round's d nbr in two ping-pong slots, each [2, N, D]
  auto dnbr = [&](int k) { return carry + static_cast<size_t>(k % 2) * 2 * nd; };
  g.dg = p.dg = dg;
  g.colsum = p.colsum = colsum;
  for (int k = R2 - 1; k >= 0 && err == cudaSuccess; --k) {
    const int dir = k % 2;
    p.res = g.res = res + static_cast<size_t>(k) * 2 * nd * 7;
    p.dnbr_in = k == R2 - 1 ? nullptr : dnbr(k + 1);
    p.nbr = NbrList{nbr_src + static_cast<size_t>(dir) * src_len, nbr_start + dir * N,
                    nbr_count + dir * N};
    p.wft = wt + dir * 2 * w;      // wt: [2 matrix, 2 dir, 2 tower, 3D, D]
    p.wht = wt + (2 + dir) * 2 * w;
    p.dxi = dxi + dir * 2 * nd * 3;
    p.dxi_add = k < R2 - 2;
    p.dnbr_out = k > 0 ? dnbr(k) : nullptr;
    struct_bwd_row_kernel<CPT, V><<<rows_grid, kRowThreads, smem, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    g.part = part + static_cast<size_t>(dir) * 2 * g.splits * g.part_size;
    g.accumulate = k < R2 - 2;
    struct_grad_partial_kernel<V><<<part_grid, kPThreads, 0, s>>>(g);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Backward of mgvae_struct_towers_forward, on `stream`. dstate [2, N, D] is
// the cotangent of the final state, overwritten (it carries each
// half-round's direct part); res [2R, 2, N, 7D] the forward's residuals;
// wt [2, 2, 2, 3D, D] W_fold^T and W_hh^T (wt[0] = wfold.transpose(-1, -2),
// wt[1] = w_hh's); ln_w (null without LayerNorm) and the neighbor lists as
// in the forward. Outputs, written whole: dxi [2, 2, N, 3D], dwfold / dwhh
// [2, 2, D, 3D], dbhh [2, 2, 3D], dlnw / dlnb [2, D] (zero without
// LayerNorm). Scratch, one half-round's whatever num_rounds: dg
// [2, N, 4D], colsum [2, ceil(N / 8), 5D], carry [2, 2, N, D] (two slots);
// part [2, 2, splits, 6D^2 + 5D], splits = ceil(n / split_rows), split_rows
// a multiple of 8. res holds bf16 with `bf16` set (the state's cotangent is
// then rounded to bf16 where it is complete), else fp32; everything else is
// fp32. 4R + 1 launches. Returns 0, or the cudaError_t of the first failed
// call.
int mgvae_struct_towers_backward(float* dstate, const void* res, const float* wt,
                                 const float* ln_w, const int* nbr_src, const int* nbr_start,
                                 const int* nbr_count, float* dxi, float* dwfold, float* dwhh,
                                 float* dbhh, float* dlnw, float* dlnb, float* dg, float* colsum,
                                 float* carry, float* part, int num_rounds, int n, int dim,
                                 int src_len, int split_rows, int bf16, void* stream) {
  if (dim < 1 || dim > kMaxDim || n < 1 || num_rounds < 1 || src_len < 1 || split_rows < 1 ||
      split_rows % kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = dim;
  const bool ln = ln_w != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = 0;
  MGVAE_WITH_VALUE(bf16, {
    RowArgs<V> p{};
    p.dsi = dstate;
    p.ln_w = ln_w;
    p.n = n;
    p.dim = D;
    PartArgs<V> g{};
    g.n = n;
    g.dim = D;
    g.split_rows = split_rows;
    g.splits = (n + split_rows - 1) / split_rows;
    g.part_size = 6 * D * D + 5 * D;
    g.i_tiles = (D + kPTile - 1) / kPTile;
    g.c_tiles = (3 * D + kPTile - 1) / kPTile;
    g.layernorm = ln ? 1 : 0;
    MGVAE_WITH_NF(dim, code = run<NF, V>(p, g, static_cast<const V*>(res), wt, nbr_src,
                                         nbr_start, nbr_count, dxi, dg, colsum, carry, part,
                                         num_rounds, src_len, s));
  });
  if (code != 0) return code;
  const int splits = (n + split_rows - 1) / split_rows, part_size = 6 * D * D + 5 * D;
  const int outputs = 4 * (6 * D * D + 3 * D) + 4 * D;
  struct_grad_sum_kernel<<<(outputs + 255) / 256, 256, 0, s>>>(
      part, dwfold, dwhh, dbhh, dlnw, dlnb, splits, D, part_size, ln ? 1 : 0);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : static_cast<int>(err);
}

}  // extern "C"
