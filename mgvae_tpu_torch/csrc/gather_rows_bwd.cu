// The backward of a row gather, out = table[index], for Hopper (sm_90a):
// d_table[r] = the sum of d_out's rows i with index[i] == r, summed in the
// order of i, with no atomics.
//
// Replaces no TPU kernel. It is the backward of XLA's gather, which the JAX
// package leaves to XLA (mgvae_tpu/models/dg_ae.py: the experts' tables
// indexed by each edge's or node's expert, the per-edge pack indexed by the
// level tables, hs / s / t indexed by the edges). On this card that backward
// would otherwise be PyTorch's index backward: a sort, then one warp per run
// of equal indices that walks the run serially, a read-modify-write of the
// gradient row per entry, so that it takes as long as the longest run. The
// model's indices have very long runs: the experts' tables have T = 4-5
// rows, and every padding entry of the level tables and of the edge lists
// names one row (edge E - 1, the dump node).
//
// What bounds it on this card: the bytes, each cotangent row read once and
// each table row written once (examples/gather_profile.py prices them at
// 3.35 TB/s). What the design does about it: the plan (ops/gather.plan,
// torch on the card: a stable sort of the index, the sorted keys, each
// row's first position) lets every run be summed across the card in two
// launches, each a warp per chunk of chunk_len sorted positions:
//   (a) the chunk's entries in sorted order (one coalesced load of 32 keys
//       and positions, then kUnroll gradient rows in flight, lanes over the
//       columns, VEC of them a lane in NCOL groups, so that one walk covers
//       the row), summed in fp32 from 0 segment by segment (a segment: the
//       chunk's entries of one row). A row whose entries all lie in the
//       chunk is written to its gradient, rounded once; a row that runs on
//       from the chunk before (slot 0) or on into the next (slot 1) leaves
//       its partial sum in a fp32 scratch [chunks, 2, W];
//   (b) the chunk where a row that spans chunks ends sums its partials in
//       chunk order (slot 1 of its first chunk, slot 0 of the others) into
//       its gradient; every other warp returns after two loads. Before
//       that, the warps take the rows 32 at a time and write 0 to those
//       that no entry names (offsets[r] == offsets[r + 1]), lanes over the
//       columns, so that a long gap (the padding nodes) is spread over
//       the card.
// Every sum's order is fixed by the index alone (chunk_len by its length),
// so the result repeats to the bit, and no size is read back to the host:
// both grids are the chunks of n entries, so a CUDA graph captures the call
// unchanged. A row inside one chunk is the serial sum in index order, the
// plain version's (zeros(R, W).index_add_(0, index, grad)) bit for bit in
// fp32; a longer row differs from it by fp32 rounding only. bf16 gradients
// are summed in fp32 and rounded once. What sets the time is a warp's chain
// of loads, chunk_len entries kUnroll at a time in (a), a row's chunks
// kUnroll2 at a time from L2 in (b): chunk_len runs from 32 (a bs16 batch's
// ~10k entries: ~320 warps) to 128 (the giant batch's ~230k: ~1,800 warps,
// its longest run ~640 chunks).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;       // warps a block
constexpr int kUnroll = 8;      // gradient rows in flight a warp, in (a)
constexpr int kUnroll2 = 16;    // partial sums in flight a warp, in (b)
constexpr int kMaxTables = 4;   // tables sharing one index (ops/gather.MAX_TABLES)

struct Tables {
  const void* grad[kMaxTables];   // [n, W] the gathered rows' cotangents
  void* out[kMaxTables];          // [R, W] the table's gradient
  float* scratch[kMaxTables];     // [chunks, 2, W] partial sums of rows across chunks
  int width[kMaxTables];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <class T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <class T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const Pack<T, VEC> x = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int q = 0; q < VEC; ++q) out[q] = to_float(x.v[q]);
}

template <class T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  Pack<T, VEC> x;
#pragma unroll
  for (int q = 0; q < VEC; ++q) x.v[q] = from_float<T>(in[q]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = x;
}

// A lane's columns of a row: NCOL groups of VEC, group j at
// c0 + j * 32 * VEC + lane * VEC, so that one walk over the entries covers
// W <= NCOL * 32 * VEC (wider rows take further walks from the next c0).
template <int VEC, int NCOL>
struct Lanes {
  int col[NCOL];
  bool on[NCOL];
  __device__ __forceinline__ Lanes(int c0, int lane, int W) {
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      col[j] = c0 + j * 32 * VEC + lane * VEC;
      on[j] = col[j] < W;
    }
  }
};

// (a): a warp a chunk; grid (chunks / kWarps, tables).
template <class T, int VEC, int NCOL>
__global__ void __launch_bounds__(kWarps * 32) gather_chunks_kernel(
    const int* __restrict__ keys, const int64_t* __restrict__ perm, Tables tabs, int n,
    int rows, int chunk_len) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t beg = chunk * chunk_len;
  if (beg >= n) return;
  const int64_t end = min(beg + chunk_len, static_cast<int64_t>(n));
  const int prev = chunk > 0 ? keys[beg - 1] : -1;   // the row before the chunk
  const int next = end < n ? keys[end] : rows;       // the row after it
  const int t = blockIdx.y, W = tabs.width[t];
  const T* grad = static_cast<const T*>(tabs.grad[t]);
  T* out = static_cast<T*>(tabs.out[t]);
  // a key outside [0, rows) (the index's contract) is summed and dropped
  const auto in_rows = [rows](int r) { return r >= 0 && r < rows; };
  float* scratch = tabs.scratch[t] + chunk * 2 * W;
  for (int c0 = 0; c0 < W; c0 += NCOL * 32 * VEC) {
    const Lanes<VEC, NCOL> ln(c0, lane, W);
    float acc[NCOL][VEC];
    const auto clear = [&acc]() {
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[j][q] = 0.0f;
      }
    };
    // a segment's sum to its row's gradient (whole) or to a scratch slot
    const auto flush = [&](int row, int slot) {
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        if (!ln.on[j]) continue;
        if (slot >= 0) {
          store_vec<float, VEC>(scratch + slot * W + ln.col[j], acc[j]);
        } else if (in_rows(row)) {
          store_vec<T, VEC>(out + static_cast<int64_t>(row) * W + ln.col[j], acc[j]);
        }
      }
    };
    clear();
    int cur = keys[beg];
    bool before = cur == prev;   // the segment runs on from the chunk before
    for (int64_t base = beg; base < end; base += 32) {
      const int cnt = static_cast<int>(min(static_cast<int64_t>(32), end - base));
      const int my_key = lane < cnt ? keys[base + lane] : 0;
      const int64_t my_e = lane < cnt ? perm[base + lane] : 0;
      for (int k = 0; k < cnt; k += kUnroll) {
        float v[kUnroll][NCOL][VEC];
        int key[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          key[u] = __shfl_sync(0xffffffffu, my_key, (k + u) & 31);
          const int64_t e = __shfl_sync(0xffffffffu, my_e, (k + u) & 31);
#pragma unroll
          for (int j = 0; j < NCOL; ++j) {
            if (ln.on[j] && k + u < cnt) {
              load_vec<T, VEC>(grad + e * W + ln.col[j], v[u][j]);
            } else {
#pragma unroll
              for (int q = 0; q < VEC; ++q) v[u][j][q] = 0.0f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k + u < cnt) {
            if (key[u] != cur) {   // a segment ends inside the chunk
              flush(cur, before ? 0 : -1);
              clear();
              cur = key[u];
              before = false;
            }
#pragma unroll
            for (int j = 0; j < NCOL; ++j) {
#pragma unroll
              for (int q = 0; q < VEC; ++q) acc[j][q] += v[u][j][q];
            }
          }
        }
      }
    }
    // the last segment
    flush(cur, before ? 0 : (next == cur ? 1 : -1));
  }
}

// (b): a warp a chunk; the warp of the chunk where a row that spans chunks
// ends writes its gradient; before that, the warps in turn take the rows 32
// at a time and write 0 to those that no entry names. grid (chunks /
// kWarps, tables).
template <class T, int VEC, int NCOL>
__global__ void __launch_bounds__(kWarps * 32) gather_spans_kernel(
    const int* __restrict__ keys, const int64_t* __restrict__ offsets, Tables tabs, int n,
    int rows, int chunk_len) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int t = blockIdx.y, W = tabs.width[t];
  T* out = static_cast<T*>(tabs.out[t]);
  for (int64_t r0 = chunk * 32; r0 < rows; r0 += static_cast<int64_t>(gridDim.x) * kWarps * 32) {
    const int64_t r = r0 + lane;
    unsigned empty = __ballot_sync(0xffffffffu, r < rows && offsets[r] == offsets[r + 1]);
    while (empty) {
      const int64_t base = (r0 + __ffs(empty) - 1) * W;
      for (int c = lane; c < W; c += 32) out[base + c] = from_float<T>(0.0f);
      empty &= empty - 1;
    }
  }
  const int64_t beg = chunk * chunk_len;
  if (beg >= n || chunk == 0) return;
  const int64_t end = min(beg + chunk_len, static_cast<int64_t>(n));
  const int r = keys[beg];
  if (r < 0 || r >= rows || keys[beg - 1] != r || (end < n && keys[end] == r)) return;
  const int64_t first = offsets[r] / chunk_len;   // the row's first chunk: its slot 1
  const float* scratch = tabs.scratch[t];
  for (int c0 = 0; c0 < W; c0 += NCOL * 32 * VEC) {
    const Lanes<VEC, NCOL> ln(c0, lane, W);
    float acc[NCOL][VEC];
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      if (ln.on[j]) load_vec<float, VEC>(scratch + (first * 2 + 1) * W + ln.col[j], acc[j]);
    }
    for (int64_t k = first + 1; k <= chunk; k += kUnroll2) {
      float v[kUnroll2][NCOL][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll2; ++u) {
#pragma unroll
        for (int j = 0; j < NCOL; ++j) {
          if (ln.on[j] && k + u <= chunk) {
            load_vec<float, VEC>(scratch + (k + u) * 2 * W + ln.col[j], v[u][j]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll2; ++u) {
        if (k + u <= chunk) {
#pragma unroll
          for (int j = 0; j < NCOL; ++j) {
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[j][q] += v[u][j][q];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      if (ln.on[j]) {
        store_vec<T, VEC>(out + static_cast<int64_t>(r) * W + ln.col[j], acc[j]);
      }
    }
  }
}

template <class T, int VEC, int NCOL>
cudaError_t launch(const int* keys, const int64_t* perm, const int64_t* offsets,
                   const Tables& tabs, int num_tables, int n, int rows, int chunk_len,
                   cudaStream_t stream) {
  const int64_t chunks = (static_cast<int64_t>(n) + chunk_len - 1) / chunk_len;
  const dim3 grid(static_cast<unsigned>((chunks + kWarps - 1) / kWarps), num_tables);
  gather_chunks_kernel<T, VEC, NCOL><<<grid, kWarps * 32, 0, stream>>>(keys, perm, tabs, n,
                                                                        rows, chunk_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gather_spans_kernel<T, VEC, NCOL><<<grid, kWarps * 32, 0, stream>>>(keys, offsets, tabs, n,
                                                                       rows, chunk_len);
  return cudaGetLastError();
}

// The instantiation for (VEC, NCOL): VEC values a lane loads at once, NCOL
// groups of them a lane (ops/gather._layout).
template <class T>
cudaError_t launch_layout(int vec, int ncol, const int* keys, const int64_t* perm,
                          const int64_t* offsets, const Tables& tabs, int num_tables, int n,
                          int rows, int chunk_len, cudaStream_t stream) {
#define MGVAE_GATHER_LAUNCH(V, C)                                                           \
  if (vec == V && ncol == C) {                                                              \
    return launch<T, V, C>(keys, perm, offsets, tabs, num_tables, n, rows, chunk_len, stream); \
  }
  MGVAE_GATHER_LAUNCH(1, 1) MGVAE_GATHER_LAUNCH(1, 2) MGVAE_GATHER_LAUNCH(1, 3)
  MGVAE_GATHER_LAUNCH(1, 4) MGVAE_GATHER_LAUNCH(2, 1) MGVAE_GATHER_LAUNCH(2, 2)
  MGVAE_GATHER_LAUNCH(4, 1) MGVAE_GATHER_LAUNCH(4, 2)
#undef MGVAE_GATHER_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The gradients of `num_tables` (1 to 4) tables gathered by one index of n
// entries (n >= 1) over `rows` rows, two launches on `stream`. keys [n]
// (int32, the sorted index), perm [n] and offsets [rows + 1] (int64) are
// ops/gather.plan's; grad_t [n, width_t] and out_t [rows, width_t] are float
// (bf16 = 0) or __nv_bfloat16 (bf16 = 1), row-major, their rows aligned to
// vec values (1, 2 or 4, dividing every width); a lane takes ncol groups of
// vec columns a walk ((vec, ncol) one of launch_layout's); scratch_t
// [ceil(n / chunk_len), 2, width_t] fp32, chunk_len the sorted positions a
// warp (ops/gather.chunk_len). Returns 0, or the cudaError_t of the failed
// call: a launch that is refused never runs.
int mgvae_gather_rows_backward(
    const int* keys, const int64_t* perm, const int64_t* offsets, const void* grad0,
    const void* grad1, const void* grad2, const void* grad3, void* out0, void* out1, void* out2,
    void* out3, float* scratch0, float* scratch1, float* scratch2, float* scratch3,
    int num_tables, int n, int rows, int width0, int width1, int width2, int width3, int vec,
    int ncol, int chunk_len, int bf16, void* stream) {
  const int widths[kMaxTables] = {width0, width1, width2, width3};
  if (num_tables < 1 || num_tables > kMaxTables || n < 1 || rows < 1 || chunk_len < 1 ||
      (vec != 1 && vec != 2 && vec != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int t = 0; t < num_tables; ++t) {
    if (widths[t] < 1 || widths[t] % vec) return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tables tabs{{grad0, grad1, grad2, grad3}, {out0, out1, out2, out3},
                    {scratch0, scratch1, scratch2, scratch3}, {width0, width1, width2, width3}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_layout<__nv_bfloat16>(vec, ncol, keys, perm, offsets, tabs, num_tables, n,
                                          rows, chunk_len, s)
           : launch_layout<float>(vec, ncol, keys, perm, offsets, tabs, num_tables, n, rows,
                                  chunk_len, s);
  return static_cast<int>(err);
}

}  // extern "C"
