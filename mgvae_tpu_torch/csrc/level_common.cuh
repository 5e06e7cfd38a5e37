// Helpers shared by the level kernels (level_slot.cuh, level_slot_bwd.cuh and
// the six level_*.cu that include them).
//
// The unit of work is a warp: one warp computes one destination slot, lane l
// owning features l, l + 32, ... (NF = ceil(D / 32) <= 4 of them, a template
// argument so that they live in registers). A block serves ONE expert for
// its whole life: it copies that expert's weight slices into shared memory
// once (stage, staged) and its warps walk the expert's slots of each level
// from the level lists (ops/level_kernel.level_lists). What bounds a level is
// the chain of dependent loads and products inside one slot, so the bodies
// load a slot's indices a lane per in-edge, compute kBatch in-edges together,
// and split into a part that can run before the level below is done
// (indices, the static inputs) and a part that cannot. The struct-tower
// kernels use kMaxDim and warp_sum (struct_common.cuh).
#pragma once

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

// ---- value types ----------------------------------------------------------
//
// Every level and struct kernel is a template of the value type V, float or
// __nv_bfloat16: what it stores in device memory (hf, the residuals, the
// state, d_pack). Registers and shared memory hold fp32, every sum is fp32,
// and a value is rounded to V where the JAX package's kernels round it
// (round_to). For V = float every helper is the identity, so the fp32
// instantiations compute what they computed before the template.

template <class V>
struct IsBf16 {
  static constexpr bool value = false;
};
template <>
struct IsBf16<__nv_bfloat16> {
  static constexpr bool value = true;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class V>
__device__ __forceinline__ V from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to V (to nearest even) and back to fp32.
template <class V>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<V>(x));
}

// Loads of one value past L1 (a persistent launch reads what it wrote on
// other SMs) and through the read-only path.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

constexpr int kMaxDim = 128;
constexpr int kMaxExperts = 5;
constexpr int kLevelWarps = 4;           // warps (slots in flight) per block
constexpr int kLevelThreads = kLevelWarps * 32;
constexpr int kBatch = 4;                // in-edges a warp computes together

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// warp_sum of each of N values, the shuffles of one round issued together.
template <int N>
__device__ __forceinline__ void warp_sums(float (&x)[N]) {
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) x[n] += __shfl_xor_sync(0xffffffffu, x[n], o);
  }
}

// acc[g][q] += sum over r < ROWS of x[r] * m[r * LD + g * GROUP + lane + 32 q]:
// a vector in shared memory times G column groups of a row-major matrix, this
// lane's columns. Bounds and strides are constants, so the loop unrolls into
// loads at fixed offsets with no address arithmetic and no predicates (the
// matrices are zero-padded to 32 NF columns).
template <int NF, int G, int ROWS, int LD, int GROUP>
__device__ __forceinline__ void vector_matrix(const float* x, const float* m,
                                              float (&acc)[G][NF]) {
  const float* col = m + (threadIdx.x & 31);
#pragma unroll 8
  for (int r = 0; r < ROWS; ++r) {
    const float xr = x[r];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        acc[g][q] = fmaf(xr, col[r * LD + g * GROUP + 32 * q], acc[g][q]);
      }
    }
  }
}

// Three matrices of one expert as the slot bodies read them, row-major and
// zero-padded to DP = 32 NF rows and columns (the wrapper's expert-major
// copies, ops/level_kernel.repack_expert_major): every product puts lane l
// on columns l, l + 32, ... of a row, so a warp reads 32 neighbouring floats
// at a time, from shared memory without bank conflicts and from device
// memory coalesced, and the padding lets every loop run to a constant bound
// with no predicate. The forward reads a = wk_e and b = wv_e [DP, DP] (rows:
// the input feature) and c = w_ih_e [DP, 3 DP]; the backward's transposed
// products read copies that the wrapper transposed, b = wv_e^T [DP, DP]
// (rows: the output feature) and c = w_ih_e^T [3 DP, DP].
//
// A block copies its expert's matrices into shared memory once, at its
// start. Up to DP = 96 all of them fit (the forward at D = 64: 5 D^2 floats =
// 80 KB, two blocks per SM). At DP = 128 the forward keeps wk and wv (128 KB)
// and reads w_ih, used once per slot against twice per edge, from device
// memory through L2; the backward keeps w_ih^T (192 KB) and reads wv^T so
// (a block can have 227 KB). Which it is, is a constant of NF, so the
// compiler knows each pointer's address space.
struct ExpertWeights {
  const float* a;
  const float* b;
  const float* c;
};

template <int NF>
struct Staged {
  static constexpr int DP = 32 * NF;
  static constexpr bool all = NF < 4;   // DP <= 96: every matrix fits
};

// Copies n floats from device to shared memory with 16-byte asynchronous
// copies (n a multiple of 4, both 16-byte aligned), all threads of the block.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int idx = 4 * threadIdx.x; idx < n; idx += 4 * blockDim.x) {
    __pipeline_memcpy_async(dst + idx, src + idx, 4 * sizeof(float));
  }
}

// Ends a block's staging: every copy has landed and every thread sees it.
__device__ __forceinline__ void staged() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Barrier over all blocks of a cooperative launch (the launch guarantees
// that they are co-resident). `counter` is zeroed before the launch and only
// grows; `target` is the count that ends this barrier: the barrier's number
// (from 1) times gridDim.x. Every thread's writes before the barrier are
// visible to every thread after it, for loads that do not go through L1
// (__ldcg) or the read-only path.
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned target) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(counter, 1u);
    while (*reinterpret_cast<volatile unsigned*>(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// Blocks per expert of a launch of one level of `chunks` chunks whose blocks
// need not be co-resident. A slot's warp streams its expert's matrices out of
// shared memory, whose bandwidth one SM's warps share, so a level's slots are
// dealt out over as many blocks as there are slots, up to 64 (the slot loops
// stride past that), and over no more blocks than fill the card once
// (`resident`: blocks the card holds at once) with all chunks' blocks.
inline int chunk_blocks_per_expert(int np, int resident, int T, int chunks) {
  int nbe = np < 64 ? np : 64;
  const int fill = resident / (T * chunks);
  if (nbe > fill) nbe = fill;
  return nbe < 1 ? 1 : nbe;
}

// The positions of an expert's slot list that one warp takes: the expert's
// k-th slot goes to block k % nbe (be: the block's number among the nbe
// blocks of its expert), so that a level's slots spread over all blocks
// before any block gets a second one, and within the block to warp
// (k / nbe) % kLevelWarps.
__device__ __forceinline__ int first_slot(int be, int nbe) {
  return be + nbe * (threadIdx.x >> 5);
}
__device__ __forceinline__ int slot_stride(int nbe) { return nbe * kLevelWarps; }

// The device indices a launcher keeps a configuration for.
constexpr int kMaxDevices = 64;

// What a launcher learns on its first call on a device: the device's SM count
// and how many of its kernel's blocks of kLevelThreads one SM holds, with the
// kernel's dynamic shared memory allowed there. A function attribute belongs
// to the device it was set on, and a process may launch on several cards, so
// each launcher keeps one of these per device (a static table of its own).
// Configured once per device: setting the attribute again per launch costs the
// host tens of microseconds, which a route of a launch per level pays per
// level. Two threads that configure one device at once set the same values.
struct DeviceConfig {
  std::atomic<int> sms{0};
  std::atomic<int> per_sm{0};   // 0: not configured on this device yet
};

// *sms and *per_sm of the current device for `kernel` with `bytes` of dynamic
// shared memory, configured on the first call on that device.
template <class Kernel>
cudaError_t device_config(Kernel kernel, size_t bytes, DeviceConfig (&table)[kMaxDevices],
                          int* sms, int* per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceConfig& c = table[device];
  int blocks = c.per_sm.load(std::memory_order_acquire);
  if (blocks == 0) {
    int n = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess) {
      return err;
    }
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(bytes))) != cudaSuccess) {
      return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kLevelThreads, bytes);
    if (err != cudaSuccess) return err;
    c.sms.store(n, std::memory_order_relaxed);
    c.per_sm.store(blocks, std::memory_order_release);
  }
  *sms = c.sms.load(std::memory_order_relaxed);
  *per_sm = blocks;
  return cudaSuccess;
}

// Whether a C entry's level dimensions are outside what the kernels take.
inline bool bad_dims(int ep, int np, int dim, int num_experts) {
  return dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts || ep < 1 ||
         np < 1;
}

// Runs the statement, which names V, with V the value type of the C entry's
// flag (0: float, else __nv_bfloat16).
#define MGVAE_WITH_VALUE(BF16, ...)                           \
  if (BF16) {                                                 \
    using V = __nv_bfloat16;                                  \
    __VA_ARGS__;                                              \
  } else {                                                    \
    using V = float;                                          \
    __VA_ARGS__;                                              \
  }

// Runs the statement, which names NF, with NF = ceil(D / 32) a constant.
#define MGVAE_WITH_NF(D, ...)                                  \
  switch (((D) + 31) / 32) {                                   \
    case 1: { constexpr int NF = 1; __VA_ARGS__; } break;      \
    case 2: { constexpr int NF = 2; __VA_ARGS__; } break;      \
    case 3: { constexpr int NF = 3; __VA_ARGS__; } break;      \
    default: { constexpr int NF = 4; __VA_ARGS__; } break;     \
  }

}  // namespace
