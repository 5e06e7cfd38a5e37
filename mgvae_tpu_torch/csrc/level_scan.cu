// Level-recurrence forward of DG_AE (num_rounds == 1), for Hopper (sm_90a):
// the fused route and the giant route, with fp32 or bf16 values.
//
// Replaces mgvae_tpu/ops/pallas/level_kernel.py::fused_level_scan (C == 1),
// with and without its residual outputs, and ::fused_level_scan_hbm
// (_level_scan_hbm_padded, _level_kernel_hbm), the giant route's forward:
// the same launch without residuals, at any N (offsets are size_t), whose
// backward (level_scan_giant_bwd.cu) recomputes from hf. The TPU kernel's
// chunked DMA stream of hf through VMEM, its double buffers and chunk loops
// have no counterpart: hf is read where it lies. Per DAG level and per destination
// slot: gather hf[src] of the slot's in-edges, the hf-side key/value of the
// destination's expert, the masked segment softmax over the in-edges,
// msg = sum attn * v, then a GRU step with h = 0, written to hf[node].
//
// What bounds it on this card: latency, not bytes or operations. At bs16 /
// D = 64 a level has ~100 destinations of fan-in 1-3, a few hundred KFLOP,
// and ~45 levels each wait for the one below. What a level costs is the
// longest dependent chain inside one slot plus whatever separates two
// levels: round trips to device memory (about 1000 cycles each), and the
// matrix products of one slot, which a warp alone issues at well under one
// instruction a cycle.
//
// What the design does about it:
//   * One persistent launch walks all real levels. Blocks are co-resident
//     (a cooperative launch, the grid no larger than the occupancy allows)
//     and meet at a barrier in device memory between two levels
//     (grid_barrier, level_common.cuh), which costs about 1.4 microseconds
//     where a launch per level cost the launch and a cold start of every
//     block.
//     A level reads hf rows that the same launch wrote on other SMs: those
//     loads go past L1 (__ldcg) and never take the read-only path, and every
//     thread fences its writes before the barrier.
//   * A block serves one expert for the whole scan and keeps that expert's
//     slices wk, wv [D, D] and w_ih [D, 3D] in shared memory, copied once at
//     its start from the wrapper's expert-major, zero-padded copy (5 D^2
//     floats: 80 KB at D = 64; past D = 96 wk and wv alone, see
//     level_common.cuh). Block b serves expert b % T. A warp streams the
//     matrices out of shared memory, whose bandwidth an SM's warps share
//     (measured: with eight busy warps in a block the two products took 15k
//     cycles a slot, with one 9k), so a level's slots are dealt out one to a
//     block before any block gets a second, and the grid is as large as can
//     be co-resident, up to a block per slot.
//   * A warp computes a slot, with no block barrier inside a level, and
//     finds the slot's in-edges in the level's list instead of scanning the
//     level's edge table (level_slot.cuh; the lists come from
//     ops/level_kernel.level_lists, one launch of level_lists.cu per batch).
//     Inside a slot, four in-edges are gathered and multiplied together; the
//     products' loops run to constant bounds over the padded matrices, so
//     they unroll into loads at fixed offsets; and whatever does not depend
//     on hf (the next level's slot: its indices and static inputs, three
//     dependent round trips) is loaded between the phases of the current
//     slot, so that when the barrier opens a warp has only hf left to read.
//   * The TPU kernel computed all T experts and selected with a mask, and
//     gathered/scattered rows with one-hot matmuls (Mosaic has no dynamic
//     row gather). Here a slot reads only its own expert and gathers rows
//     with indexed loads. fp32 FMA: tensor cores would mean TF32 or bf16.
//
// Values: fp32, or bf16 on both routes (the JAX package's throughput mode,
// level_kernel.py:352-356; the giant forward in bf16 is kernel 1's bf16
// launch without residuals, bit for bit): pack_lv, hf and the residuals are
// then bf16 in memory and rounded where the JAX kernel rounds them
// (level_slot.cuh), while registers, shared memory, the softmax scratch and
// every sum stay fp32. The expert weights are the wrapper's fp32 copies
// either way (a bf16 weight is exact in fp32, and so is the product of two
// bf16 values), so the products read them as before.
//
// Residuals (training): with res_e / res_n given, each updated slot also
// writes, for the backward kernel (level_scan_bwd.cu), per live in-edge
// res_e [Ep, 3D+1] = hf_src | khf | v | attn and per slot
// res_n [Np, 4D] = msg | r | z | nw, unpadded. Rows of slots that are not
// updated, of edges that are not live and of padding levels are not written
// and never read: the buffers need no zero fill.

#include <cuda_runtime.h>

#include "level_slot.cuh"

namespace {

template <class V>
struct ScanForward {
  const V* pack_lv;       // [L, Ep, D+2]
  const int* lv_src;      // [L, Ep]
  const int* lv_nodes;    // [L, Np] node id of each slot
  const int* slot_rows;   // [L, Np]
  const int* slot_off;    // [L, T+1]
  const int* in_rows;     // [L, Ep]
  const int* in_off;      // [L, Np+1]
  const float* wkv_e;     // [T, 2, DP, DP], DP = D rounded up to 32
  const float* wih_e;     // [T, DP, 3 DP]
  const float* b_ih;      // [T, 3D]
  const float* b_hh;      // [T, 3D]
  const float* wa_k;      // [T, D]
  V* hf;                  // [N, D] zeroed; sources read, each level's rows written
  float* score_buf;       // [Ep] scratch
  float* v_buf;           // [Ep, D] scratch
  V* res_e;               // [L, Ep, 3D+1] or null
  V* res_n;               // [L, Np, 4D] or null
  unsigned* barrier;      // zeroed
  int num_levels, ep, np, dim, num_experts;
};

template <class V>
__device__ __forceinline__ LevelFwd<V> level_of(const ScanForward<V>& p, int l) {
  const size_t eo = (size_t)l * p.ep, no = (size_t)l * p.np;
  return LevelFwd<V>{p.pack_lv + eo * (p.dim + 2), p.lv_src + eo, p.slot_rows + no,
                  p.slot_off + (size_t)l * (p.num_experts + 1), p.in_rows + eo,
                  p.in_off + (size_t)l * (p.np + 1)};
}

// Cooperative launch: T * nbe blocks of kLevelThreads; block b serves expert
// b % T as the (b / T)-th of its nbe blocks.
template <int NF, class V>
__global__ void __launch_bounds__(kLevelThreads) level_scan_kernel(const ScanForward<V> p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.dim, T = p.num_experts;
  const int e = blockIdx.x % T, be = blockIdx.x / T, nbe = gridDim.x / T;
  float* scratch;
  const ExpertVec<NF> x = load_expert_vec<NF>(p.b_ih, p.b_hh, p.wa_k, e, D);
  const ExpertWeights w = stage_forward_weights<NF>(smem, p.wkv_e, p.wih_e, e, &scratch);
  const size_t ew = 3 * (size_t)D + 1;
  // Two levels ahead of the one it computes a warp holds its expert's range
  // of the slot list, one level ahead its own slot, prepared in stages
  // (NextSlot) that are issued between the phases of the current slot: by
  // the time a level's barrier opens, all that is left to load is hf.
  const int first = first_slot(be, nbe), stride = slot_stride(nbe);
  const int* so = p.slot_off + e;                 // this expert's column of slot_off [L, T+1]
  auto range = [&](int l, int (&r)[2]) {          // level l's positions [r[0], r[1]), loads only
    r[0] = l < p.num_levels ? __ldg(so + (size_t)l * (T + 1)) : 0;
    r[1] = l < p.num_levels ? __ldg(so + (size_t)l * (T + 1) + 1) : 0;
  };
  int cur[2], nxt[2], far[2];
  range(0, cur);
  range(1, nxt);
  NextSlot<NF, V> next;
  next.start(level_of(p, 0), p.lv_nodes, cur[0] + first, cur[0] + first < cur[1], D);
  next.a();
  next.b();
  next.c();
  for (int l = 0; l < p.num_levels; ++l) {
    const size_t eo = (size_t)l * p.ep, no = (size_t)l * p.np;
    const SlotPrep<NF> ready = next.sp;
    next.start(level_of(p, l + 1), p.lv_nodes + no + p.np, nxt[0] + first,
               nxt[0] + first < nxt[1], D);   // past the last level: an empty range
    next.a();
    range(l + 2, far);
    level_forward_block<NF, V, V>(level_of(p, l), cur[0] + first, cur[1], stride, w, x, p.hf,
                                  p.hf, p.lv_nodes + no, p.score_buf, p.v_buf,
                                  p.res_e ? p.res_e + eo * ew : nullptr,
                                  p.res_n ? p.res_n + no * 4 * D : nullptr, scratch, D, &ready,
                                  next);
    cur[0] = nxt[0], cur[1] = nxt[1];
    nxt[0] = far[0], nxt[1] = far[1];
    if (l + 1 < p.num_levels) grid_barrier(p.barrier, (unsigned)(l + 1) * gridDim.x);
  }
}

template <int NF, class V>
cudaError_t launch_scan(ScanForward<V> p, cudaStream_t s) {
  const size_t smem = forward_smem<NF>();
  static DeviceConfig configs[kMaxDevices];
  int sms = 0, per_sm = 0;
  cudaError_t err = device_config(level_scan_kernel<NF, V>, smem, configs, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  // a block per slot of a level's expert (its warps stream the expert's matrices
  // out of shared memory, whose bandwidth an SM's warps share), as far as the
  // blocks are co-resident
  int nbe = p.np;
  if (nbe > per_sm * sms / p.num_experts) nbe = per_sm * sms / p.num_experts;
  if (nbe < 1) return cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(p.barrier, 0, sizeof(unsigned), s)) != cudaSuccess) return err;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(level_scan_kernel<NF, V>),
                                     dim3(p.num_experts * nbe), dim3(kLevelThreads), args, smem,
                                     s);
}

}  // namespace

extern "C" {

// Runs levels [0, num_levels) of the level tables in one cooperative launch
// on `stream`. Tables and lists are row-major int32 with a leading level
// axis, pack_lv is [L, Ep, D+2]; hf [N, D] must be zeroed by the caller.
// res_e [L, Ep, 3D+1] and res_n [L, Np, 4D] are both given (training) or both
// null. pack_lv, hf, res_e and res_n hold bf16 with `bf16` set, else fp32;
// the weights, b_ih, b_hh, wa_k and the scratch are fp32. `barrier`: one
// unsigned of device memory. Returns 0, or the cudaError_t of the failed
// call: a launch that is refused never runs.
int mgvae_level_scan_forward(
    const void* pack_lv, const int* lv_src, const int* lv_nodes, const int* slot_rows,
    const int* slot_off, const int* in_rows, const int* in_off, const float* wkv_e,
    const float* wih_e, const float* b_ih, const float* b_hh, const float* wa_k, void* hf,
    float* score_buf, float* v_buf, void* res_e, void* res_n, unsigned* barrier,
    int num_levels, int ep, int np, int dim, int num_experts, int bf16, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || num_levels < 0 || (res_e == nullptr) != (res_n == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_levels == 0) return 0;
  cudaError_t err = cudaSuccess;
  MGVAE_WITH_VALUE(bf16, {
    ScanForward<V> p{static_cast<const V*>(pack_lv), lv_src, lv_nodes, slot_rows, slot_off,
                     in_rows, in_off, wkv_e, wih_e, b_ih, b_hh, wa_k, static_cast<V*>(hf),
                     score_buf, v_buf, static_cast<V*>(res_e), static_cast<V*>(res_n), barrier,
                     num_levels, ep, np, dim, num_experts};
    MGVAE_WITH_NF(dim, err = launch_scan<NF, V>(p, static_cast<cudaStream_t>(stream)));
  });
  return static_cast<int>(err);
}

const char* mgvae_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
