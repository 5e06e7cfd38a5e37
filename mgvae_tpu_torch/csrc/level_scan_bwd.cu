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
//   * The reverse sweep is one persistent cooperative launch, as the forward
//     (level_scan.cu): a block serves one expert and keeps in shared memory
//     the transposed copies of its wv and w_ih slices that the wrapper made,
//     so that the transposed products read rows, without bank conflicts; a
//     warp owns a slot and takes its in-edges from the level's list; the
//     per-edge D x 2D product dk . wk^T + dv . wv^T collapses to one D x D
//     product per slot and one vector per expert (level_slot_bwd.cuh); the
//     next level's slot (indices, residuals) is loaded between the phases
//     of the current one. Per level,
//     from the last down to 0: the slot phase (GRU backward, dmsg, the
//     attention backward, dk | dv and dgi | dbh saved for the weight
//     gradients, dhf_src per in-edge), a grid barrier, the source sums
//     ghf[src] += dhf_src, a grid barrier. Several slots of a level can share
//     a source: the level's live rows are listed by source, and the warp
//     that finds a group's start sums the group in row order and adds once.
//     No atomics, the same result on every run. A level's sources all sit at
//     lower levels, so the sums never race with the level's own reads of
//     ghf; ghf and dhf_src are read past L1, since the same launch wrote them
//     on other SMs.
//   * The weight gradients follow in one or two more launches, no longer
//     inside each level as on the TPU (level_kernel.py:721-748): a block owns
//     one (product, expert, output tile, chunk of levels) and visits only
//     its expert's live rows, from the lists; the chunks' partials are
//     summed pairwise in a fixed order (level_slot_bwd.cuh).
//   * The TPU kernel's one-hot gathers and scatters, source windows, class
//     tiers and expert-stacked matmuls over all T experts are gone. fp32
//     FMA: tensor cores would mean TF32 or bf16.

#include <cuda_runtime.h>

#include "level_slot_bwd.cuh"

namespace {

struct ScanBackward {
  float* ghf;             // [N, D] cotangent of hf, updated in place
  const float* res_e;     // [L, Ep, 3D+1]
  const float* res_n;     // [L, Np, 4D]
  const int* lv_nodes;    // [L, Np]
  LevelBwd lists;         // all levels': lv_src, slot_rows, slot_off, in_rows, in_off, src_rows
  const float* wkv_e;     // [T, 2, DP, DP], DP = D rounded up to 32
  const float* wvt_e;     // [T, DP, DP]: wv_e transposed
  const float* wiht_e;    // [T, 3 DP, DP]: w_ih_e transposed
  const float* b_hh;      // [T, 3D]
  const float* wa_k;      // [T, D]
  float* d_pack;          // [L, Ep, D+2] zeroed
  float* dkv;             // [L, Ep, 2D]
  float* dg;              // [L, Np, 6D]
  float* dhf_buf;         // [Ep, D] scratch
  unsigned* barrier;      // zeroed
  int num_levels, ep, np, dim, num_experts;
};

// Cooperative launch: T * nbe blocks of kLevelThreads; block b serves expert
// b % T as the (b / T)-th of its nbe blocks.
template <int NF>
__global__ void __launch_bounds__(kLevelThreads) level_scan_bwd_kernel(const ScanBackward p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.dim, T = p.num_experts;
  const int e = blockIdx.x % T, be = blockIdx.x / T, nbe = gridDim.x / T;
  float *ck, *scratch;
  const ExpertVecBwd<NF> x = load_expert_vec_bwd<NF>(p.b_hh, p.wa_k, e, D);
  const ExpertWeights w = stage_backward_weights<NF>(smem, p.wkv_e, p.wvt_e, p.wiht_e, p.wa_k,
                                                     e, D, &ck, &scratch);
  const size_t ew = 3 * (size_t)D + 1;
  unsigned target = 0;
  // As the forward (level_scan.cu): two levels ahead (below) a warp holds its
  // expert's range of the slot list, one level ahead its own slot, prepared
  // in stages between the phases of the current slot.
  const int first = first_slot(be, nbe), stride = slot_stride(nbe);
  const int* so = p.lists.slot_off + e;           // this expert's column of slot_off [L, T+1]
  auto range = [&](int l, int (&r)[2]) {          // level l's positions [r[0], r[1]), loads only
    r[0] = l >= 0 ? __ldg(so + (size_t)l * (T + 1)) : 0;
    r[1] = l >= 0 ? __ldg(so + (size_t)l * (T + 1) + 1) : 0;
  };
  auto start = [&](NextSlotBwd<NF>& next, int l, const int (&r)[2]) {
    const size_t lo = l >= 0 ? l : 0;              // below level 0: an empty range
    next.start(level_of(p.lists, lo, p.ep, p.np, T), p.res_e + lo * p.ep * ew,
               p.res_n + lo * p.np * 4 * D, p.lv_nodes + lo * p.np, r[0] + first,
               r[0] + first < r[1], D);
  };
  int l = p.num_levels - 1;
  int cur[2], nxt[2], far[2];
  range(l, cur);
  range(l - 1, nxt);
  NextSlotBwd<NF> next;
  start(next, l, cur);
  next.a();
  next.b();
  next.c();
  for (; l >= 0; --l) {
    const size_t eo = (size_t)l * p.ep, no = (size_t)l * p.np;
    const LevelBwd lv = level_of(p.lists, l, p.ep, p.np, T);
    const SlotPrepBwd<NF> ready = next.sp;
    start(next, l - 1, nxt);
    next.a();
    range(l - 2, far);
    level_backward_block<NF>(lv, cur[0] + first, cur[1], stride, w, x, ck, p.ghf,
                             p.lv_nodes + no, p.res_e + eo * ew, p.res_n + no * 4 * D,
                             p.d_pack + eo * (D + 2), p.dkv + eo * 2 * D, p.dg + no * 6 * D,
                             p.dhf_buf, scratch, D, &ready, next);
    cur[0] = nxt[0], cur[1] = nxt[1];
    nxt[0] = far[0], nxt[1] = far[1];
    grid_barrier(p.barrier, target += gridDim.x);
    level_source_block<NF>(lv, p.np, p.ghf, p.dhf_buf,
                           blockIdx.x * kLevelWarps + (threadIdx.x >> 5),
                           gridDim.x * kLevelWarps, D);
    if (l > 0) grid_barrier(p.barrier, target += gridDim.x);
  }
}

template <int NF>
cudaError_t launch_sweep(ScanBackward p, cudaStream_t s) {
  const size_t smem = backward_smem<NF>();
  static bool configured = false;
  static int sms = 0, per_sm = 0;   // of the device the first call ran on
  cudaError_t err = cudaSuccess;
  if (!configured) {
    int device = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    bool allowed = false;
    if ((err = allow_shared_memory(level_scan_bwd_kernel<NF>, smem, &allowed)) != cudaSuccess) {
      return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, level_scan_bwd_kernel<NF>,
                                                        kLevelThreads, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  // a block per slot of a level's expert, as far as the blocks are co-resident
  // (level_scan.cu)
  int nbe = p.np;
  if (nbe > per_sm * sms / p.num_experts) nbe = per_sm * sms / p.num_experts;
  if (nbe < 1) return cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(p.barrier, 0, sizeof(unsigned), s)) != cudaSuccess) return err;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(level_scan_bwd_kernel<NF>),
                                     dim3(p.num_experts * nbe), dim3(kLevelThreads), args, smem,
                                     s);
}

}  // namespace

extern "C" {

// Backward of mgvae_level_scan_forward over levels [0, num_levels), on
// `stream`: the sweep, then the weight gradients (two launches in all when
// num_levels <= levels_per_block, else three). ghf [N, D] is a working copy
// of hf's cotangent: it is updated in place. res_e / res_n are the forward's
// residuals and the lists the forward's; wkv_e [T, 2, D, D] is the
// expert-major copy of wkv_hf, wvt_e [T, D, D] and wiht_e [T, 3D, D] the
// transposed slices of wv and w_ih. d_pack [L, Ep, D+2] must be zeroed
// by the caller; dkv [L, Ep, 2D], dg [L, Np, 6D], dhf_buf [Ep, D] and
// partial [ceil(num_levels / levels_per_block), weight-gradient floats] are
// scratch that needs no fill; grads holds the five weight gradients end to
// end (d_wkv, d_wih, d_bih, d_bhh, d_wak), written whole; `barrier`: one
// unsigned. Returns 0, or the cudaError_t of the failed call: a launch that
// is refused never runs.
int mgvae_level_scan_backward(
    float* ghf, const float* res_e, const float* res_n, const int* lv_src, const int* lv_nodes,
    const int* slot_rows, const int* slot_off, const int* in_rows, const int* in_off,
    const int* src_rows, const float* wkv_e, const float* wvt_e, const float* wiht_e,
    const float* b_hh, const float* wa_k, float* d_pack, float* dkv, float* dg, float* dhf_buf,
    float* grads,
    float* partial, unsigned* barrier,
    int num_levels, int levels_per_block, int ep, int np, int dim, int num_experts,
    void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || num_levels < 1 || levels_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LevelBwd lists{lv_src, slot_rows, slot_off, in_rows, in_off, src_rows};
  ScanBackward p{ghf, res_e, res_n, lv_nodes, lists, wkv_e, wvt_e, wiht_e, b_hh, wa_k, d_pack,
                 dkv, dg, dhf_buf, barrier, num_levels, ep, np, dim, num_experts};
  cudaError_t err = cudaSuccess;
  MGVAE_WITH_NF(dim, err = launch_sweep<NF>(p, s));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_weight_grads(res_e, res_n, d_pack, dkv, dg, lists, grads,
                                              partial, num_levels, levels_per_block, ep, np,
                                              dim, num_experts, false, s));
}

}  // extern "C"
