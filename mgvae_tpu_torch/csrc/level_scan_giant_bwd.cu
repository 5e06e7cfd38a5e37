// Backward of the level recurrence for one batch of any size
// (num_rounds == 1), with fp32 or bf16 values, for Hopper (sm_90a): it
// recomputes every level's forward intermediates from the saved hf, K levels
// at a time.
//
// Replaces mgvae_tpu/ops/pallas/level_kernel.py::fused_level_scan_hbm_bwd
// (_level_bwd_kernel_hbm, the backward of the custom VJP
// pallas_level_scan_hbm). Inputs: the cotangent ghf [N, D] (a working copy,
// updated in place), the forward's hf [N, D], the level tables, pack_lv and
// the weights. No residuals exist: where level_scan_bwd.cu reads stacked
// res_e [L, Ep, 3D+1] and res_n [L, Np, 4D], this backward rebuilds them for
// a chunk of K levels into scratch of K levels' size. Recomputing from the
// final hf is exact: with one round a source's row is final before any
// level that reads it runs, and a level never reads a row of its own or a
// later level as a source. Outputs: d_pack [L, Ep, D+2] = [dv | dscore | 0]
// per edge and the weight gradients d_wkv [D, 2TD], d_wih [D, 3TD],
// d_bih / d_bhh [T, 3D], d_wak [T, D].
//
// What bounds it on this card: latency. The giant example (one layered MIG
// circuit, width 512 x depth 200, D = 64) is ~200 dependent levels of 512
// slots of fan-in 2-3. Of a level's work only the slot backward and the
// source sums form the dependent chain (ghf flows down from one level to
// the next). The recompute reads nothing but the saved hf, and the weight
// gradients nothing that a later level changes: neither belongs on the chain.
//
// What the design does about it: the real levels are walked from the top in
// chunks of K (ops/level_kernel.giant_chunk_levels: K from a byte budget, so
// that the route keeps its point, memory O(N * D + K * Ep * D); the last
// chunk ragged). Per chunk, on the caller's stream:
//   1. the recompute: one launch over all K * Np slots of the chunk, no
//      barrier (every row it reads is final), the forward's slot body
//      (level_slot.cuh) with residual outputs and the new row dropped:
//      res_e = hf_src | khf | v | attn, res_n = msg | r | z | nw. A block
//      serves one expert and stages its weights once for the K levels; the
//      expert's slots of the chunk, in level order, are dealt out over all
//      of its blocks' warps, so a level of few slots does not leave warps
//      idle while another waits;
//   2. the reverse sweep of the K levels: the fused backward's persistent
//      cooperative launch (level_slot_bwd.cuh, level_scan_bwd_kernel) on the
//      chunk's arrays: per level the slot phase, a grid barrier, the source
//      sums ghf[src] += dhf_src in row order, a grid barrier;
//   3. the chunk's weight gradients: the fused backward's partial tiles, a
//      partial per level of the chunk, then their pairwise sums added into
//      the outputs. Chunks add in chunk order on one stream: no atomics,
//      the same result on every run.
// Four launches per chunk, three for a chunk of one level, against four per
// level before. The recompute and the sweep stay apart:
// one launch for both would need the forward's and the backward's weights in
// shared memory at once (144 KB at D = 64: one block an SM, where the sweep
// runs two). No scratch needs a fill: every launch visits live rows only.
// The TPU kernel's DMA streams of hf and ghf through VMEM, its
// read-modify-write scatter stream, lane padding and chunk loops have no
// counterpart.
//
// bf16 values (the JAX package's throughput mode): hf and pack_lv are read
// as bf16 and d_pack is written as bf16, but the JAX kernel does not round
// where the fused backward does (_level_bwd_kernel_hbm): it keeps the ghf
// stream in fp32 (level_kernel.py:1557-1564), adds each level's dhf_src
// into it unrounded (:1486-1518), and uses the level values it recomputes
// (khf, v, attn, msg, r, z, nw) in fp32 (:1375-1410); only the products'
// operands are rounded. So the recompute runs the forward slot body with
// bf16 values and fp32 residual scratch (R = float, level_slot.cuh), and
// the sweep the backward slot body with bf16 values and fp32 residuals and
// ghf (level_slot_bwd.cuh): the same two templates as the fused kernels, in
// another instantiation. dscore goes to an fp32 buffer for d_wak, as in
// the fused backward. The launches per chunk are fp32's.

#include <cuda_runtime.h>

#include "level_slot.cuh"
#include "level_slot_bwd.cuh"

namespace {

// K levels' recompute: every array from the chunk's first level on. V: the
// value type of pack_lv and hf; the residual scratch is fp32.
template <class V>
struct Recompute {
  const V* pack_lv;       // [K, Ep, D+2]
  const int* lv_src;      // [K, Ep]
  const int* slot_rows;   // [K, Np]
  const int* slot_off;    // [K, T+1]
  const int* in_rows;     // [K, Ep]
  const int* in_off;      // [K, Np+1]
  const float* wkv_e;     // [T, 2, DP, DP]
  const float* wih_e;     // [T, DP, 3 DP]
  const float* b_ih;      // [T, 3D]
  const float* b_hh;      // [T, 3D]
  const float* wa_k;      // [T, D]
  const V* hf;            // [N, D] the forward's result
  float* score_buf;       // [K, Ep] scratch
  float* v_buf;           // [K, Ep, D] scratch
  float* res_e;           // [K, Ep, 3D+1]
  float* res_n;           // [K, Np, 4D]
  int levels, ep, np, dim, num_experts;
};

// Grid: T * nbe blocks of kLevelThreads; block b serves expert b % T. The
// expert's k-th slot of the chunk (levels in order, each level's list in
// order) goes to the warp first_slot numbers k % slot_stride: as a level's
// slots in the persistent scan, spread over the blocks before any block
// gets a second.
template <int NF, class V>
__global__ void __launch_bounds__(kLevelThreads) level_recompute_kernel(const Recompute<V> p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.dim, T = p.num_experts;
  const int e = blockIdx.x % T, nbe = gridDim.x / T;
  const int* so = p.slot_off + e;                 // this expert's column of slot_off [K, T+1]
  int total = 0;
  for (int l = 0; l < p.levels; ++l) {
    total += __ldg(so + (size_t)l * (T + 1) + 1) - __ldg(so + (size_t)l * (T + 1));
  }
  if (total == 0) return;                         // block-uniform
  float* scratch;
  const ExpertVec<NF> x = load_expert_vec<NF>(p.b_ih, p.b_hh, p.wa_k, e, D);
  const ExpertWeights w = stage_forward_weights<NF>(smem, p.wkv_e, p.wih_e, e, &scratch);
  const int warp = first_slot(blockIdx.x / T, nbe), stride = slot_stride(nbe);
  const size_t ew = 3 * (size_t)D + 1;
  NoNext none;
  int before = 0;                                 // the expert's slots in the levels below l
  for (int l = 0; l < p.levels; ++l) {
    const size_t eo = (size_t)l * p.ep, no = (size_t)l * p.np;
    const int p0 = __ldg(so + (size_t)l * (T + 1)), p1 = __ldg(so + (size_t)l * (T + 1) + 1);
    const LevelFwd<V> lv{p.pack_lv + eo * (D + 2), p.lv_src + eo, p.slot_rows + no,
                         p.slot_off + (size_t)l * (T + 1), p.in_rows + eo,
                         p.in_off + (size_t)l * (p.np + 1)};
    const int first = ((warp - before) % stride + stride) % stride;
    level_forward_block<NF, V, float>(lv, p0 + first, p1, stride, w, x, p.hf, nullptr, nullptr,
                                      p.score_buf + eo, p.v_buf + eo * D, p.res_e + eo * ew,
                                      p.res_n + no * 4 * D, scratch, D, nullptr, none);
    before += p1 - p0;
  }
}

template <int NF, class V>
cudaError_t launch_recompute(const Recompute<V>& p, cudaStream_t s) {
  const size_t smem = forward_smem<NF>();
  static DeviceConfig configs[kMaxDevices];
  int sms = 0, per_sm = 0;
  cudaError_t err = device_config(level_recompute_kernel<NF, V>, smem, configs, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  // a warp per slot of the chunk, as many blocks as fit on the card at once
  // (the blocks need not be co-resident: no barrier)
  const long long slots = (long long)p.levels * p.np;
  long long nbe = (slots + kLevelWarps - 1) / kLevelWarps;
  const long long resident = (long long)per_sm * sms / p.num_experts;
  if (nbe > resident) nbe = resident;
  if (nbe < 1) nbe = 1;
  level_recompute_kernel<NF, V><<<p.num_experts * (int)nbe, kLevelThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Backward of the giant forward (mgvae_level_scan_forward without residuals)
// over levels [0, num_levels), on `stream`, in chunks of `chunk_levels`
// levels from the top. ghf [N, D] (fp32 in both value types) is a working
// copy of hf's cotangent, updated in place; hf [N, D] is the forward's
// result; the lists are the forward's; wkv_e [T, 2, D, D] and wih_e
// [T, D, 3D] are the expert-major copies of the weights, wvt_e [T, D, D]
// and wiht_e [T, 3D, D] the transposed slices. d_pack [L, Ep, D+2] and grads
// (the five weight gradients end to end: d_wkv, d_wih, d_bih, d_bhh, d_wak;
// they are added into) must be zeroed by the caller. Scratch of
// K = chunk_levels levels, fp32, none of which needs a fill: res_e
// [K, Ep, 3D+1], res_n [K, Np, 4D], dkv [K, Ep, 2D], dg [K, Np, 6D],
// score_buf [K, Ep], v_buf [K, Ep, D], dhf_buf [Ep, D] and, when K > 1,
// partial [K, weight-gradient floats]; `barrier`: one unsigned. With `bf16`
// hf, pack_lv and d_pack hold bf16, and wkt_e [T, DP, DP] (wk_e transposed)
// and dscore [K, Ep] (fp32 scratch) are given; else they are null and those
// arrays fp32. Adds to *launched (host memory) one for each kernel it
// enqueues. Returns 0, or the cudaError_t of the first failed call: a
// cooperative launch that is refused never runs.
int mgvae_level_scan_giant_backward(
    float* ghf, const void* hf, const void* pack_lv, const int* lv_src, const int* lv_nodes,
    const int* slot_rows, const int* slot_off, const int* in_rows, const int* in_off,
    const int* src_rows, const float* wkv_e, const float* wih_e, const float* wvt_e,
    const float* wiht_e, const float* b_ih, const float* b_hh, const float* wa_k,
    void* d_pack, float* res_e, float* res_n, float* dkv, float* dg,
    float* score_buf, float* v_buf, float* dhf_buf, float* grads, float* partial,
    const float* wkt_e, float* dscore, unsigned* barrier, int* launched, int num_levels,
    int chunk_levels, int ep, int np, int dim, int num_experts, int bf16, void* stream) {
  if (dim < 1 || dim > kMaxDim || num_experts < 1 || num_experts > kMaxExperts ||
      ep < 1 || np < 1 || num_levels < 0 || chunk_levels < 1 || launched == nullptr ||
      (bf16 && (wkt_e == nullptr || dscore == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = dim, T = num_experts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LevelBwd all{lv_src, slot_rows, slot_off, in_rows, in_off, src_rows};
  for (int top = num_levels; top > 0; top -= chunk_levels) {
    const int l0 = top > chunk_levels ? top - chunk_levels : 0, k = top - l0;
    const size_t eo = static_cast<size_t>(l0) * ep, no = static_cast<size_t>(l0) * np;
    const LevelBwd lv = level_of(all, l0, ep, np, T);
    cudaError_t err = cudaSuccess;
    void* dp = nullptr;   // the chunk's rows of d_pack
    MGVAE_WITH_VALUE(bf16, {
      const Recompute<V> rc{static_cast<const V*>(pack_lv) + eo * (D + 2), lv.src,
                            lv.slot_rows, lv.slot_off, lv.in_rows, lv.in_off, wkv_e, wih_e, b_ih,
                            b_hh, wa_k, static_cast<const V*>(hf), score_buf, v_buf, res_e, res_n,
                            k, ep, np, D, T};
      const ScanBackward<V, float> sw{ghf, res_e, res_n, lv_nodes + no, lv, wkv_e, wvt_e,
                                      wiht_e, b_hh, wa_k, static_cast<V*>(d_pack) + eo * (D + 2),
                                      dkv, dg, dhf_buf, wkt_e, dscore, barrier, k, ep, np, D, T};
      dp = sw.d_pack;
      MGVAE_WITH_NF(D, err = launch_recompute<NF, V>(rc, s));
      if (err == cudaSuccess) {
        ++*launched;
        MGVAE_WITH_NF(D, err = launch_sweep<NF, V, float>(sw, s));
      }
    });
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    err = launch_weight_grads(res_e, res_n, dp, dkv, dg, lv, grads, partial, k, 1, ep, np, D, T,
                              true, s, launched, 0, bf16 ? dscore : nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
