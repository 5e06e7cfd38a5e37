// The level recurrence one level per launch (num_rounds == 1), with fp32 or
// bf16 values, for Hopper (sm_90a): the single-level step from an explicit
// hf, and the step route's forward, which walks a chunked batch's level
// indices with one launch each for all chunks.
//
// Replaces mgvae_tpu/ops/pallas/level_kernel.py::level_step_call
// (_level_step_kernel), with and without its residual outputs, and the
// lax.scan over it in mgvae_tpu/models/dg_ae.py::_level_scan_step. A level
// computes what one level of the fused scan computes (level_scan.cu).
//   * mgvae_level_step_forward: one level; hf [N, D] is an input that is
//     only read, and the new rows go to h_new [Np, D] in slot order, not
//     scattered (the public level_step, and the route's plain structure:
//     models/dg_ae.level_step_loop scatters them in torch between calls).
//   * mgvae_level_scan_step_forward: the route. A chunked batch (C chunks
//     of L level rows each, chunk-local node ids, chunk k's hf rows at
//     k * n_sub) whose chunks are too large for the fused route's size gate
//     runs level index l of every chunk in one launch, l = 0 .. max real
//     levels - 1, the loop here on the host: one call per pass. Each
//     updated slot's new row goes straight into hf at its node, as the JAX
//     scan body's hf.at[nodes].set(where(upd, h_new, 0)): hf starts zeroed
//     and each real node belongs to one level, so the rows of slots that are
//     not updated (0 there) are left as they are.
//
// What bounds it on this card: latency, launches and the host. A level of a
// bs64 MIG chunk has a few hundred destinations of fan-in 1-3 at D = 64:
// under a MFLOP and a few hundred KB per chunk, far from the card's rates.
// Driven a call per (chunk, level) with the scatter in torch, the host takes
// ~0.3 ms a row against ~9 us of device time; so the route makes one host
// call a pass.
//
// What the design does about it: the slot body of level_scan.cu
// (level_slot.cuh) in one launch per level index: a warp per destination
// slot, the slot's in-edges from the level's list
// (ops/level_kernel.level_lists), a block per expert with that expert's
// weight slices in shared memory, the chunk in blockIdx.y (a chunk past its
// real levels has empty lists, so its blocks return at once), as many
// blocks as fill the card once. The scatter is the slot body's out_index
// path (the fused scan's). The TPU kernel's source windows
// (_step_prologue), one-hot gathers, lane padding of the residuals and
// chunk picking have no counterpart here.
//
// Rows of h_new whose slot is not updated are left as the caller gave them
// (zeroed); the residual rows of such slots, of edges that are not live and
// of rows past a chunk's real levels are not written and never read.
//
// bf16 values (the JAX package's throughput mode; its step kernel runs
// _level_body, as the fused kernel does): hf, pack, h_new and the residuals
// are bf16 in memory and rounded where kernel 1 rounds them (level_slot.cuh,
// R = V); the softmax scratch and every sum stay fp32.

#include <cuda_runtime.h>

#include "level_slot.cuh"

extern "C" {

// One launch on `stream`. h_new [Np, D] must be zeroed by the caller. res_e
// [Ep, 3D+1] and res_n [Np, 4D] are both given (training) or both null. The
// lists are one level's. hf, pack, h_new, res_e and res_n hold bf16 with
// `bf16` set, else fp32. Returns 0, or the cudaError_t of the failed launch.
int mgvae_level_step_forward(
    const void* hf, const void* pack, const int* src, const int* slot_rows,
    const int* slot_off, const int* in_rows, const int* in_off, const float* wkv_e,
    const float* wih_e, const float* b_ih, const float* b_hh, const float* wa_k, void* h_new,
    float* score_buf, float* v_buf, void* res_e, void* res_n,
    int ep, int np, int dim, int num_experts, int bf16, void* stream) {
  if (bad_dims(ep, np, dim, num_experts) || (res_e == nullptr) != (res_n == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  MGVAE_WITH_VALUE(bf16, {
    const StepForward<V> p{static_cast<const V*>(pack), src, nullptr, slot_rows, slot_off,
                           in_rows, in_off, wkv_e, wih_e, b_ih, b_hh, wa_k,
                           static_cast<const V*>(hf), static_cast<V*>(h_new), score_buf, v_buf,
                           static_cast<V*>(res_e), static_cast<V*>(res_n),
                           0, 0, 0, ep, np, dim, num_experts};
    MGVAE_WITH_NF(dim, err = launch_level_forward<NF, V>(p, 1, static_cast<cudaStream_t>(stream)));
  });
  return static_cast<int>(err);
}

// The step route's forward on `stream`: for l = 0 .. max(levels) - 1 one
// launch that runs row k * rows + l of the tables for every chunk k < chunks
// (`levels`: each chunk's real level count, host memory). hf [chunks * n_sub,
// D] must be zeroed by the caller; the tables (pack_lv [R, Ep, D+2], lv_src
// [R, Ep], lv_nodes [R, Np]) and the lists are all R = chunks * rows rows'.
// res_e [R, Ep, 3D+1] and res_n [R, Np, 4D] are both given (training) or
// both null. hf, pack_lv, res_e and res_n hold bf16 with `bf16` set, else
// fp32. score_buf [chunks, Ep] and v_buf [chunks, Ep, D] are fp32 scratch.
// Adds to *launched (host memory) one for each kernel it enqueues. Returns 0,
// or the cudaError_t of the first failed launch.
int mgvae_level_scan_step_forward(
    void* hf, const void* pack_lv, const int* lv_src, const int* lv_nodes,
    const int* slot_rows, const int* slot_off, const int* in_rows, const int* in_off,
    const float* wkv_e, const float* wih_e, const float* b_ih, const float* b_hh,
    const float* wa_k, float* score_buf, float* v_buf, void* res_e, void* res_n,
    const int* levels, int* launched, int chunks, int rows, int n_sub, int ep, int np,
    int dim, int num_experts, int bf16, void* stream) {
  if (bad_dims(ep, np, dim, num_experts) || (res_e == nullptr) != (res_n == nullptr) ||
      chunks < 1 || rows < 1 || n_sub < 1 || levels == nullptr || launched == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int top = 0;
  for (int k = 0; k < chunks; ++k) {
    if (levels[k] < 0 || levels[k] > rows) return static_cast<int>(cudaErrorInvalidValue);
    top = levels[k] > top ? levels[k] : top;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  MGVAE_WITH_VALUE(bf16, {
    StepForward<V> p{static_cast<const V*>(pack_lv), lv_src, lv_nodes, slot_rows, slot_off,
                     in_rows, in_off, wkv_e, wih_e, b_ih, b_hh, wa_k,
                     static_cast<const V*>(hf), static_cast<V*>(hf), score_buf, v_buf,
                     static_cast<V*>(res_e), static_cast<V*>(res_n),
                     0, rows, n_sub, ep, np, dim, num_experts};
    for (int l = 0; l < top && err == cudaSuccess; ++l) {
      p.row = l;
      MGVAE_WITH_NF(dim, err = launch_level_forward<NF, V>(p, chunks, s));
      if (err == cudaSuccess) ++*launched;
    }
  });
  return static_cast<int>(err);
}

}  // extern "C"
