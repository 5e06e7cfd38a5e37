// What one destination slot of one level computes in the forward, shared by
// the level scan (level_scan.cu: the fused route and the giant route's
// forward), the giant backward's recompute (level_scan_giant_bwd.cu) and the
// single-level step (level_step.cu): gather hf[src] of the slot's in-edges, the hf-side
// key/value of the slot's expert, the masked segment softmax over the
// in-edges, msg = sum attn * v, then a GRU step with h = 0. The kernels
// differ only in where hf is read from, where the new row goes and how the
// levels are launched.
//
// One warp computes one slot: lane l owns features l, l + 32, ... in
// registers, the score reduction is a shuffle, and the slot's in-edges come
// from the level's list (ops/level_kernel.level_lists): no block barrier and
// no scan of the level's edge table. What a slot costs is its chain of
// dependent loads and products, so:
//   * the indices of up to 32 in-edges are loaded at once, a lane each;
//   * kBatch in-edges are computed together: their sources' rows are
//     gathered (coalesced) in one round trip into the warp's scratch in
//     shared memory, interleaved so that one 16-byte broadcast load brings
//     feature i of all four, and every weight element read feeds four
//     accumulators. A slot of at most kBatch in-edges, the common case,
//     keeps its values and scores in registers through the softmax; past
//     that they go through score_buf / v_buf in device memory;
//   * what does not depend on hf (a slot's indices and the first batch's
//     static inputs: SlotPrep) is loaded apart from the rest, in three
//     stages of one round trip each; the persistent scan issues the stages
//     of a warp's next-level slot between the phases of its current one
//     (NextSlot), so that they cost it no wait, and has them ready when the
//     barrier opens.
// Every sum runs in list order (an edge list is in row order) whichever path
// a slot takes, so the result is the same on every run and in every kernel
// that uses this body.
#pragma once

#include "level_common.cuh"

namespace {

// One level's tables and lists. Positions p in [slot_off[e], slot_off[e+1])
// are expert e's updated slots: slot_rows[p] is the slot and
// in_rows[in_off[p] .. in_off[p+1]) are the rows of its live in-edges. V:
// the value type (level_common.cuh).
template <class V>
struct LevelFwd {
  const V* pack;         // [Ep, D+2]: [vhs | score_static | expert]
  const int* src;        // [Ep] source node of each edge row
  const int* slot_rows;  // [Np]
  const int* slot_off;   // [T+1]
  const int* in_rows;    // [Ep]
  const int* in_off;     // [Np+1]
};

// What a slot's warp holds before it reads hf.
template <int NF>
struct SlotPrep {
  int slot, eb, n;            // the slot, its first position in in_rows, its in-edges
  int out;                    // the row of `out` that gets the slot's new row
  int j, s;                   // lane t < min(n, 32): row and source node of in-edge t
  float pv[kBatch][NF];       // the first batch's vhs, this lane's features
  float ps[kBatch];           // and score_static
};

// An expert's vectors, this lane's features: wa_k, b_ih + b_hh of the r and
// z gates, b_ih and b_hh of the n gate. Loaded once per block.
template <int NF>
struct ExpertVec {
  float wa[NF], br[NF], bz[NF], bin[NF], bhn[NF];
};

template <int NF>
__device__ __forceinline__ ExpertVec<NF> load_expert_vec(
    const float* __restrict__ b_ih, const float* __restrict__ b_hh,
    const float* __restrict__ wa_k, int e, int D) {
  const int lane = threadIdx.x & 31;
  const float* bi = b_ih + (size_t)e * 3 * D;
  const float* bh = b_hh + (size_t)e * 3 * D;
  ExpertVec<NF> x;
#pragma unroll
  for (int q = 0; q < NF; ++q) {
    const int d = lane + 32 * q;
    const bool own = d < D;
    x.wa[q] = own ? __ldg(wa_k + (size_t)e * D + d) : 0.f;
    x.br[q] = own ? __ldg(bi + d) + __ldg(bh + d) : 0.f;
    x.bz[q] = own ? __ldg(bi + D + d) + __ldg(bh + D + d) : 0.f;
    x.bin[q] = own ? __ldg(bi + 2 * D + d) : 0.f;
    x.bhn[q] = own ? __ldg(bh + 2 * D + d) : 0.f;
  }
  return x;
}

// Row and source of the slot's in-edge t (all lanes get them).
template <int NF, class V>
__device__ __forceinline__ void edge_of(const LevelFwd<V>& lv, const SlotPrep<NF>& sp, int t,
                                        int* j, int* s) {
  if (t < 32) {
    *j = __shfl_sync(0xffffffffu, sp.j, t);
    *s = __shfl_sync(0xffffffffu, sp.s, t);
  } else {
    *j = __ldg(lv.in_rows + sp.eb + t);
    *s = __ldg(lv.src + *j);
  }
}

// One batch's static inputs: vhs and score_static of in-edges t0 .. t0+3.
template <int NF, class V>
__device__ __forceinline__ void load_pack(const LevelFwd<V>& lv, const SlotPrep<NF>& sp, int t0,
                                          int D, float (&pv)[kBatch][NF], float (&ps)[kBatch]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    int j = 0, s;
    if (t0 + u < sp.n) edge_of(lv, sp, t0 + u, &j, &s);   // warp-uniform
    const V* row = lv.pack + (size_t)j * (D + 2);
    ps[u] = t0 + u < sp.n ? load_ro(row + D) : 0.f;
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      const int d = lane + 32 * q;
      pv[u][q] = (t0 + u < sp.n && d < D) ? load_ro(row + d) : 0.f;
    }
  }
}

// A slot's SlotPrep in three stages, each a round trip to device memory that
// needs the one before: called by all lanes of the warp that takes position
// p of the level's slot list. They read the lists and pack only: nothing
// that a level below writes. Stage a issues loads and uses none of them, so
// it never waits. The slot's new row will go to row out_index[slot] of the
// output, or row slot without out_index.
template <int NF, class V>
__device__ __forceinline__ void slot_prepare_a(const LevelFwd<V>& lv, int p, SlotPrep<NF>& sp) {
  sp.slot = __ldg(lv.slot_rows + p);
  sp.eb = __ldg(lv.in_off + p);
  sp.n = __ldg(lv.in_off + p + 1);   // the end of the slot's in-edges, until stage b
}

template <int NF, class V>
__device__ __forceinline__ void slot_prepare_b(const LevelFwd<V>& lv,
                                               const int* __restrict__ out_index,
                                               SlotPrep<NF>& sp) {
  const int lane = threadIdx.x & 31;
  sp.n -= sp.eb;
  sp.j = lane < sp.n ? __ldg(lv.in_rows + sp.eb + lane) : 0;
  sp.out = out_index ? __ldg(out_index + sp.slot) : sp.slot;
}

template <int NF, class V>
__device__ __forceinline__ void slot_prepare_c(const LevelFwd<V>& lv, int D, SlotPrep<NF>& sp) {
  sp.s = (threadIdx.x & 31) < sp.n ? __ldg(lv.src + sp.j) : 0;
  load_pack(lv, sp, 0, D, sp.pv, sp.ps);
}

template <int NF, class V>
__device__ __forceinline__ SlotPrep<NF> level_slot_prepare(
    const LevelFwd<V>& lv, int p, const int* __restrict__ out_index, int D) {
  SlotPrep<NF> sp;
  slot_prepare_a(lv, p, sp);
  slot_prepare_b(lv, out_index, sp);
  slot_prepare_c(lv, D, sp);
  return sp;
}

// The slot at position p of the next level's list that a warp of the
// persistent scan prepares while it computes its slot of this level: a() at
// the level's start, b() and c() where the slot body calls them, between its
// phases, each by then with the stage before it long landed. A warp with no
// slot now runs them back to back. Each stage runs once.
template <int NF, class V>
struct NextSlot {
  LevelFwd<V> lv;
  const int* out_index;
  int p, D, stage;   // stage: the next to run; 3: none (done, or no slot there)
  SlotPrep<NF> sp;
  __device__ __forceinline__ void start(const LevelFwd<V>& level, const int* index, int pos,
                                        bool any, int dim) {
    lv = level;
    out_index = index;
    p = pos;
    D = dim;
    stage = any ? 0 : 3;
  }
  __device__ __forceinline__ void a() {
    if (stage == 0) {
      slot_prepare_a(lv, p, sp);
      stage = 1;
    }
  }
  __device__ __forceinline__ void b() {
    if (stage == 1) {
      slot_prepare_b(lv, out_index, sp);
      stage = 2;
    }
  }
  __device__ __forceinline__ void c() {
    if (stage == 2) {
      slot_prepare_c(lv, D, sp);
      stage = 3;
    }
  }
};

// For a launch of one level: nothing to prepare.
struct NoNext {
  __device__ __forceinline__ void b() {}
  __device__ __forceinline__ void c() {}
};

// Called by all lanes of the warp that owns the prepared slot, with w its
// expert's wk, wv, w_ih. Reads the sources' rows from `hf` past L1 (a
// persistent launch wrote them itself, on other SMs) and writes the slot's
// new row to row sp.out of `out` [., D]; `hf` and `out` may be one array (a
// level writes rows of a higher level than any it reads); a null `out` drops
// the row (the giant backward recomputes levels for their residuals only).
// With res_e / res_n given it also writes the slot's residual rows (see
// level_scan.cu). `scratch`: kBatch * DP floats of shared memory of this
// warp's own, 16-byte aligned. `next`: see NextSlot.
//
// hf and out hold V, the residuals R (V, or float where the giant backward's
// recompute keeps them unrounded); everything else is fp32. In bf16 the
// values are rounded where the JAX package's _level_body rounds them
// (mgvae_tpu/ops/pallas/level_kernel.py): v * attn before the message sum
// (:418-420; the softmax weights are then taken before the sum, not after
// as in fp32), msg before the GRU product (:427), the residuals (:446-453;
// R = V) and the new row (:480). hf's rows are bf16 already when gathered
// (:393). With R = float the residuals are the unrounded fp32 values, as
// the JAX giant backward recomputes them (:1375-1410): msg is its sum
// before the rounding that feeds the GRU product.
template <int NF, class V, class R, class Next>
__device__ __forceinline__ void level_slot_forward(
    const LevelFwd<V>& lv, SlotPrep<NF>& sp, const ExpertWeights& w, const ExpertVec<NF>& x,
    Next& next,
    const V* hf,                      // [N, D]
    V* out,                           // [., D] or null
    float* score_buf,                 // [Ep] scratch in device memory
    float* v_buf,                     // [Ep, D] scratch in device memory
    R* __restrict__ res_e,            // [Ep, 3D+1] or null
    R* __restrict__ res_n,            // [Np, 4D] or null
    float* scratch, int D) {
  const int lane = threadIdx.x & 31;
  const size_t ew = 3 * (size_t)D + 1;
  const bool in_registers = sp.n <= kBatch;   // warp-uniform
  bool own[NF];
#pragma unroll
  for (int q = 0; q < NF; ++q) own[q] = lane + 32 * q < D;

  // pass 1: score and value of each in-edge, a batch at a time, and the
  // scores' max
  float smax = -1e30f;
  float v[kBatch][NF], score[kBatch];
  int row[kBatch];
  for (int t0 = 0; t0 < sp.n; t0 += kBatch) {
    if (t0 > 0) load_pack(lv, sp, t0, D, sp.pv, sp.ps);
    float h[kBatch][NF], k[kBatch][NF];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      int s = 0;
      row[u] = 0;
      if (t0 + u < sp.n) edge_of(lv, sp, t0 + u, &row[u], &s);
      const V* hrow = hf + (size_t)s * D;
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        h[u][q] = (t0 + u < sp.n && own[q]) ? load_cg(hrow + lane + 32 * q) : 0.f;
        k[u][q] = 0.f;
        v[u][q] = 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < NF; ++q) {   // every lane: the rows past D are 0
      *reinterpret_cast<float4*>(scratch + kBatch * (lane + 32 * q)) =
          make_float4(h[0][q], h[1][q], h[2][q], h[3][q]);
    }
    __syncwarp();
    // k, v of the batch's four in-edges: a row of wk and of wv at a time
    constexpr int DP = Staged<NF>::DP;
    const float* wk = w.a + lane;
    const float* wv = w.b + lane;
#pragma unroll 8
    for (int i = 0; i < DP; ++i) {
      const float4 hi4 = *reinterpret_cast<const float4*>(scratch + kBatch * i);
      const float hi[kBatch] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const float wkq = wk[i * DP + 32 * q], wvq = wv[i * DP + 32 * q];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          k[u][q] = fmaf(hi[u], wkq, k[u][q]);
          v[u][q] = fmaf(hi[u], wvq, v[u][q]);
        }
      }
    }
    __syncwarp();  // the next batch overwrites scratch
    next.b();
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      score[u] = 0.f;
#pragma unroll
      for (int q = 0; q < NF; ++q) score[u] = fmaf(k[u][q], x.wa[q], score[u]);
    }
    warp_sums(score);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (t0 + u >= sp.n) break;   // warp-uniform
      score[u] += sp.ps[u];
      smax = fmaxf(smax, score[u]);
      const size_t j = row[u];
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        if (!own[q]) continue;
        const int d = lane + 32 * q;
        v[u][q] += sp.pv[u][q];
        if (!in_registers) v_buf[j * D + d] = v[u][q];
        if (res_e) {
          R* re = res_e + j * ew;
          re[d] = from_float<R>(h[u][q]);
          re[D + d] = from_float<R>(k[u][q]);
          re[2 * D + d] = from_float<R>(v[u][q]);
        }
      }
      if (!in_registers && lane == 0) score_buf[j] = score[u];
    }
  }
  __syncwarp();  // lane 0's scores are read by every lane below

  // pass 2: masked softmax over the slot's in-edges (shift clipped to
  // [-80, 0], +1e-16 on the normalizer) and the message
  float den = 0.f, acc[NF];
#pragma unroll
  for (int q = 0; q < NF; ++q) acc[q] = 0.f;
  if constexpr (!IsBf16<V>::value) {
    if (in_registers) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u >= sp.n) break;
        const float ex = expf(fminf(fmaxf(score[u] - smax, -80.f), 0.f));
        den += ex;
#pragma unroll
        for (int q = 0; q < NF; ++q) acc[q] = fmaf(ex, v[u][q], acc[q]);
      }
    } else {
      for (int t = 0; t < sp.n; ++t) {
        int j, s;
        edge_of(lv, sp, t, &j, &s);
        const float ex = expf(fminf(fmaxf(__ldcg(score_buf + j) - smax, -80.f), 0.f));
        den += ex;
#pragma unroll
        for (int q = 0; q < NF; ++q) {
          if (own[q]) acc[q] = fmaf(ex, __ldcg(v_buf + (size_t)j * D + lane + 32 * q), acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NF; ++q) acc[q] /= den + 1e-16f;
  } else {
    // the normaliser first, then the sum of round(v * attn)
    if (in_registers) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u < sp.n) den += expf(fminf(fmaxf(score[u] - smax, -80.f), 0.f));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u >= sp.n) break;
        const float a = expf(fminf(fmaxf(score[u] - smax, -80.f), 0.f)) / (den + 1e-16f);
#pragma unroll
        for (int q = 0; q < NF; ++q) acc[q] += round_to<V>(v[u][q] * a);
      }
    } else {
      for (int t = 0; t < sp.n; ++t) {
        int j, s;
        edge_of(lv, sp, t, &j, &s);
        den += expf(fminf(fmaxf(__ldcg(score_buf + j) - smax, -80.f), 0.f));
      }
      for (int t = 0; t < sp.n; ++t) {
        int j, s;
        edge_of(lv, sp, t, &j, &s);
        const float a =
            expf(fminf(fmaxf(__ldcg(score_buf + j) - smax, -80.f), 0.f)) / (den + 1e-16f);
#pragma unroll
        for (int q = 0; q < NF; ++q) {
          if (own[q]) acc[q] += round_to<V>(__ldcg(v_buf + (size_t)j * D + lane + 32 * q) * a);
        }
      }
    }
  }
  float msg[NF];   // the GRU product's operand; the residual keeps acc
#pragma unroll
  for (int q = 0; q < NF; ++q) {
    msg[q] = round_to<V>(acc[q]);   // 0 past D
    scratch[lane + 32 * q] = msg[q];
  }
  __syncwarp();
  if (res_e) {
    // training only: each in-edge's softmax weight, a lane per edge
    for (int t = lane; t < sp.n; t += 32) {
      const int j = t < 32 ? sp.j : __ldg(lv.in_rows + sp.eb + t);
      float sc = score[0];
      if (in_registers) {
#pragma unroll
        for (int u = 1; u < kBatch; ++u) sc = t == u ? score[u] : sc;
      } else {
        sc = __ldcg(score_buf + j);
      }
      res_e[j * ew + 3 * D] =
          from_float<R>(expf(fminf(fmaxf(sc - smax, -80.f), 0.f)) / (den + 1e-16f));
    }
  }

  // GRU step with h = 0: gi = msg @ w_ih[:, e] + b_ih[e], gh = b_hh[e]
  float gi[3][NF];   // the r, z and n gates' columns
#pragma unroll
  for (int q = 0; q < NF; ++q) gi[0][q] = gi[1][q] = gi[2][q] = 0.f;
  vector_matrix<NF, 3, Staged<NF>::DP, 3 * Staged<NF>::DP, Staged<NF>::DP>(scratch, w.c, gi);
  __syncwarp();  // the warp's next slot overwrites scratch
  next.c();
#pragma unroll
  for (int q = 0; q < NF; ++q) {
    if (!own[q]) continue;
    const int d = lane + 32 * q;
    const float r = 1.f / (1.f + expf(-(gi[0][q] + x.br[q])));
    const float z = 1.f / (1.f + expf(-(gi[1][q] + x.bz[q])));
    const float n = tanhf(gi[2][q] + x.bin[q] + r * x.bhn[q]);
    if (out) out[(size_t)sp.out * D + d] = from_float<V>((1.f - z) * n);
    if (res_n) {
      R* rn = res_n + (size_t)sp.slot * 4 * D;
      rn[d] = from_float<R>(acc[q]);   // for R = V the same as msg
      rn[D + d] = from_float<R>(r);
      rn[2 * D + d] = from_float<R>(z);
      rn[3 * D + d] = from_float<R>(n);
    }
  }
}

// A warp's share of one level: the positions p0, p0 + stride, ... below p1 of
// the level's slot list (expert e's slots that first_slot / slot_stride deal
// to it). The new row of slot s goes to
// out + out_index[s] * D (the scan: hf at the slot's node), to out + s * D
// without out_index (the step), or nowhere without out (the recompute).
// `ready`: the warp's first slot of this level, prepared before the call, or
// null. `next`: see NextSlot; its stages have all run when this returns.
// R: the residuals' type (level_slot_forward).
template <int NF, class V, class R, class Next>
__device__ __forceinline__ void level_forward_block(
    const LevelFwd<V>& lv, int p0, int p1, int stride, const ExpertWeights& w,
    const ExpertVec<NF>& x, const V* hf, V* out, const int* __restrict__ out_index,
    float* score_buf, float* v_buf, R* __restrict__ res_e, R* __restrict__ res_n,
    float* scratch, int D, const SlotPrep<NF>* ready, Next& next) {
  for (int p = p0; p < p1; p += stride) {
    SlotPrep<NF> sp = (ready && p == p0) ? *ready : level_slot_prepare<NF>(lv, p, out_index, D);
    level_slot_forward<NF, V, R>(lv, sp, w, x, next, hf, out, score_buf, v_buf, res_e, res_n,
                                 scratch + (threadIdx.x >> 5) * kBatch * Staged<NF>::DP, D);
  }
  next.b();
  next.c();
}

// Shared memory of a forward block: wk, wv, w_ih where it fits, and
// kBatch * DP floats of scratch per warp.
template <int NF>
constexpr size_t forward_smem() {
  constexpr size_t DP = Staged<NF>::DP;
  return sizeof(float) * ((Staged<NF>::all ? 5 : 2) * DP * DP + kLevelWarps * kBatch * DP);
}

// Called by every thread of a forward block at its start: expert e's
// matrices from the wrapper's expert-major copies wkv_e [T, 2, DP, DP] and
// wih_e [T, DP, 3 DP], staged; *scratch: the shared memory behind them.
template <int NF>
__device__ __forceinline__ ExpertWeights stage_forward_weights(
    float* smem, const float* __restrict__ wkv_e, const float* __restrict__ wih_e, int e,
    float** scratch) {
  constexpr int DP = Staged<NF>::DP;
  const float* wk = wkv_e + (size_t)e * 2 * DP * DP;
  const float* wi = wih_e + (size_t)e * 3 * DP * DP;
  stage(smem, wk, 2 * DP * DP);
  if (Staged<NF>::all) stage(smem + 2 * DP * DP, wi, 3 * DP * DP);
  staged();
  *scratch = smem + (Staged<NF>::all ? 5 : 2) * DP * DP;
  return ExpertWeights{smem, smem + DP * DP, Staged<NF>::all ? smem + 2 * DP * DP : wi};
}

// One level of each of gridDim.y chunks as a launch of its own: the step
// route's level index l of every chunk at once, or the single-level step (one
// chunk). The scan has the level loop inside its persistent kernel, the giant
// backward's recompute a chunk of levels inside one launch.
//
// Chunk k = blockIdx.y finds its level at row `row + k * rows` of the tables
// and lists (all rows' arrays are given), reads its sources from hf rows
// k * n_sub on (the tables' node ids are chunk-local), writes its new rows
// to `out` from the same offset on, and keeps its softmax scratch at k * Ep.
// A chunk past its real levels has empty lists there, so its blocks return
// at once. V: the value type of pack_lv, hf, out and the residuals.
template <class V>
struct StepForward {
  const V* pack_lv;         // [R, Ep, D+2]
  const int* lv_src;        // [R, Ep]
  const int* out_index;     // [R, Np] the slots' nodes (lv_nodes), or null: slot s -> row s
  const int* slot_rows;     // [R, Np]
  const int* slot_off;      // [R, T+1]
  const int* in_rows;       // [R, Ep]
  const int* in_off;        // [R, Np+1]
  const float* wkv_e;       // [T, 2, DP, DP]
  const float* wih_e;       // [T, DP, 3 DP]
  const float* b_ih;        // [T, 3D]
  const float* b_hh;        // [T, 3D]
  const float* wa_k;        // [T, D]
  const V* hf;              // [C * n_sub, D] read
  V* out;                   // [C * n_sub, D] (hf itself on the route) or [Np, D]
  float* score_buf;         // [C, Ep] scratch
  float* v_buf;             // [C, Ep, D] scratch
  V* res_e;                 // [R, Ep, 3D+1] or null
  V* res_n;                 // [R, Np, 4D] or null
  int row, rows;            // chunk 0's row; rows from one chunk's level to the next's
  int n_sub, ep, np, dim, num_experts;
};

// Grid: (T * nbe, chunks) blocks of kLevelThreads; block (b, k) serves
// expert b % T of chunk k.
template <int NF, class V>
__global__ void __launch_bounds__(kLevelThreads) level_fwd_kernel(const StepForward<V> p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.dim, T = p.num_experts, e = blockIdx.x % T, k = blockIdx.y;
  const size_t r = p.row + (size_t)k * p.rows;
  const int* so = p.slot_off + r * (T + 1);
  const int p1 = __ldg(so + e + 1);
  if (__ldg(so + e) == p1) return;  // block-uniform
  const LevelFwd<V> lv{p.pack_lv + r * p.ep * (D + 2), p.lv_src + r * p.ep,
                       p.slot_rows + r * p.np, so, p.in_rows + r * p.ep,
                       p.in_off + r * (p.np + 1)};
  const size_t h0 = (size_t)k * p.n_sub * D, ew = 3 * (size_t)D + 1;
  float* scratch;
  const ExpertVec<NF> x = load_expert_vec<NF>(p.b_ih, p.b_hh, p.wa_k, e, D);
  const ExpertWeights w = stage_forward_weights<NF>(smem, p.wkv_e, p.wih_e, e, &scratch);
  NoNext none;
  const int nbe = gridDim.x / T;
  level_forward_block<NF, V, V>(lv, __ldg(so + e) + first_slot(blockIdx.x / T, nbe), p1,
                                slot_stride(nbe), w, x, p.hf + h0, p.out + h0,
                                p.out_index ? p.out_index + r * p.np : nullptr,
                                p.score_buf + (size_t)k * p.ep, p.v_buf + (size_t)k * p.ep * D,
                                p.res_e ? p.res_e + r * p.ep * ew : nullptr,
                                p.res_n ? p.res_n + r * p.np * 4 * D : nullptr, scratch, D,
                                nullptr, none);
}

// Launches the kernel above for `chunks` chunks on stream s, with
// chunk_blocks_per_expert blocks per expert.
template <int NF, class V>
cudaError_t launch_level_forward(const StepForward<V>& p, int chunks, cudaStream_t s) {
  static DeviceConfig configs[kMaxDevices];
  int sms = 0, per_sm = 0;
  cudaError_t err = device_config(level_fwd_kernel<NF, V>, forward_smem<NF>(), configs, &sms,
                                  &per_sm);
  if (err != cudaSuccess) return err;
  // blocks the device holds at once
  const int nbe = chunk_blocks_per_expert(p.np, per_sm * sms, p.num_experts, chunks);
  level_fwd_kernel<NF, V><<<dim3(p.num_experts * nbe, chunks), kLevelThreads,
                            forward_smem<NF>(), s>>>(p);
  return cudaGetLastError();
}

}  // namespace
