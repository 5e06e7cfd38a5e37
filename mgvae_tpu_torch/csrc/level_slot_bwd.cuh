// The backward of one level, shared by the fused level scan's backward
// (level_scan_bwd.cu), the giant backward (level_scan_giant_bwd.cu) and the
// single-level step's (level_step_bwd.cu): what one destination slot computes
// from its saved residuals, the sums of the sources' gradients without
// atomics, the persistent reverse sweep over a run of levels, and the
// weight-gradient kernels that run over saved rows. The
// backwards differ in where a slot's cotangent comes from (a row of the
// carried ghf, or the step's own g [Np, D]), in where the sources' gradients
// go (added into the carried ghf, or into a zeroed d_hf) and in how the
// levels are launched.
//
// As in the forward (level_slot.cuh) a warp owns a slot, lane l features l,
// l + 32, ..., the slot's in-edges and a source's rows come from the level
// lists, and what does not depend on the sweep (indices, the slot's
// residuals: SlotPrepBwd) is loaded in three stages that a persistent sweep
// issues between the phases of the warp's current slot (NextSlotBwd, as the
// forward's NextSlot). The transposed products read copies of the expert's
// matrices that the wrapper transposed (lane d on column d of a row: no bank
// conflict, no uncoalesced row). And the per-edge products collapse: with
// dk = dscore * wa_k[e] and dv = attn * dmsg,
//   dhf_src = dk . wk_e^T + dv . wv_e^T = dscore * ck + attn * cv,
//   ck = wa_k[e] . wk_e^T  (one vector per expert, once per block),
//   cv = dmsg . wv_e^T     (one product per slot),
// so an in-edge costs O(D), not O(D^2).
//
// Values (level_common.cuh): the slot backward, the source sums and the
// persistent sweep are templates of the value type V (d_pack, and the
// rounding points of the products' operands) and of R, the type of the
// residuals and of the carried cotangent (ghf, or the step's g and d_hf).
// Every level backward instantiates them in fp32 and in bf16: the fused
// backward and the step route's with R = V, the giant backward with
// R = float. With V = bf16 the values are rounded where the JAX package's
// _level_bwd_body rounds them (level_kernel.py): dgi before the dmsg product
// (:728), dmsg (:732), dk | dv before the dhf_src product (:750; the
// per-edge products then do not collapse: a slot reads wk_e^T too and
// computes each in-edge's dhf_src as the forward computes its k and v) and
// d_pack (:758); dscore goes to an fp32 buffer for d_wak, as the JAX kernel
// sums it unrounded. With R = V = bf16 the residuals and the carried ghf are
// bf16 in memory, and dhf_src and a source's sum are rounded before and
// after it is added to ghf (:774-778). With R = float (the giant backward,
// _level_bwd_kernel_hbm, :1375-1518) the recomputed residuals, ghf, dhf_src
// and the source sums stay fp32, unrounded.
#pragma once

#include "level_common.cuh"

namespace {

// A backward warp's scratch in shared memory: 4 DP floats (dgi, dmsg), and
// in bf16 2 kBatch DP for a batch's rounded dk | dv.
template <int NF, class V>
__host__ __device__ constexpr int bwd_scratch_floats() {
  return (IsBf16<V>::value ? 2 * kBatch : 4) * Staged<NF>::DP;
}

// One level's lists for the backward (see LevelFwd; src_rows: the level's
// live edge rows grouped by source node, each group in row order, in_off[Np]
// of them).
struct LevelBwd {
  const int* src;        // [Ep]
  const int* slot_rows;  // [Np]
  const int* slot_off;   // [T+1]
  const int* in_rows;    // [Ep]
  const int* in_off;     // [Np+1]
  const int* src_rows;   // [Ep]
};

// Level l's lists, from lists that hold all levels' (each list's rows at l
// times its width).
__host__ __device__ inline LevelBwd level_of(const LevelBwd& all, int l, int ep, int np, int T) {
  const size_t eo = (size_t)l * ep, no = (size_t)l * np;
  return LevelBwd{all.src + eo,
                  all.slot_rows + no,
                  all.slot_off + (size_t)l * (T + 1),
                  all.in_rows + eo,
                  all.in_off + (size_t)l * (np + 1),
                  all.src_rows + eo};
}

// What a slot's warp holds before it reads its cotangent.
template <int NF>
struct SlotPrepBwd {
  int slot, eb, n;              // the slot, its first position in in_rows, its in-edges
  int g;                        // the row of the cotangent array that is the slot's
  int j;                        // lane t < min(n, 32): row of in-edge t
  float a;                      //   and its softmax weight
  float r[NF], z[NF], nw[NF];   // the slot's GRU residuals, this lane's features
  float v[kBatch][NF];          // the first batch's values
};

// An expert's vectors, this lane's features: wa_k and the n gate's b_hh.
// Loaded once per block.
template <int NF>
struct ExpertVecBwd {
  float wa[NF], bhn[NF];
};

template <int NF>
__device__ __forceinline__ ExpertVecBwd<NF> load_expert_vec_bwd(
    const float* __restrict__ b_hh, const float* __restrict__ wa_k, int e, int D) {
  ExpertVecBwd<NF> x;
#pragma unroll
  for (int q = 0; q < NF; ++q) {
    const int d = (threadIdx.x & 31) + 32 * q;
    x.wa[q] = d < D ? __ldg(wa_k + (size_t)e * D + d) : 0.f;
    x.bhn[q] = d < D ? __ldg(b_hh + (size_t)e * 3 * D + 2 * D + d) : 0.f;
  }
  return x;
}

// Values of in-edges t0 .. t0+3, this lane's features.
template <int NF, class R>
__device__ __forceinline__ void load_values(const LevelBwd& lv, const SlotPrepBwd<NF>& sp,
                                            const R* __restrict__ res_e, int t0, int D,
                                            float (&v)[kBatch][NF]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int t = t0 + u;
    int j = 0;
    if (t < sp.n) {   // warp-uniform
      j = t < 32 ? __shfl_sync(0xffffffffu, sp.j, t) : __ldg(lv.in_rows + sp.eb + t);
    }
    const R* re = res_e + (size_t)j * (3 * D + 1) + 2 * D;
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      v[u][q] = (t < sp.n && lane + 32 * q < D) ? to_float(re[lane + 32 * q]) : 0.f;
    }
  }
}

// A slot's SlotPrepBwd in three stages, each a round trip to device memory
// that needs the one before (see the forward's slot_prepare_a .. c): called
// by all lanes of the warp that takes position p of the level's slot list.
// They read the lists and the forward's residuals only. The slot's cotangent
// is row g_index[slot] of the cotangent array, or row slot without g_index.
template <int NF>
__device__ __forceinline__ void slot_bwd_prepare_a(const LevelBwd& lv, int p,
                                                   SlotPrepBwd<NF>& sp) {
  sp.slot = __ldg(lv.slot_rows + p);
  sp.eb = __ldg(lv.in_off + p);
  sp.n = __ldg(lv.in_off + p + 1);   // the end of the slot's in-edges, until stage b
}

template <int NF, class R>
__device__ __forceinline__ void slot_bwd_prepare_b(const LevelBwd& lv,
                                                   const R* __restrict__ res_n,
                                                   const int* __restrict__ g_index, int D,
                                                   SlotPrepBwd<NF>& sp) {
  const int lane = threadIdx.x & 31;
  sp.n -= sp.eb;
  sp.j = lane < sp.n ? __ldg(lv.in_rows + sp.eb + lane) : 0;
  sp.g = g_index ? __ldg(g_index + sp.slot) : sp.slot;
  const R* rn = res_n + (size_t)sp.slot * 4 * D;
#pragma unroll
  for (int q = 0; q < NF; ++q) {
    const int d = lane + 32 * q;
    sp.r[q] = d < D ? to_float(rn[D + d]) : 0.f;
    sp.z[q] = d < D ? to_float(rn[2 * D + d]) : 0.f;
    sp.nw[q] = d < D ? to_float(rn[3 * D + d]) : 0.f;
  }
}

template <int NF, class R>
__device__ __forceinline__ void slot_bwd_prepare_c(const LevelBwd& lv,
                                                   const R* __restrict__ res_e, int D,
                                                   SlotPrepBwd<NF>& sp) {
  sp.a = (threadIdx.x & 31) < sp.n ? to_float(res_e[(size_t)sp.j * (3 * D + 1) + 3 * D]) : 0.f;
  load_values(lv, sp, res_e, 0, D, sp.v);
}

template <int NF, class R>
__device__ __forceinline__ SlotPrepBwd<NF> level_slot_bwd_prepare(
    const LevelBwd& lv, int p, const R* __restrict__ res_e, const R* __restrict__ res_n,
    const int* __restrict__ g_index, int D) {
  SlotPrepBwd<NF> sp;
  slot_bwd_prepare_a(lv, p, sp);
  slot_bwd_prepare_b(lv, res_n, g_index, D, sp);
  slot_bwd_prepare_c(lv, res_e, D, sp);
  return sp;
}

// The slot at position p of the next (lower) level's list that a warp of the
// persistent sweep prepares while it computes its slot of this level: the
// forward's NextSlot for the backward.
template <int NF, class R>
struct NextSlotBwd {
  LevelBwd lv;
  const R* res_e;
  const R* res_n;
  const int* g_index;
  int p, D, stage;   // stage: the next to run; 3: none (done, or no slot there)
  SlotPrepBwd<NF> sp;
  __device__ __forceinline__ void start(const LevelBwd& level, const R* e_rows,
                                        const R* n_rows, const int* index, int pos,
                                        bool any, int dim) {
    lv = level;
    res_e = e_rows;
    res_n = n_rows;
    g_index = index;
    p = pos;
    D = dim;
    stage = any ? 0 : 3;
  }
  __device__ __forceinline__ void a() {
    if (stage == 0) {
      slot_bwd_prepare_a(lv, p, sp);
      stage = 1;
    }
  }
  __device__ __forceinline__ void b() {
    if (stage == 1) {
      slot_bwd_prepare_b(lv, res_n, g_index, D, sp);
      stage = 2;
    }
  }
  __device__ __forceinline__ void c() {
    if (stage == 2) {
      slot_bwd_prepare_c(lv, res_e, D, sp);
      stage = 3;
    }
  }
};

// For a launch of one level: nothing to prepare.
struct NoNextBwd {
  __device__ __forceinline__ void b() {}
  __device__ __forceinline__ void c() {}
};

// Called by all lanes of the warp that owns the prepared slot, with its
// expert's w.b = wv_e^T and w.c = w_ih_e^T, ck [D] = wa_k[e] . wk_e^T, and
// row sp.g of `g` [., D] the cotangent of the slot's h_new (read past L1: a
// persistent sweep wrote it itself). GRU backward with h = 0, dmsg through
// w_ih_e^T, cv through wv_e^T, then the slot's in-edges in list order:
// dattn, the softmax backward, dv, dk and dhf_src. `scratch`:
// bwd_scratch_floats<NF, V>() floats of shared memory of this warp's own
// (DP = 32 NF). `next`: see NextSlotBwd. With V = bf16, w.a = wk_e^T and
// `dscore_out` [Ep] receives each in-edge's dscore in fp32. g and the
// residuals hold R, dhf_buf is rounded to R.
template <int NF, class V, class R, class Next>
__device__ __forceinline__ void level_slot_backward(
    const LevelBwd& lv, SlotPrepBwd<NF>& sp, const ExpertWeights& w,
    const ExpertVecBwd<NF>& x, Next& next, const float* ck, const R* g,
    const R* __restrict__ res_e,       // [Ep, 3D+1] hf_src | khf | v | attn
    V* __restrict__ d_pack,            // [Ep, D+2]: dv | dscore written
    float* __restrict__ dkv,           // [Ep, 2D]: dk | dv, for the weight gradients
    float* __restrict__ dg,            // [Np, 6D]: dgi | dbh, for the weight gradients
    float* dhf_buf,                    // [Ep, D]: dhf_src, for the source sums
    float* __restrict__ dscore_out,    // [Ep] (bf16 only) or null
    float* scratch, int D) {
  const int lane = threadIdx.x & 31;
  const size_t pw = D + 2;
  constexpr int DP = Staged<NF>::DP;
  float* dgi_s = scratch;             // [3 DP]: gate g's features at g * DP, 0 past D
  float* dmsg_s = scratch + 3 * DP;   // [DP]
  bool own[NF];
  float ckq[NF];

  // GRU backward with h = 0: h_new = (1 - z) * nw, nw = tanh(i_n + r * b_hn)
  float* o = dg + (size_t)sp.slot * 6 * D;
  const R* g_row = g + (size_t)sp.g * D;
#pragma unroll
  for (int q = 0; q < NF; ++q) {
    const int d = lane + 32 * q;
    own[q] = d < D;
    ckq[q] = ck[d];
    if (!own[q]) {
      dgi_s[d] = dgi_s[DP + d] = dgi_s[2 * DP + d] = 0.f;
      continue;
    }
    const float r = sp.r[q], z = sp.z[q], nw = sp.nw[q];
    const float go = load_cg(g_row + d);
    const float dnw = go * (1.f - z);
    const float dz = -go * nw;
    const float dnu = dnw * (1.f - nw * nw);                  // pre-tanh
    const float dr = dnu * x.bhn[q];
    const float dzeta = dz * z * (1.f - z);                   // pre-sigmoid z
    const float drho = dr * r * (1.f - r);                    // pre-sigmoid r
    dgi_s[d] = round_to<V>(drho);
    dgi_s[DP + d] = round_to<V>(dzeta);
    dgi_s[2 * DP + d] = round_to<V>(dnu);
    o[d] = drho;
    o[D + d] = dzeta;
    o[2 * D + d] = dnu;
    o[3 * D + d] = drho;
    o[4 * D + d] = dzeta;
    o[5 * D + d] = dnu * r;
  }
  __syncwarp();

  // dmsg = dgi . w_ih_e^T, then cv = dmsg . wv_e^T
  float dmsg1[1][NF], cv1[1][NF];
#pragma unroll
  for (int q = 0; q < NF; ++q) dmsg1[0][q] = cv1[0][q] = 0.f;
  vector_matrix<NF, 1, 3 * DP, DP, 0>(dgi_s, w.c, dmsg1);
  float (&dmsg)[NF] = dmsg1[0];   // 0 past D: w_ih^T's columns there are
#pragma unroll
  for (int q = 0; q < NF; ++q) {
    dmsg[q] = round_to<V>(dmsg[q]);
    dmsg_s[lane + 32 * q] = dmsg[q];
  }
  __syncwarp();
  next.b();
  if constexpr (!IsBf16<V>::value) vector_matrix<NF, 1, DP, DP, 0>(dmsg_s, w.b, cv1);
  const float (&cv)[NF] = cv1[0];
  __syncwarp();  // the warp's next slot (or, in bf16, the edge products) overwrites scratch
  next.c();

  // softmax weight of in-edge t (all lanes get it)
  auto attn_of = [&](int t) {
    if (t < 32) return __shfl_sync(0xffffffffu, sp.a, t);
    return to_float(res_e[(size_t)__ldg(lv.in_rows + sp.eb + t) * (3 * D + 1) + 3 * D]);
  };
  // dattn = v . dmsg of in-edges t0 .. t0+3
  float dattn[kBatch];
  auto batch = [&](int t0) {
    if (t0 > 0 || sp.n > kBatch) load_values(lv, sp, res_e, t0, D, sp.v);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      dattn[u] = 0.f;
#pragma unroll
      for (int q = 0; q < NF; ++q) dattn[u] = fmaf(sp.v[u][q], dmsg[q], dattn[u]);
    }
    warp_sums(dattn);
  };

  // pass 1: sum attn * dattn over the slot's in-edges
  float s_grp = 0.f;
  for (int t0 = 0; t0 < sp.n; t0 += kBatch) {
    batch(t0);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (t0 + u < sp.n) s_grp = fmaf(attn_of(t0 + u), dattn[u], s_grp);
    }
  }

  // pass 2: the softmax backward, dv = attn * dmsg, dk = dscore * wa_k[e],
  // dhf_src = dscore * ck + attn * cv (fp32), or in bf16
  // round(dk) . wk_e^T + round(dv) . wv_e^T, rounded
  for (int t0 = 0; t0 < sp.n; t0 += kBatch) {
    if (sp.n > kBatch) batch(t0);   // else dattn still holds the slot's only batch
    size_t rows[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + u;
      rows[u] = 0;
      if (t >= sp.n) {   // warp-uniform
        if constexpr (IsBf16<V>::value) {
#pragma unroll
          for (int q = 0; q < NF; ++q) {
            scratch[kBatch * (lane + 32 * q) + u] = 0.f;
            scratch[kBatch * (DP + lane + 32 * q) + u] = 0.f;
          }
        }
        continue;
      }
      const size_t j = t < 32 ? __shfl_sync(0xffffffffu, sp.j, t)
                              : __ldg(lv.in_rows + sp.eb + t);
      rows[u] = j;
      const float a = attn_of(t);
      const float dscore = a * (dattn[u] - s_grp);
      if (lane == 0) {
        d_pack[j * pw + D] = from_float<V>(dscore);
        if (dscore_out) dscore_out[j] = dscore;
      }
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const int d = lane + 32 * q;
        const float dv = a * dmsg[q];
        if constexpr (IsBf16<V>::value) {   // every lane: the rows past D are 0
          scratch[kBatch * d + u] = round_to<V>(dscore * x.wa[q]);
          scratch[kBatch * (DP + d) + u] = round_to<V>(dv);
        }
        if (!own[q]) continue;
        d_pack[j * pw + d] = from_float<V>(dv);
        dkv[j * 2 * D + d] = dscore * x.wa[q];
        dkv[j * 2 * D + D + d] = dv;
        if constexpr (!IsBf16<V>::value) dhf_buf[j * D + d] = fmaf(dscore, ckq[q], a * cv[q]);
      }
    }
    if constexpr (IsBf16<V>::value) {
      // the batch's dhf_src: a row of wk^T and of wv^T at a time, as the
      // forward's k and v products
      __syncwarp();
      float acc[kBatch][NF];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int q = 0; q < NF; ++q) acc[u][q] = 0.f;
      }
      const float* wk = w.a + lane;
      const float* wv = w.b + lane;
#pragma unroll 8
      for (int i = 0; i < DP; ++i) {
        const float4 k4 = *reinterpret_cast<const float4*>(scratch + kBatch * i);
        const float4 v4 = *reinterpret_cast<const float4*>(scratch + kBatch * (DP + i));
        const float ki[kBatch] = {k4.x, k4.y, k4.z, k4.w};
        const float vi[kBatch] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int q = 0; q < NF; ++q) {
          const float wkq = wk[i * DP + 32 * q], wvq = wv[i * DP + 32 * q];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            acc[u][q] = fmaf(vi[u], wvq, fmaf(ki[u], wkq, acc[u][q]));
          }
        }
      }
      __syncwarp();  // the next batch overwrites scratch
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (t0 + u >= sp.n) break;
#pragma unroll
        for (int q = 0; q < NF; ++q) {
          if (own[q]) dhf_buf[rows[u] * D + lane + 32 * q] = round_to<R>(acc[u][q]);
        }
      }
    }
  }
}

// A warp's share of one level's slot backward: as level_forward_block. The
// cotangent of slot s is the row of g at g_index[s] (the sweeps: ghf at the
// slot's node) or at s without g_index (the step).
template <int NF, class V, class R, class Next>
__device__ __forceinline__ void level_backward_block(
    const LevelBwd& lv, int p0, int p1, int stride, const ExpertWeights& w,
    const ExpertVecBwd<NF>& x, const float* ck, const R* g,
    const int* __restrict__ g_index, const R* __restrict__ res_e,
    const R* __restrict__ res_n, V* __restrict__ d_pack, float* __restrict__ dkv,
    float* __restrict__ dg, float* dhf_buf, float* dscore, float* scratch, int D,
    const SlotPrepBwd<NF>* ready, Next& next) {
  for (int p = p0; p < p1; p += stride) {
    SlotPrepBwd<NF> sp = (ready && p == p0)
                             ? *ready
                             : level_slot_bwd_prepare<NF, R>(lv, p, res_e, res_n, g_index, D);
    level_slot_backward<NF, V, R>(lv, sp, w, x, next, ck, g, res_e, d_pack, dkv, dg, dhf_buf,
                                  dscore,
                                  scratch + (threadIdx.x >> 5) * bwd_scratch_floats<NF, V>(), D);
  }
  next.b();
  next.c();
}

// out[src] += a level's dhf_src rows: a block's share of the level's source
// sums. Several slots of a level can share a source. The level's live rows
// are listed by source; a warp looks at 31 positions of the list at a time, a
// lane each, and where the first of them starts a source's group (the
// position before it holds another source) it sums the group's rows in list
// (= row) order and adds once. No atomics, the same result on every run.
// `first_warp` / `num_warps`: this warp's number among all that share the
// level. dhf_buf and out are read past L1 (a persistent sweep wrote them
// itself). With R = bf16 the group's fp32 sum is rounded, added to its row
// of out and rounded again (level_kernel.py:774-778); with R = float both
// are exact fp32 sums (the giant backward's, :1486-1518).
template <int NF, class R>
__device__ __forceinline__ void level_source_block(
    const LevelBwd& lv, int np, R* out, const float* dhf_buf, int first_warp, int num_warps,
    int D) {
  const int lane = threadIdx.x & 31;
  const int n_live = __ldg(lv.in_off + np);
  for (int i = first_warp; i < n_live; i += num_warps) {
    // lane 0: the position before i; lane t: position i + t - 1
    const int pos = i + lane - 1;
    const int jt = (pos >= 0 && pos < n_live) ? __ldg(lv.src_rows + pos) : -1;
    const int st = jt >= 0 ? __ldg(lv.src + jt) : -1;
    const int s = __shfl_sync(0xffffffffu, st, 1);
    if (__shfl_sync(0xffffffffu, st, 0) == s) continue;   // not a group's start
    // the group: positions i .. i + len - 1
    const unsigned same = __ballot_sync(0xffffffffu, st == s) >> 1;
    int len = __ffs(~same) - 1;                             // leading lanes 1.. that match
    float acc[NF];
#pragma unroll
    for (int q = 0; q < NF; ++q) acc[q] = 0.f;
    for (int r0 = 0; r0 < len; r0 += kBatch) {
      float x[kBatch][NF];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = __shfl_sync(0xffffffffu, jt, (1 + r0 + u) & 31);
#pragma unroll
        for (int q = 0; q < NF; ++q) {
          const int d = lane + 32 * q;
          x[u][q] = (r0 + u < len && d < D) ? __ldcg(dhf_buf + (size_t)j * D + d) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (r0 + u >= len) break;
#pragma unroll
        for (int q = 0; q < NF; ++q) acc[q] += x[u][q];
      }
    }
    // a group longer than the 31 positions in view: the rest one row at a time
    for (int t = i + 31; len == 31 && t < n_live; ++t) {
      const int j = __ldg(lv.src_rows + t);
      if (__ldg(lv.src + j) != s) break;
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        const int d = lane + 32 * q;
        if (d < D) acc[q] += __ldcg(dhf_buf + (size_t)j * D + d);
      }
    }
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      const int d = lane + 32 * q;
      if (d < D) {
        out[(size_t)s * D + d] =
            from_float<R>(load_cg(out + (size_t)s * D + d) + round_to<R>(acc[q]));
      }
    }
  }
}

// The expert's matrices a backward block keeps in shared memory: w_ih^T,
// and where they fit wv^T and (bf16) wk^T.
template <int NF, class V>
__host__ __device__ constexpr int bwd_staged_matrices() {
  return 3 + (Staged<NF>::all ? 1 + (IsBf16<V>::value ? 1 : 0) : 0);
}

// Shared memory of a backward block: the staged matrices, ck [DP] and each
// warp's scratch.
template <int NF, class V>
constexpr size_t backward_smem() {
  constexpr size_t DP = Staged<NF>::DP;
  return sizeof(float) * (bwd_staged_matrices<NF, V>() * DP * DP + DP +
                          kLevelWarps * bwd_scratch_floats<NF, V>());
}

// Called by every thread of a backward block at its start: expert e's
// w_ih_e^T and wv_e^T from the wrapper's copies wiht_e [T, 3 DP, DP] and
// wvt_e [T, DP, DP], staged, and ck = wa_k[e] . wk_e^T from wkv_e
// [T, 2, DP, DP], in shared memory behind them (*ck; *scratch follows).
// With V = bf16 also wk_e^T from wkt_e [T, DP, DP] (w.a).
template <int NF, class V>
__device__ __forceinline__ ExpertWeights stage_backward_weights(
    float* smem, const float* __restrict__ wkv_e, const float* __restrict__ wvt_e,
    const float* __restrict__ wiht_e, const float* __restrict__ wkt_e,
    const float* __restrict__ wa_k, int e, int D, float** ck, float** scratch) {
  constexpr int DP = Staged<NF>::DP;
  constexpr bool kt = IsBf16<V>::value;
  const float* wit = wiht_e + (size_t)e * 3 * DP * DP;
  const float* wvt = wvt_e + (size_t)e * DP * DP;
  const float* wkt = kt ? wkt_e + (size_t)e * DP * DP : nullptr;
  stage(smem, wit, 3 * DP * DP);
  if (Staged<NF>::all) stage(smem + 3 * DP * DP, wvt, DP * DP);
  if (Staged<NF>::all && kt) stage(smem + 4 * DP * DP, wkt, DP * DP);
  *ck = smem + bwd_staged_matrices<NF, V>() * DP * DP;
  const float* wk = wkv_e + (size_t)e * 2 * DP * DP;
  for (int i = threadIdx.x; i < DP; i += blockDim.x) {
    float x = 0.f;
    for (int c = 0; c < D; ++c) x = fmaf(__ldg(wa_k + (size_t)e * D + c), __ldg(wk + i * DP + c), x);
    (*ck)[i] = x;
  }
  staged();
  *scratch = *ck + DP;
  const float* wk_t = kt && Staged<NF>::all ? smem + 4 * DP * DP : wkt;
  return ExpertWeights{wk_t, Staged<NF>::all ? smem + 3 * DP * DP : wvt, smem};
}

// The slot backward and the source sums of one level of each of gridDim.y
// chunks, each as a launch of its own: the step route's level index l of
// every chunk at once, or the single-level step's backward (one chunk). The
// sweeps have both inside their persistent kernel.
//
// Chunk k = blockIdx.y finds its level at row `row + k * rows` of the tables,
// lists and residuals (all rows' arrays are given), reads its slots'
// cotangents from g and adds its sources' gradients into `out`, both from
// rows k * n_sub on (the tables' node ids are chunk-local), and keeps its
// scratch rows dkv, dg and (bf16) dscore at k * scratch_rows rows of the
// level's width from the given pointers on, dhf_buf at k * Ep rows. A chunk
// past its real levels has empty lists there, so its blocks return at once.
// V: the value type of g, the residuals, d_pack and out (R = V).
template <class V>
struct StepBackward {
  LevelBwd lists;           // all rows': lv_src, slot_rows, slot_off, in_rows, in_off, src_rows
  const V* g;               // [C * n_sub, D] (the carried ghf) or [Np, D]
  const int* g_index;       // [R, Np] the slots' nodes (lv_nodes), or null: slot s <- row s
  const V* res_e;           // [R, Ep, 3D+1]
  const V* res_n;           // [R, Np, 4D]
  const float* wkv_e;       // [T, 2, DP, DP]
  const float* wvt_e;       // [T, DP, DP]
  const float* wiht_e;      // [T, 3 DP, DP]
  const float* b_hh;        // [T, 3D]
  const float* wa_k;        // [T, D]
  V* d_pack;                // [R, Ep, D+2]
  float* dkv;               // chunk k's level at dkv + k * scratch_rows * Ep * 2D
  float* dg;                // chunk k's level at dg + k * scratch_rows * Np * 6D
  float* dhf_buf;           // [C, Ep, D]
  V* out;                   // [C * n_sub, D]: ghf (the route) or d_hf (the step), added into
  const float* wkt_e;       // [T, DP, DP]: wk_e transposed (bf16 only), or null
  float* dscore;            // chunk k's level at dscore + k * scratch_rows * Ep (bf16), or null
  int row, rows, scratch_rows;
  int n_sub, ep, np, dim, num_experts;
};

// Grid: (T * nbe, chunks) blocks of kLevelThreads; block (b, k) serves
// expert b % T of chunk k.
template <int NF, class V>
__global__ void __launch_bounds__(kLevelThreads) level_bwd_slot_kernel(const StepBackward<V> p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.dim, T = p.num_experts, e = blockIdx.x % T, k = blockIdx.y;
  const int r = p.row + k * p.rows;
  const size_t sr = (size_t)k * p.scratch_rows;
  const LevelBwd lv = level_of(p.lists, r, p.ep, p.np, T);
  const int p1 = __ldg(lv.slot_off + e + 1);
  if (__ldg(lv.slot_off + e) == p1) return;  // block-uniform
  float *ck, *scratch;
  const ExpertVecBwd<NF> x = load_expert_vec_bwd<NF>(p.b_hh, p.wa_k, e, D);
  const ExpertWeights w = stage_backward_weights<NF, V>(smem, p.wkv_e, p.wvt_e, p.wiht_e,
                                                        p.wkt_e, p.wa_k, e, D, &ck, &scratch);
  NoNextBwd none;
  const int nbe = gridDim.x / T;
  const int p0 = __ldg(lv.slot_off + e) + first_slot(blockIdx.x / T, nbe);
  level_backward_block<NF, V, V>(lv, p0, p1, slot_stride(nbe), w, x, ck,
                                 p.g + (size_t)k * p.n_sub * D,
                                 p.g_index ? p.g_index + (size_t)r * p.np : nullptr,
                                 p.res_e + (size_t)r * p.ep * (3 * D + 1),
                                 p.res_n + (size_t)r * p.np * 4 * D,
                                 p.d_pack + (size_t)r * p.ep * (D + 2),
                                 p.dkv + sr * p.ep * 2 * D, p.dg + sr * p.np * 6 * D,
                                 p.dhf_buf + (size_t)k * p.ep * D,
                                 p.dscore ? p.dscore + sr * p.ep : nullptr, scratch, D, nullptr,
                                 none);
}

// Grid: (any number, chunks) blocks of kLevelThreads.
template <int NF, class V>
__global__ void __launch_bounds__(kLevelThreads) level_bwd_source_kernel(const StepBackward<V> p) {
  const int k = blockIdx.y, r = p.row + k * p.rows;
  level_source_block<NF, V>(level_of(p.lists, r, p.ep, p.np, p.num_experts), p.np,
                            p.out + (size_t)k * p.n_sub * p.dim,
                            p.dhf_buf + (size_t)k * p.ep * p.dim,
                            blockIdx.x * kLevelWarps + (threadIdx.x >> 5), gridDim.x * kLevelWarps,
                            p.dim);
}

// Launches the two kernels above for `chunks` chunks on stream s (blocks per
// expert as the forward's, launch_level_forward).
template <int NF, class V>
cudaError_t launch_level_backward(const StepBackward<V>& p, int chunks, cudaStream_t s) {
  static DeviceConfig configs[kMaxDevices];
  int sms = 0, per_sm = 0;
  cudaError_t err = device_config(level_bwd_slot_kernel<NF, V>, backward_smem<NF, V>(), configs,
                                  &sms, &per_sm);
  if (err != cudaSuccess) return err;
  // blocks the device holds at once
  const int nbe = chunk_blocks_per_expert(p.np, per_sm * sms, p.num_experts, chunks);
  level_bwd_slot_kernel<NF, V><<<dim3(p.num_experts * nbe, chunks), kLevelThreads,
                                 backward_smem<NF, V>(), s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  level_bwd_source_kernel<NF, V><<<dim3((p.ep + kLevelWarps - 1) / kLevelWarps, chunks),
                                   kLevelThreads, 0, s>>>(p);
  return cudaGetLastError();
}

// ---- the persistent reverse sweep ---------------------------------------
//
// The slot phase and the source sums of levels [0, num_levels) of the arrays
// given, from the last down to 0, in one cooperative launch (the fused
// backward's whole sweep, level_scan_bwd.cu; one chunk of levels of the giant
// backward, level_scan_giant_bwd.cu, which passes every array from its
// chunk's first level on).

// V: the value type (d_pack); R: the residuals' and ghf's (V, or float in
// the giant backward).
template <class V, class R>
struct ScanBackward {
  R* ghf;                 // [N, D] cotangent of hf, updated in place
  const R* res_e;         // [L, Ep, 3D+1]
  const R* res_n;         // [L, Np, 4D]
  const int* lv_nodes;    // [L, Np]
  LevelBwd lists;         // all levels': lv_src, slot_rows, slot_off, in_rows, in_off, src_rows
  const float* wkv_e;     // [T, 2, DP, DP], DP = D rounded up to 32
  const float* wvt_e;     // [T, DP, DP]: wv_e transposed
  const float* wiht_e;    // [T, 3 DP, DP]: w_ih_e transposed
  const float* b_hh;      // [T, 3D]
  const float* wa_k;      // [T, D]
  V* d_pack;              // [L, Ep, D+2] zeroed
  float* dkv;             // [L, Ep, 2D]
  float* dg;              // [L, Np, 6D]
  float* dhf_buf;         // [Ep, D] scratch
  const float* wkt_e;     // [T, DP, DP]: wk_e transposed (bf16 only), or null
  float* dscore;          // [L, Ep] (bf16 only), or null
  unsigned* barrier;      // zeroed
  int num_levels, ep, np, dim, num_experts;
};

// Cooperative launch: T * nbe blocks of kLevelThreads; block b serves expert
// b % T as the (b / T)-th of its nbe blocks.
template <int NF, class V, class R>
__global__ void __launch_bounds__(kLevelThreads) level_scan_bwd_kernel(
    const ScanBackward<V, R> p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.dim, T = p.num_experts;
  const int e = blockIdx.x % T, be = blockIdx.x / T, nbe = gridDim.x / T;
  float *ck, *scratch;
  const ExpertVecBwd<NF> x = load_expert_vec_bwd<NF>(p.b_hh, p.wa_k, e, D);
  const ExpertWeights w = stage_backward_weights<NF, V>(smem, p.wkv_e, p.wvt_e, p.wiht_e,
                                                        p.wkt_e, p.wa_k, e, D, &ck, &scratch);
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
  auto start = [&](NextSlotBwd<NF, R>& next, int l, const int (&r)[2]) {
    const size_t lo = l >= 0 ? l : 0;              // below level 0: an empty range
    next.start(level_of(p.lists, lo, p.ep, p.np, T), p.res_e + lo * p.ep * ew,
               p.res_n + lo * p.np * 4 * D, p.lv_nodes + lo * p.np, r[0] + first,
               r[0] + first < r[1], D);
  };
  int l = p.num_levels - 1;
  int cur[2], nxt[2], far[2];
  range(l, cur);
  range(l - 1, nxt);
  NextSlotBwd<NF, R> next;
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
    level_backward_block<NF, V, R>(lv, cur[0] + first, cur[1], stride, w, x, ck, p.ghf,
                                   p.lv_nodes + no, p.res_e + eo * ew, p.res_n + no * 4 * D,
                                   p.d_pack + eo * (D + 2), p.dkv + eo * 2 * D,
                                   p.dg + no * 6 * D, p.dhf_buf,
                                   p.dscore ? p.dscore + eo : nullptr, scratch, D, &ready, next);
    cur[0] = nxt[0], cur[1] = nxt[1];
    nxt[0] = far[0], nxt[1] = far[1];
    grid_barrier(p.barrier, target += gridDim.x);
    level_source_block<NF, R>(lv, p.np, p.ghf, p.dhf_buf,
                           blockIdx.x * kLevelWarps + (threadIdx.x >> 5),
                           gridDim.x * kLevelWarps, D);
    if (l > 0) grid_barrier(p.barrier, target += gridDim.x);
  }
}

template <int NF, class V, class R>
cudaError_t launch_sweep(ScanBackward<V, R> p, cudaStream_t s) {
  const size_t smem = backward_smem<NF, V>();
  static DeviceConfig configs[kMaxDevices];
  int sms = 0, per_sm = 0;
  cudaError_t err = device_config(level_scan_bwd_kernel<NF, V, R>, smem, configs, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  // a block per slot of a level's expert, as far as the blocks are co-resident
  // (level_scan.cu)
  int nbe = p.np;
  if (nbe > per_sm * sms / p.num_experts) nbe = per_sm * sms / p.num_experts;
  if (nbe < 1) return cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(p.barrier, 0, sizeof(unsigned), s)) != cudaSuccess) return err;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(level_scan_bwd_kernel<NF, V, R>),
                                     dim3(p.num_experts * nbe), dim3(kLevelThreads), args, smem,
                                     s);
}


// ---- weight gradients -----------------------------------------------------
//
// out[i, col(e, c)] = sum over the rows r of expert e of A[r, i] * B[r, c],
// for five products at once. The rows are the live edges (d_wkv, d_wak) or
// the updated slots (d_wih, d_bih, d_bhh) of `levels` levels, taken from the
// lists: a block visits its expert's rows only, none of another expert and
// no padding row, so the buffers it reads need no zero fill. The levels are
// cut into chunks of `levels_per_block`; a block owns one (product, expert,
// output tile, chunk) and sums its rows in list order. With one chunk it
// writes (or, `accumulate`, adds into) the outputs themselves; with more,
// each chunk writes a partial and weight_reduce_kernel sums the partials of
// an entry pairwise in a fixed order and writes (or adds) the sum: no
// atomics, the same result on every run, and no accumulator that runs over
// more than a chunk's rows.

struct ExpertGemm {
  const void* a;    // A rows at a + r * lda, width wa; null: A = 1 (wa = 1)
  const void* b;    // B rows at b + r * ldb, width wb
  int a_bf16, b_bf16;   // A, B hold bf16 (else fp32)
  float* out;       // out[i * ldo + (c / seg) * T * seg + e * seg + c % seg]
  int lda, wa, ldb, wb, ldo, seg;
  int edges;        // rows: 1 the live edges, 0 the updated slots
  int tiles_i, tiles_c, first_block;
};

constexpr int kMaxGemms = 5;
struct ExpertGemms {
  ExpertGemm g[kMaxGemms];
  LevelBwd lists;            // all levels': row l of each list at l * its width
  int ep, np, num_experts, levels, levels_per_block;
  int accumulate;            // one chunk only: 0 out = the sum, 1 out += the sum
  size_t chunk_stride;       // floats between two chunks' partials; 0 with one chunk
};

constexpr int kTileI = 8, kTileC = 32, kChunk = 64;

__device__ __forceinline__ float load_any(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Grid: (blocks of all products, chunks). A product with wa > 1 gives each
// thread one entry of an 8 x 32 output tile; one with wa == 1 (a single
// output row: d_wak, d_bih, d_bhh) gives thread (ti, tc) every 8th row of
// the chunk for column tc and sums the 8 shares in a fixed order.
__global__ void __launch_bounds__(kTileI * kTileC) expert_gemm_kernel(const ExpertGemms p) {
  int gi = 0;
  while (gi + 1 < kMaxGemms && static_cast<int>(blockIdx.x) >= p.g[gi + 1].first_block) ++gi;
  const ExpertGemm& g = p.g[gi];
  int local = blockIdx.x - g.first_block;
  const int per_expert = g.tiles_i * g.tiles_c;
  const int e = local / per_expert;
  local %= per_expert;
  const int i0 = (local / g.tiles_c) * kTileI, c0 = (local % g.tiles_c) * kTileC;
  const int tc = threadIdx.x % kTileC, ti = threadIdx.x / kTileC;
  const int l0 = blockIdx.y * p.levels_per_block;
  const int l1 = min(l0 + p.levels_per_block, p.levels);
  const int T1 = p.num_experts + 1, width = g.edges ? p.ep : p.np;
  const int* list = g.edges ? p.lists.in_rows : p.lists.slot_rows;

  // expert e's rows of level l: `len` entries of the level's list from `beg`
  auto segment = [&](int l, int* beg) {
    const int so = __ldg(p.lists.slot_off + l * T1 + e);
    const int so1 = __ldg(p.lists.slot_off + l * T1 + e + 1);
    if (!g.edges) {
      *beg = so;
      return so1 - so;
    }
    const int* off = p.lists.in_off + (size_t)l * (p.np + 1);
    *beg = __ldg(off + so);
    return __ldg(off + so1) - *beg;
  };
  int total = 0;
  for (int l = l0; l < l1; ++l) {
    int beg;
    total += segment(l, &beg);
  }

  __shared__ float as[kChunk][kTileI];
  __shared__ float bs[kChunk][kTileC];
  __shared__ long long row_of[kChunk];   // l * width + row, or -1
  float acc = 0.f;
  for (int r0 = 0; r0 < total; r0 += kChunk) {
    if (threadIdx.x < kChunk) {
      int r = r0 + threadIdx.x;
      long long id = -1;
      for (int l = l0; l < l1 && r < total; ++l) {
        int beg;
        const int len = segment(l, &beg);
        if (r < len) {
          id = (long long)l * width + __ldg(list + (size_t)l * width + beg + r);
          break;
        }
        r -= len;
      }
      row_of[threadIdx.x] = id;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kChunk * kTileC; idx += blockDim.x) {
      const int rr = idx / kTileC, c = c0 + idx % kTileC;
      const long long id = row_of[rr];
      bs[rr][idx % kTileC] =
          (id >= 0 && c < g.wb) ? load_any(g.b, id * g.ldb + c, g.b_bf16) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kChunk * kTileI; idx += blockDim.x) {
      const int rr = idx / kTileI, i = i0 + idx % kTileI;
      const long long id = row_of[rr];
      float v = 0.f;
      if (id >= 0 && i < g.wa) v = g.a ? load_any(g.a, id * g.lda + i, g.a_bf16) : 1.f;
      as[rr][idx % kTileI] = v;
    }
    __syncthreads();
    if (g.wa > 1) {
#pragma unroll 16
      for (int k = 0; k < kChunk; ++k) acc = fmaf(as[k][ti], bs[k][tc], acc);
    } else {
#pragma unroll
      for (int k = ti; k < kChunk; k += kTileI) acc = fmaf(as[k][0], bs[k][tc], acc);
    }
    __syncthreads();
  }
  int i = i0 + ti;
  if (g.wa == 1) {   // block-uniform: the 8 shares of column tc, summed by ti == 0
    bs[ti][tc] = acc;
    __syncthreads();
    if (ti != 0) return;
    acc = ((bs[0][tc] + bs[1][tc]) + (bs[2][tc] + bs[3][tc])) +
          ((bs[4][tc] + bs[5][tc]) + (bs[6][tc] + bs[7][tc]));
    i = 0;
  }
  const int c = c0 + tc;
  if (i < g.wa && c < g.wb) {
    float* o = g.out + blockIdx.y * p.chunk_stride + (size_t)i * g.ldo +
               (size_t)(c / g.seg) * p.num_experts * g.seg + (size_t)e * g.seg + c % g.seg;
    *o = p.accumulate ? *o + acc : acc;
  }
}

// out[x] = the sum over chunks of partial[chunk, x], pairwise (with
// `accumulate`, out[x] + that sum): partials are merged as the bits of a
// binary counter carry, so the tree is fixed by the chunk count alone.
__global__ void weight_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                     int total, int chunks, int accumulate) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= total) return;
  float stack[32];
  int sp = 0;
  for (int c = 0; c < chunks; ++c) {
    float v = partial[(size_t)c * total + x];
    for (int b = c; b & 1; b >>= 1) v = stack[--sp] + v;
    stack[sp++] = v;
  }
  float v = stack[--sp];
  while (sp > 0) v = stack[--sp] + v;
  out[x] = accumulate ? out[x] + v : v;
}

ExpertGemm gemm(const void* a, int lda, int wa, const void* b, int ldb, int wb, int edges,
                float* out, int ldo, int seg, int a_bf16 = 0, int b_bf16 = 0) {
  ExpertGemm g{};
  g.a = a; g.lda = lda; g.wa = wa; g.a_bf16 = a_bf16;
  g.b = b; g.ldb = ldb; g.wb = wb; g.b_bf16 = b_bf16;
  g.edges = edges;
  g.out = out; g.ldo = ldo; g.seg = seg;
  g.tiles_i = (wa + kTileI - 1) / kTileI;
  g.tiles_c = (wb + kTileC - 1) / kTileC;
  return g;
}

// Floats of the five weight gradients laid end to end: d_wkv [D, 2TD],
// d_wih [D, 3TD], d_bih [T, 3D], d_bhh [T, 3D], d_wak [T, D].
inline size_t weight_grad_floats(int D, int T) {
  return static_cast<size_t>(T) * D * (5 * D + 7);
}

// The five weight gradients over `levels` levels of saved rows (res_e, res_n,
// d_pack, dkv, dg and the lists all start at the first of them). `grads`
// holds the five outputs end to end (weight_grad_floats). With
// levels <= levels_per_block: one launch, which writes the outputs or with
// `accumulate` adds into them (every entry belongs to one thread of one
// block, so calls on one stream add in call order). Else two launches: the
// chunks' partials into `partial` [chunks, weight_grad_floats], then their
// pairwise sums written into `grads` or, with `accumulate`, added. Adds one
// to *launched for each kernel it enqueues, where `launched` is not null.
// With `res_bf16` res_e and res_n hold bf16 (else fp32). d_wak reads each
// edge's fp32 dscore from `dscore` [levels, Ep] where that is given (it must
// be where d_pack holds bf16), else from d_pack (fp32).
cudaError_t launch_weight_grads(
    const void* res_e, const void* res_n, const void* d_pack, const float* dkv,
    const float* dg, const LevelBwd& lists, float* grads, float* partial,
    int levels, int levels_per_block, int ep, int np, int D, int T, bool accumulate,
    cudaStream_t s, int* launched = nullptr, int res_bf16 = 0,
    const float* dscore = nullptr) {
  if (levels < 1) return cudaSuccess;
  const int chunks = (levels + levels_per_block - 1) / levels_per_block;
  if (chunks > 1 && partial == nullptr) return cudaErrorInvalidValue;
  const size_t total = weight_grad_floats(D, T);
  float* base = chunks > 1 ? partial : grads;
  float* d_wkv = base;
  float* d_wih = d_wkv + static_cast<size_t>(D) * 2 * T * D;
  float* d_bih = d_wih + static_cast<size_t>(D) * 3 * T * D;
  float* d_bhh = d_bih + static_cast<size_t>(T) * 3 * D;
  float* d_wak = d_bhh + static_cast<size_t>(T) * 3 * D;
  ExpertGemms p{};
  p.lists = lists;
  p.ep = ep;
  p.np = np;
  p.num_experts = T;
  p.levels = levels;
  p.levels_per_block = levels_per_block;
  p.accumulate = accumulate && chunks == 1 ? 1 : 0;
  p.chunk_stride = chunks > 1 ? total : 0;
  // an array's element n: res_e's in its type, d_pack's in fp32
  const auto at = [](const void* x, size_t n, int bf16) {
    return static_cast<const void*>(static_cast<const char*>(x) + n * (bf16 ? 2 : 4));
  };
  // d_wkv[:, k | v block of expert e] = hf_src^T (dk | dv)
  p.g[0] = gemm(res_e, 3 * D + 1, D, dkv, 2 * D, 2 * D, 1, d_wkv, 2 * T * D, D, res_bf16);
  // d_wak[e] = sum dscore * khf
  p.g[1] = dscore ? gemm(dscore, 1, 1, at(res_e, D, res_bf16), 3 * D + 1, D, 1, d_wak, T * D,
                         D, 0, res_bf16)
                  : gemm(at(d_pack, D, 0), D + 2, 1, at(res_e, D, res_bf16), 3 * D + 1, D, 1,
                         d_wak, T * D, D, 0, res_bf16);
  // d_wih[:, expert e block] = msg^T dgi
  p.g[2] = gemm(res_n, 4 * D, D, dg, 6 * D, 3 * D, 0, d_wih, 3 * T * D, 3 * D, res_bf16);
  // d_bih[e] = sum dgi, d_bhh[e] = sum dbh
  p.g[3] = gemm(nullptr, 0, 1, dg, 6 * D, 3 * D, 0, d_bih, 3 * T * D, 3 * D);
  p.g[4] = gemm(nullptr, 0, 1, dg + 3 * D, 6 * D, 3 * D, 0, d_bhh, 3 * T * D, 3 * D);
  int blocks = 0;
  for (int i = 0; i < kMaxGemms; ++i) {
    p.g[i].first_block = blocks;
    blocks += T * p.g[i].tiles_i * p.g[i].tiles_c;
  }
  expert_gemm_kernel<<<dim3(blocks, chunks), kTileI * kTileC, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (launched) ++*launched;
  if (chunks == 1) return cudaSuccess;
  const int n = static_cast<int>(total);
  weight_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(partial, grads, n, chunks,
                                                       accumulate ? 1 : 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (launched) ++*launched;
  return cudaSuccess;
}

}  // namespace
