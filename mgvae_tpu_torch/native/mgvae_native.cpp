// Native data-path kernels for mgvae_tpu.
//
// The reference outsources its native needs to external deps (torch_scatter,
// aigtoaig, PyMiniSolvers — SURVEY.md §2.3). Here the host-side hot loops of
// the DATA layer are C++: topological levelization (the per-circuit
// preprocessing hot loop, reference dag_utils.py:10-37) and binary-AIGER
// decoding (replacing the aigtoaig subprocess, aiger_utils.py:115-189).
// Exposed via a plain C ABI consumed with ctypes (no pybind11 in this image).
//
// Build: see mgvae_tpu/native/build.sh (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ABI version: bump whenever ANY exported signature changes (the loader
// refuses mismatches — a stale .so that fails to rebuild must be LOUD, not
// silently called with the old arity; round-3 review finding).
int32_t mg_abi_version() { return 3; }

// ---------------------------------------------------------------------------
// levelize: longest-path levels via Kahn propagation. Returns max level,
// or -1 if the graph has a cycle.
// ---------------------------------------------------------------------------
int64_t mg_levelize(int64_t num_nodes, int64_t num_edges,
                    const int64_t* src, const int64_t* dst,
                    int32_t* out_level) {
  std::vector<int64_t> indeg(num_nodes, 0);
  std::vector<int64_t> out_ptr(num_nodes + 1, 0);
  for (int64_t i = 0; i < num_edges; ++i) {
    indeg[dst[i]]++;
    out_ptr[src[i] + 1]++;
  }
  for (int64_t v = 0; v < num_nodes; ++v) out_ptr[v + 1] += out_ptr[v];
  std::vector<int64_t> out_adj(num_edges);
  {
    std::vector<int64_t> cursor(out_ptr.begin(), out_ptr.end() - 1);
    for (int64_t i = 0; i < num_edges; ++i) out_adj[cursor[src[i]]++] = dst[i];
  }
  std::vector<int64_t> frontier, next;
  frontier.reserve(num_nodes);
  for (int64_t v = 0; v < num_nodes; ++v) {
    out_level[v] = 0;
    if (indeg[v] == 0) frontier.push_back(v);
  }
  int64_t placed = (int64_t)frontier.size();
  int32_t level = 0;
  while (!frontier.empty()) {
    ++level;
    next.clear();
    for (int64_t u : frontier) {
      for (int64_t k = out_ptr[u]; k < out_ptr[u + 1]; ++k) {
        int64_t v = out_adj[k];
        if (--indeg[v] == 0) {
          out_level[v] = level;
          next.push_back(v);
        }
      }
    }
    placed += (int64_t)next.size();
    frontier.swap(next);
  }
  if (placed != num_nodes) return -1;  // cycle
  int32_t maxl = 0;
  for (int64_t v = 0; v < num_nodes; ++v)
    if (out_level[v] > maxl) maxl = out_level[v];
  return maxl;
}

// ---------------------------------------------------------------------------
// Binary AIGER decode (the 'aig' varint/delta format). Matches the node/edge
// construction of the reference's aig_to_xdata_bak: nodes = I PIs + A ANDs
// plus one shared NOT node per inverted variable (incl. inverted POs).
//
// gates_out capacity must be >= I + A + (2A + O) ; edges 2 cols x capacity
// >= 2A + (2A + O). Returns 0 on success, negative error codes otherwise.
// Outputs: n_nodes, n_edges written through pointers.
// ---------------------------------------------------------------------------
static inline int read_uint(const uint8_t* data, int64_t len, int64_t* pos,
                            uint64_t* out) {
  uint64_t x = 0;
  int shift = 0;
  while (*pos < len) {
    uint8_t b = data[(*pos)++];
    x |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = x;
      return 0;
    }
    shift += 7;
  }
  return -1;
}

int32_t mg_aig_decode(const uint8_t* data, int64_t len,
                      int32_t* gates_out, int64_t gates_cap,
                      int64_t* edge_src_out, int64_t* edge_dst_out,
                      int64_t edges_cap,
                      int64_t* n_nodes, int64_t* n_edges) {
  // header: "aig M I L O A\n"
  int64_t pos = 0;
  if (len < 4 || memcmp(data, "aig", 3) != 0) return -2;
  long vals[5];
  int vi = 0;
  pos = 3;
  while (vi < 5 && pos < len) {
    while (pos < len && data[pos] == ' ') ++pos;
    long v = 0;
    bool any = false;
    while (pos < len && data[pos] >= '0' && data[pos] <= '9') {
      v = v * 10 + (data[pos++] - '0');
      any = true;
    }
    if (!any) return -3;
    vals[vi++] = v;
  }
  if (vi != 5) return -3;
  while (pos < len && data[pos] != '\n') ++pos;
  ++pos;
  const int64_t I = vals[1], L = vals[2], O = vals[3], A = vals[4];
  if (L != 0) return -4;  // latches unsupported (combinational only)

  std::vector<int64_t> outputs(O);
  for (int64_t k = 0; k < O; ++k) {
    long v = 0;
    bool any = false;
    while (pos < len && data[pos] >= '0' && data[pos] <= '9') {
      v = v * 10 + (data[pos++] - '0');
      any = true;
    }
    if (!any || pos >= len || data[pos] != '\n') return -5;
    ++pos;
    outputs[k] = v;
  }

  int64_t nn = 0, ne = 0;
  if (I + A > gates_cap) return -6;
  for (int64_t k = 0; k < I; ++k) gates_out[nn++] = 0;  // PI
  for (int64_t k = 0; k < A; ++k) gates_out[nn++] = 1;  // AND

  std::vector<int64_t> has_not(I + A, -1);
  auto resolve = [&](int64_t lit) -> int64_t {
    int64_t idx = lit / 2 - 1;
    if ((lit & 1) == 0) return idx;
    if (has_not[idx] < 0) {
      if (nn >= gates_cap || ne >= edges_cap) return -1;
      gates_out[nn] = 2;  // NOT
      edge_src_out[ne] = idx;
      edge_dst_out[ne] = nn;
      has_not[idx] = nn;
      ++nn;
      ++ne;
    }
    return has_not[idx];
  };

  for (int64_t k = 0; k < A; ++k) {
    uint64_t d0, d1;
    if (read_uint(data, len, &pos, &d0) || read_uint(data, len, &pos, &d1))
      return -7;
    int64_t lhs = 2 * (I + L + k + 1);
    int64_t rhs0 = lhs - (int64_t)d0;
    int64_t rhs1 = rhs0 - (int64_t)d1;
    if (rhs0 < 0 || rhs1 < 0) return -8;
    int64_t and_idx = lhs / 2 - 1;
    int64_t f0 = resolve(rhs0);
    int64_t f1 = resolve(rhs1);
    if (f0 < 0 || f1 < 0 || ne + 2 > edges_cap) return -6;
    edge_src_out[ne] = f0;
    edge_dst_out[ne] = and_idx;
    ++ne;
    edge_src_out[ne] = f1;
    edge_dst_out[ne] = and_idx;
    ++ne;
  }
  for (int64_t k = 0; k < O; ++k) {
    if (outputs[k] & 1) {
      if (resolve(outputs[k]) < 0) return -6;
    }
  }
  *n_nodes = nn;
  *n_edges = ne;
  return 0;
}


// ---------------------------------------------------------------------------
// Batch-collation table builder (the host-side hot path of data/batching.py).
//
// On a real v5e-8, one process collates num_devices shards per step; the
// numpy implementation costs ~27 ms per dp=8 step vs a ~4 ms device step —
// host-bound. This C++ core does the integer-heavy work (level-major
// counting sorts + level/blocked-CSR table fills) in O(N+E).
//
// Semantics mirror the numpy path EXACTLY (tests/test_native.py asserts
// array equality): nodes renumbered level-major (stable by original id),
// level tables rank edges stably by original edge order, blocked tables
// rank edges stably by (by-node id, original edge order).
// ---------------------------------------------------------------------------

// phase 1: real table extents (before bucketing). stats[5] =
// {lv_real, np_real, ep_real, ebf_real, ebr_real}. block = dst-block width.
int64_t mg_collate_stats(int64_t n, const int32_t* fwd,
                         int64_t e, const int64_t* esrc, const int64_t* edst,
                         int64_t block, int64_t* stats) {
  int32_t lv_real = 0;
  for (int64_t v = 0; v < n; ++v)
    if (fwd[v] > lv_real) lv_real = fwd[v];
  std::vector<int64_t> lcnt(lv_real + 2, 0);
  for (int64_t v = 0; v < n; ++v) lcnt[fwd[v]]++;
  int64_t np_real = 0;
  for (int32_t l = 1; l <= lv_real; ++l)
    if (lcnt[l] > np_real) np_real = lcnt[l];
  // inv (new id per node) via stable counting sort by level
  std::vector<int64_t> starts(lv_real + 2, 0);
  for (int32_t l = 0; l <= lv_real; ++l) starts[l + 1] = starts[l] + lcnt[l];
  std::vector<int32_t> inv(n);
  {
    std::vector<int64_t> cur(starts.begin(), starts.end() - 1);
    for (int64_t v = 0; v < n; ++v) inv[v] = (int32_t)cur[fwd[v]]++;
  }
  std::vector<int64_t> ecnt(lv_real + 2, 0);
  int64_t ep_real = 0;
  for (int64_t i = 0; i < e; ++i) ecnt[fwd[edst[i]]]++;
  for (int32_t l = 1; l <= lv_real; ++l)
    if (ecnt[l] > ep_real) ep_real = ecnt[l];
  int64_t nb = (n + block) / block + 1;  // generous
  std::vector<int64_t> bcnt(nb, 0);
  int64_t ebf = 0, ebr = 0;
  for (int64_t i = 0; i < e; ++i) bcnt[inv[edst[i]] / block]++;
  for (int64_t b = 0; b < nb; ++b) { if (bcnt[b] > ebf) ebf = bcnt[b]; bcnt[b] = 0; }
  for (int64_t i = 0; i < e; ++i) bcnt[inv[esrc[i]] / block]++;
  for (int64_t b = 0; b < nb; ++b) if (bcnt[b] > ebr) ebr = bcnt[b];
  stats[0] = lv_real; stats[1] = np_real; stats[2] = ep_real;
  stats[3] = ebf; stats[4] = ebr;
  return lv_real;
}

// phase 2: fill. Outputs pre-filled by the caller with padding defaults
// (lv_nodes/lv_e_src/fa_src/ra_src = dump, lv_e_id = E-1, valids = 0,
// slots = 0, lv_start = n, perm/inv = identity, e_*_out = 0, degs = 0).
int32_t mg_collate_fill(
    int64_t n, const int32_t* fwd,
    int64_t e, const int64_t* esrc, const int64_t* edst,
    int64_t E, int64_t L, int64_t NP, int64_t EP,
    int64_t EBF, int64_t EBR, int64_t block,
    int32_t* perm, int32_t* inv,
    int32_t* e_src_out, int32_t* e_dst_out,
    int32_t* lv_nodes, uint8_t* lv_node_valid,
    int32_t* lv_e_src, int32_t* lv_e_slot, uint8_t* lv_e_valid, int32_t* lv_e_id,
    int32_t* lv_start,
    int32_t* fa_src, int32_t* fa_slot, uint8_t* fa_valid,
    int32_t* ra_src, int32_t* ra_slot, uint8_t* ra_valid,
    float* deg_in, float* deg_out,
    int32_t* fa_eid, int32_t* ra_eid, int32_t* e_lv_row) {
  int32_t lv_real = 0;
  for (int64_t v = 0; v < n; ++v)
    if (fwd[v] > lv_real) lv_real = fwd[v];
  if (lv_real > L) return -1;  // level tables hold update levels 1..L
  std::vector<int64_t> lcnt(lv_real + 2, 0);
  for (int64_t v = 0; v < n; ++v) lcnt[fwd[v]]++;
  std::vector<int64_t> starts(lv_real + 2, 0);
  for (int32_t l = 0; l <= lv_real; ++l) starts[l + 1] = starts[l] + lcnt[l];
  // perm/inv + per-level node tables + slot_of (rank within level)
  std::vector<int32_t> slot_of(n, 0);
  {
    std::vector<int64_t> cur(starts.begin(), starts.end() - 1);
    for (int64_t v = 0; v < n; ++v) {
      int32_t l = fwd[v];
      int64_t pos = cur[l]++;
      perm[pos] = (int32_t)v;
      inv[v] = (int32_t)pos;
      if (l >= 1) {
        int64_t rank = pos - starts[l];
        if (rank >= NP) return -2;
        slot_of[pos] = (int32_t)rank;
        lv_nodes[(int64_t)(l - 1) * NP + rank] = (int32_t)pos;
        lv_node_valid[(int64_t)(l - 1) * NP + rank] = 1;
      }
    }
  }
  for (int32_t l = 1; l <= lv_real && l <= (int32_t)L; ++l)
    lv_start[l - 1] = (int32_t)starts[l];
  if (e == 0) return 0;
  // renumbered + padded edge arrays, degrees (original edge order)
  for (int64_t i = 0; i < e; ++i) {
    int32_t ns = inv[esrc[i]], nd = inv[edst[i]];
    e_src_out[i] = ns;
    e_dst_out[i] = nd;
    deg_in[nd] += 1.0f;
    deg_out[ns] += 1.0f;
    if (fwd[edst[i]] < 1) return -3;  // edge into a level-0 node: impossible
  }
  // level edge tables, rows ordered by (dst level, SOURCE id, orig idx):
  // two stable counting sorts. Src-sorted rows give the fused kernel tight
  // per-segment source windows (matches the numpy lexsort exactly).
  {
    std::vector<int64_t> o1(e), order(e);
    {
      std::vector<int64_t> scnt(n + 1, 0);
      for (int64_t i = 0; i < e; ++i) scnt[e_src_out[i]]++;
      std::vector<int64_t> cur(n + 1, 0);
      for (int64_t v = 0; v < n; ++v) cur[v + 1] = cur[v] + scnt[v];
      for (int64_t i = 0; i < e; ++i) order[cur[e_src_out[i]]++] = i;
      o1.swap(order);
    }
    {
      std::vector<int64_t> lcnt2(lv_real + 2, 0);
      for (int64_t i = 0; i < e; ++i) lcnt2[fwd[edst[i]]]++;
      std::vector<int64_t> cur(lv_real + 2, 0);
      for (int32_t l = 0; l <= lv_real; ++l) cur[l + 1] = cur[l] + lcnt2[l];
      for (int64_t k = 0; k < e; ++k) {
        int64_t i = o1[k];
        order[cur[fwd[edst[i]]]++] = i;
      }
    }
    std::vector<int64_t> ecur(lv_real + 2, 0);
    for (int64_t k = 0; k < e; ++k) {
      int64_t i = order[k];
      int32_t ns = e_src_out[i], nd = e_dst_out[i];
      int32_t l = fwd[edst[i]];
      int64_t rank = ecur[l]++;
      if (rank >= EP) return -4;
      int64_t row = (int64_t)(l - 1) * EP + rank;
      lv_e_src[row] = ns;
      lv_e_slot[row] = slot_of[nd];
      lv_e_valid[row] = 1;
      lv_e_id[row] = (int32_t)i;
      e_lv_row[i] = (int32_t)row;
    }
  }
  // blocked-CSR tables: stable by (by-node id, edge order). First bucket
  // edges per by-node (counting sort over node ids), then emit in id order.
  // o_eid records WHICH edge fills each slot — the gather-transpose tables
  // (train/losses.py scatters per-edge cotangents back to nodes via these).
  auto blocked = [&](const bool by_dst, int32_t* o_src, int32_t* o_slot,
                     uint8_t* o_valid, int32_t* o_eid, int64_t EB) -> int32_t {
    std::vector<int64_t> ncnt(n + 1, 0);
    for (int64_t i = 0; i < e; ++i)
      ncnt[by_dst ? inv[edst[i]] : inv[esrc[i]]]++;
    std::vector<int64_t> nst(n + 1, 0);
    for (int64_t v = 0; v < n; ++v) nst[v + 1] = nst[v] + ncnt[v];
    std::vector<int64_t> order(e);
    {
      std::vector<int64_t> cur(nst.begin(), nst.end() - 1);
      for (int64_t i = 0; i < e; ++i)
        order[cur[by_dst ? inv[edst[i]] : inv[esrc[i]]]++] = i;
    }
    int64_t prev_blk = -1, rank = 0;
    for (int64_t k = 0; k < e; ++k) {
      int64_t i = order[k];
      int32_t by = by_dst ? inv[edst[i]] : inv[esrc[i]];
      int32_t other = by_dst ? inv[esrc[i]] : inv[edst[i]];
      int64_t blk = by / block;
      if (blk != prev_blk) { prev_blk = blk; rank = 0; }
      if (rank >= EB) return -5;
      int64_t row = blk * EB + rank++;
      o_src[row] = other;
      o_slot[row] = by % (int32_t)block;
      o_valid[row] = 1;
      o_eid[row] = (int32_t)i;
    }
    return 0;
  };
  int32_t r = blocked(true, fa_src, fa_slot, fa_valid, fa_eid, EBF);
  if (r) return r;
  return blocked(false, ra_src, ra_slot, ra_valid, ra_eid, EBR);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Whole-STEP collation: all dp shards of one data-parallel step in a single
// call, written straight into the stacked [dp, ...] buffers — including the
// padding-default initialization and the permuted per-node feature arrays
// that data/batching.py otherwise does per shard in numpy. This removes the
// per-shard Python overhead that dominates host feeding at dp=8 (the device
// step is ~1.6 ms while per-shard python collation costs ~1 ms per shard on
// one core). Shards are independent: with num_threads > 1 they collate on
// std::thread workers (ctypes releases the GIL for the whole call).
//
// Inputs are the step's graphs concatenated in shard order with RAW per-
// graph node ids (no offsets applied); per-graph counts delimit them.
// Semantics per shard mirror collate()'s numpy path exactly
// (tests/test_native.py + tests/test_data.py assert array equality).
// ---------------------------------------------------------------------------

namespace {

struct StepDims {
  int64_t N, E, P, L, NP, EP, EBF, EBR, block;
};

struct StepOut {
  int32_t *perm, *inv, *gate, *fwdl, *graph_id;
  uint8_t* node_valid;
  float* prob;
  int32_t *e_src, *e_dst;
  uint8_t* e_valid;
  int32_t *tt_a, *tt_b;
  uint8_t* tt_valid;
  float* tt_dis;
  int32_t* lv_nodes;
  uint8_t* lv_node_valid;
  int32_t *lv_e_src, *lv_e_slot, *lv_e_id;
  uint8_t* lv_e_valid;
  int32_t* lv_start;
  int32_t *fa_src, *fa_slot;
  uint8_t* fa_valid;
  int32_t *ra_src, *ra_slot;
  uint8_t* ra_valid;
  float *deg_in, *deg_out;
  int32_t *n_nodes, *n_edges, *n_tt;  // [dp] scalars
  int32_t *fa_eid, *ra_eid, *e_lv_row;
};

template <typename T>
static void fill_arr(T* p, int64_t count, T v) {
  for (int64_t i = 0; i < count; ++i) p[i] = v;
}

// Collate ONE shard (graphs [g0, g1) of the step) into the d-th slice of the
// stacked outputs. Returns 0 or a negative error code.
static int32_t collate_one_shard(
    int64_t g0, int64_t g1, const int64_t* graph_nodes,
    const int64_t* graph_edges, const int64_t* graph_tt,
    const int64_t* node_off, const int64_t* edge_off, const int64_t* tt_off,
    const int32_t* gate_all, const int32_t* fwd_all, const float* prob_all,
    const int64_t* esrc_all, const int64_t* edst_all,
    const int64_t* tta_all, const int64_t* ttb_all, const float* ttdis_all,
    const StepDims& dm, const StepOut& o, int64_t d) {
  const int64_t N = dm.N, E = dm.E, P = dm.P, L = dm.L, NP = dm.NP,
                EP = dm.EP, EBF = dm.EBF, EBR = dm.EBR, block = dm.block;
  const int64_t nb = N / block;
  // shard-local views of the stacked outputs
  int32_t* perm = o.perm + d * N;
  int32_t* inv = o.inv + d * N;
  int32_t* gate = o.gate + d * N;
  int32_t* fwdl = o.fwdl + d * N;
  int32_t* graph_id = o.graph_id + d * N;
  uint8_t* node_valid = o.node_valid + d * N;
  float* prob = o.prob + d * N;
  int32_t* e_src = o.e_src + d * E;
  int32_t* e_dst = o.e_dst + d * E;
  uint8_t* e_valid = o.e_valid + d * E;
  int32_t* tt_a = o.tt_a + d * P;
  int32_t* tt_b = o.tt_b + d * P;
  uint8_t* tt_valid = o.tt_valid + d * P;
  float* tt_dis = o.tt_dis + d * P;
  int32_t* lv_nodes = o.lv_nodes + d * L * NP;
  uint8_t* lv_node_valid = o.lv_node_valid + d * L * NP;
  int32_t* lv_e_src = o.lv_e_src + d * L * EP;
  int32_t* lv_e_slot = o.lv_e_slot + d * L * EP;
  uint8_t* lv_e_valid = o.lv_e_valid + d * L * EP;
  int32_t* lv_e_id = o.lv_e_id + d * L * EP;
  int32_t* lv_start = o.lv_start + d * L;
  int32_t* fa_src = o.fa_src + d * nb * EBF;
  int32_t* fa_slot = o.fa_slot + d * nb * EBF;
  uint8_t* fa_valid = o.fa_valid + d * nb * EBF;
  int32_t* ra_src = o.ra_src + d * nb * EBR;
  int32_t* ra_slot = o.ra_slot + d * nb * EBR;
  uint8_t* ra_valid = o.ra_valid + d * nb * EBR;
  int32_t* fa_eid = o.fa_eid + d * nb * EBF;
  int32_t* ra_eid = o.ra_eid + d * nb * EBR;
  int32_t* e_lv_row = o.e_lv_row + d * E;
  float* deg_in = o.deg_in + d * N;
  float* deg_out = o.deg_out + d * N;

  // shard extents
  int64_t n = 0, e = 0, p = 0;
  for (int64_t g = g0; g < g1; ++g) {
    n += graph_nodes[g];
    e += graph_edges[g];
    p += graph_tt[g];
  }
  if (n >= N || e > E || p > P) return -6;
  const int32_t dump = (int32_t)n;
  const int64_t nbase = node_off[g0], tbase = tt_off[g0];
  const int32_t* fwd = fwd_all + nbase;  // shard-local: ids are 0..n-1

  // ---- padding defaults (the caller passes UNINITIALIZED buffers) --------
  fill_arr(lv_nodes, L * NP, dump);
  memset(lv_node_valid, 0, L * NP);
  fill_arr(lv_e_src, L * EP, dump);
  memset(lv_e_slot, 0, L * EP * sizeof(int32_t));
  memset(lv_e_valid, 0, L * EP);
  fill_arr(lv_e_id, L * EP, (int32_t)(E - 1));
  fill_arr(lv_start, L, (int32_t)n);
  fill_arr(fa_src, nb * EBF, dump);
  memset(fa_slot, 0, nb * EBF * sizeof(int32_t));
  memset(fa_valid, 0, nb * EBF);
  fill_arr(ra_src, nb * EBR, dump);
  memset(ra_slot, 0, nb * EBR * sizeof(int32_t));
  memset(ra_valid, 0, nb * EBR);
  fill_arr(fa_eid, nb * EBF, (int32_t)(E - 1));
  fill_arr(ra_eid, nb * EBR, (int32_t)(E - 1));
  memset(e_lv_row, 0, E * sizeof(int32_t));
  memset(deg_in, 0, N * sizeof(float));
  memset(deg_out, 0, N * sizeof(float));
  memset(e_src, 0, E * sizeof(int32_t));
  memset(e_dst, 0, E * sizeof(int32_t));
  for (int64_t v = n; v < N; ++v) perm[v] = inv[v] = (int32_t)v;
  // masks + padded tails of the feature arrays
  memset(node_valid, 1, n);
  memset(node_valid + n, 0, N - n);
  memset(e_valid, 1, e);
  memset(e_valid + e, 0, E - e);
  memset(tt_valid, 1, p);
  memset(tt_valid + p, 0, P - p);
  memset(gate + n, 0, (N - n) * sizeof(int32_t));
  memset(fwdl + n, 0, (N - n) * sizeof(int32_t));
  fill_arr(graph_id + n, N - n, (int32_t)-1);
  memset(prob + n, 0, (N - n) * sizeof(float));
  memset(tt_a + p, 0, (P - p) * sizeof(int32_t));
  memset(tt_b + p, 0, (P - p) * sizeof(int32_t));
  memset(tt_dis + p, 0, (P - p) * sizeof(float));
  o.n_nodes[d] = (int32_t)n;
  o.n_edges[d] = (int32_t)e;
  o.n_tt[d] = (int32_t)p;

  // ---- level-major renumbering (stable counting sort by level) -----------
  int32_t lv_real = 0;
  for (int64_t v = 0; v < n; ++v)
    if (fwd[v] > lv_real) lv_real = fwd[v];
  if (lv_real > L) return -1;
  std::vector<int64_t> lcnt(lv_real + 2, 0);
  for (int64_t v = 0; v < n; ++v) lcnt[fwd[v]]++;
  std::vector<int64_t> starts(lv_real + 2, 0);
  for (int32_t l = 0; l <= lv_real; ++l) starts[l + 1] = starts[l] + lcnt[l];
  std::vector<int32_t> slot_of(n, 0);
  {
    std::vector<int64_t> cur(starts.begin(), starts.end() - 1);
    for (int64_t v = 0; v < n; ++v) {
      int32_t l = fwd[v];
      int64_t pos = cur[l]++;
      perm[pos] = (int32_t)v;
      inv[v] = (int32_t)pos;
      if (l >= 1) {
        int64_t rank = pos - starts[l];
        if (rank >= NP) return -2;
        slot_of[pos] = (int32_t)rank;
        lv_nodes[(int64_t)(l - 1) * NP + rank] = (int32_t)pos;
        lv_node_valid[(int64_t)(l - 1) * NP + rank] = 1;
      }
    }
  }
  for (int32_t l = 1; l <= lv_real && l <= (int32_t)L; ++l)
    lv_start[l - 1] = (int32_t)starts[l];

  // ---- permuted feature arrays + graph ids --------------------------------
  {
    // graph index of every shard-local node id
    std::vector<int32_t> gid(n);
    int64_t at = 0;
    for (int64_t g = g0; g < g1; ++g) {
      for (int64_t k = 0; k < graph_nodes[g]; ++k) gid[at + k] = (int32_t)(g - g0);
      at += graph_nodes[g];
    }
    for (int64_t pos = 0; pos < n; ++pos) {
      int64_t v = perm[pos];  // shard-local original id
      gate[pos] = gate_all[nbase + v];
      fwdl[pos] = fwd[v];
      prob[pos] = prob_all[nbase + v];
      graph_id[pos] = gid[v];
    }
  }

  // ---- tt pairs: per-graph raw ids -> shard-local -> renumbered ----------
  {
    int64_t at = 0, goff = 0;
    for (int64_t g = g0; g < g1; ++g) {
      for (int64_t k = 0; k < graph_tt[g]; ++k) {
        int64_t i = tbase + at + k;
        tt_a[at + k] = inv[tta_all[i] + goff];
        tt_b[at + k] = inv[ttb_all[i] + goff];
        tt_dis[at + k] = ttdis_all[i];
      }
      at += graph_tt[g];
      goff += graph_nodes[g];
    }
  }

  if (e == 0) return 0;

  // ---- edges: offsets applied on the fly, then the fill logic -------------
  std::vector<int32_t> es(e), ed(e);
  {
    int64_t at = 0, goff = 0;
    for (int64_t g = g0; g < g1; ++g) {
      for (int64_t k = 0; k < graph_edges[g]; ++k) {
        es[at + k] = (int32_t)(esrc_all[edge_off[g] + k] + goff);
        ed[at + k] = (int32_t)(edst_all[edge_off[g] + k] + goff);
      }
      at += graph_edges[g];
      goff += graph_nodes[g];
    }
  }
  for (int64_t i = 0; i < e; ++i) {
    int32_t ns = inv[es[i]], nd = inv[ed[i]];
    e_src[i] = ns;
    e_dst[i] = nd;
    deg_in[nd] += 1.0f;
    deg_out[ns] += 1.0f;
    if (fwd[ed[i]] < 1) return -3;
  }
  // level edge tables ordered by (dst level, src id, orig idx) — see
  // mg_collate_fill for rationale; identical two-pass counting sort
  {
    std::vector<int64_t> o1(e), order(e);
    {
      std::vector<int64_t> scnt(n + 1, 0);
      for (int64_t i = 0; i < e; ++i) scnt[e_src[i]]++;
      std::vector<int64_t> cur(n + 1, 0);
      for (int64_t v = 0; v < n; ++v) cur[v + 1] = cur[v] + scnt[v];
      for (int64_t i = 0; i < e; ++i) order[cur[e_src[i]]++] = i;
      o1.swap(order);
    }
    {
      std::vector<int64_t> lcnt2(lv_real + 2, 0);
      for (int64_t i = 0; i < e; ++i) lcnt2[fwd[ed[i]]]++;
      std::vector<int64_t> cur(lv_real + 2, 0);
      for (int32_t l = 0; l <= lv_real; ++l) cur[l + 1] = cur[l] + lcnt2[l];
      for (int64_t k = 0; k < e; ++k) {
        int64_t i = o1[k];
        order[cur[fwd[ed[i]]]++] = i;
      }
    }
    std::vector<int64_t> ecur(lv_real + 2, 0);
    for (int64_t k = 0; k < e; ++k) {
      int64_t i = order[k];
      int32_t l = fwd[ed[i]];
      int64_t rank = ecur[l]++;
      if (rank >= EP) return -4;
      int64_t row = (int64_t)(l - 1) * EP + rank;
      lv_e_src[row] = e_src[i];
      lv_e_slot[row] = slot_of[e_dst[i]];
      lv_e_valid[row] = 1;
      lv_e_id[row] = (int32_t)i;
      e_lv_row[i] = (int32_t)row;
    }
  }
  auto blocked = [&](const bool by_dst, int32_t* o_src, int32_t* o_slot,
                     uint8_t* o_valid, int32_t* o_eid, int64_t EB) -> int32_t {
    std::vector<int64_t> ncnt(n + 1, 0);
    for (int64_t i = 0; i < e; ++i)
      ncnt[by_dst ? inv[ed[i]] : inv[es[i]]]++;
    std::vector<int64_t> nst(n + 1, 0);
    for (int64_t v = 0; v < n; ++v) nst[v + 1] = nst[v] + ncnt[v];
    std::vector<int64_t> order(e);
    {
      std::vector<int64_t> cur(nst.begin(), nst.end() - 1);
      for (int64_t i = 0; i < e; ++i)
        order[cur[by_dst ? inv[ed[i]] : inv[es[i]]]++] = i;
    }
    int64_t prev_blk = -1, rank = 0;
    for (int64_t k = 0; k < e; ++k) {
      int64_t i = order[k];
      int32_t by = by_dst ? inv[ed[i]] : inv[es[i]];
      int32_t other = by_dst ? inv[es[i]] : inv[ed[i]];
      int64_t blk = by / block;
      if (blk != prev_blk) { prev_blk = blk; rank = 0; }
      if (rank >= EB) return -5;
      int64_t row = blk * EB + rank++;
      o_src[row] = other;
      o_slot[row] = by % (int32_t)block;
      o_valid[row] = 1;
      o_eid[row] = (int32_t)i;
    }
    return 0;
  };
  int32_t r = blocked(true, fa_src, fa_slot, fa_valid, fa_eid, EBF);
  if (r) return r;
  return blocked(false, ra_src, ra_slot, ra_valid, ra_eid, EBR);
}

}  // namespace

extern "C" {

// Batched stats: real (pre-bucketing) table extents for MANY graph groups in
// one call — the fixed-dims trainer's epoch pre-scan (it probes every
// (step, shard, chunk) group's dims before collating an epoch; doing that
// per group from Python costs more than the collation itself). Graphs are
// addressed by id into dataset-wide concatenated arrays, so the caller can
// cache those once per dataset and pass only the grouping each epoch.
// stats_out[g*5..g*5+5) = {lv_real, np_real, ep_real, ebf_real, ebr_real}.
int32_t mg_group_stats(
    int64_t n_groups, const int64_t* group_ptr,  // [n_groups+1] into graph_ids
    const int64_t* graph_ids,
    const int64_t* graph_nodes, const int64_t* graph_edges,  // per-graph counts
    const int64_t* node_off, const int64_t* edge_off,        // per-graph offsets
    const int32_t* fwd_all,                                  // concatenated levels
    const int64_t* esrc_all, const int64_t* edst_all,        // RAW per-graph ids
    int64_t block, int64_t num_threads, int64_t* stats_out) {
  auto run = [&](int64_t gi) {
    const int64_t a = group_ptr[gi], b = group_ptr[gi + 1];
    int64_t n = 0, e = 0;
    int32_t lv_real = 0;
    for (int64_t k = a; k < b; ++k) {
      const int64_t g = graph_ids[k];
      const int32_t* fwd = fwd_all + node_off[g];
      for (int64_t v = 0; v < graph_nodes[g]; ++v)
        if (fwd[v] > lv_real) lv_real = fwd[v];
      n += graph_nodes[g];
      e += graph_edges[g];
    }
    // per-level node/edge counts + the group's level-major renumbering
    std::vector<int64_t> lcnt(lv_real + 2, 0), ecnt(lv_real + 2, 0);
    std::vector<int32_t> fwd_loc(n);
    {
      int64_t at = 0;
      for (int64_t k = a; k < b; ++k) {
        const int64_t g = graph_ids[k];
        const int32_t* fwd = fwd_all + node_off[g];
        for (int64_t v = 0; v < graph_nodes[g]; ++v) {
          fwd_loc[at + v] = fwd[v];
          lcnt[fwd[v]]++;
        }
        at += graph_nodes[g];
      }
    }
    std::vector<int64_t> starts(lv_real + 2, 0);
    for (int32_t l = 0; l <= lv_real; ++l) starts[l + 1] = starts[l] + lcnt[l];
    std::vector<int32_t> inv(n);
    {
      std::vector<int64_t> cur(starts.begin(), starts.end() - 1);
      for (int64_t v = 0; v < n; ++v) inv[v] = (int32_t)cur[fwd_loc[v]]++;
    }
    int64_t np_real = 0;
    for (int32_t l = 1; l <= lv_real; ++l)
      if (lcnt[l] > np_real) np_real = lcnt[l];
    const int64_t nb = n / block + 2;
    std::vector<int64_t> bf(nb, 0), br(nb, 0);
    {
      int64_t goff = 0;
      for (int64_t k = a; k < b; ++k) {
        const int64_t g = graph_ids[k];
        const int64_t* es = esrc_all + edge_off[g];
        const int64_t* ed = edst_all + edge_off[g];
        for (int64_t i = 0; i < graph_edges[g]; ++i) {
          const int64_t s = es[i] + goff, d = ed[i] + goff;
          ecnt[fwd_loc[d]]++;
          bf[inv[d] / block]++;
          br[inv[s] / block]++;
        }
        goff += graph_nodes[g];
      }
    }
    int64_t ep_real = 0, ebf = 0, ebr = 0;
    for (int32_t l = 1; l <= lv_real; ++l)
      if (ecnt[l] > ep_real) ep_real = ecnt[l];
    for (int64_t v = 0; v < nb; ++v) {
      if (bf[v] > ebf) ebf = bf[v];
      if (br[v] > ebr) ebr = br[v];
    }
    stats_out[gi * 5 + 0] = lv_real;
    stats_out[gi * 5 + 1] = np_real;
    stats_out[gi * 5 + 2] = ep_real;
    stats_out[gi * 5 + 3] = ebf;
    stats_out[gi * 5 + 4] = ebr;
  };
  if (num_threads <= 1 || n_groups == 1) {
    for (int64_t gi = 0; gi < n_groups; ++gi) run(gi);
  } else {
    int64_t nt = num_threads < n_groups ? num_threads : n_groups;
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int64_t t = 0; t < nt; ++t)
      threads.emplace_back([&, t]() {
        for (int64_t gi = t; gi < n_groups; gi += nt) run(gi);
      });
    for (auto& th : threads) th.join();
  }
  return 0;
}

int32_t mg_collate_step(
    int64_t dp, const int64_t* shard_graphs,  // graphs per shard, [dp]
    const int64_t* graph_nodes, const int64_t* graph_edges,
    const int64_t* graph_tt,  // per-graph counts, [sum(shard_graphs)]
    const int32_t* gate_all, const int32_t* fwd_all, const float* prob_all,
    const int64_t* esrc_all, const int64_t* edst_all,  // RAW per-graph ids
    const int64_t* tta_all, const int64_t* ttb_all, const float* ttdis_all,
    int64_t N, int64_t E, int64_t P, int64_t L, int64_t NP, int64_t EP,
    int64_t EBF, int64_t EBR, int64_t block, int64_t num_threads,
    int32_t* perm, int32_t* inv, int32_t* gate, uint8_t* node_valid,
    int32_t* fwdl, int32_t* graph_id, float* prob,
    int32_t* e_src, int32_t* e_dst, uint8_t* e_valid,
    int32_t* tt_a, int32_t* tt_b, uint8_t* tt_valid, float* tt_dis,
    int32_t* lv_nodes, uint8_t* lv_node_valid,
    int32_t* lv_e_src, int32_t* lv_e_slot, uint8_t* lv_e_valid,
    int32_t* lv_e_id, int32_t* lv_start,
    int32_t* fa_src, int32_t* fa_slot, uint8_t* fa_valid,
    int32_t* ra_src, int32_t* ra_slot, uint8_t* ra_valid,
    float* deg_in, float* deg_out,
    int32_t* n_nodes, int32_t* n_edges, int32_t* n_tt,
    int32_t* fa_eid, int32_t* ra_eid, int32_t* e_lv_row) {
  int64_t total_graphs = 0;
  for (int64_t d = 0; d < dp; ++d) total_graphs += shard_graphs[d];
  // prefix offsets of every graph's node/edge/tt spans
  std::vector<int64_t> node_off(total_graphs + 1, 0), edge_off(total_graphs + 1, 0),
      tt_off(total_graphs + 1, 0);
  for (int64_t g = 0; g < total_graphs; ++g) {
    node_off[g + 1] = node_off[g] + graph_nodes[g];
    edge_off[g + 1] = edge_off[g] + graph_edges[g];
    tt_off[g + 1] = tt_off[g] + graph_tt[g];
  }
  StepDims dm{N, E, P, L, NP, EP, EBF, EBR, block};
  StepOut o{perm, inv, gate, fwdl, graph_id, node_valid, prob,
            e_src, e_dst, e_valid, tt_a, tt_b, tt_valid, tt_dis,
            lv_nodes, lv_node_valid, lv_e_src, lv_e_slot, lv_e_id,
            lv_e_valid, lv_start, fa_src, fa_slot, fa_valid,
            ra_src, ra_slot, ra_valid, deg_in, deg_out,
            n_nodes, n_edges, n_tt, fa_eid, ra_eid, e_lv_row};
  std::vector<int64_t> g_start(dp + 1, 0);
  for (int64_t d = 0; d < dp; ++d) g_start[d + 1] = g_start[d] + shard_graphs[d];
  std::vector<int32_t> rc(dp, 0);
  auto run = [&](int64_t d) {
    rc[d] = collate_one_shard(
        g_start[d], g_start[d + 1], graph_nodes, graph_edges, graph_tt,
        node_off.data(), edge_off.data(), tt_off.data(),
        gate_all, fwd_all, prob_all, esrc_all, edst_all,
        tta_all, ttb_all, ttdis_all, dm, o, d);
  };
  if (num_threads <= 1 || dp == 1) {
    for (int64_t d = 0; d < dp; ++d) run(d);
  } else {
    int64_t nt = num_threads < dp ? num_threads : dp;
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int64_t t = 0; t < nt; ++t)
      threads.emplace_back([&, t]() {
        for (int64_t d = t; d < dp; d += nt) run(d);
      });
    for (auto& th : threads) th.join();
  }
  for (int64_t d = 0; d < dp; ++d)
    if (rc[d]) return rc[d];
  return 0;
}

}  // extern "C"
