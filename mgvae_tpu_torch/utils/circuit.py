"""Circuit-analysis toolkit: logic simulation, COP testability, reconvergence.

Numpy rebuild of the reference's DeepGate-2 label-generation toolkit
(DG_VAE/deepgate/utils/circuit_utils.py). Only the .bench pipeline +
get_fanin_fanout sit on the reference's live path; the rest generates the
prob / tt-distance labels consumed by training.

IMPORTANT — two gate-id conventions coexist in the reference and are kept:
  * toolkit convention (this module's ``logic``/``prob_logic``/``obs_prob``):
    {1: AND, 2: NAND, 3: OR, 4: NOR, 5: NOT, 6: XOR} (circuit_utils.py:23-68)
  * training-data convention: {INPUT:0, MAJ:1, NOT:2, AND:3, OR:4, XOR:5}
    (parser.py:133); simulation for that convention lives in
    data/synthetic.simulate.

Performance note: the reference simulates one random pattern per python
sweep (circuit_utils.py:185-233; 15k patterns default). ``simulator`` here
packs 64 patterns per uint64 word and sweeps vectorized per level —
~3 orders of magnitude fewer python iterations for identical statistics.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

from ..data.levelize import levelize


# ---------------------------------------------------------------------------
# basic structure helpers (circuit_utils.py:919-1005)
# ---------------------------------------------------------------------------

def get_fanin_fanout(num_nodes: int, edge_index: np.ndarray):
    fanin = [[] for _ in range(num_nodes)]
    fanout = [[] for _ in range(num_nodes)]
    for u, v in np.asarray(edge_index).T:
        fanin[int(v)].append(int(u))
        fanout[int(u)].append(int(v))
    return fanin, fanout


def get_level_list(levels: np.ndarray):
    level_list = [[] for _ in range(int(levels.max()) + 1 if len(levels) else 0)]
    for idx, l in enumerate(levels):
        level_list[int(l)].append(idx)
    return level_list


def random_pattern_generator(no_pis: int, rng=None):
    rng = rng or np.random
    return rng.randint(2, size=no_pis) if hasattr(rng, "randint") else rng.integers(0, 2, no_pis)


# ---------------------------------------------------------------------------
# scalar logic (toolkit convention) — circuit_utils.py:23-68
# ---------------------------------------------------------------------------

def logic(gate_type: int, signals):
    if gate_type == 1:  # AND
        return int(all(s == 1 for s in signals))
    if gate_type == 2:  # NAND
        return int(any(s == 0 for s in signals))
    if gate_type == 3:  # OR
        return int(any(s == 1 for s in signals))
    if gate_type == 4:  # NOR
        return int(not any(s == 1 for s in signals))
    if gate_type == 5:  # NOT
        return 1 - signals[0]
    if gate_type == 6:  # XOR (the reference's: 0 iff all-equal)
        z = sum(1 for s in signals if s == 0)
        o = sum(1 for s in signals if s == 1)
        return 0 if z == len(signals) or o == len(signals) else 1
    raise ValueError(f"unsupported gate type {gate_type}")


_FULL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _word_logic(gate_type: int, vals):
    if gate_type == 1:
        r = _FULL
        for v in vals:
            r &= v
        return r
    if gate_type == 2:
        r = _FULL
        for v in vals:
            r &= v
        return r ^ _FULL
    if gate_type == 3:
        r = np.uint64(0)
        for v in vals:
            r |= v
        return r
    if gate_type == 4:
        r = np.uint64(0)
        for v in vals:
            r |= v
        return r ^ _FULL
    if gate_type == 5:
        return vals[0] ^ _FULL
    if gate_type == 6:
        allm1 = _FULL
        allm0 = _FULL
        for v in vals:
            allm1 &= v
            allm0 &= v ^ _FULL
        return (allm1 | allm0) ^ _FULL
    raise ValueError(f"unsupported gate type {gate_type}")


def simulator(x_data, PI_indexes, level_list, fanin_list, num_patterns, seed=None):
    """1-probability per node from random-pattern simulation
    (circuit_utils.py:185-233 semantics; bit-parallel implementation).

    Returns list of [prob] like the reference (PIs forced to 0.5)."""
    rng = np.random.default_rng(seed)
    n = len(x_data)
    no_patterns = min(num_patterns, 10 * (1 << min(len(PI_indexes), 40)))
    words = max(1, (no_patterns + 63) // 64)
    ones = np.zeros(n, dtype=np.int64)
    total = words * 64
    sig = np.zeros(n, dtype=np.uint64)
    from ..data.synthetic import popcount64

    for _ in range(words):
        for i in PI_indexes:
            sig[i] = rng.integers(0, 1 << 63, dtype=np.uint64) | (
                rng.integers(0, 2, dtype=np.uint64) << np.uint64(63)
            )
        for level in range(1, len(level_list)):
            for idx in level_list[level]:
                fi = fanin_list[idx]
                if fi:
                    sig[idx] = _word_logic(int(x_data[idx][1]), [sig[p] for p in fi])
        ones += popcount64(sig)
    y1 = [[ones[i] / total] for i in range(n)]
    for i in PI_indexes:
        y1[i] = [0.5]
    return y1


# ---------------------------------------------------------------------------
# COP testability (circuit_utils.py:71-183, 555-623)
# ---------------------------------------------------------------------------

def prob_logic(gate_type, signals):
    """(C0, C1) of a node given fan-in [(C0, C1)] pairs (circuit_utils.py:71)."""
    if gate_type == 1:  # AND
        m = float(np.prod([s[1] for s in signals]))
        return 1.0 - m, m
    if gate_type == 2:  # NAND
        m = float(np.prod([s[1] for s in signals]))
        return m, 1.0 - m
    if gate_type == 3:  # OR
        m = float(np.prod([s[0] for s in signals]))
        return m, 1.0 - m
    if gate_type == 4:  # NOR
        m = float(np.prod([s[0] for s in signals]))
        return 1.0 - m, m
    if gate_type == 5:  # NOT
        return signals[0][1], signals[0][0]
    if gate_type == 6:  # XOR (reference's formula, circuit_utils.py:118-128)
        m0 = float(np.prod([s[0] for s in signals]))
        m1 = float(np.prod([s[1] for s in signals]))
        zero = m0 + m1
        return zero, 1.0 - zero
    raise ValueError(f"unsupported gate type {gate_type}")


def generate_prob_cont(x_data, PI_indexes, level_list, fanin_list):
    """Appends C1 then C0 columns to x_data (circuit_utils.py:555-587)."""
    y = [0] * len(x_data)
    for i in PI_indexes:
        y[i] = [0.5, 0.5]
    for level in range(1, len(level_list)):
        for idx in level_list[level]:
            sigs = [y[p] for p in fanin_list[idx]]
            if sigs:
                zero, one = prob_logic(x_data[idx][1], sigs)
                y[idx] = [zero, one]
    for i, prob in enumerate(y):
        x_data[i].append(prob[1])
        x_data[i].append(prob[0])
    return x_data


def obs_prob(x, r, y, input_signals):
    """Backward observability update (circuit_utils.py:134-181 verbatim
    semantics, incl. its 2-input XOR restriction)."""
    g = x[r][1]
    if g in (1, 2):  # AND/NAND: obs *= C1 of the other inputs
        for s in input_signals:
            obs = y[r]
            for s1 in input_signals:
                if s != s1:
                    obs = obs * x[s1][3]
            if obs < y[s] or y[s] == -1:
                y[s] = obs
    elif g in (3, 4):  # OR/NOR: obs *= C0 of the other inputs
        for s in input_signals:
            obs = y[r]
            for s1 in input_signals:
                if s != s1:
                    obs = obs * x[s1][4]
            if obs < y[s] or y[s] == -1:
                y[s] = obs
    elif g == 5:  # NOT
        obs = y[r]
        for s in input_signals:
            if obs < y[s] or y[s] == -1:
                y[s] = obs
    elif g == 6:  # XOR
        if len(input_signals) != 2:
            raise ValueError("Not support non 2-input XOR Gate")
        a, b = input_signals
        y[a] = y[r] * max(x[b][3], x[b][4])
        y[b] = y[r] * max(x[a][3], x[a][4])
    return y


def generate_prob_obs(x_data, level_list, fanin_list, fanout_list):
    """Appends CO column (circuit_utils.py:590-623)."""
    y = [-1] * len(x_data)
    for idx, nxt in enumerate(fanout_list):
        if len(nxt) == 0:
            y[idx] = 1
    for level in range(len(level_list) - 1, -1, -1):
        for idx in level_list[level]:
            if fanin_list[idx]:
                y = obs_prob(x_data, idx, y, fanin_list[idx])
    for i, val in enumerate(y):
        x_data[i].append(val)
    return x_data


# ---------------------------------------------------------------------------
# reconvergence (circuit_utils.py:637-726)
# ---------------------------------------------------------------------------

def identify_reconvergence(x_data, level_list, fanin_list, fanout_list):
    """Appends [is_multi_fanout, is_rc, rc_source_idx] columns; returns
    (x_data, rc_list). Algorithm: propagate per-node fanout-source sets level
    by level; a node whose merged set contains a duplicate is reconvergent,
    sourced at the deepest duplicated node."""
    n = len(x_data)
    for idx in range(n):
        x_data[idx].append(1 if len(fanout_list[idx]) > 1 else 0)
    FOL = [[] for _ in range(n)]
    fanout_num = [len(fanout_list[i]) for i in range(n)]
    rc_lst = []
    max_level = len(level_list) - 1
    for level in range(max_level + 1):
        for idx in level_list[level]:
            if level == 0:
                x_data[idx].append(0)
                x_data[idx].append(-1)
                if x_data[idx][-3]:
                    FOL[idx].append(idx)
                continue
            FOL_tmp = []
            for pre in fanin_list[idx]:
                FOL_tmp += FOL[pre]
                fanout_num[pre] -= 1
                if fanout_num[pre] == 0:
                    FOL[pre] = []
            cnt = Counter(FOL_tmp)
            src_idx, src_level, is_rc = 0, -1, False
            for d, c in cnt.items():
                if c > 1:
                    is_rc = True
                    if x_data[d][2] > src_level:
                        src_level = x_data[d][2]
                        src_idx = d
            if is_rc:
                x_data[idx].append(1)
                x_data[idx].append(src_idx)
                rc_lst.append(idx)
            else:
                x_data[idx].append(0)
                x_data[idx].append(-1)
            FOL[idx] = list(cnt.keys())
            if x_data[idx][-3]:
                FOL[idx].append(idx)
    return x_data, rc_lst


# ---------------------------------------------------------------------------
# AIG simulation in the training convention (circuit_utils.py:840-917)
# ---------------------------------------------------------------------------

def aig_simulation(gate: np.ndarray, edge_index: np.ndarray, num_patterns: int = 15000, seed=None):
    """1-probability per node for AIG convention {PI:0, AND:1, NOT:2};
    bit-parallel."""
    rng = np.random.default_rng(seed)
    n = len(gate)
    fanin, fanout = get_fanin_fanout(n, edge_index)
    levels = levelize(np.asarray(edge_index), n)
    level_list = get_level_list(levels)
    pis = [i for i in range(n) if not fanin[i]]
    words = max(1, (num_patterns + 63) // 64)
    from ..data.synthetic import popcount64

    ones = np.zeros(n, dtype=np.int64)
    sig = np.zeros(n, dtype=np.uint64)
    for _ in range(words):
        for i in pis:
            sig[i] = rng.integers(0, 1 << 63, dtype=np.uint64) | (
                rng.integers(0, 2, dtype=np.uint64) << np.uint64(63)
            )
        for level in range(1, len(level_list)):
            for idx in level_list[level]:
                vals = [sig[p] for p in fanin[idx]]
                if int(gate[idx]) == 1:
                    r = _FULL
                    for v in vals:
                        r &= v
                    sig[idx] = r
                elif int(gate[idx]) == 2:
                    sig[idx] = vals[0] ^ _FULL
        ones += popcount64(sig)
    return ones / (words * 64.0)


# ---------------------------------------------------------------------------
# graph-level helpers (utils/utils.py:59-147 equivalents)
# ---------------------------------------------------------------------------

def simulate_graph(graph, pattern=None, seed=None):
    """pyg_simulation equivalent on a CircuitGraph using the TRAINING gate
    convention of its modality; returns (po_value, pattern)."""
    from ..data.synthetic import simulate

    rng = np.random.default_rng(seed)
    modality = "aig" if set(np.unique(graph.gate)) <= {0, 1, 2} else "mig"
    sig = simulate(graph.gate, graph.edge_index, rng, modality)
    pos = graph.POs
    return sig[pos], None


def get_function_acc(graph, node_emb, samples: int = 100, min_gap: float = 0.05, seed=0):
    """Pairwise-ranking accuracy of functional embeddings
    (utils/utils.py:111-147): sample pairs of labeled tt pairs, check that
    cosine-distance ordering matches truth-table-distance ordering."""
    rng = np.random.default_rng(seed)
    node_emb = np.asarray(node_emb)
    p = graph.tt_pair_index.shape[1]
    if p < 2:
        return -1
    correct, total, retry = 0, 0, 10000
    tri = 0
    while tri < samples and retry > 0:
        retry -= 1
        i, j = rng.choice(p, 2, replace=False)
        gt_i, gt_j = graph.tt_dis[i], graph.tt_dis[j]
        if gt_i == gt_j or abs(gt_i - gt_j) < min_gap:
            continue
        total += 1
        tri += 1

        def dis(k):
            a = node_emb[graph.tt_pair_index[0][k]]
            b = node_emb[graph.tt_pair_index[1][k]]
            na = max(np.linalg.norm(a), 1e-8)
            nb = max(np.linalg.norm(b), 1e-8)
            return 1.0 - float(a @ b / (na * nb))

        d_i, d_j = dis(i), dis(j)
        if (gt_i > gt_j) == (d_i > d_j):
            correct += 1
    return correct / total if total else -1


def backward_search(node_idx, fanin_list, x_data, min_level):
    """Transitive fan-in cone down to min_level (circuit_utils.py:728-741)."""
    if x_data[node_idx][2] <= min_level:
        return []
    result = set()
    stack = [node_idx]
    while stack:
        cur = stack.pop()
        for pre in fanin_list[cur]:
            if x_data[pre][2] > min_level and pre not in result:
                result.add(pre)
                stack.append(pre)
    return sorted(result)


def extract_subcircuit(graph, roots, max_depth: int | None = None):
    """Extract the transitive fan-in cone of ``roots`` as a new CircuitGraph
    (the generate_sub_circuit / circuit_extraction capability,
    circuit_utils.py:396-552, reformulated on CircuitGraph)."""
    from ..data.graph import build_graph

    n = graph.num_nodes
    fanin, _ = get_fanin_fanout(n, graph.edge_index)
    keep = set()
    frontier = [(int(r), 0) for r in roots]
    while frontier:
        v, d = frontier.pop()
        if v in keep:
            continue
        keep.add(v)
        if max_depth is None or d < max_depth:
            frontier.extend((u, d + 1) for u in fanin[v])
    keep_sorted = sorted(keep)
    remap = {v: i for i, v in enumerate(keep_sorted)}
    gate = graph.gate[keep_sorted]
    # cut fan-ins outside the cone become PIs
    edges = [
        (remap[u], remap[v])
        for u, v in graph.edge_index.T
        if int(u) in keep and int(v) in keep
    ]
    sub_fanin_cnt = np.zeros(len(keep_sorted), np.int64)
    for _, v in edges:
        sub_fanin_cnt[v] += 1
    gate = gate.copy()
    gate[sub_fanin_cnt == 0] = 0  # INPUT
    edge_index = (
        np.asarray(edges, dtype=np.int64).T if edges else np.zeros((2, 0), np.int64)
    )
    return build_graph(f"{graph.name}_sub", gate, edge_index), keep_sorted


def check_reconvergence(graph):
    """Validate rc annotations by path counting (circuit_utils.py:743-764
    capability): returns node indices reachable from >1 parallel path."""
    n = graph.num_nodes
    fanin, _ = get_fanin_fanout(n, graph.edge_index)
    levels = graph.forward_level
    order = np.argsort(levels, kind="stable")
    rc = []
    for v in order:
        srcs = set()
        dup = False
        stack = list(fanin[v])
        # count distinct multi-fanout ancestors reached via >1 immediate fanin
        seen_per_branch = [set() for _ in fanin[v]]
        for bi, u in enumerate(fanin[v]):
            st = [u]
            while st:
                x = st.pop()
                if x in seen_per_branch[bi]:
                    continue
                seen_per_branch[bi].add(x)
                st.extend(fanin[x])
        for i in range(len(seen_per_branch)):
            for j in range(i + 1, len(seen_per_branch)):
                if seen_per_branch[i] & seen_per_branch[j]:
                    dup = True
        del srcs, stack
        if dup:
            rc.append(int(v))
    return rc


def circuit_statistics(graph):
    """Summary stats (circuit_utils.py:769-817 capability)."""
    n = graph.num_nodes
    _, fanout = get_fanin_fanout(n, graph.edge_index)
    counts = {int(g): int(c) for g, c in zip(*np.unique(graph.gate, return_counts=True))}
    return {
        "name": graph.name,
        "num_nodes": n,
        "num_edges": graph.num_edges,
        "num_levels": graph.num_levels,
        "num_pis": int(len(graph.PIs)),
        "num_pos": int(len(graph.POs)),
        "gate_counts": counts,
        "max_fanout": max((len(f) for f in fanout), default=0),
    }


def generate_orthogonal_vectors(n: int, dim: int, seed=None):
    """Random (approximately) orthogonal unit vectors (utils/utils.py:149+).
    Uses QR on gaussian blocks instead of the reference's rejection loop."""
    rng = np.random.default_rng(seed)
    vecs = []
    remaining = n
    while remaining > 0:
        block = rng.normal(size=(dim, min(dim, remaining)))
        q, _ = np.linalg.qr(block)
        vecs.append(q.T[:remaining])
        remaining -= q.shape[1]
    return np.concatenate(vecs, axis=0)[:n]


def generate_hs_init(num_pis: int, dim_hidden: int, seed=None):
    """Legacy orthogonal PI initialization (utils/utils.py:182-206)."""
    return generate_orthogonal_vectors(num_pis, dim_hidden, seed).astype(np.float32)


# ---------------------------------------------------------------------------
# dead-path tail of the reference toolkit (circuit_utils.py:299-381 /
# 625-634 / 819-837): the modified-.bench feature pipeline, the
# reconvergent-cone DFS, and the dataset C1-vs-GT diagnostic. None of these
# sit on the reference's live path; ported for inventory completeness with
# the reference's crashes fixed (recursion-depth blowup, list-aliasing in
# the DFS, torch-only dataset assumption).
# ---------------------------------------------------------------------------

_BENCH_GATE_NAMES = ("NAND", "NOR", "AND", "OR", "NOT", "XOR")


def feature_generation(lines, gate_to_index):
    """Modified-.bench (``idx: name = GATE(a, b)``) pre-processing
    (circuit_utils.py:299-381): returns (x_data [[name, gate_idx, level]],
    edge_index [[src, dst] pairs], level_list, fanin_list, fanout_list).
    Levelization delegates to data/levelize (O(V+E) Kahn) instead of the
    reference's repeated-relaxation BFS — identical longest-path levels.
    Gate keywords match on ``GATE(`` exactly (the reference's 13-10-2021
    bugfix: a net named MEMORY must not match OR)."""
    import re

    gate_re = re.compile(r"=\s*(%s)\s*\(" % "|".join(_BENCH_GATE_NAMES))
    name2idx, x_data, gate_lines = {}, [], []
    for line in lines:
        if "INPUT(" in line:
            name = line.split("(")[-1].split(")")[0].strip()
            name2idx[name] = len(x_data)
            x_data.append([name, gate_to_index["INPUT"]])
            continue
        m = gate_re.search(line)
        if m is not None:
            name = line.split(":")[-1].split("=")[0].strip()
            srcs = [s.strip() for s in line.split("(")[-1].split(")")[0].split(",")]
            name2idx[name] = len(x_data)
            x_data.append([name, gate_to_index[m.group(1)]])
            gate_lines.append((name, srcs))
    edge_index = []
    for name, srcs in gate_lines:
        dst = name2idx[name]
        edge_index.extend([name2idx[s], dst] for s in srcs)
    n = len(x_data)
    ei = np.asarray(edge_index, dtype=np.int64).reshape(-1, 2).T
    levels = levelize(ei, n)
    for idx in range(n):
        x_data[idx].append(int(levels[idx]))
    level_list = get_level_list(levels)
    fanin_list, fanout_list = get_fanin_fanout(n, ei)
    return x_data, edge_index, level_list, fanin_list, fanout_list


def dfs_reconvergent_circuit(node_idx, dst_idx, fanout_list, x_data):
    """All nodes lying on a directed path from ``node_idx`` to the
    reconvergence point ``dst_idx`` through nodes at level <= level(dst)
    (circuit_utils.py:625-634 capability). Iterative two-pass
    reachability (forward from src x backward from dst) instead of the
    reference's exponential path-enumerating recursion, whose
    ``vis = vis[:-1]`` rebinding also corrupts sibling branches; includes
    dst, excludes src, like the reference's intent."""
    n = len(x_data)
    dst_level = x_data[dst_idx][2]
    fwd = np.zeros(n, dtype=bool)
    stack = [node_idx]
    while stack:
        u = stack.pop()
        for v in fanout_list[u]:
            if not fwd[v] and x_data[v][2] <= dst_level:
                fwd[v] = True
                stack.append(v)
    # backward from dst over the forward-reachable subgraph
    parents = [[] for _ in range(n)]
    for u in range(n):
        if fwd[u] or u == node_idx:
            for v in fanout_list[u]:
                if fwd[v]:
                    parents[v].append(u)
    keep = np.zeros(n, dtype=bool)
    if not fwd[dst_idx]:
        return []
    keep[dst_idx] = True
    stack = [dst_idx]
    while stack:
        v = stack.pop()
        for u in parents[v]:
            if not keep[u] and u != node_idx:
                keep[u] = True
                stack.append(u)
    return [int(i) for i in np.flatnonzero(keep)]


def check_difference(dataset, c1="c1", gt="gt", rec="rec"):
    """Dataset diagnostic (circuit_utils.py:819-837): mean |C1 - GT| overall
    and split by reconvergent / non-reconvergent nodes. Attribute names are
    parameterized (the legacy npz pipeline stores GT as ``prob``); arrays
    may be numpy or torch. Returns the three means and prints the
    reference's three lines."""
    sums = np.zeros(3)
    tots = np.zeros(3)
    for g in dataset:
        d = np.abs(np.asarray(getattr(g, c1), dtype=np.float64).reshape(-1)
                   - np.asarray(getattr(g, gt), dtype=np.float64).reshape(-1))
        r = np.asarray(getattr(g, rec), dtype=np.float64).reshape(-1)
        sums += (d.sum(), (d * r).sum(), (d * (1 - r)).sum())
        tots += (d.size, r.sum(), (1 - r).sum())
    means = tuple(float(s / t) if t else float("nan") for s, t in zip(sums, tots))
    print("Average difference between C1 and GT is: ", means[0])
    print("Average difference between C1 and GT (reconvergent nodes) is: ", means[1])
    print("Average difference between C1 and GT (non-reconvergent nodes) is: ", means[2])
    return means
