"""Synthetic circuit generation with simulated labels.

Copy of ``random_circuit`` and ``layered_circuit`` from
``mgvae_tpu/data/synthetic.py``: the same ``np.random.Generator`` gives the
same circuits in both packages. Labels
come from a 64-pattern bit-parallel logic simulation over uint64 words.

Gate arities: NOT=1 input, AND/OR/XOR=2, MAJ=3.
"""
from __future__ import annotations

import numpy as np

from .graph import MODALITY_GATES, CircuitGraph, build_graph
from .levelize import levelize

_ARITY = {1: 3, 2: 1, 3: 2, 4: 2, 5: 2}  # MAJ NOT AND OR XOR (non-AIG ids)
_ARITY_AIG = {1: 2, 2: 1}  # AND NOT (AIG ids)


def random_circuit(
    rng: np.random.Generator,
    modality: str = "mig",
    num_inputs: int = 8,
    num_gates: int = 56,
    num_tt_pairs: int = 32,
    name: str = "synthetic",
) -> CircuitGraph:
    gates_avail = list(MODALITY_GATES[modality])
    arity = _ARITY_AIG if modality == "aig" else _ARITY
    n = num_inputs + num_gates
    gate = np.zeros(n, dtype=np.int32)
    src_list, dst_list = [], []
    for v in range(num_inputs, n):
        g = gates_avail[rng.integers(len(gates_avail))]
        gate[v] = g
        k = arity[g]
        # biased toward recent nodes for realistic depth
        lo = max(0, v - 24)
        fanins = rng.choice(np.arange(lo, v), size=min(k, v - lo), replace=False)
        for u in fanins:
            src_list.append(u)
            dst_list.append(v)
    edge_index = np.array([src_list, dst_list], dtype=np.int64)

    sig = simulate(gate, edge_index, rng, modality)
    prob = popcount64(sig) / 64.0

    # sample labeled pairs among non-PI nodes
    pool = np.arange(num_inputs, n)
    a = rng.choice(pool, size=num_tt_pairs)
    b = rng.choice(pool, size=num_tt_pairs)
    tt_dis = popcount64(sig[a] ^ sig[b]) / 64.0
    tt_pair_index = np.stack([a, b]).astype(np.int64)
    return build_graph(name, gate, edge_index, prob, tt_pair_index, tt_dis.astype(np.float32))


def layered_circuit(
    rng: np.random.Generator,
    modality: str = "mig",
    width: int = 512,
    depth: int = 200,
    num_inputs: int | None = None,
    num_tt_pairs: int = 256,
    name: str = "layered",
) -> CircuitGraph:
    """Deep circuit with bounded level width: ``depth`` layers of exactly
    ``width`` gates, each drawing its fanins from the two preceding layers.
    Total nodes = width * depth + inputs; every level holds ``width`` nodes,
    so the level tables' Np / Ep are set by ``width`` alone."""
    num_inputs = width if num_inputs is None else num_inputs
    gates_avail = list(MODALITY_GATES[modality])
    arity = _ARITY_AIG if modality == "aig" else _ARITY
    n = num_inputs + width * depth
    gate = np.zeros(n, dtype=np.int32)
    src_list, dst_list = [], []
    prev2 = np.arange(num_inputs)  # candidate fanins: the previous two layers
    prev1 = np.arange(num_inputs)
    base = num_inputs
    for _ in range(depth):
        ids = np.arange(base, base + width)
        g = np.asarray(gates_avail)[rng.integers(len(gates_avail), size=width)]
        gate[ids] = g
        pool = np.unique(np.concatenate([prev1, prev2]))
        for v, gv in zip(ids, g):
            k = min(arity[int(gv)], len(pool))
            fanins = rng.choice(pool, size=k, replace=False)
            # at least one fanin from the layer just before keeps the
            # circuit exactly ``depth`` levels deep
            if fanins.max() < prev1.min():
                fanins[0] = prev1[rng.integers(len(prev1))]
            src_list.extend(fanins.tolist())
            dst_list.extend([v] * k)
        prev2, prev1 = prev1, ids
        base += width
    edge_index = np.array([src_list, dst_list], dtype=np.int64)
    sig = simulate(gate, edge_index, rng, modality)
    prob = popcount64(sig) / 64.0
    pool = np.arange(num_inputs, n)
    a = rng.choice(pool, size=num_tt_pairs)
    b = rng.choice(pool, size=num_tt_pairs)
    tt_dis = popcount64(sig[a] ^ sig[b]) / 64.0
    tt_pair_index = np.stack([a, b]).astype(np.int64)
    return build_graph(name, gate, edge_index, prob, tt_pair_index, tt_dis.astype(np.float32))


def simulate(gate, edge_index, rng, modality="mig") -> np.ndarray:
    """64-pattern bit-parallel logic simulation; returns uint64 signature/node."""
    n = len(gate)
    sig = np.zeros(n, dtype=np.uint64)
    fanins = [[] for _ in range(n)]
    for u, v in edge_index.T:
        fanins[v].append(u)
    level = levelize(edge_index, n)
    order = np.argsort(level, kind="stable")
    if modality == "aig":
        AND_IDS, OR_IDS, XOR_IDS, NOT_IDS, MAJ_IDS = {1}, set(), set(), {2}, set()
    else:
        AND_IDS, OR_IDS, XOR_IDS, NOT_IDS, MAJ_IDS = {3}, {4}, {5}, {2}, {1}
    full = np.uint64(0xFFFFFFFFFFFFFFFF)
    for v in order:
        fi = fanins[v]
        if not fi:
            sig[v] = rng.integers(0, 1 << 63, dtype=np.uint64) | (
                rng.integers(0, 2, dtype=np.uint64) << np.uint64(63)
            )
            continue
        g = int(gate[v])
        vals = [sig[u] for u in fi]
        if g in NOT_IDS:
            sig[v] = vals[0] ^ full
        elif g in AND_IDS:
            r = full
            for x in vals:
                r &= x
            sig[v] = r
        elif g in OR_IDS:
            r = np.uint64(0)
            for x in vals:
                r |= x
            sig[v] = r
        elif g in XOR_IDS:
            r = np.uint64(0)
            for x in vals:
                r ^= x
            sig[v] = r
        elif g in MAJ_IDS:
            a_, b_, c_ = (vals + vals)[:3]
            sig[v] = (a_ & b_) | (a_ & c_) | (b_ & c_)
        else:
            sig[v] = vals[0]
    return sig


def popcount64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    cnt = np.zeros(x.shape, dtype=np.int64)
    for shift in range(0, 64, 8):
        byte = (x >> np.uint64(shift)) & np.uint64(0xFF)
        cnt += _POP8[byte.astype(np.int64)]
    return cnt


_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)
