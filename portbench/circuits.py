"""Synthetic logic circuits made from a seed, vectorised over circuits and
gates: the benchmark's own generator.

It draws the families of the port's ``data/synthetic.py`` (``random_circuit``
and ``layered_circuit``) with whole-array numpy calls instead of a Python
loop per gate, so a pool of hundreds of circuits, or a 100k-node layered
circuit, takes well under a second. The draws are not the port's, only
their distributions:

  * random: ``num_inputs`` primary inputs, then ``num_gates`` gates whose
    type is uniform over the modality's gates and whose fanins are distinct
    nodes among the 24 before it;
  * layered: ``depth`` layers of ``width`` gates, each gate's fanins
    distinct nodes of the two layers before it, at least one of them in the
    layer just before, so that layer l lies at level l + 1.

Labels come from a 64-pattern bit-parallel simulation: ``prob`` is a
node's share of ones, ``tt_dis`` the share of differing bits of
``num_tt_pairs`` gate pairs drawn uniformly among the gates.

Gate ids: {INPUT: 0, MAJ: 1, NOT: 2, AND: 3, OR: 4, XOR: 5}; AIG {INPUT: 0,
AND: 1, NOT: 2}.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# the gate ids each modality uses, in expert order (expert t takes gate
# GATES[modality][t])
GATES = {
    "aig": (1, 2),
    "mig": (2, 3, 4, 1),
    "xag": (3, 2, 5),
    "xmg": (3, 2, 5, 1, 4),
}
ARITY = {1: 3, 2: 1, 3: 2, 4: 2, 5: 2}
ARITY_AIG = {1: 2, 2: 1}
WINDOW = 24          # a random circuit's fanins lie among the 24 nodes before the gate
MAX_ARITY = 3
_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


@dataclasses.dataclass
class Circuit:
    """One circuit as plain arrays: gate ids [n], edges [2, e] (src, dst),
    signal probabilities [n], truth-table pairs [2, p] and their distances
    [p]."""
    gate: np.ndarray
    edge_index: np.ndarray
    prob: np.ndarray
    tt_pair_index: np.ndarray
    tt_dis: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.gate.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])


def popcount(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.uint64)
    return _POP8[x.view(np.uint8)].reshape(x.shape + (8,)).sum(-1)


def _arity_table(modality: str) -> np.ndarray:
    table = np.zeros(6, np.int64)
    for g, k in (ARITY_AIG if modality == "aig" else ARITY).items():
        table[g] = k
    return table


def _distinct(rng, w: np.ndarray, k: int) -> np.ndarray:
    """k distinct offsets in [0, w) per row of ``w`` (ordered, uniform over
    ordered k-tuples; rows with w < k repeat nothing past w): [..., k]."""
    w = np.asarray(w, np.int64)
    out = np.zeros(w.shape + (k,), np.int64)
    for j in range(k):
        x = np.floor(rng.random(w.shape) * np.maximum(w - j, 1)).astype(np.int64)
        # shift the draw past each offset taken so far, smallest first
        for t in np.moveaxis(np.sort(out[..., :j], axis=-1), -1, 0):
            x = x + (x >= t)
        out[..., j] = x
    return out


def _simulate_step(gate, a, b, c, mod_aig: bool):
    """Signatures of gates with fanin signatures a, b, c (c: only MAJ)."""
    full = np.uint64(0xFFFFFFFFFFFFFFFF)
    if mod_aig:
        return np.where(gate == 1, a & b, a ^ full)
    return np.select(
        [gate == 2, gate == 3, gate == 4, gate == 5, gate == 1],
        [a ^ full, a & b, a | b, a ^ b, (a & b) | (a & c) | (b & c)], a)


def _labels(rng, sig: np.ndarray, first_gate: int, num_pairs: int):
    """(prob, pairs [2, p], tt_dis) of one circuit's signatures."""
    n = sig.shape[0]
    prob = (popcount(sig) / 64.0).astype(np.float32)
    a = rng.integers(first_gate, n, size=num_pairs)
    b = rng.integers(first_gate, n, size=num_pairs)
    tt = (popcount(sig[a] ^ sig[b]) / 64.0).astype(np.float32)
    return prob, np.stack([a, b]).astype(np.int64), tt


def random_circuits(rng, modality: str, count: int, num_inputs: int, num_gates: int,
                    num_tt_pairs: int) -> list[Circuit]:
    """``count`` random circuits of one size (the family of the port's
    ``random_circuit``)."""
    gates = np.asarray(GATES[modality])
    arity = _arity_table(modality)
    n = num_inputs + num_gates
    v = np.arange(num_inputs, n)
    lo = np.maximum(0, v - WINDOW)
    gate = np.zeros((count, n), np.int32)
    gate[:, num_inputs:] = gates[rng.integers(len(gates), size=(count, num_gates))]
    k = arity[gate[:, num_inputs:]]                                  # [C, G]
    k = np.minimum(k, (v - lo)[None, :])
    off = _distinct(rng, np.broadcast_to(v - lo, (count, num_gates)), MAX_ARITY)
    fanin = lo[None, :, None] + off                                  # [C, G, 3]
    sig = np.zeros((count, n), np.uint64)
    sig[:, :num_inputs] = rng.integers(0, 2**64, size=(count, num_inputs), dtype=np.uint64,
                                       endpoint=False)
    rows = np.arange(count)
    for j in range(num_gates):
        f = fanin[:, j]
        s = [sig[rows, f[:, t]] for t in range(MAX_ARITY)]
        sig[:, num_inputs + j] = _simulate_step(gate[:, num_inputs + j], *s, modality == "aig")
    out = []
    slot = np.arange(MAX_ARITY)[None, :]
    for c in range(count):
        used = slot < k[c][:, None]                                  # [G, 3]
        src = fanin[c][used]
        dst = np.broadcast_to(v[:, None], used.shape)[used]
        prob, pairs, tt = _labels(rng, sig[c], num_inputs, num_tt_pairs)
        out.append(Circuit(gate[c], np.stack([src, dst]).astype(np.int64), prob, pairs, tt))
    return out


def layered_circuit(rng, modality: str, width: int, depth: int, num_tt_pairs: int,
                    num_inputs: int | None = None) -> Circuit:
    """``depth`` layers of ``width`` gates over ``num_inputs`` (default
    ``width``) primary inputs (the family of the port's
    ``layered_circuit``)."""
    num_inputs = width if num_inputs is None else num_inputs
    gates = np.asarray(GATES[modality])
    arity = _arity_table(modality)
    n = num_inputs + width * depth
    gate = np.zeros(n, np.int32)
    sig = np.zeros(n, np.uint64)
    sig[:num_inputs] = rng.integers(0, 2**64, size=num_inputs, dtype=np.uint64)
    srcs, dsts = [], []
    p1 = (0, num_inputs)                  # the layer just before: [start, end)
    pool_lo = 0                           # the two layers before start here
    base = num_inputs
    for _ in range(depth):
        ids = np.arange(base, base + width)
        g = gates[rng.integers(len(gates), size=width)]
        gate[ids] = g
        w = p1[1] - pool_lo
        k = np.minimum(arity[g], w)
        fanin = pool_lo + _distinct(rng, np.full(width, w), MAX_ARITY)   # [W, 3]
        used = np.arange(MAX_ARITY)[None, :] < k[:, None]
        top = np.where(used, fanin, -1).max(axis=1)
        fix = top < p1[0]
        fanin[fix, 0] = p1[0] + rng.integers(p1[1] - p1[0], size=int(fix.sum()))
        s = [sig[fanin[:, t]] for t in range(MAX_ARITY)]
        sig[ids] = _simulate_step(g, *s, modality == "aig")
        srcs.append(fanin[used])
        dsts.append(np.broadcast_to(ids[:, None], used.shape)[used])
        pool_lo, p1 = p1[0], (base, base + width)
        base += width
    edge = np.stack([np.concatenate(srcs), np.concatenate(dsts)]).astype(np.int64)
    prob, pairs, tt = _labels(rng, sig, num_inputs, num_tt_pairs)
    return Circuit(gate, edge, prob, pairs, tt)
