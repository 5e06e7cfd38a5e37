"""AIGER front-end: ASCII (.aag) and binary (.aig) decoders.

A copy of ``mgvae_tpu/data/aiger.py``. The reference shells out to the
external C tool ``aigtoaig`` to convert binary AIGER to ASCII, then parses
text (utils/aiger_utils.py:115-189); this decodes the binary delta/varint
format directly: with the port's native decoder (``mgvae_tpu_torch/native``,
the same construction) when the library loads and the gate map is AIGER's,
else in Python. No subprocess, no external binary.

Graph construction matches aig_to_xdata_bak exactly:
  * nodes: I inputs then A ands (gate map {PI:0, AND:1, NOT:2});
  * every inverted fanin literal materializes a NOT node, shared per
    variable (aiger_utils.py:148-173);
  * inverted primary outputs also get a NOT node (aiger_utils.py:176-187).
"""
from __future__ import annotations

import os

import numpy as np

from .graph import CircuitGraph, build_graph

GATE_TO_INDEX_AIG = {"PI": 0, "AND": 1, "NOT": 2}


def _decode_binary(data: bytes):
    """Decode binary AIGER; returns (I, L, O, A, outputs, ands) with ands as
    (lhs, rhs0, rhs1) literal triples."""
    nl = data.index(b"\n")
    header = data[:nl].split()
    if not header or header[0] != b"aig":
        raise ValueError("not a binary AIGER file")
    m, i, l, o, a = (int(x) for x in header[1:6])
    pos = nl + 1
    if l:
        raise ValueError("AIGER latches unsupported (combinational only)")
    outputs = []
    for _ in range(o):
        nl = data.index(b"\n", pos)
        outputs.append(int(data[pos:nl]))
        pos = nl + 1

    def varint():
        nonlocal pos
        x, shift = 0, 0
        while True:
            b = data[pos]
            pos += 1
            x |= (b & 0x7F) << shift
            if not (b & 0x80):
                return x
            shift += 7

    ands = []
    for k in range(a):
        lhs = 2 * (i + l + k + 1)
        delta0 = varint()
        delta1 = varint()
        rhs0 = lhs - delta0
        rhs1 = rhs0 - delta1
        ands.append((lhs, rhs0, rhs1))
    return i, l, o, a, outputs, ands


def _decode_ascii(text: str):
    lines = [ln for ln in text.splitlines() if ln.strip()]
    header = lines[0].split() if lines else []
    if not header or header[0] != "aag":
        raise ValueError("not an ASCII AIGER file")
    m, i, l, o, a = (int(x) for x in header[1:6])
    if l:
        raise ValueError("AIGER latches unsupported (combinational only)")
    outputs = [int(lines[1 + i + k].split()[0]) for k in range(o)]
    ands = []
    for k in range(a):
        parts = lines[1 + i + o + k].split()
        if len(parts) != 3:
            continue
        ands.append(tuple(int(x) for x in parts))
    return i, l, o, a, outputs, ands


def aig_to_xdata(path: str, gate_to_index=GATE_TO_INDEX_AIG):
    """Returns (x_data, edge_index) lists in the reference's format."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] == b"aig":
        if gate_to_index == GATE_TO_INDEX_AIG:
            from ..native import aig_decode_native

            res = aig_decode_native(data)
            if res is not None:
                gates, edges = res
                return [[k, int(g)] for k, g in enumerate(gates)], edges.T.tolist()
        i, l, o, a, outputs, ands = _decode_binary(data)
    else:
        i, l, o, a, outputs, ands = _decode_ascii(data.decode())

    x_data = [[k, gate_to_index["PI"]] for k in range(i)]
    for _ in range(a):
        x_data.append([len(x_data), gate_to_index["AND"]])
    edge_index = []
    has_not = {}

    def resolve(lit: int) -> int:
        idx = lit // 2 - 1
        if lit % 2 == 0:
            return idx
        if idx not in has_not:
            x_data.append([len(x_data), gate_to_index["NOT"]])
            not_idx = len(x_data) - 1
            edge_index.append([idx, not_idx])
            has_not[idx] = not_idx
        return has_not[idx]

    for lhs, rhs0, rhs1 in ands:
        and_idx = lhs // 2 - 1
        f0 = resolve(rhs0)
        f1 = resolve(rhs1)
        edge_index.append([f0, and_idx])
        edge_index.append([f1, and_idx])
    for lit in outputs:
        if lit % 2 == 1:
            resolve(lit)
    return x_data, edge_index


class AigParser:
    """The parser examples/feature_extract.py expects but the reference never
    shipped (SURVEY.md §8 quirk 13)."""

    def __init__(self, gate_to_index=GATE_TO_INDEX_AIG):
        self.gate_to_index = dict(gate_to_index)

    def read_aiger(self, path: str) -> CircuitGraph:
        x_data, edge_index = aig_to_xdata(path, self.gate_to_index)
        gate = np.asarray([g for _, g in x_data], dtype=np.int32)
        edges = (
            np.asarray(edge_index, dtype=np.int64).T
            if edge_index
            else np.zeros((2, 0), dtype=np.int64)
        )
        return build_graph(os.path.basename(path).split(".")[0], gate, edges)
