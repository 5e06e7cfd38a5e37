"""Host-side circuit graph container (numpy) + constructor.

Copy of ``mgvae_tpu/data/graph.py``'s container and constructor: the
``CircuitGraph`` dataclass byte for byte (with the DeepGate2 extras and the
reference's index / PI / PO / one-hot views) and ``build_graph``.

Gate-id conventions:
  AIG:               {PI: 0, AND: 1, NOT: 2}
  MIG/XMG/XAG/.bench {INPUT: 0, MAJ: 1, NOT: 2, AND: 3, OR: 4, XOR: 5}
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .levelize import levelize

NUM_GATE_TYPES = 6

# gate -> expert sets per modality (expert t of a model handles gate id
# MODALITY_GATES[modality][t])
MODALITY_GATES = {
    "aig": (1, 2),
    "mig": (2, 3, 4, 1),
    "xag": (3, 2, 5),
    "xmg": (3, 2, 5, 1, 4),
}


@dataclasses.dataclass
class CircuitGraph:
    """One parsed circuit. All arrays are numpy; edges are directed src->dst."""

    name: str
    gate: np.ndarray          # [N] int32 gate-type ids
    edge_index: np.ndarray    # [2, E] int64
    forward_level: np.ndarray   # [N] int32
    backward_level: np.ndarray  # [N] int32
    prob: np.ndarray          # [N] float32 signal probability labels
    tt_pair_index: np.ndarray  # [2, P] int64 node pairs with truth-table labels
    tt_dis: np.ndarray        # [P] float32 pairwise truth-table distance/similarity
    # DeepGate2-style extras carried by the legacy Dataset front-end
    # (data/dataset.py; the reference's dataset.py labels): optional.
    min_tt_dis: np.ndarray | None = None   # [P] float32
    rc_pair_index: np.ndarray | None = None  # [2, R] int64 reconvergence pairs
    is_rc: np.ndarray | None = None        # [R] float32 0/1 labels

    @property
    def num_nodes(self) -> int:
        return int(self.gate.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    @property
    def num_levels(self) -> int:
        return int(self.forward_level.max()) + 1 if self.num_nodes else 0

    # API parity with OrderedData consumers (BenchParser.read_bench masks,
    # parser.py:163-165)
    @property
    def forward_index(self) -> np.ndarray:
        return np.arange(self.num_nodes, dtype=np.int64)

    @property
    def backward_index(self) -> np.ndarray:
        return np.arange(self.num_nodes, dtype=np.int64)

    @property
    def PIs(self) -> np.ndarray:
        return np.flatnonzero((self.forward_level == 0) & (self.backward_level != 0))

    @property
    def POs(self) -> np.ndarray:
        return np.flatnonzero((self.backward_level == 0) & (self.forward_level != 0))

    @property
    def no_connect(self) -> np.ndarray:
        return np.flatnonzero((self.forward_level == 0) & (self.backward_level == 0))

    @property
    def x(self) -> np.ndarray:
        """One-hot node features, reconstructed on demand (construct_node_feature
        parity, utils/data_utils.py:77-85)."""
        x = np.zeros((self.num_nodes, NUM_GATE_TYPES), dtype=np.float32)
        x[np.arange(self.num_nodes), self.gate] = 1.0
        return x


def build_graph(
    name: str,
    gate: np.ndarray,
    edge_index: np.ndarray,
    prob: np.ndarray | None = None,
    tt_pair_index: np.ndarray | None = None,
    tt_dis: np.ndarray | None = None,
) -> CircuitGraph:
    """Levelize + package one circuit; ``tt_pair_index`` is [2, P]."""
    gate = np.asarray(gate, dtype=np.int32).reshape(-1)
    n = gate.shape[0]
    edge_index = np.asarray(edge_index, dtype=np.int64).reshape(2, -1)
    fwd = levelize(edge_index, n)
    bwd = levelize(edge_index[::-1] if edge_index.size else edge_index, n)
    if prob is None:
        prob = np.zeros(n, dtype=np.float32)
    if tt_pair_index is None:
        tt_pair_index = np.zeros((2, 0), dtype=np.int64)
    if tt_dis is None:
        tt_dis = np.zeros(0, dtype=np.float32)
    return CircuitGraph(
        name=name,
        gate=gate,
        edge_index=edge_index,
        forward_level=fwd,
        backward_level=bwd,
        prob=np.asarray(prob, dtype=np.float32).reshape(-1),
        tt_pair_index=np.asarray(tt_pair_index, dtype=np.int64).reshape(2, -1),
        tt_dis=np.asarray(tt_dis, dtype=np.float32).reshape(-1),
    )
