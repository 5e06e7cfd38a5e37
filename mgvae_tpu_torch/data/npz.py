"""NpzParser: the reference's npz dataset front-end, PyG-free.

Copy of ``mgvae_tpu/data/npz.py`` apart from the cache directory.

Mirrors DG_VAE/deepgate/parser.py:22-126 including its quirks:
  * graphs.npz holds {'circuits': {name: {...}}}; for AIG the labels
    (tt_sim/tt_pair_index/prob) AND the gate array live in graphs.npz,
    while mig/xmg/xag read labels.npz {'labels': {name: ...}}
    (parser.py:73-107, SURVEY.md §8 quirk 6).
  * storage layout differs by modality: AIG stores edge_index/tt_pair_index
    as [2, E]; the others store [E, 2] and are transposed on load
    (parser_func.py:46-59 vs parser_func_others.py:46-62, quirk 5).
  * seven named sequential circuits are skipped (parser.py:90, quirk 16).
  * circuits with no tt pairs are skipped (parser.py:109-111).
  * parsed graphs are cached on disk (parser.py:124) as a .npy pickle of
    CircuitGraph objects, under <root>/inmemory_torch/: the JAX package's
    cache in <root>/inmemory/ pickles its own CircuitGraph class, and
    unpickling that here would import the JAX package.
  * 90/10 shuffled train/val split (parser.py:30-36).
"""
from __future__ import annotations

import os

import numpy as np

from .graph import CircuitGraph, build_graph

SKIP_CIRCUITS = {
    "D_FF_0", "register_cc", "D_FF_1", "Main_led_brightness_control_PWM",
    "ProgramCounter", "TenHertz", "dlatch",
}


class NpzParser:
    """Parse the npz file into train/val lists of CircuitGraph."""

    def __init__(self, data_dir, circuit_path, label_path, circuit_type,
                 random_shuffle=True, trainval_split=0.9, seed=None, use_cache=True):
        self.data_dir = data_dir
        self.circuit_type = circuit_type
        dataset = self._load(data_dir, circuit_path, label_path, circuit_type, use_cache)
        if random_shuffle:
            rng = np.random.default_rng(seed)
            perm = rng.permutation(len(dataset))
            dataset = [dataset[i] for i in perm]
        cutoff = int(len(dataset) * trainval_split)
        self.train_dataset = dataset[:cutoff]
        self.val_dataset = dataset[cutoff:]

    def get_dataset(self):
        return self.train_dataset, self.val_dataset

    # ------------------------------------------------------------------
    def _cache_path(self):
        return os.path.join(self.data_dir, "inmemory_torch", "data.npy")

    def _load(self, data_dir, circuit_path, label_path, circuit_type, use_cache):
        cache = self._cache_path()
        if use_cache and os.path.exists(cache):
            graphs = np.load(cache, allow_pickle=True)
            return list(graphs)
        graphs = parse_npz(circuit_path, label_path, circuit_type)
        if use_cache:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            np.save(cache, np.asarray(graphs, dtype=object), allow_pickle=True)
            print("[INFO] Inmemory dataset save:", cache)
        return graphs


def parse_npz(circuit_path, label_path, circuit_type) -> list[CircuitGraph]:
    circuits = np.load(circuit_path, allow_pickle=True)["circuits"].item()
    labels = None
    if circuit_type != "aig":
        labels = np.load(label_path, allow_pickle=True)["labels"].item()

    out = []
    for idx, name in enumerate(circuits):
        if name in SKIP_CIRCUITS:
            continue
        c = circuits[name]
        x = np.asarray(c["x"])
        edge_index = np.asarray(c["edge_index"])
        if circuit_type == "aig":
            tt_dis = np.asarray(c["tt_sim"])          # similarity key, quirk 6
            tt_pair_index = np.asarray(c["tt_pair_index"])  # stored [2, P]
            prob = np.asarray(c["prob"])
            gate = np.asarray(c["gate"]).reshape(-1)
        else:
            lab = labels[name]
            tt_dis = np.asarray(lab["tt_dis"])
            tt_pair_index = np.asarray(lab["tt_pair_index"])
            if tt_pair_index.size:
                tt_pair_index = tt_pair_index.T        # stored [P, 2], quirk 5
            prob = np.asarray(lab["prob"])
            gate = x[:, 1].astype(np.int64)            # parser_func_others.py:75
            edge_index = edge_index.T if edge_index.size else edge_index
        if tt_pair_index.size == 0:
            print("No tt or rc pairs:", name)
            continue
        out.append(
            build_graph(name, gate, edge_index, prob.reshape(-1),
                        tt_pair_index.reshape(2, -1), tt_dis.reshape(-1))
        )
    return out


def save_npz(graphs: list[CircuitGraph], circuit_path, label_path, circuit_type):
    """Write graphs back in the reference npz schema (useful for tests and
    for generating datasets consumable by the original PyTorch repo)."""
    circuits, labels = {}, {}
    for g in graphs:
        n = g.num_nodes
        x = np.zeros((n, 2), dtype=np.int64)
        x[:, 0] = np.arange(n)
        x[:, 1] = g.gate
        if circuit_type == "aig":
            circuits[g.name] = {
                "x": x, "edge_index": g.edge_index,
                "tt_sim": g.tt_dis, "tt_pair_index": g.tt_pair_index,
                "prob": g.prob, "gate": g.gate.reshape(-1, 1),
            }
        else:
            circuits[g.name] = {"x": x, "edge_index": g.edge_index.T}
            labels[g.name] = {
                "tt_dis": g.tt_dis, "tt_pair_index": g.tt_pair_index.T,
                "prob": g.prob,
            }
    np.savez(circuit_path, circuits=_obj(circuits))
    if circuit_type != "aig":
        np.savez(label_path, labels=_obj(labels))


def _obj(d):
    arr = np.empty((), dtype=object)
    arr[()] = d
    return arr
