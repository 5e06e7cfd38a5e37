"""Legacy DeepGate2-style Dataset front-end — rebuilt WORKING.

The reference ships deepgate/dataset.py, an older InMemoryDataset that loads
npz circuits plus richer labels (min_tt_dis, reconvergence pairs rc_pair_
index/is_rc) — but it is dead code there: its parse_pyg_mlpgate calls
construct_node_feature with 4 args against a 2-param signature
(dataset.py:54 vs utils/data_utils.py:77, SURVEY.md §8 quirk 13). This is a
working torch/PyG-free equivalent with the same knobs:

  * args.data_dir / circuit_file / label_file  (dataset.py:135-136)
  * args.small_train  -> first ~100 circuits, cached separately
    (dataset.py:115-120,139)
  * args.no_rc        -> dummy rc labels, '_norc' cache suffix
    (dataset.py:120-121,152-155)
  * args.reload_dataset -> drop the inmemory cache first (dataset.py:102-104)
  * circuits with no tt or rc pairs are skipped (dataset.py:158-160)

Returns CircuitGraph objects carrying the extra label arrays (min_tt_dis,
rc_pair_index [2, R], is_rc) so DeepGate2-style readout heads can train on
them; the standard collate() ignores the extras.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from .graph import CircuitGraph, build_graph


class Dataset:
    """Working rebuild of deepgate/dataset.py:93-183."""

    def __init__(self, root, args):
        self.name = "MIG"
        self.args = args
        self.root = root
        if getattr(args, "reload_dataset", False) and os.path.exists(self.processed_dir):
            shutil.rmtree(self.processed_dir)
        cache = os.path.join(self.processed_dir, "data.npy")
        if os.path.exists(cache):
            self.graphs = list(np.load(cache, allow_pickle=True))
        else:
            self.graphs = self._process()
            os.makedirs(self.processed_dir, exist_ok=True)
            np.save(cache, np.asarray(self.graphs, dtype=object), allow_pickle=True)
            print("[INFO] Inmemory dataset save:", cache)

    # ------------------------------------------------------------------
    @property
    def processed_dir(self) -> str:
        name = "inmemory_small" if getattr(self.args, "small_train", False) else "inmemory"
        if getattr(self.args, "no_rc", False):
            name += "_norc"
        return os.path.join(self.root, name)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        return self.graphs[i]

    # ------------------------------------------------------------------
    def _process(self) -> list[CircuitGraph]:
        a = self.args
        circuit_path = os.path.join(a.data_dir, a.circuit_file)
        label_path = os.path.join(a.data_dir, a.label_file)
        circuits = np.load(circuit_path, allow_pickle=True)["circuits"].item()
        labels = np.load(label_path, allow_pickle=True)["labels"].item()
        small = getattr(a, "small_train", False)
        no_rc = getattr(a, "no_rc", False)

        out: list[CircuitGraph] = []
        tot_pairs = 0
        for idx, name in enumerate(circuits):
            c, lab = circuits[name], labels[name]
            x = np.asarray(c["x"])
            edge_index = np.asarray(c["edge_index"])
            if edge_index.size and edge_index.shape[0] != 2:
                edge_index = edge_index.T  # stored [E, 2] (quirk 5)
            tt_dis = np.asarray(lab["tt_dis"], dtype=np.float32).reshape(-1)
            min_tt_dis = np.asarray(lab.get("min_tt_dis", tt_dis), dtype=np.float32).reshape(-1)
            tt_pair_index = np.asarray(lab["tt_pair_index"])
            if tt_pair_index.size and tt_pair_index.shape[0] != 2:
                tt_pair_index = tt_pair_index.T
            prob = np.asarray(lab["prob"], dtype=np.float32).reshape(-1)
            if no_rc:
                rc_pair_index = np.asarray([[0], [1]], dtype=np.int64)  # dataset.py:153
                is_rc = np.zeros(1, dtype=np.float32)
            else:
                rc_pair_index = np.asarray(lab["rc_pair_index"])
                if rc_pair_index.size and rc_pair_index.shape[0] != 2:
                    rc_pair_index = rc_pair_index.T
                is_rc = np.asarray(lab["is_rc"], dtype=np.float32).reshape(-1)
            if tt_pair_index.size == 0 or rc_pair_index.size == 0:
                print("No tt or rc pairs:", name)
                continue
            tot_pairs += tt_dis.shape[0]
            g = build_graph(name, x[:, 1].astype(np.int64), edge_index, prob,
                            tt_pair_index.reshape(2, -1), tt_dis)
            g.min_tt_dis = min_tt_dis
            g.rc_pair_index = rc_pair_index.reshape(2, -1).astype(np.int64)
            g.is_rc = is_rc
            out.append(g)
            if small and idx > 100:
                break
        print(f"Total Circuits: {len(out)} Total pairs: {tot_pairs}")
        return out
