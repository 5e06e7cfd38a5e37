"""A traffic mix's datasets, made from the seed: the pools of distinct
circuits and the train and val entries drawn from them.

A mix is a JSON file under ``portbench/traffic/``:

  family          "random" (``num_inputs``, ``num_gates``) or "layered"
                  (``width``, ``depth``): ``circuits.py``'s families
  num_tt_pairs    truth-table pairs a circuit
  train_pool, train_entries, val_pool, val_entries
                  distinct circuits and entries of each split; each
                  circuit of a pool appears entries / pool times, in an
                  order drawn from the seed
  batch_size      circuits a step and rank
  dp              ranks of the data-parallel trainer (one card each)
  steps_per_call  the trainer's K-step calls

Every seed gives circuits of the same sizes, so every seed's window holds
the same work but for the edges' share of it. An epoch's train steps cover
the train entries exactly (``check``), so the nodes and operations an epoch
completes do not depend on the trainer's shuffle.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import circuits


@dataclasses.dataclass
class Datasets:
    train: list          # circuits.Circuit, one per entry (pool circuits repeat)
    val: list


def check(traffic: dict) -> None:
    t = traffic
    per_step = t["batch_size"] * t["dp"]
    for split in ("train", "val"):
        pool, entries = t[f"{split}_pool"], t[f"{split}_entries"]
        if entries and (entries % pool or entries % per_step):
            raise ValueError(f"traffic: {split}_entries {entries} must be a multiple of its pool "
                             f"{pool} and of batch_size x dp {per_step}")
    steps = t["train_entries"] // per_step
    if steps < t["steps_per_call"] or steps % t["steps_per_call"]:
        raise ValueError(f"traffic: {steps} train steps an epoch must be whole K-step calls of "
                         f"{t['steps_per_call']}")
    if t["steps_per_call"] < 3:
        raise ValueError("traffic: the check follows the first three steps of the first call, "
                         "so steps_per_call must be at least 3")


def _pool(rng, traffic: dict, modality: str, count: int) -> list:
    t = traffic
    if t["family"] == "random":
        return circuits.random_circuits(rng, modality, count, t["num_inputs"], t["num_gates"],
                                        t["num_tt_pairs"])
    if t["family"] == "layered":
        return [circuits.layered_circuit(rng, modality, t["width"], t["depth"], t["num_tt_pairs"])
                for _ in range(count)]
    raise ValueError(f"traffic: unknown family {t['family']!r}")


def build(traffic: dict, modality: str, seed: int) -> Datasets:
    check(traffic)
    rng = np.random.default_rng([int(seed), 0x7B])
    out = []
    for split in ("train", "val"):
        pool_n, entries = traffic[f"{split}_pool"], traffic[f"{split}_entries"]
        if not entries:
            out.append([])
            continue
        pool = _pool(rng, traffic, modality, pool_n)
        ids = rng.permutation(np.tile(np.arange(pool_n), entries // pool_n))
        out.append([pool[i] for i in ids])
    return Datasets(*out)


def real_counts(circuits_: list) -> dict:
    """Nodes, gates (non-input nodes), edges and pairs summed over circuits."""
    return {"nodes": sum(c.num_nodes for c in circuits_),
            "gates": sum(int((c.gate != 0).sum()) for c in circuits_),
            "edges": sum(c.num_edges for c in circuits_),
            "pairs": sum(int(c.tt_dis.shape[0]) for c in circuits_)}
