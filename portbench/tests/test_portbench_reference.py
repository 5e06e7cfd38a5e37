"""The frozen plain reference against the port on the CPU, on tiny
circuits of each configuration's modality: the forward's hs and hf, and
the three training steps the check compares, through the harness's own
run (``cell.run``) with the trainer's K-step calls and draws."""
import time

import numpy as np
import pytest
import torch

from portbench import cell, circuits, reference
from portbench_tiny import cell as tiny_cell, config, layered_traffic, random_traffic

CONFIGS = ("dgae_mig_d64", "dgae_xmg_d64")


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_port(name):
    from mgvae_tpu_torch.data.batching import collate
    from mgvae_tpu_torch.models import dg_ae

    cfg = dict(config(name))
    cfg["num_experts"] = len(circuits.GATES[cfg["modality"]])
    cs = circuits.random_circuits(np.random.default_rng(11), cfg["modality"], 3, 6, 30, 12)
    params, _ = reference.weight_tree(cfg, 5, "cpu")
    batch = collate(cell.program_graphs(cs))
    hs_p, hf_p, _ = dg_ae.forward(params, batch, cell.program_config(cfg))
    lay = reference.join(cs, "cpu")
    with reference.fp32():
        hs_r, hf_r = reference.encode(params, lay, cfg)
    n = lay.n
    order = torch.as_tensor(batch["node_perm"][:n]).long()
    assert torch.equal(order, lay.perm)
    torch.testing.assert_close(hs_p[:n], hs_r[order], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hf_p[:n], hf_r[order], rtol=1e-5, atol=1e-5)
    assert hf_r.abs().sum() > 0


def test_levels_match_the_port():
    from mgvae_tpu_torch.data.graph import build_graph

    c = circuits.layered_circuit(np.random.default_rng(2), "xmg", 16, 12, 20)
    want = build_graph("x", c.gate, c.edge_index).forward_level
    assert np.array_equal(reference.levelize(c.edge_index, c.num_nodes), want)
    assert want.max() == 12


@pytest.mark.parametrize("name,workload,traffic", [
    ("dgae_mig_d64", "mig_train_bs16", random_traffic()),
    ("dgae_xmg_d64", "xmg_train_giant", layered_traffic()),
])
def test_three_steps_match_through_the_trainer(name, workload, traffic):
    res = cell.run(tiny_cell(workload, name, traffic), 2**31 + 77, 0.0, False, time.time())
    assert res["correct"], res["checks"]
    for k, v in res["checks"].items():
        assert v["value"] <= 1e-5, (k, v)
