"""Large-batch training through the chunked fused kernels.

Counterpart of ``examples/large_batch_training.py``: a bs64 batch of MIG
circuits (16 inputs, 264 gates) collated by ``collate_fit`` as C disjoint
chunks, the smallest C whose chunks pass the fused level kernel's size gate
(``ops/level_kernel.kernel_fits``); each train step then runs the struct
towers' kernels and, per chunk, the fused level scan and its backward
(``csrc/struct_towers*.cu``, ``csrc/level_scan*.cu``). D = 64, layernorm,
weights [1, 4, 2, 0], Adam lr 1e-4, 5 steps.

    python -m mgvae_tpu_torch.examples.large_batch_training [--device cpu]

Runs on the card unless ``--device cpu``. Returns the steps' metrics.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.batching import collate_fit
from ..data.synthetic import random_circuit
from ..models.dg_ae import DGConfig, init_params
from ..train.step import make_optimizer, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num_graphs", type=int, default=64)
    ap.add_argument("--num_gates", type=int, default=264)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    graphs = [random_circuit(rng, "mig", num_inputs=16, num_gates=args.num_gates,
                             num_tt_pairs=64) for _ in range(args.num_graphs)]

    cfg = DGConfig(modality="mig", dim_hidden=64, layernorm=True)
    params, state = init_params(cfg, seed=0, device=args.device)
    optimizer = make_optimizer(params, 1e-4)
    train_step, _ = make_train_step(cfg, optimizer)
    gen = torch.Generator(device=params["hs_linear"]["w"].device).manual_seed(0)

    batch = collate_fit(graphs)
    C = batch["lv_nodes"].shape[0] if batch["lv_nodes"].ndim == 3 else 1
    print(f"bs{len(graphs)} collated as {C} chunk(s) of "
          f"{batch['gate'].shape[0] // C} padded nodes")

    weights = [1.0, 4.0, 2.0, 0.0]
    out = []
    for step in range(5):
        state, m = train_step(params, state, batch, gen, weights)
        m = {k: float(v) for k, v in m.items()}
        print(f"step {step}: loss {m['loss']:.4f} recon {m['recon_loss']:.4f}")
        out.append(m)
    return out


if __name__ == "__main__":
    main()
