"""Embedding extraction for all four modalities on one device.

Counterpart of ``examples/extract_all_modalities.py`` (there a data-parallel
jitted forward per modality; here one device, the port's parallelism not
being ported yet): per modality, 16 random circuits (8 inputs, 96 gates)
collated into one bs16 batch and encoded at D = 64 with layernorm, random
weights from seed 0; prints the shapes and the mean |hf| of the real rows.

    python -m mgvae_tpu_torch.examples.extract_all_modalities [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.batching import collate
from ..data.synthetic import random_circuit
from ..models.dg_ae import DGConfig, forward, init_params

MODALITIES = ("aig", "mig", "xmg", "xag")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    out = {}
    for modality in MODALITIES:
        cfg = DGConfig(modality=modality, dim_hidden=64, layernorm=True)
        params, _ = init_params(cfg, seed=0, device=args.device)
        graphs = [random_circuit(rng, modality, num_inputs=8, num_gates=96) for _ in range(16)]
        batch = collate(graphs)
        with torch.inference_mode():
            hs, hf, _ = forward(params, batch, cfg)
        n = int(batch["n_nodes"])
        out[modality] = (hs[:n].cpu(), hf[:n].cpu())
        print(f"{modality}: hs {tuple(hs[:n].shape)} hf {tuple(hf[:n].shape)} "
              f"|hf| mean {float(hf[:n].abs().mean()):.4f}")
    return out


if __name__ == "__main__":
    main()
