"""Two-stage training example through the ``deepgate`` shim.

Counterpart of ``examples/train.py`` (the reference's examples/train.py with
its stale argument names fixed): the circuits of ``$DATA_DIR/graphs.npz``
(AIG, ``NpzParser``) or, without ``DATA_DIR``, 32 synthetic AIG circuits of
8 inputs and 64 gates; D = 64, bs4; stage 1 with weights [3, 1, 0], stage 2
with [3, 1, 2], ``$EPOCHS`` epochs each (default 2).

    python -m mgvae_tpu_torch.examples.train [--device cpu] [--save_dir DIR]

Runs on the card unless ``--device cpu``. Returns the trainer.
"""
from __future__ import annotations

import argparse
import os
import types

import numpy as np

from .. import deepgate
from ..data.synthetic import random_circuit


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save_dir", default="./exp")
    ap.add_argument("--num_graphs", type=int, default=32)
    args = ap.parse_args(argv)
    data_dir = os.environ.get("DATA_DIR", "")
    num_epochs = int(os.environ.get("EPOCHS", "2"))

    print("[INFO] Parse Dataset")
    if data_dir:
        circuit_path = os.path.join(data_dir, "graphs.npz")
        parser = deepgate.NpzParser(data_dir, circuit_path, circuit_path, "aig")
        train_dataset, val_dataset = parser.get_dataset()
    else:
        rng = np.random.default_rng(0)
        graphs = [random_circuit(rng, "aig", num_inputs=8, num_gates=64)
                  for _ in range(args.num_graphs)]
        cut = args.num_graphs * 7 // 8
        train_dataset, val_dataset = graphs[:cut], graphs[cut:]

    print("[INFO] Create Model and Trainer")
    cfg = deepgate.DGConfig(modality="aig", dim_hidden=64)
    trainer = deepgate.Trainer(types.SimpleNamespace(model="DG_AE"), cfg, batch_size=4,
                               distributed=True, save_dir=args.save_dir, device=args.device)

    print("[INFO] Stage 1 Training ...")
    trainer.set_training_args(rc_prob_func_weight=[3.0, 1.0, 0.0], lr=1e-4, lr_step=50)
    trainer.train(num_epochs, train_dataset, val_dataset)

    print("[INFO] Stage 2 Training ...")
    trainer.set_training_args(rc_prob_func_weight=[3.0, 1.0, 2.0], lr=1e-4, lr_step=50)
    trainer.train(num_epochs, train_dataset, val_dataset)
    return trainer


if __name__ == "__main__":
    main()
