"""Resume training from ``<save_dir>/resume_demo/model_last.pth``.

Counterpart of ``examples/resume.py`` (the reference's examples/resume.py):
32 synthetic MIG circuits of 8 inputs and 64 gates, D = 64, bs4; resumes
when the checkpoint exists, trains ``$EPOCHS`` epochs (default 1) with
weights [1, 4, 2] and saves ``model_last.pth`` again.

    python -m mgvae_tpu_torch.examples.resume [--device cpu] [--save_dir DIR]

Runs on the card unless ``--device cpu``. Returns (trainer, resumed).
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
    rng = np.random.default_rng(0)
    graphs = [random_circuit(rng, "mig", num_inputs=8, num_gates=64)
              for _ in range(args.num_graphs)]
    cut = args.num_graphs * 7 // 8
    cfg = deepgate.DGConfig(modality="mig", dim_hidden=64)
    trainer = deepgate.Trainer(types.SimpleNamespace(model="DG_AE"), cfg,
                               training_id="resume_demo", batch_size=4, distributed=False,
                               save_dir=args.save_dir, device=args.device)
    resumed = trainer.resume()
    if resumed:
        print("[INFO] Resumed from", os.path.join(trainer.log_dir, "model_last.pth"))
    trainer.set_training_args(rc_prob_func_weight=[1.0, 4.0, 2.0], lr=1e-4, lr_step=50)
    trainer.train(int(os.environ.get("EPOCHS", "1")), graphs[:cut], graphs[cut:])
    trainer.save(os.path.join(trainer.log_dir, "model_last.pth"))
    return trainer, resumed


if __name__ == "__main__":
    main()
