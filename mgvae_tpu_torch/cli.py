"""The 3-stage training CLI of the port: ``python -m mgvae_tpu_torch.train``,
the counterpart of the root ``train.py`` (the reference's DG_VAE/train.py).

    MGVAE_PLATFORM=cpu python -m mgvae_tpu_torch.train --exp_id v --model DG_AE \\
        --type mig --batch_size 4 --layernorm --dim_hidden 32 --s_rounds 1 \\
        --t_rounds 1 --stage_epochs 1,1,1 --synthetic_circuits 24 --save_dir /tmp/vexp

Stages (train.py:81-85): recon only, recon + prob, all three losses, lr
1e-4, lr_step 50; ``--stage_epochs`` sets their epochs (100,60,60).
``--num_epochs`` and ``--lr`` are ignored, like the reference's (quirk 9).
Without ``--data_dir`` a synthetic labelled dataset is generated.

``--model`` picks the model as ``train.py`` does: DG_VAE (the parser's
default) adds the variational head and the KL term (``--kl_weight``), DG_AE
runs without them, AE swaps the struct towers for the directed GCN.

Runs on the card (``cuda``) unless ``MGVAE_PLATFORM=cpu`` (the environment
knob of ``train.py``). Data parallelism runs one process per device:

    torchrun --nproc_per_node 8 -m mgvae_tpu_torch.train --distributed ...

(``examples/run_multihost.sh`` for several hosts): NCCL between the cards,
gloo between CPU processes with ``MGVAE_PLATFORM=cpu``; every rank trains
its shard of each step, the gradients are averaged, and rank 0 logs and
writes the checkpoints (``train/trainer.py``). Before any data is built, a
partial launch (``WORLD_SIZE`` without its rendezvous) raises RuntimeError,
and ``--distributed --num_devices k`` with k other than the processes
launched raises ValueError. ``--steps_per_call`` K (default 8, as
``train.py``'s) groups each phase's steps by K (``Trainer``): on the card
each group replays the step's captured CUDA graph, on the CPU it runs
eagerly; 1 runs every step singly. ``--distributed`` with
``--steps_per_call`` groups too, on a single-host launch (torchrun's
``WORLD_SIZE`` = ``LOCAL_WORLD_SIZE``): each replay holds the step's NCCL
all-reduce. A multi-host launch, and gloo processes sharing one card, step
singly, as the JAX trainer steps singly across hosts.
``--matmul_precision`` goes into ``DGConfig`` as in ``train.py:66``:
"default" (the parser's default) runs PyTorch's fp32 products in TF32 on
the card, "highest" in full fp32.
``--dim_hidden`` reaches the model unchanged: past 128 (the kernels' width)
the model runs its plain route, as the JAX package runs its XLA paths.
``--resume`` reads ``model_last.pth`` in the port's format or the JAX
package's, so a run started on a TPU continues here (``utils/checkpoint``).
"""
from __future__ import annotations

import os

import numpy as np

from .config import get_parse_args
from .data.npz import NpzParser
from .data.synthetic import random_circuit
from .models.dg_ae import DGConfig
from .parallel.mesh import local_device
from .train.trainer import Trainer, join_launch, resolve_device

STAGE_WEIGHTS = ([1.0, 0.0, 0.0], [1.0, 5.0, 0.0], [1.0, 4.0, 4.0])
STAGE_LR, LR_STEP = 1e-4, 50


def load_dataset(args):
    """(train, val) lists of CircuitGraph: ``--data_dir``'s npz files, or
    ``--synthetic_circuits`` random circuits cut 90/10."""
    if args.data_dir:
        circuit_path = os.path.join(args.data_dir, "graphs.npz")
        label_filename = "graphs.npz" if args.type == "aig" else "labels.npz"
        label_path = os.path.join(args.data_dir, label_filename)
        parser = NpzParser(args.data_dir, circuit_path, label_path, args.type, seed=args.seed)
        return parser.get_dataset()
    print(f"[INFO] --data_dir not set; generating {args.synthetic_circuits} synthetic {args.type} circuits")
    rng = np.random.default_rng(args.seed)
    graphs = [
        random_circuit(rng, args.type, num_inputs=8, num_gates=120, num_tt_pairs=64,
                       name=f"syn{i}")
        for i in range(args.synthetic_circuits)
    ]
    cut = int(len(graphs) * 0.9)
    return graphs[:cut], graphs[cut:]


def model_config(args) -> DGConfig:
    """The model configuration of the flags (``train.py:55-67``)."""
    return DGConfig(
        modality=args.type,
        dim_hidden=args.dim_hidden,
        dim_feature=args.dim_feature,
        s_rounds=args.s_rounds,
        t_rounds=args.t_rounds,
        layernorm=args.layernorm,
        variational="VAE" in args.model,
        input_quirk=not args.no_input_quirk,
        struct_encoder="multigcn" if "DG" in args.model else "gcn",
        neg_collision_mask=args.neg_collision_mask,
        matmul_precision=args.matmul_precision,
    )


def main(argv=None) -> Trainer:
    """Run the 3 stages; returns the trainer."""
    args = get_parse_args(argv)
    cfg = model_config(args)
    platform = "cpu" if os.environ.get("MGVAE_PLATFORM") == "cpu" else "cuda"
    join_launch(args.distributed, args.num_devices or None, platform)
    device = resolve_device(local_device(platform))

    print("[INFO] Parse Dataset")
    train_dataset, val_dataset = load_dataset(args)

    print("[INFO] Create Model")
    trainer = Trainer(
        args, cfg,
        training_id=args.exp_id,
        save_dir=args.save_dir,
        batch_size=args.batch_size,
        distributed=args.distributed,
        num_devices=args.num_devices or None,
        kl_weight=args.kl_weight,
        seed=args.seed,
        log_every=args.log_every,
        fixed_dims=not args.no_fixed_dims,
        steps_per_call=args.steps_per_call,
        split=args.split if args.split == "auto" else int(args.split),
        device=device,
    )
    if args.resume:
        trainer.resume()

    stage_epochs = [int(x) for x in args.stage_epochs.split(",")]
    for stage_idx, weights in enumerate(STAGE_WEIGHTS):
        epochs = stage_epochs[stage_idx]
        print(f"\n{'=' * 40}")
        print(f"[STAGE {stage_idx + 1}] Start Training")
        print(f"|-- Epochs: {epochs}")
        print(f"|-- Loss Weights: {weights}")
        print(f"|-- Learning Rate: {STAGE_LR}")
        trainer.set_training_args(rc_prob_func_weight=weights, lr=STAGE_LR, lr_step=LR_STEP)
        trainer.train(epochs, train_dataset, val_dataset)
        trainer.save(os.path.join(trainer.log_dir, f"stage_{stage_idx + 1}.pth"))

    print("\n[INFO] All training stages completed!")
    return trainer
