"""CLI flags of ``python -m mgvae_tpu_torch.train``: a copy of the root
``config.py`` (the JAX trainer's), so that both entry points take the same
flags, defaults, choices and types. The port imports nothing from the
repository root, hence the copy.

Flags the port accepts but does not honour yet are named in ``cli.py``."""
import argparse


def get_parse_args(argv=None):
    """Parse ``argv`` (default: ``sys.argv[1:]``)."""
    parser = argparse.ArgumentParser(description="Training script of DG_VAE (mgvae_tpu_torch, one CUDA device).")
    parser.add_argument("--exp_id", type=str, default="default", help="Experiment ID")
    parser.add_argument("--local-rank", type=int, default=0, help="(compat) unused; JAX manages processes")

    # Model
    parser.add_argument("--model", type=str, default="DG_VAE", help="Model name",
                        choices=["DG_VAE", "DG_AE", "AE"])
    parser.add_argument("--dim_hidden", type=int, default=64, help="Dimension of hidden layer")
    parser.add_argument("--dim_feature", type=int, default=6, help="Dimension of input feature")
    parser.add_argument("--s_rounds", type=int, default=4, help="Number of rounds for source node")
    parser.add_argument("--t_rounds", type=int, default=4, help="Number of rounds for target node")
    parser.add_argument("--layernorm", action="store_true", help="Enable layernorm")

    # Training
    parser.add_argument("--type", type=str, required=True, choices=["aig", "mig", "xmg", "xag"],
                        help="Circuit type to train")
    parser.add_argument("--batch_size", type=int, default=4, help="Batch size (per device)")
    parser.add_argument("--num_epochs", type=int, default=60,
                        help="(compat) ignored by 3-stage train.py, like the reference (quirk 9)")
    parser.add_argument("--lr", type=float, default=1e-3, help="Learning rate")
    parser.add_argument("--distributed", action="store_true", help="Enable data-parallel training")
    parser.add_argument("--resume", action="store_true")

    # Additions over the reference
    parser.add_argument("--data_dir", type=str, default="",
                        help="Dataset dir containing graphs.npz (+labels.npz); "
                             "empty -> synthetic dataset (reference hardcodes a cluster path)")
    parser.add_argument("--save_dir", type=str, default="./exp")
    parser.add_argument("--synthetic_circuits", type=int, default=256,
                        help="Synthetic dataset size when --data_dir is empty")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num_devices", type=int, default=0, help="0 = all local devices")
    parser.add_argument("--no_input_quirk", action="store_true",
                        help="Feed the real gate one-hot to the struct encoder "
                             "instead of replicating the reference's collapsed input (quirk 3)")
    parser.add_argument("--no_fixed_dims", action="store_true",
                        help="Disable the running-max batch-dims mode (fixed dims avoid "
                             "recompilation storms on datasets with varied circuit sizes)")
    parser.add_argument("--matmul_precision", type=str, default="default",
                        choices=["default", "high", "highest"],
                        help="TPU fp32 matmul precision (highest = exact fp32 via bf16x6; "
                             "default = 1 bf16 pass, ~1e-3 drift, fastest)")
    parser.add_argument("--neg_collision_mask", action="store_true",
                        help="Mask sampled negatives that hit real edges (matches PyG "
                             "negative_sampling's rejection; ~E/N^2 bias otherwise)")
    parser.add_argument("--kl_weight", type=float, default=0.0,
                        help="KL weight for DG_VAE (reference computes KL but never trains it)")
    parser.add_argument("--stage_epochs", type=str, default="100,60,60",
                        help="Epochs of the 3 training stages (reference: 100,60,60)")
    parser.add_argument("--log_every", type=int, default=0, help="Print running stats every N iters")
    parser.add_argument("--steps_per_call", type=int, default=8,
                        help="Optimizer steps scanned into one dispatched program "
                             "(amortizes per-dispatch latency; 1 = step-per-dispatch)")
    parser.add_argument("--split", type=str, default="auto",
                        help="Shape-aware split batches (collate_split): 'auto' "
                             "engages on TPU when each shard yields >=2 kernel-"
                             "sized groups, '0' disables, an integer forces that "
                             "group count")

    args = parser.parse_args(argv)
    return args
