#!/bin/bash
# Data-parallel training of the port over several cards and hosts: one
# process per card, started by torchrun (the reference's run_mig.sh:8-16).
#
# One host, all its cards:
#   bash mgvae_tpu_torch/examples/run_multihost.sh
# Two hosts of 8 cards each (run on both; host0 holds the rendezvous):
#   host0$ NNODES=2 NODE_RANK=0 MASTER_ADDR=host0 bash mgvae_tpu_torch/examples/run_multihost.sh
#   host1$ NNODES=2 NODE_RANK=1 MASTER_ADDR=host0 bash mgvae_tpu_torch/examples/run_multihost.sh
#
# torchrun sets RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT;
# each rank trains on cuda:LOCAL_RANK over NCCL. Every rank draws the same
# shuffle and dims, collates its own shard of each step, and averages the
# gradients, BN state and metrics with the others; rank 0 writes the log
# and the checkpoints. On CPUs (gloo): MGVAE_PLATFORM=cpu NPROC=2 ... .
# tests/test_torch_dp.py runs a 2-process trainer on the CPU.
set -e
cd "$(dirname "$0")/../.."
NPROC=${NPROC:-$(nvidia-smi -L 2>/dev/null | wc -l)}
torchrun --nnodes "${NNODES:-1}" --node_rank "${NODE_RANK:-0}" \
  --nproc_per_node "${NPROC:-1}" \
  --master_addr "${MASTER_ADDR:-localhost}" --master_port "${MASTER_PORT:-29500}" \
  -m mgvae_tpu_torch.train \
  --exp_id MH_MIG --model DG_AE --type mig \
  --batch_size 16 --layernorm --distributed \
  --stage_epochs 100,60,60 "$@"
