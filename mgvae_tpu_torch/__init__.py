"""mgvae_tpu_torch: the PyTorch + CUDA port of mgvae_tpu, for NVIDIA Hopper.

It serves and trains the three models of the JAX package (DG_AE, DG_VAE
and AE; ``num_rounds`` >= 1) on the card, in fp32, TF32 or bf16:
``Model.forward`` / ``encode_many`` with ``load`` / ``load_pretrained``
(the port's checkpoints, the JAX package's msgpack ones and reference
``.pth`` state dicts), the parsers (``BenchParser``, ``AigParser``,
``NpzParser``), one training step (``train.step.make_train_step``) on
plain, chunked and split batches and on one giant graph collated alone,
K of them in one call (``make_multi_step`` / ``make_multi_eval``: on the
card a captured CUDA graph of the step, replayed per step), and the
reference's 3-stage training (``Trainer``, its epochs in groups of
``steps_per_call``, checkpoints and resume; ``python -m mgvae_tpu_torch.train``), data-parallel over one process per
card under torchrun (``--distributed``; grouped on one host, each replay
holding its NCCL all-reduce), and the within-level
model-parallel train step (``parallel.sharded``), and the multi-task
trainers (``BalancerTrainer``, ``GradNormTrainer``: three per-task
backwards from one forward) and ``EarlyTrainer``; ``deepgate`` is the
reference's ``import deepgate`` surface. The data layer is numpy on the
host, its tables built by the JAX package's C++ library where it loads
(``native``, built by g++ at first use); the level statics and losses are
PyTorch; the struct towers and the level recurrence, forward
and backward, are hand-written CUDA kernels: ``csrc/struct_towers*.cu``;
``csrc/level_scan.cu`` / ``level_scan_bwd.cu``, the fused scan of a batch or
chunk that passes the size gate, one persistent launch per pass; for chunks
too large for it ``csrc/level_step*.cu``, one launch per level index; and
for a giant graph or any unchunked batch past the gate ``csrc/level_scan.cu``
without residuals and ``csrc/level_scan_giant_bwd.cu``, which recomputes
from hf in the backward, K levels at a time. Past the kernels' width
(D > 128) the model runs in plain PyTorch, as the JAX package runs its XLA
paths there. The JAX package ``mgvae_tpu`` is the reference it is tested
against; this package never imports jax.
"""

from .api import Model
from .data.aiger import AigParser
from .data.dataset import Dataset
from .data.batching import collate, collate_chunked, collate_fit, collate_shards, collate_split
from .data.bench import BenchParser
from .data.npz import NpzParser
from .data.graph import MODALITY_GATES, CircuitGraph, build_graph
from .data.synthetic import layered_circuit, random_circuit
from .models.dg_ae import DGConfig, forward, init_params
from .train.gradnorm import BalancerConfig, GradNormConfig
from .train.step import make_multi_eval, make_multi_step, make_train_step
from .train.trainer import Trainer
from .train.trainer_balancer import BalancerTrainer
from .train.trainer_early_stop import EarlyTrainer
from .train.trainer_gradnorm import GradNormTrainer
from .utils.seed import set_seed

__all__ = [
    "Model", "DGConfig", "forward", "init_params", "collate", "collate_chunked",
    "collate_fit", "collate_shards", "collate_split", "random_circuit", "layered_circuit",
    "BenchParser", "AigParser", "build_graph", "CircuitGraph", "MODALITY_GATES", "NpzParser",
    "Trainer", "set_seed", "BalancerTrainer", "GradNormTrainer", "EarlyTrainer",
    "BalancerConfig", "GradNormConfig", "Dataset", "make_train_step", "make_multi_step",
    "make_multi_eval",
]
