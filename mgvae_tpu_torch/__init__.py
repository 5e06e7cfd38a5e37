"""mgvae_tpu_torch: the PyTorch + CUDA port of mgvae_tpu, for NVIDIA Hopper.

It runs the DG_AE encode path (``Model.forward`` / ``encode_many``) and one
DG_AE training step (``train.step.make_train_step``: forward, the recon,
prob and func losses, backward, Adam): the numpy data layer, the struct
encoder, level statics and losses in PyTorch, and the level recurrence
forward and backward as hand-written CUDA kernels (``csrc/level_scan.cu``,
``csrc/level_scan_bwd.cu``). The JAX package ``mgvae_tpu`` is the reference
it is tested against; this package never imports jax.
"""

from .api import Model
from .data.batching import collate
from .data.bench import BenchParser
from .data.graph import CircuitGraph, build_graph
from .data.synthetic import random_circuit
from .models.dg_ae import DGConfig, forward, init_params

__all__ = [
    "Model", "DGConfig", "forward", "init_params", "collate", "random_circuit",
    "BenchParser", "build_graph", "CircuitGraph",
]
