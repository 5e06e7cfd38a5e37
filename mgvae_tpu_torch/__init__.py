"""mgvae_tpu_torch: the PyTorch + CUDA port of mgvae_tpu, for NVIDIA Hopper.

It runs the DG_AE encode path (``Model.forward`` / ``encode_many``) and one
DG_AE training step (``train.step.make_train_step``: forward, the recon,
prob and func losses, backward, Adam) on plain, chunked and split batches
and on one giant graph collated alone: the numpy data layer, level statics
and losses in PyTorch, and the struct towers and the level recurrence,
forward and backward, as hand-written CUDA kernels: ``csrc/struct_towers*.cu``;
``csrc/level_scan.cu`` / ``level_scan_bwd.cu``, the fused scan of a batch or
chunk that passes the size gate, one persistent launch per pass; for chunks
too large for it ``csrc/level_step*.cu``, one level per call; and for a
giant graph or any unchunked batch past the gate ``csrc/level_scan.cu``
without residuals and ``csrc/level_scan_giant_bwd.cu``, which recomputes
from hf in the backward, K levels at a time. The JAX
package ``mgvae_tpu`` is the reference it is tested against; this package
never imports jax.
"""

from .api import Model
from .data.batching import collate, collate_chunked, collate_fit, collate_split
from .data.bench import BenchParser
from .data.graph import CircuitGraph, build_graph
from .data.synthetic import layered_circuit, random_circuit
from .models.dg_ae import DGConfig, forward, init_params

__all__ = [
    "Model", "DGConfig", "forward", "init_params", "collate", "collate_chunked",
    "collate_fit", "collate_split", "random_circuit", "layered_circuit",
    "BenchParser", "build_graph", "CircuitGraph",
]
