"""The precision modes: the fp32 matmul precision of a scope (full fp32 or
TF32), and the helpers of the kernels' value types (fp32 or bf16).

Counterpart of ``jax.default_matmul_precision`` as the JAX package uses it
(``mgvae_tpu/models/dg_ae.py:225``, and the kernels' ``_prec_ctx``,
``mgvae_tpu/ops/pallas/level_kernel.py:133-140``). ``DGConfig.matmul_precision``
names the mode; ``models/dg_ae.forward_device`` and ``train/step`` run under
it, and every autograd Function of the port saves ``current_precision()`` in
its forward and re-enters it in its backward, so that a backward called
outside the forward's scope still runs in the forward's mode.

The names are the JAX package's: "default" and "high" mean TF32 for fp32
products on the card (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` set), "highest" and "float32" full fp32
(both cleared). On the CPU both are exact fp32. The hand-written kernels
compute in fp32 FMA whatever the mode; it reaches the products that PyTorch
runs around them.
"""
from __future__ import annotations

import contextlib

import torch

TF32 = ("default", "high")
FP32 = ("highest", "float32")


def uses_tf32(name: str) -> bool:
    """Whether the mode ``name`` runs fp32 products in TF32; raises
    ``ValueError`` for a name that is none of the modes."""
    if name in TF32:
        return True
    if name in FP32:
        return False
    raise ValueError(f"matmul_precision must be one of {TF32 + FP32}, got {name!r}")


@contextlib.contextmanager
def matmul_precision(name: str):
    """Run the scope's fp32 products in the mode ``name``; the flags are
    restored on exit, also when the scope raises."""
    tf32 = uses_tf32(name)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def current_precision() -> str:
    """The mode of the current scope: "default" (TF32 matmuls) or "highest"."""
    return "default" if torch.backends.cuda.matmul.allow_tf32 else "highest"


def rounder(dtype: torch.dtype):
    """x -> x rounded to the value type ``dtype`` and back to fp32: the
    identity for fp32, a bf16 rounding point otherwise (the plain versions
    compute in fp32 between the rounding points of the JAX package's
    kernels, as the CUDA kernels do)."""
    if dtype == torch.float32:
        return lambda x: x
    return lambda x: x.to(dtype).float()


def bf16_flag(t: torch.Tensor) -> int:
    """The C entries' value-type flag of ``t``: 1 for bf16 values, 0 for fp32."""
    return int(t.dtype == torch.bfloat16)
