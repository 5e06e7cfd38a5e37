"""Parameter initializers and the small layers, with torch numerics.

Counterpart of ``mgvae_tpu/ops/init.py``. Weights are stored ``[in, out]``
as in the JAX package (applies are ``x @ w + b``), so moving a JAX params
tree into the port is a plain copy (``utils/params.params_from_jax``).

Init bounds are torch's defaults:
  - ``nn.Linear``: weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
  - ``nn.GRU``: every weight and bias U(-1/sqrt(hidden), 1/sqrt(hidden)).
  - ``nn.LayerNorm`` / ``nn.BatchNorm1d``: weight 1, bias 0.

Init draws on the CPU from an explicit ``torch.Generator``; callers move
the finished tree to their device.
"""
from __future__ import annotations

import math

import torch


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=gen)


def linear_init(gen: torch.Generator, dim_in: int, dim_out: int) -> dict:
    bound = 1.0 / math.sqrt(dim_in)
    return {"w": _uniform(gen, (dim_in, dim_out), bound),
            "b": _uniform(gen, (dim_out,), bound)}


def linear_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def gru_cell_init(gen: torch.Generator, dim_in: int, dim_hidden: int) -> dict:
    """torch ``nn.GRU`` init, transposed to [in, 3H], gate order (r, z, n),
    with both biases kept apart (b_hn sits inside ``r * (h W_hn + b_hn)``)."""
    bound = 1.0 / math.sqrt(dim_hidden)
    return {
        "w_ih": _uniform(gen, (dim_in, 3 * dim_hidden), bound),
        "w_hh": _uniform(gen, (dim_hidden, 3 * dim_hidden), bound),
        "b_ih": _uniform(gen, (3 * dim_hidden,), bound),
        "b_hh": _uniform(gen, (3 * dim_hidden,), bound),
    }


def gru_cell_apply(p: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step with torch gate order and semantics.

    r = sigmoid(x Wir + b_ir + h Whr + b_hr)
    z = sigmoid(x Wiz + b_iz + h Whz + b_hz)
    n = tanh(x Win + b_in + r * (h Whn + b_hn))
    h' = (1 - z) * n + z * h
    """
    gi = x @ p["w_ih"] + p["b_ih"]
    gh = h @ p["w_hh"] + p["b_hh"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) rounded once to x's dtype, as XLA rounds it. torch's CPU
    rsqrt of bf16 rounds twice outside its vectorised loop (a 0-d tensor, a
    loop's tail), which sends one value in eight to the farther neighbour
    (0.17578125 -> 2.375, not 2.390625); a loss that z-scores before an L1
    kink turns that one ulp into a flipped sign. A no-op cast in fp32."""
    return torch.rsqrt(x.float()).to(x.dtype)


def layernorm_init(dim: int) -> dict:
    return {"w": torch.ones(dim), "b": torch.zeros(dim)}


def layernorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch ``nn.LayerNorm`` over the last axis (biased variance, eps inside
    the square root)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * rsqrt(var + eps) * p["w"] + p["b"]
