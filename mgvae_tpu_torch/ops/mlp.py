"""The readout MLP, with masked BatchNorm1d, ReLU and Dropout, with torch
semantics.

Counterpart of ``mgvae_tpu/ops/mlp.py`` as ``readout_prob`` calls it: three
linear layers, dim_in -> dim_hidden -> dim_hidden -> 1, the first two each
followed by BatchNorm1d, ReLU and Dropout with p = 0.2.

Batches are padded to static shapes, so the batch statistics are taken over
the valid rows only (``valid``). Trainable params and running statistics are
separate trees: ``mlp_apply`` returns the new running state instead of
updating it in place, so the optimizer only ever sees the params.

Dropout draws its keep mask from an explicit ``torch.Generator``, or takes
the mask itself (``drop_keep``): the parity tests hand in the masks the JAX
package drew.
"""
from __future__ import annotations

import torch

from .init import linear_apply, linear_init, rsqrt

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
NUM_LAYER = 3
P_DROP = 0.2


def batchnorm_init(dim: int):
    params = {"w": torch.ones(dim), "b": torch.zeros(dim)}
    state = {"mean": torch.zeros(dim), "var": torch.ones(dim)}
    return params, state


def batchnorm_apply(params, state, x, valid=None, train: bool = True):
    """torch BatchNorm1d over the valid rows (all rows when ``valid`` is
    None): normalises with the biased batch variance, tracks the unbiased
    one (n / (n - 1)) with momentum 0.1. Returns (y, new_state); the new
    state is detached."""
    if train:
        v = (x.new_ones(x.shape[0]) if valid is None else valid.to(x.dtype))[:, None]
        n = v.sum().clamp(min=1.0)
        mean = (x * v).sum(dim=0) / n
        var = ((x - mean).square() * v).sum(dim=0) / n
        unbiased = var * n / (n - 1.0).clamp(min=1.0)
        new_state = {
            "mean": ((1 - BN_MOMENTUM) * state["mean"] + BN_MOMENTUM * mean).detach(),
            "var": ((1 - BN_MOMENTUM) * state["var"] + BN_MOMENTUM * unbiased).detach(),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * rsqrt(var + BN_EPS) * params["w"] + params["b"]
    return y, new_state


def dropout(x, p: float, train: bool, gen: torch.Generator | None = None, keep=None):
    """Inverted dropout: kept entries scaled by 1 / (1 - p). ``keep`` is an
    explicit bool mask of x's shape; without it each entry is kept with
    probability 1 - p, drawn on the generator's device."""
    if not train or p <= 0.0:
        return x
    if keep is None:
        if gen is None:
            raise ValueError("dropout in train mode needs a generator or a keep mask")
        keep = (torch.rand(x.shape, generator=gen, device=gen.device) < 1.0 - p).to(x.device)
    return torch.where(keep, x / (1.0 - p), 0.0)


def mlp_init(gen: torch.Generator, dim_in: int, dim_hidden: int):
    """(params, state) with the JAX package's tree: {"layers": [...], "bn":
    [...]} and {"bn": [...]}."""
    dims = [dim_in] + [dim_hidden] * (NUM_LAYER - 1) + [1]
    params = {"layers": [linear_init(gen, dims[i], dims[i + 1]) for i in range(NUM_LAYER)]}
    bns = [batchnorm_init(dim_hidden) for _ in range(NUM_LAYER - 1)]
    params["bn"] = [p for p, _ in bns]
    return params, {"bn": [s for _, s in bns]}


def mlp_apply(params, state, x, *, valid=None, train: bool = True,
              gen: torch.Generator | None = None, drop_keep=None):
    """Returns (out [M, 1], new_state). ``drop_keep``: optional list of one
    keep mask per hidden layer, used instead of drawing from ``gen``."""
    layers = params["layers"]
    new_bn = []
    for i in range(len(layers) - 1):
        x = linear_apply(layers[i], x)
        x, s = batchnorm_apply(params["bn"][i], state["bn"][i], x, valid=valid, train=train)
        new_bn.append(s)
        x = torch.relu(x)
        x = dropout(x, P_DROP, train, gen, None if drop_keep is None else drop_keep[i])
    return linear_apply(layers[-1], x), {"bn": new_bn}
