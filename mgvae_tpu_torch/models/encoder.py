"""Structural encoder: the DirectMultiGCN source/target towers.

Counterpart of ``direct_multigcn_apply`` in ``mgvae_tpu/models/encoder.py``.
Per round, a sum-aggregation of linearly transformed neighbor states
(AggConv) feeds a one-step GRU together with the node's input feature, then
optionally LayerNorm; then the same again over reversed edges. Each tower
has ONE LayerNorm instance, shared by both directions and applied after
every half-round.

When both towers run the same number of rounds, the batch carries the
blocked tables (``fa_src`` / ``ra_src``) and the width is one the kernels
take (D <= ``struct_kernel.MAX_DIM``), as in the JAX package's kernel route
(``mgvae_tpu/models/dg_ae.py:287-289`` and the width term of
``struct_kernel_fits``), the towers run together through
``ops.struct_kernel.struct_towers``: the CUDA kernels on the card, their
plain version on the CPU. Otherwise they run here, eagerly and one after
the other, as in the reference model and the JAX package's XLA towers; at
D > 128 that holds on every device.

AggConv uses sum_j (W x_j + b) == W (sum_j x_j) + deg * b, so the linear
runs once per node. The eager neighbor sum is an ``index_add_`` over the
valid edges (atomics on CUDA: the order of the sum changes from run to
run); the kernels sum in a fixed order.
"""
from __future__ import annotations

import torch

from ..ops.init import gru_cell_apply, gru_cell_init, layernorm_apply, layernorm_init, linear_init
from ..ops.struct_kernel import MAX_DIM as KERNEL_MAX_DIM
from ..ops.struct_kernel import struct_towers


def multigcn_init(gen: torch.Generator, dim_hidden: int, dim_feature: int, layernorm: bool) -> dict:
    p = {
        "aggr": linear_init(gen, dim_hidden, dim_hidden),
        "update": gru_cell_init(gen, dim_hidden + dim_feature, dim_hidden),
        "aggr_r": linear_init(gen, dim_hidden, dim_hidden),
        "update_r": gru_cell_init(gen, dim_hidden + dim_feature, dim_hidden),
    }
    if layernorm:
        p["ln"] = layernorm_init(dim_hidden)
    return p


def direct_multigcn_init(gen: torch.Generator, dim_hidden: int, dim_feature: int,
                         layernorm: bool) -> dict:
    return {
        "source": multigcn_init(gen, dim_hidden, dim_feature, layernorm),
        "target": multigcn_init(gen, dim_hidden, dim_feature, layernorm),
    }


def _neighbor_sum(state, src, dst, ev):
    """out[v] = sum of state[u] over valid edges u -> v, summed in fp32 and
    rounded once to the state's dtype, as the JAX package's blocked one-hot
    products sum (a no-op in fp32)."""
    out = torch.zeros(state.shape, dtype=torch.float32, device=state.device)
    return out.index_add_(0, dst, (state[src] * ev).float()).to(state.dtype)


def multigcn_apply(params, x_feat, batch, num_rounds: int, layernorm: bool) -> torch.Tensor:
    """One tower; ``batch`` needs edge_src / edge_dst / edge_valid and
    deg_in / deg_out as tensors. Returns [N, D]."""
    n = x_feat.shape[0]
    dim = params["aggr"]["w"].shape[1]
    state = x_feat.new_ones((n, dim))
    src, dst = batch["edge_src"], batch["edge_dst"]
    ev = batch["edge_valid"].to(x_feat.dtype)[:, None]
    # the batch's degrees are f32: in bf16 a mixed product would promote the
    # tower to f32 (the JAX package casts them likewise)
    deg_in = batch["deg_in"].to(x_feat.dtype)[:, None]
    deg_out = batch["deg_out"].to(x_feat.dtype)[:, None]

    def half_round(state, aggr_p, gru_p, nbr, deg):
        msg = nbr @ aggr_p["w"] + deg * aggr_p["b"]
        state = gru_cell_apply(gru_p, torch.cat([msg, x_feat], dim=-1), state)
        if layernorm:
            state = layernorm_apply(params["ln"], state)
        return state

    for _ in range(num_rounds):
        state = half_round(state, params["aggr"], params["update"],
                           _neighbor_sum(state, src, dst, ev), deg_in)
        # reverse direction: messages flow dst -> src
        state = half_round(state, params["aggr_r"], params["update_r"],
                           _neighbor_sum(state, dst, src, ev), deg_out)
    return state


def direct_multigcn_apply(params, x_feat, batch, s_rounds: int, t_rounds: int,
                          layernorm: bool):
    """Both towers: returns (s, t), each [N, D]. The route is chosen from
    the rounds, the tables and the width before any kernel is called."""
    dim = params["source"]["aggr"]["w"].shape[1]
    if (s_rounds == t_rounds and "fa_src" in batch and "ra_src" in batch
            and dim <= KERNEL_MAX_DIM):
        return struct_towers(params, x_feat, batch, s_rounds, layernorm)
    s = multigcn_apply(params["source"], x_feat, batch, s_rounds, layernorm)
    t = multigcn_apply(params["target"], x_feat, batch, t_rounds, layernorm)
    return s, t
