"""Differentiable collectives over a process group: the port's counterpart of
shard_map's all_gather / psum and their transposes.

The convention that keeps every gradient whole (the JAX package gets it
from shard_map's replication tracking, ``mgvae_tpu/parallel/sharded.py``):

  * each member of a model-parallel group computes the replicated part of
    the model (what reads whole tensors only: hs_linear, the losses) in
    full, and scales its loss by 1 / mp;
  * a collective's backward SUMS the cotangents over the group: the
    all_gather's backward is the sum of the gathered tensor's cotangents,
    of which each member keeps its own slice, and the all-reduce sum's
    backward is an all-reduce sum;
  * after ``backward()`` one all-reduce sum over the group adds the
    members' gradients (``mean_``, which the train step runs over dp and mp
    together).

A replicated tensor's cotangent on one member is then its share: the
replicated compute's 1 / mp, and what that member's own slice read of it.
The sum over the members is the whole gradient, equal on every member.

All collectives here are ``dist.all_gather`` into a list and
``dist.all_reduce``, which NCCL and gloo both run on torch 2.11 and 2.13,
gloo on the card's tensors too (several processes sharing one card run
gloo; ``chip_smoke.py`` ``[parallel]`` (c) checks that torch 2.11's takes
them; gloo copies them through the host itself).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# collectives launched, for the per-step counts of chip_smoke.py
launches = 0


def _reduce_(buf: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """buf reduced over the group, in place."""
    global launches
    dist.all_reduce(buf, op=op, group=group)
    launches += 1
    return buf


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x reduced over the group into a new tensor on x's device."""
    return _reduce_(x.detach().clone(), group, op)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The members' x concatenated on dim 0, in rank order of the group."""
    global launches
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    launches += 1
    return torch.cat(parts)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        start = dist.get_rank(ctx.group) * ctx.rows
        return _all_reduce(g, ctx.group)[start:start + ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every member's x (same shape on each) concatenated on dim 0, in the
    group's rank order; backward: the sum of the cotangents over the group,
    this member's rows."""
    return _AllGather.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group; backward: the sum of the cotangents."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group, not differentiated."""
    return _all_reduce(x, group, op=dist.ReduceOp.MAX)


def mean_(parts: list, group) -> None:
    """In place: the tensors of each (tensors, divisor) part summed over
    ``group`` and divided by the part's divisor, with ONE all-reduce of all
    of them flattened (in fp32), one division per part and one fused copy
    back (each tensor keeps its dtype)."""
    tensors = [t for ts, _ in parts for t in ts]
    flat = _reduce_(torch.cat([t.detach().reshape(-1).float() for t in tensors]), group)
    at = 0
    for ts, div in parts:
        n = sum(t.numel() for t in ts)
        flat[at:at + n].div_(div)
        at += n
    views = [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]
    with torch.no_grad():
        torch._foreach_copy_(tensors, views)
