"""Train and eval steps on one device.

Counterpart of the single-device path of ``mgvae_tpu/train/step.py``: one
step is the forward (struct towers, level statics, level recurrence), the
recon, prob and func losses, the backward and an Adam update, on a plain, a
chunked or a split host batch (``models/dg_ae.forward``); the losses read
the batch's top-level arrays and stay global. PyTorch runs it eagerly; on
CUDA the struct towers and the level recurrence, forward and backward, are
the hand-written kernels (autograd Functions in ``ops/struct_kernel`` and
``ops/level_kernel``).

Loss weights are [w_recon, w_prob, w_func, w_kl]; the KL term is DG_VAE's
(``cfg.variational``) and 0 otherwise. Random draws (the variational noise,
the negatives, the dropout masks) come from one ``torch.Generator`` in that
order, or are passed in.

Data parallelism (``make_train_step(..., group=)``, the JAX package's mesh
path, ``mgvae_tpu/train/step.py:158-219``): each process runs the
single-device step on its own shard, with its own draws (the generator
folded by its rank in the group, ``fold_generator``), and between
``backward()`` and the optimizer step ONE all-reduce of the gradients, the
BatchNorm running state and the metrics, each divided by the group's size:
every rank then takes the same Adam step and reports the same metrics.

Not ported: ``rehydrate`` / ``rehydrate_split``, which rebuild on the
device what the JAX package's thin host-to-device wire drops (the port
sends whole batches), and the K-step ``make_multi_step``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import dg_ae
from ..models.dg_ae import DGConfig
from ..ops.precision import matmul_precision
from ..parallel.collectives import mean_
from .losses import func_loss, kl_loss, prob_loss, recon_loss

# epoch-metric row layout, as in the JAX package
METRIC_KEYS = ("recon_loss", "prob_loss", "func_loss", "kl_loss",
               "tp", "fp", "tn", "fn", "n_pred")


def param_leaves(tree) -> list:
    """The tensors of a params tree, in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return [tree]


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """Adam over the params tree's leaves (made to require grad) with torch's
    defaults, betas (0.9, 0.999) and eps 1e-8: the update rule of
    ``optax.adam``."""
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def losses_from_forward(params, state, b: dict, hs, hf, gen, weights, cfg: DGConfig,
                        train: bool, neg_edges=None, drop_keep=None, aux=None):
    """The losses of one forward's (hs, hf, aux) on the device batch ``b``;
    returns (total, (new_state, metrics))."""
    rc, metrics = recon_loss(params, hs, b, gen, neg_edges=neg_edges,
                             mask_collisions=cfg.neg_collision_mask)
    pl, new_state = prob_loss(params, state, hf, b, train, gen, drop_keep=drop_keep)
    fl = func_loss(hf, b)
    kl = (kl_loss(aux, b) if cfg.variational
          else torch.zeros((), dtype=hs.dtype, device=hs.device))
    w = [float(x) for x in weights]
    total = w[0] * rc + w[1] * pl + w[2] * fl + w[3] * kl
    metrics = dict(metrics)
    metrics.update(recon_loss=rc.detach(), prob_loss=pl.detach(), func_loss=fl.detach(),
                   kl_loss=kl.detach(), loss=total.detach())
    return total, (new_state, metrics)


def loss_and_metrics(params, state, batch: dict, gen, weights, cfg: DGConfig, train: bool,
                     neg_edges=None, drop_keep=None, vae_eps=None):
    """Forward and losses of a host batch; returns (total, (new_state,
    metrics)). ``neg_edges``, ``drop_keep`` and ``vae_eps`` replace the
    draws from ``gen`` (the parity tests pass the JAX package's)."""
    device = params["hs_linear"]["w"].device
    b = dg_ae.batch_to_device(batch, device)
    hs, hf, aux = dg_ae.forward_device(params, b, cfg, dg_ae.level_counts(batch), gen=gen,
                                       vae_eps=vae_eps)
    return losses_from_forward(params, state, b, hs, hf, gen, weights, cfg, train,
                               neg_edges=neg_edges, drop_keep=drop_keep, aux=aux)


def fold_generator(gen, rank: int, folded: dict):
    """The draws of rank ``rank``: ``gen`` itself at rank 0 (so that one
    rank draws what the single-device step draws), else a generator on
    ``gen``'s device seeded from ``gen``'s seed and the rank, made on the
    rank's first step and kept in ``folded``: the stream counterpart of
    the JAX step's ``fold_in(rng, axis_index("dp"))``. None stays None
    (the caller passes its draws)."""
    if gen is None or rank == 0:
        return gen
    mine = folded.get("gen")
    if mine is None or mine[0] is not gen:
        seed = (gen.initial_seed() + rank * 0x9E3779B97F4A7C15) % (1 << 63)
        mine = folded["gen"] = (gen, torch.Generator(device=gen.device).manual_seed(seed))
    return mine[1]


def make_train_step(cfg: DGConfig, optimizer: torch.optim.Optimizer, group=None):
    """Returns (train_step, eval_step).

    train_step(params, state, batch, gen, weights, neg_edges=None,
    drop_keep=None, vae_eps=None) -> (state, metrics) updates ``params`` IN PLACE through
    ``optimizer`` (which must hold the params' leaves, ``make_optimizer``)
    and returns the new BatchNorm running state and the metrics (detached
    0-d tensors; reading them syncs the device).

    eval_step(params, state, batch, gen, weights, neg_edges=None,
    vae_eps=None) -> metrics runs under ``no_grad`` with the running
    statistics and no dropout.

    Both run the forward, the losses and (train_step) ``total.backward()``
    under ``matmul_precision(cfg.matmul_precision)`` and restore the flags
    after; Adam updates the fp32 master params. With
    ``cfg.compute_dtype="bfloat16"`` the forward runs in bf16
    (``models/dg_ae.forward_device``) and the gradients reach the master
    params in fp32.

    ``group``: a process group of data-parallel ranks (``parallel.mesh``),
    each with its own shard in ``batch``. The train step then averages the
    gradients, the BN running state and the metrics over the group before
    the optimizer step, in one all-reduce; the eval step averages its
    metrics. ``gen`` is folded by the rank (``fold_generator``);
    ``neg_edges``, ``drop_keep`` and ``vae_eps`` are the rank's own.
    Over a group of one rank the mean is exact: the step equals the
    single-device step bit for bit.
    """
    dg_ae.check_supported(cfg)
    dp = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    folded: dict = {}

    def train_step(params, state, batch, gen, weights, neg_edges=None, drop_keep=None,
                   vae_eps=None):
        optimizer.zero_grad(set_to_none=True)
        with matmul_precision(cfg.matmul_precision):
            total, (new_state, metrics) = loss_and_metrics(
                params, state, batch, fold_generator(gen, rank, folded), weights, cfg, True,
                neg_edges=neg_edges, drop_keep=drop_keep, vae_eps=vae_eps)
            total.backward()
        if group is not None:
            grads = [t.grad for t in param_leaves(params) if t.grad is not None]
            rest = param_leaves(new_state) + [metrics[k] for k in sorted(metrics)]
            mean_([(grads + rest, dp)], group)
        optimizer.step()
        return state | new_state, metrics

    @torch.no_grad()
    def eval_step(params, state, batch, gen, weights, neg_edges=None, vae_eps=None):
        with matmul_precision(cfg.matmul_precision):
            _, (_, metrics) = loss_and_metrics(params, state, batch,
                                               fold_generator(gen, rank, folded), weights, cfg,
                                               False, neg_edges=neg_edges, vae_eps=vae_eps)
        if group is not None:
            mean_([([metrics[k] for k in sorted(metrics)], dp)], group)
        return metrics

    return train_step, eval_step
