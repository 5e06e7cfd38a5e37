"""BalancerTrainer: gradient-norm-rescaled multi-task loss weighting.

Counterpart of ``mgvae_tpu/train/trainer_balancer.py`` (the reference's
trainer_balancer.py, stale there, rebuilt as a working variant): three
per-task gradients (recon, prob, func) of one step, their norms on the
shared ``hs_linear`` layer drive the Balancer's EMA rescaling
(``train/gradnorm``), and the optimizer applies the scaled sum of the three
gradients; no fourth backward.

One forward, three backwards: ``task_grads`` runs the forward once and
takes each task's gradient with ``torch.autograd.grad(..., retain_graph=)``
from the same saved residuals, so on the card the struct towers' backward
kernel runs three times and the level recurrence's twice (recon does not
reach hf) on one forward's residuals. The JAX package runs the forward once
per task with the same key, so its three tasks see the same draws; one
forward draws them once, from the generator in the port's order (the
variational noise, the negatives, the dropout masks). The BatchNorm
running state is that forward's.

Data parallelism (``group=``): the three gradient sets, the BN state, the
losses and the metrics are averaged over the group in ONE all-reduce BEFORE
the norms, as the JAX step ``pmean``s each task's gradient first, so that
every rank computes the same scales.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..models import dg_ae
from ..models.dg_ae import DGConfig
from ..ops.precision import matmul_precision
from ..parallel.collectives import mean_
from ..utils.logger import AverageMeter
from .gradnorm import BalancerConfig, balancer_init, balancer_scales, tree_norm
from .losses import func_loss, prob_loss, recon_loss
from .step import fold_generator, param_leaves
from .trainer import Trainer

TASKS = ("recon", "prob", "func")


def task_grads(cfg: DGConfig, params, state, batch: dict, gen, neg_edges=None, drop_keep=None,
               vae_eps=None):
    """Three per-task gradients (recon / prob / func) from ONE forward of the
    host batch: the counterpart of the JAX package's ``task_grads``.

    Returns (grads, losses, new_state, metrics): ``grads`` three lists of
    tensors in ``param_leaves(params)`` order (a leaf the task does not reach
    gets zeros, as ``jax.grad`` gives zeros), ``losses`` the three detached
    0-d losses, ``new_state`` the BN running state of the forward, and
    ``metrics`` the recon loss's counts. The params' leaves must require
    grad. ``neg_edges``, ``drop_keep`` and ``vae_eps`` replace the draws
    from ``gen`` (the parity tests pass the JAX package's). As in the JAX
    package the negatives are not masked for collisions."""
    leaves = param_leaves(params)
    b = dg_ae.batch_to_device(batch, params["hs_linear"]["w"].device)
    hs, hf, _ = dg_ae.forward_device(params, b, cfg, dg_ae.level_counts(batch), gen=gen,
                                     vae_eps=vae_eps)
    rc, metrics = recon_loss(params, hs, b, gen, neg_edges=neg_edges)
    pl, new_state = prob_loss(params, state, hf, b, True, gen, drop_keep=drop_keep)
    fl = func_loss(hf, b)
    grads = []
    for i, loss in enumerate((rc, pl, fl)):
        g = torch.autograd.grad(loss, leaves, retain_graph=i < 2, allow_unused=True)
        grads.append([torch.zeros_like(t) if x is None else x for t, x in zip(leaves, g)])
    return grads, [rc.detach(), pl.detach(), fl.detach()], new_state, metrics


def make_task_step(cfg: DGConfig, optimizer: torch.optim.Optimizer, weigh, group=None):
    """A train step that weighs the three task gradients by ``weigh(aux,
    losses [3], norms [3]) -> (aux, w [3], extra metrics)``, where ``norms``
    are the tasks' gradient norms on ``hs_linear``: the Balancer's and
    GradNorm's shared body.

    step(params, state, aux, batch, gen, neg_edges=None, drop_keep=None,
    vae_eps=None) -> (state, aux, metrics) sets every leaf's ``.grad`` to
    sum_i w_i g_i (zeros included: Adam then decays every leaf's moments,
    as optax does) and takes ``optimizer.step()``, all under
    ``matmul_precision(cfg.matmul_precision)``; ``params`` are updated in
    place. Metrics: the recon counts, the three losses, ``kl_loss`` 0 (for
    DG_VAE too, as in the JAX package) and ``loss`` = sum_i w_i L_i."""
    dg_ae.check_supported(cfg)
    dp = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    folded: dict = {}

    def step(params, state, aux, batch, gen, neg_edges=None, drop_keep=None, vae_eps=None):
        leaves = param_leaves(params)
        ref = {id(t) for t in param_leaves(params["hs_linear"])}
        on_ref = [i for i, t in enumerate(leaves) if id(t) in ref]
        with matmul_precision(cfg.matmul_precision):
            grads, losses, new_state, m = task_grads(
                cfg, params, state, batch, fold_generator(gen, rank, folded),
                neg_edges=neg_edges, drop_keep=drop_keep, vae_eps=vae_eps)
            losses = torch.stack(losses)
            if group is not None:
                rest = [losses] + param_leaves(new_state) + [m[k] for k in sorted(m)]
                mean_([([x for g in grads for x in g] + rest, dp)], group)
            norms = torch.stack([tree_norm([g[i] for i in on_ref]) for g in grads])
            aux, w, extra = weigh(aux, losses, norms)
            with torch.no_grad():
                for t, g0, g1, g2 in zip(leaves, *grads):
                    t.grad = w[0] * g0 + w[1] * g1 + w[2] * g2
            optimizer.step()
        metrics = dict(m)
        metrics.update(recon_loss=losses[0], prob_loss=losses[1], func_loss=losses[2],
                       kl_loss=torch.zeros((), device=losses.device),
                       loss=w[0] * losses[0] + w[1] * losses[1] + w[2] * losses[2], **extra)
        return state | new_state, aux, metrics

    return step


def make_balancer_train_step(cfg: DGConfig, optimizer: torch.optim.Optimizer,
                             bal_cfg: BalancerConfig, group=None):
    """The Balancer-weighted train step: step(params, state, bal_state,
    batch, gen, ...) -> (state, bal_state, metrics), with the scales as
    ``scale_recon`` / ``scale_prob`` / ``scale_func``. With ``group`` the
    per-task gradients are averaged before the norms, so the scales are those
    of the global gradient and the same on every rank."""

    def weigh(bal_state, losses, norms):
        bal_state, scales = balancer_scales(bal_state, norms, bal_cfg)
        return bal_state, scales, {f"scale_{t}": scales[i] for i, t in enumerate(TASKS)}

    return make_task_step(cfg, optimizer, weigh, group)


class BalancerTrainer(Trainer):
    """Trainer whose loss weighting is driven by the Balancer instead of the
    static rc_prob_func_weight. Its ``train`` runs the train phase alone:
    no val phase, no checkpoint, no lr decay, no capture, as in the JAX
    package."""

    def __init__(self, *args, rescale_grads=True, total_norm=1.0, ema_decay=0.999, **kwargs):
        super().__init__(*args, **kwargs)
        self.bal_cfg = BalancerConfig(
            weights=tuple(self.rc_prob_func_weight),
            rescale_grads=rescale_grads,
            total_norm=total_norm,
            ema_decay=ema_decay,
        )
        self.bal_state = balancer_init(self.bal_cfg, self.device)
        self._bal_step = make_balancer_train_step(self.model_cfg, self.optimizer, self.bal_cfg,
                                                  group=self.group)

    def train(self, num_epoch: int, train_dataset, val_dataset):
        meters = {k: AverageMeter() for k in ("recon", "prob", "func", "time")}
        for epoch in range(num_epoch):
            meters = {k: AverageMeter() for k in ("recon", "prob", "func", "time")}
            t0 = time.time()
            # metrics stay on the device; one read-back per epoch
            pending = []
            for batch in self._iter_batches(train_dataset):
                self.state, self.bal_state, m = self._bal_step(
                    self.params, self.state, self.bal_state, batch, self._gen)
                pending.append(torch.stack([m["recon_loss"], m["prob_loss"], m["func_loss"]]))
                meters["time"].update(time.time() - t0)
                t0 = time.time()
            if pending:
                for rc, pl, fl in torch.stack(pending).cpu().numpy():
                    meters["recon"].update(float(rc))
                    meters["prob"].update(float(pl))
                    meters["func"].update(float(fl))
            if self.is_chief:
                self.logger.write(
                    "balancer| Epoch: {:}/{:} |Recon: {:.4f} |Prob: {:.4f} |Func: {:.4f}|Net: {:.2f}s\n".format(
                        epoch, num_epoch, meters["recon"].avg, meters["prob"].avg,
                        meters["func"].avg, meters["time"].avg,
                    )
                )
            self.model_epoch += 1
        return {k: v.avg for k, v in meters.items()}
