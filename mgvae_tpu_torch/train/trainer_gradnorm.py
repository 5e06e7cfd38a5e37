"""GradNormTrainer: learned multi-task loss weights (GradNorm, Chen et al.).

Counterpart of ``mgvae_tpu/train/trainer_gradnorm.py`` (the reference's
gradnorm.py:6-98 as a working trainer). Each step:
  1. three per-task gradients from one forward
     (``trainer_balancer.task_grads``);
  2. the raw per-task norms on the shared ``hs_linear`` layer, the
     reference's ``ref_layer``;
  3. ``gradnorm_update`` moves the task weights toward equal, rate-balanced
     gradient norms (``train/gradnorm``);
  4. the optimizer applies sum_i w_i g_i (no fourth backward).

Data parallelism: the per-task gradients are averaged over the group before
the norms and the weights (``trainer_balancer.make_task_step``), so every
rank learns the same task weights.
"""
from __future__ import annotations

import time

import torch

from ..models.dg_ae import DGConfig
from ..utils.logger import AverageMeter
from .gradnorm import GradNormConfig, gradnorm_init, gradnorm_update
from .trainer import Trainer
from .trainer_balancer import TASKS, make_task_step


def make_gradnorm_train_step(cfg: DGConfig, optimizer: torch.optim.Optimizer,
                             gn_cfg: GradNormConfig, group=None):
    """The GradNorm-weighted train step: step(params, state, gn_state, batch,
    gen, ...) -> (state, gn_state, metrics), with ``l_grad`` and the weights
    as ``w_recon`` / ``w_prob`` / ``w_func``."""

    def weigh(gn_state, losses, norms):
        gn_state, w, l_grad = gradnorm_update(gn_state, losses, norms, gn_cfg)
        return gn_state, w, {"l_grad": l_grad, **{f"w_{t}": w[i] for i, t in enumerate(TASKS)}}

    return make_task_step(cfg, optimizer, weigh, group)


class GradNormTrainer(Trainer):
    """Trainer whose task weights are learned by GradNorm instead of the
    static rc_prob_func_weight (which seeds nothing here: GradNorm starts
    from uniform weights, gradnorm.py:23). Its ``train`` runs the train
    phase alone, as in the JAX package."""

    def __init__(self, *args, alpha: float = 1.5, gn_lr: float = 0.025,
                 gn_lr_warmup: float | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.gn_cfg = GradNormConfig(alpha=alpha, num_tasks=3, lr=gn_lr,
                                     lr_warmup=gn_lr_warmup)
        self.gn_state = gradnorm_init(self.gn_cfg, self.device)
        self._gn_step = make_gradnorm_train_step(self.model_cfg, self.optimizer, self.gn_cfg,
                                                 group=self.group)

    @property
    def task_weights(self):
        return [float(x) for x in self.gn_state["w"]]

    def train(self, num_epoch: int, train_dataset, val_dataset):
        meters = {k: AverageMeter() for k in ("recon", "prob", "func", "l_grad", "time")}
        for epoch in range(num_epoch):
            for k in meters:
                meters[k] = AverageMeter()
            t0 = time.time()
            # metrics stay on the device; one read-back per epoch
            pending = []
            for batch in self._iter_batches(train_dataset):
                self.state, self.gn_state, m = self._gn_step(
                    self.params, self.state, self.gn_state, batch, self._gen)
                pending.append(torch.stack(
                    [m["recon_loss"], m["prob_loss"], m["func_loss"], m["l_grad"]]))
                meters["time"].update(time.time() - t0)
                t0 = time.time()
            if pending:
                for rc, pl, fl, lg in torch.stack(pending).cpu().numpy():
                    meters["recon"].update(float(rc))
                    meters["prob"].update(float(pl))
                    meters["func"].update(float(fl))
                    meters["l_grad"].update(float(lg))
            if self.is_chief:
                w = self.task_weights
                self.logger.write(
                    "gradnorm| Epoch: {:}/{:} |Recon: {:.4f} |Prob: {:.4f} |Func: {:.4f} "
                    "|W: [{:.3f} {:.3f} {:.3f}] |Lgrad: {:.4f}|Net: {:.2f}s\n".format(
                        epoch, num_epoch, meters["recon"].avg, meters["prob"].avg,
                        meters["func"].avg, w[0], w[1], w[2], meters["l_grad"].avg,
                        meters["time"].avg,
                    )
                )
            self.model_epoch += 1
        out = {k: v.avg for k, v in meters.items()}
        out["task_weights"] = self.task_weights
        return out
