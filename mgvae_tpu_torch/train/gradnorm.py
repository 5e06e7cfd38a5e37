"""Multi-task loss balancing: GradNorm and the EMA gradient-norm Balancer.

Counterpart of ``mgvae_tpu/train/gradnorm.py`` (the reference's
gradnorm.py: GradNorm :6-98, the averager :112-130, the Balancer :137-219).
The caller supplies the per-task gradients (``trainer_balancer.task_grads``,
three backwards from one forward) and the balancing is arithmetic on their
norms: d(w_i * L_i)/dtheta = w_i * dL_i/dtheta for a scalar w_i, so no
nested autograd is needed.

State is a dict of tensors on the trainer's device, as the JAX package
carries it as arrays; the clamps are the JAX package's.
"""
from __future__ import annotations

import dataclasses

import torch

from .step import param_leaves


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm of a gradient tree: sqrt of the sum over its leaves
    (in ``param_leaves`` order) of each leaf's sum of squares (the
    reference's per-item mean coincides with it on its reference layer)."""
    return torch.sqrt(sum(leaf.square().sum() for leaf in param_leaves(tree)))


# ---------------------------------------------------------------------------
# EMA averager (gradnorm.py:112-130): total = total * beta + value; fix likewise
# ---------------------------------------------------------------------------

def averager_init(num_tasks: int, device=None) -> dict:
    return {"total": torch.zeros(num_tasks, device=device),
            "fix": torch.zeros(num_tasks, device=device)}


def averager_update(state: dict, values: torch.Tensor, beta: float = 0.999,
                    weight: float = 1.0):
    total = state["total"] * beta + weight * values
    fix = state["fix"] * beta + weight
    avg = total / fix.clamp(min=1e-12)
    return {"total": total, "fix": fix}, avg


# ---------------------------------------------------------------------------
# Balancer (gradnorm.py:137-219)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BalancerConfig:
    weights: tuple            # per-task weight coefficients
    rescale_grads: bool = True
    total_norm: float = 1.0
    ema_decay: float = 0.999
    epsilon: float = 1e-12


def balancer_init(cfg: BalancerConfig, device=None) -> dict:
    return {"avg": averager_init(len(cfg.weights), device)}


def balancer_scales(state: dict, norms: torch.Tensor, cfg: BalancerConfig):
    """norms: [T] per-task reference-layer gradient norms. Returns
    (new_state, scales [T]): Balancer.compute_scaling_factors."""
    new_avg, avg_norms = averager_update(state["avg"], norms, cfg.ema_decay)
    w = torch.tensor(cfg.weights, dtype=torch.float32, device=norms.device)
    if cfg.rescale_grads:
        ratios = w / w.sum()
        scales = ratios * cfg.total_norm / (cfg.epsilon + avg_norms)
    else:
        scales = w
    return {"avg": new_avg}, scales


# ---------------------------------------------------------------------------
# GradNorm (gradnorm.py:6-98)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GradNormConfig:
    alpha: float
    num_tasks: int
    lr: float = 0.01
    lr_warmup: float | None = None


def gradnorm_init(cfg: GradNormConfig, device=None) -> dict:
    return {
        "w": torch.ones(cfg.num_tasks, device=device),
        "L0": torch.zeros(cfg.num_tasks, device=device),
        "has_L0": torch.zeros((), dtype=torch.bool, device=device),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def gradnorm_update(state: dict, losses: torch.Tensor, raw_norms: torch.Tensor,
                    cfg: GradNormConfig):
    """One GradNorm step.

    losses:    [T] current task losses
    raw_norms: [T] ||d L_i / d theta_ref|| (unweighted)
    Returns (new_state, task_weights [T], L_grad scalar).
    """
    L0 = torch.where(state["has_L0"], state["L0"], losses)
    w = state["w"]
    G = w * raw_norms                       # G_W_i for scalar weights
    G_bar = G.mean()
    tilde = losses / L0.clamp(min=1e-12)
    r = tilde / tilde.mean().clamp(min=1e-12)
    target = (G_bar * r.pow(cfg.alpha)).detach()
    L_grad = (G - target).abs().mean()
    # dL_grad/dw_i = sign(G_i - target_i) * raw_norms_i / T (sign(0) = 0)
    grad_w = torch.sign(G - target) * raw_norms / cfg.num_tasks
    lr = cfg.lr
    if cfg.lr_warmup is not None:
        lr = lr * ((state["step"] + 1).to(torch.float32) / cfg.lr_warmup).clamp(max=1.0)
    w = w - lr * grad_w
    w = w / w.sum() * cfg.num_tasks         # renormalise to sum T
    w = w.clamp(min=1e-8)                   # clamp negatives (gradnorm.py:94-96)
    new_state = {
        "w": w,
        "L0": L0,
        "has_L0": torch.ones((), dtype=torch.bool, device=w.device),
        "step": state["step"] + 1,
    }
    return new_state, w, L_grad
