"""The port's multi-task balancing (mgvae_tpu_torch.train.gradnorm,
trainer_balancer, trainer_gradnorm) against the JAX package's on the CPU.

* The Balancer's and GradNorm's arithmetic over a few steps, rtol 1e-6.
* ``task_grads``: three per-task gradients from ONE forward against JAX's
  three forwards with one key, on a plain batch (the fused route's
  Function), a chunked one (the step route, by the ``KERNEL_MAX_NODES``
  patch) and a giant-routed one (``kernel_fits`` patched to False), with
  JAX's negatives and dropout masks handed over: each task's gradient leaf
  within 1e-4 * max(its scale, 1). The same three gradients bit for bit
  against three separate forward + backward passes with the same draws: the
  backwards re-entered from one forward's residuals leave them as they were
  (one thread: the CPU's threaded index backward does not repeat itself).
* Two Balancer and two GradNorm steps against ``make_balancer_train_step``
  / ``make_gradnorm_train_step``: scales and weights rtol 1e-5, params
  within ``tests/test_torch_train_step.py``'s Adam bound (2 * lr a step
  everywhere; 1e-3 * lr a step where each step's gradient is past 1e-5 of
  its scale), the BN running variances atol 1e-6 and the means as written
  at the check.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgvae_tpu.data.batching import collate, collate_chunked
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.train import gradnorm as JG
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
from mgvae_tpu.train import trainer_balancer as JB
from mgvae_tpu.train import trainer_gradnorm as JGT
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import level_kernel
from mgvae_tpu_torch.train import gradnorm as PG
from mgvae_tpu_torch.train import losses as PL
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.train import trainer_balancer as PB
from mgvae_tpu_torch.train import trainer_gradnorm as PGT
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax

torch.set_num_threads(1)
KW = dict(modality="mig", dim_hidden=32, s_rounds=1, t_rounds=1, layernorm=True)
GRAD_TOL = 1e-4
LR = 1e-3


# ---- the arithmetic ----------------------------------------------------------

def _inputs(seed, steps=5, tie=False):
    rng = np.random.default_rng(seed)
    norms = rng.uniform(0.05, 3.0, (steps, 3)).astype(np.float32)
    losses = rng.uniform(0.2, 2.0, (steps, 3)).astype(np.float32)
    if tie:   # equal tasks: G == target, sign(0) = 0 in both
        norms[:] = norms[:, :1]
        losses[:] = losses[:, :1]
    return norms, losses


@pytest.mark.parametrize("rescale", [True, False])
def test_balancer_scales_match_jax(rescale):
    cfg_j = JG.BalancerConfig(weights=(1.0, 4.0, 2.0), rescale_grads=rescale, ema_decay=0.9)
    cfg_p = PG.BalancerConfig(weights=(1.0, 4.0, 2.0), rescale_grads=rescale, ema_decay=0.9)
    sj, sp = JG.balancer_init(cfg_j), PG.balancer_init(cfg_p)
    norms, _ = _inputs(0)
    for n in norms:
        sj, cj = JG.balancer_scales(sj, jnp.asarray(n), cfg_j)
        sp, cp = PG.balancer_scales(sp, torch.tensor(n), cfg_p)
        np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=1e-6)
        for k in ("total", "fix"):
            np.testing.assert_allclose(sp["avg"][k].numpy(), np.asarray(sj["avg"][k]), rtol=1e-6)


def test_averager_and_tree_norm_match_jax():
    rng = np.random.default_rng(1)
    tree = {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}
    np.testing.assert_allclose(
        float(PG.tree_norm({k: torch.tensor(v) for k, v in tree.items()})),
        float(JG.tree_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)
    sj, sp = JG.averager_init(3), PG.averager_init(3)
    for v in rng.uniform(0, 2, (6, 3)).astype(np.float32):
        sj, aj = JG.averager_update(sj, jnp.asarray(v), beta=0.8, weight=0.5)
        sp, ap = PG.averager_update(sp, torch.tensor(v), beta=0.8, weight=0.5)
        np.testing.assert_allclose(ap.numpy(), np.asarray(aj), rtol=1e-6)


@pytest.mark.parametrize("warmup, tie", [(None, False), (3.0, False), (None, True)],
                         ids=["plain", "warmup", "tie"])
def test_gradnorm_update_matches_jax(warmup, tie):
    cfg_j = JG.GradNormConfig(alpha=1.5, num_tasks=3, lr=0.05, lr_warmup=warmup)
    cfg_p = PG.GradNormConfig(alpha=1.5, num_tasks=3, lr=0.05, lr_warmup=warmup)
    sj, sp = JG.gradnorm_init(cfg_j), PG.gradnorm_init(cfg_p)
    norms, losses = _inputs(2, tie=tie)
    for n, l in zip(norms, losses):
        sj, wj, gj = JG.gradnorm_update(sj, jnp.asarray(l), jnp.asarray(n), cfg_j)
        sp, wp, gp = PG.gradnorm_update(sp, torch.tensor(l), torch.tensor(n), cfg_p)
        np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=1e-6)
        np.testing.assert_allclose(float(gp), float(gj), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(sp["L0"].numpy(), np.asarray(sj["L0"]), rtol=1e-6)
        assert int(sp["step"]) == int(sj["step"]) and bool(sp["has_L0"]) == bool(sj["has_L0"])
    if tie:
        np.testing.assert_allclose(wp.numpy(), np.ones(3), rtol=1e-6)


# ---- per-task gradients --------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(layout, seed=3):
    rng = np.random.default_rng(seed)
    graphs = [random_circuit(rng, "mig", num_inputs=4, num_gates=24 + 4 * i, num_tt_pairs=16)
              for i in range(4)]
    return collate_chunked(graphs, 2) if layout == "chunked" else collate(graphs)


def _route(layout, monkeypatch):
    """Send the port's level recurrence down the layout's route, and count
    the calls of that route's autograd Function."""
    calls = []
    if layout == "chunked":
        monkeypatch.setattr(level_kernel, "KERNEL_MAX_NODES", 64)
        fn = level_kernel._LevelScanStep
    elif layout == "giant":
        monkeypatch.setattr(P, "kernel_fits", lambda *a: False)
        fn = level_kernel._LevelScanGiant
    else:
        fn = level_kernel._LevelScan
    real = fn.apply
    monkeypatch.setattr(fn, "apply", lambda *a: (calls.append(1), real(*a))[1])
    return calls


def _jax_draws(key, hb, cfg):
    """The draws of JAX's task_grads from ``key`` (its k_neg and k_drop), as
    torch tensors."""
    _, k_neg, k_drop = jax.random.split(key, 3)
    batch = jax.tree.map(jnp.asarray, hb)
    neg = JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0], batch)
    n = hb["gate"].shape[0]
    keep = [jax.random.bernoulli(k, 0.8, (n, cfg.dim_mlp)) for k in jax.random.split(k_drop, 2)]
    return (tuple(torch.tensor(np.asarray(x)) for x in neg),
            [torch.tensor(np.asarray(k)) for k in keep])


@functools.cache
def _jax_task_grads(cfg):
    return jax.jit(functools.partial(JB.task_grads, cfg))


def _port(params, state):
    pp = params_from_jax(_np(params), device="cpu")
    for t in PS.param_leaves(pp):
        t.requires_grad_(True)
    return pp, state_from_jax(_np(state), device="cpu")


def _held(got, want, what):
    """Each leaf within GRAD_TOL * max(its scale, 1); returns the largest
    leaf scale."""
    top = 0.0
    for i, (a, c) in enumerate(zip(got, want, strict=True)):
        a, c = np.asarray(a), np.asarray(c)
        assert a.shape == c.shape and np.isfinite(a).all(), (what, i)
        scale = float(np.abs(c).max())
        err = float(np.abs(a - c).max())
        assert err <= GRAD_TOL * max(scale, 1.0), (what, i, err, scale)
        top = max(top, scale)
    return top


@pytest.mark.parametrize("layout", ["plain", "chunked", "giant"])
def test_task_grads_match_jax(layout, monkeypatch):
    jcfg, pcfg = J.DGConfig(**KW), P.DGConfig(**KW)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    hb = _batch(layout)
    key = jax.random.PRNGKey(4)
    g_j, l_j, st_j, m_j = _jax_task_grads(jcfg)(params, state, jax.tree.map(jnp.asarray, hb),
                                                key)
    calls = _route(layout, monkeypatch)
    pp, ps = _port(params, state)
    neg, keep = _jax_draws(key, hb, pcfg)
    g_p, l_p, st_p, m_p = PB.task_grads(pcfg, pp, ps, hb, None, neg_edges=neg, drop_keep=keep)
    assert len(calls) == 1      # one forward through the route's Function
    np.testing.assert_allclose([float(x) for x in l_p], [float(x) for x in l_j], rtol=1e-5)
    for k in ("tp", "fp", "tn", "fn", "n_pred"):
        assert float(m_p[k]) == float(m_j[k]), k
    for a, c in zip(jax.tree.leaves(params_to_numpy(st_p)), jax.tree.leaves(st_j)):
        np.testing.assert_allclose(a, np.asarray(c), rtol=0, atol=1e-6)
    for t in range(3):
        want = [np.asarray(x) for x in jax.tree.leaves(g_j[t])]
        got = [x.numpy() for x in g_p[t]]
        assert _held(got, want, (layout, PB.TASKS[t])) > 1e-3   # the task has a gradient
    # recon reaches neither the level recurrence nor the readout: exact zeros
    leaves = PS.param_leaves(pp)
    readout = {id(t) for t in PS.param_leaves(pp["readout_prob"])}
    assert all(not g.any() for t, g in zip(leaves, g_p[0]) if id(t) in readout)


def _separate(cfg, params, state, hb, neg, keep):
    """Each task's gradient from a forward and backward of its own."""
    leaves = PS.param_leaves(params)
    out = []
    for t in range(3):
        b = P.batch_to_device(hb, "cpu")
        hs, hf, _ = P.forward_device(params, b, cfg, P.level_counts(hb))
        loss = (PL.recon_loss(params, hs, b, neg_edges=neg)[0] if t == 0
                else PL.prob_loss(params, state, hf, b, True, drop_keep=keep)[0] if t == 1
                else PL.func_loss(hf, b))
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        out.append([torch.zeros_like(x) if y is None else y for x, y in zip(leaves, g)])
    return out


@pytest.mark.parametrize("layout", ["plain", "chunked", "giant"])
def test_one_forward_equals_three_passes_bit_for_bit(layout, monkeypatch):
    cfg = P.DGConfig(**KW)
    params, state = P.init_params(cfg, seed=5, device="cpu")
    for t in PS.param_leaves(params):
        t.requires_grad_(True)
    hb = _batch(layout, seed=6)
    calls = _route(layout, monkeypatch)
    gen = torch.Generator().manual_seed(7)
    neg = PL.sample_negative_edges(gen, hb["edge_src"].shape[0], P.batch_to_device(hb, "cpu"))
    keep = [torch.rand(hb["gate"].shape[0], cfg.dim_mlp, generator=gen) < 0.8 for _ in range(2)]
    one, _, _, _ = PB.task_grads(cfg, params, state, hb, None, neg_edges=neg, drop_keep=keep)
    three = _separate(cfg, params, state, hb, neg, keep)
    assert len(calls) == 1 + 3
    for t in range(3):
        assert all(torch.equal(a, c) for a, c in zip(one[t], three[t])), PB.TASKS[t]
        assert any(bool(g.any()) for g in one[t])


# ---- two optimizer steps ------------------------------------------------------------

def _two_steps(kind, layout, monkeypatch):
    jcfg, pcfg = J.DGConfig(**KW), P.DGConfig(**KW)
    params, state = J.init_params(jax.random.PRNGKey(1), jcfg)
    hb = _batch(layout)     # task_grads tests' batches: their JAX compiles are reused
    batch = jax.tree.map(jnp.asarray, hb)
    opt = JS.make_optimizer(LR)
    if kind == "balancer":
        cj, cp = (m.BalancerConfig(weights=(1.0, 4.0, 2.0), ema_decay=0.9) for m in (JG, PG))
        step_j = JB.make_balancer_train_step(jcfg, opt, cj)
        aux_j, aux_p = JG.balancer_init(cj), PG.balancer_init(cp)
        keys = ("scale_recon", "scale_prob", "scale_func")
    else:
        cj, cp = (m.GradNormConfig(alpha=1.5, num_tasks=3, lr=0.05) for m in (JG, PG))
        step_j = JGT.make_gradnorm_train_step(jcfg, opt, cj)
        aux_j, aux_p = JG.gradnorm_init(cj), PG.gradnorm_init(cp)
        keys = ("w_recon", "w_prob", "w_func", "l_grad")
    _route(layout, monkeypatch)
    pp, ps = _port(params, state)
    make = PB.make_balancer_train_step if kind == "balancer" else PGT.make_gradnorm_train_step
    step_p = make(pcfg, PS.make_optimizer(pp, LR), cp)
    p_j, s_j, o_j = params, state, opt.init(params)
    p0 = [np.asarray(x) for x in jax.tree.leaves(params)]
    big = None
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        g_j, _, _, _ = _jax_task_grads(jcfg)(p_j, s_j, batch, key)
        p_j, s_j, aux_j, o_j, m_j = step_j(p_j, s_j, aux_j, o_j, batch, key)
        w = [float(m_j[k]) for k in keys[:3]]
        total = [w[0] * np.asarray(a) + w[1] * np.asarray(b) + w[2] * np.asarray(c)
                 for a, b, c in zip(*(jax.tree.leaves(g) for g in g_j))]
        scale = max(float(np.abs(x).max()) for x in total)
        now = [np.abs(x) > 1e-5 * scale for x in total]
        big = now if big is None else [a & b for a, b in zip(big, now)]
        neg, keep = _jax_draws(key, hb, pcfg)
        ps, aux_p, m_p = step_p(pp, ps, aux_p, hb, None, neg_edges=neg, drop_keep=keep)
        for k in keys + ("recon_loss", "prob_loss", "func_loss", "loss"):
            np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        assert float(m_p["kl_loss"]) == float(m_j["kl_loss"]) == 0.0
        moved = 0
        for a, c, b, x0 in zip(jax.tree.leaves(params_to_numpy(pp)), jax.tree.leaves(p_j), big,
                               p0):
            d = np.abs(a - np.asarray(c))
            assert d.max() <= 2 * LR * (i + 1)
            assert (d[b] <= 1e-3 * LR * (i + 1)).all(), (i, float(d[b].max()))
            moved += int((np.abs(a - x0) > 0.5 * LR).sum())
        assert moved > 0
        # BN running statistics: the mean follows the readout's pre-BN biases,
        # whose gradient is 0 in exact arithmetic (BN cancels them) and
        # rounding noise in each package, which Adam turns into up to lr a
        # step: after step i the means may differ by momentum 0.1 * 2 * lr * i
        for bn_p, bn_j in zip(ps["readout_prob"]["bn"], s_j["readout_prob"]["bn"]):
            np.testing.assert_allclose(bn_p["mean"].numpy(), np.asarray(bn_j["mean"]), rtol=0,
                                       atol=1e-6 + 0.1 * 2 * LR * i)
            np.testing.assert_allclose(bn_p["var"].numpy(), np.asarray(bn_j["var"]), rtol=0,
                                       atol=1e-6)
    return aux_p, aux_j


@pytest.mark.parametrize("layout", ["plain", "chunked"])
def test_two_balancer_steps_match_jax(layout, monkeypatch):
    aux_p, aux_j = _two_steps("balancer", layout, monkeypatch)
    np.testing.assert_allclose(aux_p["avg"]["total"].numpy(), np.asarray(aux_j["avg"]["total"]),
                               rtol=1e-5)


@pytest.mark.parametrize("layout", ["plain", "giant"])
def test_two_gradnorm_steps_match_jax(layout, monkeypatch):
    aux_p, aux_j = _two_steps("gradnorm", layout, monkeypatch)
    np.testing.assert_allclose(aux_p["w"].numpy(), np.asarray(aux_j["w"]), rtol=1e-5)
    assert abs(float(aux_p["w"].sum()) - 3.0) < 1e-5
