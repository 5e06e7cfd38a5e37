"""The port's training step (mgvae_tpu_torch.train.step) against the JAX
package's: whole-model gradients of ``loss_and_metrics`` against
``jax.grad`` (the XLA path on the CPU) for the four modalities, and one full
``train_step`` against ``make_train_step(cfg, make_optimizer(lr),
mesh=None)``, on plain batches and on chunked (the step route of the level
recurrence) and split ones. JAX's negatives and dropout masks are rebuilt from its key
(``step.py:142``) and handed to the port.

Tolerances: losses and metrics rtol 1e-5; each gradient leaf 1e-4 * its
largest entry, floored at 2e-2 of the largest entry over all leaves (leaves
whose gradient is 0 in exact arithmetic, such as the readout biases that
BatchNorm cancels, carry rounding noise of about 1e-6 of that); BatchNorm
running statistics atol 1e-6. Adam's first step
is lr * g / (|g| + 1e-8), so where |g| is tiny a gradient difference far
below the gradient tolerance moves a parameter by up to lr: updated params
agree within 2 * lr everywhere and within 1e-3 * lr where
|g_jax| > 1e-5 * scale.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgvae_tpu.data.batching import collate, collate_chunked, collate_split
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
import mgvae_tpu_torch
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import level_kernel
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax

torch.set_num_threads(1)
WEIGHTS = [1.0, 4.0, 4.0, 0.0]    # stage-3 weights (train.py)
RTOL = 1e-5
GRAD_FLOOR = 2e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(modality, seed=1):
    kw = dict(modality=modality, dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=True)
    jcfg, pcfg = J.DGConfig(**kw), P.DGConfig(**kw)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    hb = collate([random_circuit(rng, modality, num_inputs=6, num_gates=40, num_tt_pairs=24)
                  for _ in range(3)])
    return jcfg, pcfg, params, state, hb


def _jax_draws(key, hb, dim_mlp):
    """The negatives and dropout keep masks JAX's loss_and_metrics draws
    from ``key``, as torch tensors."""
    _, k_neg, k_drop = jax.random.split(key, 3)
    batch = jax.tree.map(jnp.asarray, hb)
    neg = JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0], batch)
    n = hb["gate"].shape[0]
    keep = [jax.random.bernoulli(k, 0.8, (n, dim_mlp)) for k in jax.random.split(k_drop, 2)]
    return (tuple(torch.tensor(np.asarray(x)) for x in neg),
            [torch.tensor(np.asarray(k)) for k in keep])


@functools.cache
def _jax_value_and_grad(cfg):
    fn = functools.partial(JS.loss_and_metrics, cfg=cfg, train=True)
    return jax.jit(jax.value_and_grad(fn, has_aux=True))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("modality", ["aig", "mig", "xag", "xmg"])
def test_model_gradients_match_jax(modality):
    jcfg, pcfg, params, state, hb = _setup(modality)
    key = jax.random.PRNGKey(5)
    (tot_j, (st_j, m_j)), g_j = _jax_value_and_grad(jcfg)(
        params, state, jax.tree.map(jnp.asarray, hb), key, jnp.asarray(WEIGHTS))

    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    leaves = PS.param_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    neg, keep = _jax_draws(key, hb, pcfg.dim_mlp)
    tot_p, (st_p, m_p) = PS.loss_and_metrics(pp, ps, hb, None, WEIGHTS, pcfg, True,
                                             neg_edges=neg, drop_keep=keep)
    tot_p.backward()
    np.testing.assert_allclose(tot_p.item(), float(tot_j), rtol=RTOL)
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=RTOL, err_msg=k)
    for a, c in zip(_leaves(params_to_numpy(st_p)), _leaves(st_j)):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
    # same tree order on both sides (dict keys sorted)
    # leaves the loss does not reach (w_hh: the recurrence runs with h = 0)
    # get no grad in torch and zeros in JAX
    g_p = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves]
    g_jl = _leaves(g_j)
    assert [g.shape for g in g_p] == [g.shape for g in g_jl]
    scale = max(float(np.abs(g).max()) for g in g_jl)
    assert all(np.isfinite(g).all() for g in g_p)
    for i, (a, c) in enumerate(zip(g_p, g_jl)):
        err, leaf = float(np.abs(a - c).max()), float(np.abs(c).max())
        assert err <= 1e-4 * max(leaf, GRAD_FLOOR * scale), (i, err, leaf, scale)


def test_train_step_matches_jax_make_train_step():
    lr = 1e-3
    jcfg, pcfg, params, state, hb = _setup("mig", seed=2)
    key = jax.random.PRNGKey(8)
    batch = jax.tree.map(jnp.asarray, hb)
    w = jnp.asarray(WEIGHTS)
    _, g_j = _jax_value_and_grad(jcfg)(params, state, batch, key, w)
    opt = JS.make_optimizer(lr)
    j_step, j_eval = JS.make_train_step(jcfg, opt, mesh=None, donate=False)
    p1_j, s1_j, _, m_j = j_step(params, state, opt.init(params), batch, key, w)

    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    optimizer = PS.make_optimizer(pp, lr)
    p_step, _ = PS.make_train_step(pcfg, optimizer)
    before = PS.param_leaves(pp)
    neg, keep = _jax_draws(key, hb, pcfg.dim_mlp)
    s1_p, m_p = p_step(pp, ps, hb, None, WEIGHTS, neg_edges=neg, drop_keep=keep)
    assert all(a is b for a, b in zip(PS.param_leaves(pp), before))   # updated in place
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=RTOL, err_msg=k)
    for a, c in zip(_leaves(params_to_numpy(s1_p)), _leaves(s1_j)):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)

    g = _leaves(g_j)
    scale = max(float(np.abs(x).max()) for x in g)
    p0 = _leaves(params)
    moved = 0
    for a, c, gj, x0 in zip(_leaves(params_to_numpy(pp)), _leaves(p1_j), g, p0):
        d = np.abs(a - c)
        assert d.max() <= 2 * lr
        big = np.abs(gj) > 1e-5 * scale
        assert (d[big] <= 1e-3 * lr).all()
        moved += int((np.abs(a - x0) > 0.5 * lr).sum())
    assert moved > 0

    # evaluation after the step, from JAX's updated params (the Adam
    # tolerance above would blur it): running statistics, no dropout
    m_je = j_eval(p1_j, s1_j, batch, key, w)
    neg_e, _ = _jax_draws(key, hb, pcfg.dim_mlp)
    with torch.no_grad():
        _, (_, m_pe) = PS.loss_and_metrics(params_from_jax(_np(p1_j), device="cpu"), s1_p, hb, None,
                                           WEIGHTS, pcfg, False, neg_edges=neg_e)
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_pe[k]), float(m_je[k]), rtol=RTOL, err_msg=k)


def test_train_and_eval_step_with_generator_on_cpu():
    """The step's own draws: metrics finite, the CPU route takes no kernel,
    lr settable, eval changes nothing, and the TF32 flags after the steps
    are the caller's (each step runs under the config's matmul precision
    and restores them)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    cfg = P.DGConfig(modality="xmg", dim_hidden=16, s_rounds=1, t_rounds=1)
    params, state = P.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    hb = mgvae_tpu_torch.collate([mgvae_tpu_torch.random_circuit(rng, "xmg", num_inputs=5,
                                                                 num_gates=30)
                                  for _ in range(2)])
    optimizer = PS.make_optimizer(params, 1e-2)
    train_step, eval_step = PS.make_train_step(cfg, optimizer)
    gen = torch.Generator().manual_seed(0)
    level_kernel.launches = level_kernel.bwd_launches = 0
    for _ in range(3):
        state, m = train_step(params, state, hb, gen, WEIGHTS)
        assert set(PS.METRIC_KEYS) <= set(m)
        assert all(np.isfinite(float(m[k])) for k in PS.METRIC_KEYS)
    assert level_kernel.launches == level_kernel.bwd_launches == 0
    PS.set_lr(optimizer, 5e-3)
    assert all(g["lr"] == 5e-3 for g in optimizer.param_groups)
    snap = [t.detach().clone() for t in PS.param_leaves(params)]
    m = eval_step(params, state, hb, gen, WEIGHTS)
    assert np.isfinite(float(m["loss"]))
    assert all(torch.equal(a, b) for a, b in zip(snap, PS.param_leaves(params)))
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags


# ---- chunked and split batches ----------------------------------------------

def _large_setup(layout, seed=3):
    kw = dict(modality="mig", dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=True)
    jcfg, pcfg = J.DGConfig(**kw), P.DGConfig(**kw)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    graphs = [random_circuit(rng, "mig", num_inputs=6, num_gates=20 + 8 * i, num_tt_pairs=16)
              for i in range(5)]
    hb = collate_chunked(graphs, 2) if layout == "chunked" else collate_split(graphs, 2)
    return jcfg, pcfg, params, state, hb


def _spy_step_route(monkeypatch):
    """Send chunked batches down the step route (their chunks are too small
    to fail ``kernel_fits`` by themselves) and count the route's calls."""
    calls = []
    real = P.level_scan_step
    monkeypatch.setattr(level_kernel, "KERNEL_MAX_NODES", 64)
    monkeypatch.setattr(P, "level_scan_step", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    return calls


@pytest.mark.parametrize("layout", ["chunked", "split"])
def test_model_gradients_on_large_batches_match_jax(layout, monkeypatch):
    """Whole-model gradients on a chunked batch, the level recurrence by the
    step route (its autograd Function with the plain versions), and on a
    split batch, against jax.grad."""
    jcfg, pcfg, params, state, hb = _large_setup(layout)
    steps = _spy_step_route(monkeypatch)
    key = jax.random.PRNGKey(6)
    (tot_j, (st_j, m_j)), g_j = _jax_value_and_grad(jcfg)(
        params, state, jax.tree.map(jnp.asarray, hb), key, jnp.asarray(WEIGHTS))

    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    leaves = PS.param_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    neg, keep = _jax_draws(key, hb, pcfg.dim_mlp)
    assert hb["node_valid"][neg[0].numpy()].all() and hb["node_valid"][neg[1].numpy()].all()
    tot_p, (st_p, m_p) = PS.loss_and_metrics(pp, ps, hb, None, WEIGHTS, pcfg, True,
                                             neg_edges=neg, drop_keep=keep)
    tot_p.backward()
    assert len(steps) == (1 if layout == "chunked" else 0)
    np.testing.assert_allclose(tot_p.item(), float(tot_j), rtol=RTOL)
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=RTOL, err_msg=k)
    for a, c in zip(_leaves(params_to_numpy(st_p)), _leaves(st_j)):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
    g_p = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves]
    g_jl = _leaves(g_j)
    scale = max(float(np.abs(g).max()) for g in g_jl)
    for i, (a, c) in enumerate(zip(g_p, g_jl)):
        err, leaf = float(np.abs(a - c).max()), float(np.abs(c).max())
        assert np.isfinite(a).all()
        assert err <= 1e-4 * max(leaf, GRAD_FLOOR * scale), (i, err, leaf, scale)


def test_train_step_on_chunked_batch_matches_jax_make_train_step(monkeypatch):
    lr = 1e-3
    jcfg, pcfg, params, state, hb = _large_setup("chunked", seed=4)
    steps = _spy_step_route(monkeypatch)
    key = jax.random.PRNGKey(9)
    batch = jax.tree.map(jnp.asarray, hb)
    w = jnp.asarray(WEIGHTS)
    _, g_j = _jax_value_and_grad(jcfg)(params, state, batch, key, w)
    opt = JS.make_optimizer(lr)
    j_step, _ = JS.make_train_step(jcfg, opt, mesh=None, donate=False)
    p1_j, s1_j, _, m_j = j_step(params, state, opt.init(params), batch, key, w)

    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    p_step, p_eval = PS.make_train_step(pcfg, PS.make_optimizer(pp, lr))
    neg, keep = _jax_draws(key, hb, pcfg.dim_mlp)
    s1_p, m_p = p_step(pp, ps, hb, None, WEIGHTS, neg_edges=neg, drop_keep=keep)
    assert len(steps) == 1
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=RTOL, err_msg=k)
    for a, c in zip(_leaves(params_to_numpy(s1_p)), _leaves(s1_j)):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
    g = _leaves(g_j)
    scale = max(float(np.abs(x).max()) for x in g)
    for a, c, gj in zip(_leaves(params_to_numpy(pp)), _leaves(p1_j), g):
        d = np.abs(a - c)
        assert d.max() <= 2 * lr
        assert (d[np.abs(gj) > 1e-5 * scale] <= 1e-3 * lr).all()
    # the step's own draws on the chunked batch: negatives stay in the valid runs
    m = p_eval(pp, s1_p, hb, torch.Generator().manual_seed(0), WEIGHTS)
    assert all(np.isfinite(float(m[k])) for k in PS.METRIC_KEYS)
