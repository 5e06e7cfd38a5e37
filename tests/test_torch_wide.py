"""Models wider than the kernels (D > 128) against the JAX package: the
forward and the gradients.

Past D = 128 every kernel gate of the JAX package fails and it runs its
XLA paths: the struct towers as XLA and the level recurrence as
``_level_scan_fast``. The port routes by the same width: the eager struct
towers and ``dg_ae.level_scan_fast`` (plain torch), on every device and
every batch layout (plain, chunked, split, one graph collated alone). Here
at D = 160 and 256, on each layout at both widths: hs and hf against JAX's
``forward``, and on one layout per width pairing the loss, its metrics, the
BatchNorm state and every gradient leaf against ``jax.grad``, all from the
same params (``params_from_jax``) and draws; ``Model.encode_many``; and
spies that no kernel wrapper is called past D = 128 while D = 128 keeps its
kernel route. tests/test_torch_wide_train.py holds the Adam step, bf16, the
``Trainer`` and the CLI at these widths.

Tolerances: as tests/test_model_parity.py:41-42 (hs rtol 1e-4 / atol 1e-5,
hf atol 1e-4); gradients within 1e-4 of each leaf's scale, floored at 2e-2
of the largest, as tests/test_torch_train_step.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgvae_tpu
from mgvae_tpu.data.batching import collate, collate_chunked, collate_split
from mgvae_tpu.data.synthetic import layered_circuit, random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
import mgvae_tpu_torch
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.models import encoder
from mgvae_tpu_torch.ops import level_kernel
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax

torch.set_num_threads(1)
WEIGHTS = [1.0, 4.0, 2.0, 0.0]
GRAD_FLOOR = 2e-2
# each layout at both widths; the gradients on one layout per width pairing
GRADIENT_CASES = [(160, "plain"), (256, "chunked"), (160, "split"), (256, "single")]
FORWARD_CASES = [(256, "plain"), (160, "chunked"), (256, "split"), (160, "single")]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _kw(D, **more):
    return dict(modality="mig", dim_hidden=D, s_rounds=2, t_rounds=2, layernorm=True, **more)


def _batch(layout, seed=3):
    rng = np.random.default_rng(seed)
    if layout == "single":
        return collate([layered_circuit(rng, "mig", width=6, depth=10, num_tt_pairs=16)])
    graphs = [random_circuit(rng, "mig", num_inputs=5, num_gates=14 + 6 * i, num_tt_pairs=12)
              for i in range(4)]
    if layout == "chunked":
        return collate_chunked(graphs, 2)
    if layout == "split":
        return collate_split(graphs, 2)
    return collate(graphs)


def _draws(key, hb, dim_mlp):
    """The negatives and dropout keep masks JAX's loss_and_metrics draws
    from ``key``, as torch tensors."""
    _, k_neg, k_drop = jax.random.split(key, 3)
    neg = JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0], jax.tree.map(jnp.asarray, hb))
    n = hb["gate"].shape[0]
    keep = [jax.random.bernoulli(k, 0.8, (n, dim_mlp)) for k in jax.random.split(k_drop, 2)]
    return (tuple(torch.tensor(np.asarray(x)) for x in neg),
            [torch.tensor(np.asarray(k)) for k in keep])


@functools.cache
def _jax_forward_and_grad(cfg):
    """hs, hf and the loss's value and gradients, in one compiled call."""
    def fn(params, state, batch, key, w):
        hs, hf, _ = J.forward(params, batch, cfg)
        return (hs, hf), jax.value_and_grad(JS.loss_and_metrics, has_aux=True)(
            params, state, batch, key, w, cfg, True)
    return jax.jit(fn)


def _spy(monkeypatch):
    """Record every call of a kernel wrapper (the CPU runs their plain
    versions, the card their kernels): the struct towers, the level scans
    of all three routes, the single-level step and the list builder."""
    calls = []

    def wrap(owner, name):
        real = getattr(owner, name)
        monkeypatch.setattr(owner, name, lambda *a, **k: (calls.append(name), real(*a, **k))[1])

    wrap(encoder, "struct_towers")
    for name in ("level_scan", "level_scan_giant", "level_step", "level_lists"):
        wrap(P, name)
    wrap(level_kernel, "level_scan_step")
    return calls


def _grads_close(g_p, g_j, tol, what):
    scale = max(float(np.abs(g).max()) for g in g_j)
    worst = 0.0
    for i, (a, c) in enumerate(zip(g_p, g_j, strict=True)):
        assert np.isfinite(a).all(), (what, i)
        err, leaf = float(np.abs(a - c).max()), float(np.abs(c).max())
        worst = max(worst, err / (tol * max(leaf, GRAD_FLOOR * scale)))
        assert err <= tol * max(leaf, GRAD_FLOOR * scale), (what, i, err, leaf, scale)
    print(f"{what}: worst leaf at {worst:.3f} of its bound")


@pytest.mark.parametrize("D,layout", GRADIENT_CASES)
def test_wide_forward_and_gradients_match_jax(D, layout, monkeypatch):
    """hs, hf, the losses, the BatchNorm state and every gradient leaf of
    the port against the JAX package at D > 128, with no kernel wrapper
    called."""
    calls = _spy(monkeypatch)
    jcfg, pcfg = J.DGConfig(**_kw(D)), P.DGConfig(**_kw(D))
    params, state = J.init_params(jax.random.PRNGKey(D), jcfg)
    hb = _batch(layout)
    key = jax.random.PRNGKey(5)
    (hs_j, hf_j), ((tot_j, (st_j, m_j)), g_j) = _jax_forward_and_grad(jcfg)(
        params, state, jax.tree.map(jnp.asarray, hb), key, jnp.asarray(WEIGHTS))

    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    with torch.no_grad():
        hs_p, hf_p, _ = P.forward(pp, hb, pcfg)
    valid = np.asarray(hb["node_valid"])
    _embeddings_close(hs_p, hf_p, hs_j, hf_j, hb)

    leaves = PS.param_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    neg, keep = _draws(key, hb, pcfg.dim_mlp)
    tot_p, (st_p, m_p) = PS.loss_and_metrics(pp, ps, hb, None, WEIGHTS, pcfg, True,
                                             neg_edges=neg, drop_keep=keep)
    tot_p.backward()
    assert calls == []
    np.testing.assert_allclose(tot_p.item(), float(tot_j), rtol=1e-5)
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    for a, c in zip(_leaves(params_to_numpy(st_p)), _leaves(st_j)):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
    g_p = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves]
    _grads_close(g_p, _leaves(g_j), 1e-4, f"D={D} {layout} gradients")


def _embeddings_close(hs_p, hf_p, hs_j, hf_j, hb):
    valid = np.asarray(hb["node_valid"])
    np.testing.assert_allclose(hs_p.numpy()[valid], np.asarray(hs_j)[valid], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hf_p.numpy()[valid], np.asarray(hf_j)[valid], rtol=0, atol=1e-4)


@pytest.mark.parametrize("D,layout", FORWARD_CASES)
def test_wide_forward_matches_jax(D, layout, monkeypatch):
    """hs and hf at D > 128 on the layout and width pairs the gradient test
    leaves out, with no kernel wrapper called."""
    calls = _spy(monkeypatch)
    jcfg, pcfg = J.DGConfig(**_kw(D)), P.DGConfig(**_kw(D))
    params, _ = J.init_params(jax.random.PRNGKey(D + 1), jcfg)
    hb = _batch(layout, seed=5)
    hs_j, hf_j, _ = jax.jit(lambda p, b: J.forward(p, b, jcfg))(params, jax.tree.map(jnp.asarray,
                                                                                     hb))
    with torch.no_grad():
        hs_p, hf_p, _ = P.forward(params_from_jax(_np(params), device="cpu"), hb, pcfg)
    assert calls == []
    _embeddings_close(hs_p, hf_p, hs_j, hf_j, hb)


@pytest.mark.parametrize("D,want", [(128, ["struct_towers", "level_scan"]), (136, [])])
def test_the_route_is_chosen_by_width(D, want, monkeypatch):
    """D = 128 keeps the kernel route (the struct towers' and the fused
    scan's wrappers, here their plain versions); one step wider takes the
    plain route, which calls neither, and agrees with the JAX package."""
    calls = _spy(monkeypatch)
    jcfg, pcfg = J.DGConfig(**_kw(D)), P.DGConfig(**_kw(D))
    params, _ = J.init_params(jax.random.PRNGKey(3), jcfg)
    hb = _batch("plain", seed=9)
    hs_j, hf_j, _ = jax.jit(lambda p, b: J.forward(p, b, jcfg))(params, jax.tree.map(jnp.asarray,
                                                                                     hb))
    with torch.no_grad():
        hs_p, hf_p, _ = P.forward(params_from_jax(_np(params), device="cpu"), hb, pcfg)
    assert calls == want
    _embeddings_close(hs_p, hf_p, hs_j, hf_j, hb)


def test_model_encode_many_at_d160_matches_jax():
    kw = _kw(160)
    jmodel = mgvae_tpu.Model(**kw)
    pmodel = mgvae_tpu_torch.Model(**kw, params=params_from_jax(_np(jmodel.params),
                                                                device="cpu"), device="cpu")
    rng = np.random.default_rng(2)
    graphs = [random_circuit(rng, "mig", num_inputs=5, num_gates=16 + 4 * i) for i in range(3)]
    for (hs_p, hf_p), (hs_j, hf_j) in zip(pmodel.encode_many(graphs, batch_size=2),
                                          jmodel.encode_many(graphs, batch_size=2), strict=True):
        np.testing.assert_allclose(hs_p, np.asarray(hs_j), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(hf_p, np.asarray(hf_j), rtol=0, atol=1e-4)


