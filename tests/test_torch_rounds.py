"""``num_rounds > 1`` in the port (``models/dg_ae.level_loop``) against the
JAX package's general level loop (``mgvae_tpu/models/dg_ae.py:339-396``)
and the clean-room torch reference (``benchmarks/torch_reference``), and
its routing: plain torch on every device, none of the level kernels' path.

Tolerances: the JAX parity tests' (hs rtol 1e-4 / atol 1e-5, hf atol 1e-4,
losses rtol 1e-5, each gradient leaf 1e-4 * its scale floored at 2e-2 of
the largest; tests/test_model_parity.py against the reference: hf rtol 1e-4
/ atol 1e-4).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.torch_reference import ReferenceModel
import mgvae_tpu
from mgvae_tpu.data.batching import collate, collate_chunked, collate_split
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
from mgvae_tpu.utils.torch_compat import params_from_torch_state
import mgvae_tpu_torch
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.utils.params import params_from_jax, state_from_jax

torch.set_num_threads(1)
D = 16
WEIGHTS = [1.0, 4.0, 4.0, 0.0]
RTOL = 1e-5
GRAD_FLOOR = 2e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(rounds, modality="mig"):
    kw = dict(modality=modality, dim_hidden=D, s_rounds=2, t_rounds=2, layernorm=True,
              num_rounds=rounds)
    return J.DGConfig(**kw), P.DGConfig(**kw)


def _batch(layout, seed=1, modality="mig"):
    rng = np.random.default_rng(seed)
    graphs = [random_circuit(rng, modality, num_inputs=5, num_gates=20 + 6 * i,
                             num_tt_pairs=16) for i in range(4)]
    if layout == "chunked":
        return collate_chunked(graphs, 2)
    if layout == "split":
        return collate_split(graphs, 2)
    return collate(graphs)


def _spy_kernel_path(monkeypatch):
    """Record every entry of the level kernels' path."""
    calls = []
    for name in ("level_recurrence", "level_scan", "level_scan_step", "level_scan_giant",
                 "kernel_inputs"):
        real = getattr(P, name)
        monkeypatch.setattr(P, name, lambda *a, _n=name, _r=real, **k: (calls.append(_n),
                                                                         _r(*a, **k))[1])
    return calls


@pytest.mark.parametrize("rounds,layout,modality", [
    (2, "plain", "mig"), (2, "chunked", "xag"), (2, "split", "aig"), (3, "plain", "xmg"),
    (3, "chunked", "mig"),
])
def test_forward_matches_jax_general_loop(rounds, layout, modality, monkeypatch):
    calls = _spy_kernel_path(monkeypatch)
    jcfg, pcfg = _cfgs(rounds, modality)
    params, _ = J.init_params(jax.random.PRNGKey(0), jcfg)
    hb = _batch(layout, modality=modality)
    hs_j, hf_j, _ = J.forward(params, jax.tree.map(jnp.asarray, hb), jcfg)
    hs_p, hf_p, aux = P.forward(params_from_jax(_np(params), device="cpu"), hb, pcfg)
    assert calls == [] and aux == {}
    v = hb["node_valid"]
    np.testing.assert_allclose(hs_p.numpy()[v], np.asarray(hs_j)[v], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hf_p.numpy()[v], np.asarray(hf_j)[v], rtol=0, atol=1e-4)
    # more rounds move hf: the loop is not the one-round scan
    _, hf_1, _ = P.forward(params_from_jax(_np(params), device="cpu"), hb, _cfgs(1, modality)[1])
    assert float((hf_1 - hf_p).abs()[torch.as_tensor(v)].max()) > 1e-3


@pytest.mark.parametrize("rounds", [2, 3])
def test_forward_matches_the_torch_reference(rounds):
    """As tests/test_model_parity.py:85-100 holds the JAX package."""
    rng = np.random.default_rng(21)
    g = random_circuit(rng, "xag", num_inputs=4, num_gates=28)
    ref = ReferenceModel("xag", dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=False,
                         num_rounds=rounds)
    ref.eval()
    with torch.no_grad():
        _, hf_t = ref(torch.from_numpy(g.gate).long(), torch.from_numpy(g.edge_index),
                      torch.from_numpy(g.forward_level).long())
    cfg = P.DGConfig(modality="xag", dim_hidden=32, s_rounds=2, t_rounds=2, num_rounds=rounds)
    params, _ = params_from_torch_state(ref.state_dict(), J.DGConfig(**vars(cfg)))
    batch = collate([g])
    _, hf_p, _ = P.forward(params_from_jax(_np(params), device="cpu"), batch, cfg)
    n = g.num_nodes
    np.testing.assert_allclose(hf_p.numpy()[batch["node_inv"]][:n], hf_t.numpy(), rtol=1e-4,
                               atol=1e-4)


@functools.cache
def _jax_value_and_grad(cfg):
    fn = functools.partial(JS.loss_and_metrics, cfg=cfg, train=True)
    return jax.jit(jax.value_and_grad(fn, has_aux=True))


@pytest.mark.parametrize("rounds,layout,aggr", [(2, "plain", "onehot"), (2, "split", "scatter"),
                                               (3, "chunked", "scatter")])
def test_gradients_match_jax(rounds, layout, aggr, monkeypatch):
    """On these split and chunked batches the general loop's default level
    aggregation in JAX ("onehot") gives NaN gradients: it takes exp of the
    padding edges' raw scores before masking them (its one-round scan masks
    first). There the reference is its "scatter" aggregation, which masks
    first, as the port does."""
    calls = _spy_kernel_path(monkeypatch)
    jcfg, pcfg = _cfgs(rounds)
    jcfg = dataclasses.replace(jcfg, level_aggr=aggr)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    hb = _batch(layout, seed=2)
    key = jax.random.PRNGKey(6)
    (tot_j, (_, m_j)), g_j = _jax_value_and_grad(jcfg)(
        params, state, jax.tree.map(jnp.asarray, hb), key, jnp.asarray(WEIGHTS))
    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    leaves = PS.param_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    _, k_neg, k_drop = jax.random.split(key, 3)
    neg = JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0], jax.tree.map(jnp.asarray, hb))
    keep = [torch.tensor(np.asarray(jax.random.bernoulli(k, 0.8, (hb["gate"].shape[0], 32))))
            for k in jax.random.split(k_drop, 2)]
    tot_p, (_, m_p) = PS.loss_and_metrics(
        pp, ps, hb, None, WEIGHTS, pcfg, True,
        neg_edges=tuple(torch.tensor(np.asarray(x)) for x in neg), drop_keep=keep)
    tot_p.backward()
    assert calls == []
    np.testing.assert_allclose(tot_p.item(), float(tot_j), rtol=RTOL)
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=RTOL, err_msg=k)
    g_p = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves]
    g_jl = [np.asarray(x) for x in jax.tree.leaves(g_j)]
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(g_j)]
    scale = max(float(np.abs(g).max()) for g in g_jl)
    for name, a, c in zip(names, g_p, g_jl):
        err, leaf = float(np.abs(a - c).max()), float(np.abs(c).max())
        assert np.isfinite(a).all()
        assert err <= 1e-4 * max(leaf, GRAD_FLOOR * scale), (name, err, leaf, scale)
    # the hidden side of the GRU is live with more than one round
    assert float(np.abs(pp["experts"]["w_hh"].grad.numpy()).max()) > 0


@pytest.mark.parametrize("layout,want", [
    ("plain", ["level_recurrence", "kernel_inputs", "level_scan"]),
    ("chunked", ["level_recurrence", "kernel_inputs"] + ["level_scan"] * 2)])
def test_one_round_routes_as_before(layout, want, monkeypatch):
    calls = _spy_kernel_path(monkeypatch)
    _, pcfg = _cfgs(1)
    params, _ = P.init_params(pcfg, device="cpu")
    P.forward(params, _batch(layout), pcfg)
    assert calls == want


def test_model_num_rounds_matches_jax_model():
    kw = dict(modality="mig", dim_hidden=D, s_rounds=2, t_rounds=2, layernorm=True,
              num_rounds=2)
    jmodel = mgvae_tpu.Model(**kw)
    pmodel = mgvae_tpu_torch.Model(**kw, params=params_from_jax(_np(jmodel.params),
                                                                device="cpu"), device="cpu")
    rng = np.random.default_rng(3)
    graphs = [random_circuit(rng, "mig", num_inputs=5, num_gates=20 + 4 * i) for i in range(3)]
    for (hs_p, hf_p), (hs_j, hf_j) in zip(pmodel.encode_many(graphs, batch_size=2),
                                          jmodel.encode_many(graphs, batch_size=2)):
        np.testing.assert_allclose(hs_p, np.asarray(hs_j), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(hf_p, np.asarray(hf_j), rtol=0, atol=1e-4)
    hs_l, hf_l = pmodel(graphs)
    _, hf_jl = jmodel(graphs)
    np.testing.assert_allclose(hf_l.numpy(), np.asarray(hf_jl), rtol=0, atol=1e-4)
