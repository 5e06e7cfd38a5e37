"""The AE model's struct encoder in the port (``models/gcn``,
``DGConfig(struct_encoder="gcn")``, ``--model AE``) against the JAX
package's ``mgvae_tpu/models/gcn.py``: the degree-normalised conv, the 2-
and single-layer encoders, ``DirectedGAE``, the numpy metrics (a byte-for-
byte copy), and the AE model's forward, gradients and one Adam step on
plain, chunked and split batches. The gcn path never reaches
``ops/struct_kernel``.

Tolerances: the JAX parity tests' (hs rtol 1e-4 / atol 1e-5, hf atol 1e-4,
losses rtol 1e-5, each gradient leaf 1e-4 * its scale floored at 2e-2 of
the largest, the Adam bounds of tests/test_torch_train_step.py); the
encoders alone rtol 1e-5 / atol 1e-6.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgvae_tpu.data.batching import collate, collate_chunked, collate_split
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.models import gcn as JG
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
from mgvae_tpu.utils import metrics as jmetrics
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.models import gcn as PG
from mgvae_tpu_torch.ops import struct_kernel
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.utils import checkpoint as pckpt
from mgvae_tpu_torch.utils import metrics as pmetrics
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 16
KW = dict(modality="mig", dim_hidden=D, s_rounds=2, t_rounds=2, layernorm=True,
          struct_encoder="gcn")
WEIGHTS = [1.0, 4.0, 4.0, 0.0]
RTOL = 1e-5
GRAD_FLOOR = 2e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _edges(seed=0, n=30, e=70):
    """Random edges over n nodes with some invalid ones, and a row with no
    edges at all (node n - 1)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 1, e).astype(np.int32)
    dst = rng.integers(0, n - 1, e).astype(np.int32)
    valid = rng.random(e) < 0.85
    x = rng.normal(size=(n, 6)).astype(np.float32)
    return x, src, dst, valid


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a.detach()), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("alpha,beta,self_loops", [(1.0, 0.0, True), (0.5, 0.5, True),
                                                   (0.5, 1.0, False)])
def test_conv_matches_jax(alpha, beta, self_loops):
    x, src, dst, valid = _edges()
    p = JG.directed_gcn_conv_init(jax.random.PRNGKey(1), 6, D)
    out_j = JG.directed_gcn_conv_apply(p, jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                                       jnp.asarray(valid), alpha, beta, self_loops)
    pp = PG._to(_np(p), "cpu")
    out_p = PG.directed_gcn_conv_apply(pp, torch.tensor(x), torch.tensor(src), torch.tensor(dst),
                                       torch.tensor(valid), alpha, beta, self_loops)
    assert np.isfinite(out_p.numpy()).all()
    _close(out_p, out_j)
    if not self_loops:   # the edge-less row: no in-degree, its output is 0
        assert (out_p[-1] == 0).all()


def test_encoders_match_jax():
    x, src, dst, valid = _edges(1)
    y = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    j_args = [jnp.asarray(a) for a in (x, y, src, dst, valid)]
    p_args = [torch.tensor(a) for a in (x, y, src, dst, valid)]
    p2 = JG.directed_gcn_encoder_init(jax.random.PRNGKey(2), 6, D, D)
    for a, b in zip(JG.directed_gcn_encoder_apply(p2, *j_args),
                    PG.directed_gcn_encoder_apply(PG._to(_np(p2), "cpu"), *p_args)):
        _close(b, a)
    p1 = JG.single_layer_directed_encoder_init(jax.random.PRNGKey(3), 6, D)
    for a, b in zip(JG.single_layer_directed_encoder_apply(p1, *j_args, 0.5, 0.5),
                    PG.single_layer_directed_encoder_apply(PG._to(_np(p1), "cpu"), *p_args,
                                                           0.5, 0.5)):
        _close(b, a)


def test_init_shapes_match_jax():
    jp = JG.directed_gcn_encoder_init(jax.random.PRNGKey(0), 6, D, 2 * D)
    pp = PG.directed_gcn_encoder_init(torch.Generator().manual_seed(0), 6, D, 2 * D)
    assert (jax.tree.map(np.shape, jp)
            == jax.tree.map(np.shape, PG._to(pp, "cpu"), is_leaf=torch.is_tensor))
    sp = PG.single_layer_directed_encoder_init(torch.Generator().manual_seed(0), 6, D)
    assert sp["source"]["lin"]["w"].shape == (6, D)


def _gae_case():
    rng = np.random.default_rng(3)
    g = random_circuit(rng, "mig", num_inputs=4, num_gates=40)
    neg = rng.integers(0, g.num_nodes, size=(2, g.num_edges))
    jgae = JG.DirectedGAE(dim_in=6, dim_hidden=D, dim_out=D, seed=4)
    pgae = PG.DirectedGAE(dim_in=6, dim_hidden=D, dim_out=D, params=_np(jgae.params),
                          device="cpu")
    return g, neg, jgae, pgae


def test_directed_gae_matches_jax():
    g, neg, jgae, pgae = _gae_case()
    x = np.asarray(g.x, np.float32)
    s_j, t_j = jgae.encode(jnp.asarray(x), jnp.asarray(x), g.edge_index[0], g.edge_index[1])
    s_p, t_p = pgae.encode(x, x, g.edge_index[0], g.edge_index[1])
    _close(s_p, s_j)
    _close(t_p, t_j)
    _close(pgae.decode(s_p, t_p, g.edge_index[0], g.edge_index[1]),
           jgae.decode(s_j, t_j, g.edge_index[0], g.edge_index[1]))
    _close(pgae.decode(s_p, t_p, neg[0], neg[1], sigmoid=False),
           jgae.decode(s_j, t_j, neg[0], neg[1], sigmoid=False), atol=1e-5)
    loss_j, pred_j, gt_j = jgae.recon_loss(s_j, t_j, jnp.asarray(g.edge_index), jnp.asarray(neg))
    loss_p, pred_p, gt_p = pgae.recon_loss(s_p, t_p, g.edge_index, neg)
    np.testing.assert_allclose(loss_p.item(), float(loss_j), rtol=RTOL)
    np.testing.assert_array_equal(pred_p.numpy(), np.asarray(pred_j))
    np.testing.assert_array_equal(gt_p.numpy(), np.asarray(gt_j))
    auc_j, ap_j = jgae.test(s_j, t_j, g.edge_index, neg)
    auc_p, ap_p = pgae.test(s_p, t_p, g.edge_index, neg)
    np.testing.assert_allclose([auc_p, ap_p], [auc_j, ap_j], rtol=1e-6)
    c = pmetrics.confusion_counts(pred_p.numpy(), gt_p.numpy())
    assert c == jmetrics.confusion_counts(np.asarray(pred_j), np.asarray(gt_j))


def test_directed_gae_recon_loss_finite_at_saturation():
    """tests/test_aux_components.py's saturation case: confident embeddings
    push sigmoid to exactly 0 or 1; the loss and its gradient stay finite."""
    g, neg, _, pgae = _gae_case()
    x = np.asarray(g.x, np.float32)
    s, t = pgae.encode(x, x, g.edge_index[0], g.edge_index[1])
    s_sat = (s.detach() * 100.0).requires_grad_(True)
    loss, _, _ = pgae.recon_loss(s_sat, t.detach() * 100.0, g.edge_index, neg)
    loss.backward()
    assert np.isfinite(loss.item()) and torch.isfinite(s_sat.grad).all()


def test_metrics_module_is_a_byte_copy():
    with open(os.path.join(REPO, "mgvae_tpu", "utils", "metrics.py"), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "mgvae_tpu_torch", "utils", "metrics.py"), "rb") as f:
        assert f.read() == ref
    rng = np.random.default_rng(0)
    y = rng.random(50) < 0.4
    score = np.round(rng.random(50), 1)          # ties
    for name in ("roc_auc_score", "average_precision_score"):
        assert getattr(pmetrics, name)(y, score) == getattr(jmetrics, name)(y, score)


def _batch(layout, seed=1):
    rng = np.random.default_rng(seed)
    graphs = [random_circuit(rng, "mig", num_inputs=5, num_gates=20 + 6 * i, num_tt_pairs=16)
              for i in range(4)]
    if layout == "chunked":
        return collate_chunked(graphs, 2)
    if layout == "split":
        return collate_split(graphs, 2)
    return collate(graphs)


def _no_struct_kernel(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("the gcn path reached ops/struct_kernel")

    for name in ("struct_towers", "struct_core", "struct_inputs", "struct_tables"):
        monkeypatch.setattr(struct_kernel, name, forbidden)
    monkeypatch.setattr(P, "direct_multigcn_apply", forbidden)


@pytest.mark.parametrize("layout", ["plain", "chunked", "split"])
def test_ae_forward_matches_jax(layout, monkeypatch):
    _no_struct_kernel(monkeypatch)
    jcfg, pcfg = J.DGConfig(**KW), P.DGConfig(**KW)
    params, _ = J.init_params(jax.random.PRNGKey(0), jcfg)
    hb = _batch(layout)
    hs_j, hf_j, _ = J.forward(params, jax.tree.map(jnp.asarray, hb), jcfg)
    hs_p, hf_p, aux = P.forward(params_from_jax(_np(params), device="cpu"), hb, pcfg)
    v = hb["node_valid"]
    assert aux == {}
    np.testing.assert_allclose(hs_p.numpy()[v], np.asarray(hs_j)[v], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hf_p.numpy()[v], np.asarray(hf_j)[v], rtol=0, atol=1e-4)


@functools.cache
def _jax_value_and_grad(cfg):
    fn = functools.partial(JS.loss_and_metrics, cfg=cfg, train=True)
    return jax.jit(jax.value_and_grad(fn, has_aux=True))


def _jax_draws(key, hb, dim_mlp):
    _, k_neg, k_drop = jax.random.split(key, 3)
    neg = JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0], jax.tree.map(jnp.asarray, hb))
    n = hb["gate"].shape[0]
    keep = [jax.random.bernoulli(k, 0.8, (n, dim_mlp)) for k in jax.random.split(k_drop, 2)]
    return (tuple(torch.tensor(np.asarray(x)) for x in neg),
            [torch.tensor(np.asarray(k)) for k in keep])


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("layout", ["plain", "chunked"])
def test_ae_gradients_match_jax(layout, monkeypatch):
    _no_struct_kernel(monkeypatch)
    jcfg, pcfg = J.DGConfig(**KW), P.DGConfig(**KW)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    hb = _batch(layout, seed=2)
    key = jax.random.PRNGKey(6)
    (tot_j, (_, m_j)), g_j = _jax_value_and_grad(jcfg)(
        params, state, jax.tree.map(jnp.asarray, hb), key, jnp.asarray(WEIGHTS))
    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    leaves = PS.param_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    neg, keep = _jax_draws(key, hb, pcfg.dim_mlp)
    tot_p, (_, m_p) = PS.loss_and_metrics(pp, ps, hb, None, WEIGHTS, pcfg, True,
                                          neg_edges=neg, drop_keep=keep)
    tot_p.backward()
    np.testing.assert_allclose(tot_p.item(), float(tot_j), rtol=RTOL)
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=RTOL, err_msg=k)
    g_p = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves]
    g_jl = _leaves(g_j)
    assert [g.shape for g in g_p] == [g.shape for g in g_jl]
    scale = max(float(np.abs(g).max()) for g in g_jl)
    for i, (a, c) in enumerate(zip(g_p, g_jl)):
        err, leaf = float(np.abs(a - c).max()), float(np.abs(c).max())
        assert np.isfinite(a).all()
        assert err <= 1e-4 * max(leaf, GRAD_FLOOR * scale), (i, err, leaf, scale)
    assert float(np.abs(pp["struct"]["source"]["conv1"]["lin"]["w"].grad.numpy()).max()) > 0


def test_ae_train_step_matches_jax_make_train_step(monkeypatch, tmp_path):
    _no_struct_kernel(monkeypatch)
    lr = 1e-3
    jcfg, pcfg = J.DGConfig(**KW), P.DGConfig(**KW)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    hb = _batch("plain", seed=3)
    key = jax.random.PRNGKey(9)
    batch, w = jax.tree.map(jnp.asarray, hb), jnp.asarray(WEIGHTS)
    _, g_j = _jax_value_and_grad(jcfg)(params, state, batch, key, w)
    opt = JS.make_optimizer(lr)
    j_step, _ = JS.make_train_step(jcfg, opt, mesh=None, donate=False)
    p1_j, _, _, m_j = j_step(params, state, opt.init(params), batch, key, w)
    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    p_step, _ = PS.make_train_step(pcfg, PS.make_optimizer(pp, lr))
    neg, keep = _jax_draws(key, hb, pcfg.dim_mlp)
    s1_p, m_p = p_step(pp, ps, hb, None, WEIGHTS, neg_edges=neg, drop_keep=keep)
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=RTOL, err_msg=k)
    g = _leaves(g_j)
    scale = max(float(np.abs(x).max()) for x in g)
    for a, c, gj in zip(_leaves(params_to_numpy(pp)), _leaves(p1_j), g):
        d = np.abs(a - c)
        assert d.max() <= 2 * lr
        assert (d[np.abs(gj) > 1e-5 * scale] <= 1e-3 * lr).all()
    # the AE tree bridges, saves and loads
    pckpt.save_checkpoint(str(tmp_path / "ae.pth"), 1, pp, s1_p, None, lr)
    fresh, fresh_state = P.init_params(pcfg, seed=7, device="cpu")
    epoch, _, loaded, _ = pckpt.load_checkpoint(str(tmp_path / "ae.pth"), fresh, fresh_state,
                                                None, "cpu")
    assert epoch == 1 and "conv2" in loaded["struct"]["target"]
    assert all(torch.equal(x, y) for x, y in zip(PS.param_leaves(pp),
                                                 PS.param_leaves(loaded)))
    # a multigcn checkpoint keeps the gcn template's struct tree
    dg, _ = P.init_params(P.DGConfig(**{**KW, "struct_encoder": "multigcn"}), device="cpu")
    merged = pckpt.tolerant_merge(fresh, dg)
    assert merged["struct"] is not dg["struct"]
    assert torch.equal(merged["struct"]["source"]["conv1"]["lin"]["w"],
                       fresh["struct"]["source"]["conv1"]["lin"]["w"])
