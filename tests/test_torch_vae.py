"""DG_VAE in the port (``DGConfig(variational=True)``) against the JAX
package: ``kl_loss``, the variational forward (hs, hf, aux) on plain,
chunked and split batches by both JAX routes, the whole loss's gradients
with the KL weight at 1 against ``jax.grad``, one Adam step against
``make_train_step``, the params bridge with the ``fc_*`` heads, the
trainer's KL field, checkpoints, and ``Model(variational=True)``'s draws.

JAX draws the posterior noise from its key (``dg_ae.py:232-245``): ``ks, kt
= split(rng)`` and ``normal(ks, shape)``, per group of a split batch from
``fold_in(rng, gi)``; the tests compute those draws here and hand them to the
port as ``vae_eps``. Tolerances are the JAX parity tests': hs rtol 1e-4 /
atol 1e-5, hf atol 1e-4, kl rtol 1e-6, losses rtol 1e-5, each gradient leaf
1e-4 * its scale (floored at 2e-2 of the largest leaf), updated params
within the Adam bounds of tests/test_torch_train_step.py.
"""
import functools
import re
import types

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
from mgvae_tpu_torch.train import losses as PL
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.train import trainer as PT
from mgvae_tpu_torch.utils import checkpoint as pckpt
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax

torch.set_num_threads(1)
D = 16
KW = dict(modality="mig", dim_hidden=D, s_rounds=2, t_rounds=2, layernorm=True, variational=True)
WEIGHTS = [1.0, 4.0, 4.0, 1.0]
RTOL = 1e-5
GRAD_FLOOR = 2e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(layout, seed=1):
    rng = np.random.default_rng(seed)
    graphs = [random_circuit(rng, "mig", num_inputs=5, num_gates=20 + 6 * i, num_tt_pairs=16)
              for i in range(4)]
    if layout == "chunked":
        return collate_chunked(graphs, 2)
    if layout == "split":
        return collate_split(graphs, 2)
    return collate(graphs)


def _setup(layout, seed=1):
    jcfg, pcfg = J.DGConfig(**KW), P.DGConfig(**KW)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, params, state, _batch(layout, seed)


def jax_vae_eps(key, hb, dim):
    """JAX's posterior noise for ``forward(..., rng=key)``, rows as hs's."""
    groups = hb["groups"] if "groups" in hb else None
    keys = ([jax.random.fold_in(key, gi) for gi in range(len(groups))] if groups
            else [key])
    sizes = [g["gate"].shape[0] for g in groups] if groups else [hb["gate"].shape[0]]
    draws = [[np.asarray(jax.random.normal(k, (n, dim))) for k in jax.random.split(kk)]
             for kk, n in zip(keys, sizes)]
    return tuple(torch.tensor(np.concatenate([d[i] for d in draws])) for i in range(2))


def jax_step_draws(key, hb, dim, dim_mlp):
    """The posterior noise, negatives and dropout keep masks of JAX's
    ``loss_and_metrics(..., rng=key)``, as torch tensors."""
    k_vae, k_neg, k_drop = jax.random.split(key, 3)
    batch = jax.tree.map(jnp.asarray, hb)
    neg = JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0], batch)
    n = hb["gate"].shape[0]
    keep = [jax.random.bernoulli(k, 0.8, (n, dim_mlp)) for k in jax.random.split(k_drop, 2)]
    return (jax_vae_eps(k_vae, hb, dim), tuple(torch.tensor(np.asarray(x)) for x in neg),
            [torch.tensor(np.asarray(k)) for k in keep])


@functools.cache
def _jax_value_and_grad(cfg):
    fn = functools.partial(JS.loss_and_metrics, cfg=cfg, train=True)
    return jax.jit(jax.value_and_grad(fn, has_aux=True))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("layout", ["plain", "split"])
def test_kl_loss_matches_jax(layout):
    hb = _batch(layout)
    n = hb["gate"].shape[0]
    rng = np.random.default_rng(3)
    aux = {k: rng.normal(0, 0.5, (n, D)).astype(np.float32)
           for k in ("s_mu", "s_logstd", "t_mu", "t_logstd")}
    kl_j = JL.kl_loss({k: jnp.asarray(v) for k, v in aux.items()},
                      {k: jnp.asarray(hb[k]) for k in ("n_nodes", "node_valid")})
    kl_p = PL.kl_loss({k: torch.tensor(v) for k, v in aux.items()},
                      {k: torch.as_tensor(np.asarray(hb[k])) for k in ("n_nodes", "node_valid")})
    np.testing.assert_allclose(kl_p.item(), float(kl_j), rtol=1e-6)


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("layout", ["plain", "chunked", "split"])
def test_variational_forward_matches_jax(layout, route):
    jcfg, pcfg, params, _, hb = _setup(layout)
    key = jax.random.PRNGKey(7)
    hs_j, hf_j, aux_j = J.forward(params, jax.tree.map(jnp.asarray, hb), jcfg, rng=key,
                                  use_pallas=route == "pallas",
                                  pallas_interpret=route == "pallas")
    pp = params_from_jax(_np(params), device="cpu")
    hs_p, hf_p, aux_p = P.forward(pp, hb, pcfg, vae_eps=jax_vae_eps(key, hb, D))
    v = hb["node_valid"]
    np.testing.assert_allclose(hs_p.numpy()[v], np.asarray(hs_j)[v], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hf_p.numpy()[v], np.asarray(hf_j)[v], rtol=0, atol=1e-4)
    assert sorted(aux_p) == sorted(aux_j) == ["s_logstd", "s_mu", "t_logstd", "t_mu"]
    for k in aux_p:
        assert aux_p[k].shape == hs_p.shape
        np.testing.assert_allclose(aux_p[k].numpy()[v], np.asarray(aux_j[k])[v], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_variational_forward_draws_from_the_generator():
    _, pcfg, params, _, hb = _setup("split")
    pp = params_from_jax(_np(params), device="cpu")
    runs = [P.forward(pp, hb, pcfg, gen=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert torch.equal(runs[0][0], runs[1][0]) and not torch.equal(runs[0][0], runs[2][0])
    with pytest.raises(ValueError, match="generator"):
        P.forward(pp, hb, pcfg)
    # the posterior mean does not depend on the draws
    assert torch.equal(runs[0][2]["s_mu"], runs[2][2]["s_mu"])


@pytest.mark.parametrize("layout", ["plain", "split"])
def test_vae_gradients_with_kl_match_jax(layout):
    jcfg, pcfg, params, state, hb = _setup(layout)
    key = jax.random.PRNGKey(5)
    (tot_j, (st_j, m_j)), g_j = _jax_value_and_grad(jcfg)(
        params, state, jax.tree.map(jnp.asarray, hb), key, jnp.asarray(WEIGHTS))
    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    leaves = PS.param_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    eps, neg, keep = jax_step_draws(key, hb, D, pcfg.dim_mlp)
    tot_p, (st_p, m_p) = PS.loss_and_metrics(pp, ps, hb, None, WEIGHTS, pcfg, True,
                                             neg_edges=neg, drop_keep=keep, vae_eps=eps)
    tot_p.backward()
    assert float(m_j["kl_loss"]) != 0.0
    np.testing.assert_allclose(tot_p.item(), float(tot_j), rtol=RTOL)
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=RTOL, err_msg=k)
    for a, c in zip(_leaves(params_to_numpy(st_p)), _leaves(st_j)):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
    g_p = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves]
    g_jl = _leaves(g_j)
    assert [g.shape for g in g_p] == [g.shape for g in g_jl]
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(g_j)]
    assert sum("fc_" in n for n in names) == 8
    scale = max(float(np.abs(g).max()) for g in g_jl)
    for name, a, c in zip(names, g_p, g_jl):
        err, leaf = float(np.abs(a - c).max()), float(np.abs(c).max())
        assert np.isfinite(a).all()
        assert err <= 1e-4 * max(leaf, GRAD_FLOOR * scale), (name, err, leaf, scale)
        if "fc_" in name:
            assert leaf > 0, name


def test_vae_train_step_matches_jax_make_train_step():
    lr = 1e-3
    jcfg, pcfg, params, state, hb = _setup("plain", seed=2)
    key = jax.random.PRNGKey(8)
    batch = jax.tree.map(jnp.asarray, hb)
    w = jnp.asarray(WEIGHTS)
    _, g_j = _jax_value_and_grad(jcfg)(params, state, batch, key, w)
    opt = JS.make_optimizer(lr)
    j_step, _ = JS.make_train_step(jcfg, opt, mesh=None, donate=False)
    p1_j, s1_j, _, m_j = j_step(params, state, opt.init(params), batch, key, w)

    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    p_step, _ = PS.make_train_step(pcfg, PS.make_optimizer(pp, lr))
    eps, neg, keep = jax_step_draws(key, hb, D, pcfg.dim_mlp)
    s1_p, m_p = p_step(pp, ps, hb, None, WEIGHTS, neg_edges=neg, drop_keep=keep, vae_eps=eps)
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=RTOL, err_msg=k)
    for a, c in zip(_leaves(params_to_numpy(s1_p)), _leaves(s1_j)):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
    g = _leaves(g_j)
    scale = max(float(np.abs(x).max()) for x in g)
    p_new, p_old = params_to_numpy(pp), _np(params)
    for name in ("fc_s_mu", "fc_s_logstd", "fc_t_mu", "fc_t_logstd"):
        assert np.abs(p_new[name]["w"] - p_old[name]["w"]).max() > 0.5 * lr, name
    for a, c, gj in zip(_leaves(p_new), _leaves(p1_j), g):
        d = np.abs(a - c)
        assert d.max() <= 2 * lr
        assert (d[np.abs(gj) > 1e-5 * scale] <= 1e-3 * lr).all()


def test_params_from_jax_takes_the_variational_heads():
    params, _ = J.init_params(jax.random.PRNGKey(0), J.DGConfig(dim_hidden=8, variational=True))
    bridged = params_from_jax(_np(params), device="cpu")
    assert {k for k in bridged if k.startswith("fc_")} == set(P.VAE_HEADS)
    assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b.numpy()),
                                     params, bridged))
    tree = _np(params)
    tree["fc_s_sigma"] = tree["fc_s_mu"]
    with pytest.raises(KeyError, match="fc_s_sigma"):
        params_from_jax(tree, device="cpu")


def test_init_params_draws_the_heads_last():
    ae, _ = P.init_params(P.DGConfig(dim_hidden=8), seed=3, device="cpu")
    vae, _ = P.init_params(P.DGConfig(dim_hidden=8, variational=True), seed=3, device="cpu")
    assert set(vae) - set(ae) == set(P.VAE_HEADS)
    assert all(torch.equal(a, b) for a, b in zip(PS.param_leaves(ae),
                                                 PS.param_leaves({k: vae[k] for k in ae})))
    assert all(vae[k]["w"].shape == (8, 8) for k in P.VAE_HEADS)


def test_model_variational_repeats_from_its_seed_and_draws_per_call(tmp_path):
    rng = np.random.default_rng(4)
    graphs = [mgvae_tpu_torch.random_circuit(rng, "mig", num_inputs=4, num_gates=20 + 4 * i)
              for i in range(3)]
    kw = dict(modality="mig", dim_hidden=D, s_rounds=1, t_rounds=1, variational=True,
              device="cpu")
    a, b = mgvae_tpu_torch.Model(**kw, seed=2), mgvae_tpu_torch.Model(**kw, seed=2)
    hs_a1, hf_a1 = a(graphs[0])
    hs_b1, _ = b(graphs[0])
    hs_a2, _ = a(graphs[0])
    assert torch.equal(hs_a1, hs_b1) and not torch.equal(hs_a1, hs_a2)
    assert hs_a1.shape == hf_a1.shape == (graphs[0].num_nodes, D)
    out = a.encode_many(graphs, batch_size=2)
    assert [o[0].shape for o in out] == [(g.num_nodes, D) for g in graphs]
    hs_l, hf_l = a(graphs)
    assert hs_l.shape[0] == sum(g.num_nodes for g in graphs)
    assert np.isfinite(hf_l.numpy()).all()
    # a DG_VAE tree saves and loads; a DG_AE checkpoint loads into it with
    # the heads kept from the template
    a.save(str(tmp_path / "vae.pth"))
    c = mgvae_tpu_torch.Model(**kw, seed=9).load(str(tmp_path / "vae.pth"))
    assert all(torch.equal(x, y) for x, y in zip(PS.param_leaves(a.params),
                                                 PS.param_leaves(c.params)))
    ae = mgvae_tpu_torch.Model(**{**kw, "variational": False}, seed=5)
    ae.save(str(tmp_path / "ae.pth"))
    merged = pckpt.tolerant_merge(c.params, pckpt._read(str(tmp_path / "ae.pth"), "cpu")["params"])
    assert torch.equal(merged["hs_linear"]["w"], ae.params["hs_linear"]["w"])
    assert merged["fc_t_mu"] is c.params["fc_t_mu"]


EPOCH = re.compile(r"^train\| Epoch: 0/1 \|Recon: [\d.]+ \|ACC: [\d.]+ \|Prob: [\d.]+ "
                   r"\|Func: [\d.]+( \|KL: (-?[\d.]+))?\|Net: [\d.]+s$")


@pytest.mark.parametrize("variational,kl_weight", [(True, 0.0), (True, 0.5), (False, 0.5)],
                         ids=["vae_kl0", "vae_kl", "ae"])
def test_trainer_epoch_line_shows_kl_when_metered(variational, kl_weight, tmp_path):
    """The KL field appears when a nonzero KL was metered: on DG_VAE, whose
    KL is computed whatever its weight (as in JAX's ``loss_and_metrics``),
    and never on DG_AE. With kl_weight > 0 the step descends on it."""
    rng = np.random.default_rng(5)
    graphs = [mgvae_tpu_torch.random_circuit(rng, "mig", num_inputs=4, num_gates=24,
                                             num_tt_pairs=16) for _ in range(8)]
    cfg = P.DGConfig(modality="mig", dim_hidden=D, s_rounds=1, t_rounds=1,
                     variational=variational)
    t = PT.Trainer(types.SimpleNamespace(), cfg, training_id="kl", save_dir=str(tmp_path),
                   batch_size=4, distributed=False, kl_weight=kl_weight, steps_per_call=1,
                   device="cpu")
    t.set_training_args(rc_prob_func_weight=[1.0, 0.0, 0.0], lr=1e-3)
    out = t.train(1, graphs, [])
    (log,) = (tmp_path / "kl").glob("log-*.txt")
    (line,) = [ln for ln in log.read_text().splitlines() if ln.startswith("train|")]
    m = EPOCH.match(line)
    assert m, line
    assert (m.group(1) is not None) == variational
    if variational:
        assert float(m.group(2)) == pytest.approx(out["train"]["kl"], abs=1e-4)
        assert out["train"]["kl"] != 0.0
    assert t.weights[3] == kl_weight
