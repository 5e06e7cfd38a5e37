"""The port's losses and readout MLP (mgvae_tpu_torch.train.losses,
ops.mlp) against the JAX package's, on the same hs / hf, batch, negatives
and dropout masks. JAX's random draws are rebuilt here and handed to the
port explicitly. Tolerances: loss values and metrics rtol 1e-5, BatchNorm
running statistics atol 1e-6, gradients 1e-4 * their largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgvae_tpu
from mgvae_tpu.data.batching import collate
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.ops import mlp as JM
from mgvae_tpu.train import losses as JL
import mgvae_tpu_torch
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import mlp as PM
from mgvae_tpu_torch.train import losses as PL
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax

torch.set_num_threads(1)
RTOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(modality="mig", seed=1, scale_hs=1.0):
    """JAX params/state, the host batch, and JAX's hs / hf as numpy."""
    cfg = J.DGConfig(modality=modality, dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=True)
    params, state = J.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(seed)
    hb = collate([random_circuit(rng, modality, num_inputs=6, num_gates=40, num_tt_pairs=24)
                  for _ in range(3)])
    batch = jax.tree.map(jnp.asarray, hb)
    hs, hf, _ = J.forward(params, batch, cfg)
    return params, state, hb, batch, np.asarray(hs) * scale_hs, np.asarray(hf)


def _port(params, state, hb):
    return (params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu"),
            P.batch_to_device(hb, "cpu"))


def _keep_masks(k_drop, n, dim):
    """The keep masks JAX's mlp_apply draws from ``k_drop`` (one key per
    hidden layer, bernoulli(0.8))."""
    return [np.asarray(jax.random.bernoulli(k, 0.8, (n, dim)))
            for k in jax.random.split(k_drop, 2)]


def _grad_close(g_port, g_jax):
    g_jax = np.asarray(g_jax)
    assert np.isfinite(g_port).all()
    scale = max(float(np.abs(g_jax).max()), 1e-30)
    assert float(np.abs(g_port - g_jax).max()) <= 1e-4 * scale


@pytest.mark.parametrize("mask_collisions", [False, True])
def test_recon_loss_matches_jax(mask_collisions):
    params, state, hb, batch, hs, _ = _setup()
    neg = [np.array(x) for x in JL.sample_negative_edges(
        jax.random.PRNGKey(7), hb["edge_src"].shape[0], batch)]
    neg[0][:6], neg[1][:6] = hb["edge_src"][:6], hb["edge_dst"][:6]   # real edges
    neg_j = tuple(jnp.asarray(x) for x in neg)

    def jloss(h):
        return JL.recon_loss(params, h, batch, None, neg_edges=neg_j,
                             mask_collisions=mask_collisions)

    (l_j, m_j), g_j = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(hs))
    pp, _, b = _port(params, state, hb)
    h = torch.tensor(hs, requires_grad=True)
    l_p, m_p = PL.recon_loss(pp, h, b, neg_edges=tuple(torch.tensor(x) for x in neg),
                             mask_collisions=mask_collisions)
    l_p.backward()
    np.testing.assert_allclose(l_p.item(), float(l_j), rtol=RTOL)
    for k in ("tp", "fn", "fp", "tn", "n_pred"):
        assert m_p[k].item() == float(m_j[k]), k
    if mask_collisions:
        assert m_p["n_pred"].item() <= 2 * int(hb["n_edges"]) - 6
    _grad_close(h.grad.numpy(), g_j)


def test_recon_loss_saturated_logits_stay_finite():
    """hs scaled up until sigmoid saturates: the loss is the clipped
    softplus, never log(0), and its gradient stays finite."""
    params, state, hb, batch, hs, _ = _setup(scale_hs=60.0)
    neg = tuple(np.asarray(x) for x in JL.sample_negative_edges(
        jax.random.PRNGKey(3), hb["edge_src"].shape[0], batch))

    def jloss(h):
        return JL.recon_loss(params, h, batch, None, neg_edges=tuple(map(jnp.asarray, neg)))[0]

    l_j, g_j = jax.value_and_grad(jloss)(jnp.asarray(hs))
    pp, _, b = _port(params, state, hb)
    h = torch.tensor(hs, requires_grad=True)
    l_p, _ = PL.recon_loss(pp, h, b, neg_edges=tuple(torch.tensor(x) for x in neg))
    l_p.backward()
    assert np.isfinite(l_p.item()) and l_p.item() > 1.0
    np.testing.assert_allclose(l_p.item(), float(l_j), rtol=RTOL)
    _grad_close(h.grad.numpy(), g_j)


def test_log_sigmoid_loss_and_masked_stats_match_jax():
    x = np.array([-200.0, -40.0, -34.0, -3.0, 0.0, 1e-3, 5.0, 36.0, 300.0], np.float32)
    for positive in (True, False):
        np.testing.assert_allclose(
            PL.log_sigmoid_loss(torch.tensor(x), positive).numpy(),
            np.asarray(JL.log_sigmoid_loss(jnp.asarray(x), positive)), rtol=RTOL, atol=1e-7)
    rng = np.random.default_rng(0)
    v = rng.normal(size=40).astype(np.float32)
    valid = rng.random(40) < 0.7
    count = float(valid.sum())
    np.testing.assert_allclose(
        PL.masked_mean(torch.tensor(v), torch.tensor(valid)).item(),
        float(JL.masked_mean(jnp.asarray(v), jnp.asarray(valid))), rtol=RTOL)
    np.testing.assert_allclose(
        PL.masked_zscore(torch.tensor(v), torch.tensor(valid), torch.tensor(count)).numpy(),
        np.asarray(JL.masked_zscore(jnp.asarray(v), jnp.asarray(valid), count)),
        rtol=RTOL, atol=1e-6)


def test_sample_negative_edges_in_range_without_self_loops():
    gen = torch.Generator().manual_seed(0)
    src, dst = PL.sample_negative_edges(gen, 4096, {"n_nodes": np.int32(37)})
    assert src.dtype == dst.dtype == torch.int32
    assert (src != dst).all() and src.min() >= 0 and src.max() < 37 and dst.max() < 37
    assert len(torch.unique(src)) == 37          # uniform over the whole range
    # two valid runs, [0, 5) and [128, 132): nothing lands between them
    src, dst = PL.sample_negative_edges(gen, 512, {
        "n_nodes": np.int32(9), "chunk_counts": np.array([5, 4], np.int32),
        "chunk_offsets": np.array([0, 128], np.int32)})
    assert (src != dst).all()
    assert set(torch.unique(torch.cat([src, dst])).tolist()) == {0, 1, 2, 3, 4, 128, 129, 130, 131}


@pytest.mark.parametrize("train", [True, False])
def test_prob_loss_matches_jax(train):
    """Train mode: dropout with JAX's keep masks, batch statistics over the
    valid rows and the new running state. Eval mode: running statistics."""
    params, state, hb, batch, _, hf = _setup(seed=2)
    k_drop = jax.random.PRNGKey(11)

    def jloss(h):
        return JL.prob_loss(params, state, h, batch, train, k_drop)

    (l_j, st_j), g_j = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(hf))
    pp, ps, b = _port(params, state, hb)
    keep = [torch.tensor(k) for k in _keep_masks(k_drop, hf.shape[0], 32)] if train else None
    h = torch.tensor(hf, requires_grad=True)
    l_p, st_p = PL.prob_loss(pp, ps, h, b, train, drop_keep=keep)
    l_p.backward()
    np.testing.assert_allclose(l_p.item(), float(l_j), rtol=RTOL)
    for a, c in zip(jax.tree.leaves(params_to_numpy(st_p)), jax.tree.leaves(_np(st_j))):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
    _grad_close(h.grad.numpy(), g_j)


def test_batchnorm_running_state_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, 16)).astype(np.float32) * 3 + 1
    valid = np.arange(50) < 37
    pj, sj = JM.batchnorm_init(16)
    pj = {"w": jnp.asarray(rng.normal(size=16), jnp.float32), "b": pj["b"] + 0.5}
    sj = {"mean": sj["mean"] + 0.2, "var": sj["var"] * 2.0}
    pp, sp = params_from_jax({"hs_linear": _np(pj)}, device="cpu")["hs_linear"], state_from_jax(
        {"readout_prob": {"bn": [_np(sj)]}}, device="cpu")["readout_prob"]["bn"][0]
    for mask in (valid, None):
        y_j, s_j = JM.batchnorm_apply(pj, sj, jnp.asarray(x),
                                      valid=None if mask is None else jnp.asarray(mask))
        y_p, s_p = PM.batchnorm_apply(pp, sp, torch.tensor(x),
                                      valid=None if mask is None else torch.tensor(mask))
        np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(s_p[k].numpy(), np.asarray(s_j[k]), rtol=0, atol=1e-6)
    y_j, _ = JM.batchnorm_apply(pj, sj, jnp.asarray(x), train=False)
    y_p, s_p = PM.batchnorm_apply(pp, sp, torch.tensor(x), train=False)
    assert s_p is sp
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)


def test_dropout_keep_mask_and_generator():
    x = torch.ones(400, 32)
    gen = torch.Generator().manual_seed(0)
    y = PM.dropout(x, 0.2, True, gen)
    kept = y != 0
    assert torch.allclose(y[kept], torch.tensor(1.25)) and 0.7 < kept.float().mean() < 0.9
    keep = torch.zeros(400, 32, dtype=torch.bool)
    keep[:, :4] = True
    assert (PM.dropout(x, 0.2, True, keep=keep) == torch.where(keep, 1.25, 0.0)).all()
    assert PM.dropout(x, 0.2, False) is x
    with pytest.raises(ValueError, match="generator"):
        PM.dropout(x, 0.2, True)


def test_func_loss_matches_jax_with_zero_rows_at_padding_pairs():
    """Padding tt pairs gather row 0; with that row all zero the masked
    norm keeps every gradient finite, as in the JAX package."""
    params, state, hb, batch, _, hf = _setup(seed=3)
    assert not hb["tt_valid"].all() and (hb["tt_pair_a"][~hb["tt_valid"]] == 0).all()
    hf = hf.copy()
    hf[0] = 0.0
    l_j, g_j = jax.value_and_grad(lambda h: JL.func_loss(h, batch))(jnp.asarray(hf))
    _, _, b = _port(params, state, hb)
    h = torch.tensor(hf, requires_grad=True)
    l_p = PL.func_loss(h, b)
    l_p.backward()
    np.testing.assert_allclose(l_p.item(), float(l_j), rtol=RTOL)
    _grad_close(h.grad.numpy(), g_j)


def test_model_pred_prob_and_recon_loss_match_jax():
    kw = dict(modality="xag", dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=True)
    jmodel = mgvae_tpu.Model(**kw)
    jmodel.state = jax.tree.map(lambda a: a + 0.3, jmodel.state)   # non-trivial running stats
    pmodel = mgvae_tpu_torch.Model(
        **kw, params=params_from_jax(_np(jmodel.params), device="cpu"),
        state=state_from_jax(_np(jmodel.state), device="cpu"), device="cpu")
    g = random_circuit(np.random.default_rng(6), "xag", num_inputs=6, num_gates=40)
    g_p = mgvae_tpu_torch.random_circuit(np.random.default_rng(6), "xag", num_inputs=6,
                                         num_gates=40)                  # the same circuit
    hs_j, hf_j = jmodel(g)
    hs_p, hf_p = pmodel(g_p)
    np.testing.assert_allclose(pmodel.pred_prob(hf_p).numpy(),
                               np.asarray(jmodel.pred_prob(hf_j)), rtol=1e-4, atol=1e-5)
    key = jax.random.PRNGKey(9)
    l_j, m_j = jmodel.recon_loss(hs_j, g.edge_index, rng=key)
    neg = JL.sample_negative_edges(key, g.num_edges, {"n_nodes": jnp.int32(g.num_nodes)})
    l_p, m_p = pmodel.recon_loss(hs_p, g.edge_index,
                                 neg_edges=tuple(torch.tensor(np.asarray(x)) for x in neg))
    np.testing.assert_allclose(l_p.item(), float(l_j), rtol=1e-4)
    for k in ("tp", "fn", "fp", "tn", "n_pred"):
        assert m_p[k].item() == float(m_j[k]), k
    l_g, _ = pmodel.recon_loss(hs_p, g.edge_index)          # negatives from a generator
    assert np.isfinite(l_g.item())


# ---- negatives on chunked and split batches ---------------------------------

def _large_batch(layout):
    from mgvae_tpu.data.batching import collate_chunked, collate_split

    rng = np.random.default_rng(12)
    graphs = [random_circuit(rng, "mig", num_inputs=5, num_gates=14 + 9 * i) for i in range(7)]
    return collate_chunked(graphs, 3) if layout == "chunked" else collate_split(graphs, 3)


@pytest.mark.parametrize("layout", ["chunked", "split"])
def test_negative_edges_on_large_batches_match_jax_mapping(layout):
    """Uniform ids over the valid-node count are mapped into the chunks' /
    groups' valid runs exactly as the JAX package maps them, and never hit
    an interior padding row."""
    hb = _large_batch(layout)
    n, valid = int(hb["n_nodes"]), hb["node_valid"]
    assert not valid[:n].all()                                  # interior padding exists
    num = 4096
    keys = [k for k in ("n_nodes", "gate", "chunk_counts", "chunk_offsets") if k in hb]
    jb = {k: jnp.asarray(hb[k]) for k in keys}
    key = jax.random.PRNGKey(9)
    src_j, dst_j = (np.asarray(x) for x in JL.sample_negative_edges(key, num, jb))
    # the same draws before the mapping: a batch without the runs
    raw = [np.asarray(x) for x in JL.sample_negative_edges(
        key, num, {"n_nodes": jb["n_nodes"]})]
    assert max(r.max() for r in raw) < n
    b = P.batch_to_device(hb, "cpu")
    for r, want in zip(raw, (src_j, dst_j)):
        got = PL.to_valid_runs(torch.tensor(r), b).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, want)
        assert valid[got].all()
    # every valid row is the image of exactly one id
    all_ids = PL.to_valid_runs(torch.arange(n, dtype=torch.int32), b).numpy()
    assert np.array_equal(np.sort(all_ids), np.flatnonzero(valid))
    # the port's own draws: valid rows, no self loops
    src, dst = PL.sample_negative_edges(torch.Generator().manual_seed(1), num, b)
    assert src.dtype == dst.dtype == torch.int32
    assert valid[src.numpy()].all() and valid[dst.numpy()].all() and (src != dst).all()
    assert len(np.unique(src.numpy() // 128)) > 1               # more than one run is hit


def test_plain_batch_negatives_are_not_remapped():
    _, _, hb, _, _, _ = _setup()
    b = P.batch_to_device(hb, "cpu")
    ids = torch.arange(int(hb["n_nodes"]), dtype=torch.int32)
    assert PL.to_valid_runs(ids, b) is ids
