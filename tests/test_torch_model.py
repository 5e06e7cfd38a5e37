"""The port's whole encode slice against the JAX package: forward (hs, hf)
for the four modalities on plain, chunked (both routes of the level
recurrence) and split batches, Model.encode_many / Model.forward, the
params bridge, and the port's independence from jax. Tolerances are the JAX
package's own: hs rtol 1e-4 / atol 1e-5, hf atol 1e-4
(tests/test_model_parity.py, tests/test_pallas_kernel.py)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgvae_tpu
from mgvae_tpu.data.batching import collate, collate_chunked, collate_split
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
import mgvae_tpu_torch
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import level_kernel
from mgvae_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _assert_embeddings_close(hs_p, hf_p, hs_j, hf_j):
    np.testing.assert_allclose(hs_p, hs_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hf_p, hf_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("modality", ["aig", "mig", "xag", "xmg"])
def test_forward_matches_jax(modality):
    kw = dict(modality=modality, dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=True)
    jcfg, pcfg = J.DGConfig(**kw), P.DGConfig(**kw)
    params, _ = J.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    batch = collate([random_circuit(rng, modality, num_inputs=6, num_gates=40) for _ in range(3)])
    hs_j, hf_j, _ = J.forward(params, jax.tree.map(jnp.asarray, batch), jcfg)
    hs_p, hf_p, aux = P.forward(params_from_jax(_np_tree(params), device="cpu"), batch, pcfg)
    n = int(batch["n_nodes"])
    assert aux == {} and hs_p.shape == hf_p.shape == (batch["gate"].shape[0], 32)
    _assert_embeddings_close(hs_p.numpy()[:n], hf_p.numpy()[:n],
                             np.asarray(hs_j)[:n], np.asarray(hf_j)[:n])


def test_model_encode_many_and_forward_match_jax():
    kw = dict(modality="mig", dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=True)
    jmodel = mgvae_tpu.Model(**kw)
    pmodel = mgvae_tpu_torch.Model(
        **kw, params=params_from_jax(_np_tree(jmodel.params), device="cpu"), device="cpu")
    make = lambda rc: [rc(rng, "mig", num_inputs=5, num_gates=24 + 4 * i) for i in range(5)]
    rng = np.random.default_rng(2)
    jgraphs = make(random_circuit)
    rng = np.random.default_rng(2)
    graphs = make(mgvae_tpu_torch.random_circuit)         # the same circuits
    out_j = jmodel.encode_many(jgraphs, batch_size=2)    # 3 requests, the last one ragged
    out_p = pmodel.encode_many(graphs, batch_size=2)
    assert len(out_p) == len(graphs)
    for g, (hs_p, hf_p), (hs_j, hf_j) in zip(graphs, out_p, out_j):
        assert hs_p.shape == hf_p.shape == (g.num_nodes, 32)
        _assert_embeddings_close(hs_p, hf_p, np.asarray(hs_j), np.asarray(hf_j))
    hs_p, hf_p = pmodel(graphs[0])
    hs_j, hf_j = jmodel(jgraphs[0])
    _assert_embeddings_close(hs_p.numpy(), hf_p.numpy(), np.asarray(hs_j), np.asarray(hf_j))
    hs_l, _ = pmodel(graphs[:2])
    assert hs_l.shape[0] == graphs[0].num_nodes + graphs[1].num_nodes
    np.testing.assert_allclose(hs_l[: graphs[0].num_nodes].numpy(), hs_p.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("modality,layernorm", [("aig", False), ("mig", True),
                                                ("xag", True), ("xmg", False)])
def test_init_params_same_tree_and_shapes_as_jax(modality, layernorm):
    kw = dict(modality=modality, dim_hidden=16, layernorm=layernorm)
    jp, js = J.init_params(jax.random.PRNGKey(0), J.DGConfig(**kw))
    pp, ps = P.init_params(P.DGConfig(**kw), seed=0, device="cpu")
    shape_tree = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert jax.tree.structure(jp) == jax.tree.structure(pp)
    assert shape_tree(jp) == shape_tree(pp)
    assert jax.tree.structure(js) == jax.tree.structure(ps)
    # the bridge carries the JAX tree over unchanged
    bridged = params_from_jax(_np_tree(jp), device="cpu")
    assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b.numpy()),
                                     jp, bridged))


def test_params_from_jax_raises_on_unknown_key():
    params, _ = J.init_params(jax.random.PRNGKey(0), J.DGConfig(dim_hidden=8))
    tree = _np_tree(params)
    tree["experts"]["w_extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="w_extra"):
        params_from_jax(tree, device="cpu")
    # the variational heads are known keys; a head of another name is not
    vae, _ = J.init_params(jax.random.PRNGKey(0), J.DGConfig(dim_hidden=8, variational=True))
    vae = _np_tree(vae)
    vae["fc_extra"] = vae["fc_s_mu"]
    with pytest.raises(KeyError, match="fc_extra"):
        params_from_jax(vae, device="cpu")


def test_unported_options_raise_not_implemented():
    with pytest.raises(NotImplementedError):
        P.init_params(P.DGConfig(dim_hidden=8, compute_dtype="bfloat16"), device="cpu")
    # DG_VAE, the gcn struct encoder and num_rounds > 1 are ported
    for kw in (dict(variational=True), dict(num_rounds=2), dict(struct_encoder="gcn")):
        P.init_params(P.DGConfig(dim_hidden=8, **kw), device="cpu")
    mgvae_tpu_torch.Model(dim_hidden=8, num_rounds=2, device="cpu")


def _large_batch_setup(modality, seed, n=6):
    kw = dict(modality=modality, dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=True)
    jcfg, pcfg = J.DGConfig(**kw), P.DGConfig(**kw)
    params, _ = J.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    graphs = [random_circuit(rng, modality, num_inputs=6, num_gates=24 + 8 * i)
              for i in range(n)]
    return jcfg, pcfg, params, graphs


_jax_forward = jax.jit(J.forward, static_argnames=("cfg", "use_pallas", "pallas_interpret"))


@pytest.mark.parametrize("route", ["fused", "step"])
@pytest.mark.parametrize("modality", ["mig", "xag"])
def test_chunked_forward_matches_jax_both_routes(modality, route, monkeypatch):
    """The port's forward on a two-chunk batch, by each route of the level
    recurrence, against the JAX package's XLA scan and against its Pallas
    route in interpret mode (for the step route with ``kernel_fits`` forced
    False, as tests/test_pallas_kernel.py:217-221 does)."""
    import mgvae_tpu.ops.pallas.level_kernel as JK

    jcfg, pcfg, params, graphs = _large_batch_setup(modality, 4)
    batch = collate_chunked(graphs, 2)
    jbatch = jax.tree.map(jnp.asarray, batch)
    valid = batch["node_valid"]
    hs_x, hf_x, _ = _jax_forward(params, jbatch, cfg=jcfg)
    calls = {"scan": 0, "step": 0}
    spy = lambda name, fn: lambda *a, **k: (calls.__setitem__(name, calls[name] + 1), fn(*a, **k))[1]
    monkeypatch.setattr(P, "level_scan", spy("scan", P.level_scan))
    monkeypatch.setattr(P, "level_step", spy("step", P.level_step))
    if route == "step":
        monkeypatch.setattr(JK, "kernel_fits", lambda *a: False)
        monkeypatch.setattr(level_kernel, "KERNEL_MAX_NODES", 64)
    hs_k, hf_k, _ = J.forward(params, jbatch, jcfg, use_pallas=True, pallas_interpret=True)
    hs_p, hf_p, _ = P.forward(params_from_jax(_np_tree(params), device="cpu"), batch, pcfg)
    counts = P.level_counts(batch)
    assert calls == ({"scan": 2, "step": 0} if route == "fused"
                     else {"scan": 0, "step": sum(counts)})
    for hs_j, hf_j in ((hs_x, hf_x), (hs_k, hf_k)):
        _assert_embeddings_close(hs_p.numpy()[valid], hf_p.numpy()[valid],
                                 np.asarray(hs_j)[valid], np.asarray(hf_j)[valid])
    assert (hf_p.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("limits,step_gate,want", [
    ({}, True, "fused"),                              # the chunks pass kernel_fits
    ({"KERNEL_MAX_NODES": 64}, True, "step"),        # too many nodes for it
    ({"KERNEL_MAX_EP": 8}, True, "step"),             # a level's edges too wide
    ({"KERNEL_MAX_NP": 4}, True, "step"),             # a level's slots too wide
    ({"KERNEL_MAX_NODES": 64}, False, "giant"),      # neither gate holds: giant per chunk
])
def test_level_recurrence_routes_as_the_jax_package(limits, step_gate, want, monkeypatch):
    """For C > 1 the port takes the step route exactly where
    ``_level_scan_pallas`` does: ``kernel_fits`` false and
    ``step_kernel_fits`` true; chunks that fail both gates, where the JAX
    package leaves its kernels, take the giant scan chunk by chunk. A plain
    batch takes the fused scan where it passes ``kernel_fits`` and the giant
    scan where it fails it."""
    rng = np.random.default_rng(5)
    graphs = [mgvae_tpu_torch.random_circuit(rng, "mig", num_inputs=4, num_gates=16 + 4 * i)
              for i in range(4)]
    cfg = P.DGConfig(dim_hidden=8, s_rounds=1, t_rounds=1)
    params, _ = P.init_params(cfg, device="cpu")
    for k, v in limits.items():
        monkeypatch.setattr(level_kernel, k, v)
    if not step_gate:
        monkeypatch.setattr(P, "step_kernel_fits", lambda *a: False)
    calls = []
    real_scan, real_step, real_giant = P.level_scan, P.level_step, P.level_scan_giant
    monkeypatch.setattr(P, "level_scan",
                        lambda *a, **k: (calls.append("fused"), real_scan(*a, **k))[1])
    monkeypatch.setattr(P, "level_scan_giant",
                        lambda *a, **k: (calls.append("giant"), real_giant(*a, **k))[1])
    monkeypatch.setattr(P, "level_step",
                        lambda *a, **k: (calls.append("step"), real_step(*a, **k))[1])
    batch = mgvae_tpu_torch.collate_chunked(graphs, 2)
    _, hf, _ = P.forward(params, batch, cfg)
    counts = P.level_counts(batch)
    assert calls == [want] * (sum(counts) if want == "step" else 2)
    calls.clear()
    _, hf1, _ = P.forward(params, mgvae_tpu_torch.collate(graphs), cfg)
    assert calls == (["giant"] if limits else ["fused"])
    inv_c, inv_1 = batch["node_inv"], mgvae_tpu_torch.collate(graphs)["node_inv"]
    n = int(batch["n_nodes"])
    np.testing.assert_allclose(hf.numpy()[inv_c][:n], hf1.numpy()[inv_1][:n], rtol=0, atol=1e-6)


@pytest.mark.parametrize("modality", ["aig", "xmg"])
def test_split_forward_matches_jax(modality):
    jcfg, pcfg, params, graphs = _large_batch_setup(modality, 6, n=7)
    batch = collate_split(graphs, 3)
    assert len({g["lv_nodes"].shape for g in batch["groups"]}) > 1
    hs_j, hf_j, _ = J.forward(params, jax.tree.map(jnp.asarray, batch), jcfg)
    hs_p, hf_p, aux = P.forward(params_from_jax(_np_tree(params), device="cpu"), batch, pcfg)
    assert aux == {} and hs_p.shape == hf_p.shape == (batch["gate"].shape[0], 32)
    valid = batch["node_valid"]
    _assert_embeddings_close(hs_p.numpy()[valid], hf_p.numpy()[valid],
                             np.asarray(hs_j)[valid], np.asarray(hf_j)[valid])
    assert P.level_counts(batch) == tuple(
        (int(g["forward_level"].max()),) for g in batch["groups"])


def test_model_forward_list_goes_through_collate_fit(monkeypatch):
    """A list too large for one chunk is chunked by ``collate_fit`` and the
    rows come back in input order, equal to the JAX package's and to the
    unchunked batch's."""
    kw = dict(modality="mig", dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=True)
    jmodel = mgvae_tpu.Model(**kw)
    pmodel = mgvae_tpu_torch.Model(
        **kw, params=params_from_jax(_np_tree(jmodel.params), device="cpu"), device="cpu")
    rng = np.random.default_rng(7)
    jgraphs = [random_circuit(rng, "mig", num_inputs=5, num_gates=30 + 5 * i) for i in range(6)]
    rng = np.random.default_rng(7)
    graphs = [mgvae_tpu_torch.random_circuit(rng, "mig", num_inputs=5, num_gates=30 + 5 * i)
              for i in range(6)]
    total = sum(g.num_nodes for g in graphs)
    hs_1, hf_1 = pmodel(mgvae_tpu_torch.collate(graphs))        # one plain batch
    hs_j, hf_j = jmodel(jgraphs)                                 # fits the JAX gate: unchunked
    # the gate's node limit shrunk so that this small list needs chunks
    monkeypatch.setattr(level_kernel, "KERNEL_MAX_NODES", 128)
    seen = []
    import mgvae_tpu_torch.api as api
    real = api.collate_fit
    monkeypatch.setattr(api, "collate_fit", lambda g: (seen.append(real(g)), seen[-1])[1])
    hs_p, hf_p = pmodel(graphs)
    assert len(seen) == 1 and seen[0]["lv_nodes"].ndim == 3 and seen[0]["lv_nodes"].shape[0] > 1
    assert seen[0]["gate"].shape[0] // seen[0]["lv_nodes"].shape[0] <= 128
    assert hs_p.shape == hf_p.shape == (total, 32)
    _assert_embeddings_close(hs_p.numpy(), hf_p.numpy(), np.asarray(hs_j), np.asarray(hf_j))
    _assert_embeddings_close(hs_p.numpy(), hf_p.numpy(), hs_1.numpy()[:total],
                             hf_1.numpy()[:total])


def test_init_params_defaults_to_the_card():
    import inspect

    assert inspect.signature(P.init_params).parameters["device"].default == "cuda"
    assert inspect.signature(mgvae_tpu_torch.Model.__init__).parameters["device"].default == "cuda"


def test_edgeless_graph_gives_zero_hf():
    g = mgvae_tpu_torch.build_graph("pi", np.zeros(5, np.int32), np.zeros((2, 0), np.int64))
    hs, hf = mgvae_tpu_torch.Model(dim_hidden=16, s_rounds=1, t_rounds=1, device="cpu")(g)
    assert hs.shape == hf.shape == (5, 16)
    assert torch.isfinite(hs).all() and (hf == 0).all()


def test_port_imports_and_encodes_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import mgvae_tpu_torch as m\n"
        "rng = np.random.default_rng(0)\n"
        "gs = [m.random_circuit(rng, 'xag', num_inputs=4, num_gates=12) for _ in range(2)]\n"
        "model = m.Model(dim_hidden=16, s_rounds=1, t_rounds=1, device='cpu')\n"
        "out = model.encode_many(gs)\n"
        "assert [o[1].shape for o in out] == [(g.num_nodes, 16) for g in gs]\n"
        "assert model.pred_prob(model(gs[0])[1]).shape == (gs[0].num_nodes, 1)\n"
        "hs, hf = model(m.collate_chunked(gs, 2))\n"
        "assert hf.shape[1] == 16 and bool(torch.isfinite(hf).all())\n"
        "hs, hf = model(m.collate_split(gs, 2))\n"
        "assert hf.shape == (sum(g.num_nodes for g in gs), 16)\n"
        "from mgvae_tpu_torch.train import losses, step\n"
        "from mgvae_tpu_torch.ops import mlp, level_kernel\n"
        "from mgvae_tpu_torch.utils import params\n"
        "opt = step.make_optimizer(model.params, 1e-3)\n"
        "train_step, eval_step = step.make_train_step(model.cfg, opt)\n"
        "gen = torch.Generator().manual_seed(0)\n"
        "state, met = train_step(model.params, model.state, m.collate(gs), gen, [1, 4, 4, 0])\n"
        "assert all(float(met[k]) == float(met[k]) for k in step.METRIC_KEYS)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'mgvae_tpu.')) or k == 'mgvae_tpu'\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
