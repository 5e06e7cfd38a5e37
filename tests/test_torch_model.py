"""The port's whole encode slice against the JAX package: forward (hs, hf)
for the four modalities, Model.encode_many / Model.forward, the params
bridge, and the port's independence from jax. Tolerances are the JAX
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
from mgvae_tpu.data.batching import collate, collate_chunked
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
import mgvae_tpu_torch
from mgvae_tpu_torch.models import dg_ae as P
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
    hs_p, hf_p, aux = P.forward(params_from_jax(_np_tree(params)), batch, pcfg)
    n = int(batch["n_nodes"])
    assert aux == {} and hs_p.shape == hf_p.shape == (batch["gate"].shape[0], 32)
    _assert_embeddings_close(hs_p.numpy()[:n], hf_p.numpy()[:n],
                             np.asarray(hs_j)[:n], np.asarray(hf_j)[:n])


def test_model_encode_many_and_forward_match_jax():
    kw = dict(modality="mig", dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=True)
    jmodel = mgvae_tpu.Model(**kw)
    pmodel = mgvae_tpu_torch.Model(**kw, params=params_from_jax(_np_tree(jmodel.params)),
                                   device="cpu")
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
    pp, ps = P.init_params(P.DGConfig(**kw), seed=0)
    shape_tree = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert jax.tree.structure(jp) == jax.tree.structure(pp)
    assert shape_tree(jp) == shape_tree(pp)
    assert jax.tree.structure(js) == jax.tree.structure(ps)
    # the bridge carries the JAX tree over unchanged
    bridged = params_from_jax(_np_tree(jp))
    assert jax.tree.all(jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b.numpy()),
                                     jp, bridged))


def test_params_from_jax_raises_on_unknown_key():
    params, _ = J.init_params(jax.random.PRNGKey(0), J.DGConfig(dim_hidden=8))
    tree = _np_tree(params)
    tree["experts"]["w_extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="w_extra"):
        params_from_jax(tree)
    vae, _ = J.init_params(jax.random.PRNGKey(0), J.DGConfig(dim_hidden=8, variational=True))
    with pytest.raises(KeyError, match="fc_"):
        params_from_jax(_np_tree(vae))


def test_unported_options_raise_not_implemented():
    for kw in (dict(variational=True), dict(num_rounds=2), dict(compute_dtype="bfloat16")):
        with pytest.raises(NotImplementedError):
            P.init_params(P.DGConfig(dim_hidden=8, **kw))
    with pytest.raises(NotImplementedError):
        mgvae_tpu_torch.Model(dim_hidden=8, num_rounds=2, device="cpu")
    rng = np.random.default_rng(3)
    graphs = [random_circuit(rng, "mig", num_inputs=4, num_gates=12) for _ in range(2)]
    cfg = P.DGConfig(dim_hidden=8)
    params, _ = P.init_params(cfg)
    with pytest.raises(NotImplementedError, match="chunked"):
        P.forward(params, collate_chunked(graphs, 2), cfg)


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
