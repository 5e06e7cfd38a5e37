"""The port's giant route (``ops.level_kernel.level_scan_giant``: the level
scan that keeps no residuals and recomputes from hf in the backward) against
the JAX package's ``pallas_level_scan_hbm`` in interpret mode and its XLA
scan, the routing of unchunked batches, the struct remat, and the giant
example's train step at mini scale in both packages.

The JAX package's HBM route is forced as its own tests force it
(tests/test_pallas_kernel.py:138-142): ``kernel_fits`` patched to False inside
``mgvae_tpu.ops.pallas.level_kernel``. On the CPU the port runs its plain
versions.

Tolerances: hf rtol 1e-4 / atol 1e-5; gradients of sum((hf - tgt)^2) with
respect to every param within 1e-4 * max(scale, 1), scale the largest
gradient entry (the JAX package's own bounds for this route); the train step
as tests/test_torch_train_step.py states them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgvae_tpu.ops.pallas.level_kernel as JK
from mgvae_tpu.data.batching import collate, collate_chunked
from mgvae_tpu.data.synthetic import layered_circuit, random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import level_kernel
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax

torch.set_num_threads(1)
WEIGHTS = [1.0, 4.0, 2.0, 0.0]    # the giant example's loss weights
FLOAT_ARGS = level_kernel.FLOAT_ARGS


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _force_giant(monkeypatch):
    """Send the port's unchunked batches down the giant route whatever their
    size, and count the calls."""
    calls = []
    real = P.level_scan_giant
    monkeypatch.setattr(P, "kernel_fits", lambda *a: False)
    monkeypatch.setattr(P, "level_scan_giant", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    return calls


def _port_case(modality, seed, dim=16):
    """A small plain batch and the port's 12 scan arguments (detached) on the
    CPU, from the port's own init, the level tables padded by two empty
    levels (as a bucketed L pads them)."""
    cfg = P.DGConfig(modality=modality, dim_hidden=dim, s_rounds=1, t_rounds=1, layernorm=True)
    params, _ = P.init_params(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    hb = collate([random_circuit(rng, modality, num_inputs=5, num_gates=30) for _ in range(3)])
    b = P.batch_to_device(hb, "cpu")
    with torch.no_grad():
        hs = P.struct_hs(params, b, cfg)
        args = [a.clone() for a in P.level_scan_inputs(params, b, cfg, hs)]
    args[:7] = [torch.cat([a, a.new_zeros((2,) + a.shape[1:])]) for a in args[:7]]
    return args, hs.shape[0], P.num_levels(hb)


# ---- the plain giant forward and backward against the JAX package ------------

@pytest.mark.parametrize("modality", ["aig", "mig", "xag", "xmg"])
def test_giant_plain_versions_match_jax_hbm_route_and_xla_scan(modality, monkeypatch):
    kw = dict(modality=modality, dim_hidden=32, s_rounds=1, t_rounds=1, layernorm=True)
    jcfg, pcfg = J.DGConfig(**kw), P.DGConfig(**kw)
    params, _ = J.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(6)
    hb = collate([random_circuit(rng, modality, num_inputs=6, num_gates=32) for _ in range(3)])
    batch = jax.tree.map(jnp.asarray, hb)
    N, D = hb["gate"].shape[0], 32
    tgt = np.random.default_rng(2).normal(size=(N, D)).astype(np.float32)
    valid = hb["node_valid"][:, None]

    def loss(p, use_pallas):
        _, hf, _ = J.forward(p, batch, jcfg, use_pallas=use_pallas, pallas_interpret=True)
        return jnp.sum(jnp.where(valid, (hf - tgt) ** 2, 0.0)), hf

    (_, hf_x), g_x = jax.value_and_grad(lambda p: loss(p, False), has_aux=True)(params)
    with monkeypatch.context() as m:
        m.setattr(JK, "kernel_fits", lambda *a: False)      # force the HBM route
        (_, hf_h), g_h = jax.value_and_grad(lambda p: loss(p, True), has_aux=True)(params)

    # the port: the whole forward by the giant route; the scan's backward
    # written out (level_scan_giant_bwd_reference), the rest by autograd
    calls = _force_giant(monkeypatch)
    pp = params_from_jax(_np(params), device="cpu")
    leaves = PS.param_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    b = P.batch_to_device(hb, "cpu")
    n_lv = P.num_levels(hb)
    hs, hf_auto, _ = P.forward_device(pp, b, pcfg, n_lv)
    assert len(calls) == 1
    args = P.level_scan_inputs(pp, b, pcfg, hs)
    det = [a.detach() for a in args]
    hf = level_kernel.level_scan_giant_reference(*det, num_nodes=N, num_levels=n_lv)
    assert torch.equal(hf, hf_auto.detach())
    mask, t_tgt = torch.tensor(valid), torch.tensor(tgt)
    ghf = torch.where(mask, 2.0 * (hf - t_tgt), 0.0)
    manual = level_kernel.level_scan_giant_bwd_reference(ghf, hf, *det, num_levels=n_lv)
    torch.autograd.backward([args[i] for i in FLOAT_ARGS], list(manual), retain_graph=True)
    g_manual = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy().copy()
                for t in leaves]
    for t in leaves:
        t.grad = None
    torch.where(mask, (hf_auto - t_tgt) ** 2, 0.0).sum().backward()
    g_auto = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
              for t in leaves]

    n = int(hb["n_nodes"])
    for hf_j in (hf_h, hf_x):
        np.testing.assert_allclose(hf.numpy()[:n], np.asarray(hf_j)[:n], rtol=1e-4, atol=1e-5)
    for g_j in (g_h, g_x):
        g_jl = _leaves(g_j)
        assert [g.shape for g in g_jl] == [g.shape for g in g_manual]
        scale = max(float(np.abs(g).max()) for g in g_jl)
        assert scale > 0
        for g_p in (g_manual, g_auto):
            for i, (a, c) in enumerate(zip(g_p, g_jl)):
                assert float(np.abs(a - c).max()) <= 1e-4 * max(scale, 1.0), (i, scale)


# ---- the two backward contracts ------------------------------------------------

@pytest.mark.parametrize("modality", ["aig", "mig", "xag", "xmg"])
def test_giant_bwd_reference_matches_autograd_and_the_residual_backward(modality):
    """Recomputing from the final hf gives what the saved residuals give
    (the same six outputs), and what autograd gives through the plain
    forward; d_pack's padding levels stay 0."""
    args, N, n_lv = _port_case(modality, seed=11)
    D = args[0].shape[2] - 2
    ghf = torch.tensor(np.random.default_rng(12).normal(size=(N, D)).astype(np.float32))
    hf, res_e, res_n = level_kernel.level_scan_reference(*args, num_nodes=N, num_levels=n_lv,
                                                         with_residuals=True)
    assert torch.equal(hf, level_kernel.level_scan_giant_reference(*args, num_nodes=N,
                                                                   num_levels=n_lv))
    giant = level_kernel.level_scan_giant_bwd_reference(ghf, hf, *args, num_levels=n_lv)
    saved = level_kernel.level_scan_bwd_reference(ghf, res_e, res_n, *args[:9], args[10],
                                                  args[11], num_levels=n_lv)
    live = [a.clone().requires_grad_(i in FLOAT_ARGS) for i, a in enumerate(args)]
    level_kernel.giant_launches = 0
    hf_w = level_kernel.level_scan_giant(*live, num_nodes=N, num_levels=n_lv)
    assert level_kernel.giant_launches == 0       # CPU tensors: the plain versions
    via = torch.autograd.grad(hf_w, [live[i] for i in FLOAT_ARGS], ghf)
    auto = torch.autograd.grad(
        level_kernel.level_scan_giant_reference(*live, num_nodes=N, num_levels=n_lv),
        [live[i] for i in FLOAT_ARGS], ghf)
    assert args[0].shape[0] >= n_lv + 2 and (giant[0][n_lv:] == 0).all()
    assert (giant[0][..., D + 1] == 0).all()      # the expert column
    for g, s, a, v in zip(giant, saved, auto, via):
        scale = float(a.abs().max())
        assert scale > 0
        assert float((g - s).abs().max()) <= 1e-6 * scale
        assert float((g - a).abs().max()) <= 1e-5 * scale
        assert float((v - a).abs().max()) <= 1e-5 * scale


# ---- routing ---------------------------------------------------------------------

def _spies(monkeypatch):
    """Replace both scans of ``models/dg_ae`` by recorders that return zeros."""
    calls = []

    def spy(name):
        def scan(*args, num_nodes, num_levels, lists=None, packed=None):
            calls.append(name)
            return args[0].new_zeros((num_nodes, args[0].shape[2] - 2))
        return scan

    monkeypatch.setattr(P, "level_scan", spy("fused"))
    monkeypatch.setattr(P, "level_scan_giant", spy("giant"))
    return calls


def test_giant_shape_routes_to_the_giant_scan(monkeypatch):
    """The example's shape at a quarter of its depth fails ``kernel_fits``,
    as tests/test_giant.py asserts for the JAX package, and
    ``level_recurrence`` sends it to ``level_scan_giant``; a small plain batch
    and a chunked batch keep the fused scan."""
    cfg = P.DGConfig(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
    params, _ = P.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    hb = collate([layered_circuit(rng, "mig", width=512, depth=50, num_tt_pairs=64)])
    n, ep, np_ = hb["gate"].shape[0], hb["lv_edge_src"].shape[-1], hb["lv_nodes"].shape[-1]
    assert not level_kernel.kernel_fits(n, ep, np_, 64)
    for dims in ((n, ep, np_, 64), (8192, 512, 512, 128), (8193, 8, 8, 64), (64, 513, 8, 64),
                 (64, 8, 513, 64), (64, 8, 8, 129)):    # both packages gate alike
        assert level_kernel.kernel_fits(*dims) == JK.kernel_fits(*dims), dims

    calls = _spies(monkeypatch)
    with torch.no_grad():
        P.forward(params, hb, cfg)
    assert calls == ["giant"]
    for t in PS.param_leaves(params):
        t.requires_grad_(True)
    del calls[:]
    P.forward(params, hb, cfg)                    # training: the same route
    assert calls == ["giant"]

    rng = np.random.default_rng(1)
    graphs = [random_circuit(rng, "mig", num_inputs=5, num_gates=24) for _ in range(4)]
    del calls[:]
    P.forward(params, collate(graphs), cfg)
    assert calls == ["fused"]
    del calls[:]
    P.forward(params, collate_chunked(graphs, 2), cfg)
    assert calls == ["fused", "fused"]


@pytest.mark.parametrize("n,ep,np_,serving,training", [
    (4096, 640, 320, "giant", "giant"),     # fails kernel_fits on Ep: a plain bs64 batch
    (8193, 512, 512, "giant", "giant"),     # fails it on N alone
    (4096, 4096, 2048, "giant", "giant"),   # past the JAX trainer's backward gate: no gate here
    (4096, 4097, 64, "giant", "giant"),     # past both of the JAX package's giant gates
    (8192, 512, 512, "fused", "fused"),     # passes kernel_fits
])
def test_unchunked_routing_by_shape(n, ep, np_, serving, training, monkeypatch):
    calls = _spies(monkeypatch)
    D, T = 8, 3
    args = [torch.zeros(s, dtype=dt) for s, dt in (
        [((1, ep, D + 2), torch.float32)] + [((1, ep), torch.int32)] * 3
        + [((1, np_), torch.int32)] * 3
        + [((D, 2 * T * D), torch.float32), ((D, 3 * T * D), torch.float32),
           ((T, 3 * D), torch.float32), ((T, 3 * D), torch.float32), ((T, D), torch.float32)])]
    P.level_recurrence(tuple(args), n, (1,))
    args[7].requires_grad_(True)
    P.level_recurrence(tuple(args), n, (1,))
    with torch.no_grad():
        P.level_recurrence(tuple(args), n, (1,))
    assert calls == [serving, training, serving]


def test_model_forward_of_one_large_graph_takes_the_giant_route(monkeypatch):
    """``Model.forward(g)`` and ``Model.forward([g])`` of one graph past the
    fused route's node gate: ``collate_fit`` of one graph is the plain batch
    (no chunk count can split a single graph), the giant scan runs once per
    call, and both calls give the rows of the fused scan on the same batch."""
    import mgvae_tpu_torch
    from mgvae_tpu_torch.data.batching import collate_fit, pick_chunks_for

    g = mgvae_tpu_torch.layered_circuit(np.random.default_rng(4), "mig", width=48, depth=12,
                                        num_inputs=8, num_tt_pairs=16)
    assert pick_chunks_for([g], 16) == 1
    fit, plain = collate_fit([g]), mgvae_tpu_torch.collate([g])
    assert fit["lv_nodes"].ndim == 2 and fit["lv_nodes"].shape == plain["lv_nodes"].shape
    monkeypatch.setattr(level_kernel, "KERNEL_MAX_NODES", 256)     # the graph now fails the gate
    n, ep, np_ = plain["gate"].shape[0], plain["lv_edge_src"].shape[1], plain["lv_nodes"].shape[1]
    assert not level_kernel.kernel_fits(n, ep, np_, 16)
    calls, real = [], P.level_scan_giant
    monkeypatch.setattr(P, "level_scan_giant", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    model = mgvae_tpu_torch.Model(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1,
                                  layernorm=True, device="cpu")
    hs_g, hf_g = model(g)
    hs_l, hf_l = model([g])
    assert len(calls) == 2
    assert hs_g.shape == hf_g.shape == (g.num_nodes, 16)
    assert torch.equal(hs_g, hs_l) and torch.equal(hf_g, hf_l)
    assert torch.isfinite(hf_g).all() and float(hf_g.abs().max()) > 0
    monkeypatch.setattr(level_kernel, "KERNEL_MAX_NODES", 1 << 30)  # the fused scan again
    hs_f, hf_f = model(g)
    assert len(calls) == 2
    assert torch.equal(hs_f, hs_g) and torch.equal(hf_f, hf_g)


# ---- the giant example's train step at mini scale ------------------------------------

def test_giant_train_step_matches_jax_at_mini_scale(monkeypatch):
    """The giant example's train step (tests/test_giant.py:46-64 is the JAX
    side) in both packages from the same params, negatives and dropout masks;
    the port's level recurrence forced to the giant route."""
    lr = 1e-3
    kw = dict(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
    jcfg, pcfg = J.DGConfig(**kw), P.DGConfig(**kw)
    rng = np.random.default_rng(1)
    hb = collate([layered_circuit(rng, "mig", width=16, depth=6, num_inputs=8, num_tt_pairs=24)])
    batch = jax.tree.map(jnp.asarray, hb)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    key, w = jax.random.PRNGKey(1), jnp.asarray(WEIGHTS)
    (_, _), g_j = jax.value_and_grad(
        lambda p: JS.loss_and_metrics(p, state, batch, key, w, cfg=jcfg, train=True),
        has_aux=True)(params)
    opt = JS.make_optimizer(lr)
    j_step, _ = JS.make_train_step(jcfg, opt, None, donate=False)
    p1_j, s1_j, _, m_j = j_step(params, state, opt.init(params), batch, key, w)

    _, k_neg, k_drop = jax.random.split(key, 3)
    neg = tuple(torch.tensor(np.asarray(x))
                for x in JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0], batch))
    keep = [torch.tensor(np.asarray(jax.random.bernoulli(k, 0.8, (hb["gate"].shape[0],
                                                                   pcfg.dim_mlp))))
            for k in jax.random.split(k_drop, 2)]
    calls = _force_giant(monkeypatch)
    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    p_step, _ = PS.make_train_step(pcfg, PS.make_optimizer(pp, lr))
    s1_p, m_p = p_step(pp, ps, hb, None, WEIGHTS, neg_edges=neg, drop_keep=keep)
    assert len(calls) == 1
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    for a, c in zip(_leaves(params_to_numpy(s1_p)), _leaves(s1_j)):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
    g = _leaves(g_j)
    scale = max(float(np.abs(x).max()) for x in g)
    for a, c, gj in zip(_leaves(params_to_numpy(pp)), _leaves(p1_j), g):
        d = np.abs(a - c)
        assert np.isfinite(a).all() and d.max() <= 2 * lr
        assert (d[np.abs(gj) > 1e-5 * scale] <= 1e-3 * lr).all()


# ---- the struct remat ------------------------------------------------------------------

def test_remat_struct_gives_the_same_forward_and_gradients(monkeypatch):
    def run(remat):
        cfg = P.DGConfig(modality="mig", dim_hidden=16, s_rounds=2, t_rounds=2, layernorm=True,
                         remat_struct=remat)
        params, state = P.init_params(cfg, seed=5, device="cpu")
        leaves = PS.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        rng = np.random.default_rng(3)
        hb = collate([layered_circuit(rng, "mig", width=12, depth=5, num_inputs=6,
                                      num_tt_pairs=16)])
        towers, real = [], P.direct_multigcn_apply
        monkeypatch.setattr(P, "direct_multigcn_apply",
                            lambda *a: (towers.append(1), real(*a))[1])
        b = P.batch_to_device(hb, "cpu")
        hs, hf, _ = P.forward_device(params, b, cfg, P.level_counts(hb))
        total, _ = PS.losses_from_forward(params, state, b, hs, hf,
                                          torch.Generator().manual_seed(0), WEIGHTS, cfg, True)
        total.backward()
        monkeypatch.setattr(P, "direct_multigcn_apply", real)
        grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in leaves]
        return len(towers), hs.detach(), hf.detach(), grads

    n_off, hs_off, hf_off, g_off = run(False)
    n_on, hs_on, hf_on, g_on = run(True)
    assert (n_off, n_on) == (1, 2)                # the backward ran the towers again
    assert torch.equal(hs_on, hs_off) and torch.equal(hf_on, hf_off)
    for a, c in zip(g_on, g_off):
        assert float((a - c).abs().max()) <= 1e-6 * max(float(c.abs().max()), 1e-30)


def test_remat_struct_auto_rule():
    auto = P.DGConfig()
    assert auto.remat_struct is None
    assert P.REMAT_STRUCT_NODES == JK.HBM_COMPILE_SAFE_NODES == 131_072
    assert not P.remat_struct(auto, 114_688)       # the example at depth 200
    assert not P.remat_struct(auto, 131_072)
    assert P.remat_struct(auto, 131_073)
    assert P.remat_struct(auto, 524_288)           # depth 1000
    assert P.remat_struct(P.DGConfig(remat_struct=True), 128)
    assert not P.remat_struct(P.DGConfig(remat_struct=False), 10**6)
