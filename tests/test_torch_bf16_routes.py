"""bf16 values on the giant and step routes of the port's level recurrence
(TPU kernels 3 to 6) against the JAX package's bf16 path.

The plain versions of the four kernels are held against the JAX package's
Pallas kernels in interpret mode and their VJPs on the same bf16 inputs:
the giant forward and backward against ``pallas_level_scan_hbm`` called on
the tables, the single-level step against ``pallas_level_step``, the step
route against ``_level_scan_step`` (jitted with every bf16 rounding kept,
``_strict``). The giant backward rounds where the JAX giant kernel rounds
(fp32 ghf stream, fp32 recompute), not where the fused backward does: the
test shows it nearer JAX than the fused backward's rounding of the same
sweep. Then the whole bf16 model on a giant-routed and a step-routed batch
(``kernel_fits`` patched to False in both packages, as
tests/test_torch_giant.py forces the JAX HBM route), and one bf16 Adam step
on the step route, against ``J.forward(..., use_pallas=True,
pallas_interpret=True)`` and ``make_train_step``.

Tolerances are those of tests/test_torch_bf16.py: two bf16 paths with the
same rounding points within KERNEL_ULPS (2^-6) of each output's own scale,
the model's hs and hf likewise, its gradient leaves within LEAF_TOL (2^-4)
of theirs; the JAX package's bounds (values atol 2e-2 / rtol 1e-1,
gradients 0.05 * max(scale, 1)) hold as well. Each test prints its maxima.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgvae_tpu.ops.pallas.level_kernel as JK
from mgvae_tpu.data.batching import collate, collate_chunked
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import level_kernel
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax
from test_torch_bf16 import (KERNEL_ULPS, VAL_ATOL, WEIGHTS, _configs, _f32, _kernel_path_step,
                             _leaf_names, _leaves_close, _np, _np_leaves, _strict, _ulps_close,
                             _values_close)
from test_torch_giant import _port_case
from test_torch_level_step import _case as _step_case
from test_torch_level_step import _jax_args as _step_jax_args
from test_torch_level_step import _port_args as _step_port_args
from test_torch_step_route import _case as _route_case

torch.set_num_threads(1)
BF16 = torch.bfloat16
FLOAT_ARGS = level_kernel.FLOAT_ARGS
NAMES = ("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak")


def _bf16(args, floats=FLOAT_ARGS):
    """The float arguments rounded to bf16 (the tables as they are), for
    the port and, with the same values, for JAX."""
    t16 = [a.to(BF16) if i in floats else a for i, a in enumerate(args)]
    j16 = [jnp.asarray(a.float().numpy(), jnp.bfloat16) if i in floats else jnp.asarray(a.numpy())
           for i, a in enumerate(t16)]
    return t16, j16


def _cotangent(shape, seed):
    return torch.tensor(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(BF16)


def _rel_err(got, want):
    """max |got - want| over max |want|, both as fp32."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


# ---- kernels 3 and 4: the giant route -------------------------------------------

@functools.lru_cache(maxsize=None)
def _giant_case(modality, seed):
    """bf16 scan arguments (port, JAX) of a small plain batch, its cotangent,
    and JAX's giant forward and VJP on them (interpret mode)."""
    args, N, n_lv = _port_case(modality, seed, dim=32)
    t16, j16 = _bf16(args)
    D, T = args[0].shape[2] - 2, args[11].shape[0]
    ghf = _cotangent((N, D), seed + 1)

    def scan(*floats):
        full = list(j16)
        for i, x in zip(FLOAT_ARGS, floats):
            full[i] = x
        return JK.pallas_level_scan_hbm(*full, N, D, T, True, "highest")

    hf_j, vjp = jax.vjp(scan, *(j16[i] for i in FLOAT_ARGS))
    grads_j = vjp(jnp.asarray(ghf.float().numpy(), jnp.bfloat16))
    return t16, N, n_lv, ghf, hf_j, grads_j


@pytest.mark.parametrize("modality", ["aig", "mig"])
def test_giant_forward_bf16_matches_jax_hbm_kernel(modality):
    """``level_scan_giant_reference`` on bf16 values against
    ``pallas_level_scan_hbm`` (kernel 3 in interpret mode): hf bf16, within
    one ulp of its scale; it is the fused plain forward without residuals,
    and the wrapper on CPU tensors gives it."""
    t16, N, n_lv, _, hf_j, _ = _giant_case(modality, 11)
    hf = level_kernel.level_scan_giant_reference(*t16, num_nodes=N, num_levels=n_lv)
    assert hf.dtype == BF16 and hf.abs().max() > 0
    _values_close(hf, hf_j, VAL_ATOL, f"{modality} giant hf")
    _ulps_close(hf, hf_j, f"{modality} giant hf")
    fused = level_kernel.level_scan_reference(*t16, num_nodes=N, num_levels=n_lv,
                                              with_residuals=True)[0]
    assert torch.equal(hf, fused)
    assert torch.equal(level_kernel.level_scan_giant(*t16, num_nodes=N, num_levels=n_lv), hf)


@pytest.mark.parametrize("modality", ["mig", "xmg"])
def test_giant_bwd_bf16_follows_the_giant_kernels_rounding(modality):
    """``level_scan_giant_bwd_reference`` on bf16 values against the VJP of
    ``pallas_level_scan_hbm`` (kernel 4, interpret mode): every output in
    its dtype and within KERNEL_ULPS of its scale. The fused backward's
    rounding of the same sweep (bf16 residuals, a bf16 ghf carried back)
    lies further from JAX: the plain version follows kernel 4's rounding
    points. Training through the wrapper on CPU tensors (``_LevelScanGiant``
    with both plain versions) gives the plain version's outputs."""
    t16, N, n_lv, ghf, hf_j, grads_j = _giant_case(modality, 13)
    hf = level_kernel.level_scan_giant_reference(*t16, num_nodes=N, num_levels=n_lv)
    ours = level_kernel.level_scan_giant_bwd_reference(ghf, hf, *t16, num_levels=n_lv)
    assert all(g.dtype == BF16 for g in ours)
    _, res_e, res_n = level_kernel.level_scan_reference(*t16, num_nodes=N, num_levels=n_lv,
                                                        with_residuals=True)
    fused = level_kernel.level_scan_bwd_reference(ghf, res_e, res_n, *t16[:9], t16[10], t16[11],
                                                  num_levels=n_lv)
    near = far = 0.0
    for name, o, f, j in zip(NAMES, ours, fused, grads_j):
        _ulps_close(o, j, f"{modality} {name}")
        near, far = near + _rel_err(o, j), far + _rel_err(f, j)
    print(f"{modality}: summed max|d|/scale against JAX: giant rounding {near:.3e}, fused "
          f"backward's rounding {far:.3e}")
    assert near < 0.5 * far, (near, far)

    leaves = [t.clone().requires_grad_(i in FLOAT_ARGS) for i, t in enumerate(t16)]
    level_kernel.level_scan_giant(*leaves, num_nodes=N, num_levels=n_lv).backward(ghf)
    (L, ep, pw), np_ = t16[0].shape, t16[4].shape[1]
    K = level_kernel.giant_chunk_levels(ep, np_, pw - 2, L, N, t16[11].shape[0])
    want = level_kernel.level_scan_giant_bwd_reference(ghf, hf, *t16, num_levels=n_lv,
                                                       chunk_levels=K)
    for i, w in zip(FLOAT_ARGS, want):
        assert torch.equal(leaves[i].grad, w), i


@pytest.mark.parametrize("chunks", ["one", "ragged", "all"])
def test_giant_bwd_bf16_chunks_change_only_the_weight_sums(chunks):
    """In bf16 as in fp32 the chunks of levels only regroup the weight
    gradients' fp32 sums: d_pack equal bit for bit to the per-level order,
    the weight gradients (rounded once to bf16) within KERNEL_ULPS of their
    scale."""
    t16, N, n_lv, ghf, _, _ = _giant_case("mig", 11)
    k = {"one": 1, "ragged": 3, "all": n_lv}[chunks]
    assert chunks != "ragged" or n_lv % k
    hf = level_kernel.level_scan_giant_reference(*t16, num_nodes=N, num_levels=n_lv)
    per_level = level_kernel.level_scan_giant_bwd_reference(ghf, hf, *t16, num_levels=n_lv)
    chunked = level_kernel.level_scan_giant_bwd_reference(ghf, hf, *t16, num_levels=n_lv,
                                                          chunk_levels=k)
    assert torch.equal(chunked[0], per_level[0])
    for name, c, p in zip(NAMES[1:], chunked[1:], per_level[1:]):
        _ulps_close(c, p, f"K={k} {name}")
        if k == 1:
            assert torch.equal(c, p)


# ---- kernels 5 and 6: the single-level step and the step route ---------------

@pytest.mark.parametrize("modality", ["mig", "xag"])
def test_level_step_bf16_matches_pallas_level_step(modality):
    """``level_step_reference`` / ``level_step_bwd_reference`` on bf16 values
    against ``pallas_level_step`` (kernels 5 and 6, interpret mode) and its
    VJP: h_new and all seven cotangents bf16 (the weight gradients rounded
    from fp32 sums) within KERNEL_ULPS of their scale; training through the
    wrapper on CPU tensors (``_LevelStep``) gives the plain versions'."""
    cfg, args = _step_case(modality, seed=4)
    D, T = cfg.dim_hidden, cfg.num_experts
    floats = (0, 1, 8, 9, 10, 11, 12)                  # the JAX step's float arguments
    args = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) if i in floats else a
            for i, a in enumerate(args)]
    ja = [x.astype(jnp.bfloat16) if i in floats else x
          for i, x in enumerate(_step_jax_args(cfg, args))]

    def step(hf, pack, wkv, wih, bih, bhh, wak):
        return JK.pallas_level_step(hf, pack, *ja[2:8], wkv, wih, bih, bhh, wak, D, T, True,
                                    "highest")

    h_j, vjp = jax.vjp(step, ja[0], ja[1], *ja[8:])
    g = _cotangent(h_j.shape, 5)
    grads_j = list(vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16)))
    grads_j[1] = grads_j[1][:, : D + 2]

    t = [x.to(BF16) if i in level_kernel.STEP_FLOAT_ARGS else x
         for i, x in enumerate(_step_port_args(args))]
    h_p, res_e, res_n = level_kernel.level_step_reference(*t, with_residuals=True)
    assert h_p.dtype == res_e.dtype == res_n.dtype == BF16
    _ulps_close(h_p, h_j, f"{modality} h_new")
    d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak, d_hf = level_kernel.level_step_bwd_reference(
        g, res_e, res_n, *t[1:9], t[10], t[11], num_nodes=args[0].shape[0])
    assert d_hf.dtype == d_pack.dtype == BF16
    manual = (d_hf, d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak)
    for name, m, j in zip(("d_hf",) + NAMES, manual, grads_j):
        assert tuple(m.shape) == tuple(j.shape), name
        _ulps_close(m, j, f"{modality} {name}")

    tg = [x.clone().requires_grad_(i in level_kernel.STEP_FLOAT_ARGS) for i, x in enumerate(t)]
    h_w = level_kernel.level_step(*tg)
    assert torch.equal(h_w.detach(), h_p) and h_w.grad_fn is not None
    h_w.backward(g)
    for i, m in zip(level_kernel.STEP_FLOAT_ARGS, manual):
        assert torch.equal(tg[i].grad, m.to(tg[i].dtype)), i


def test_step_route_bf16_matches_jax_level_scan_step():
    """``level_scan_step_reference`` / ``level_scan_step_bwd_reference`` on
    bf16 values (hf and its cotangent carried in bf16) against ``jax.vjp`` of
    ``_level_scan_step`` over the bf16 step kernels, jitted with every bf16
    rounding kept (``_strict``), on two chunks of unequal real levels: hf
    and the six cotangents within KERNEL_ULPS of their scale, at K = 1 and
    in the kernel's blocks; training through ``level_scan_step`` on CPU
    tensors (``_LevelScanStep``) gives the plain versions' outputs."""
    args, n_levels, n_sub = _route_case()
    t16, j16 = _bf16(args)
    D, T = args[0].shape[2] - 2, args[11].shape[0]
    C, L = 2, args[0].shape[0] // 2
    ghf = _cotangent((C * n_sub, D), 6)
    lv_off = jnp.repeat(jnp.arange(C, dtype=jnp.int32) * n_sub, L)

    def vjp(pack_lv, wkv, wih, bih, bhh, wak, g):
        def route(pack_lv, wkv, wih, bih, bhh, wak):
            pack_lv = jnp.pad(pack_lv, ((0, 0), (0, 0), (0, JK.LANE - D - 2)))
            return J._level_scan_step((pack_lv, *j16[1:7], wkv, wih, bih, bhh, wak), lv_off,
                                      C * n_sub, n_sub, D, T, True, "highest")
        hf, back = jax.vjp(route, pack_lv, wkv, wih, bih, bhh, wak)
        return hf, back(g)

    hf_j, grads_j = _strict(jax.jit(vjp), j16[0], *j16[7:],
                            jnp.asarray(ghf.float().numpy(), jnp.bfloat16))
    hf, res_e, res_n = level_kernel.level_scan_step_reference(*t16, n_levels, n_sub,
                                                              with_residuals=True)
    assert hf.dtype == res_e.dtype == BF16 and hf_j.dtype == jnp.bfloat16
    _ulps_close(hf, hf_j, "route hf")
    bargs = (*t16[:9], t16[10], t16[11])
    K = level_kernel.step_chunk_levels(t16[0].shape[1], t16[4].shape[1], D, L, C, C * n_sub, T)
    for k in (1, K):
        grads = level_kernel.level_scan_step_bwd_reference(ghf, res_e, res_n, *bargs, n_levels,
                                                           n_sub, chunk_levels=k)
        for name, x, j in zip(NAMES, grads, grads_j):
            assert x.dtype == BF16, name
            _ulps_close(x, j, f"route K={k} {name}")

    leaves = [a.clone().requires_grad_(i in FLOAT_ARGS) for i, a in enumerate(t16)]
    hf_w = level_kernel.level_scan_step(*leaves, n_levels=n_levels, n_sub=n_sub)
    assert torch.equal(hf_w.detach(), hf)
    hf_w.backward(ghf)
    for i, x in zip(FLOAT_ARGS, grads):
        assert torch.equal(leaves[i].grad, x), i


# ---- the whole model on both routes --------------------------------------------

def _route_batch(route, seed):
    rng = np.random.default_rng(seed)
    graphs = [random_circuit(rng, "mig", num_inputs=6, num_gates=40 + 4 * i, num_tt_pairs=24)
              for i in range(4)]
    return collate(graphs) if route == "giant" else collate_chunked(graphs, 2)


def _force_route(monkeypatch, route):
    """Both packages past their fused gate: a plain batch takes the giant
    route, a chunked one the step route; the port's route functions count
    their calls."""
    monkeypatch.setattr(JK, "kernel_fits", lambda *a: False)
    monkeypatch.setattr(P, "kernel_fits", lambda *a: False)
    name = "level_scan_giant" if route == "giant" else "level_scan_step"
    real, calls = getattr(P, name), []
    monkeypatch.setattr(P, name, lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    return calls


@pytest.mark.parametrize("route", ["giant", "step"])
def test_bf16_model_matches_jax_on_the_giant_and_step_routes(route, monkeypatch):
    """hs and hf of the bf16 forward, and the fp32 master gradients of a
    loss on both, by the giant route (a plain batch) and by the step route
    (two chunks), against the JAX package's bf16 kernel path forced to the
    same route: hs / hf within one ulp of their scale, each gradient leaf
    within LEAF_TOL of its own."""
    calls = _force_route(monkeypatch, route)
    jcfg, jcfg16, pcfg16 = _configs()
    params, _ = J.init_params(jax.random.PRNGKey(3), jcfg)
    hb = _route_batch(route, 12)
    batch = jax.tree.map(jnp.asarray, hb)
    n, D = hb["gate"].shape[0], jcfg.dim_hidden
    tgt = np.random.default_rng(7).normal(size=(2, n, D)).astype(np.float32)
    m = np.asarray(hb["node_valid"])[:, None]

    def jloss(p):
        hs, hf, _ = J.forward(p, batch, jcfg16, use_pallas=True, pallas_interpret=True)
        return (jnp.sum(jnp.where(m, (hf.astype(jnp.float32) - tgt[0]) ** 2, 0.0))
                + jnp.sum(jnp.where(m, (hs.astype(jnp.float32) - tgt[1]) ** 2, 0.0))), (hs, hf)

    (_, (hs_j, hf_j)), g_j = _strict(jax.jit(jax.value_and_grad(jloss, has_aux=True)), params)
    assert hf_j.dtype == jnp.bfloat16
    pparams = params_from_jax(_np(params), device="cpu")
    leaves = PS.param_leaves(pparams)
    for t in leaves:
        t.requires_grad_(True)
    hs, hf, _ = P.forward(pparams, hb, pcfg16)
    assert hs.dtype == hf.dtype == BF16 and len(calls) == 1
    valid = m[:, 0]
    _ulps_close(hs[valid], np.asarray(hs_j)[valid], f"{route} hs")
    _ulps_close(hf[valid], np.asarray(hf_j)[valid], f"{route} hf")
    mt = torch.tensor(m)
    loss = (torch.where(mt, (hf.float() - torch.tensor(tgt[0])) ** 2, 0.0).sum()
            + torch.where(mt, (hs.float() - torch.tensor(tgt[1])) ** 2, 0.0).sum())
    loss.backward()
    g_p = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves]
    assert all(t.grad is None or t.grad.dtype == torch.float32 for t in leaves)
    _leaves_close(g_p, jax.tree.leaves(g_j), _leaf_names(params), f"{route} gradients")


def _step_batch_case(seed):
    """The JAX params and state, a two-chunk batch of ``seed`` (host and
    JAX), the step's key, and JAX's negative-edge and dropout draws of that
    key as the port takes them."""
    jcfg, _, pcfg16 = _configs()
    params, state = J.init_params(jax.random.PRNGKey(6), jcfg)
    hb = _route_batch("step", seed)
    batch = jax.tree.map(jnp.asarray, hb)
    key = jax.random.PRNGKey(8)
    _, k_neg, k_drop = jax.random.split(key, 3)
    neg = tuple(torch.tensor(np.asarray(x)) for x in
                JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0], batch))
    n = hb["gate"].shape[0]
    keep = [torch.tensor(np.asarray(jax.random.bernoulli(k, 0.8, (n, pcfg16.dim_mlp))))
            for k in jax.random.split(k_drop, 2)]
    return params, state, hb, batch, key, neg, keep


def _port_grads(case, cfg):
    """The port's master gradients of one loss_and_metrics on the case."""
    params, state, hb, _, _, neg, keep = case
    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    leaves = PS.param_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    total, _ = PS.loss_and_metrics(pp, ps, hb, None, WEIGHTS, cfg, True, neg_edges=neg,
                                   drop_keep=keep)
    total.backward()
    return [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves]


def _jax_grads(case, cfg, strict=True):
    params, state, _, batch, key, _, _ = case
    grad = jax.jit(jax.grad(lambda p: JS.loss_and_metrics(p, state, batch, key,
                                                          jnp.asarray(WEIGHTS), cfg, True)[0]))
    return [_f32(g) for g in jax.tree.leaves(_strict(grad, params) if strict else grad(params))]


def test_bf16_adam_step_on_the_step_route_matches_jax(monkeypatch):
    """One bf16 train step (fp32 master params) on a two-chunk batch by the
    step route against the JAX package's ``make_train_step`` on its step
    kernels, with the same draws: the losses within the JAX bounds, the
    gradient leaves within LEAF_TOL of their scale, and Adam's first step
    the same on every element whose two gradients are well apart from 0.
    (Seed 13's batch: ``test_bf16_gap_to_jax_at_seed_13_is_bf16_rounding``.)"""
    lr = 1e-3
    _kernel_path_step(monkeypatch)
    calls = _force_route(monkeypatch, "step")
    jcfg, jcfg16, pcfg16 = _configs()
    case = _step_batch_case(14)
    params, state, hb, batch, key, neg, keep = case
    opt = JS.make_optimizer(lr)
    j_step, _ = JS.make_train_step(jcfg16, opt, mesh=None, donate=False)
    step_args = (params, state, opt.init(params), batch, key, jnp.asarray(WEIGHTS))
    p1_j, _, _, m_j = _strict(j_step, *step_args)
    g_j = _jax_grads(case, jcfg16)

    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    p_step, _ = PS.make_train_step(pcfg16, PS.make_optimizer(pp, lr))
    _, m_p = p_step(pp, ps, hb, None, WEIGHTS, neg_edges=neg, drop_keep=keep)
    assert len(calls) == 1
    for k in ("recon_loss", "prob_loss", "func_loss", "loss"):
        got, want = float(m_p[k]), float(m_j[k])
        print(f"{k}: port {got:.6f} JAX {want:.6f}")
        assert abs(got - want) <= VAL_ATOL + 0.1 * abs(want), k
    leaves = PS.param_leaves(pp)
    g_p = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves]
    _leaves_close(g_p, g_j, _leaf_names(params), "step-route step gradients")
    held = nonzero = 0
    for a, c, gp, gj in zip(_np_leaves(params_to_numpy(pp)), _np_leaves(p1_j), g_p, g_j):
        d, gj = np.abs(a - c), np.asarray(gj)
        assert d.max() <= 2 * lr + 1e-6
        big = (np.abs(gj) > 4 * np.abs(gp - gj)) & (np.abs(gj) > 1e-5)
        assert (d[big] <= 1e-3 * lr).all()
        held, nonzero = held + int(big.sum()), nonzero + int((gj != 0).sum())
    print(f"Adam update held on {held} of the {nonzero} elements with a gradient")
    assert held >= nonzero // 2


@pytest.mark.parametrize("seed", [13, 14])
def test_bf16_step_route_gradients_equal_the_fused_routes(seed, monkeypatch):
    """The Adam tests' two-chunk batch in bf16 by the step route and by the
    fused route (the struct towers and the rest of the model shared): every
    master gradient leaf within KERNEL_ULPS of its own scale, so the step
    route's kernels 5 and 6 add nothing to a gap against JAX there."""
    _, _, pcfg16 = _configs()
    case = _step_batch_case(seed)
    fused = _port_grads(case, pcfg16)
    calls = _force_route(monkeypatch, "step")
    step = _port_grads(case, pcfg16)
    assert len(calls) == 1
    worst = (0.0, "")
    for name, a, c in zip(_leaf_names(case[0]), step, fused):
        err, scale = float(np.abs(a - c).max()), float(np.abs(c).max())
        worst = max(worst, (err / scale if scale else err, name))
        assert err <= KERNEL_ULPS * scale, (name, err, scale)
    print(f"seed {seed}: step route against fused route, worst leaf {worst[1]} at "
          f"{worst[0]:.3e} of its scale")


def test_bf16_gap_to_jax_at_seed_13_is_bf16_rounding(monkeypatch):
    """Seed 13's two-chunk batch: the port's bf16 step-route gradients
    against JAX's bf16 ones (``make_train_step``'s loss on its step kernels)
    as ``_leaves_close`` holds them, the JAX package's bound over all leaves
    and every leaf within LEAF_TOL of its scale. ``['struct']['source']['ln']['w']``
    missed LEAF_TOL here, 8.8% of its scale, while the losses rounded their
    norms and z-score rsqrt elsewhere than JAX (torch's vector_norm and CPU
    rsqrt, ``train/losses.func_loss``); a pair near the func loss's L1 kink
    turned that over. The port now rounds where JAX does."""
    _kernel_path_step(monkeypatch)
    calls = _force_route(monkeypatch, "step")
    _, jcfg16, pcfg16 = _configs()
    case = _step_batch_case(13)
    g_p, g_j16 = _port_grads(case, pcfg16), _jax_grads(case, jcfg16)
    assert len(calls) == 1
    _leaves_close(g_p, g_j16, _leaf_names(case[0]), "seed 13")
