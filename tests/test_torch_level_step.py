"""The port's single-level step (mgvae_tpu_torch.ops.level_kernel.level_step)
against the JAX package's ``level_step_call`` / ``pallas_level_step`` in
interpret mode, on one level of a chunk of a chunked batch with a non-zero
hf. Both packages get the same pack, tables and hf, built by the JAX
package. Tolerances are the JAX package's own (tests/test_pallas_kernel.py):
h_new atol 1e-5 / rtol 1e-4; each cotangent 1e-4 * max(its largest entry, 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgvae_tpu.data.batching import collate_chunked
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.ops.pallas.level_kernel import LANE, level_step_call, pallas_level_step
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import level_kernel

torch.set_num_threads(1)
NAMES = ("d_hf", "d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak")


def _case(modality, seed=3, level=None):
    """One level of chunk 1 of a two-chunk batch, from the JAX package:
    (cfg, the JAX step's 13 array arguments as numpy, hf included)."""
    cfg = J.DGConfig(modality=modality, dim_hidden=32, s_rounds=1, t_rounds=1, layernorm=True)
    params, _ = J.init_params(jax.random.PRNGKey(2), cfg)
    rng = np.random.default_rng(seed)
    graphs = [random_circuit(rng, modality, num_inputs=5, num_gates=24 + 4 * i)
              for i in range(4)]
    batch = jax.tree.map(jnp.asarray, collate_chunked(graphs, 2))
    hs, hf, _ = J.forward(params, batch, cfg)
    expert = cfg.expert_of_gate[batch["gate"]]
    pack, wkv_hf = J._level_statics(params, batch, cfg, hs, expert)
    n_sub = hs.shape[0] // 2
    lv = int(np.asarray(batch["forward_level"])[n_sub:].max()) // 2 if level is None else level
    nodes = batch["lv_nodes"][1, lv]
    e_nodes = expert[nodes + n_sub]
    ex = params["experts"]
    args = (hf[n_sub:], pack[batch["lv_edge_id"][1, lv]], batch["lv_edge_src"][1, lv],
            batch["lv_edge_dst_slot"][1, lv], batch["lv_edge_valid"][1, lv].astype(jnp.int32),
            nodes, (batch["lv_node_valid"][1, lv] & (e_nodes >= 0)).astype(jnp.int32),
            jnp.maximum(e_nodes, 0), wkv_hf, ex["w_ih"], ex["b_ih"], ex["b_hh"], ex["wa_k"])
    return cfg, [np.asarray(a) for a in args]


def _jax_args(cfg, args):
    """The JAX package pads the pack to a lane-aligned width (dg_ae.py:574)."""
    a = [jnp.asarray(x) for x in args]
    a[1] = jnp.pad(a[1], ((0, 0), (0, LANE - cfg.dim_hidden - 2)))
    return a


def _port_args(args, grad=False):
    """The port's step takes no ``nodes`` (argument 5 of the JAX step)."""
    t = [torch.tensor(a) for i, a in enumerate(args) if i != 5]
    if grad:
        for i in level_kernel.STEP_FLOAT_ARGS:
            t[i].requires_grad_(True)
    return t


@pytest.mark.parametrize("modality", ["aig", "mig", "xmg"])
def test_level_step_matches_pallas_interpret(modality):
    cfg, args = _case(modality)
    assert np.abs(args[0]).max() > 0 and args[6].sum() > 0 and args[4].sum() > 0
    h_j = level_step_call(*_jax_args(cfg, args), dim=cfg.dim_hidden,
                          num_experts=cfg.num_experts, interpret=True, precision="highest")
    t = _port_args(args)
    level_kernel.step_launches = 0
    h_p = level_kernel.level_step(*t)
    assert level_kernel.step_launches == 0          # CPU tensors: the plain version
    assert torch.equal(h_p, level_kernel.level_step_reference(*t))
    assert h_p.shape == (args[5].shape[0], cfg.dim_hidden) and np.abs(h_p.numpy()).max() > 0
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("modality", ["mig", "xag"])
def test_level_step_bwd_matches_pallas_vjp_interpret(modality):
    """All seven cotangents, d_hf included, of the written-out backward on
    the port's residuals and of autograd through the plain forward, against
    jax.vjp of the custom VJP ``pallas_level_step`` (kernels 5 and 6)."""
    cfg, args = _case(modality, seed=4)
    D, T = cfg.dim_hidden, cfg.num_experts
    ja = _jax_args(cfg, args)

    def step(hf, pack, wkv, wih, bih, bhh, wak):
        return pallas_level_step(hf, pack, *ja[2:8], wkv, wih, bih, bhh, wak, D, T, True,
                                 "highest")

    h_j, vjp = jax.vjp(step, ja[0], ja[1], *ja[8:])
    g = np.random.default_rng(5).normal(size=h_j.shape).astype(np.float32)
    grads_j = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    assert (grads_j[1][:, D + 2 :] == 0).all()
    grads_j[1] = grads_j[1][:, : D + 2]

    t = _port_args(args)
    h_p, res_e, res_n = level_kernel.level_step_reference(*t, with_residuals=True)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), rtol=1e-4, atol=1e-5)
    d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak, d_hf = level_kernel.level_step_bwd_reference(
        torch.tensor(g), res_e, res_n, *t[1:9], t[10], t[11], num_nodes=args[0].shape[0])
    manual = (d_hf, d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak)
    tg = _port_args(args, grad=True)
    auto = torch.autograd.grad(level_kernel.level_step_reference(*tg),
                               [tg[i] for i in level_kernel.STEP_FLOAT_ARGS], torch.tensor(g))
    for name, m, a, j in zip(NAMES, manual, auto, grads_j):
        assert m.shape == a.shape == j.shape, name
        scale = float(np.abs(j).max())
        assert scale > 0, name
        for p in (m, a):
            assert float(np.abs(p.numpy() - j).max()) <= 1e-4 * max(scale, 1.0), name
    assert (d_pack[:, D + 1] == 0).all()                       # the expert column
    # d_hf reaches only the level's sources
    touched = np.zeros(args[0].shape[0], bool)
    touched[args[2][args[4] > 0]] = True
    assert (d_hf.numpy()[~touched] == 0).all() and np.abs(d_hf.numpy()[touched]).max() > 0


def test_level_step_rows_not_updated_are_zero():
    """Slots with upd == 0 (padding slots, gates without an expert) give
    h_new = 0, zero residual rows and no gradient, whatever g holds there."""
    cfg, args = _case("mig", seed=6)
    args[6] = args[6].copy()
    args[6][0] = 0                                             # switch one real slot off
    t = _port_args(args)
    h, res_e, res_n = level_kernel.level_step_reference(*t, with_residuals=True)
    off = t[5] == 0
    assert off.any() and (~off).any()
    assert (h[off] == 0).all() and (res_n[off] == 0).all() and (h[~off].abs().sum(1) > 0).all()
    dead = (t[4] == 0) | off[t[3].long()]
    assert (res_e[dead] == 0).all() and (res_e[~dead][:, -1] > 0).all()
    g = torch.ones_like(h)
    g_masked = torch.where(off[:, None], 0.0, g)
    bargs = (*t[1:9], t[10], t[11])
    a = level_kernel.level_step_bwd_reference(g, res_e, res_n, *bargs, num_nodes=t[0].shape[0])
    b = level_kernel.level_step_bwd_reference(g_masked, res_e, res_n, *bargs,
                                              num_nodes=t[0].shape[0])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_level_step_argument_checks_raise():
    cfg, args = _case("aig", seed=7)
    t = _port_args(args)
    with pytest.raises(ValueError, match="src must be torch.int32"):
        level_kernel.level_step(*t[:2], t[2].long(), *t[3:])
    with pytest.raises(ValueError, match="hf must be"):
        level_kernel.level_step(t[0][:, :-1].contiguous(), *t[1:])
    with pytest.raises(ValueError, match="must be contiguous"):
        level_kernel.level_step(t[0], t[1].t().contiguous().t(), *t[2:])
    with pytest.raises(ValueError, match=r"pack must be \[Ep, D\+2\]"):
        level_kernel.level_step(t[0], t[1][None], *t[2:])
    with pytest.raises(ValueError, match="e_n must be"):
        level_kernel.level_step(*t[:6], t[6][:-1].contiguous(), *t[7:])


@pytest.mark.parametrize("modality", ["aig", "xmg"])
def test_level_scan_step_equals_fused_scan_per_chunk(modality):
    """The port's two routes for a chunked batch give the same hf: one
    ``level_step`` per (chunk, level) with the scatter between calls, and
    the fused scan chunk by chunk."""
    import mgvae_tpu_torch as m

    rng = np.random.default_rng(8)
    graphs = [m.random_circuit(rng, modality, num_inputs=5, num_gates=20 + 6 * i)
              for i in range(5)]
    cfg = P.DGConfig(modality=modality, dim_hidden=16, s_rounds=1, t_rounds=1)
    params, _ = P.init_params(cfg, seed=1, device="cpu")
    batch = m.collate_chunked(graphs, 2)
    b = P.batch_to_device(batch, "cpu")
    counts = P.level_counts(batch)
    assert len(counts) == 2
    hs = P.struct_hs(params, b, cfg)
    args = P.level_scan_inputs(params, b, cfg, hs)
    n_sub = hs.shape[0] // 2
    hf_step = P.level_scan_step(args, counts, n_sub)
    hf_fused = P.level_recurrence(args, hs.shape[0], counts)
    L = args[0].shape[0] // 2
    assert min(counts) < L
    hf_all = P.level_scan_step(args, (L, L), n_sub)            # padding levels too
    assert torch.equal(hf_step, hf_fused) and torch.equal(hf_all, hf_step)
    valid = torch.as_tensor(batch["node_valid"])
    assert (hf_step[~valid] == 0).all() and hf_step[valid].abs().max() > 0
