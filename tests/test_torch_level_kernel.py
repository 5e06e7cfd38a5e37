"""The port's level scan (mgvae_tpu_torch.ops.level_kernel) against the JAX
package: the XLA scan ``_level_scan_fast`` and the Pallas kernel in
interpret mode (``forward(..., use_pallas=True, pallas_interpret=True)``).
Both packages get the same pack and level tables, built by the JAX package.
Tolerance: hf atol 1e-4, the JAX package's own (tests/test_pallas_kernel.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgvae_tpu.data.batching import collate
from mgvae_tpu.data.graph import build_graph
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu_torch.ops import level_kernel

torch.set_num_threads(1)
HF_ATOL = 1e-4


def _jax_inputs(cfg, params, batch):
    """hs, the XLA-path hf, and the 12 level_scan arguments as numpy, all
    from the JAX package."""
    hs, hf, _ = J.forward(params, batch, cfg)
    expert = cfg.expert_of_gate[batch["gate"]]
    pack, wkv_hf = J._level_statics(params, batch, cfg, hs, expert)
    nodes = batch["lv_nodes"]
    ex = params["experts"]
    args = (
        pack[batch["lv_edge_id"]],
        batch["lv_edge_src"], batch["lv_edge_dst_slot"],
        batch["lv_edge_valid"].astype(jnp.int32), nodes,
        (batch["lv_node_valid"] & (expert[nodes] >= 0)).astype(jnp.int32),
        jnp.maximum(expert[nodes], 0),
        wkv_hf, ex["w_ih"], ex["b_ih"], ex["b_hh"], ex["wa_k"],
    )
    return np.asarray(hs), np.asarray(hf), [np.asarray(a) for a in args]


def _port_scan(fn, args, num_nodes, num_levels):
    return fn(*(torch.tensor(a) for a in args), num_nodes=num_nodes,
              num_levels=num_levels).numpy()


def _small_batch(modality, seed=4):
    cfg = J.DGConfig(modality=modality, dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=True)
    params, _ = J.init_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(seed)
    graphs = [random_circuit(rng, modality, num_inputs=6, num_gates=32) for _ in range(3)]
    return cfg, params, jax.tree.map(jnp.asarray, collate(graphs))


@pytest.mark.parametrize("modality", ["aig", "mig", "xag", "xmg"])
def test_level_scan_matches_xla_scan(modality):
    cfg, params, batch = _small_batch(modality)
    hs, hf_xla, args = _jax_inputs(cfg, params, batch)
    n_lv = int(np.asarray(batch["forward_level"]).max())
    N = hs.shape[0]

    level_kernel.launches = 0
    hf_ref = _port_scan(level_kernel.level_scan_reference, args, N, n_lv)
    hf_wrap = _port_scan(level_kernel.level_scan, args, N, n_lv)
    assert level_kernel.launches == 0       # CPU tensors: the plain version
    np.testing.assert_array_equal(hf_wrap, hf_ref)
    np.testing.assert_allclose(hf_ref, hf_xla, rtol=0, atol=HF_ATOL)


@pytest.mark.parametrize("modality", ["aig", "xmg"])
def test_level_scan_matches_pallas_interpret(modality):
    cfg, params, batch = _small_batch(modality, seed=5)
    hs, _, args = _jax_inputs(cfg, params, batch)
    n_lv = int(np.asarray(batch["forward_level"]).max())
    hf = _port_scan(level_kernel.level_scan, args, hs.shape[0], n_lv)
    _, hf_pallas, _ = J.forward(params, batch, cfg, use_pallas=True, pallas_interpret=True)
    np.testing.assert_allclose(hf, np.asarray(hf_pallas), rtol=0, atol=HF_ATOL)


def test_deep_chain_bucketed_padded_levels_keep_dump_row_zero():
    """NOT chain of 21 levels: L is bucketed to 24, so the tables end in
    fully padded levels; running them too changes nothing and the dump row
    (first padding node) stays 0."""
    gate = np.r_[0, np.full(21, 2)].astype(np.int32)
    g = build_graph("chain", gate, np.stack([np.arange(21), np.arange(1, 22)]))
    cfg = J.DGConfig(modality="aig", dim_hidden=32, s_rounds=1, t_rounds=1)
    params, _ = J.init_params(jax.random.PRNGKey(0), cfg)
    batch = jax.tree.map(jnp.asarray, collate([g]))
    L = batch["lv_nodes"].shape[0]
    assert L == 24 and int(batch["forward_level"].max()) == 21
    hs, hf_xla, args = _jax_inputs(cfg, params, batch)
    N, dump = hs.shape[0], g.num_nodes

    hf_real = _port_scan(level_kernel.level_scan, args, N, 21)
    hf_all = _port_scan(level_kernel.level_scan, args, N, L)
    np.testing.assert_array_equal(hf_all, hf_real)
    assert (hf_all[dump] == 0).all() and (hf_all[dump:] == 0).all()
    assert np.isfinite(hf_all).all() and (np.abs(hf_all[1:dump]).sum(1) > 0).all()
    np.testing.assert_allclose(hf_all, hf_xla, rtol=0, atol=HF_ATOL)
    _, hf_pallas, _ = J.forward(params, batch, cfg, use_pallas=True, pallas_interpret=True)
    np.testing.assert_allclose(hf_all, np.asarray(hf_pallas), rtol=0, atol=HF_ATOL)


def test_slot_without_expert_is_not_updated():
    """A level-1 node whose gate has no expert in the modality (XOR in an
    MIG model) keeps hf = 0, as in the JAX package."""
    gate = np.array([0, 0, 3, 5], np.int32)          # PI, PI, AND, XOR
    edges = np.array([[0, 1, 0, 1], [2, 2, 3, 3]])
    g = build_graph("mixed", gate, edges)
    cfg = J.DGConfig(modality="mig", dim_hidden=32, s_rounds=1, t_rounds=1)
    params, _ = J.init_params(jax.random.PRNGKey(1), cfg)
    batch = jax.tree.map(jnp.asarray, collate([g]))
    hs, hf_xla, args = _jax_inputs(cfg, params, batch)
    hf = _port_scan(level_kernel.level_scan, args, hs.shape[0], 1)
    xor_row = int(np.asarray(batch["node_inv"])[3])
    and_row = int(np.asarray(batch["node_inv"])[2])
    assert (hf[xor_row] == 0).all() and (np.abs(hf[and_row]) > 0).any()
    np.testing.assert_allclose(hf, hf_xla, rtol=0, atol=HF_ATOL)


def _torch_args(args, grad=False):
    t = [torch.tensor(a) for a in args]
    if grad:
        for i in level_kernel.FLOAT_ARGS:
            t[i].requires_grad_(True)
    return t


def _bwd_args(t):
    """level_scan_bwd_reference's tables and weights from the 12 level_scan
    args (b_ih is not read by the backward)."""
    return (*t[:9], t[10], t[11])


@pytest.mark.parametrize("modality", ["mig", "xag"])
def test_level_scan_bwd_matches_pallas_vjp_interpret(modality):
    """The plain backward on the port's residuals against jax.vjp of the
    JAX package's custom VJP ``pallas_level_scan`` (kernels 1 and 2 in
    interpret mode), on the same 12 arguments and cotangent. Tolerance
    1e-4 * the largest entry of each gradient (tests/test_pallas_kernel.py)."""
    from mgvae_tpu.ops.pallas.level_kernel import LANE, pallas_level_scan

    cfg, params, batch = _small_batch(modality, seed=6)
    hs, _, args = _jax_inputs(cfg, params, batch)
    N, D, T = hs.shape[0], cfg.dim_hidden, cfg.num_experts
    n_lv = int(np.asarray(batch["forward_level"]).max())
    # the JAX package pads the pack to a lane-aligned width (dg_ae.py:574)
    jpack = np.pad(args[0], ((0, 0), (0, 0), (0, LANE - D - 2)))
    tables = [jnp.asarray(a) for a in args[1:7]]

    def scan(pack, wkv, wih, bih, bhh, wak):
        return pallas_level_scan(pack, *tables, wkv, wih, bih, bhh, wak, N, D, T, 1, True,
                                 "highest")

    hf_j, vjp = jax.vjp(scan, jnp.asarray(jpack), *map(jnp.asarray, args[7:]))
    ghf = np.random.default_rng(7).normal(size=(N, D)).astype(np.float32)
    grads_j = [np.asarray(g) for g in vjp(jnp.asarray(ghf))]

    t = _torch_args(args)
    hf_p, res_e, res_n = level_kernel.level_scan_reference(*t, num_nodes=N, num_levels=n_lv,
                                                           with_residuals=True)
    np.testing.assert_allclose(hf_p.numpy(), np.asarray(hf_j), rtol=0, atol=HF_ATOL)
    grads_p = level_kernel.level_scan_bwd_reference(torch.tensor(ghf), res_e, res_n,
                                                    *_bwd_args(t), num_levels=n_lv)
    assert (grads_j[0][..., D + 2 :] == 0).all()
    grads_j[0] = grads_j[0][..., : D + 2]
    names = ("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak")
    for name, p, j in zip(names, grads_p, grads_j):
        assert p.shape == j.shape, name
        scale = float(np.abs(j).max())
        assert scale > 0 and float(np.abs(p.numpy() - j).max()) <= 1e-4 * scale, name
    assert (grads_p[0][..., D + 1] == 0).all()            # the expert column


@pytest.mark.parametrize("modality", ["aig", "xmg"])
def test_level_scan_autograd_on_cpu_matches_bwd_reference(modality):
    """On CPU tensors ``level_scan`` is differentiated by autograd through
    the plain forward; that must equal the written-out backward, and the
    residuals must be zero exactly on the rows the kernels never write."""
    cfg, params, batch = _small_batch(modality, seed=8)
    hs, _, args = _jax_inputs(cfg, params, batch)
    N, D = hs.shape[0], cfg.dim_hidden
    n_lv = int(np.asarray(batch["forward_level"]).max())
    t = _torch_args(args, grad=True)
    hf = level_kernel.level_scan(*t, num_nodes=N, num_levels=n_lv)
    ghf = torch.tensor(np.random.default_rng(9).normal(size=(N, D)).astype(np.float32))
    auto = torch.autograd.grad(hf, [t[i] for i in level_kernel.FLOAT_ARGS], ghf)

    plain = _torch_args(args)
    hf_r, res_e, res_n = level_kernel.level_scan_reference(*plain, num_nodes=N, num_levels=n_lv,
                                                           with_residuals=True)
    assert torch.equal(hf_r, hf.detach())
    upd = plain[5] > 0
    live = (plain[3] > 0) & torch.gather(upd, 1, plain[2].long())
    assert (res_n[~upd] == 0).all() and (res_e[~live] == 0).all()
    assert (res_n[n_lv:] == 0).all() and (res_e[n_lv:] == 0).all()
    assert (res_e[live][:, 3 * D] > 0).all()              # attn of every live edge
    manual = level_kernel.level_scan_bwd_reference(ghf, res_e, res_n, *_bwd_args(plain),
                                                   num_levels=n_lv)
    for a, m in zip(auto, manual):
        scale = float(a.abs().max())
        assert float((a - m).abs().max()) <= 1e-5 * max(scale, 1e-30)
