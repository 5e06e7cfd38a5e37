"""The step route (``ops.level_kernel.level_scan_step``): a chunked batch's
level recurrence one level at a time from an explicit hf, for chunks too
large for the fused route.

Its plain versions are held against the plain loop of one ``level_step``
per (chunk, level) with the scatter in torch between the calls
(``models.dg_ae.level_step_loop``, the route's plain structure), against
autograd through the plain forward, and against ``jax.vjp`` of the JAX package's
``_level_scan_step`` in interpret mode (its Pallas step kernels, the pack
lane-padded as the JAX package pads it), on chunks with unequal real
levels; the backward at K = 1, a ragged K and K >= L level indices per
block. Then the K of the byte budget (``step_chunk_levels``) and the launch
count (``step_route_launch_count``) against hand counts.

Tolerances are the JAX package's (tests/test_pallas_kernel.py): hf atol
1e-5 / rtol 1e-4; each cotangent 1e-4 * max(its largest entry, 1).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.ops.pallas.level_kernel import LANE
import mgvae_tpu_torch as m
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import level_kernel

torch.set_num_threads(1)
FLOAT_ARGS = level_kernel.FLOAT_ARGS
NAMES = ("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak")
MiB = 1 << 20


@functools.lru_cache(maxsize=None)
def _case(modality="mig", seed=5, dim=16):
    """(args, n_levels, n_sub) of a two-chunk batch on the CPU:
    ``level_scan_inputs``' 12 arguments. The largest circuit fills one chunk
    alone, so the chunks' real levels differ."""
    rng = np.random.default_rng(seed)
    graphs = [m.random_circuit(rng, modality, num_inputs=4, num_gates=g)
              for g in (60, 14, 12, 10, 16)]
    cfg = P.DGConfig(modality=modality, dim_hidden=dim, s_rounds=1, t_rounds=1, layernorm=True)
    params, _ = P.init_params(cfg, seed=2, device="cpu")
    batch = m.collate_chunked(graphs, 2)
    b = P.batch_to_device(batch, "cpu")
    with torch.no_grad():
        hs = P.struct_hs(params, b, cfg)
        args = tuple(a.detach() for a in P.level_scan_inputs(params, b, cfg, hs))
    n_levels = P.level_counts(batch)
    assert len(set(n_levels)) == 2 and min(n_levels) > 1   # unequal real levels
    return args, n_levels, hs.shape[0] // 2


def _ghf(args, n_sub, seed=6):
    D = args[0].shape[2] - 2
    return torch.tensor(np.random.default_rng(seed).normal(size=(2 * n_sub, D)),
                        dtype=torch.float32)


def _close(name, got, want):
    scale = float(np.abs(want).max())
    assert scale > 0, name
    assert float(np.abs(got - want).max()) <= 1e-4 * max(scale, 1.0), name


@pytest.mark.parametrize("modality", ["mig", "xag"])
def test_route_forward_reference_equals_the_per_level_steps(modality):
    """``level_scan_step_reference`` gives the plain loop's hf bit for bit,
    and with residuals each real (chunk, level) row's are the single-level
    step's on hf as the loop leaves it before that level; rows of padding
    levels are 0."""
    args, n_levels, n_sub = _case(modality)
    hf_loop = P.level_step_loop(args, n_levels, n_sub)
    hf, res_e, res_n = level_kernel.level_scan_step_reference(*args, n_levels, n_sub,
                                                              with_residuals=True)
    assert torch.equal(hf, hf_loop) and hf.abs().max() > 0
    assert torch.equal(level_kernel.level_scan_step(*args, n_levels, n_sub), hf)   # CPU: plain
    C, L = 2, args[0].shape[0] // 2
    step = torch.zeros_like(hf)
    for k in range(C):
        for lv in range(L):
            row = k * L + lv
            if lv >= n_levels[k]:
                assert (res_e[row] == 0).all() and (res_n[row] == 0).all()
                continue
            h_new, re, rn = level_kernel.level_step_reference(
                step.narrow(0, k * n_sub, n_sub), *(args[i][row] for i in (0, 1, 2, 3, 5, 6)),
                *args[7:], with_residuals=True)
            assert torch.equal(re, res_e[row]) and torch.equal(rn, res_n[row]), (k, lv)
            step[args[4][row].long() + k * n_sub] = h_new
    assert torch.equal(step, hf)


@functools.lru_cache(maxsize=None)
def _jax_vjp():
    """hf and the six cotangents of jax.vjp of the JAX package's
    ``_level_scan_step`` (interpret mode) on ``_case()``, the pack padded to
    LANE columns as ``_level_scan_pallas`` pads it (the padding's cotangent
    must be 0 and is cut off)."""
    args, n_levels, n_sub = _case()
    D, T = args[0].shape[2] - 2, args[11].shape[0]
    C, L = 2, args[0].shape[0] // 2
    a = [jnp.asarray(t.numpy()) for t in args]
    a[0] = jnp.pad(a[0], ((0, 0), (0, 0), (0, LANE - D - 2)))
    lv_off = jnp.repeat(jnp.arange(C, dtype=jnp.int32) * n_sub, L)

    def route(pack_lv, wkv, wih, bih, bhh, wak):
        return J._level_scan_step((pack_lv, *a[1:7], wkv, wih, bih, bhh, wak), lv_off,
                                  C * n_sub, n_sub, D, T, True, "highest")

    hf, vjp = jax.vjp(route, a[0], *a[7:])
    grads = [np.asarray(x) for x in vjp(jnp.asarray(_ghf(args, n_sub).numpy()))]
    assert (grads[0][:, :, D + 2 :] == 0).all()
    grads[0] = grads[0][:, :, : D + 2]
    return np.asarray(hf), grads


@pytest.mark.parametrize("chunk_levels", ["one", "ragged", "all"])
def test_route_backward_reference_matches_autograd_and_jax(chunk_levels):
    """``level_scan_step_bwd_reference`` in blocks of K level indices (1; 2,
    the deeper chunk's levels not a multiple of it; past L) against autograd
    through the plain forward and against ``jax.vjp`` of ``_level_scan_step``;
    d_pack is 0 on the rows it does not walk, and in its expert column."""
    args, n_levels, n_sub = _case()
    L = args[0].shape[0] // 2
    K = {"one": 1, "ragged": 2, "all": L + 3}[chunk_levels]
    assert K != 2 or max(n_levels) % 2 == 1
    ghf = _ghf(args, n_sub)
    hf, res_e, res_n = level_kernel.level_scan_step_reference(*args, n_levels, n_sub,
                                                              with_residuals=True)
    manual = level_kernel.level_scan_step_bwd_reference(
        ghf, res_e, res_n, *args[:9], args[10], args[11], n_levels, n_sub, chunk_levels=K)
    t = [a.clone().requires_grad_(i in FLOAT_ARGS) for i, a in enumerate(args)]
    auto = torch.autograd.grad(level_kernel.level_scan_step_reference(*t, n_levels, n_sub),
                               [t[i] for i in FLOAT_ARGS], ghf)
    hf_j, grads_j = _jax_vjp()
    np.testing.assert_allclose(hf.numpy(), hf_j, rtol=1e-4, atol=1e-5)
    for name, x, a, j in zip(NAMES, manual, auto, grads_j):
        assert x.shape == a.shape == j.shape, name
        _close(name, x.numpy(), a.numpy())
        _close(name, x.numpy(), j)
    D = args[0].shape[2] - 2
    d_pack = manual[0].view(2, L, *manual[0].shape[1:])
    assert (manual[0][..., D + 1] == 0).all()
    for k, levels in enumerate(n_levels):
        assert (d_pack[k, levels:] == 0).all() and d_pack[k, :levels].abs().max() > 0


def test_route_backward_reference_blocks_change_only_the_weight_sums():
    """K only regroups the weight gradients' sums: d_pack is the same bit for
    bit at every K, the weight gradients within rounding."""
    args, n_levels, n_sub = _case("xmg", seed=9)
    ghf = _ghf(args, n_sub, seed=3)
    _, res_e, res_n = level_kernel.level_scan_step_reference(*args, n_levels, n_sub,
                                                             with_residuals=True)
    bargs = (*args[:9], args[10], args[11])
    runs = [level_kernel.level_scan_step_bwd_reference(ghf, res_e, res_n, *bargs, n_levels,
                                                       n_sub, chunk_levels=k)
            for k in (None, 1, 3, 100)]
    assert all(torch.equal(r[0], runs[0][0]) for r in runs)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))       # None is K = 1
    for r in runs[2:]:
        for name, x, y in zip(NAMES[1:], r[1:], runs[0][1:]):
            assert (x - y).abs().max() <= 1e-5 * max(y.abs().max(), 1.0), name


def test_route_arguments_are_checked():
    args, n_levels, n_sub = _case()
    L = args[0].shape[0] // 2
    with pytest.raises(ValueError, match="real levels"):
        level_kernel.level_scan_step(*args, (L + 1, 1), n_sub)
    with pytest.raises(ValueError, match="do not divide"):
        level_kernel.level_scan_step(*args, (1, 1, 1), n_sub)
    with pytest.raises(ValueError, match="lv_src must be torch.int32"):
        level_kernel.level_scan_step(args[0], args[1].long(), *args[2:], n_levels, n_sub)


# ---- launches and the scratch budget ----------------------------------------

@pytest.mark.parametrize("n_levels,k,want", [
    ((49, 47), 10, 118),   # bs64 C=2: 98 sweep launches; blocks [39,49) .. [0,9), 2 a chunk each
    ((5, 3), 2, 18),       # 10; chunk 0: 2 + 2 + 1; chunk 1: none in [3,5), then 2 + 1
    ((5, 3), 8, 14),       # one block: 10; 2 a chunk
    ((1, 1), 1, 4),        # 2; one partial launch a chunk, no sum
    ((4, 0, 2), 1, 14),    # 8; chunk 0 one launch a level, chunk 1 none, chunk 2 two
    ((0, 0), 3, 0),
])
def test_step_route_launch_count_matches_hand_counts(n_levels, k, want):
    assert level_kernel.step_route_launch_count(n_levels, k) == want


def _route_bytes(ep, np_, dim, rows, chunks, nodes):
    """Stacked residuals + hf + ghf's copy + d_pack_lv."""
    return 4 * (2 * nodes * dim + chunks * rows * (
        ep * (dim + 2) + ep * (3 * dim + 1) + np_ * 4 * dim))


def _scratch_bytes(k, ep, np_, dim, chunks, experts):
    per_level, fixed = level_kernel._step_scratch_floats(ep, np_, dim, chunks, experts)
    return 4 * (k * per_level + fixed)


@pytest.mark.parametrize("ep,np_,dim,rows,chunks,nodes,experts", [
    (640, 320, 64, 56, 2, 20480, 4),       # bs64 in two chunks (chip_smoke.py phases 10-14)
    (2048, 2048, 128, 120, 4, 262144, 5),  # the route's largest shapes (step_kernel_fits)
    (40, 16, 16, 9, 2, 200, 3),            # the CPU tests' mini scale: everything fits
    (640, 320, 64, 2, 3, 30720, 4),        # fewer levels than the budget holds
])
def test_step_chunk_levels_keeps_its_scratch_within_budget(ep, np_, dim, rows, chunks, nodes,
                                                           experts):
    k = level_kernel.step_chunk_levels(ep, np_, dim, rows, chunks, nodes, experts)
    budget = max(level_kernel.SCRATCH_FLOOR,
                 level_kernel.SCRATCH_SHARE * _route_bytes(ep, np_, dim, rows, chunks, nodes))
    assert 1 <= k <= rows
    assert k == 1 or _scratch_bytes(k, ep, np_, dim, chunks, experts) <= budget
    assert k == rows or _scratch_bytes(k + 1, ep, np_, dim, chunks, experts) > budget


def test_step_chunk_levels_leaves_the_peak_check_room():
    """At the bs64 two-chunk batch K is 8 to 12 level indices, and its
    scratch leaves the level recurrence under 1.25 x (stacked residuals + hf
    + ghf's copy + d_pack_lv) with 2% held besides (lists, weight copies,
    the forward's softmax scratch)."""
    shape = (640, 320, 64, 56, 2, 20480)
    k = level_kernel.step_chunk_levels(*shape, 4)
    law = _route_bytes(*shape)
    assert 8 <= k <= 12
    assert 1.02 * law + _scratch_bytes(k, *shape[:3], 2, 4) <= 1.25 * law - 4 * MiB
