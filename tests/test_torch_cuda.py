"""The port's CUDA kernels on the card: they build from csrc/, launch, and
agree with their plain PyTorch versions; a training step on the card agrees
with the same step on the CPU. Marked ``cuda``; without a card these tests
skip. On a machine with one:
python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from mgvae_tpu_torch import (Model, collate, collate_chunked, collate_split, layered_circuit,
                             random_circuit)
from mgvae_tpu_torch.models import dg_ae
from mgvae_tpu_torch.ops import _build, level_kernel, struct_kernel
from mgvae_tpu_torch.train import step

pytestmark = pytest.mark.cuda
GRAD_FLOOR = 2e-2    # leaf scale floor, as a share of the largest gradient entry
# struct backward launches per call at 2 rounds: a row launch and a
# weight-gradient partial launch per half-round, one sum
STRUCT_BWD_LAUNCHES = 4 * 2 + 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("modality,dim", [("aig", 32), ("mig", 64), ("xag", 128), ("xmg", 96)])
def test_kernel_matches_plain_version_on_card(cuda, modality, dim):
    cfg = dg_ae.DGConfig(modality=modality, dim_hidden=dim, s_rounds=2, t_rounds=2,
                         layernorm=True, matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, seed=1, device=cuda)
    rng = np.random.default_rng(2)
    batch = collate([random_circuit(rng, modality, num_inputs=8, num_gates=120)
                     for _ in range(4)])
    b = dg_ae.batch_to_device(batch, cuda)
    hs = dg_ae.struct_hs(params, b, cfg)
    args = dg_ae.level_scan_inputs(params, b, cfg, hs)
    n_lv = dg_ae.num_levels(batch)
    level_kernel.launches = level_kernel.levels_walked = 0
    hf_k = level_kernel.level_scan(*args, num_nodes=hs.shape[0], num_levels=n_lv)
    torch.cuda.synchronize()
    # one persistent launch, which walks every real level
    assert (level_kernel.launches, level_kernel.levels_walked) == (1, n_lv)
    hf_r = level_kernel.level_scan_reference(*args, num_nodes=hs.shape[0], num_levels=n_lv)
    # fp32 with TF32 off: only the order of sums differs
    torch.testing.assert_close(hf_k, hf_r, rtol=0, atol=1e-4)


def test_encode_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    graphs = [random_circuit(rng, "mig", num_inputs=6, num_gates=60) for _ in range(5)]
    gpu = Model(modality="mig", dim_hidden=64, layernorm=True, device=cuda)
    cpu = Model(modality="mig", dim_hidden=64, layernorm=True, device="cpu")
    for (hs_g, hf_g), (hs_c, hf_c) in zip(gpu.encode_many(graphs, batch_size=2),
                                          cpu.encode_many(graphs, batch_size=2)):
        # the card's kernels sum in a fixed order, but not the CPU's order,
        # and its matmuls (level statics, hs_linear) block their sums otherwise
        np.testing.assert_allclose(hs_g, hs_c, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(hf_g, hf_c, rtol=0, atol=1e-4)


def test_kernel_rejects_unsupported_width(cuda):
    """Past the kernels' width the model takes the plain route, which
    launches no kernel; each kernel wrapper, called directly at D = 160,
    still refuses."""
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=160, s_rounds=1, t_rounds=1,
                         matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, device=cuda)
    batch = collate([random_circuit(np.random.default_rng(0), "mig", num_inputs=4,
                                    num_gates=20)])
    _zero_counts()
    with torch.no_grad():
        hs, hf, _ = dg_ae.forward(params, batch, cfg)
    torch.cuda.synchronize()
    assert _all_counts() == (0,) * 9
    assert hs.shape == hf.shape == (batch["gate"].shape[0], 160)
    assert torch.isfinite(hs).all() and torch.isfinite(hf).all()
    b = dg_ae.batch_to_device(batch, cuda)
    with torch.no_grad():
        x = dg_ae.struct_input(b["gate"], cfg)
        args = dg_ae.level_scan_inputs(params, b, cfg, hs)
        n_lv, N = dg_ae.num_levels(batch), hs.shape[0]
        calls = {
            "struct_towers": lambda: struct_kernel.struct_towers(params["struct"], x, b, 1, False),
            "level_scan": lambda: level_kernel.level_scan(*args, num_nodes=N, num_levels=n_lv),
            "level_scan_giant": lambda: level_kernel.level_scan_giant(*args, num_nodes=N,
                                                                      num_levels=n_lv),
            "level_scan_step": lambda: level_kernel.level_scan_step(*args, n_levels=(n_lv,),
                                                                    n_sub=N),
            "level_step": lambda: level_kernel.level_step(hf, *(a[0] for a in args[:7]
                                                                if a is not args[4]),
                                                          *args[7:]),
        }
        for name, call in calls.items():
            with pytest.raises(ValueError, match="D <= 128"):
                call()
    torch.cuda.synchronize()
    assert _all_counts() == (0,) * 9


def _all_counts():
    """Every kernel's launch counter: struct forward / backward, level
    forward / backward, lists, step forward / backward, giant forward /
    backward."""
    return (struct_kernel.launches, struct_kernel.bwd_launches, level_kernel.launches,
            level_kernel.bwd_launches, level_kernel.lists_launches, level_kernel.step_launches,
            level_kernel.step_bwd_launches, level_kernel.giant_launches,
            level_kernel.giant_bwd_launches)


def _zero_counts():
    for m in (level_kernel, struct_kernel):
        m.launches = m.bwd_launches = 0
    level_kernel.lists_launches = level_kernel.step_launches = 0
    level_kernel.step_bwd_launches = level_kernel.giant_launches = 0
    level_kernel.giant_bwd_launches = 0


def _struct_case(cuda, modality, dim, layernorm=True, seed=7):
    cfg = dg_ae.DGConfig(modality=modality, dim_hidden=dim, s_rounds=2, t_rounds=2,
                         layernorm=layernorm, matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, seed=1, device=cuda)
    rng = np.random.default_rng(seed)
    batch = collate([random_circuit(rng, modality, num_inputs=8, num_gates=120)
                     for _ in range(4)])
    b = dg_ae.batch_to_device(batch, cuda)
    x = dg_ae.struct_input(b["gate"], cfg)
    with torch.no_grad():
        args = struct_kernel.struct_inputs(params["struct"], x, b, layernorm)
    return args, struct_kernel.struct_tables(b)


@pytest.mark.parametrize("layernorm", [True, False])
@pytest.mark.parametrize("modality,dim", [("aig", 32), ("mig", 64), ("xag", 128), ("xmg", 96)])
def test_struct_kernels_match_plain_versions_on_card(cuda, modality, dim, layernorm):
    args, tables = _struct_case(cuda, modality, dim, layernorm)
    struct_kernel.launches = struct_kernel.bwd_launches = 0
    st_k = struct_kernel._forward_cuda(args, tables, 2, layernorm, residuals=False)
    st_kr, res_k = struct_kernel._forward_cuda(args, tables, 2, layernorm, residuals=True)
    torch.cuda.synchronize()
    assert struct_kernel.launches == 2 * 4          # one launch per half-round
    st_r, res_r = struct_kernel.struct_towers_reference(*args, tables, 2, layernorm,
                                                        with_residuals=True)
    # fp32, TF32 off: only the order of sums differs
    for k, r in ((st_k, st_r), (st_kr, st_r), (res_k, res_r)):
        assert (k - r).abs().max().item() <= 1e-4
    dstate = torch.randn(st_k.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    grads_k = struct_kernel._backward_cuda(dstate, res_k, args[1], args[2], args[4], tables, 2,
                                           layernorm)
    torch.cuda.synchronize()
    assert struct_kernel.bwd_launches == STRUCT_BWD_LAUNCHES
    for name, ref in (("reference", struct_kernel.struct_towers_bwd_reference),
                      ("in place", struct_kernel.struct_towers_bwd_inplace)):
        grads_r = ref(dstate, res_k, args[1], args[2], args[4], tables, 2, layernorm)
        for k, r in zip(grads_k, grads_r):
            assert (k - r).abs().max().item() <= 1e-4 * max(r.abs().max().item(), 1.0), name


@pytest.mark.parametrize("layernorm", [True, False])
def test_struct_kernels_deterministic_and_autograd_on_card(cuda, layernorm):
    args, tables = _struct_case(cuda, "mig", 64, layernorm, seed=8)
    st1, res1 = struct_kernel._forward_cuda(args, tables, 2, layernorm, residuals=True)
    st2, res2 = struct_kernel._forward_cuda(args, tables, 2, layernorm, residuals=True)
    assert torch.equal(st1, st2) and torch.equal(res1, res2)
    assert torch.equal(struct_kernel._forward_cuda(args, tables, 2, layernorm, residuals=False),
                       st1)
    dstate = torch.randn(st1.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    raw = [struct_kernel._backward_cuda(dstate, res1, args[1], args[2], args[4], tables, 2,
                                        layernorm) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*raw))
    # the autograd Function launches the residual forward and the backward kernels
    t = [a.detach().clone().requires_grad_(True) for a in args]
    struct_kernel.launches = struct_kernel.bwd_launches = 0
    st = struct_kernel.struct_core(*t, tables, 2, layernorm)
    auto = torch.autograd.grad(st, t if layernorm else t[:4], dstate)
    torch.cuda.synchronize()
    assert struct_kernel.launches == 4 and struct_kernel.bwd_launches == STRUCT_BWD_LAUNCHES
    assert torch.equal(st.detach(), st1)
    for a, k in zip(auto, raw[0]):
        torch.testing.assert_close(a, k, rtol=0, atol=0)


def _hub_case(cuda, dim, n, seed):
    """Random struct-core inputs on a graph made for the forward kernel's
    edges: node 3 has 45 in-edges (its forward list is longer than a warp)
    and node 7 45 out-edges (its reverse list); rows 32-39, one warp's rows,
    have 6 in-edges each (48 entries for the warp); every fifth node has no
    in-edge, and nodes that are nobody's source no out-edge; n is not a
    multiple of the block's 32 rows."""
    rng = np.random.default_rng(seed)
    src, dst = [rng.integers(0, n, 45), np.full(45, 7)], [np.full(45, 3), rng.integers(0, n, 45)]
    for v in range(32, 40):
        src.append(rng.integers(0, n, 6))
        dst.append(np.full(6, v))
    for v in range(n):
        if v % 5 and v != 3 and not 32 <= v < 40:
            k = int(rng.integers(1, 4))
            src.append(rng.integers(0, n // 2, k))   # nodes past n / 2 have few out-edges
            dst.append(np.full(k, v))
    src, dst = np.concatenate(src), np.concatenate(dst)

    def lists(by, other):
        order = np.argsort(by, kind="stable")        # each node's entries in edge order
        count = np.bincount(by, minlength=n)
        return other[order], np.cumsum(count) - count, count

    tables = tuple(torch.tensor(np.stack(a), dtype=torch.int32, device=cuda)
                   for a in zip(lists(dst, src), lists(src, dst)))
    f = lambda scale, *shape: torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32,
                                           device=cuda)
    D3 = 3 * dim
    args = (f(0.5, 2, 2, n, D3), f(0.5 / dim**0.5, 2, 2, dim, D3), f(1 / dim**0.5, 2, 2, dim, D3),
            f(0.1, 2, 2, D3), 1 + f(0.1, 2, dim), f(0.1, 2, dim))
    return args, tables


@pytest.mark.parametrize("rounds", [1, 2, 4])
@pytest.mark.parametrize("layernorm", [True, False])
@pytest.mark.parametrize("dim", [32, 40, 64, 96, 128])
def test_struct_forward_on_hubs_ragged_rows_and_empty_lists_on_card(cuda, dim, layernorm,
                                                                    rounds):
    """The forward kernel against its plain version where its gather and
    tiles have edges: lists longer than a warp, a warp's lists together
    longer than a warp, empty lists, a partial last block, a width that is
    not a multiple of 32 (D = 40: the padded weight copies); bitwise
    repeatable; the backward kernel on its residuals."""
    args, tables = _hub_case(cuda, dim, 203, seed=dim + rounds)
    struct_kernel.launches = 0
    st_k = struct_kernel._forward_cuda(args, tables, rounds, layernorm, residuals=False)
    st_kr, res_k = struct_kernel._forward_cuda(args, tables, rounds, layernorm, residuals=True)
    torch.cuda.synchronize()
    assert struct_kernel.launches == 2 * 2 * rounds       # one launch per half-round
    st_r, res_r = struct_kernel.struct_towers_reference(*args, tables, rounds, layernorm,
                                                        with_residuals=True)
    # fp32, TF32 off: only the order of sums differs (the neighbor sums of
    # 45 rows in the residuals: against their scale)
    assert (st_k - st_r).abs().max().item() <= 1e-4
    assert (res_k - res_r).abs().max().item() <= 1e-4 * max(res_r.abs().max().item(), 1.0)
    assert torch.equal(st_kr, st_k)
    again = struct_kernel._forward_cuda(args, tables, rounds, layernorm, residuals=True)
    assert torch.equal(again[0], st_k) and torch.equal(again[1], res_k)
    dstate = torch.randn(st_k.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(6))
    grads_k = struct_kernel._backward_cuda(dstate, res_k, args[1], args[2], args[4], tables,
                                           rounds, layernorm)
    grads_r = struct_kernel.struct_towers_bwd_reference(dstate, res_k, args[1], args[2], args[4],
                                                        tables, rounds, layernorm)
    for k, r in zip(grads_k, grads_r):
        assert (k - r).abs().max().item() <= 1e-4 * max(r.abs().max().item(), 1.0)


def test_struct_forward_layout_matches_the_kernel_on_card(cuda):
    """``struct_kernel.forward_layout`` is the layout the kernel launches."""
    lib = _build.library()
    out = (ctypes.c_int * 6)()
    for n in (1, 203, 5120, 114_688):
        for dim in (1, 31, 32, 33, 40, 64, 96, 100, 128):
            assert lib.mgvae_struct_towers_forward_layout(n, dim, out) == 0
            lay = struct_kernel.forward_layout(n, dim)
            assert list(out) == [*lay["grid"], lay["threads"], lay["smem_bytes"],
                                 lay["chunk_rows"], lay["rows_per_warp"]], (n, dim)
    assert lib.mgvae_struct_towers_forward_layout(8, 129, out) != 0


def test_struct_backward_scratch_does_not_grow_with_rounds(cuda):
    """The backward's scratch holds one half-round whatever the rounds: one
    call's peak memory past its inputs is the same at 2 and 4 rounds (the
    residuals are an input)."""
    args, tables = _struct_case(cuda, "mig", 64, seed=9)
    past = {}
    for rounds in (2, 4):
        st, res = struct_kernel._forward_cuda(args, tables, rounds, True, residuals=True)
        dstate = torch.randn(st.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(5))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = struct_kernel._backward_cuda(dstate, res, args[1], args[2], args[4], tables,
                                             rounds, True)
        torch.cuda.synchronize()
        past[rounds] = torch.cuda.max_memory_allocated() - base
        del grads, st, res
    assert abs(past[4] - past[2]) <= 2**20, past


@pytest.mark.parametrize("modality,dim", [("aig", 32), ("mig", 64), ("xag", 128), ("xmg", 96)])
def test_backward_kernel_matches_plain_version_on_card(cuda, modality, dim):
    cfg = dg_ae.DGConfig(modality=modality, dim_hidden=dim, s_rounds=2, t_rounds=2,
                         layernorm=True, matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, seed=1, device=cuda)
    rng = np.random.default_rng(5)
    batch = collate([random_circuit(rng, modality, num_inputs=8, num_gates=120)
                     for _ in range(4)])
    b = dg_ae.batch_to_device(batch, cuda)
    with torch.no_grad():
        hs = dg_ae.struct_hs(params, b, cfg)
        args = dg_ae.level_scan_inputs(params, b, cfg, hs)
    n_lv, N = dg_ae.num_levels(batch), hs.shape[0]
    hf_k, re_k, rn_k = level_kernel._forward_cuda(args, N, n_lv, residuals=True)
    re_k, rn_k = _written_rows(args[2], args[3], args[5], n_lv, re_k, rn_k)
    hf_r, re_r, rn_r = level_kernel.level_scan_reference(*args, num_nodes=N, num_levels=n_lv,
                                                         with_residuals=True)
    for k, r in ((hf_k, hf_r), (re_k, re_r), (rn_k, rn_r)):
        torch.testing.assert_close(k, r, rtol=0, atol=1e-4)
    ghf = torch.randn(hf_k.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    bargs = (*args[:9], args[10], args[11])
    level_kernel.bwd_launches = level_kernel.bwd_levels_walked = 0
    grads_k = level_kernel._backward_cuda(ghf, re_k, rn_k, args, n_lv)
    torch.cuda.synchronize()
    # the persistent sweep, the weight gradients' partials, their sums
    assert n_lv > level_kernel.LEVELS_PER_BLOCK
    assert (level_kernel.bwd_launches, level_kernel.bwd_levels_walked) == (3, n_lv)
    grads_r = level_kernel.level_scan_bwd_reference(ghf, re_k, rn_k, *bargs, num_levels=n_lv)
    for k, r in zip(grads_k, grads_r):
        # fp32, TF32 off: only the order of sums differs
        assert (k - r).abs().max().item() <= 1e-4 * max(r.abs().max().item(), 1.0)
    # the same through autograd: the Function launches the residual forward
    # and the backward kernels
    t = [a.detach().clone() for a in args]
    for i in level_kernel.FLOAT_ARGS:
        t[i].requires_grad_(True)
    level_kernel.launches = level_kernel.bwd_launches = 0
    hf = level_kernel.level_scan(*t, num_nodes=N, num_levels=n_lv)
    auto = torch.autograd.grad(hf, [t[i] for i in level_kernel.FLOAT_ARGS], ghf)
    torch.cuda.synchronize()
    assert (level_kernel.launches, level_kernel.bwd_launches) == (1, 3)
    for a, k in zip(auto, grads_k):
        torch.testing.assert_close(a, k, rtol=0, atol=0)   # the same kernels, deterministic


def _written_rows(dslot, evalid, upd, n_lv, res_e, res_n):
    """The residuals with every row that the kernels leave unwritten set to
    0, as the plain versions have them (all levels' tables, of which the
    first ``n_lv`` ran, or one level's)."""
    e_live, s_live = level_kernel.live_rows(dslot, evalid, upd)
    if e_live.dim() == 2:
        e_live[n_lv:], s_live[n_lv:] = False, False
    return torch.where(e_live[..., None], res_e, 0.0), torch.where(s_live[..., None], res_n, 0.0)


def _step_case(cuda, modality, dim, seed=9):
    """level_step's 12 arguments for a mid level of chunk 1 of a chunked
    batch, with hf as the fused scan leaves it, and the chunk's node count."""
    cfg = dg_ae.DGConfig(modality=modality, dim_hidden=dim, s_rounds=2, t_rounds=2,
                         layernorm=True, matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, seed=1, device=cuda)
    rng = np.random.default_rng(seed)
    batch = collate_chunked([random_circuit(rng, modality, num_inputs=8, num_gates=120)
                             for _ in range(6)], 2)
    b = dg_ae.batch_to_device(batch, cuda)
    counts = dg_ae.level_counts(batch)
    with torch.no_grad():
        hs = dg_ae.struct_hs(params, b, cfg)
        args = dg_ae.level_scan_inputs(params, b, cfg, hs)
        hf = dg_ae.level_recurrence(args, hs.shape[0], counts)     # the fused route
    n_sub, L = hs.shape[0] // 2, args[0].shape[0] // 2
    row = L + counts[1] // 2
    step = (hf[n_sub:].contiguous(), *(args[i][row] for i in (0, 1, 2, 3, 5, 6)), *args[7:])
    return step, n_sub


@pytest.mark.parametrize("modality,dim", [("aig", 32), ("mig", 64), ("xag", 128), ("xmg", 96)])
def test_step_kernels_match_plain_versions_on_card(cuda, modality, dim):
    step_args, n_sub = _step_case(cuda, modality, dim)
    level_kernel.step_launches = level_kernel.step_bwd_launches = 0
    h_k = level_kernel._step_forward_cuda(step_args, residuals=False)
    h_kr, re_k, rn_k = level_kernel._step_forward_cuda(step_args, residuals=True)
    re_k, rn_k = _written_rows(step_args[3], step_args[4], step_args[5], 1, re_k, rn_k)
    torch.cuda.synchronize()
    assert level_kernel.step_launches == 2
    h_r, re_r, rn_r = level_kernel.level_step_reference(*step_args, with_residuals=True)
    assert h_r.abs().max().item() > 0
    # fp32, TF32 off: only the order of sums differs
    for k, r in ((h_k, h_r), (h_kr, h_r), (re_k, re_r), (rn_k, rn_r)):
        torch.testing.assert_close(k, r, rtol=0, atol=1e-4)
    assert (h_k[step_args[5] == 0] == 0).all()
    g = torch.randn(h_k.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    raw = [level_kernel._step_backward_cuda(g, re_k, rn_k, step_args[1:], n_sub)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert level_kernel.step_bwd_launches == 2 * 3     # slots, sources, weight gradients
    assert all(torch.equal(a, b) for a, b in zip(*raw))              # no atomics
    bargs = (*step_args[1:9], step_args[10], step_args[11])
    grads_r = level_kernel.level_step_bwd_reference(g, re_k, rn_k, *bargs, num_nodes=n_sub)
    assert grads_r[6].abs().max().item() > 0                           # d_hf
    for k, r in zip(raw[0], grads_r):
        assert (k - r).abs().max().item() <= 1e-4 * max(r.abs().max().item(), 1.0)
    # the same through autograd: the Function launches the residual forward
    # and the backward kernels, and saves no hf
    t = [a.detach().clone() for a in step_args]
    for i in level_kernel.STEP_FLOAT_ARGS:
        t[i].requires_grad_(True)
    level_kernel.step_launches = level_kernel.step_bwd_launches = 0
    h = level_kernel.level_step(*t)
    auto = torch.autograd.grad(h, [t[i] for i in level_kernel.STEP_FLOAT_ARGS], g)
    torch.cuda.synchronize()
    assert level_kernel.step_launches == 1 and level_kernel.step_bwd_launches == 3
    d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak, d_hf = raw[0]
    for a, k in zip(auto, (d_hf, d_pack, d_wkv, d_wih, d_bih, d_bhh, d_wak)):
        torch.testing.assert_close(a, k, rtol=0, atol=0)


def _route_tables(cuda, dim, experts, chunks, seed):
    """level_scan_step's 12 arguments for ``chunks`` chunks of the tables of
    tests/test_torch_level_lists.py (a source shared by several slots, a
    slot with 40 in-edges, a level with no updated slot), chunk k with
    REAL - k % 3 real levels and its rows past them padding, as
    collate_chunked pads (no updated slot, no valid edge); the weights of
    chunk 0's. Returns (args, real levels, n_sub)."""
    from test_torch_level_lists import REAL, random_tables

    parts = [random_tables(seed + k, dim, experts) for k in range(chunks)]
    n_sub = parts[0][1]
    n_levels = tuple(REAL - k % 3 for k in range(chunks))
    tables = []
    for (t, _), real in zip(parts, n_levels):
        t = [a.clone() for a in t[:7]]
        t[3][real:], t[5][real:], t[4][real:] = 0, 0, n_sub - 1
        tables.append(t)
    args = [torch.cat([t[i] for t in tables]) for i in range(7)] + parts[0][0][7:]
    return tuple(a.to(cuda) for a in args), n_levels, n_sub


@pytest.mark.parametrize("dim,experts,chunks", [(32, 3, 2), (64, 4, 3), (128, 5, 4), (40, 4, 2)])
def test_step_route_matches_plain_versions_on_card(cuda, dim, experts, chunks):
    """Kernels 5 and 6 as the step route (one launch per level index for all
    chunks, the scatter inside the kernel, hf's cotangent carried in place)
    on chunks of unequal real levels: the forward with residuals against
    level_scan_step_reference within 1e-5, equal bit for bit to its serving
    launch and to the per-row loop of single-level calls; the backward at
    K = 1, a ragged K and K >= L against level_scan_step_bwd_reference in
    the same block order within 1e-4 * max(scale, 1), d_pack 0 on the rows
    it does not walk; each twice, bit for bit the same; launches as
    step_route_launch_count gives, and through the autograd Function the
    same outputs."""
    from test_torch_level_lists import L

    args, n_levels, n = _route_tables(cuda, dim, experts, chunks, seed=11)
    level_kernel.step_launches = 0
    runs = [level_kernel._step_route_forward_cuda(args, n_levels, n, residuals=True)
            for _ in range(2)]
    hf_k, re_k, rn_k = runs[0]
    torch.cuda.synchronize()
    assert level_kernel.step_launches == 2 * max(n_levels)
    written = [_written_rows(args[2], args[3], args[5], chunks * L, r[1], r[2]) for r in runs]
    assert torch.equal(runs[1][0], hf_k) and all(
        torch.equal(a, b) for a, b in zip(written[0], written[1]))
    hf_r, re_r, rn_r = level_kernel.level_scan_step_reference(*args, n_levels, n,
                                                              with_residuals=True)
    assert hf_r.abs().max().item() > 0.01
    for k, r in zip((hf_k, *written[0]), (hf_r, re_r, rn_r)):
        torch.testing.assert_close(k, r, rtol=0, atol=1e-5)
    assert torch.equal(level_kernel._step_route_forward_cuda(args, n_levels, n, False), hf_k)
    assert torch.equal(dg_ae.level_step_loop(args, n_levels, n), hf_k)
    ghf = torch.randn(hf_k.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    top = max(n_levels)
    for K in (1, 2, L + 2):
        level_kernel.step_bwd_launches = 0
        raw = [level_kernel._step_route_backward_cuda(ghf, re_k, rn_k, args, n_levels, n,
                                                      chunk_levels=K) for _ in range(2)]
        torch.cuda.synchronize()
        assert level_kernel.step_bwd_launches == 2 * level_kernel.step_route_launch_count(
            n_levels, min(K, top))
        assert all(torch.equal(a, c) for a, c in zip(*raw))          # no atomics
        d_pack = raw[0][0].view(chunks, L, -1)
        assert all((d_pack[k, real:] == 0).all() for k, real in enumerate(n_levels))
        grads_r = level_kernel.level_scan_step_bwd_reference(
            ghf, *written[0], *args[:9], args[10], args[11], n_levels, n, chunk_levels=K)
        for a, r in zip(raw[0], grads_r):
            scale = max(r.abs().max().item(), 1.0)
            assert r.abs().max().item() > 0
            assert (a - r).abs().max().item() <= 1e-4 * scale
    # through the autograd Function: the residual forward and the backward
    # at its own K (step_chunk_levels), on an expanded cotangent
    t = [a.detach().clone() for a in args]
    for i in level_kernel.FLOAT_ARGS:
        t[i].requires_grad_(True)
    level_kernel.step_launches = level_kernel.step_bwd_launches = 0
    hf = level_kernel.level_scan_step(*t, n_levels, n)
    g1 = torch.ones((), device=cuda).expand(hf.shape)
    auto = torch.autograd.grad(hf, [t[i] for i in level_kernel.FLOAT_ARGS], g1)
    torch.cuda.synchronize()
    K = level_kernel.step_chunk_levels(args[0].shape[1], args[4].shape[1], dim, L, chunks,
                                       chunks * n, experts)
    assert level_kernel.step_launches == top
    assert level_kernel.step_bwd_launches == level_kernel.step_route_launch_count(
        n_levels, min(K, top))
    assert torch.equal(hf, hf_k)
    want = level_kernel._step_route_backward_cuda(g1.contiguous(), re_k, rn_k, args, n_levels, n)
    assert all(torch.equal(a, w) for a, w in zip(auto, want))


@pytest.mark.parametrize("modality,dim", [("aig", 32), ("mig", 64), ("xag", 128), ("xmg", 96)])
def test_giant_kernels_match_plain_versions_on_card(cuda, modality, dim):
    """Kernels 3 and 4 on a small layered circuit whose shape takes the giant
    route (N > 8192): forward (one persistent launch) against the plain
    scan, backward (recomputed from hf, in chunks of the default K) against
    the plain recompute in its order and against the residual route's
    kernel, twice for bitwise repeatability, and through autograd."""
    cfg = dg_ae.DGConfig(modality=modality, dim_hidden=dim, s_rounds=1, t_rounds=1,
                         layernorm=True, matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, seed=1, device=cuda)
    rng = np.random.default_rng(5)
    batch = collate([layered_circuit(rng, modality, width=96, depth=90, num_tt_pairs=16)])
    b = dg_ae.batch_to_device(batch, cuda)
    n_lv = dg_ae.num_levels(batch)
    with torch.no_grad():
        hs = dg_ae.struct_hs(params, b, cfg)
        args = [a.detach().clone() for a in dg_ae.level_scan_inputs(params, b, cfg, hs)]
    N, L = hs.shape[0], args[0].shape[0]
    assert not level_kernel.kernel_fits(N, args[0].shape[1], args[4].shape[1], dim)
    k = min(level_kernel.giant_chunk_levels(args[0].shape[1], args[4].shape[1], dim, L, N,
                                            cfg.num_experts), n_lv)
    bwd_launches = level_kernel.giant_bwd_launch_count(n_lv, k)
    level_kernel.giant_launches = level_kernel.giant_bwd_launches = level_kernel.launches = 0
    hf_k = level_kernel.level_scan_giant(*args, num_nodes=N, num_levels=n_lv)
    torch.cuda.synchronize()
    assert (level_kernel.giant_launches, level_kernel.launches) == (1, 0)
    hf_r = level_kernel.level_scan_giant_reference(*args, num_nodes=N, num_levels=n_lv)
    assert hf_r.abs().max().item() > 0
    # fp32, TF32 off: only the order of sums differs
    torch.testing.assert_close(hf_k, hf_r, rtol=0, atol=1e-4)
    ghf = torch.randn(hf_k.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    raw = [level_kernel._giant_backward_cuda(ghf, hf_k, tuple(args), n_lv) for _ in range(2)]
    torch.cuda.synchronize()
    assert level_kernel.giant_bwd_launches == 2 * bwd_launches
    assert all(torch.equal(a, c) for a, c in zip(*raw))              # no atomics
    assert n_lv == L or (raw[0][0][n_lv:] == 0).all()                # padding levels
    grads_r = level_kernel.level_scan_giant_bwd_reference(ghf, hf_k, *args, num_levels=n_lv,
                                                          chunk_levels=k)
    _, res_e, res_n = level_kernel._forward_cuda(args, N, n_lv, residuals=True)
    grads_2 = level_kernel._backward_cuda(ghf, res_e, res_n, tuple(args), n_lv)
    for k, r, k2 in zip(raw[0], grads_r, grads_2):
        scale = max(r.abs().max().item(), 1.0)
        assert (k - r).abs().max().item() <= 1e-4 * scale
        assert (k - k2).abs().max().item() <= 1e-5 * scale         # recomputed vs saved
    t = [a.clone().requires_grad_(i in level_kernel.FLOAT_ARGS) for i, a in enumerate(args)]
    level_kernel.giant_launches = level_kernel.giant_bwd_launches = 0
    hf = level_kernel.level_scan_giant(*t, num_nodes=N, num_levels=n_lv)
    auto = torch.autograd.grad(hf, [t[i] for i in level_kernel.FLOAT_ARGS], ghf)
    torch.cuda.synchronize()
    assert (level_kernel.giant_launches, level_kernel.giant_bwd_launches) == (1, bwd_launches)
    assert torch.equal(hf, hf_k)
    for a, k in zip(auto, raw[0]):
        torch.testing.assert_close(a, k, rtol=0, atol=0)


def test_giant_train_step_on_card_matches_cpu_with_and_without_remat(cuda):
    """One training step on a layered circuit by the giant route, card vs
    CPU, and the struct remat on the card against the step without it. The
    prob loss is left out: among the readout's ~0.6M ReLU units one may sit
    within rounding of 0 and be on for one device and off for the other."""
    smooth = (1.0, 0.0, 2.0, 0.0)
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2, layernorm=True,
                         matmul_precision="highest")
    rng = np.random.default_rng(13)
    batch = collate([layered_circuit(rng, "mig", width=64, depth=140, num_tt_pairs=64)])
    assert batch["gate"].shape[0] > level_kernel.KERNEL_MAX_NODES
    g = torch.Generator().manual_seed(5)
    n_real, e_pad, n_pad = int(batch["n_nodes"]), batch["edge_src"].shape[0], batch["gate"].shape[0]
    neg = tuple(torch.randint(0, n_real, (2, e_pad), generator=g).to(torch.int32))
    keep = [torch.rand(n_pad, cfg.dim_mlp, generator=g) < 0.8 for _ in range(2)]
    m_c, g_c = _one_step(cfg, batch, "cpu", neg, keep, weights=smooth)
    for mod in (level_kernel, struct_kernel):
        mod.launches = mod.bwd_launches = 0
    level_kernel.giant_launches = level_kernel.giant_bwd_launches = 0
    m_g, g_g = _one_step(cfg, batch, cuda, neg, keep, weights=smooth)
    n_lv = dg_ae.num_levels(batch)
    k = min(level_kernel.giant_chunk_levels(batch["lv_edge_src"].shape[-1],
                                            batch["lv_nodes"].shape[-1], 64,
                                            batch["lv_nodes"].shape[0], n_pad, cfg.num_experts),
            n_lv)
    assert (level_kernel.giant_launches, level_kernel.giant_bwd_launches) == (
        1, level_kernel.giant_bwd_launch_count(n_lv, k))
    assert (level_kernel.launches, level_kernel.bwd_launches) == (0, 0)
    assert (struct_kernel.launches, struct_kernel.bwd_launches) == (4, STRUCT_BWD_LAUNCHES)
    struct_kernel.launches = struct_kernel.bwd_launches = 0
    m_r, g_r = _one_step(dataclasses.replace(cfg, remat_struct=True), batch, cuda, neg, keep,
                         weights=smooth)
    # the towers ran twice
    assert (struct_kernel.launches, struct_kernel.bwd_launches) == (8, STRUCT_BWD_LAUNCHES)
    for k in ("recon_loss", "func_loss"):
        assert abs(float(m_g[k]) - float(m_c[k])) <= 1e-4 * max(abs(float(m_c[k])), 1.0)
        assert float(m_r[k]) == float(m_g[k])
    scale = max(c.abs().max().item() for c in g_c if c is not None)
    for a, c, r in zip(g_g, g_c, g_r):
        if c is None:
            assert a is None and r is None
            continue
        assert (a - c).abs().max().item() <= 1e-4 * max(c.abs().max().item(), GRAD_FLOOR * scale)
        assert torch.equal(a, r)            # the struct kernels are bitwise deterministic


@pytest.mark.parametrize("dim,experts", [(32, 3), (40, 4), (64, 5), (96, 3), (128, 4)])
def test_giant_kernels_by_chunks_on_random_tables_on_card(cuda, dim, experts):
    """Kernel 3 (one persistent launch) and kernel 4 in chunks of K = 1, a
    ragged K (2: chunks of 2, 2 and 1 of the 5 real levels) and K >= L on the
    tables of tests/test_torch_level_lists.py (a source shared by several
    slots, slots with 0 and with 40 in-edges, a level with no updated slot, a
    padding level): kernel 3 equal to kernel 1 bit for bit and repeatable;
    kernel 4 against the plain version in its own chunk order within
    1e-4 * max(scale, 1) and against kernel 2 from saved residuals within
    1e-5 * max(scale, 1), bitwise repeatable, with the launches
    ``giant_bwd_launch_count`` gives."""
    from test_torch_level_lists import L, REAL, random_tables

    cpu_args, n = random_tables(7, dim, experts)
    args = tuple(a.to(cuda) for a in cpu_args)
    level_kernel.giant_launches = 0
    hf = [level_kernel._giant_forward_cuda(args, n, REAL) for _ in range(2)]
    torch.cuda.synchronize()
    assert level_kernel.giant_launches == 2
    hf_1, re_1, rn_1 = level_kernel._forward_cuda(args, n, REAL, residuals=True)
    assert torch.equal(hf[0], hf[1]) and torch.equal(hf[0], hf_1)
    ghf = torch.randn(hf_1.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    grads_2 = level_kernel._backward_cuda(ghf, re_1, rn_1, args, REAL)
    for k in (1, 2, L + 2):
        level_kernel.giant_bwd_launches = 0
        raw = [level_kernel._giant_backward_cuda(ghf, hf_1, args, REAL, chunk_levels=k)
               for _ in range(2)]
        torch.cuda.synchronize()
        assert level_kernel.giant_bwd_launches == 2 * level_kernel.giant_bwd_launch_count(
            REAL, min(k, REAL))
        assert all(torch.equal(a, c) for a, c in zip(*raw))          # no atomics
        assert (raw[0][0][REAL:] == 0).all()                         # the padding level
        grads_r = level_kernel.level_scan_giant_bwd_reference(ghf, hf_1, *args, num_levels=REAL,
                                                              chunk_levels=k)
        for a, r, a2 in zip(raw[0], grads_r, grads_2):
            scale = max(r.abs().max().item(), 1.0)
            assert r.abs().max().item() > 0
            assert (a - r).abs().max().item() <= 1e-4 * scale
            assert (a - a2).abs().max().item() <= 1e-5 * scale       # recomputed vs saved


@pytest.mark.parametrize("dim,experts", [(32, 4), (64, 5), (128, 4), (128, 5), (96, 5), (64, 4)])
def test_level_kernels_on_random_tables_on_card(cuda, dim, experts):
    """Kernels 1 and 2, and 3 to 6 on the same body, on the tables of
    tests/test_torch_level_lists.py: arbitrary row order, padding rows, a
    source shared by several slots, slots with 0 and with 40 in-edges, a
    level with no updated slot, a padding level, T = 5; D = 128 stages wk and
    wv alone. Forward within 1e-5 of the plain version, backward within
    1e-4 * max(scale, 1), both bitwise repeatable, kernel 3 bit-equal to
    kernel 1."""
    from test_torch_level_lists import REAL, random_tables

    cpu_args, n = random_tables(5, dim, experts)
    args = tuple(a.to(cuda) for a in cpu_args)
    L = args[0].shape[0]
    runs = [level_kernel._forward_cuda(args, n, REAL, residuals=True) for _ in range(2)]
    hf_k, re_k, rn_k = runs[0]
    re_m, rn_m = _written_rows(args[2], args[3], args[5], REAL, re_k, rn_k)
    again = _written_rows(args[2], args[3], args[5], REAL, runs[1][1], runs[1][2])
    assert torch.equal(runs[1][0], hf_k)                                 # repeatable
    assert torch.equal(again[0], re_m) and torch.equal(again[1], rn_m)
    hf_r, re_r, rn_r = level_kernel.level_scan_reference(*args, num_nodes=n, num_levels=REAL,
                                                         with_residuals=True)
    assert hf_r.abs().max().item() > 0.01
    for k, r in ((hf_k, hf_r), (re_m, re_r), (rn_m, rn_r)):
        torch.testing.assert_close(k, r, rtol=0, atol=1e-5)
    assert torch.equal(level_kernel._forward_cuda(args, n, REAL, residuals=False), hf_k)
    assert torch.equal(level_kernel._giant_forward_cuda(args, n, REAL), hf_k)   # kernel 3
    ghf = torch.randn(hf_k.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    raw = [level_kernel._backward_cuda(ghf, re_k, rn_k, args, REAL) for _ in range(2)]
    assert all(torch.equal(a, c) for a, c in zip(*raw))                  # no atomics
    assert (raw[0][0][REAL:] == 0).all() and L > REAL                    # the padding level
    bargs = (*args[:9], args[10], args[11])
    grads_r = level_kernel.level_scan_bwd_reference(ghf, re_m, rn_m, *bargs, num_levels=REAL)
    grads_4 = level_kernel._giant_backward_cuda(ghf, hf_k, args, REAL)              # kernel 4
    for k, r, k4 in zip(raw[0], grads_r, grads_4):
        scale = max(r.abs().max().item(), 1.0)
        assert r.abs().max().item() > 0
        assert (k - r).abs().max().item() <= 1e-4 * scale
        assert (k4 - r).abs().max().item() <= 1e-4 * scale
        assert (k4 - k).abs().max().item() <= 1e-5 * scale               # recomputed vs saved
    # kernels 5 and 6 on the level with the 40-in-edge slot, from kernel 1's hf
    row = 3
    step = (hf_k, *(args[i][row] for i in (0, 1, 2, 3, 5, 6)), *args[7:])
    h_k, se_k, sn_k = level_kernel._step_forward_cuda(step, residuals=True)
    h_r = level_kernel.level_step_reference(*step)
    torch.testing.assert_close(h_k, h_r, rtol=0, atol=1e-5)
    g = torch.randn(h_k.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    grads_6 = level_kernel._step_backward_cuda(g, se_k, sn_k, step[1:], n)
    se_m, sn_m = _written_rows(step[3], step[4], step[5], 1, se_k, sn_k)
    grads_r = level_kernel.level_step_bwd_reference(g, se_m, sn_m, *step[1:9], step[10],
                                                    step[11], num_nodes=n)
    for k, r in zip(grads_6, grads_r):
        assert (k - r).abs().max().item() <= 1e-4 * max(r.abs().max().item(), 1.0)


@pytest.mark.parametrize("case", ["random", "batch", "one_level"])
def test_level_lists_kernel_equals_its_plain_version_on_card(cuda, case):
    """``csrc/level_lists.cu`` against the torch sorts, entry for entry: on
    the random tables of tests/test_torch_level_lists.py, on a collated
    batch's tables (all chunks at once) and on one level's."""
    from test_torch_level_lists import T, random_tables

    if case == "batch":
        cfg = dg_ae.DGConfig(modality="xmg", dim_hidden=32, s_rounds=1, t_rounds=1,
                             matmul_precision="highest")
        params, _ = dg_ae.init_params(cfg, seed=1, device=cuda)
        rng = np.random.default_rng(3)
        batch = collate_chunked([random_circuit(rng, "xmg", num_inputs=8, num_gates=90)
                                 for _ in range(6)], 2)
        b = dg_ae.batch_to_device(batch, cuda)
        args = dg_ae.level_scan_inputs(params, b, cfg, dg_ae.struct_hs(params, b, cfg))
        experts = cfg.num_experts
    else:
        args, experts = [a.to(cuda) for a in random_tables(6)[0]], T
    tables = [args[i] for i in (1, 2, 3, 5, 6)]
    if case == "one_level":
        tables = [t[3] for t in tables]
    level_kernel.lists_launches = 0
    got = level_kernel.level_lists(*tables, experts)
    torch.cuda.synchronize()
    assert level_kernel.lists_launches == 1
    want = level_kernel.level_lists_reference(*tables, experts)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.int32 and g.shape == w.shape and torch.equal(g, w), name


@pytest.mark.parametrize("dim", [32, 64, 128])
def test_fused_kernels_on_a_three_chunk_batch_on_card(cuda, dim):
    """Kernels 1 and 2 chunk by chunk on ``collate_chunked(graphs, 3)``, the
    lists built once for all chunks: hf and every gradient against the plain
    versions, through ``level_recurrence`` and autograd."""
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=dim, s_rounds=1, t_rounds=1, layernorm=True,
                         matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, seed=1, device=cuda)
    rng = np.random.default_rng(12)
    batch = collate_chunked([random_circuit(rng, "mig", num_inputs=8, num_gates=60 + 10 * i)
                             for i in range(9)], 3)
    b = dg_ae.batch_to_device(batch, cuda)
    counts = dg_ae.level_counts(batch)
    with torch.no_grad():
        hs = dg_ae.struct_hs(params, b, cfg)
        args = [a.detach().clone() for a in dg_ae.level_scan_inputs(params, b, cfg, hs)]
    N, L = hs.shape[0], args[0].shape[0] // 3
    t = [a.clone().requires_grad_(i in level_kernel.FLOAT_ARGS) for i, a in enumerate(args)]
    level_kernel.launches = level_kernel.bwd_launches = 0
    level_kernel.levels_walked = level_kernel.bwd_levels_walked = 0
    hf = dg_ae.level_recurrence(tuple(t), N, counts)
    ghf = torch.randn(hf.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    auto = torch.autograd.grad(hf, [t[i] for i in level_kernel.FLOAT_ARGS], ghf)
    torch.cuda.synchronize()
    assert (level_kernel.launches, level_kernel.bwd_launches) == (3, 9)
    assert (level_kernel.levels_walked, level_kernel.bwd_levels_walked) == (sum(counts),) * 2
    r = [a.clone().requires_grad_(i in level_kernel.FLOAT_ARGS) for i, a in enumerate(args)]
    hf_r = torch.cat([level_kernel.level_scan_reference(
        *(x[k * L:(k + 1) * L] for x in r[:7]), *r[7:], num_nodes=N // 3, num_levels=counts[k])
        for k in range(3)])
    want = torch.autograd.grad(hf_r, [r[i] for i in level_kernel.FLOAT_ARGS], ghf)
    torch.testing.assert_close(hf, hf_r, rtol=0, atol=1e-5)
    for a, w in zip(auto, want):
        assert (a - w).abs().max().item() <= 1e-4 * max(w.abs().max().item(), 1.0)


def _one_step(cfg, batch, dev, neg, keep, seed=4, weights=(1.0, 4.0, 4.0, 0.0)):
    params, state = dg_ae.init_params(cfg, seed=seed, device=dev)
    leaves = step.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    total, (_, metrics) = step.loss_and_metrics(
        params, state, batch, None, list(weights), cfg, True,
        neg_edges=tuple(t.to(dev) for t in neg), drop_keep=[k.to(dev) for k in keep])
    total.backward()
    return metrics, [None if t.grad is None else t.grad.cpu() for t in leaves]


@pytest.mark.parametrize("layout", ["chunked_fused", "chunked_step", "split"])
def test_large_batch_train_step_on_card_matches_cpu(cuda, layout, monkeypatch):
    """One training step on a chunked batch by both routes and on a split
    batch: the card's kernels against the CPU's plain versions."""
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2, layernorm=True,
                         matmul_precision="highest")
    rng = np.random.default_rng(11)
    graphs = [random_circuit(rng, "mig", num_inputs=8, num_gates=60 + 20 * i) for i in range(6)]
    batch = collate_split(graphs, 3) if layout == "split" else collate_chunked(graphs, 2)
    if layout == "chunked_step":
        monkeypatch.setattr(dg_ae, "kernel_fits", lambda *a: False)
    gen = torch.Generator().manual_seed(3)
    e_pad, n_pad = batch["edge_src"].shape[0], batch["gate"].shape[0]
    valid = torch.as_tensor(np.flatnonzero(batch["node_valid"]))
    neg = tuple(valid[torch.randint(0, len(valid), (e_pad,), generator=gen)].to(torch.int32)
                for _ in range(2))
    keep = [torch.rand(n_pad, cfg.dim_mlp, generator=gen) < 0.8 for _ in range(2)]
    for m in (level_kernel, struct_kernel):
        m.launches = m.bwd_launches = 0
    level_kernel.step_launches = level_kernel.step_bwd_launches = 0
    level_kernel.levels_walked = level_kernel.bwd_levels_walked = 0
    m_c, g_c = _one_step(cfg, batch, "cpu", neg, keep)
    assert level_kernel.launches == level_kernel.step_launches == 0
    m_g, g_g = _one_step(cfg, batch, cuda, neg, keep)
    torch.cuda.synchronize()
    counts = dg_ae.level_counts(batch)
    if layout == "split":
        real, calls = sum(c[0] for c in counts), len(counts)
    else:
        real, calls = sum(counts), len(counts)
    if layout == "chunked_step":
        # the route: a launch per level index forward, and backward the
        # launches of its blocks of K level indices
        ep, np_ = batch["lv_edge_src"].shape[-1], batch["lv_nodes"].shape[-1]
        K = level_kernel.step_chunk_levels(ep, np_, cfg.dim_hidden, batch["lv_nodes"].shape[1],
                                           len(counts), n_pad, cfg.num_experts)
        assert (level_kernel.step_launches, level_kernel.step_bwd_launches) == (
            max(counts), level_kernel.step_route_launch_count(counts, min(K, max(counts))))
        assert level_kernel.launches == level_kernel.bwd_launches == 0
    else:
        # per chunk or group one persistent launch forward and three launches backward
        assert (level_kernel.launches, level_kernel.bwd_launches) == (calls, 3 * calls)
        assert (level_kernel.levels_walked, level_kernel.bwd_levels_walked) == (real, real)
        assert level_kernel.step_launches == level_kernel.step_bwd_launches == 0
    groups = len(counts) if layout == "split" else 1
    assert struct_kernel.launches == 4 * groups
    assert struct_kernel.bwd_launches == STRUCT_BWD_LAUNCHES * groups
    for k in ("recon_loss", "prob_loss", "func_loss"):
        assert abs(float(m_g[k]) - float(m_c[k])) <= 1e-4 * max(abs(float(m_c[k])), 1.0), k
    scale = max(g.abs().max().item() for g in g_c if g is not None)
    for a, c in zip(g_g, g_c):
        assert (a is None) == (c is None)
        if c is not None:
            tol = 1e-4 * max(c.abs().max().item(), GRAD_FLOOR * scale)
            assert (a - c).abs().max().item() <= tol


def test_train_step_on_card_matches_cpu(cuda):
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2, layernorm=True,
                         matmul_precision="highest")
    rng = np.random.default_rng(6)
    batch = collate([random_circuit(rng, "mig", num_inputs=8, num_gates=120) for _ in range(4)])
    gen = torch.Generator().manual_seed(3)
    neg = tuple(t.to(torch.int32) for t in torch.randint(
        0, int(batch["n_nodes"]), (2, batch["edge_src"].shape[0]), generator=gen))
    keep = [torch.rand(batch["gate"].shape[0], cfg.dim_mlp, generator=gen) < 0.8
            for _ in range(2)]
    out = {}
    for dev in ("cpu", cuda):
        params, state = dg_ae.init_params(cfg, seed=4, device=dev)
        leaves = step.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        total, (_, metrics) = step.loss_and_metrics(
            params, state, batch, None, [1.0, 4.0, 4.0, 0.0], cfg, True,
            neg_edges=tuple(t.to(dev) for t in neg), drop_keep=[k.to(dev) for k in keep])
        total.backward()
        out[str(dev)] = (metrics, [None if t.grad is None else t.grad.cpu() for t in leaves])
    (m_c, g_c), (m_g, g_g) = out["cpu"], out["cuda"]
    for k in step.METRIC_KEYS:
        assert abs(float(m_g[k]) - float(m_c[k])) <= 1e-4 * max(abs(float(m_c[k])), 1.0), k
    # each leaf against its own largest entry, with a floor for the leaves
    # whose gradient is 0 in exact arithmetic (the readout biases that
    # BatchNorm cancels, the attention query terms): they carry rounding
    # noise only
    scale = max(g.abs().max().item() for g in g_c if g is not None)
    for a, c in zip(g_g, g_c):
        assert (a is None) == (c is None)
        if c is not None:
            tol = 1e-4 * max(c.abs().max().item(), GRAD_FLOOR * scale)
            assert (a - c).abs().max().item() <= tol


def _variant_counts():
    return (struct_kernel.launches, struct_kernel.bwd_launches, level_kernel.launches,
            level_kernel.bwd_launches, level_kernel.lists_launches,
            level_kernel.step_launches + level_kernel.step_bwd_launches
            + level_kernel.giant_launches + level_kernel.giant_bwd_launches)


@pytest.mark.parametrize("variant,want", [
    ("dg_vae", (4, STRUCT_BWD_LAUNCHES, 1, 3, 1, 0)),
    ("ae", (0, 0, 1, 3, 1, 0)),
    ("rounds2", (4, STRUCT_BWD_LAUNCHES, 0, 0, 0, 0)),
])
def test_variant_train_step_on_card_matches_cpu(cuda, variant, want):
    """DG_VAE (the variational head and KL), AE (the gcn struct encoder,
    plain torch) and num_rounds = 2 (the general level loop, plain torch):
    one step's losses and gradients on the card against the CPU, with the
    launches of the card's step."""
    kw = {"dg_vae": dict(variational=True), "ae": dict(struct_encoder="gcn"),
          "rounds2": dict(num_rounds=2)}[variant]
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2, layernorm=True,
                         **kw, matmul_precision="highest")
    rng = np.random.default_rng(7)
    batch = collate([random_circuit(rng, "mig", num_inputs=8, num_gates=120) for _ in range(4)])
    gen = torch.Generator().manual_seed(5)
    n = batch["gate"].shape[0]
    neg = tuple(t.to(torch.int32) for t in torch.randint(
        0, int(batch["n_nodes"]), (2, batch["edge_src"].shape[0]), generator=gen))
    keep = [torch.rand(n, cfg.dim_mlp, generator=gen) < 0.8 for _ in range(2)]
    eps = tuple(torch.randn(n, 64, generator=gen) for _ in range(2))
    out = {}
    for dev in ("cpu", cuda):
        params, state = dg_ae.init_params(cfg, seed=4, device=dev)
        leaves = step.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        before = _variant_counts()
        total, (_, metrics) = step.loss_and_metrics(
            params, state, batch, None, [1.0, 4.0, 4.0, 1.0], cfg, True,
            neg_edges=tuple(t.to(dev) for t in neg), drop_keep=[k.to(dev) for k in keep],
            vae_eps=tuple(e.to(dev) for e in eps) if cfg.variational else None)
        total.backward()
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(_variant_counts(), before))
        out[str(dev)] = (metrics, [None if t.grad is None else t.grad.cpu() for t in leaves],
                         counts)
    (m_c, g_c, _), (m_g, g_g, got) = out["cpu"], out["cuda"]
    assert got == want
    assert (float(m_g["kl_loss"]) != 0.0) == cfg.variational
    for k in step.METRIC_KEYS:
        assert abs(float(m_g[k]) - float(m_c[k])) <= 1e-4 * max(abs(float(m_c[k])), 1.0), k
    scale = max(g.abs().max().item() for g in g_c if g is not None)
    for a, c in zip(g_g, g_c):
        assert (a is None) == (c is None)
        if c is not None:
            tol = 1e-4 * max(c.abs().max().item(), GRAD_FLOOR * scale)
            assert (a - c).abs().max().item() <= tol


def test_ordered_segment_sum_is_deterministic_on_card(cuda):
    """The gcn encoder's sums: a fixed order on the card, two runs bit for
    bit, and the atomic index_add_'s value within rounding."""
    from mgvae_tpu_torch.ops.segment import segment_sum, segment_sum_ordered

    gen = torch.Generator(device=cuda).manual_seed(0)
    data = torch.randn(200_000, 64, device=cuda, generator=gen)
    ids = torch.randint(0, 300, (200_000,), device=cuda, generator=gen)
    a, b = segment_sum_ordered(data, ids, 300), segment_sum_ordered(data, ids, 300)
    assert torch.equal(a, b)
    assert (a - segment_sum(data, ids, 300)).abs().max().item() <= 1e-3


def test_model_variational_draws_on_card(cuda):
    """Model(variational=True): noise from a generator on the card, seeded
    seed + 17; repeatable from the seed, fresh on every request."""
    rng = np.random.default_rng(8)
    graphs = [random_circuit(rng, "mig", num_inputs=8, num_gates=100) for _ in range(4)]
    kw = dict(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2, layernorm=True,
              variational=True, seed=3)
    a, b = Model(**kw), Model(**kw)
    assert a._gen.device.type == "cuda"
    first = a.encode_many(graphs, batch_size=4)
    twin = b.encode_many(graphs, batch_size=4)
    again = a.encode_many(graphs, batch_size=4)
    for (hs1, hf1), (hs2, _), (hs3, _) in zip(first, twin, again):
        assert np.isfinite(hf1).all()
        assert np.abs(hs1 - hs2).max() <= 1e-6 < np.abs(hs1 - hs3).max()


# ---- bf16 values (kernels 1, 2, 7 and 8) ---------------------------------------
# The kernels round where their plain versions do and the sums run in other
# orders, so each output is held against its own largest entry at BF16_ULPS
# (two bf16 ulps at the top of its range; inside the JAX package's bf16
# bounds, tests/test_pallas_kernel.py:95-114). A bf16 step card vs CPU: the
# JAX bounds over all gradient leaves, and each leaf within BF16_LEAF of its
# own scale floored at GRAD_FLOOR of the largest entry, as the fp32 steps'
# (a leaf's gradient sums terms that cancel, each about a bf16 ulp apart
# between the card and the CPU; chip_smoke.py's BF16_LEAF).
BF16_ULPS, BF16_LEAF = 2.0 ** -6, 2.0 ** -3

def _bf16_case(cuda, modality, dim, seed=7):
    cfg = dg_ae.DGConfig(modality=modality, dim_hidden=dim, s_rounds=2, t_rounds=2,
                         layernorm=True, compute_dtype="bfloat16", matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, seed=1, device=cuda)
    rng = np.random.default_rng(seed)
    batch = collate([random_circuit(rng, modality, num_inputs=8, num_gates=120)
                     for _ in range(4)])
    b = dg_ae.batch_to_device(batch, cuda)
    with torch.no_grad():
        p = dg_ae.cast_params(params, cfg)
        sargs = struct_kernel.struct_inputs(p["struct"], dg_ae.struct_input(b["gate"], cfg), b,
                                            True)
        hs = dg_ae.struct_hs(p, b, cfg)
        args = dg_ae.level_scan_inputs(p, b, cfg, hs)
    return cfg, batch, b, sargs, args


def _bf16_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= BF16_ULPS * want.abs().max().item()


def _leaf_names(tree, prefix=""):
    """The leaves' paths, in ``step.param_leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


@pytest.mark.parametrize("modality,dim", [("aig", 32), ("mig", 64), ("xag", 128), ("xmg", 96)])
def test_bf16_kernels_match_plain_versions_on_card(cuda, modality, dim):
    """The four bf16 kernels against their plain bf16 versions on the same
    bf16 inputs: the struct towers with residuals and their backward, the
    fused level scan with residuals and its backward; outputs bf16."""
    cfg, batch, b, sargs, args = _bf16_case(cuda, modality, dim)
    assert all(t.dtype == torch.bfloat16 for t in (*sargs, args[0], *args[7:]))
    tables = struct_kernel.struct_tables(b)
    st_k, sres_k = struct_kernel._forward_cuda(sargs, tables, 2, True, residuals=True)
    st_r, sres_r = struct_kernel.struct_towers_reference(*sargs, tables, 2, True,
                                                         with_residuals=True)
    assert st_k.dtype == sres_k.dtype == torch.bfloat16
    _bf16_close(st_k, st_r)
    _bf16_close(sres_k, sres_r)
    dstate = torch.randn(st_k.shape, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(3)).to(torch.bfloat16)
    sg_k = struct_kernel._backward_cuda(dstate, sres_k, sargs[1], sargs[2], sargs[4], tables,
                                        2, True)
    sg_r = struct_kernel.struct_towers_bwd_reference(dstate, sres_k, sargs[1], sargs[2],
                                                     sargs[4], tables, 2, True)
    for k, r in zip(sg_k, sg_r):
        assert k.dtype == r.dtype == torch.bfloat16
        _bf16_close(k, r)
    n_lv, N = dg_ae.num_levels(batch), b["gate"].shape[0]
    hf_k, re_k, rn_k = level_kernel._forward_cuda(args, N, n_lv, residuals=True)
    re_k, rn_k = (x.to(torch.bfloat16) for x in
                  _written_rows(args[2], args[3], args[5], n_lv, re_k, rn_k))
    hf_r, re_r, rn_r = level_kernel.level_scan_reference(*args, num_nodes=N, num_levels=n_lv,
                                                         with_residuals=True)
    for k, r in ((hf_k, hf_r), (re_k, re_r), (rn_k, rn_r)):
        assert k.dtype == torch.bfloat16
        _bf16_close(k, r)
    ghf = torch.randn(hf_k.shape, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(2)).to(torch.bfloat16)
    g_k = level_kernel._backward_cuda(ghf, re_k, rn_k, args, n_lv)
    g_r = level_kernel.level_scan_bwd_reference(ghf, re_k, rn_k, *args[:9], args[10], args[11],
                                                num_levels=n_lv)
    for k, r in zip(g_k, g_r):
        assert k.dtype == torch.bfloat16
        _bf16_close(k, r)


def _to_bf16(args, floats):
    return tuple(a.to(torch.bfloat16) if i in floats else a for i, a in enumerate(args))


@pytest.mark.parametrize("modality,dim", [("aig", 32), ("mig", 64), ("xag", 128), ("xmg", 96)])
def test_bf16_giant_kernels_match_plain_versions_on_card(cuda, modality, dim):
    """Kernels 3 and 4 with bf16 values on a layered circuit past the fused
    gate: the giant forward equal bit for bit to kernel 1's bf16 launch
    without residuals and within BF16_ULPS of its plain version; the giant
    backward (fp32 ghf and recompute, kernel 4's rounding points) against
    level_scan_giant_bwd_reference in its chunk order, each output in its
    dtype within BF16_ULPS of its scale, twice bit for bit, with fp32's
    launches; through the autograd Function the same."""
    cfg = dg_ae.DGConfig(modality=modality, dim_hidden=dim, s_rounds=1, t_rounds=1,
                         layernorm=True, matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, seed=1, device=cuda)
    batch = collate([layered_circuit(np.random.default_rng(5), modality, width=96, depth=90,
                                     num_tt_pairs=16)])
    b = dg_ae.batch_to_device(batch, cuda)
    n_lv = dg_ae.num_levels(batch)
    with torch.no_grad():
        hs = dg_ae.struct_hs(params, b, cfg)
        args = _to_bf16(dg_ae.level_scan_inputs(params, b, cfg, hs), level_kernel.FLOAT_ARGS)
    N, L = hs.shape[0], args[0].shape[0]
    assert not level_kernel.kernel_fits(N, args[0].shape[1], args[4].shape[1], dim)
    level_kernel.giant_launches = level_kernel.giant_bwd_launches = 0
    hf_k = level_kernel._giant_forward_cuda(args, N, n_lv)
    assert hf_k.dtype == torch.bfloat16
    assert torch.equal(hf_k, level_kernel._forward_cuda(args, N, n_lv, residuals=False))
    _bf16_close(hf_k, level_kernel.level_scan_giant_reference(*args, num_nodes=N,
                                                               num_levels=n_lv))
    ghf = torch.randn(hf_k.shape, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(3)).to(torch.bfloat16)
    raw = [level_kernel._giant_backward_cuda(ghf, hf_k, args, n_lv) for _ in range(2)]
    torch.cuda.synchronize()
    k = min(level_kernel.giant_chunk_levels(args[0].shape[1], args[4].shape[1], dim, L, N,
                                            cfg.num_experts), n_lv)
    assert level_kernel.giant_launches == 1
    assert level_kernel.giant_bwd_launches == 2 * level_kernel.giant_bwd_launch_count(n_lv, k)
    assert all(torch.equal(a, c) for a, c in zip(*raw))              # no atomics
    grads_r = level_kernel.level_scan_giant_bwd_reference(ghf, hf_k, *args, num_levels=n_lv,
                                                          chunk_levels=k)
    for a, r in zip(raw[0], grads_r):
        assert a.dtype == r.dtype == torch.bfloat16
        _bf16_close(a, r)
    t = [a.clone().requires_grad_(i in level_kernel.FLOAT_ARGS) for i, a in enumerate(args)]
    hf = level_kernel.level_scan_giant(*t, num_nodes=N, num_levels=n_lv)
    auto = torch.autograd.grad(hf, [t[i] for i in level_kernel.FLOAT_ARGS], ghf)
    assert torch.equal(hf, hf_k) and all(torch.equal(a, c) for a, c in zip(auto, raw[0]))


@pytest.mark.parametrize("dim,experts,chunks", [(32, 3, 2), (64, 4, 3), (128, 5, 4), (96, 4, 2)])
def test_bf16_step_kernels_match_plain_versions_on_card(cuda, dim, experts, chunks):
    """Kernels 5 and 6 with bf16 values: the single-level step with
    residuals and its backward on one level's row, and the step route (a
    launch per level index, hf and its cotangent carried in bf16) on chunks
    of unequal real levels, against their plain bf16 versions in the
    kernels' order; every output in its dtype within BF16_ULPS of its
    scale, the route's launches as fp32's, twice bit for bit."""
    from test_torch_level_lists import BUSY_LEVEL, L

    args, n_levels, n = _route_tables(cuda, dim, experts, chunks, seed=13)
    args = _to_bf16(args, level_kernel.FLOAT_ARGS)
    row = BUSY_LEVEL                     # chunk 0's level with a slot of 40 in-edges
    hf0 = level_kernel.level_scan_step_reference(*args, n_levels, n)[:n].contiguous()
    step_args = (hf0, *(args[i][row] for i in (0, 1, 2, 3, 5, 6)), *args[7:])
    h_k, re_k, rn_k = level_kernel._step_forward_cuda(step_args, residuals=True)
    re_k, rn_k = (x.to(torch.bfloat16) for x in
                  _written_rows(step_args[3], step_args[4], step_args[5], 1, re_k, rn_k))
    h_r, re_r, rn_r = level_kernel.level_step_reference(*step_args, with_residuals=True)
    for k, r in ((h_k, h_r), (re_k, re_r), (rn_k, rn_r)):
        assert k.dtype == torch.bfloat16
        _bf16_close(k, r)
    g = torch.randn(h_k.shape, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2)).to(torch.bfloat16)
    grads_k = level_kernel._step_backward_cuda(g, re_k, rn_k, step_args[1:], n)
    grads_r = level_kernel.level_step_bwd_reference(g, re_k, rn_k, *step_args[1:9],
                                                    step_args[10], step_args[11], num_nodes=n)
    for k, r in zip(grads_k, grads_r):
        _bf16_close(k, r)
    assert grads_k[0].dtype == grads_k[6].dtype == torch.bfloat16          # d_pack, d_hf

    level_kernel.step_launches = 0
    hf_k, re_k, rn_k = level_kernel._step_route_forward_cuda(args, n_levels, n, residuals=True)
    torch.cuda.synchronize()
    assert level_kernel.step_launches == max(n_levels) and hf_k.dtype == torch.bfloat16
    written = [x.to(torch.bfloat16) for x in
               _written_rows(args[2], args[3], args[5], chunks * L, re_k, rn_k)]
    hf_r, re_r, rn_r = level_kernel.level_scan_step_reference(*args, n_levels, n,
                                                              with_residuals=True)
    for k, r in zip((hf_k, *written), (hf_r, re_r, rn_r)):
        _bf16_close(k, r)
    ghf = torch.randn(hf_k.shape, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(5)).to(torch.bfloat16)
    K = 2
    level_kernel.step_bwd_launches = 0
    raw = [level_kernel._step_route_backward_cuda(ghf, *written, args, n_levels, n,
                                                  chunk_levels=K) for _ in range(2)]
    torch.cuda.synchronize()
    assert level_kernel.step_bwd_launches == 2 * level_kernel.step_route_launch_count(n_levels, K)
    assert all(torch.equal(a, c) for a, c in zip(*raw))
    grads_r = level_kernel.level_scan_step_bwd_reference(
        ghf, *written, *args[:9], args[10], args[11], n_levels, n, chunk_levels=K)
    for a, r in zip(raw[0], grads_r):
        assert a.dtype == r.dtype == torch.bfloat16
        _bf16_close(a, r)


@pytest.mark.parametrize("route", ["giant", "step"])
def test_bf16_giant_and_step_train_steps_on_card_match_cpu(cuda, route, monkeypatch):
    """One bf16 train step by the giant route (a layered circuit past the
    fused gate) and by the step route (two chunks, the fused gate patched
    off), card against CPU: the route's launches, losses within the JAX
    package's bf16 bounds, every fp32 master gradient within them over all
    leaves and within BF16_LEAF of its own leaf's scale."""
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2, layernorm=True,
                         compute_dtype="bfloat16", matmul_precision="highest")
    rng = np.random.default_rng(12)
    if route == "giant":
        batch = collate([layered_circuit(rng, "mig", width=96, depth=90, num_tt_pairs=16)])
    else:
        batch = collate_chunked([random_circuit(rng, "mig", num_inputs=8, num_gates=60 + 20 * i)
                                 for i in range(6)], 2)
        monkeypatch.setattr(dg_ae, "kernel_fits", lambda *a: False)
    gen = torch.Generator().manual_seed(3)
    e_pad, n_pad = batch["edge_src"].shape[0], batch["gate"].shape[0]
    valid = torch.as_tensor(np.flatnonzero(batch["node_valid"]))
    neg = tuple(valid[torch.randint(0, len(valid), (e_pad,), generator=gen)].to(torch.int32)
                for _ in range(2))
    keep = [torch.rand(n_pad, cfg.dim_mlp, generator=gen) < 0.8 for _ in range(2)]
    m_c, g_c = _one_step(cfg, batch, "cpu", neg, keep)
    level_kernel.launches = level_kernel.bwd_launches = 0
    level_kernel.step_launches = level_kernel.step_bwd_launches = 0
    level_kernel.giant_launches = level_kernel.giant_bwd_launches = 0
    m_g, g_g = _one_step(cfg, batch, cuda, neg, keep)
    torch.cuda.synchronize()
    counts = dg_ae.level_counts(batch)
    ep, np_ = batch["lv_edge_src"].shape[-1], batch["lv_nodes"].shape[-1]
    if route == "giant":
        L = batch["lv_nodes"].shape[0]
        K = level_kernel.giant_chunk_levels(ep, np_, 64, L, n_pad, cfg.num_experts)
        want = (0, 0, 1, level_kernel.giant_bwd_launch_count(counts[0], min(K, counts[0])))
        got = (level_kernel.launches, level_kernel.step_launches, level_kernel.giant_launches,
               level_kernel.giant_bwd_launches)
    else:
        K = level_kernel.step_chunk_levels(ep, np_, 64, batch["lv_nodes"].shape[1], len(counts),
                                           n_pad, cfg.num_experts)
        want = (0, max(counts), 0,
                level_kernel.step_route_launch_count(counts, min(K, max(counts))))
        got = (level_kernel.launches, level_kernel.step_launches, level_kernel.giant_launches,
               level_kernel.step_bwd_launches)
    assert got == want, (got, want)
    for k in ("recon_loss", "prob_loss", "func_loss"):
        assert abs(float(m_g[k]) - float(m_c[k])) <= 2e-2 + 1e-1 * abs(float(m_c[k])), k
    names = _leaf_names(dg_ae.init_params(cfg, seed=4, device="cpu")[0])
    scale = max(c.abs().max().item() for c in g_c if c is not None)
    flat = lambda g: torch.cat([x.reshape(-1) for x in g if x is not None])
    assert (flat(g_g) - flat(g_c)).abs().max().item() <= 0.05 * max(scale, 1.0)
    for name, a, c in zip(names, g_g, g_c, strict=True):
        assert (a is None) == (c is None)
        if c is not None:
            assert a.dtype == c.dtype == torch.float32
            leaf = max(c.abs().max().item(), GRAD_FLOOR * scale)
            assert (a - c).abs().max().item() <= BF16_LEAF * leaf, name


def test_bf16_train_step_on_card_matches_cpu(cuda):
    """One bf16 step (bs4 MIG, D = 64) on the card against the CPU: the
    kernels' launches, losses within the JAX package's bf16 bounds, and
    every master gradient (fp32) within them over all leaves and within
    BF16_LEAF of its own leaf's scale."""
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2, layernorm=True,
                         compute_dtype="bfloat16", matmul_precision="highest")
    rng = np.random.default_rng(6)
    batch = collate([random_circuit(rng, "mig", num_inputs=8, num_gates=120) for _ in range(4)])
    gen = torch.Generator().manual_seed(3)
    neg = tuple(t.to(torch.int32) for t in torch.randint(
        0, int(batch["n_nodes"]), (2, batch["edge_src"].shape[0]), generator=gen))
    keep = [torch.rand(batch["gate"].shape[0], cfg.dim_mlp, generator=gen) < 0.8
            for _ in range(2)]
    for m in (level_kernel, struct_kernel):
        m.launches = m.bwd_launches = 0
    m_c, g_c = _one_step(cfg, batch, "cpu", neg, keep)
    m_g, g_g = _one_step(cfg, batch, cuda, neg, keep)
    torch.cuda.synchronize()
    assert (level_kernel.launches, level_kernel.bwd_launches) == (1, 3)
    assert (struct_kernel.launches, struct_kernel.bwd_launches) == (4, STRUCT_BWD_LAUNCHES)
    for k in ("recon_loss", "prob_loss", "func_loss"):
        assert abs(float(m_g[k]) - float(m_c[k])) <= 2e-2 + 1e-1 * abs(float(m_c[k])), k
    names = _leaf_names(dg_ae.init_params(cfg, seed=4, device="cpu")[0])
    scale = max(c.abs().max().item() for c in g_c if c is not None)
    flat = lambda g: torch.cat([x.reshape(-1) for x in g if x is not None])
    assert (flat(g_g) - flat(g_c)).abs().max().item() <= 0.05 * max(scale, 1.0)
    for name, a, c in zip(names, g_g, g_c, strict=True):
        assert (a is None) == (c is None)
        if c is not None:
            assert a.dtype == c.dtype == torch.float32
            leaf = max(c.abs().max().item(), GRAD_FLOOR * scale)
            assert (a - c).abs().max().item() <= BF16_LEAF * leaf, name


# ---- wide models (D > 128: the plain route) and foreign checkpoints --------------

def _wide_batch(circuits, inputs, gates, tt_pairs, seed):
    rng = np.random.default_rng(seed)
    return collate([random_circuit(rng, "mig", num_inputs=inputs, num_gates=gates,
                                   num_tt_pairs=tt_pairs) for _ in range(circuits)])


def _wide_card_vs_cpu(cuda, dtype, batch, weights):
    """D = 256 (MIG, layernorm, 4 rounds): the encode and one train step on
    the card against the CPU, with no kernel launched. fp32: hs / hf within
    1e-4 of their scale, each gradient leaf within 1e-4 * max(its scale,
    GRAD_FLOOR * the largest); bf16: hs / hf within BF16_ULPS of their
    scale, the gradients within the JAX package's 0.05 * max(scale, 1) over
    all leaves, and each leaf within BF16_LEAF of its own scale (floored the
    same way), as ``[precision]`` (c) and chip_smoke.py's ``[wide]`` hold
    them."""
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=256, s_rounds=4, t_rounds=4, layernorm=True,
                         compute_dtype=dtype, matmul_precision="highest")
    valid = torch.as_tensor(batch["node_valid"])
    enc = {}
    for dev in ("cpu", cuda):
        params, _ = dg_ae.init_params(cfg, seed=2, device=dev)
        _zero_counts()
        with torch.inference_mode():
            hs, hf, _ = dg_ae.forward(params, batch, cfg)
        enc[str(dev)] = (hs.cpu().float()[valid], hf.cpu().float()[valid])
    torch.cuda.synchronize()
    assert _all_counts() == (0,) * 9
    tol = 1e-4 if dtype == "float32" else BF16_ULPS
    for (g, c) in zip(enc["cuda"], enc["cpu"]):
        assert torch.isfinite(g).all() and (g - c).abs().max().item() <= tol * c.abs().max().item()
    gen = torch.Generator().manual_seed(3)
    neg = tuple(t.to(torch.int32) for t in torch.randint(
        0, int(batch["n_nodes"]), (2, batch["edge_src"].shape[0]), generator=gen))
    keep = [torch.rand(batch["gate"].shape[0], cfg.dim_mlp, generator=gen) < 0.8
            for _ in range(2)]
    m_c, g_c = _one_step(cfg, batch, "cpu", neg, keep, weights=weights)
    _zero_counts()
    m_g, g_g = _one_step(cfg, batch, cuda, neg, keep, weights=weights)
    torch.cuda.synchronize()
    assert _all_counts() == (0,) * 9
    scale = max(c.abs().max().item() for c in g_c if c is not None)
    for k in ("recon_loss", "prob_loss", "func_loss"):
        bound = (1e-4 * max(abs(float(m_c[k])), 1.0) if dtype == "float32"
                 else 2e-2 + 1e-1 * abs(float(m_c[k])))
        assert abs(float(m_g[k]) - float(m_c[k])) <= bound, k
    if dtype == "bfloat16":
        flat = lambda g: torch.cat([x.reshape(-1) for x in g if x is not None])
        assert (flat(g_g) - flat(g_c)).abs().max().item() <= 0.05 * max(scale, 1.0)
    leaf_tol = 1e-4 if dtype == "float32" else BF16_LEAF
    names = _leaf_names(dg_ae.init_params(cfg, seed=2, device="cpu")[0])
    worst = (0.0, "")
    for name, a, c in zip(names, g_g, g_c, strict=True):
        assert (a is None) == (c is None)
        if c is not None:
            assert a.dtype == torch.float32 and torch.isfinite(a).all()
            leaf = max(c.abs().max().item(), GRAD_FLOOR * scale)
            err = (a - c).abs().max().item()
            worst = max(worst, (err / (leaf_tol * leaf), name))
            assert err <= leaf_tol * leaf, (name, err, leaf)
    print(f"{dtype} weights {weights}: worst leaf {worst[1]} at {worst[0]:.3f} of its bound")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_encode_and_step_on_card_match_cpu(cuda, dtype):
    """``_wide_card_vs_cpu`` on chip_smoke.py's ``[wide]`` batch (MIG bs16,
    16 inputs, 264 gates, 64 truth-table pairs, seed 7) with round 5's
    weights [1, 4, 2, 0]. On a bs4 batch of 80-gate circuits the bf16
    step's ``/experts/b_hh`` came out 1.04x BF16_LEAF from the CPU's
    (NVIDIA H100 80GB HBM3, 700 W): on a batch that small, one truth-table
    pair or readout unit turned over at an L1 or ReLU kink moves a leaf by
    more (``test_wide_bf16_step_on_a_small_batch_on_card``)."""
    _wide_card_vs_cpu(cuda, dtype, _wide_batch(16, 16, 264, 64, seed=7), (1.0, 4.0, 2.0, 0.0))


def test_wide_bf16_step_on_a_small_batch_on_card(cuda):
    """``_wide_card_vs_cpu`` in bf16 on a bs4 batch of 80-gate circuits
    without the prob term (weights [1, 0, 2, 0], as the CPU tests against
    JAX): its readout's ReLU units and L1 loss are the kinks that bf16
    rounding turns over on so small a batch."""
    _wide_card_vs_cpu(cuda, "bfloat16", _wide_batch(4, 8, 80, 32, seed=11), (1.0, 0.0, 2.0, 0.0))


def test_reference_pth_encodes_on_card(cuda, tmp_path):
    """A reference ``.pth`` state dict loaded into ``Model`` on the card:
    the encode takes the struct and fused level kernels and agrees with the
    same file loaded on the CPU within 1e-4."""
    from benchmarks.torch_reference import ReferenceModel

    torch.manual_seed(0)
    ref = ReferenceModel("mig", dim_hidden=64, layernorm=True)
    path = str(tmp_path / "ref.pth")
    torch.save({"epoch": 3, "state_dict": ref.state_dict()}, path)
    rng = np.random.default_rng(12)
    graphs = [random_circuit(rng, "mig", num_inputs=8, num_gates=60) for _ in range(4)]
    out = {}
    for dev in ("cpu", cuda):
        m = Model(modality="mig", layernorm=True, device=dev).load(path)
        _zero_counts()
        out[str(dev)] = m.encode_many(graphs, batch_size=4)
    torch.cuda.synchronize()
    assert (struct_kernel.launches, level_kernel.launches, level_kernel.lists_launches) == (8, 1, 1)
    for (hs_g, hf_g), (hs_c, hf_c) in zip(out["cuda"], out["cpu"], strict=True):
        np.testing.assert_allclose(hs_g, hs_c, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(hf_g, hf_c, rtol=0, atol=1e-4)


@pytest.fixture
def one_rank_nccl(cuda, monkeypatch):
    """A one-rank NCCL process group on the card, taken down after the test."""
    import socket

    import torch.distributed as dist

    from mgvae_tpu_torch.parallel import mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    mesh.maybe_initialize_distributed("cuda", timeout=60)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_dp_over_one_nccl_rank_equals_single_device_on_card(one_rank_nccl, tmp_path):
    """The trainer with ``distributed`` under a one-rank NCCL group (its
    all-reduce of the gradients, BN state and metrics over one rank) trains
    two epochs bit for bit as the single-device trainer on the card."""
    import types

    from mgvae_tpu_torch.parallel import collectives
    from mgvae_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(1)
    ds = [random_circuit(rng, "mig", num_inputs=6, num_gates=60) for _ in range(12)]
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2,
                         layernorm=True, matmul_precision="highest")
    out = {}
    for distributed in (False, True):
        before = collectives.launches
        tr = Trainer(types.SimpleNamespace(model="DG_AE"), cfg, training_id=str(distributed),
                     save_dir=str(tmp_path), batch_size=4, distributed=distributed, seed=3,
                     device="cuda")
        assert (tr.group is not None) == distributed
        m = tr.train(2, ds, ds[:4])
        out[distributed] = (m, step.param_leaves(tr.params) + step.param_leaves(tr.state),
                            collectives.launches - before)
    # 3 train and 1 val steps an epoch: one all-reduce each
    assert (out[False][2], out[True][2]) == (0, 8)
    for phase in ("train", "val"):
        for k, v in out[False][0][phase].items():
            if k != "time":
                assert out[True][0][phase][k] == v, (phase, k)
    for a, c in zip(out[True][1], out[False][1], strict=True):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dim, route", [(64, "kernel"), (256, "edge")])
def test_sharded_step_at_mp1_on_card_matches_single_device_step(one_rank_nccl, dim, route):
    """The sharded step at mp = 1 against the single-device step, weights
    [1, 0, 4, 0] (the prob term's readout kinks move with the order of the
    struct sums): each gradient leaf within 1e-4 * max(its scale, 1). At
    D = 64 the batch's dst-complete tables select the kernel route (kernels
    5 and 6, kernel 5 once and kernel 6 three times per real level, the
    plain sharded struct towers) against kernels 1, 2, 7 and 8; at D = 256,
    past the kernels' width, the same batch takes the edge-split route,
    plain torch with no kernel launched, against the single-device step's
    plain route."""
    from mgvae_tpu_torch.data.batching import shard_levels_by_dst
    from mgvae_tpu_torch.parallel import mesh, sharded

    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=dim, s_rounds=2, t_rounds=2,
                         layernorm=True, matmul_precision="highest")
    rng = np.random.default_rng(6)
    batch = shard_levels_by_dst(
        collate([random_circuit(rng, "mig", num_inputs=8, num_gates=120) for _ in range(4)]), 1)
    gen = torch.Generator().manual_seed(3)
    neg = tuple(t.to(torch.int32).cuda() for t in torch.randint(
        0, int(batch["n_nodes"]), (2, batch["edge_src"].shape[0]), generator=gen))
    keep = [(torch.rand(batch["gate"].shape[0], cfg.dim_mlp, generator=gen) < 0.8).cuda()
            for _ in range(2)]
    assert sharded.route_of(batch, cfg, 1) == route
    m11 = mesh.make_mesh(1, 1)
    grads = {}
    for kind in ("single", "sharded"):
        params, state = dg_ae.init_params(cfg, seed=4, device="cuda")
        leaves = step.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        opt = torch.optim.SGD(leaves, lr=0.0)
        fn = (step.make_train_step(cfg, opt)[0] if kind == "single"
              else sharded.make_sharded_train_step(cfg, opt, m11))
        _zero_counts()
        fn(params, state, batch, None, [1.0, 0.0, 4.0, 0.0], neg_edges=neg, drop_keep=keep)
        torch.cuda.synchronize()
        if kind == "sharded":
            n_lv = dg_ae.num_levels(batch) if route == "kernel" else 0
            assert (level_kernel.step_launches, level_kernel.step_bwd_launches,
                    level_kernel.launches, struct_kernel.launches) == (n_lv, 3 * n_lv, 0, 0)
        grads[kind] = [None if t.grad is None else t.grad.cpu() for t in leaves]
    for a, c in zip(grads["sharded"], grads["single"], strict=True):
        assert (a is None) == (c is None)
        if c is not None:
            assert (a - c).abs().max().item() <= 1e-4 * max(c.abs().max().item(), 1.0)


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_step_kernels_on_member_tables_match_plain_on_card(cuda, mp):
    """Kernels 5 and 6 on each member's dst-complete tables
    (``shard_levels_by_dst``), every real level: h_new and the residual rows
    they write within 1e-4, each backward output within 1e-4 * max(scale, 1)
    of level_step_reference / level_step_bwd_reference."""
    from mgvae_tpu_torch.data.batching import shard_levels_by_dst
    from mgvae_tpu_torch.parallel import sharded

    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2, layernorm=True,
                         matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, seed=2, device=cuda)
    rng = np.random.default_rng(9)
    batch = shard_levels_by_dst(
        collate([random_circuit(rng, "mig", num_inputs=8, num_gates=150) for _ in range(6)],
                mp=mp), mp)
    gen = torch.Generator(device=cuda).manual_seed(5)
    with torch.no_grad():
        hs, hf, _ = dg_ae.forward(params, batch, cfg)
        expert = cfg.expert_of_gate(cuda)[dg_ae.batch_to_device(batch, cuda)["gate"].long()]
        for m in range(mp):
            b = sharded.member_to_device(sharded.member_slices(batch, m, mp), cuda, "kernel")
            a = sharded.member_level_inputs(params, b, cfg, hs, expert)
            for lv in range(dg_ae.num_levels(batch)):
                sa = (hf, a[0][lv], a[1][lv], a[2][lv], a[3][lv], a[5][lv], a[6][lv], *a[7:])
                h_k, re_k, rn_k = level_kernel._step_forward_cuda(sa, residuals=True)
                h_r, re_r, rn_r = level_kernel.level_step_reference(*sa, with_residuals=True)
                e_live, s_live = level_kernel.live_rows(sa[3], sa[4], sa[5])
                torch.testing.assert_close(h_k, h_r, rtol=0, atol=1e-4)
                torch.testing.assert_close(re_k[e_live], re_r[e_live], rtol=0, atol=1e-4)
                torch.testing.assert_close(rn_k[s_live], rn_r[s_live], rtol=0, atol=1e-4)
                g = torch.randn(sa[5].shape[0], 64, device=cuda, generator=gen)
                re_k = torch.where(e_live[:, None], re_k, 0.0)
                rn_k = torch.where(s_live[:, None], rn_k, 0.0)
                got = level_kernel._step_backward_cuda(g, re_k, rn_k, sa[1:], hf.shape[0])
                want = level_kernel.level_step_bwd_reference(g, re_k, rn_k, *sa[1:9], sa[10],
                                                             sa[11], num_nodes=hf.shape[0])
                for x, r in zip(got, want, strict=True):
                    assert (x - r).abs().max().item() <= 1e-4 * max(r.abs().max().item(), 1.0)


# ---- the multi-task steps: backwards re-entered from one forward ----------------

def _task_case(cuda, route, monkeypatch):
    """MIG at D = 64, 2 rounds, and a batch that takes ``route``: the fused
    scan (one plain batch), the step route (two chunks with ``kernel_fits``
    patched to False) or the giant scan (one layered circuit past the size
    gate)."""
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2, layernorm=True,
                         matmul_precision="highest")
    rng = np.random.default_rng(12)
    if route == "giant":
        batch = collate([layered_circuit(rng, "mig", width=512, depth=24, num_tt_pairs=256)])
        monkeypatch.setattr(level_kernel, "KERNEL_MAX_NODES", 8192)
    else:
        graphs = [random_circuit(rng, "mig", num_inputs=8, num_gates=60 + 20 * i)
                  for i in range(6)]
        batch = collate_chunked(graphs, 2) if route == "step" else collate(graphs)
        if route == "step":
            monkeypatch.setattr(dg_ae, "kernel_fits", lambda *a: False)
    gen = torch.Generator().manual_seed(5)
    valid = torch.as_tensor(np.flatnonzero(batch["node_valid"]))
    neg = tuple(valid[torch.randint(0, len(valid), (batch["edge_src"].shape[0],),
                                    generator=gen)].to(torch.int32) for _ in range(2))
    keep = [torch.rand(batch["gate"].shape[0], cfg.dim_mlp, generator=gen) < 0.8
            for _ in range(2)]
    return cfg, batch, neg, keep


@pytest.mark.parametrize("route", ["fused", "step", "giant"])
def test_task_grads_equal_three_passes_on_card(cuda, route, monkeypatch):
    """The three per-task gradients of one forward (the struct backward
    re-entered three times, the route's level backward twice, from the same
    saved residuals) equal three separate forward + backward passes with the
    same draws bit for bit."""
    from mgvae_tpu_torch.train import losses, trainer_balancer

    cfg, batch, neg, keep = _task_case(cuda, route, monkeypatch)
    params, state = dg_ae.init_params(cfg, seed=4, device=cuda)
    leaves = step.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    neg, keep = tuple(t.to(cuda) for t in neg), [k.to(cuda) for k in keep]
    _zero_counts()
    one, _, _, _ = trainer_balancer.task_grads(cfg, params, state, batch, None, neg_edges=neg,
                                               drop_keep=keep)
    torch.cuda.synchronize()
    counts = _all_counts()
    three = []
    for t in range(3):
        b = dg_ae.batch_to_device(batch, cuda)
        hs, hf, _ = dg_ae.forward_device(params, b, cfg, dg_ae.level_counts(batch))
        loss = (losses.recon_loss(params, hs, b, neg_edges=neg)[0] if t == 0
                else losses.prob_loss(params, state, hf, b, True, drop_keep=keep)[0] if t == 1
                else losses.func_loss(hf, b))
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        three.append([torch.zeros_like(x) if y is None else y for x, y in zip(leaves, g)])
    for t in range(3):
        assert all(torch.equal(a, c) for a, c in zip(one[t], three[t])), t
    # _all_counts' order: struct 0 / 1, level 2 / 3, lists 4, step 5 / 6, giant 7 / 8
    assert counts[1] == 3 * STRUCT_BWD_LAUNCHES and counts[4] == 1
    fwd, bwd = {"fused": (2, 3), "step": (5, 6), "giant": (7, 8)}[route]
    assert counts[fwd] > 0 and counts[bwd] > 0 and counts[bwd] % 2 == 0
    assert sum(counts[2:4] + counts[5:]) == counts[fwd] + counts[bwd]


def test_balancer_step_on_card_matches_cpu(cuda):
    """One Balancer step on the card against the CPU: each task's gradient
    leaf, each scale and the weighted sum within 1e-4 * max(its scale, 1)."""
    from mgvae_tpu_torch.train import gradnorm, trainer_balancer

    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2, layernorm=True,
                         matmul_precision="highest")
    rng = np.random.default_rng(6)
    batch = collate([random_circuit(rng, "mig", num_inputs=8, num_gates=120) for _ in range(4)])
    gen = torch.Generator().manual_seed(3)
    neg = tuple(t.to(torch.int32) for t in torch.randint(
        0, int(batch["n_nodes"]), (2, batch["edge_src"].shape[0]), generator=gen))
    keep = [torch.rand(batch["gate"].shape[0], cfg.dim_mlp, generator=gen) < 0.8
            for _ in range(2)]
    bal_cfg = gradnorm.BalancerConfig(weights=(1.0, 4.0, 2.0))
    out = {}
    for dev in ("cpu", cuda):
        params, state = dg_ae.init_params(cfg, seed=4, device=dev)
        leaves = step.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        draws = dict(neg_edges=tuple(t.to(dev) for t in neg), drop_keep=[k.to(dev) for k in keep])
        tasks, _, _, _ = trainer_balancer.task_grads(cfg, params, state, batch, None, **draws)
        run = trainer_balancer.make_balancer_train_step(cfg, torch.optim.SGD(leaves, lr=0.0),
                                                        bal_cfg)
        _, _, m = run(params, state, gradnorm.balancer_init(bal_cfg, dev), batch, None, **draws)
        out[str(dev)] = ([[g.cpu() for g in t] for t in tasks],
                         [m[f"scale_{t}"].cpu() for t in trainer_balancer.TASKS],
                         [t.grad.cpu() for t in leaves])
    (tasks_g, scales_g, sum_g), (tasks_c, scales_c, sum_c) = out["cuda"], out["cpu"]
    pairs = [p for t in range(3) for p in zip(tasks_g[t], tasks_c[t])]
    pairs += list(zip(scales_g, scales_c)) + list(zip(sum_g, sum_c))
    for a, c in pairs:
        assert (a - c).abs().max().item() <= 1e-4 * max(c.abs().max().item(), 1.0)


# ---- the native host library on the card's host ---------------------------------

def test_native_library_loads_on_the_card_host(cuda, monkeypatch):
    """The port's library builds with g++ and loads beside the card, at ABI
    3, and its collate is the numpy branch's byte for byte."""
    from mgvae_tpu_torch import native

    lib = native.get_lib()
    assert lib is not None and lib.mg_abi_version() == native.ABI_VERSION == 3
    graphs = [random_circuit(np.random.default_rng(4), "mig", num_inputs=8, num_gates=120)
              for _ in range(8)]
    got = collate(graphs, mp=2)
    monkeypatch.setattr(native, "_lib", False)
    want = collate(graphs, mp=2)
    assert set(got) == set(want)
    for k in want:
        a, c = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == c.dtype and a.shape == c.shape and np.array_equal(a, c), k


def test_trainer_epochs_native_equal_numpy_on_card(cuda, tmp_path, monkeypatch):
    """Two fixed-dims trainer epochs on the card, the data layer on the
    native library (collates and the stats-cache dims scan) against its
    numpy branch: the same dims, per-step metrics and params bit for bit."""
    import types

    from mgvae_tpu_torch import native
    from mgvae_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(1)
    ds = [random_circuit(rng, "mig", num_inputs=6, num_gates=60 + 10 * (i % 4))
          for i in range(16)]
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2,
                         layernorm=True, matmul_precision="highest")
    out = {}
    for kind in ("native", "numpy"):
        if kind == "numpy":
            monkeypatch.setattr(native, "_lib", False)
        tr = Trainer(types.SimpleNamespace(model="DG_AE"), cfg, training_id=kind,
                     save_dir=str(tmp_path), batch_size=4, distributed=False, seed=3,
                     device="cuda")
        metrics, run = [], tr.train_step

        def recorded(*a, _run=run, _metrics=metrics, **k):
            o = _run(*a, **k)
            _metrics.append(o[1])
            return o

        tr.train_step = recorded
        tr.train(2, ds, ds[:8])
        out[kind] = (dict(tr._dims_max), tr._chunks, len(tr._stats_caches),
                     [[m[k].item() for k in sorted(m)] for m in metrics],
                     [t.detach().cpu() for t in step.param_leaves(tr.params)])
    (d_n, c_n, caches_n, m_n, p_n), (d_p, c_p, caches_p, m_p, p_p) = out["native"], out["numpy"]
    assert (d_n, c_n) == (d_p, c_p) and (caches_n, caches_p) == (2, 0)
    assert m_n == m_p and len(m_n) == 2 * 4
    for a, c in zip(p_n, p_p, strict=True):
        assert torch.equal(a, c)


@pytest.mark.parametrize("route", ["kernel", "edge"])
def test_bf16_sharded_step_at_mp1_on_card_equals_fp32(one_rank_nccl, route):
    """compute_dtype="bfloat16" on the sharded step at mp = 1 computes what
    the JAX package's sharded routes compute, fp32: with deterministic
    algorithms on (the towers' index_add_ is atomic otherwise) the fp32 step
    repeats itself bit for bit, and the bf16 step equals it."""
    from mgvae_tpu_torch.data.batching import shard_levels_by_dst
    from mgvae_tpu_torch.parallel import mesh, sharded

    rng = np.random.default_rng(6)
    batch = shard_levels_by_dst(
        collate([random_circuit(rng, "mig", num_inputs=8, num_gates=120) for _ in range(4)]), 1)
    if route == "edge":
        batch = {k: v for k, v in batch.items() if not k.startswith("mp_lv_")}
    gen = torch.Generator().manual_seed(3)
    neg = tuple(t.to(torch.int32).cuda() for t in torch.randint(
        0, int(batch["n_nodes"]), (2, batch["edge_src"].shape[0]), generator=gen))
    keep = [(torch.rand(batch["gate"].shape[0], 32, generator=gen) < 0.8).cuda()
            for _ in range(2)]
    m11 = mesh.make_mesh(1, 1)
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for dtype in ("float32", "float32", "bfloat16"):
            cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2,
                                 layernorm=True, matmul_precision="highest", dim_mlp=32,
                                 compute_dtype=dtype)
            assert sharded.route_of(batch, cfg, 1) == route
            params, state = dg_ae.init_params(cfg, seed=4, device="cuda")
            leaves = step.param_leaves(params)
            for t in leaves:
                t.requires_grad_(True)
            fn = sharded.make_sharded_train_step(cfg, torch.optim.SGD(leaves, lr=0.1), m11)
            st, metrics = fn(params, state, batch, None, [1.0, 4.0, 4.0, 0.0], neg_edges=neg,
                             drop_keep=keep)
            runs.append([t.detach().cpu() for t in leaves + step.param_leaves(st)]
                        + [metrics[k].cpu() for k in sorted(metrics)])
    finally:
        torch.use_deterministic_algorithms(False)
    for other in runs[1:]:
        for a, c in zip(other, runs[0], strict=True):
            assert a.dtype == c.dtype == torch.float32 and torch.equal(a, c)


# ---- the K-step calls (train.step.make_multi_step / make_multi_eval) ----------------

MS_CFG = dict(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2, layernorm=True,
              matmul_precision="highest")
MS_WEIGHTS = [1.0, 4.0, 4.0, 0.0]


def _ms_group(K=4, bs=4, seed=7):
    """A group of K bs-circuit steps stacked at their common dims."""
    from mgvae_tpu_torch.data import batching

    rng = np.random.default_rng(seed)
    graphs = [random_circuit(rng, "mig", num_inputs=8, num_gates=100 + 10 * (i % 3))
              for i in range(K * bs)]
    shards = [graphs[i * bs:(i + 1) * bs] for i in range(K)]
    dims: dict = {}
    for sh in shards:
        for k, v in batching.natural_dims(sh).items():
            dims[k] = max(dims.get(k, 0), v)
    return batching.collate_shards(shards, dims=dims)


def _ms_run(sb, groups, grouped, lr_at=None, group=None):
    """``groups`` K-step train and eval calls (grouped) or their K
    train_step / eval_step calls each; ``lr_at`` (group, lr): set_lr before
    that group; ``group``: a data-parallel process group for every call.
    Returns every metric row, the params, Adam's state and BN state after,
    the generator's state and the captures."""
    cfg = dg_ae.DGConfig(**MS_CFG)
    params, state = dg_ae.init_params(cfg, seed=1, device="cuda")
    opt = step.make_optimizer(params, 1e-3)
    gen = torch.Generator(device="cuda").manual_seed(2)
    multi = step.make_multi_step(cfg, opt, group=group)
    multi_eval = step.make_multi_eval(cfg, group=group)
    train_step, eval_step = step.make_train_step(cfg, opt, group=group)
    K = sb["gate"].shape[0]

    def row(m):
        return torch.stack([m[k] for k in step.METRIC_KEYS])

    rows = []
    for g in range(groups):
        if lr_at and g == lr_at[0]:
            step.set_lr(opt, lr_at[1])
        if grouped:
            state, r = multi(params, state, sb, gen, MS_WEIGHTS)
            rows += [r, multi_eval(params, state, sb, gen, MS_WEIGHTS)]
            continue
        for k in range(K):
            state, m = train_step(params, state, step.step_of(sb, k), gen, MS_WEIGHTS)
            rows.append(row(m)[None])
        rows += [row(eval_step(params, state, step.step_of(sb, k), gen, MS_WEIGHTS))[None]
                 for k in range(K)]
    torch.cuda.synchronize()
    adam = [t for p in step.param_leaves(params) for t in opt.state[p].values()]
    return (torch.cat(rows), step.param_leaves(params) + adam + step.param_leaves(state),
            gen.get_state(), multi.captures + multi_eval.captures)


def _ms_equal(a, b):
    return (torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
            and all(torch.equal(x, y) for x, y in zip(a[1], b[1], strict=True)))


def test_multi_step_graph_equals_eager_steps_on_card(cuda):
    """K = 4: two K-step train and eval calls (the first step of each
    eager, then one capture each and replays) against the 16 eager steps:
    metric rows, params, Adam's state, BN state and the generator's state
    bit for bit; each replay counts the launches its graph holds."""
    sb = _ms_group()
    before = step.launch_counts()
    graph = _ms_run(sb, 2, True)
    mid = step.launch_counts()
    eager = _ms_run(sb, 2, False)
    after = step.launch_counts()
    assert graph[3] == 2 and _ms_equal(graph, eager)
    for m, n in (("struct", "launches"), ("struct", "bwd_launches"), ("level", "launches"),
                 ("level", "bwd_launches"), ("level", "lists_launches")):
        mod = struct_kernel if m == "struct" else level_kernel
        assert mid[(mod, n)] - before[(mod, n)] == after[(mod, n)] - mid[(mod, n)] > 0, n


def test_multi_step_lr_change_after_capture_takes_effect_on_card(cuda):
    """set_lr between calls writes the device lr that the captured step
    reads: three calls with the lr changed before the third equal the eager
    steps with the same change, and differ from the calls without it."""
    sb = _ms_group(K=2)
    changed = _ms_run(sb, 3, True, lr_at=(2, 1e-2))
    assert changed[3] == 2 and _ms_equal(changed, _ms_run(sb, 3, False, lr_at=(2, 1e-2)))
    assert not _ms_equal(changed, _ms_run(sb, 3, True))


def test_multi_step_captures_anew_after_a_loaded_state_on_card(cuda):
    """A loaded optimizer state (new tensors, as from a checkpoint) moves
    what the captured step read: the next call runs its first step eagerly
    and captures again, and the calls equal the eager steps with the same
    load, bit for bit."""
    import copy

    sb = _ms_group(K=2)
    cfg = dg_ae.DGConfig(**MS_CFG)
    out = []
    for grouped in (True, False):
        params, state = dg_ae.init_params(cfg, seed=1, device="cuda")
        opt = step.make_optimizer(params, 1e-3)
        gen = torch.Generator(device="cuda").manual_seed(2)
        multi = step.make_multi_step(cfg, opt)
        train_step, _ = step.make_train_step(cfg, opt)
        rows = []
        for g in range(3):
            if g == 2:   # the state through the host, as a checkpoint brings it
                saved = copy.deepcopy(opt.state_dict())
                for st in saved["state"].values():
                    for k, v in st.items():
                        st[k] = v.cpu()
                opt.load_state_dict(saved)
            if grouped:
                state, r = multi(params, state, sb, gen, MS_WEIGHTS)
                rows.append(r)
                continue
            for k in range(sb["gate"].shape[0]):
                state, m = train_step(params, state, step.step_of(sb, k), gen, MS_WEIGHTS)
                rows.append(torch.stack([m[x] for x in step.METRIC_KEYS])[None])
        torch.cuda.synchronize()
        out.append((torch.cat(rows), step.param_leaves(params) + step.param_leaves(state),
                    multi.captures))
    assert out[0][2] == 2 and torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1], strict=True))


def test_padded_level_walk_equals_real_walk_on_card(cuda):
    """Kernels 1 and 2 over every row of level tables padded past the real
    levels (what a captured step walks) against the real levels: hf and
    every gradient bit for bit."""
    from mgvae_tpu_torch.data import batching

    cfg = dg_ae.DGConfig(**MS_CFG)
    params, _ = dg_ae.init_params(cfg, seed=1, device=cuda)
    rng = np.random.default_rng(8)
    graphs = [random_circuit(rng, "mig", num_inputs=8, num_gates=150) for _ in range(4)]
    dims = batching.natural_dims(graphs)
    dims["L"] += 11
    batch = collate(graphs, dims=dims)
    b = dg_ae.batch_to_device(batch, cuda)
    with torch.no_grad():
        hs = dg_ae.struct_hs(params, b, cfg)
        args = dg_ae.level_scan_inputs(params, b, cfg, hs)
    args = [a.detach().requires_grad_(a.is_floating_point()) for a in args]
    floats = [args[i] for i in level_kernel.FLOAT_ARGS]
    real, L = dg_ae.level_counts(batch)[0], args[0].shape[0]
    assert dg_ae.table_levels(batch) == (L,) and real < L
    cot = torch.randn((hs.shape[0], hs.shape[1]), generator=torch.Generator().manual_seed(0))
    outs = []
    for n in (real, L):
        hf = level_kernel.level_scan(*args, num_nodes=hs.shape[0], num_levels=n)
        outs.append([hf.detach()] + list(torch.autograd.grad((hf * cot.cuda()).sum(), floats)))
    assert all(torch.equal(x, y) for x, y in zip(*outs, strict=True))


def test_multi_step_over_one_nccl_rank_on_card(one_rank_nccl):
    """Under a one-rank NCCL group, two K = 4 train and eval calls (the
    all-reduce captured in each step's graph) against their 16 eager
    ``train_step(group=)`` / ``eval_step(group=)`` calls and against the
    single-device K-step calls: bit for bit; each replay counts the
    launches its graph holds, one all-reduce a step among them."""
    from mgvae_tpu_torch.parallel import collectives

    sb = _ms_group()
    before = step.launch_counts()
    graph = _ms_run(sb, 2, True, group=one_rank_nccl)
    mid = step.launch_counts()
    eager = _ms_run(sb, 2, False, group=one_rank_nccl)
    after = step.launch_counts()
    single = _ms_run(sb, 2, True)
    assert graph[3] == 2 and _ms_equal(graph, eager) and _ms_equal(graph, single)
    for mod, n in ((struct_kernel, "launches"), (struct_kernel, "bwd_launches"),
                   (level_kernel, "launches"), (level_kernel, "bwd_launches"),
                   (level_kernel, "lists_launches"), (collectives, "launches")):
        assert mid[(mod, n)] - before[(mod, n)] == after[(mod, n)] - mid[(mod, n)] > 0, n
    # 2 calls x (4 train + 4 eval steps), one all-reduce each
    assert mid[(collectives, "launches")] - before[(collectives, "launches")] == 16


def test_multi_step_step_route_gradients_match_real_walk_on_card(cuda, monkeypatch):
    """Fault 3.10 decided: ONE step on the step route (chunks past the
    patched size gate; blocks of 4 level indices from the top, which shift
    with the padded walk) as the K-step call's replayed graph and as ``train_step``'s
    real-level walk, from the same params (Adam at lr 0 keeps them) and
    draws: each gradient leaf within 1e-4 of its own scale, floored at
    GRAD_FLOOR of the largest entry over all leaves as the card-vs-CPU
    steps floor it. The gradients after a replay are the params' ``.grad``."""
    from mgvae_tpu_torch.data import batching

    monkeypatch.setattr(level_kernel, "KERNEL_MAX_NODES", 64)
    monkeypatch.setattr(level_kernel, "step_chunk_levels", lambda *a, **k: 4)
    rng = np.random.default_rng(9)
    # the second step's circuits are the smaller: its real levels sit below
    # the group's padded L
    shards = [[random_circuit(rng, "mig", num_inputs=8, num_gates=110 - 50 * s + 10 * i)
               for i in range(4)] for s in range(2)]
    sb = batching.collate_shards(shards, num_chunks=2)
    second = step.step_of(sb, 1)
    assert dg_ae.level_counts(second) != dg_ae.table_levels(second)
    cfg = dg_ae.DGConfig(**MS_CFG)
    grads = {}
    for mode in ("graph", "real"):
        params, state = dg_ae.init_params(cfg, seed=1, device="cuda")
        opt = step.make_optimizer(params, 0.0)
        gen = torch.Generator(device="cuda").manual_seed(2)
        before = level_kernel.step_bwd_launches
        if mode == "graph":
            multi = step.make_multi_step(cfg, opt)
            multi(params, state, sb, gen, MS_WEIGHTS)
            assert multi.captures == 1
        else:
            train_step, _ = step.make_train_step(cfg, opt)
            for k in range(2):
                state, _ = train_step(params, state, step.step_of(sb, k), gen, MS_WEIGHTS)
        torch.cuda.synchronize()
        assert level_kernel.step_bwd_launches > before
        grads[mode] = [None if p.grad is None else p.grad.detach().clone()
                       for p in step.param_leaves(params)]
    scale = max(g.abs().max().item() for g in grads["real"] if g is not None)
    for a, c in zip(grads["graph"], grads["real"], strict=True):
        assert (a is None) == (c is None)
        if c is not None:
            tol = 1e-4 * max(c.abs().max().item(), GRAD_FLOOR * scale)
            assert (a - c).abs().max().item() <= tol


def test_multi_step_under_gloo_on_card_raises(cuda, tmp_path):
    """A gloo group on the card (processes sharing one card run gloo): the
    K-step call raises a ValueError that names NCCL before any step runs
    (no launch, the params unchanged), and the trainer at
    ``steps_per_call`` 8 steps singly."""
    import types

    import torch.distributed as dist

    from mgvae_tpu_torch.train.trainer import Trainer

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        cfg = dg_ae.DGConfig(**MS_CFG)
        params, state = dg_ae.init_params(cfg, seed=1, device="cuda")
        kept = [t.detach().clone() for t in step.param_leaves(params)]
        multi = step.make_multi_step(cfg, step.make_optimizer(params, 1e-3),
                                     group=dist.group.WORLD)
        before = step.launch_counts()
        with pytest.raises(ValueError, match="NCCL"):
            multi(params, state, _ms_group(K=2), torch.Generator(device="cuda").manual_seed(2),
                  MS_WEIGHTS)
        assert step.launch_counts() == before and multi.captures == 0
        assert all(torch.equal(a, b) for a, b in zip(step.param_leaves(params), kept))
        tr = Trainer(types.SimpleNamespace(model="DG_AE"), cfg, training_id="gloo",
                     save_dir=str(tmp_path), batch_size=4, distributed=True, seed=3,
                     device="cuda", steps_per_call=8)
        assert tr.group is not None and not tr.grouped and "gloo" in tr.step_mode
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("card", ["first", "last"])
def test_kernels_on_each_card_match_plain_versions_on_card(cuda, card):
    """Kernels 7, 8, 1, 2, 5 and 6 against their plain versions on a card
    (``examples.dryrun_multichip.kernel_checks``: forward and backward by
    their C entries, the backwards through autograd on its device thread,
    and both replayed from a captured CUDA graph). "last": on cuda:0 and
    then on the last card while cuda:0 stays the current device, which needs
    each level kernel's launcher to configure itself per device (the shared
    memory a kernel may take belongs to the device it was allowed on);
    skipped with one card."""
    from mgvae_tpu_torch.examples.dryrun_multichip import SIZES, kernel_checks

    n = torch.cuda.device_count()
    if card == "last" and n < 2:
        pytest.skip(f"needs two cards, torch.cuda.device_count() is {n}")
    devs = [torch.device("cuda", 0)] + ([torch.device("cuda", n - 1)] if card == "last" else [])
    for dev in devs:
        rows = kernel_checks(dev, SIZES["cuda"])
        assert torch.cuda.current_device() == 0
        assert {mode for _, mode, _, _ in rows} == {"main", "graph", "autograd"}
        bad = [row for row in rows if not row[2] <= 1.0]
        assert not bad, (dev, bad)


def test_failed_capture_raises_on_card(cuda, monkeypatch):
    """A step that cannot be captured (it reads a loss back on the host)
    raises from the K-step call: its first step runs eagerly, the capture
    fails, and nothing runs in the replay's place. Last in the file: the
    failed capture's stream is the call's own."""
    sb = _ms_group(K=2)
    cfg = dg_ae.DGConfig(**MS_CFG)
    params, state = dg_ae.init_params(cfg, seed=1, device="cuda")
    multi = step.make_multi_step(cfg, step.make_optimizer(params, 1e-3))
    real = step.func_loss

    def read_back(hf, b):
        loss = real(hf, b)
        float(loss)
        return loss

    monkeypatch.setattr(step, "func_loss", read_back)
    with pytest.raises(RuntimeError, match="capturing the train step"):
        multi(params, state, sb, torch.Generator(device="cuda").manual_seed(2), MS_WEIGHTS)
    assert multi.captures == 0
