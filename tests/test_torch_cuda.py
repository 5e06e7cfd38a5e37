"""The port's CUDA kernels on the card: they build from csrc/, launch, and
agree with their plain PyTorch versions; a training step on the card agrees
with the same step on the CPU. Marked ``cuda``; without a card these tests
skip. On a machine with one:
python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from mgvae_tpu_torch import Model, collate, random_circuit
from mgvae_tpu_torch.models import dg_ae
from mgvae_tpu_torch.ops import level_kernel
from mgvae_tpu_torch.train import step

pytestmark = pytest.mark.cuda
GRAD_FLOOR = 2e-2    # leaf scale floor, as a share of the largest gradient entry


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
                         layernorm=True)
    params, _ = dg_ae.init_params(cfg, seed=1, device=cuda)
    rng = np.random.default_rng(2)
    batch = collate([random_circuit(rng, modality, num_inputs=8, num_gates=120)
                     for _ in range(4)])
    b = dg_ae.batch_to_device(batch, cuda)
    hs = dg_ae.struct_hs(params, b, cfg)
    args = dg_ae.level_scan_inputs(params, b, cfg, hs)
    n_lv = dg_ae.num_levels(batch)
    level_kernel.launches = 0
    hf_k = level_kernel.level_scan(*args, num_nodes=hs.shape[0], num_levels=n_lv)
    torch.cuda.synchronize()
    assert level_kernel.launches == n_lv
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
        # atomic index_add_ sums on the card: run-to-run order differences
        np.testing.assert_allclose(hs_g, hs_c, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(hf_g, hf_c, rtol=0, atol=1e-4)


def test_kernel_rejects_unsupported_width(cuda):
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=160, s_rounds=1, t_rounds=1)
    params, _ = dg_ae.init_params(cfg, device=cuda)
    batch = collate([random_circuit(np.random.default_rng(0), "mig", num_inputs=4,
                                    num_gates=20)])
    with pytest.raises(ValueError, match="D <= 128"):
        dg_ae.forward(params, batch, cfg)


@pytest.mark.parametrize("modality,dim", [("aig", 32), ("mig", 64), ("xag", 128), ("xmg", 96)])
def test_backward_kernel_matches_plain_version_on_card(cuda, modality, dim):
    cfg = dg_ae.DGConfig(modality=modality, dim_hidden=dim, s_rounds=2, t_rounds=2,
                         layernorm=True)
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
    hf_r, re_r, rn_r = level_kernel.level_scan_reference(*args, num_nodes=N, num_levels=n_lv,
                                                         with_residuals=True)
    for k, r in ((hf_k, hf_r), (re_k, re_r), (rn_k, rn_r)):
        torch.testing.assert_close(k, r, rtol=0, atol=1e-4)
    ghf = torch.randn(hf_k.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    bargs = (*args[:9], args[10], args[11])
    level_kernel.bwd_launches = 0
    grads_k = level_kernel._backward_cuda(ghf, re_k, rn_k, args, n_lv)
    torch.cuda.synchronize()
    # a slot and a source kernel per level, one weight-gradient kernel
    assert level_kernel.bwd_launches == 2 * n_lv + 1
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
    assert level_kernel.launches == n_lv and level_kernel.bwd_launches == 2 * n_lv + 1
    for a, k in zip(auto, grads_k):
        torch.testing.assert_close(a, k, rtol=0, atol=0)   # the same kernels, deterministic


def test_train_step_on_card_matches_cpu(cuda):
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=2, t_rounds=2, layernorm=True)
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
