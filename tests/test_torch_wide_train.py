"""Models wider than the kernels (D > 128) in training, against the JAX
package: one Adam step of ``make_train_step``, bf16, the ``Trainer`` and
the CLI at D = 160 and 256 (tests/test_torch_wide.py holds the forward and
the gradients on every layout).

Past D = 128 the port runs the eager struct towers and
``dg_ae.level_scan_fast`` (plain torch) on every device, as the JAX package
runs its XLA paths there. Tolerances: the Adam step as
tests/test_torch_train_step.py (the metrics rtol 1e-5, BatchNorm state atol
1e-6, the updated params within 1e-3 * lr wherever the gradient is past
1e-5 of its scale, 2 * lr everywhere). bf16: the JAX package's bounds
(tests/test_pallas_kernel.py:95-114) for a bf16 path against one that
rounds elsewhere, values atol 3e-2 / rtol 1e-1, against JAX's bf16 forward
(excess precision off) and its fp32 forward both. Its tighter bound, atol
2e-2, is for two paths with the same rounding points (a kernel and XLA);
at these widths JAX's own bf16 hs is up to 3.4e-2 from its fp32 hs (on
this test's batches), as the port's is up to 2.8e-2, since the two bf16
paths round the GRU's and the LayerNorm's elementwise operations at
different points. The bf16 gradients are held as tests/test_torch_bf16.py
holds them (``_leaves_close``): 0.05 * max(scale, 1) over all leaves, and
each leaf within 2^-4 of its own scale (NOISE_LEAVES floored at 2e-2 of
the largest entry). They leave the prob term out (BF16_WEIGHTS): its
readout's ReLU units and its L1 loss turn a gradient over where a
pre-activation or a prediction lies within bf16 rounding of a kink, and on
these batches that moved JAX's own bf16 readout gradients 0.195 from its
fp32 ones at a scale of 1.05, past the 0.05 bound. The func loss has an L1
kink too, so its bf16 norms and z-scores must round where JAX's do
(``train/losses.func_loss``, ``ops/init.rsqrt``): one ulp off flips a pair
that lies within bf16 rounding of its kink, and every expert leaf moves
30% of its scale.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgvae_tpu_torch
from mgvae_tpu.data.batching import collate, collate_chunked, collate_split
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
from mgvae_tpu_torch import cli
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.models import encoder
from mgvae_tpu_torch.ops.init import rsqrt
from mgvae_tpu_torch.ops import level_kernel
from mgvae_tpu_torch.train import losses as PL
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.train import trainer as ptrainer
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax
from test_torch_bf16 import KERNEL_ULPS, _leaf_names, _leaves_close

torch.set_num_threads(1)
WEIGHTS = [1.0, 4.0, 2.0, 0.0]
BF16_ATOL, BF16_RTOL = 3e-2, 1e-1
BF16_WEIGHTS = [1.0, 0.0, 2.0, 0.0]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _kw(D, **more):
    return dict(modality="mig", dim_hidden=D, s_rounds=2, t_rounds=2, layernorm=True, **more)


def _batch(layout, seed):
    rng = np.random.default_rng(seed)
    graphs = [random_circuit(rng, "mig", num_inputs=5, num_gates=14 + 6 * i, num_tt_pairs=12)
              for i in range(4)]
    if layout == "chunked":
        return collate_chunked(graphs, 2)
    if layout == "split":
        return collate_split(graphs, 2)
    return collate(graphs)


def _draws(key, hb, dim_mlp):
    """The negatives and dropout keep masks JAX's loss_and_metrics draws
    from ``key``, as torch tensors."""
    _, k_neg, k_drop = jax.random.split(key, 3)
    neg = JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0], jax.tree.map(jnp.asarray, hb))
    n = hb["gate"].shape[0]
    keep = [jax.random.bernoulli(k, 0.8, (n, dim_mlp)) for k in jax.random.split(k_drop, 2)]
    return (tuple(torch.tensor(np.asarray(x)) for x in neg),
            [torch.tensor(np.asarray(k)) for k in keep])


def _strict(jitted, *args):
    """A jitted JAX function with every bf16 rounding kept (no excess precision)."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@functools.cache
def _jax_forward_and_grad(cfg):
    """hs, hf and the loss's value and gradients, in one compiled call."""
    def fn(params, state, batch, key, w):
        hs, hf, _ = J.forward(params, batch, cfg)
        return (hs, hf), jax.value_and_grad(JS.loss_and_metrics, has_aux=True)(
            params, state, batch, key, w, cfg, True)
    return jax.jit(fn)


def _spy(monkeypatch):
    """Record every call of a kernel wrapper."""
    calls = []

    def wrap(owner, name):
        real = getattr(owner, name)
        monkeypatch.setattr(owner, name, lambda *a, **k: (calls.append(name), real(*a, **k))[1])

    wrap(encoder, "struct_towers")
    for name in ("level_scan", "level_scan_giant", "level_step", "level_lists"):
        wrap(P, name)
    wrap(level_kernel, "level_scan_step")
    return calls


@pytest.mark.parametrize("D,layout", [(256, "plain"), (160, "chunked")])
def test_wide_adam_step_matches_jax_make_train_step(D, layout):
    """One Adam step (lr 1e-3) of ``make_train_step`` in both packages from
    the same params and draws: the metrics, the BatchNorm state, and the
    updated params wherever the gradient is well away from 0."""
    lr = 1e-3
    jcfg, pcfg = J.DGConfig(**_kw(D)), P.DGConfig(**_kw(D))
    params, state = J.init_params(jax.random.PRNGKey(1), jcfg)
    hb = _batch(layout, seed=4)
    key, w = jax.random.PRNGKey(8), jnp.asarray(WEIGHTS)
    batch = jax.tree.map(jnp.asarray, hb)
    opt = JS.make_optimizer(lr)
    j_step, _ = JS.make_train_step(jcfg, opt, mesh=None, donate=False)
    p1_j, s1_j, _, m_j = j_step(params, state, opt.init(params), batch, key, w)
    _, ((_, _), g_j) = _jax_forward_and_grad(jcfg)(params, state, batch, key, w)

    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    p_step, _ = PS.make_train_step(pcfg, PS.make_optimizer(pp, lr))
    neg, keep = _draws(key, hb, pcfg.dim_mlp)
    s1_p, m_p = p_step(pp, ps, hb, None, WEIGHTS, neg_edges=neg, drop_keep=keep)
    for k in PS.METRIC_KEYS:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    for a, c in zip(_leaves(params_to_numpy(s1_p)), _leaves(s1_j)):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
    g = _leaves(g_j)
    scale = max(float(np.abs(x).max()) for x in g)
    for a, c, gj in zip(_leaves(params_to_numpy(pp)), _leaves(p1_j), g):
        d = np.abs(a - c)
        assert d.max() <= 2 * lr
        assert (d[np.abs(gj) > 1e-5 * scale] <= 1e-3 * lr).all()


@pytest.mark.parametrize("D,layout", [(160, "plain"), (256, "split")])
def test_wide_bf16_matches_jax(D, layout, monkeypatch):
    """compute_dtype="bfloat16" at D > 128: hs and hf against the JAX
    package's bf16 forward and its fp32 forward, the loss against JAX's
    bf16 one, at the bounds for bf16 paths that round elsewhere; the
    gradients against JAX's bf16 ones over all leaves and leaf by leaf; the
    master params and their gradients fp32; no kernel wrapper called."""
    calls = _spy(monkeypatch)
    jcfg, pcfg = J.DGConfig(**_kw(D)), P.DGConfig(**_kw(D), compute_dtype="bfloat16")
    jcfg16 = J.DGConfig(**_kw(D), compute_dtype="bfloat16")
    params, state = J.init_params(jax.random.PRNGKey(2), jcfg)
    hb = _batch(layout, seed=6)
    batch, key = jax.tree.map(jnp.asarray, hb), jax.random.PRNGKey(7)
    w = jnp.asarray(BF16_WEIGHTS)
    (hs16, hf16), ((tot16, _), g16) = _strict(_jax_forward_and_grad(jcfg16), params, state,
                                               batch, key, w)
    (hs32, hf32), _ = _jax_forward_and_grad(jcfg)(params, state, batch, key, w)

    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    leaves = PS.param_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    hs, hf, _ = P.forward(pp, hb, pcfg)
    assert hs.dtype == hf.dtype == torch.bfloat16
    valid = np.asarray(hb["node_valid"])
    for name, got, want16, want32 in (("hs", hs, hs16, hs32), ("hf", hf, hf16, hf32)):
        got = got.detach().float().numpy()[valid]
        for what, want in (("JAX bf16", np.asarray(want16.astype(jnp.float32))[valid]),
                           ("JAX fp32", np.asarray(want32)[valid])):
            print(f"{name} vs {what}: max|d| {np.abs(got - want).max():.3e} "
                  f"(scale {np.abs(want).max():.3e})")
            np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL,
                                       err_msg=f"{name} vs {what}")
    neg, keep = _draws(key, hb, pcfg.dim_mlp)
    tot, _ = PS.loss_and_metrics(pp, ps, hb, None, BF16_WEIGHTS, pcfg, True, neg_edges=neg,
                                 drop_keep=keep)
    tot.backward()
    assert calls == []
    tot = tot.item()
    assert abs(tot - float(tot16)) <= BF16_ATOL + BF16_RTOL * abs(float(tot16))
    assert all(t.dtype == torch.float32 and (t.grad is None or t.grad.dtype == torch.float32)
               for t in leaves)
    g_p = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves]
    assert all(np.isfinite(g).all() for g in g_p)
    _leaves_close(g_p, _leaves(g16), _leaf_names(params), "gradients")


def test_rsqrt_rounds_once_as_xla():
    """``ops.init.rsqrt`` on every positive normal bf16 value, as a 0-d
    tensor and as a vector: XLA's bf16 rsqrt (excess precision off), the
    correctly rounded 1 / sqrt(x); and in fp32 torch.rsqrt bit for bit."""
    x = torch.arange(0x0080, 0x7F80, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    want = np.asarray(_strict(jax.jit(jax.lax.rsqrt),
                              jnp.asarray(x.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    exact = torch.tensor(1.0 / np.sqrt(x.double().numpy())).bfloat16().float().numpy()
    np.testing.assert_array_equal(want, exact)
    np.testing.assert_array_equal(rsqrt(x).float().numpy(), want)
    scalar = np.array([rsqrt(v).float().item() for v in x[::7]], np.float32)
    np.testing.assert_array_equal(scalar, want[::7])
    y = torch.rand(1000, generator=torch.Generator().manual_seed(0)) + 1e-3
    assert torch.equal(rsqrt(y), torch.rsqrt(y))


@pytest.mark.parametrize("D,layout", [(160, "plain"), (256, "split")])
def test_wide_bf16_func_loss_cotangent_matches_jax(D, layout):
    """The func loss in bf16 on the same hf (the JAX package's bf16 forward
    of test_wide_bf16_matches_jax's case): its value and its cotangent into
    hf against the JAX package's (excess precision off), the cotangent
    within KERNEL_ULPS of its scale, as two bf16 paths that round at the
    same points. Rounding the norms and the z-score's rsqrt elsewhere
    (torch's vector_norm and CPU rsqrt) moved it 56% and 59% of its scale
    on these cases, where a pair lies within bf16 rounding of the loss's L1
    kink."""
    jcfg16 = J.DGConfig(**_kw(D), compute_dtype="bfloat16")
    params, _ = J.init_params(jax.random.PRNGKey(2), jcfg16)
    hb = _batch(layout, seed=6)
    batch = jax.tree.map(jnp.asarray, hb)
    hf = jax.jit(lambda p: J.forward(p, batch, jcfg16)[1])(params)
    loss_j, cot_j = _strict(jax.jit(jax.value_and_grad(
        lambda h: JL.func_loss(h, batch).astype(jnp.float32))), hf)
    b = {k: torch.as_tensor(np.asarray(hb[k])) for k in ("tt_pair_a", "tt_pair_b", "tt_valid",
                                                          "tt_dis", "n_tt")}
    h = torch.tensor(np.asarray(hf.astype(jnp.float32))).bfloat16().requires_grad_(True)
    loss = PL.func_loss(h, b)
    loss.float().backward()
    cot_j = np.asarray(cot_j.astype(jnp.float32))
    scale, err = float(np.abs(cot_j).max()), float(np.abs(h.grad.float().numpy() - cot_j).max())
    print(f"func loss {loss.item():.6f} vs {float(loss_j):.6f}; cotangent max|d| {err:.3e} "
          f"at scale {scale:.3e}, bound {KERNEL_ULPS * scale:.3e}")
    assert h.grad.dtype == torch.bfloat16
    assert abs(loss.item() - float(loss_j)) <= 2.0 ** -8 * abs(float(loss_j))
    assert err <= KERNEL_ULPS * scale


@pytest.mark.parametrize("cfg_kw", [dict(dim_hidden=160), dict(dim_hidden=64, num_rounds=2)],
                         ids=["d160", "rounds2"])
def test_trainer_searches_no_chunk_count_off_the_kernel_route(cfg_kw, tmp_path, monkeypatch):
    """On the card the chunk count is searched only for the level kernels'
    route: at D > 128 (no C passes ``kernel_fits``) and for num_rounds > 1
    the trainer takes C = 1 as the JAX trainer does, without collating the
    shards once per candidate C, and does not search again when the dims
    grow."""
    cfg = P.DGConfig(**{**_kw(64), **cfg_kw})
    t = ptrainer.Trainer(None, cfg, save_dir=str(tmp_path), batch_size=4, distributed=False,
                         steps_per_call=1, device="cpu")
    t.device = torch.device("cuda")     # the plan makes no CUDA call; the device is only named
    scans = []
    real = t._scan_dims
    monkeypatch.setattr(t, "_scan_dims", lambda *a: (scans.append(a[2]), real(*a))[1])
    rng = np.random.default_rng(0)
    small = [random_circuit(rng, "mig", num_inputs=4, num_gates=10) for _ in range(8)]
    big = [random_circuit(rng, "mig", num_inputs=4, num_gates=400) for _ in range(8)]
    t._epoch_plan(small)
    t._epoch_plan(big)
    assert t._chunks == 1 and scans == [1, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_epoch_at_d256(dtype, tmp_path):
    """One epoch of the ``Trainer`` at D = 256 on the CPU: finite losses,
    and the params moved."""
    cfg = P.DGConfig(**_kw(256), compute_dtype=dtype, matmul_precision="highest")
    t = ptrainer.Trainer(None, cfg, save_dir=str(tmp_path), batch_size=4, distributed=False,
                         steps_per_call=1, device="cpu", rc_prob_func_weight=WEIGHTS[:3])
    before = [x.detach().clone() for x in PS.param_leaves(t.params)]
    rng = np.random.default_rng(1)
    train = [mgvae_tpu_torch.random_circuit(rng, "mig", num_inputs=4, num_gates=12,
                                            num_tt_pairs=8) for _ in range(8)]
    out = t.train(1, train, train[:4])
    assert all(np.isfinite(out["train"][k]) for k in ("recon", "prob", "func"))
    assert any(not torch.equal(a, b) for a, b in zip(before, PS.param_leaves(t.params)))


@pytest.mark.parametrize("D,precision", [(160, "default"), (256, "highest")])
def test_cli_trains_at_wide_width(D, precision, tmp_path, monkeypatch):
    """``python -m mgvae_tpu_torch.train --dim_hidden D`` through its three
    stages on the CPU: the width reaches the model unchanged."""
    monkeypatch.setenv("MGVAE_PLATFORM", "cpu")
    trainer = cli.main(["--exp_id", "w", "--model", "DG_AE", "--type", "mig", "--batch_size", "4",
                        "--layernorm", "--dim_hidden", str(D), "--s_rounds", "1", "--t_rounds",
                        "1", "--stage_epochs", "1,0,1", "--synthetic_circuits", "10",
                        "--matmul_precision", precision, "--save_dir", str(tmp_path)])
    assert trainer.model_cfg.dim_hidden == D
    assert trainer.params["hs_linear"]["w"].shape == (2 * D, D)
    for name in ("stage_1.pth", "stage_3.pth", "model_last.pth"):
        assert (tmp_path / "w" / name).exists()
    assert all(torch.isfinite(x).all() for x in PS.param_leaves(trainer.params))
