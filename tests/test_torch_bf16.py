"""bf16 compute (``DGConfig(compute_dtype="bfloat16")``) in the port against
the JAX package's bf16 path: the plain versions of the four bf16 kernels
(the fused level scan and its backward, the struct towers and their
backward) against the JAX package's Pallas kernels in interpret mode on the
same bf16 inputs; the whole bf16 forward against
``forward(cfg16, use_pallas=True, pallas_interpret=True)`` and against the
fp32 forward; the gradients of a bf16 loss against ``jax.grad``; one bf16
Adam step on fp32 master params against ``make_train_step``; a bf16 DG_VAE
step with JAX's draws; and the routing per dtype (the fused route and the
struct kernels on plain, fit and split batches; the giant and step routes,
which tests/test_torch_bf16_routes.py holds against JAX).

Tolerances: every comparison holds the JAX package's own bf16 bounds
(tests/test_pallas_kernel.py:95-114): values atol 2e-2 / rtol 1e-1 against
the JAX bf16 kernel path, atol 3e-2 / rtol 1e-1 against fp32, gradients
0.05 * max(scale, 1). Those bounds are made for bf16 against fp32; two bf16
paths that round at the same points are held tighter as well, each tensor
or gradient leaf against its own largest entry: a kernel's outputs within
2^-6 of their scale (two bf16 ulps at the top of the range), a whole
model's gradient leaves within 2^-4 of theirs (the few leaves whose
gradient is 0 in exact arithmetic, NOISE_LEAVES, floored at 2e-2 of the
largest entry over all leaves). Each test prints its measured maxima.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgvae_tpu.data.batching import collate, collate_chunked, collate_fit, collate_split
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.ops.pallas.level_kernel import LANE, pallas_level_scan
from mgvae_tpu.ops.pallas.struct_kernel import pallas_struct_core
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import level_kernel, struct_kernel
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax

torch.set_num_threads(1)
BF16 = torch.bfloat16
D, ROUNDS = 32, 2
KW = dict(modality="mig", dim_hidden=D, s_rounds=ROUNDS, t_rounds=ROUNDS, layernorm=True)
VAL_ATOL, VAL_RTOL = 2e-2, 1e-1       # against the JAX bf16 kernel path
F32_ATOL = 3e-2                       # against fp32
GRAD_TOL = 0.05                       # of max(scale, 1)
KERNEL_ULPS = 2.0 ** -6               # of each output's scale: bf16 against bf16
LEAF_TOL = 2.0 ** -4                  # of each gradient leaf's scale, whole model
GRAD_FLOOR = 2e-2                     # a noise leaf's scale floor, of the largest entry
# the gradient leaves that are 0 in exact arithmetic and carry rounding noise
# alone: the attention's query side and key bias shift every logit into a
# node alike, which the softmax cancels, and the readout's biases before
# BatchNorm, which takes their mean out again
NOISE_LEAVES = (*(f"['experts']['{k}']" for k in ("wq", "bq", "wa_q", "ba", "bk")),
                *(f"['readout_prob']['layers'][{i}]['b']" for i in (0, 1)))
WEIGHTS = [1.0, 4.0, 4.0, 0.0]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _values_close(got, want, atol, what):
    """|got - want| <= atol + rtol |want| everywhere; prints the largest error."""
    got, want = _f32(got), _f32(want)
    err = float(np.abs(got - want).max())
    print(f"{what}: max |d| {err:.3e} (scale {float(np.abs(want).max()):.3e})")
    np.testing.assert_allclose(got, want, atol=atol, rtol=VAL_RTOL, err_msg=what)


def _ulps_close(got, want, what):
    """Two bf16 paths with the same rounding points: max |got - want| within
    KERNEL_ULPS of max |want| (no floor), which is inside the JAX bounds."""
    got, want = _f32(got), _f32(want)
    scale, err = float(np.abs(want).max()), float(np.abs(got - want).max())
    print(f"{what}: max |d| {err:.3e}, scale {scale:.3e}, bound {KERNEL_ULPS * scale:.3e}")
    assert np.isfinite(got).all() and err <= KERNEL_ULPS * scale, (what, err, scale)


def _grad_close(got, want, what):
    got, want = _f32(got), _f32(want)
    scale, err = float(np.abs(want).max()), float(np.abs(got - want).max())
    print(f"{what}: max |d| {err:.3e}, scale {scale:.3e}, bound {GRAD_TOL * max(scale, 1.0):.3e}")
    assert err <= GRAD_TOL * max(scale, 1.0), (what, err, scale)


def _leaves_close(got, want, names, what):
    """The JAX bound over all gradient leaves together, and each leaf within
    LEAF_TOL of its own scale (a noise leaf's floored at GRAD_FLOOR of the
    largest entry over all leaves)."""
    got, want = [_f32(g) for g in got], [_f32(w) for w in want]
    _grad_close(np.concatenate([g.reshape(-1) for g in got]),
                np.concatenate([w.reshape(-1) for w in want]), f"{what}, all leaves")
    floor = GRAD_FLOOR * max(float(np.abs(w).max()) for w in want)
    worst = (0.0, "")
    for name, g, w in zip(names, got, want):
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        if name in NOISE_LEAVES:
            scale = max(scale, floor)
        worst = max(worst, (err / (LEAF_TOL * scale) if scale else float(err > 0), name))
        assert err <= LEAF_TOL * scale, (what, name, err, scale)
    print(f"{what}: worst leaf {worst[1]} at {worst[0]:.3f} of {LEAF_TOL} * its scale "
          f"(noise leaves' floor {floor:.3e})")


def _leaf_names(tree):
    return [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _batch(seed=4, circuits=3, gates=40, layout="plain"):
    rng = np.random.default_rng(seed)
    graphs = [random_circuit(rng, "mig", num_inputs=6, num_gates=gates + 4 * i, num_tt_pairs=24)
              for i in range(circuits)]
    if layout == "fit":
        return collate_fit(graphs)
    if layout == "chunked":
        return collate_chunked(graphs, 2)
    if layout == "split":
        return collate_split(graphs, 2)
    return collate(graphs)


def _configs(**kw):
    kw = {**KW, **kw}
    return (J.DGConfig(**kw), J.DGConfig(**kw, compute_dtype="bfloat16"),
            P.DGConfig(**kw, compute_dtype="bfloat16"))


# ---- the kernels' plain versions --------------------------------------------

def _level_args(seed):
    """The 12 level_scan arguments of a small MIG batch, built by the JAX
    package in fp32, as numpy, with N, L and the real levels."""
    cfg = J.DGConfig(**KW)
    params, _ = J.init_params(jax.random.PRNGKey(seed), cfg)
    batch = jax.tree.map(jnp.asarray, _batch(seed))
    hs, _, _ = J.forward(params, batch, cfg)
    expert = cfg.expert_of_gate[batch["gate"]]
    pack, wkv_hf = J._level_statics(params, batch, cfg, hs, expert)
    nodes, ex = batch["lv_nodes"], params["experts"]
    args = (pack[batch["lv_edge_id"]], batch["lv_edge_src"], batch["lv_edge_dst_slot"],
            batch["lv_edge_valid"].astype(jnp.int32), nodes,
            (batch["lv_node_valid"] & (expert[nodes] >= 0)).astype(jnp.int32),
            jnp.maximum(expert[nodes], 0), wkv_hf, ex["w_ih"], ex["b_ih"], ex["b_hh"],
            ex["wa_k"])
    return [np.asarray(a) for a in args], hs.shape[0], int(np.asarray(batch["forward_level"]).max())


@pytest.mark.parametrize("seed", [6, 7])
def test_level_scan_bf16_plain_matches_pallas_interpret(seed):
    """``level_scan_reference`` / ``level_scan_bwd_reference`` on bf16 values
    against ``pallas_level_scan`` (kernels 1 and 2 in interpret mode) and
    its VJP on the same bf16 values and cotangent."""
    args, N, n_lv = _level_args(seed)
    T = args[11].shape[0]
    floats = level_kernel.FLOAT_ARGS
    j16 = [jnp.asarray(a, jnp.bfloat16) if i in floats else jnp.asarray(a)
           for i, a in enumerate(args)]
    t16 = [torch.tensor(a).to(BF16) if i in floats else torch.tensor(a)
           for i, a in enumerate(args)]
    tables = j16[1:7]

    def scan(pack, *w):
        pack = jnp.pad(pack, ((0, 0), (0, 0), (0, LANE - D - 2)))
        return pallas_level_scan(pack, *tables, *w, N, D, T, 1, True, "highest")

    hf_j, vjp = jax.vjp(scan, j16[0], *j16[7:])
    ghf = np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)
    grads_j = vjp(jnp.asarray(ghf, jnp.bfloat16))

    hf_p, res_e, res_n = level_kernel.level_scan_reference(*t16, num_nodes=N, num_levels=n_lv,
                                                           with_residuals=True)
    assert hf_p.dtype == res_e.dtype == res_n.dtype == BF16
    _values_close(hf_p, hf_j, VAL_ATOL, "hf")
    _ulps_close(hf_p, hf_j, "hf")
    grads_p = level_kernel.level_scan_bwd_reference(
        torch.tensor(ghf).to(BF16), res_e, res_n, *t16[:9], t16[10], t16[11], num_levels=n_lv)
    assert all(g.dtype == BF16 for g in grads_p)
    for name, p, j in zip(("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak"), grads_p,
                          grads_j):
        _ulps_close(p, j, name)

    # the wrapper on CPU tensors: in bf16 training goes through _LevelScan
    # with both plain versions, and gives what they give
    leaves = [t.clone().requires_grad_(i in floats) for i, t in enumerate(t16)]
    hf_w = level_kernel.level_scan(*leaves, num_nodes=N, num_levels=n_lv)
    assert torch.equal(hf_w.detach(), hf_p) and hf_w.grad_fn is not None
    hf_w.backward(torch.tensor(ghf).to(BF16))
    for i, g in zip(floats, grads_p):
        assert torch.equal(leaves[i].grad, g), i


def _struct_case(seed, layernorm):
    """struct_core's six float inputs in bf16 (from the port's fp32
    struct_inputs) and its tables, and the JAX package's table."""
    jcfg = J.DGConfig(**{**KW, "layernorm": layernorm})
    params, _ = J.init_params(jax.random.PRNGKey(seed), jcfg)
    hb = _batch(seed, circuits=4)
    pcfg = P.DGConfig(**{**KW, "layernorm": layernorm})
    pparams = params_from_jax(_np(params), device="cpu")
    b = P.batch_to_device(hb, "cpu")
    x = P.struct_input(b["gate"], pcfg)
    floats = [f.detach().to(BF16) for f in
              struct_kernel.struct_inputs(pparams["struct"], x, b, layernorm)]
    iv = lambda k: jnp.asarray(hb[k], jnp.int32)
    eb = max(hb["fa_src"].shape[1], hb["ra_src"].shape[1])
    pad = lambda a: jnp.pad(a, ((0, 0), (0, eb - a.shape[1])))
    tbl = jnp.stack([jnp.stack([pad(iv(f"{p}_src")), pad(iv(f"{p}_slot")),
                                pad(iv(f"{p}_valid")), pad(iv(f"{p}_valid"))], axis=-1)
                     for p in ("fa", "ra")])
    return floats, struct_kernel.struct_tables(b), tbl, int(hb["n_nodes"])


@pytest.mark.parametrize("layernorm", [True, False])
def test_struct_towers_bf16_plain_matches_pallas_interpret(layernorm):
    """``struct_towers_reference`` / ``struct_towers_bwd_reference`` on bf16
    values against ``pallas_struct_core`` (kernels 7 and 8 in interpret
    mode) and its VJP on the same bf16 values and cotangent."""
    floats, tables, tbl, n = _struct_case(11, layernorm)
    xi, wfold, w_hh, b_hh, ln_w, ln_b = (jnp.asarray(_f32(t), jnp.bfloat16) for t in floats)
    core = lambda *f: pallas_struct_core(*f, tbl, ROUNDS, layernorm, True, "highest")
    state_j, vjp = jax.vjp(core, xi, wfold, w_hh, b_hh[:, :, None, :], ln_w[:, None, :],
                           ln_b[:, None, :])
    assert state_j.dtype == jnp.bfloat16
    dstate = np.random.default_rng(12).normal(size=state_j.shape).astype(np.float32)
    dstate[:, n:] = 0.0
    grads_j = vjp(jnp.asarray(dstate, jnp.bfloat16))

    state_p, res = struct_kernel.struct_towers_reference(*floats, tables, ROUNDS, layernorm,
                                                         with_residuals=True)
    assert state_p.dtype == res.dtype == BF16
    _values_close(state_p[:, :n], state_j[:, :n], VAL_ATOL, "state")
    _ulps_close(state_p[:, :n], state_j[:, :n], "state")
    grads_p = struct_kernel.struct_towers_bwd_reference(
        torch.tensor(dstate).to(BF16), res, floats[1], floats[2], floats[4], tables, ROUNDS,
        layernorm)
    assert all(g.dtype == BF16 for g in grads_p)
    names = ("dxi", "dwfold", "dwhh", "dbhh", "dlnw", "dlnb")
    # dxi is summed in fp32 over the half-rounds and rounded once, as the JAX
    # kernel's fp32 dxi output (struct_kernel.py:381) and its VJP's cast do
    for name, p, j in zip(names, grads_p, grads_j):
        _ulps_close(p.reshape(-1), np.asarray(jnp.asarray(j, jnp.float32)).reshape(-1), name)
    # the kernel's order gives the same sweep
    inplace = struct_kernel.struct_towers_bwd_inplace(
        torch.tensor(dstate).to(BF16), res, floats[1], floats[2], floats[4], tables, ROUNDS,
        layernorm, split_rows=48)
    for name, a, c in zip(names, inplace, grads_p):
        _ulps_close(a, c, f"inplace {name}")


# ---- the whole model ----------------------------------------------------------

def _jax_forward(cfg, params, batch):
    return _strict(jax.jit(lambda p, b: J.forward(p, b, cfg, use_pallas=True,
                                                  pallas_interpret=True)), params, batch)


@pytest.mark.parametrize("layout", ["plain", "fit"])
def test_bf16_forward_matches_jax(layout):
    """hs and hf of the bf16 forward against the JAX package's bf16 kernel
    path and its fp32 forward, on a plain and a fit (C chunks) batch."""
    jcfg, jcfg16, pcfg16 = _configs()
    params, _ = J.init_params(jax.random.PRNGKey(1), jcfg)
    hb = _batch(5, circuits=4, layout=layout)
    batch = jax.tree.map(jnp.asarray, hb)
    hs16, hf16, _ = _jax_forward(jcfg16, params, batch)
    hs32, hf32, _ = J.forward(params, batch, jcfg)
    assert hs16.dtype == hf16.dtype == jnp.bfloat16
    pparams = params_from_jax(_np(params), device="cpu")
    hs, hf, aux = P.forward(pparams, hb, pcfg16)
    assert hs.dtype == hf.dtype == BF16 and aux == {}
    assert all(t.dtype == torch.float32 for t in PS.param_leaves(pparams))
    valid = np.asarray(hb["node_valid"])
    _values_close(hs[valid], np.asarray(hs16)[valid], VAL_ATOL, "hs vs JAX bf16")
    _values_close(hf[valid], np.asarray(hf16)[valid], VAL_ATOL, "hf vs JAX bf16")
    _ulps_close(hs[valid], np.asarray(hs16)[valid], "hs vs JAX bf16")
    _ulps_close(hf[valid], np.asarray(hf16)[valid], "hf vs JAX bf16")
    _values_close(hs[valid], np.asarray(hs32)[valid], F32_ATOL, "hs vs JAX fp32")
    _values_close(hf[valid], np.asarray(hf32)[valid], F32_ATOL, "hf vs JAX fp32")


def test_bf16_gradients_match_jax():
    """Gradients of a bf16 loss on hs and hf, through every kernel's plain
    version, against ``jax.grad`` of the same loss through the JAX
    package's bf16 kernels in interpret mode; the master params and their
    gradients fp32."""
    jcfg, jcfg16, pcfg16 = _configs()
    params, _ = J.init_params(jax.random.PRNGKey(2), jcfg)
    hb = _batch(8)
    batch = jax.tree.map(jnp.asarray, hb)
    n = hb["gate"].shape[0]
    tgt = np.random.default_rng(3).normal(size=(2, n, D)).astype(np.float32)
    m = np.asarray(hb["node_valid"])[:, None]

    def jloss(p):
        hs, hf, _ = J.forward(p, batch, jcfg16, use_pallas=True, pallas_interpret=True)
        return (jnp.sum(jnp.where(m, (hf.astype(jnp.float32) - tgt[0]) ** 2, 0.0))
                + jnp.sum(jnp.where(m, (hs.astype(jnp.float32) - tgt[1]) ** 2, 0.0)))

    g_j = jax.tree.leaves(_strict(jax.jit(jax.grad(jloss)), params))
    pparams = params_from_jax(_np(params), device="cpu")
    leaves = PS.param_leaves(pparams)
    for t in leaves:
        t.requires_grad_(True)
    hs, hf, _ = P.forward(pparams, hb, pcfg16)
    mt = torch.tensor(m)
    loss = (torch.where(mt, (hf.float() - torch.tensor(tgt[0])) ** 2, 0.0).sum()
            + torch.where(mt, (hs.float() - torch.tensor(tgt[1])) ** 2, 0.0).sum())
    loss.backward()
    g_p = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves]
    assert all(t.grad is None or t.grad.dtype == torch.float32 for t in leaves)
    _leaves_close(g_p, g_j, _leaf_names(params), "gradients")


def _kernel_path_step(monkeypatch):
    """The JAX train step through its Pallas kernels in interpret mode (its
    own gate picks them on a TPU only)."""
    monkeypatch.setattr(JS, "_auto_pallas", lambda batch, cfg: True)
    forward = J.forward
    monkeypatch.setattr(JS, "forward",
                        lambda *a, **k: forward(*a, **k, pallas_interpret=True))


def _strict(jitted, *args):
    """A jitted JAX function called with every bf16 rounding kept: by
    default XLA may compute bf16 intermediates in fp32 (excess precision)."""
    compiled = jitted.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def _jax_eps(key, n, dtype):
    """JAX's posterior noise of ``forward(..., rng=key)`` on a plain batch."""
    return tuple(torch.tensor(np.asarray(jax.random.normal(k, (n, D), dtype), np.float32))
                 for k in jax.random.split(key))


@pytest.mark.parametrize("variational", [False, True], ids=["dg_ae", "dg_vae"])
def test_bf16_adam_step_matches_jax(variational, monkeypatch):
    """One bf16 train step on fp32 master params against the JAX package's
    ``make_train_step`` with the same draws (DG_VAE's noise from JAX's key):
    the losses within the bf16 bounds, the master params and their
    gradients fp32, each gradient leaf against its own scale, and Adam's
    first step, lr * g / (|g| + eps), the same on every element whose two
    gradients are well apart from 0 (the signs agree)."""
    lr = 1e-3
    _kernel_path_step(monkeypatch)
    weights = [1.0, 4.0, 4.0, 1.0] if variational else WEIGHTS
    jcfg, jcfg16, pcfg16 = _configs(variational=variational)
    params, state = J.init_params(jax.random.PRNGKey(4), jcfg)
    hb = _batch(9)
    batch = jax.tree.map(jnp.asarray, hb)
    key = jax.random.PRNGKey(5)
    opt = JS.make_optimizer(lr)
    j_step, _ = JS.make_train_step(jcfg16, opt, mesh=None, donate=False)
    step_args = (params, state, opt.init(params), batch, key, jnp.asarray(weights))
    p1_j, _, _, m_j = _strict(j_step, *step_args)
    grad = jax.jit(jax.grad(lambda p: JS.loss_and_metrics(p, *step_args[1:2], *step_args[3:],
                                                          jcfg16, True)[0]))
    g_j = jax.tree.leaves(_strict(grad, params))

    k_vae, k_neg, k_drop = jax.random.split(key, 3)
    neg = tuple(torch.tensor(np.asarray(x)) for x in
                JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0], batch))
    n = hb["gate"].shape[0]
    keep = [torch.tensor(np.asarray(jax.random.bernoulli(k, 0.8, (n, pcfg16.dim_mlp))))
            for k in jax.random.split(k_drop, 2)]
    eps = _jax_eps(k_vae, n, jnp.bfloat16) if variational else None
    pp, ps = params_from_jax(_np(params), device="cpu"), state_from_jax(_np(state), device="cpu")
    optimizer = PS.make_optimizer(pp, lr)
    p_step, _ = PS.make_train_step(pcfg16, optimizer)
    _, m_p = p_step(pp, ps, hb, None, weights, neg_edges=neg, drop_keep=keep, vae_eps=eps)
    leaves = PS.param_leaves(pp)
    assert all(t.dtype == torch.float32 and t.grad.dtype == torch.float32 for t in leaves
               if t.grad is not None)
    for k in ("recon_loss", "prob_loss", "func_loss", "kl_loss", "loss"):
        got, want = float(m_p[k]), float(m_j[k])
        print(f"{k}: port {got:.6f} JAX {want:.6f}")
        assert abs(got - want) <= VAL_ATOL + VAL_RTOL * abs(want), k
    assert variational == (float(m_p["kl_loss"]) != 0.0)
    g_p = [np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy() for t in leaves]
    _leaves_close(g_p, g_j, _leaf_names(params), "step gradients")
    held = nonzero = 0
    for a, c, gp, gj in zip(_np_leaves(params_to_numpy(pp)), _np_leaves(p1_j), g_p, g_j):
        d, gj = np.abs(a - c), np.asarray(gj)
        assert d.max() <= 2 * lr + 1e-6    # opposite signs: the two updates, rounded
        # |g| past 4x the two gradients' difference (the signs agree) and past
        # Adam's eps region (eps / |g| <= 1e-3): the updates agree to 1e-3 * lr
        big = (np.abs(gj) > 4 * np.abs(gp - gj)) & (np.abs(gj) > 1e-5)
        assert (d[big] <= 1e-3 * lr).all()
        held, nonzero = held + int(big.sum()), nonzero + int((gj != 0).sum())
    print(f"Adam update held on {held} of the {nonzero} elements with a gradient")
    assert held >= nonzero // 2


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# ---- routing per dtype ----------------------------------------------------------

def _spy(monkeypatch):
    calls = {"level_scan": 0, "struct_core": 0}
    for mod, name in ((P, "level_scan"), (struct_kernel, "struct_core")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("layout, chunks", [("plain", 1), ("fit", None), ("split", 2)])
def test_bf16_routing_takes_the_fused_scan_and_struct_kernels(layout, chunks, monkeypatch):
    """A bf16 batch that fits (plain, every ``collate_fit`` chunk, every
    ``collate_split`` group) goes through ``level_scan`` (once per chunk or
    group) and ``struct_core`` (once per group), and its hf is bf16."""
    calls = _spy(monkeypatch)
    *_, pcfg16 = _configs()
    params, _ = P.init_params(pcfg16, seed=0, device="cpu")
    hb = _batch(10, circuits=4, layout=layout)
    hs, hf, _ = P.forward(params, hb, pcfg16)
    assert hs.dtype == hf.dtype == BF16
    if chunks is None:
        chunks = np.asarray(hb["lv_nodes"]).shape[0] if np.asarray(hb["lv_nodes"]).ndim == 3 else 1
    groups = len(hb["groups"]) if "groups" in hb else 1
    assert calls == {"level_scan": chunks, "struct_core": groups}, calls


@pytest.mark.parametrize("route", ["giant", "step"])
def test_bf16_giant_and_step_routes_raise(route, monkeypatch):
    """Routing per dtype past ``kernel_fits``: a plain batch goes through
    ``level_scan_giant``, a chunked one through ``level_scan_step``, once
    each and nothing else of the level recurrence, in bf16 as in fp32, and
    the bf16 forward's hf is bf16 (the name is from when bf16 raised on
    these routes)."""
    monkeypatch.setattr(P, "kernel_fits", lambda *a: False)
    name = "level_scan_giant" if route == "giant" else "level_scan_step"
    calls = []
    for other in ("level_scan_giant", "level_scan_step", "level_scan"):
        real = getattr(P, other)
        if other == name:
            monkeypatch.setattr(P, other, lambda *a, _real=real, **k: (calls.append(1),
                                                                       _real(*a, **k))[1])
        else:
            monkeypatch.setattr(P, other, lambda *a, **k: pytest.fail("another route ran"))
    hb = _batch(11, circuits=4, layout="plain" if route == "giant" else "chunked")
    *_, pcfg16 = _configs()
    for cfg, dtype in ((pcfg16, BF16), (P.DGConfig(**KW), torch.float32)):
        params, _ = P.init_params(cfg, seed=0, device="cpu")
        calls.clear()
        hs, hf, _ = P.forward(params, hb, cfg)
        assert hs.dtype == hf.dtype == dtype and len(calls) == 1, (dtype, calls)
        assert torch.isfinite(hf.float()).all() and hf.abs().max() > 0


def test_bf16_values_reaching_kernels_3_to_6_raise():
    """A mix of value types is refused by every route of the level
    recurrence and by the struct towers (the name is from when kernels 3 to
    6 refused bf16 values themselves; they take them now)."""
    args, N, n_lv = _level_args(6)
    t16 = [torch.tensor(a).to(BF16) if i in level_kernel.FLOAT_ARGS else torch.tensor(a)
           for i, a in enumerate(args)]
    mixed = list(t16)
    mixed[8] = mixed[8].float()
    with pytest.raises(ValueError, match="w_ih"):
        level_kernel.level_scan(*mixed, num_nodes=N, num_levels=n_lv)
    with pytest.raises(ValueError, match="w_ih"):
        level_kernel.level_scan_giant(*mixed, num_nodes=N, num_levels=n_lv)
    with pytest.raises(ValueError, match="w_ih"):
        level_kernel.level_scan_step(*mixed, n_levels=(n_lv,), n_sub=N)
    hf = torch.zeros((N, D), dtype=torch.float32)
    with pytest.raises(ValueError, match="hf"):
        level_kernel.level_step(hf, t16[0][0], *(t[0] for t in t16[1:4]), t16[5][0], t16[6][0],
                                *t16[7:])
    floats, tables, _, _ = _struct_case(11, True)
    floats[2] = floats[2].float()
    with pytest.raises(ValueError, match="w_hh"):
        struct_kernel.struct_core(*floats, tables, ROUNDS, True)
