"""The port's struct towers (mgvae_tpu_torch.ops.struct_kernel) against the
JAX package: the fused tower kernel ``struct_towers_pallas`` in interpret
mode and the XLA towers ``direct_multigcn_apply``, forward and every encoder
parameter's gradient; the written-out backward against autograd; the
backward in the CUDA kernel's order (``struct_towers_bwd_inplace``) against
the written-out one and against the JAX package's ``pallas_struct_core`` VJP
in interpret mode (each output within 1e-5 * max(scale, 1)); the whole
forward against ``forward(use_pallas=True, pallas_interpret=True)``.
Tolerances are the JAX package's own (tests/test_struct_kernel.py): s and t
rtol 1e-4 / atol 1e-5 on valid rows, gradients 1e-5 relative to each leaf's
largest entry; hs rtol 1e-4 / atol 1e-5, hf atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgvae_tpu.data.batching import collate
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.models import encoder as jencoder
from mgvae_tpu.ops.pallas.struct_kernel import pallas_struct_core, struct_towers_pallas
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.models import encoder
from mgvae_tpu_torch.ops import struct_kernel
from mgvae_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(1)
DIM, ROUNDS = 32, 2


def _setup(layernorm, modality="mig", seed=0, circuits=3, gates=44):
    """JAX params and host batch (3 circuits of 44 gates by default), and the
    port's params, device batch and x_feat made from them."""
    kw = dict(modality=modality, dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
              layernorm=layernorm)
    jcfg, pcfg = J.DGConfig(**kw), P.DGConfig(**kw)
    params, _ = J.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 1)
    hb = collate([random_circuit(rng, modality, num_inputs=5, num_gates=gates)
                  for _ in range(circuits)])
    pparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    b = P.batch_to_device(hb, "cpu")
    return jcfg, pcfg, params, hb, pparams, b, P.struct_input(b["gate"], pcfg)


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.mark.parametrize("layernorm", [True, False])
def test_struct_towers_match_pallas_interpret_and_xla(layernorm):
    jcfg, _, params, hb, pparams, b, x = _setup(layernorm)
    batch = jax.tree.map(jnp.asarray, hb)
    jx = jnp.asarray(x.numpy())
    n = int(hb["n_nodes"])
    enc = params["struct"]
    w = np.random.default_rng(3).normal(size=(hb["gate"].shape[0], DIM)).astype(np.float32)
    w[n:] = 0.0    # the cotangent is zero on padding rows

    struct_kernel.launches = 0
    leaves = _flat(pparams["struct"])
    for t in leaves.values():
        t.requires_grad_(True)
    s_p, t_p = struct_kernel.struct_towers(pparams["struct"], x, b, ROUNDS, layernorm)
    assert struct_kernel.launches == 0          # CPU tensors: the plain version
    wt = torch.tensor(w)
    (s_p * wt).sum().add((t_p * wt).sum() * 0.5).backward()
    g_p = {k: t.grad.numpy() for k, t in leaves.items()}

    def loss(fn):
        def f(e):
            s, t = fn(e)
            return jnp.sum(s * w) + 0.5 * jnp.sum(t * w)
        return f

    towers = {
        "pallas": lambda e: struct_towers_pallas(e, jx, batch, ROUNDS, layernorm, interpret=True,
                                                 precision="highest"),
        "xla": lambda e: jencoder.direct_multigcn_apply(e, jx, batch, ROUNDS, ROUNDS, layernorm),
    }
    for name, fn in towers.items():
        s_j, t_j = jax.jit(fn)(enc)
        np.testing.assert_allclose(s_p.detach().numpy()[:n], np.asarray(s_j)[:n], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(t_p.detach().numpy()[:n], np.asarray(t_j)[:n], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        g_j = _flat(jax.tree.map(np.asarray, jax.jit(jax.grad(loss(fn)))(enc)))
        assert g_j.keys() == g_p.keys()
        rel = {k: _rel(g_p[k], g_j[k]) for k in g_j}
        assert max(rel.values()) <= 1e-5, (name, rel)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("layernorm", [True, False])
def test_bwd_reference_matches_autograd(layernorm):
    _, _, _, _, pparams, b, x = _setup(layernorm, modality="xmg", seed=4)
    args = [a.detach().requires_grad_(True)
            for a in struct_kernel.struct_inputs(pparams["struct"], x, b, layernorm)]
    tables = struct_kernel.struct_tables(b)
    state, res = struct_kernel.struct_towers_reference(*args, tables, ROUNDS, layernorm,
                                                       with_residuals=True)
    assert res.shape == (2 * ROUNDS, 2, x.shape[0], 7 * DIM) and not res.requires_grad
    dstate = torch.tensor(np.random.default_rng(5).normal(size=state.shape).astype(np.float32))
    auto = torch.autograd.grad(state, args, dstate, allow_unused=True)
    manual = struct_kernel.struct_towers_bwd_reference(dstate, res, args[1], args[2], args[4],
                                                       tables, ROUNDS, layernorm)
    for i, (a, m) in enumerate(zip(auto, manual)):
        if a is None:   # ln_w / ln_b without LayerNorm: constants
            assert not layernorm and i >= 4 and (m == 0).all()
            continue
        assert a.shape == m.shape
        assert float((a - m).abs().max()) <= 1e-5 * float(a.abs().max()), i


def _bwd_case(dim, layernorm, seed):
    """(dstate, res, wfold, w_hh, ln_w, tables) and the six float inputs of a
    4-circuit batch (N = 256) at width ``dim``, the cotangent from numpy."""
    kw = dict(modality="mig", dim_hidden=dim, s_rounds=ROUNDS, t_rounds=ROUNDS,
              layernorm=layernorm)
    params, _ = J.init_params(jax.random.PRNGKey(seed), J.DGConfig(**kw))
    rng = np.random.default_rng(seed + 1)
    hb = collate([random_circuit(rng, "mig", num_inputs=5, num_gates=40) for _ in range(4)])
    pparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    b = P.batch_to_device(hb, "cpu")
    x = P.struct_input(b["gate"], P.DGConfig(**kw))
    floats = struct_kernel.struct_inputs(pparams["struct"], x, b, layernorm)
    tables = struct_kernel.struct_tables(b)
    state, res = struct_kernel.struct_towers_reference(*floats, tables, ROUNDS, layernorm,
                                                       with_residuals=True)
    dstate = torch.tensor(rng.normal(size=state.shape).astype(np.float32))
    return (dstate, res, floats[1], floats[2], floats[4], tables), floats, hb


def _held(got, want, what):
    """Each of the six outputs within 1e-5 * max(scale, 1)."""
    for name, g, w in zip(("dxi", "dwfold", "dwhh", "dbhh", "dlnw", "dlnb"), got, want):
        g, w = np.asarray(g, np.float32).reshape(-1), np.asarray(w, np.float32).reshape(-1)
        err = float(np.abs(g - w).max())
        assert err <= 1e-5 * max(float(np.abs(w).max()), 1.0), (what, name, err)


@pytest.mark.parametrize("split_rows", [48, struct_kernel.SPLIT_ROWS])
@pytest.mark.parametrize("layernorm", [True, False])
@pytest.mark.parametrize("dim", [32, 64])
def test_bwd_inplace_matches_bwd_reference(dim, layernorm, split_rows):
    """The kernel's order (one half-round of scratch, split partials
    accumulated in place) against the written-out sweep. N = 256: 48-row
    splits leave a ragged last split of 16 rows, SPLIT_ROWS one short split."""
    args, _, _ = _bwd_case(dim, layernorm, seed=10 + dim)
    assert args[0].shape[1] % split_rows
    got = struct_kernel.struct_towers_bwd_inplace(*args, ROUNDS, layernorm, split_rows=split_rows)
    want = struct_kernel.struct_towers_bwd_reference(*args, ROUNDS, layernorm)
    _held(got, want, "reference")
    if not layernorm:
        assert (got[4] == 0).all() and (got[5] == 0).all()


def test_partial_rows_give_the_partial_launch_enough_splits():
    rows = struct_kernel.partial_rows
    assert rows(256) == 128 and rows(5120) == 128          # tiny and bs16 batches
    assert rows(10240) == 256 and rows(20480) == 512       # bs64 chunk, plain bs64
    assert rows(114_688) == struct_kernel.SPLIT_ROWS       # the giant batch: 224 splits
    assert all(rows(n) % struct_kernel.WARP_ROWS == 0 for n in (1, 128, 5120, 10**6))


@pytest.mark.parametrize("layernorm", [True, False])
@pytest.mark.parametrize("dim", [32, 64])
def test_bwd_inplace_matches_pallas_vjp(dim, layernorm):
    """Against the JAX package's custom VJP ``pallas_struct_core`` with its
    backward kernel in interpret mode, on the same inputs and cotangent."""
    args, floats, hb = _bwd_case(dim, layernorm, seed=20 + dim)
    got = struct_kernel.struct_towers_bwd_inplace(*args, ROUNDS, layernorm, split_rows=48)
    xi, wfold, w_hh, b_hh, ln_w, ln_b = (jnp.asarray(t.numpy()) for t in floats)
    iv = lambda k: jnp.asarray(hb[k], jnp.int32)
    eb = max(hb["fa_src"].shape[1], hb["ra_src"].shape[1])
    pad = lambda a: jnp.pad(a, ((0, 0), (0, eb - a.shape[1])))
    tbl = jnp.stack([jnp.stack([pad(iv(f"{p}_src")), pad(iv(f"{p}_slot")), pad(iv(f"{p}_valid")),
                                pad(iv(f"{p}_valid"))], axis=-1) for p in ("fa", "ra")])
    core = lambda *f: pallas_struct_core(*f, tbl, ROUNDS, layernorm, True, "highest")
    _, vjp = jax.vjp(core, xi, wfold, w_hh, b_hh[:, :, None, :], ln_w[:, None, :],
                     ln_b[:, None, :])
    want = vjp(jnp.asarray(args[0].numpy()))
    _held(got, want, "pallas_struct_core")


@pytest.mark.parametrize("modality", ["aig", "mig", "xag", "xmg"])
def test_forward_matches_jax_use_pallas(modality):
    jcfg, pcfg, params, hb, pparams, _, _ = _setup(True, modality=modality, seed=6, circuits=2,
                                                   gates=24)
    fwd = jax.jit(lambda p, b: J.forward(p, b, jcfg, use_pallas=True, pallas_interpret=True)[:2])
    hs_j, hf_j = fwd(params, jax.tree.map(jnp.asarray, hb))
    hs_p, hf_p, _ = P.forward(pparams, hb, pcfg)
    n = int(hb["n_nodes"])
    np.testing.assert_allclose(hs_p.numpy()[:n], np.asarray(hs_j)[:n], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hf_p.numpy()[:n], np.asarray(hf_j)[:n], rtol=0, atol=1e-4)


def test_unequal_rounds_take_eager_towers(monkeypatch):
    _, _, params, hb, pparams, b, x = _setup(True, modality="xag", seed=7)
    calls = []
    real = encoder.struct_towers
    monkeypatch.setattr(encoder, "struct_towers", lambda *a: calls.append(a[3]) or real(*a))
    for rounds in ((2, 3), (2, 2)):
        s_p, t_p = encoder.direct_multigcn_apply(pparams["struct"], x, b, *rounds, True)
        s_j, t_j = jencoder.direct_multigcn_apply(
            params["struct"], jnp.asarray(x.numpy()), jax.tree.map(jnp.asarray, hb), *rounds,
            True)
        n = int(hb["n_nodes"])
        np.testing.assert_allclose(s_p.numpy()[:n], np.asarray(s_j)[:n], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t_p.numpy()[:n], np.asarray(t_j)[:n], rtol=1e-4, atol=1e-5)
    assert calls == [2]       # only s_rounds == t_rounds takes the kernel route


def test_tables_list_each_nodes_edges():
    """Node v's forward list holds the sources of its in-edges and its
    reverse list the destinations of its out-edges, in edge order, for a
    batch and for an edge-less graph."""
    rng = np.random.default_rng(8)
    graphs = [random_circuit(rng, "aig", num_inputs=4, num_gates=30) for _ in range(3)]
    from mgvae_tpu_torch import build_graph

    for hb in (collate(graphs), collate([build_graph("pi", np.zeros(3, np.int32),
                                                     np.zeros((2, 0), np.int64))])):
        src, start, count = struct_kernel.struct_tables(P.batch_to_device(hb, "cpu"))
        e = int(hb["n_edges"])
        es, ed = hb["edge_src"][:e], hb["edge_dst"][:e]
        for v in range(hb["gate"].shape[0]):
            for d, (by, other) in enumerate(((ed, es), (es, ed))):
                got = src[d, start[d, v] : start[d, v] + count[d, v]].numpy()
                np.testing.assert_array_equal(got, other[by == v])
        assert int(count.sum()) == 2 * e


def test_core_checks_its_arguments():
    _, _, _, _, pparams, b, x = _setup(False, seed=9)
    args = list(struct_kernel.struct_inputs(pparams["struct"], x, b, False))
    tables = struct_kernel.struct_tables(b)
    ref = struct_kernel.struct_towers_reference(*args, tables, ROUNDS, False)
    assert torch.equal(struct_kernel.struct_core(*args, tables, ROUNDS, False), ref)
    bad = [(1, args[1].double()), (2, args[2].transpose(2, 3).contiguous()),
           (0, args[0][:, :, :-1]), (3, args[3].mT.contiguous().mT)]
    for i, t in bad:
        a = list(args)
        a[i] = t
        with pytest.raises(ValueError, match="struct_towers"):
            struct_kernel.struct_core(*a, tables, ROUNDS, False)
    with pytest.raises(ValueError, match="int32"):
        struct_kernel.struct_core(*args, (tables[0].long(), *tables[1:]), ROUNDS, False)
    with pytest.raises(ValueError, match="num_rounds"):
        struct_kernel.struct_core(*args, tables, 0, False)


@pytest.mark.parametrize("dim", [1, 31, 32, 33, 64, 96, 100, 128])
def test_forward_layout_fits_the_card(dim):
    """The forward kernel's block at every width: its shared memory within
    a block's 227 KB, at least two blocks an SM (228 KB, 1 KB reserved per
    block), three at D <= 64; chunks that tile the padded width."""
    lay = struct_kernel.forward_layout(5120, dim)
    smem = lay["smem_bytes"]
    assert smem <= 232_448                # a block's dynamic shared memory on the H100
    per_sm = (228 * 1024) // (smem + 1024)
    assert per_sm >= (3 if dim <= 64 else 2), (dim, smem, per_sm)
    assert 32 % lay["chunk_rows"] == 0 and lay["threads"] == 32 * struct_kernel.FWD_WARPS
    assert lay["rows_per_warp"] == struct_kernel.FWD_ROWS


@pytest.mark.parametrize("n,blocks", [(1, 1), (31, 1), (32, 1), (33, 2), (5120, 160),
                                      (5121, 161), (114_688, 3584)])
def test_forward_layout_grid_covers_the_rows(n, blocks):
    """One block per 32 rows of each tower: bs16 (N = 5120) gives 320 blocks,
    the giant batch (N = 114,688) 7168; a ragged N gets one more block."""
    lay = struct_kernel.forward_layout(n, 64)
    assert lay["grid"] == (blocks, 2)
    tile = lay["rows_per_warp"] * lay["threads"] // 32
    assert (blocks - 1) * tile < n <= blocks * tile


def test_forward_layout_refuses_wide_rows():
    with pytest.raises(ValueError, match="D <= 128"):
        struct_kernel.forward_layout(64, 129)
