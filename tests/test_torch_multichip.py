"""Data and model parallelism at four ranks, on the CPU over gloo, against the
JAX package on 4 of the 8 virtual CPU devices (``tests/conftest.py``).

One ``torchrun --standalone`` launch of four gloo ranks
(``tests/test_torch_dp.py``'s launcher; the worker script imports only torch
and the port, one CPU thread a rank) runs every multi-process case, and each
test reads its part of the ranks' results:

  * the dp = 4 SGD step (lr 0.1) against ``make_train_step(cfg, opt,
    mesh)`` on a 4-device dp mesh, rank d with the negatives and dropout
    masks JAX draws for shard d (``fold_in(rng, d)``): metrics rtol 1e-5 /
    atol 1e-6, params within 5e-6, BN state atol 1e-6;
  * ``make_multi_step(group=)`` / ``make_multi_eval(group=)`` at dp = 4
    and K = 2 against JAX's ``make_multi_step(mesh=)`` /
    ``make_multi_eval(mesh=)``, the draws patched to the same closed forms
    in both packages and the prob term left out of the train loss
    (``tests/test_torch_multistep_dp.py``'s reasons): metrics rtol 1e-5,
    params atol 1e-5 (the softmax-invariant leaves within K * lr), BN state
    atol 1e-6;
  * the sharded forward at mp = 4 and the sharded SGD step on the (1, 4)
    mesh, by both routes, against ``mgvae_tpu/parallel/sharded.py``'s
    ``make_sharded_forward`` / ``make_sharded_train_step`` (the kernel route
    against ``use_pallas=True, interpret=True``), at
    ``tests/test_torch_sharded.py``'s bounds.

And ``python -m mgvae_tpu_torch.examples.dryrun_multichip --device cpu
--nproc 4``, started as the module's first fixture so that it runs beside
the JAX side, must exit 0 with every phase's lines.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from mgvae_tpu.data import batching as jbatching
from mgvae_tpu.data.synthetic import random_circuit as j_random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.ops import mlp as jmlp
from mgvae_tpu.parallel.sharded import make_sharded_forward, make_sharded_train_step
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
from mgvae_tpu_torch.data import batching
from test_torch_dp import (DRAWS, GRAPHS, JAX_DRAWS, REPO, SOFTMAX_INVARIANT, WORKER_TIMEOUT,
                           _flat, _inputs, _jax_draws, _torchrun)
from test_torch_sharded import _jax_draws as _sharded_draws

torch.set_num_threads(1)
W = 4
CFG = dict(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
WEIGHTS = [1.0, 4.0, 2.0, 0.0]
SMOOTH = [1.0, 0.0, 4.0, 0.0]     # the K-step comparison: no prob term
SGD_LR, ADAM_LR = 0.1, 1e-3
K, BS = 2, 2
ROUTES = ("kernel", "edge")
DRYRUN_TIMEOUT = 300
DRYRUN_PHASES = "kabcdefg"

WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from mgvae_tpu_torch.data import batching
from mgvae_tpu_torch.data.synthetic import random_circuit
from mgvae_tpu_torch.models import dg_ae
from mgvae_tpu_torch.ops import mlp
from mgvae_tpu_torch.parallel import mesh, sharded
from mgvae_tpu_torch.train import losses
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.utils.params import params_from_jax, state_from_jax

inp, out = sys.argv[1:3]
rank, world = mesh.maybe_initialize_distributed("cpu", timeout=60)
z = dict(np.load(inp, allow_pickle=False))
cfg = dg_ae.DGConfig(**json.loads(str(z.pop("cfg"))))
K, BS = int(z["K"]), int(z["bs"])
weights, smooth = json.loads(str(z["weights"])), json.loads(str(z["smooth"]))
exec(str(z["graphs"]))
exec(str(z["draws"]))


def tree(prefix):
    t = {}
    for k, v in z.items():
        if k.startswith(prefix):
            node, parts = t, k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    def lists(n):
        if isinstance(n, dict):
            n = {k: lists(v) for k, v in n.items()}
            if n and all(k.isdigit() for k in n):
                return [n[str(i)] for i in range(len(n))]
        return n
    return lists(t)


def fresh():
    params = params_from_jax(tree("params/"), device="cpu")
    for t in PS.param_leaves(params):
        t.requires_grad_(True)
    return params, state_from_jax(tree("state/"), device="cpu")


res = {}


def put(prefix, params, state, metrics=None):
    res.update({f"{prefix}p{i}": t.detach().numpy()
                for i, t in enumerate(PS.param_leaves(params))})
    res.update({f"{prefix}s{i}": t.numpy() for i, t in enumerate(PS.param_leaves(state))})
    for k, v in (metrics or {}).items():
        res[f"{prefix}m/{k}"] = v.numpy()


def draws(tag, shard):
    return (tuple(torch.tensor(z[f"{tag}neg{shard}/{i}"]) for i in range(2)),
            [torch.tensor(z[f"{tag}keep{shard}/{i}"]) for i in range(2)])


# the dp = 4 SGD step, rank r on shard r with JAX's draws for it
params, state = fresh()
opt = torch.optim.SGD(PS.param_leaves(params), lr=float(z["sgd_lr"]))
step, _ = PS.make_train_step(cfg, opt, group=dist.group.WORLD)
neg, keep = draws("dp/", rank)
st, m = step(params, state, {k: v[rank] for k, v in tree("dpbatch/").items()}, None, weights,
             neg_edges=neg, drop_keep=keep)
put("dp/", params, st, m)

# the sharded forward at mp = 4 and the SGD step on the (1, 4) mesh, both routes
m14 = mesh.make_mesh(1, world)
hb = tree("shbatch/")
for route in ("kernel", "edge"):
    b = {k: v[0] for k, v in hb.items() if route == "kernel" or not k.startswith("mp_lv_")}
    params, state = fresh()
    with torch.no_grad():
        hs, hf = sharded.make_sharded_forward(cfg, m14.mp_group)(params, b)
    res[f"fwd/{route}/hs"], res[f"fwd/{route}/hf"] = hs.numpy(), hf.numpy()
    opt = torch.optim.SGD(PS.param_leaves(params), lr=float(z["sgd_lr"]))
    neg, keep = draws("sh/", 0)
    st, m = sharded.make_sharded_train_step(cfg, opt, m14)(params, state, b, None, weights,
                                                           neg_edges=neg, drop_keep=keep)
    put(f"sh/{route}/", params, st, m)

# the K-step calls at dp = 4, the draws patched to closed forms
losses.sample_negative_edges, mlp.dropout = negatives, dropout
every = graphs(random_circuit, K * world * BS)
shards = [every[j * BS:(j + 1) * BS] for j in range(K * world)]
mine = [shards[s * world + rank] for s in range(K)]
dl = [batching.natural_dims(s) for s in shards]
sb = batching.collate_shards(mine, dims={k: max(d[k] for d in dl) for k in dl[0]})
params, state = fresh()
opt = PS.make_optimizer(params, float(z["adam_lr"]))
state, rows = PS.make_multi_step(cfg, opt, group=dist.group.WORLD)(
    params, state, sb, torch.Generator().manual_seed(0), smooth)
res["ms/rows"] = rows.numpy()
put("ms/", params, state)
params, state = fresh()
res["me/rows"] = PS.make_multi_eval(cfg, group=dist.group.WORLD)(
    params, state, sb, torch.Generator().manual_seed(0), weights).numpy()
np.savez(f"{out}/{rank}.npz", **res)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """``dryrun_multichip --device cpu --nproc 4``, started at once; the test
    that reads it waits for it."""
    out = tmp_path_factory.mktemp("dryrun_multichip")
    cmd = [sys.executable, "-m", "mgvae_tpu_torch.examples.dryrun_multichip", "--device", "cpu",
           "--nproc", str(W), "--phases", DRYRUN_PHASES, "--out", str(out / "work"),
           "--timeout", str(DRYRUN_TIMEOUT - 30)]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen(cmd, env=env, cwd=str(out), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        yield p
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _shards(seed, n_shards, bs, gates):
    rng = np.random.default_rng(seed)
    return [[j_random_circuit(rng, "mig", num_inputs=8, num_gates=gates, num_tt_pairs=32)
             for _ in range(bs)] for _ in range(n_shards)]


def _common_dims(shards, mp=1):
    dl = [batching.natural_dims(s, mp=mp) for s in shards]
    return {k: max(d[k] for d in dl) for k in dl[0]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, dryrun):
    """The four ranks' results and the JAX side's."""
    tmp = tmp_path_factory.mktemp("multichip")
    jcfg = J.DGConfig(**CFG)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    inputs = _inputs(params, state, CFG, WEIGHTS)
    inputs.update(graphs=GRAPHS, draws=DRAWS, K=K, bs=BS, sgd_lr=SGD_LR, adam_lr=ADAM_LR,
                  smooth=json.dumps(SMOOTH))
    want = {}
    sgd = optax.sgd(SGD_LR)
    rng = jax.random.PRNGKey(9)

    # the dp = 4 step
    shards = _shards(20, W, 4, 40)
    hb = jbatching.collate_shards(shards, dims=_common_dims(shards))
    mesh_dp = Mesh(np.asarray(jax.devices()[:W]), ("dp",))
    step_j, _ = JS.make_train_step(jcfg, sgd, mesh_dp, donate=False)
    p_j, s_j, _, m_j = step_j(params, state, sgd.init(params), jax.tree.map(jnp.asarray, hb),
                              rng, jnp.asarray(WEIGHTS))
    want["dp"] = (p_j, s_j, m_j)
    inputs.update(_flat(hb, "dpbatch/", {}))
    for d in range(W):
        neg, keep, _ = _jax_draws(jax.random.fold_in(rng, d), {k: v[d] for k, v in hb.items()},
                                  jcfg)
        inputs.update({f"dp/neg{d}/{i}": x for i, x in enumerate(neg)})
        inputs.update({f"dp/keep{d}/{i}": x for i, x in enumerate(keep)})

    # the sharded forward and step at mp = 4 on one dp shard
    shards = _shards(30, 1, 6, 60)
    hb = batching.shard_levels_by_dst(
        batching.collate_shards(shards, mp=W, dims=_common_dims(shards, W)), W)
    batch_j = jax.tree.map(jnp.asarray, hb)
    one = {k: v[0] for k, v in batch_j.items()}
    mesh_mp = Mesh(np.asarray(jax.devices()[:W]), ("mp",))
    mesh_14 = Mesh(np.asarray(jax.devices()[:W]).reshape(1, W), ("dp", "mp"))
    for route, pallas in (("kernel", True), ("edge", False)):
        want[f"fwd/{route}"] = make_sharded_forward(jcfg, mesh_mp, one, use_pallas=pallas,
                                                    interpret=pallas)(params, one)
        step = make_sharded_train_step(jcfg, sgd, mesh_14, batch_j, donate=False,
                                       use_pallas=pallas, interpret=pallas)
        want[f"sh/{route}"] = step(params, state, sgd.init(params), batch_j, rng,
                                   jnp.asarray(WEIGHTS))
    want["n_sh"] = int(hb["n_nodes"][0])
    inputs.update(_flat(hb, "shbatch/", {}))
    neg, keep = _sharded_draws(jax.random.fold_in(rng, 0), {k: v[0] for k, v in hb.items()},
                               jcfg.dim_mlp)
    inputs.update({f"sh/neg0/{i}": x for i, x in enumerate(neg)})
    inputs.update({f"sh/keep0/{i}": x for i, x in enumerate(keep)})

    inp = tmp / "in.npz"
    np.savez(inp, **inputs)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    _torchrun([script, inp, tmp], W, WORKER_TIMEOUT)
    outs = [dict(np.load(tmp / f"{r}.npz")) for r in range(W)]

    # the K-step calls, JAX's on the [K, dp] stack with the closed-form draws
    scope = {"np": np, "jnp": jnp, "torch": torch}
    exec(GRAPHS + JAX_DRAWS, scope)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "sample_negative_edges", scope["negatives"])
        mp.setattr(jmlp, "dropout", scope["dropout"])
        every = scope["graphs"](j_random_circuit, K * W * BS)
        shards = [every[j * BS:(j + 1) * BS] for j in range(K * W)]
        hb = jbatching.collate_shards(shards, dims=_common_dims(shards))
        jsb = {k: jnp.asarray(v.reshape((K, W) + v.shape[1:])) for k, v in hb.items()}
        adam = JS.make_optimizer(ADAM_LR)
        rngs = jax.random.split(jax.random.PRNGKey(1), K)
        p_k, s_k, _, m_k = JS.make_multi_step(jcfg, adam, mesh=mesh_dp, donate=False)(
            params, state, adam.init(params), jsb, rngs, jnp.asarray(SMOOTH))
        e_k = JS.make_multi_eval(jcfg, mesh=mesh_dp)(params, state, jsb, rngs,
                                                     jnp.asarray(WEIGHTS))
    want["ms"] = (p_k, s_k, np.asarray(m_k))
    want["me"] = np.asarray(e_k)
    return outs, want


def _leaves(o, prefix):
    n = sum(1 for k in o if k.startswith(prefix) and k[len(prefix):].isdigit())
    return [o[f"{prefix}{i}"] for i in range(n)]


def _held_step(o, prefix, p_j, s_j, m_j, state_rtol):
    """An SGD step's metrics, params and BN state against JAX's."""
    for k, v in m_j.items():
        np.testing.assert_allclose(o[f"{prefix}m/{k}"], np.asarray(v), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{prefix} {k}")
    pj = [np.asarray(x) for x in jax.tree.leaves(p_j)]   # dict keys sorted, as param_leaves
    got = _leaves(o, prefix + "p")
    assert len(got) == len(pj)
    delta = max(float(np.abs(a - c).max()) for a, c in zip(got, pj))
    assert delta < 5e-6, (prefix, delta)
    sj = [np.asarray(x) for x in jax.tree.leaves(s_j)]
    got = _leaves(o, prefix + "s")
    assert len(got) == len(sj)
    for a, c in zip(got, sj):
        np.testing.assert_allclose(a, c, rtol=state_rtol, atol=1e-6, err_msg=prefix)


@pytest.mark.parametrize("rank", range(W))
def test_dp4_train_step_matches_jax_make_train_step_mesh(ranks, rank):
    """The dp = 4 SGD step on each of the four gloo ranks against JAX's
    ``make_train_step`` on a 4-device dp mesh."""
    outs, want = ranks
    _held_step(outs[rank], "dp/", *want["dp"], state_rtol=0)


@pytest.mark.parametrize("rank", range(W))
def test_dp4_multi_step_matches_jax_make_multi_step_mesh(ranks, rank):
    """``make_multi_step(group=)`` at K = 2 over four gloo ranks against JAX's
    ``make_multi_step(mesh=)`` on a 4-device dp mesh: metric rows, params and
    BN state on each rank."""
    outs, want = ranks
    o = outs[rank]
    p_k, s_k, rows = want["ms"]
    assert o["ms/rows"].shape == (K, 9)
    np.testing.assert_allclose(o["ms/rows"], rows, rtol=1e-5)
    paths = jax.tree_util.tree_leaves_with_path(p_k)
    got = _leaves(o, "ms/p")
    assert len(got) == len(paths)
    for g, (path, w) in zip(got, paths):
        name = jax.tree_util.keystr(path)
        atol = K * ADAM_LR if name in SOFTMAX_INVARIANT else 1e-5
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol, err_msg=name)
    want_s = jax.tree.leaves(s_k)
    got_s = _leaves(o, "ms/s")
    assert len(got_s) == len(want_s)
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rank", range(W))
def test_dp4_multi_eval_matches_jax_make_multi_eval_mesh(ranks, rank):
    """``make_multi_eval(group=)`` over four gloo ranks against JAX's
    ``make_multi_eval(mesh=)``."""
    outs, want = ranks
    assert outs[rank]["me/rows"].shape == (K, 9)
    np.testing.assert_allclose(outs[rank]["me/rows"], want["me"], rtol=1e-5)


@pytest.mark.parametrize("route", ROUTES)
def test_sharded_forward_at_mp4_matches_jax(ranks, route):
    """Both routes over four gloo processes against JAX's
    ``make_sharded_forward`` on a 4-device mp mesh (the kernel route against
    the Pallas level step in interpret mode): hs and hf whole and equal on
    every member."""
    outs, want = ranks
    hs_j, hf_j = (np.asarray(x) for x in want[f"fwd/{route}"])
    n = want["n_sh"]
    for o in outs:
        np.testing.assert_allclose(o[f"fwd/{route}/hs"][:n], hs_j[:n], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(o[f"fwd/{route}/hf"][:n], hf_j[:n], rtol=0, atol=1e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_sharded_train_step_on_a_1x4_mesh_matches_jax(ranks, route):
    """One SGD step on the (1, 4) mesh by both routes, on every rank, against
    JAX's ``make_sharded_train_step`` on the same mesh of the virtual
    devices: metrics, params and BN state (rtol 1e-4 / atol 1e-6, as
    ``tests/test_torch_sharded.py`` holds them)."""
    outs, want = ranks
    p_j, s_j, _, m_j = want[f"sh/{route}"]
    for o in outs:
        _held_step(o, f"sh/{route}/", p_j, s_j, m_j, state_rtol=1e-4)


def test_dryrun_multichip_on_four_gloo_ranks(dryrun):
    """The four-card dry run over four gloo ranks on the CPU exits 0, every
    phase printing its lines, each held on all four ranks."""
    try:
        text, _ = dryrun.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        dryrun.kill()
        text, _ = dryrun.communicate()
        pytest.fail(f"the dry run ran past {DRYRUN_TIMEOUT} s:\n{text[-6000:]}")
    assert dryrun.returncode == 0, text[-6000:]
    lines = [ln for ln in text.splitlines() if ln.startswith("[multichip]")]
    assert f"[multichip] {W} rank(s) exited 0" in "\n".join(lines)
    assert "[multichip] (-) every phase held" in lines
    for ph in DRYRUN_PHASES:
        mine = [ln for ln in lines if ln.startswith(f"[multichip] ({ph})")]
        assert any(ln.endswith(" s") and " took " in ln for ln in mine), ph
        if ph != "k":    # (k) holds the kernels: none on the CPU
            assert any(ln.endswith("held on ranks [True, True, True, True]") for ln in mine), ph
    assert not any("held on ranks" in ln and "False" in ln for ln in lines)
