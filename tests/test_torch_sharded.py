"""Within-level model parallelism of the port (mgvae_tpu_torch.parallel.sharded)
against the single-device forward and the JAX package's sharded forward
and train step. The route follows the batch (``sharded.route_of``): a batch
with ``shard_levels_by_dst`` tables takes the dst-complete kernel route, the
same batch without them the edge-split route.

In one process, at mp = 1 (a gloo group of one): both routes' forward
equals ``dg_ae.forward``, and the sharded train step's gradients equal the
single-device step's. In gloo processes (``torchrun --standalone``; each
worker script is written to ``tmp_path`` and imports only torch and the
port): the edge-split and dst-complete forwards at mp = 2 equal JAX's
``make_sharded_forward`` (the kernel route against ``use_pallas=True,
interpret=True``) on the virtual CPU mesh, and a dp = 2 x mp = 2 SGD step
in 4 processes equals JAX's ``make_sharded_train_step`` on the same route,
with the negatives and dropout masks JAX draws for each dp shard
(``fold_in(rng, d)``) handed to the port's ranks.

Tolerances are the JAX package's own (``tests/test_sharded.py``): hs rtol
1e-4 / atol 1e-5 and hf atol 1e-4; metrics rtol 1e-5 / atol 1e-6, params
after one SGD step (lr 0.1) within 5e-6, BN running state atol 1e-6.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from mgvae_tpu.data import batching as jbatching
from mgvae_tpu.data.synthetic import random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.parallel.sharded import make_sharded_forward, make_sharded_train_step
from mgvae_tpu.train import losses as JL
from mgvae_tpu_torch.data import batching
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.parallel import mesh, sharded
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.utils.params import params_from_jax
from test_torch_dp import _torchrun

torch.set_num_threads(1)
KW = dict(modality="mig", dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=True)
WEIGHTS = [1.0, 4.0, 2.0, 0.0]
LR = 0.1
WORKER_TIMEOUT = 150

# One worker for every multi-process case: argv = mode, the input .npz, the
# output directory. Inputs hold the JAX params (flattened, "/"-joined keys),
# the batch and the draws; each rank writes its results to <out>/<rank>.npz.
WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from mgvae_tpu_torch.models import dg_ae
from mgvae_tpu_torch.parallel import mesh, sharded
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax

mode, inp, out = sys.argv[1:4]
routes = lambda b: (("kernel", b), ("edge", {k: v for k, v in b.items()
                                            if not k.startswith("mp_lv_")}))
rank, world = mesh.maybe_initialize_distributed("cpu", timeout=60)
z = dict(np.load(inp, allow_pickle=False))
cfg = dg_ae.DGConfig(**json.loads(str(z.pop("cfg"))))

def tree(prefix):
    t = {}
    for k, v in z.items():
        if not k.startswith(prefix):
            continue
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

def flat(t, prefix, acc):
    if isinstance(t, dict):
        for k, v in t.items():
            flat(v, f"{prefix}{k}/", acc)
    elif isinstance(t, list):
        for i, v in enumerate(t):
            flat(v, f"{prefix}{i}/", acc)
    else:
        acc[prefix[:-1]] = t
    return acc

batch = tree("batch/")
res = {}
if mode == "forward":
    params = params_from_jax(tree("params/"), device="cpu")
    for route, b in routes(batch):
        hs, hf = sharded.make_sharded_forward(cfg, dist.group.WORLD)(params, b)
        res[f"{route}/hs"], res[f"{route}/hf"] = hs.numpy(), hf.numpy()
else:
    dp, mp = (int(x) for x in z.pop("mesh"))
    m = mesh.make_mesh(dp, mp)
    shard = {k: v[m.dp_rank] for k, v in batch.items()}
    neg = tuple(torch.tensor(z[f"neg{m.dp_rank}/{i}"]) for i in range(2))
    keep = [torch.tensor(z[f"keep{m.dp_rank}/{i}"]) for i in range(2)]
    for route, b in routes(shard):
        params = params_from_jax(tree("params/"), device="cpu")
        state = state_from_jax(tree("state/"), device="cpu")
        leaves = PS.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        step = sharded.make_sharded_train_step(cfg, torch.optim.SGD(leaves, lr=0.1), m)
        st, metrics = step(params, state, b, None, json.loads(str(z["weights"])),
                           neg_edges=neg, drop_keep=keep)
        flat(params_to_numpy(params), f"{route}/params/", res)
        flat(params_to_numpy(st), f"{route}/state/", res)
        for k, v in metrics.items():
            res[f"{route}/metrics/{k}"] = v.numpy()
np.savez(f"{out}/{rank}.npz", **res)
dist.destroy_process_group()
'''


def _flat(tree, prefix, acc):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}{k}/", acc)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}{i}/", acc)
    else:
        acc[prefix[:-1]] = np.asarray(tree)
    return acc


def _graphs(seed, n_graphs=8, num_gates=120):
    rng = np.random.default_rng(seed)
    return [random_circuit(rng, "mig", num_inputs=16, num_gates=num_gates)
            for _ in range(n_graphs)]


def _dims(shards, mp):
    """The common padded dims of the shards at model-parallel degree mp."""
    dl = [batching.natural_dims(s, mp=mp) for s in shards]
    return {k: max(d[k] for d in dl) for k in dl[0]}


def _run(tmp_path, mode, nprocs, inputs):
    tmp_path.mkdir(parents=True, exist_ok=True)
    inp = tmp_path / f"{mode}.npz"
    np.savez(inp, **inputs)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    _torchrun([script, mode, inp, tmp_path], nprocs, WORKER_TIMEOUT)
    return [dict(np.load(tmp_path / f"{r}.npz")) for r in range(nprocs)]


def _edge_only(batch):
    """The batch without its dst-complete tables: the edge-split route's."""
    return {k: v for k, v in batch.items() if not k.startswith("mp_lv_")}


@pytest.fixture(scope="module")
def group_of_one(tmp_path_factory):
    """A gloo process group of one rank in this process, for mp = 1."""
    store = tmp_path_factory.mktemp("group_of_one") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("route", ["kernel", "edge"])
def test_sharded_forward_at_mp1_matches_forward(route, group_of_one):
    cfg = P.DGConfig(**KW)
    params, _ = P.init_params(cfg, seed=3, device="cpu")
    batch = batching.shard_levels_by_dst(batching.collate(_graphs(0)), 1)
    if route == "edge":
        batch = _edge_only(batch)
    assert sharded.route_of(batch, cfg, 1) == route
    hs0, hf0, _ = P.forward(params, batch, cfg)
    hs1, hf1 = sharded.make_sharded_forward(cfg, group_of_one)(params, batch)
    n = int(batch["n_nodes"])
    np.testing.assert_allclose(hs1[:n].numpy(), hs0[:n].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hf1[:n].numpy(), hf0[:n].numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("route, dim", [("kernel", 32), ("edge", 32), ("edge", 256)],
                         ids=["kernel", "edge", "edge_past_the_kernels"])
def test_sharded_train_step_at_mp1_matches_single_device_step(route, dim, group_of_one):
    """One SGD step on a (1, 1) mesh: gradients, metrics and BN state equal
    the single-device step's with the same generator. At D = 256 the batch
    keeps its dst-complete tables and the edge-split route takes it."""
    cfg = P.DGConfig(**dict(KW, dim_hidden=dim))
    batch = batching.shard_levels_by_dst(batching.collate(_graphs(1)), 1)
    if route == "edge" and dim <= 128:
        batch = _edge_only(batch)
    assert sharded.route_of(batch, cfg, 1) == route
    m = mesh.make_mesh(1, 1)
    out = []
    for kind in ("single", "sharded"):
        params, state = P.init_params(cfg, seed=3, device="cpu")
        leaves = PS.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        opt = torch.optim.SGD(leaves, lr=LR)
        step = (PS.make_train_step(cfg, opt)[0] if kind == "single"
                else sharded.make_sharded_train_step(cfg, opt, m))
        st, metrics = step(params, state, batch, torch.Generator().manual_seed(5), WEIGHTS)
        out.append(([t.grad for t in leaves], st, metrics))
    (g0, s0, m0), (g1, s1, m1) = out
    scale = max(float(g.abs().max()) for g in g0 if g is not None)
    for a, c in zip(g1, g0):
        assert (a is None) == (c is None)
        if c is not None:
            assert float((a - c).abs().max()) <= 1e-5 * scale
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    for a, c in zip(PS.param_leaves(s1), PS.param_leaves(s0)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=1e-6)


def test_sharded_rejects_what_it_does_not_take(group_of_one):
    with pytest.raises(ValueError, match="num_rounds"):
        sharded.make_sharded_forward(P.DGConfig(**KW, num_rounds=2), None)
    batch = batching.collate(_graphs(2, n_graphs=2))
    with pytest.raises(ValueError, match=r"mp = 1, the group has 2: shard_levels_by_dst"):
        sharded.route_of(batching.shard_levels_by_dst(batch, 1), P.DGConfig(**KW), 2)
    with pytest.raises(ValueError, match="shard_levels_by_dst"):
        sharded.member_slices(batch, 0, 1, "kernel")
    with pytest.raises(ValueError, match="mp=2"):
        sharded.member_slices(batching.collate(_graphs(2, n_graphs=1, num_gates=40)), 0, 2,
                              "edge")
    with pytest.raises(ValueError, match="needs 2 processes"):
        mesh.make_mesh(2, 1)


@pytest.mark.parametrize("dim, tables, want", [
    (32, True, "kernel"), (32, False, "edge"), (128, True, "kernel"), (256, True, "edge"),
], ids=["tables", "no_tables", "widest_kernel", "past_the_kernels"])
def test_route_follows_the_batch_and_the_width(dim, tables, want):
    """The dst-complete route needs the batch's tables and D <= MAX_DIM (the
    kernels' width, 128); past it the edge-split route takes the batch, as
    the single-device forward leaves the kernels there."""
    batch = batching.collate(_graphs(2, n_graphs=2))
    if tables:
        batch = batching.shard_levels_by_dst(batch, 1)
    assert sharded.route_of(batch, P.DGConfig(**dict(KW, dim_hidden=dim)), 1) == want


def test_sharded_forwards_at_mp2_match_jax(tmp_path):
    """Both routes over 2 gloo processes == JAX's make_sharded_forward on a
    2-device mp mesh (the kernel route against the Pallas level step in
    interpret mode); hs and hf are whole and equal on both members."""
    _forwards_at_mp2_match_jax(tmp_path, KW)


def _forwards_at_mp2_match_jax(tmp_path, kw):
    mp = 2
    graphs = _graphs(4, n_graphs=16)
    hb = batching.shard_levels_by_dst(batching.collate(graphs, mp=mp), mp)
    jcfg = J.DGConfig(**kw)
    params, _ = J.init_params(jax.random.PRNGKey(0), jcfg)
    mesh_j = Mesh(np.asarray(jax.devices()[:mp]), ("mp",))
    batch_j = jax.tree.map(jnp.asarray, hb)
    want = {
        "kernel": make_sharded_forward(jcfg, mesh_j, batch_j, use_pallas=True,
                                       interpret=True)(params, batch_j),
        "edge": make_sharded_forward(jcfg, mesh_j, batch_j)(params, batch_j),
    }
    inputs = _flat(jax.tree.map(np.asarray, params), "params/", {})
    inputs.update(_flat(hb, "batch/", {}), cfg=json.dumps(kw))
    outs = _run(tmp_path, "forward", mp, inputs)
    n = int(hb["n_nodes"])
    for route, (hs_j, hf_j) in want.items():
        for o in outs:
            np.testing.assert_allclose(o[f"{route}/hs"][:n], np.asarray(hs_j)[:n], rtol=1e-4,
                                       atol=1e-5, err_msg=route)
            np.testing.assert_allclose(o[f"{route}/hf"][:n], np.asarray(hf_j)[:n], rtol=0,
                                       atol=1e-4, err_msg=route)
    return outs


def _jax_draws(key, hb, dim_mlp):
    """The negatives and dropout keep masks JAX's sharded step draws from
    its dp-folded key on one shard (``mgvae_tpu/parallel/sharded.py:355-372``)."""
    _, k_neg, k_drop = jax.random.split(key, 3)
    batch = jax.tree.map(jnp.asarray, hb)
    neg = JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0], batch)
    n = hb["gate"].shape[0]
    keep = [jax.random.bernoulli(k, 0.8, (n, dim_mlp)) for k in jax.random.split(k_drop, 2)]
    return [np.asarray(x) for x in neg], [np.asarray(k) for k in keep]


def test_dp2_mp2_train_step_matches_jax(tmp_path):
    """One SGD step on a dp = 2 x mp = 2 mesh of 4 gloo processes, by both
    routes, == JAX's make_sharded_train_step on a 2 x 2 mesh of the virtual
    CPU devices (the kernel route against use_pallas=True, interpret=True):
    every rank's metrics, params and BN state."""
    _dp2_mp2_step_matches_jax(tmp_path, KW)


def _dp2_mp2_step_matches_jax(tmp_path, kw):
    dp, mp = 2, 2
    shards = [_graphs(10 + d) for d in range(dp)]
    hb = batching.shard_levels_by_dst(
        batching.collate_shards(shards, mp=mp, dims=_dims(shards, mp)), mp)
    jcfg = J.DGConfig(**kw)
    params, state = J.init_params(jax.random.PRNGKey(3), jcfg)
    opt = optax.sgd(LR)
    rng = jax.random.PRNGKey(7)
    mesh_j = Mesh(np.asarray(jax.devices()[:dp * mp]).reshape(dp, mp), ("dp", "mp"))
    batch_j = jax.tree.map(jnp.asarray, hb)
    want = {}
    for route, pallas in (("kernel", True), ("edge", False)):
        step = make_sharded_train_step(jcfg, opt, mesh_j, batch_j, donate=False,
                                       use_pallas=pallas, interpret=pallas)
        want[route] = step(params, state, opt.init(params), batch_j, rng, jnp.asarray(WEIGHTS))

    inputs = _flat(jax.tree.map(np.asarray, params), "params/", {})
    inputs.update(_flat(jax.tree.map(np.asarray, state), "state/", {}))
    inputs.update(_flat(hb, "batch/", {}), cfg=json.dumps(kw), mesh=np.array([dp, mp]),
                  weights=json.dumps(WEIGHTS))
    for d in range(dp):
        neg, keep = _jax_draws(jax.random.fold_in(rng, d), {k: v[d] for k, v in hb.items()},
                               jcfg.dim_mlp)
        inputs.update({f"neg{d}/{i}": x for i, x in enumerate(neg)})
        inputs.update({f"keep{d}/{i}": x for i, x in enumerate(keep)})
    outs = _run(tmp_path, "step", dp * mp, inputs)
    for route, (p_j, s_j, _, m_j) in want.items():
        pj = _flat(jax.tree.map(np.asarray, p_j), f"{route}/params/", {})
        sj = _flat(jax.tree.map(np.asarray, s_j), f"{route}/state/", {})
        for rank, o in enumerate(outs):
            for k, v in m_j.items():
                np.testing.assert_allclose(o[f"{route}/metrics/{k}"], np.asarray(v), rtol=1e-5,
                                           atol=1e-6, err_msg=f"{route} rank {rank} {k}")
            delta = max(float(np.abs(o[k] - v).max()) for k, v in pj.items())
            assert delta < 5e-6, (route, rank, delta)
            for k, v in sj.items():
                np.testing.assert_allclose(o[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    return outs


def test_bf16_sharded_routes_match_jax(tmp_path):
    """compute_dtype="bfloat16" on both sharded routes, in gloo processes,
    against the JAX package's bf16 sharded forward (mp = 2) and dp = 2 x
    mp = 2 step, within the fp32 bounds above: the JAX routes never cast
    the params, so both packages compute in fp32 there. The port's bf16
    outputs equal its fp32 outputs bit for bit."""
    bf16 = dict(KW, compute_dtype="bfloat16")
    fwd16 = _forwards_at_mp2_match_jax(tmp_path / "fwd16", bf16)
    step16 = _dp2_mp2_step_matches_jax(tmp_path / "step16", bf16)
    fwd32 = _run(tmp_path / "fwd32", "forward", 2, _port_inputs_of(tmp_path / "fwd16"))
    step32 = _run(tmp_path / "step32", "step", 4, _port_inputs_of(tmp_path / "step16"))
    for got, want in ((fwd16, fwd32), (step16, step32)):
        for a, c in zip(got, want, strict=True):
            assert a.keys() == c.keys()
            for k in c:
                assert a[k].dtype == c[k].dtype and np.array_equal(a[k], c[k]), k


def _port_inputs_of(run_dir):
    """The inputs of an earlier worker run with its config set to fp32."""
    (inp,) = [p for p in run_dir.glob("*.npz") if p.stem in ("forward", "step")]
    z = dict(np.load(inp, allow_pickle=False))
    z["cfg"] = json.dumps(dict(json.loads(str(z["cfg"])), compute_dtype="float32"))
    return z


@pytest.mark.parametrize("route", ["kernel", "edge"])
def test_bf16_sharded_step_at_mp1_equals_fp32(route, group_of_one):
    """At mp = 1 the bf16 sharded forward and step are the fp32 ones bit for
    bit: hs, hf, every gradient, the metrics and the BN state."""
    batch = batching.shard_levels_by_dst(batching.collate(_graphs(1)), 1)
    if route == "edge":
        batch = _edge_only(batch)
    m = mesh.make_mesh(1, 1)
    out = []
    for dtype in ("float32", "bfloat16"):
        cfg = P.DGConfig(**KW, compute_dtype=dtype)
        assert sharded.route_of(batch, cfg, 1) == route
        params, state = P.init_params(cfg, seed=3, device="cpu")
        hs, hf = sharded.make_sharded_forward(cfg, group_of_one)(params, batch)
        leaves = PS.param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        step = sharded.make_sharded_train_step(cfg, torch.optim.SGD(leaves, lr=LR), m)
        st, metrics = step(params, state, batch, torch.Generator().manual_seed(5), WEIGHTS)
        out.append(([hs, hf] + [t.grad for t in leaves] + PS.param_leaves(st)
                    + [metrics[k] for k in sorted(metrics)]))
    for a, c in zip(*out, strict=True):
        assert (a is None) == (c is None)
        if c is not None:
            assert a.dtype == c.dtype == torch.float32 and torch.equal(a, c)
