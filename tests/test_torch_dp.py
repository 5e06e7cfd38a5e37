"""Data parallelism of the port: ``train.step.make_train_step(..., group=)``
and the ``Trainer`` over gloo processes (``torchrun --standalone``; each
worker script is written to ``tmp_path`` and imports only torch and the
port), against the JAX package's data-parallel step and trainer on the
virtual CPU mesh.

A dp = 2 SGD step (lr 0.1) of DG_AE and of DG_VAE equals JAX's
``make_train_step(cfg, opt, mesh_dp)`` on every rank, with the negatives,
dropout masks and (DG_VAE) posterior noise JAX draws on each shard from
``fold_in(rng, d)`` handed to rank d: metrics rtol 1e-5 / atol 1e-6 (the
dp means), params within 5e-6, BN running state atol 1e-6. A 2-process
``Trainer`` epoch, plain and split, equals the JAX ``Trainer``'s epoch on a
2-device dp mesh from the same params: each rank collates the shards the
JAX trainer hands its device, and the meters, params and BN state agree
within ``tests/test_torch_trainer.py``'s bounds, with the negatives and
the dropout patched to the same closed forms in both packages (their
reasons are written there). Adam runs at lr 1e-4: it moves a leaf whose
gradient is rounding noise by up to lr a step, in either package, and at
1e-3 one such element of 768 passed the 1e-5 bound. Only the chief
writes the log and the checkpoints (as ``tests/test_multihost.py`` holds
the JAX trainer). In one process, a ``Trainer`` with ``distributed``
under a gloo group of one trains bit for bit as the single-device
trainer.
"""
import json
import os
import subprocess
import sys
import types

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
from mgvae_tpu.ops import mlp as jmlp
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
from mgvae_tpu.train import trainer as jtrainer
from mgvae_tpu_torch.data import batching
from mgvae_tpu_torch.data.synthetic import random_circuit as p_random_circuit
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(modality="mig", dim_hidden=32, s_rounds=2, t_rounds=2, layernorm=True)
LR = 0.1
WORKER_TIMEOUT = 150

WORKER = r'''
import json, os, sys, types
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from mgvae_tpu_torch.models import dg_ae
from mgvae_tpu_torch.parallel import mesh
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax

mode, inp, out = sys.argv[1:4]
rank, world = mesh.maybe_initialize_distributed("cpu", timeout=60)
z = dict(np.load(inp, allow_pickle=False))
cfg = dg_ae.DGConfig(**json.loads(str(z.pop("cfg"))))


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


params = params_from_jax(tree("params/"), device="cpu")
state = state_from_jax(tree("state/"), device="cpu")
res = {}
if mode.startswith("trainer"):
    from mgvae_tpu_torch.data.synthetic import random_circuit
    from mgvae_tpu_torch.ops import mlp
    from mgvae_tpu_torch.train import losses
    from mgvae_tpu_torch.train.trainer import Trainer
    exec(str(z["draws"]))              # the closed-form draws the parent patches in
    losses.sample_negative_edges, mlp.dropout = negatives, dropout
    exec(str(z["graphs"]))
    names, collate_step = [], Trainer._collate_step

    def recorded(self, graphs, *a):
        names.append([g.name for g in graphs])
        return collate_step(self, graphs, *a)

    Trainer._collate_step = recorded
    split = int(mode[len("trainer"):] or 0) or "auto"
    tr = Trainer(None, cfg, params=params, state=state, training_id="mh", save_dir=out,
                 batch_size=4, distributed=True, seed=3, device="cpu", split=split,
                 steps_per_call=1)
    assert tr.num_devices == 2 and tr.group is not None and tr.is_chief == (rank == 0)
    tr.set_training_args(rc_prob_func_weight=json.loads(str(z["weights"])),
                         lr=float(z["lr"]))
    m = tr.train(1, graphs(random_circuit, 16), graphs(random_circuit, 8, seed=1))
    res = {f"m/{phase}/{k}": v for phase in ("train", "val") for k, v in m[phase].items()
           if k != "time"}
    res.update(names=json.dumps(names), split=tr._split or 1)
    res.update({f"s{i}": t.numpy() for i, t in enumerate(PS.param_leaves(tr.state))})
    leaves = PS.param_leaves(tr.params)
else:
    leaves = PS.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    m = mesh.make_dp_mesh()
    step, _ = PS.make_train_step(cfg, torch.optim.SGD(leaves, lr=0.1), group=m.dp_group)
    shard = {k: v[m.dp_rank] for k, v in tree("batch/").items()}
    neg = tuple(torch.tensor(z[f"neg{rank}/{i}"]) for i in range(2))
    keep = [torch.tensor(z[f"keep{rank}/{i}"]) for i in range(2)]
    eps = (tuple(torch.tensor(z[f"eps{rank}/{i}"]) for i in range(2))
           if cfg.variational else None)
    st, metrics = step(params, state, shard, None, json.loads(str(z["weights"])),
                       neg_edges=neg, drop_keep=keep, vae_eps=eps)
    res.update({f"s{i}": t.numpy() for i, t in enumerate(PS.param_leaves(st))})
    res.update({f"m/{k}": v.numpy() for k, v in metrics.items()})
res.update({f"p{i}": t.detach().numpy() for i, t in enumerate(leaves)})
np.savez(f"{out}/{rank}.npz", **res)
dist.destroy_process_group()
'''

# The trainer comparison's graphs and draws, run in this process on the JAX
# side and in each worker (exec) on the port's: the draws are closed forms
# of the batch (tests/test_torch_trainer.py), the same in both packages.
GRAPHS = '''
def graphs(make, n, seed=0):
    rng = np.random.default_rng(seed)
    return [make(rng, "mig", num_inputs=4, num_gates=24 + (i % 3) * 4, num_tt_pairs=16,
                 name=f"g{seed}_{i}") for i in range(n)]
'''
DRAWS = '''
def _keep(n, d, xp):
    r, c = xp.arange(n)[:, None], xp.arange(d)[None, :]
    return (r * 7 + c * 13 + r // 3) % 5 != 0


def negatives(gen, num_samples, b):
    i = torch.arange(num_samples, dtype=torch.int32)
    n = torch.as_tensor(b["n_nodes"]).to(torch.int32).clamp(min=2)
    src = (b["edge_dst"] * 5 + i * 3 + 1) % n
    off = (b["edge_src"] * 7 + i * 11) % (n - 1)
    return src, (src + 1 + off) % n


def dropout(x, p, train, gen=None, keep=None):
    if not train or p <= 0.0:
        return x
    return torch.where(_keep(*x.shape, torch), x / (1.0 - p), 0.0)
'''
JAX_DRAWS = '''
def _keep(n, d, xp):
    r, c = xp.arange(n)[:, None], xp.arange(d)[None, :]
    return (r * 7 + c * 13 + r // 3) % 5 != 0


def negatives(rng, num_samples, batch):
    i = jnp.arange(num_samples, dtype=jnp.int32)
    n = jnp.maximum(batch["n_nodes"].astype(jnp.int32), 2)
    src = (batch["edge_dst"] * 5 + i * 3 + 1) % n
    off = (batch["edge_src"] * 7 + i * 11) % (n - 1)
    return src, (src + 1 + off) % n


def dropout(key, x, p, train):
    if not train or p <= 0.0:
        return x
    return jnp.where(_keep(*x.shape, jnp), x / (1.0 - p), 0.0)
'''
# leaves whose gradient the softmax cancels: each package's rounding noise,
# which Adam scales to at most lr a step (tests/test_torch_trainer.py)
SOFTMAX_INVARIANT = {f"['experts']['{k}']" for k in ("wq", "bq", "wa_q", "ba", "bk")}


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


def _torchrun(argv, nprocs: int, timeout: float) -> None:
    """Run ``argv`` (a script and its arguments) as ``nprocs`` ranks of
    ``torchrun --standalone`` on this host: torchrun takes a free port and
    stops every rank when one fails. Past ``timeout`` seconds it gets
    SIGTERM, on which it stops its ranks, and the test fails."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nprocs), *map(str, argv)]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.terminate()
        try:
            out, _ = p.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        pytest.fail(f"{nprocs} ranks past {timeout} s:\n{out[-6000:]}")
    if p.returncode:
        pytest.fail(f"{nprocs} ranks: exit code {p.returncode}\n{out[-6000:]}")


def _run(tmp_path, mode, nprocs, inputs):
    inp = tmp_path / f"{mode}.npz"
    np.savez(inp, **inputs)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    _torchrun([script, mode, inp, tmp_path], nprocs, WORKER_TIMEOUT)
    return [dict(np.load(tmp_path / f"{r}.npz")) for r in range(nprocs)]


def _inputs(params, state, kw, weights):
    inputs = _flat(jax.tree.map(np.asarray, params), "params/", {})
    inputs.update(_flat(jax.tree.map(np.asarray, state), "state/", {}))
    inputs.update(cfg=json.dumps(kw), weights=json.dumps(weights))
    return inputs


def _jax_draws(key, hb, cfg):
    """JAX's draws of ``loss_and_metrics(..., rng=key)`` on one shard: the
    posterior noise (DG_VAE), the negatives and the dropout keep masks."""
    k_vae, k_neg, k_drop = jax.random.split(key, 3)
    batch = jax.tree.map(jnp.asarray, hb)
    neg = JL.sample_negative_edges(k_neg, hb["edge_src"].shape[0], batch)
    n = hb["gate"].shape[0]
    keep = [jax.random.bernoulli(k, 0.8, (n, cfg.dim_mlp)) for k in jax.random.split(k_drop, 2)]
    eps = [jax.random.normal(k, (n, cfg.dim_hidden)) for k in jax.random.split(k_vae)]
    return [np.asarray(x) for x in neg], [np.asarray(k) for k in keep], [np.asarray(e) for e in eps]


@pytest.mark.parametrize("model", ["DG_AE", "DG_VAE"])
def test_dp2_train_step_matches_jax(model, tmp_path):
    dp = 2
    kw = dict(KW, variational=model == "DG_VAE")
    weights = [1.0, 4.0, 2.0, 0.5 if kw["variational"] else 0.0]
    jcfg = J.DGConfig(**kw)
    rngs = [np.random.default_rng(20 + d) for d in range(dp)]
    shards = [[random_circuit(r, "mig", num_inputs=8, num_gates=60, num_tt_pairs=32)
               for _ in range(4)] for r in rngs]
    dl = [batching.natural_dims(s) for s in shards]
    hb = jbatching.collate_shards(shards, dims={k: max(d[k] for d in dl) for k in dl[0]})
    params, state = J.init_params(jax.random.PRNGKey(2), jcfg)
    opt = optax.sgd(LR)
    rng = jax.random.PRNGKey(9)
    mesh_j = Mesh(np.asarray(jax.devices()[:dp]), ("dp",))
    step_j, _ = JS.make_train_step(jcfg, opt, mesh_j, donate=False)
    p_j, s_j, _, m_j = step_j(params, state, opt.init(params), jax.tree.map(jnp.asarray, hb),
                              rng, jnp.asarray(weights))

    inputs = _inputs(params, state, kw, weights)
    inputs.update(_flat(hb, "batch/", {}))
    for d in range(dp):
        neg, keep, eps = _jax_draws(jax.random.fold_in(rng, d),
                                    {k: v[d] for k, v in hb.items()}, jcfg)
        for name, xs in (("neg", neg), ("keep", keep), ("eps", eps)):
            inputs.update({f"{name}{d}/{i}": x for i, x in enumerate(xs)})
    outs = _run(tmp_path, "step", dp, inputs)
    pj = [np.asarray(x) for x in jax.tree.leaves(p_j)]   # dict keys sorted, as param_leaves
    sj = [np.asarray(x) for x in jax.tree.leaves(s_j)]
    for rank, o in enumerate(outs):
        for k, v in m_j.items():
            np.testing.assert_allclose(o[f"m/{k}"], np.asarray(v), rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {rank} {k}")
        assert len(pj) == sum(k.startswith("p") for k in o)
        delta = max(float(np.abs(o[f"p{i}"] - v).max()) for i, v in enumerate(pj))
        assert delta < 5e-6, (rank, delta)
        for i, v in enumerate(sj):
            np.testing.assert_allclose(o[f"s{i}"], v, rtol=0, atol=1e-6)


@pytest.mark.parametrize("split", [1, 2])
def test_two_process_trainer_epoch_matches_jax_trainer(split, tmp_path, monkeypatch):
    """The trainer over 2 gloo processes, 16 graphs at bs4 (2 steps of 2
    shards) and 8 for validation, plain or split into 2 shape-sorted groups
    a shard (the agreed per-group dims of every shard), against the JAX
    trainer's epoch on a 2-device dp mesh from the same params: rank r
    collates, step by step, the shard the JAX trainer hands device r; both
    ranks end with the JAX meters, params and BN state; only the chief
    wrote the log and model_last.pth."""
    weights, lr = [1.0, 0.0, 4.0], 1e-4
    kw = dict(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
    scope = {"np": np, "jnp": jnp, "torch": torch}
    exec(GRAPHS + JAX_DRAWS, scope)
    monkeypatch.setattr(JL, "sample_negative_edges", scope["negatives"])
    monkeypatch.setattr(jmlp, "dropout", scope["dropout"])
    shards = []
    if split > 1:
        inner = jtrainer.Trainer._collate_split_shards

        def recorded(self, groups, *a, **k):
            shards.append([[g.name for g in s] for s in groups])
            return inner(self, groups, *a, **k)
        monkeypatch.setattr(jtrainer.Trainer, "_collate_split_shards", recorded)
    else:
        def recorded(groups, *a, _inner=jtrainer.collate_shards, **k):
            shards.append([[g.name for g in s] for s in groups])
            return _inner(groups, *a, **k)
        monkeypatch.setattr(jtrainer, "collate_shards", recorded)

    jcfg = J.DGConfig(**kw)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    inputs = _inputs(params, state, kw, weights)      # before the JAX step donates them
    inputs.update(graphs=GRAPHS, draws=DRAWS, lr=lr)
    p0 = [np.asarray(x) for x in jax.tree.leaves(params)]
    jt = jtrainer.Trainer(None, jcfg, params=params, state=state, training_id="j",
                          save_dir=str(tmp_path / "jax"), batch_size=4, distributed=True,
                          num_devices=2, seed=3, steps_per_call=1, split=split,
                          thin_wire=False)
    jt.set_training_args(rc_prob_func_weight=weights, lr=lr)
    out_j = jt.train(1, scope["graphs"](random_circuit, 16),
                     scope["graphs"](random_circuit, 8, seed=1))
    assert jt.num_devices == 2 and len(shards) == 2 + 1

    outs = _run(tmp_path, f"trainer{split if split > 1 else ''}", 2, inputs)
    j_paths = jax.tree_util.tree_leaves_with_path(jt.params)
    for rank, o in enumerate(outs):
        assert json.loads(str(o["names"])) == [step[rank] for step in shards], rank
        assert int(o["split"]) == split
        for phase in ("train", "val"):
            for k, v in out_j[phase].items():
                if k != "time":
                    np.testing.assert_allclose(o[f"m/{phase}/{k}"], v, rtol=1e-5,
                                               err_msg=f"rank {rank} {phase} {k}")
        assert len(j_paths) == sum(k.startswith("p") for k in o)
        moved = 0
        for i, ((path, c), x0) in enumerate(zip(j_paths, p0)):
            name = jax.tree_util.keystr(path)
            atol = 2 * 2 * lr if name in SOFTMAX_INVARIANT else 1e-5
            np.testing.assert_allclose(o[f"p{i}"], np.asarray(c), rtol=0, atol=atol,
                                       err_msg=f"rank {rank} {name}")
            moved += int((np.abs(o[f"p{i}"] - x0) > 5e-5).sum())
        # the epoch trained: most params moved by 5x the tolerance or more
        assert moved > 0.5 * sum(x.size for x in p0), moved
        for i, c in enumerate(jax.tree.leaves(jt.state)):
            np.testing.assert_allclose(o[f"s{i}"], np.asarray(c), rtol=0, atol=1e-6)
    run = tmp_path / "mh"
    assert (run / "model_last.pth").exists() and (run / "model_0.pth").exists()
    assert len([f for f in os.listdir(run) if f.startswith("log-")]) == 1


def test_trainer_over_a_group_of_one_equals_single_device(tmp_path):
    """``distributed`` under a gloo group of one rank: the data-parallel step
    (its all-reduce over one rank) trains bit for bit as the single-device
    trainer: losses, params and BN state after two epochs. Both group their
    steps (``steps_per_call`` 2: a group and the tail step an epoch), the
    group of one through ``make_multi_step(..., group=)``."""
    rng = np.random.default_rng(1)
    ds = [p_random_circuit(rng, "mig", num_inputs=6, num_gates=40) for _ in range(12)]
    cfg = P.DGConfig(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
    args = types.SimpleNamespace(model="DG_AE")
    groups = []

    def spied(tr):
        multi = tr.multi_step

        def call(params, state, sbatch, *a, **k):
            groups.append((tr.group is not None, int(sbatch["gate"].shape[0])))
            return multi(params, state, sbatch, *a, **k)
        tr.multi_step = call
        return tr

    single = spied(Trainer(args, cfg, training_id="one", save_dir=str(tmp_path), batch_size=4,
                           distributed=False, seed=3, device="cpu", steps_per_call=2))
    m_single = single.train(2, ds, ds[:4])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        dp = spied(Trainer(args, cfg, training_id="dp", save_dir=str(tmp_path), batch_size=4,
                           distributed=True, seed=3, device="cpu", steps_per_call=2))
        assert dp.group is not None and dp.grouped
        m_dp = dp.train(2, ds, ds[:4])
    finally:
        dist.destroy_process_group()
    assert groups == [(False, 2)] * 2 + [(True, 2)] * 2
    assert all(m_dp[phase][k] == m_single[phase][k] for phase in ("train", "val")
               for k in m_single[phase] if k != "time")
    for a, c in zip(PS.param_leaves(dp.params) + PS.param_leaves(dp.state),
                    PS.param_leaves(single.params) + PS.param_leaves(single.state)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("env, want", [
    ({}, None),
    ({"RANK": "1", "WORLD_SIZE": "4", "MASTER_ADDR": "h0", "MASTER_PORT": "29500",
      "LOCAL_RANK": "1"},
     {"init_method": "tcp://h0:29500", "rank": 1, "world_size": 4, "local_rank": 1}),
    ({"COORDINATOR_ADDRESS": "h0:1234", "NUM_PROCESSES": "2", "PROCESS_ID": "1"},
     {"init_method": "tcp://h0:1234", "rank": 1, "world_size": 2, "local_rank": 0}),
    ({"COORDINATOR_ADDRESS": "h0:1234", "NUM_PROCESSES": "2", "PROCESS_ID": "1",
      "LOCAL_RANK": "3"},
     {"init_method": "tcp://h0:1234", "rank": 1, "world_size": 2, "local_rank": 3}),
    ({"MASTER_ADDR": "h0"}, None),
    ({"MASTER_ADDR": "h0", "MASTER_PORT": "29500", "NUM_PROCESSES": "2"}, None),
    ({"WORLD_SIZE": "2"}, RuntimeError),
    ({"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "h0"}, RuntimeError),
    ({"COORDINATOR_ADDRESS": "h0:1234", "NUM_PROCESSES": "2"}, RuntimeError),
], ids=["none", "torchrun", "jax", "jax_local_rank", "master_addr_alone",
        "rendezvous_without_ranks", "world_size_alone", "no_port", "no_process_id"])
def test_launch_config_from_the_environment(env, want, monkeypatch):
    """torchrun's and the JAX package's launch variables; a partial set
    raises (the JAX package's ``mesh.py:45-50``), none is a one-process run.
    A launch starts at ``RANK`` / ``WORLD_SIZE`` or ``COORDINATOR_ADDRESS``:
    ``MASTER_ADDR`` / ``MASTER_PORT``, which cluster shells export for
    every job, start none. Under the JAX package's variables (one process
    per host) the local rank is ``LOCAL_RANK`` or 0."""
    from mgvae_tpu_torch.parallel import mesh

    for k in mesh.TORCHRUN_VARS + mesh.JAX_VARS + ("LOCAL_RANK",):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="partial multi-process launch"):
            mesh.maybe_initialize_distributed("cpu")
    else:
        assert mesh._launch_config() == want
    if want is None:
        assert mesh.maybe_initialize_distributed("cpu") == (0, 1)
        assert not dist.is_initialized()


def test_no_backend_is_chosen_silently(monkeypatch):
    from mgvae_tpu_torch.parallel import mesh

    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT="29500").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="no backend 'nccl' for device cpu"):
        mesh.maybe_initialize_distributed("cpu", backend="nccl")
    with pytest.raises(ValueError, match="no backend 'mpi'"):
        mesh.maybe_initialize_distributed("cpu", backend="mpi")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh.make_mesh(1, 1)


def test_master_addr_alone_trains_on_one_device(tmp_path, monkeypatch):
    """A shell that exports only the rendezvous address (common on clusters
    and in PyTorch images) runs the single-device trainer and CLI check: no
    process group, rank 0 the chief, one device."""
    from mgvae_tpu_torch.parallel import mesh
    from mgvae_tpu_torch.train.trainer import join_launch

    for k in mesh.TORCHRUN_VARS + mesh.JAX_VARS + ("LOCAL_RANK",):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert join_launch(False, None, "cpu") == (0, 1)
    cfg = P.DGConfig(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1)
    tr = Trainer(None, cfg, training_id="one", save_dir=str(tmp_path), batch_size=4,
                 distributed=False, device="cpu")
    assert tr.group is None and tr.is_chief and tr.num_devices == 1
    assert not dist.is_initialized()
