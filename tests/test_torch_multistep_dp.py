"""The K-step calls under data parallelism (``train.step.make_multi_step`` /
``make_multi_eval(..., group=)``) and the trainer's grouped data-parallel
epochs, on the CPU over two gloo processes.

One ``torchrun --standalone`` launch of two ranks (``tests/test_torch_dp.py``'s
launcher; the worker script imports only torch and the port) runs every
multi-process case, and each test reads its part of the ranks' results:

  (a) ``make_multi_step(group=)`` at K = 3 against the JAX package's
      ``make_multi_step(cfg, opt, mesh=)`` on the [K, dp] stack of a
      2-device dp mesh, the negatives and dropout patched to the same
      closed forms in both packages and the prob term left out of the loss
      (``tests/test_torch_multistep.py``'s reasons): metrics rtol 1e-5,
      params atol 1e-5 (the softmax-invariant attention leaves within
      K * lr, Adam's bound), BN state atol 1e-6;
  (b) ``make_multi_eval(group=)`` against ``make_multi_eval(mesh=)``,
      metrics rtol 1e-5;
  (c) on each rank, the K-step train and eval calls bit for bit against K
      ``train_step(group=)`` / ``eval_step(group=)`` calls, plain and split
      (G = 2 at the per-group dims every rank agrees on), with the trainer's
      generator drawing (rank 1 from its folded stream);
  (d) a ``Trainer`` epoch pair at ``steps_per_call`` 3 (two groups and a
      tail step; the val phase one group) against 1, plain and split: the
      meters, params, Adam's state, BN state and both generators bit for
      bit on both ranks. Rank 1's draws come from one folded stream per
      base generator shared by the per-step and the K-step calls: a stream
      of its own in the K-step call would draw anew after each group.

In this process: (e) the grouping rule, by a spy on the trainer's
``multi_step`` under a gloo group of one and the launch variables of a
single-host or a multi-host launch (``parallel.mesh.multi_host_launch``).
Bit for bit needs one CPU thread (the threaded index backward is not
repeatable).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from mgvae_tpu.data import batching as jbatching
from mgvae_tpu.data.synthetic import random_circuit as j_random_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.ops import mlp as jmlp
from mgvae_tpu.train import losses as JL
from mgvae_tpu.train import step as JS
from mgvae_tpu_torch.data import batching
from mgvae_tpu_torch.parallel import mesh as pmesh
from test_torch_dp import (DRAWS, GRAPHS, JAX_DRAWS, SOFTMAX_INVARIANT, WORKER_TIMEOUT,
                           _inputs, _torchrun)
from test_torch_multistep import _graphs, _trainer

torch.set_num_threads(1)
CFG = dict(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
WEIGHTS = [1.0, 4.0, 2.0, 0.0]
SMOOTH = [1.0, 0.0, 4.0, 0.0]     # the JAX comparison: no prob term
LR = 1e-3
K, DP, BS = 3, 2, 4
LAYOUTS = ("plain", "split")

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from mgvae_tpu_torch.data import batching
from mgvae_tpu_torch.data.synthetic import random_circuit
from mgvae_tpu_torch.models import dg_ae
from mgvae_tpu_torch.ops import mlp
from mgvae_tpu_torch.parallel import mesh
from mgvae_tpu_torch.train import losses
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.train.trainer import Trainer
from mgvae_tpu_torch.utils.params import params_from_jax, state_from_jax

inp, out = sys.argv[1:3]
rank, world = mesh.maybe_initialize_distributed("cpu", timeout=60)
group = dist.group.WORLD
z = dict(np.load(inp, allow_pickle=False))
cfg = dg_ae.DGConfig(**json.loads(str(z.pop("cfg"))))
K, BS, LR = int(z["K"]), int(z["bs"]), float(z["lr"])
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
    return (params_from_jax(tree("params/"), device="cpu"),
            state_from_jax(tree("state/"), device="cpu"))


res = {}


def put(prefix, params, state, opt, gen):
    adam = [t for p in PS.param_leaves(params) for t in opt.state[p].values()]
    for name, leaves in (("p", PS.param_leaves(params)), ("s", PS.param_leaves(state)),
                         ("a", adam)):
        res.update({f"{prefix}{name}{i}": t.detach().numpy() for i, t in enumerate(leaves)})
    if gen is not None:
        res[f"{prefix}gen"] = gen.get_state().numpy()
        res[f"{prefix}folded"] = PS.fold_generator(gen, rank).get_state().numpy()


# this rank's shard of each of the K steps; the dims over every rank's shards
every = graphs(random_circuit, K * world * BS)
shards = [every[j * BS:(j + 1) * BS] for j in range(K * world)]
mine = [shards[s * world + rank] for s in range(K)]
stacks = {}
dl = [batching.natural_dims(s) for s in shards]
dims = {k: max(d[k] for d in dl) for k in dl[0]}
stacks["plain"] = (batching.collate_shards(mine, dims=dims),
                   [batching.collate(s, dims=dims) for s in mine])
sdims = batching.split_dims(shards, 2)
stacks["split"] = (batching.collate_split_step(mine, sdims),
                   [batching.collate_split(s, 2, dims=sdims) for s in mine])

# (c) the K-step calls against K train_step / eval_step calls, the generator drawing
for layout, (sb, singles) in stacks.items():
    for grouped in (True, False):
        params, state = fresh()
        opt = PS.make_optimizer(params, LR)
        gen = torch.Generator().manual_seed(5)
        if grouped:
            state, rows = PS.make_multi_step(cfg, opt, group=group)(params, state, sb, gen,
                                                                   weights)
            erows = PS.make_multi_eval(cfg, group=group)(params, state, sb, gen, weights)
        else:
            train_step, eval_step = PS.make_train_step(cfg, opt, group=group)
            rows, erows = [], []
            for b in singles:
                state, m = train_step(params, state, b, gen, weights)
                rows.append(torch.stack([m[k] for k in PS.METRIC_KEYS]))
            for b in singles:
                m = eval_step(params, state, b, gen, weights)
                erows.append(torch.stack([m[k] for k in PS.METRIC_KEYS]))
            rows, erows = torch.stack(rows), torch.stack(erows)
        tag = f"c/{layout}/{'group' if grouped else 'single'}/"
        res[tag + "rows"], res[tag + "erows"] = rows.numpy(), erows.numpy()
        put(tag, params, state, opt, gen)

# (d) the trainer at steps_per_call 3 against 1, with a tail step
train_ds, val_ds = graphs(random_circuit, 28, seed=1), graphs(random_circuit, 12, seed=2)
for layout in ("plain", "split"):
    for spc in (K, 1):
        params, state = fresh()
        tr = Trainer(None, cfg, params=params, state=state, training_id=f"{layout}{spc}",
                     save_dir=out, batch_size=2, distributed=True, seed=3, device="cpu",
                     steps_per_call=spc, split=2 if layout == "split" else "auto")
        assert tr.num_devices == world and tr.group is not None
        tr.set_training_args(rc_prob_func_weight=weights[:3], lr=LR, lr_step=1)
        calls = {"group": [], "single": 0}
        multi, single = tr.multi_step, tr.train_step

        def spy_multi(p, s, sbatch, *a, _multi=multi, **k):
            calls["group"].append(int(sbatch["gate"].shape[0]))
            return _multi(p, s, sbatch, *a, **k)

        def spy_single(*a, _single=single, **k):
            calls["single"] += 1
            return _single(*a, **k)

        tr.multi_step, tr.train_step = spy_multi, spy_single
        ms = [tr.train(1, train_ds, val_ds) for _ in range(2)]
        tag = f"d/{layout}/{spc}/"
        res[tag + "meters"] = json.dumps([{k: v for k, v in m[ph].items() if k != "time"}
                                          for m in ms for ph in ("train", "val")])
        res[tag + "calls"] = json.dumps(calls)
        res[tag + "grouped"] = int(tr.grouped)
        put(tag, tr.params, tr.state, tr.optimizer, tr._gen)

# (a), (b): against the JAX package's mesh calls, the draws patched to closed forms
losses.sample_negative_edges, mlp.dropout = negatives, dropout
sb = stacks["plain"][0]
params, state = fresh()
opt = PS.make_optimizer(params, LR)
state, rows = PS.make_multi_step(cfg, opt, group=group)(
    params, state, sb, torch.Generator().manual_seed(0), smooth)
res["a/rows"] = rows.numpy()
put("a/", params, state, opt, None)
params, state = fresh()
res["b/rows"] = PS.make_multi_eval(cfg, group=group)(
    params, state, sb, torch.Generator().manual_seed(0), weights).numpy()
np.savez(f"{out}/{rank}.npz", **res)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results and the JAX side's (a) and (b)."""
    tmp = tmp_path_factory.mktemp("multistep_dp")
    jcfg = J.DGConfig(**CFG)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    inputs = _inputs(params, state, CFG, WEIGHTS)
    inputs.update(graphs=GRAPHS, draws=DRAWS, K=K, bs=BS, lr=LR, smooth=json.dumps(SMOOTH))
    inp = tmp / "in.npz"
    np.savez(inp, **inputs)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    _torchrun([script, inp, tmp], DP, WORKER_TIMEOUT)
    outs = [dict(np.load(tmp / f"{r}.npz")) for r in range(DP)]

    scope = {"np": np, "jnp": jnp, "torch": torch}
    exec(GRAPHS + JAX_DRAWS, scope)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "sample_negative_edges", scope["negatives"])
        mp.setattr(jmlp, "dropout", scope["dropout"])
        every = scope["graphs"](j_random_circuit, K * DP * BS)
        shards = [every[j * BS:(j + 1) * BS] for j in range(K * DP)]
        dl = [batching.natural_dims(s) for s in shards]
        hb = jbatching.collate_shards(shards, dims={k: max(d[k] for d in dl) for k in dl[0]})
        jsb = {k: jnp.asarray(v.reshape((K, DP) + v.shape[1:])) for k, v in hb.items()}
        mesh_j = Mesh(np.asarray(jax.devices()[:DP]), ("dp",))
        opt = JS.make_optimizer(LR)
        rngs = jax.random.split(jax.random.PRNGKey(1), K)
        p_j, s_j, _, m_j = JS.make_multi_step(jcfg, opt, mesh=mesh_j, donate=False)(
            params, state, opt.init(params), jsb, rngs, jnp.asarray(SMOOTH))
        e_j = JS.make_multi_eval(jcfg, mesh=mesh_j)(params, state, jsb, rngs,
                                                    jnp.asarray(WEIGHTS))
    return outs, {"params": p_j, "state": s_j, "rows": np.asarray(m_j),
                  "erows": np.asarray(e_j)}


def _leaves(o, prefix, name):
    n = sum(1 for k in o if k.startswith(prefix + name) and k[len(prefix + name):].isdigit())
    return [o[f"{prefix}{name}{i}"] for i in range(n)]


def _same(o, a, b):
    """Every array under prefix ``a`` equals its counterpart under ``b``."""
    keys = sorted(k[len(a):] for k in o if k.startswith(a))
    assert keys and keys == sorted(k[len(b):] for k in o if k.startswith(b))
    return [k for k in keys if not (o[a + k].dtype == o[b + k].dtype
                                    and np.array_equal(o[a + k], o[b + k]))]


@pytest.mark.parametrize("rank", range(DP))
def test_dp_multi_step_matches_jax_make_multi_step_mesh(ranks, rank):
    """(a) The K-step call over 2 gloo ranks against JAX's ``make_multi_step``
    on a 2-device dp mesh: metric rows, params and BN state on each rank."""
    outs, j = ranks
    o = outs[rank]
    assert o["a/rows"].shape == (K, 9)
    np.testing.assert_allclose(o["a/rows"], j["rows"], rtol=1e-5)
    paths = jax.tree_util.tree_leaves_with_path(j["params"])
    got = _leaves(o, "a/", "p")
    assert len(got) == len(paths)
    for g, (path, want) in zip(got, paths):
        name = jax.tree_util.keystr(path)
        atol = K * LR if name in SOFTMAX_INVARIANT else 1e-5
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=atol, err_msg=name)
    want_s = jax.tree.leaves(j["state"])
    got_s = _leaves(o, "a/", "s")
    assert len(got_s) == len(want_s)
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rank", range(DP))
def test_dp_multi_eval_matches_jax_make_multi_eval_mesh(ranks, rank):
    """(b) The K-step eval call over 2 gloo ranks against JAX's
    ``make_multi_eval`` on a 2-device dp mesh."""
    outs, j = ranks
    assert outs[rank]["b/rows"].shape == (K, 9)
    np.testing.assert_allclose(outs[rank]["b/rows"], j["erows"], rtol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dp_multi_step_equals_k_train_steps_on_each_rank(ranks, layout):
    """(c) On each rank the K-step train call equals K ``train_step(group=)``
    calls bit for bit: metric rows, params, Adam's state, BN state and both
    generators (rank 1 draws from its folded stream)."""
    outs, _ = ranks
    for rank, o in enumerate(outs):
        a, b = f"c/{layout}/group/", f"c/{layout}/single/"
        assert np.array_equal(o[a + "rows"], o[b + "rows"]), rank
        assert not _same(o, a + "p", b + "p") and not _same(o, a + "a", b + "a"), rank
        assert not _same(o, a + "s", b + "s"), rank
        assert np.array_equal(o[a + "gen"], o[b + "gen"]), rank
        assert np.array_equal(o[a + "folded"], o[b + "folded"]), rank
    # the ranks trained on different shards, drew apart, and agree on the means
    assert not np.array_equal(outs[0][f"c/{layout}/group/folded"],
                              outs[1][f"c/{layout}/group/folded"])
    assert np.array_equal(outs[0][f"c/{layout}/group/rows"], outs[1][f"c/{layout}/group/rows"])
    assert not _same({**{"0/" + k: v for k, v in outs[0].items()},
                      **{"1/" + k: v for k, v in outs[1].items()}},
                     f"0/c/{layout}/group/p", f"1/c/{layout}/group/p")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dp_multi_eval_equals_k_eval_steps_on_each_rank(ranks, layout):
    """(c) On each rank the K-step eval call equals K ``eval_step(group=)``
    calls bit for bit, after the same train steps."""
    outs, _ = ranks
    for rank, o in enumerate(outs):
        assert np.array_equal(o[f"c/{layout}/group/erows"], o[f"c/{layout}/single/erows"]), rank


@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_process_grouped_epochs_equal_per_step_epochs(ranks, layout):
    """(d) Two epochs over 2 gloo ranks at ``steps_per_call`` 3 (7 train
    steps: two groups and a tail step; the val phase one group) against 1:
    every meter, param, Adam moment, BN statistic and both generators bit
    for bit on each rank."""
    outs, _ = ranks
    for rank, o in enumerate(outs):
        g, s = f"d/{layout}/{K}/", f"d/{layout}/1/"
        assert int(o[g + "grouped"]) == 1 and int(o[s + "grouped"]) == 0
        assert json.loads(str(o[g + "calls"])) == {"group": [K, K] * 2, "single": 2}, rank
        assert json.loads(str(o[s + "calls"])) == {"group": [], "single": 14}, rank
        assert json.loads(str(o[g + "meters"])) == json.loads(str(o[s + "meters"])), rank
        for part in ("p", "a", "s"):
            assert not _same(o, g + part, s + part), (rank, part)
        assert np.array_equal(o[g + "gen"], o[s + "gen"]), rank
        assert np.array_equal(o[g + "folded"], o[s + "folded"]), rank


RULES = {
    # (launch variables, multi-host, grouped)
    "no_launch_variables": ({}, False, True),
    "torchrun_one_host": ({"RANK": "0", "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"}, False,
                          True),
    "torchrun_two_hosts": ({"RANK": "0", "WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "2"}, True,
                           False),
    "by_hand_without_local_world_size": ({"RANK": "0", "WORLD_SIZE": "2"}, True, False),
    "jax_one_process": ({"COORDINATOR_ADDRESS": "h0:1234", "NUM_PROCESSES": "1",
                         "PROCESS_ID": "0"}, False, True),
    "jax_two_hosts": ({"COORDINATOR_ADDRESS": "h0:1234", "NUM_PROCESSES": "2",
                       "PROCESS_ID": "0"}, True, False),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_grouping_rule_under_a_group(tmp_path, monkeypatch, rule):
    """(e) Under a (gloo) process group the trainer groups its steps on a
    single-host launch and steps singly on a multi-host one, as the JAX
    trainer's ``jax.process_count() == 1``: torchrun's ``WORLD_SIZE`` past
    its ``LOCAL_WORLD_SIZE`` (any ``WORLD_SIZE > 1`` without it), or the
    JAX package's ``NUM_PROCESSES > 1``. A spy on ``multi_step`` counts the
    groups of 7 train steps at K = 3."""
    env, multi_host, grouped = RULES[rule]
    for k in pmesh.TORCHRUN_VARS + pmesh.JAX_VARS + ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pmesh.multi_host_launch() == multi_host
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        t, calls = _trainer(tmp_path, rule, K, distributed=True)
        assert t.group is not None and t.grouped == grouped
        t.train(1, _graphs(14, seed=1), [])
    finally:
        dist.destroy_process_group()
    want = {"group": [K, K], "single": 1} if grouped else {"group": [], "single": 7}
    assert calls == want, t.step_mode
