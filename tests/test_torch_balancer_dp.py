"""One data-parallel Balancer step of the port over two gloo processes
(``tests/test_torch_dp.py``'s launcher and time limit; the worker script
imports only torch and the port) against the JAX package's mesh step:
the per-task gradients are averaged before the norms, so every rank takes
the JAX step's scales."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh

from mgvae_tpu.data import batching as jbatching
from mgvae_tpu.data.synthetic import random_circuit as jrandom_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.train import gradnorm as JG
from mgvae_tpu.train import trainer_balancer as jbal
from mgvae_tpu_torch.data import batching
from test_torch_dp import WORKER_TIMEOUT, _flat, _inputs, _jax_draws, _torchrun

CFG = dict(modality="mig", dim_hidden=32, s_rounds=1, t_rounds=1, layernorm=True)


BAL_WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from mgvae_tpu_torch.models import dg_ae
from mgvae_tpu_torch.parallel import mesh
from mgvae_tpu_torch.train import gradnorm, trainer_balancer
from mgvae_tpu_torch.train.step import param_leaves
from mgvae_tpu_torch.utils.params import params_from_jax, state_from_jax

inp, out = sys.argv[1:3]
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
leaves = param_leaves(params)
for t in leaves:
    t.requires_grad_(True)
m = mesh.make_dp_mesh()
bal_cfg = gradnorm.BalancerConfig(weights=tuple(json.loads(str(z["weights"]))))
step = trainer_balancer.make_balancer_train_step(cfg, torch.optim.SGD(leaves, lr=float(z["lr"])),
                                                 bal_cfg, group=m.dp_group)
shard = {k: v[m.dp_rank] for k, v in tree("batch/").items()}
neg = tuple(torch.tensor(z[f"neg{rank}/{i}"]) for i in range(2))
keep = [torch.tensor(z[f"keep{rank}/{i}"]) for i in range(2)]
st, bal, metrics = step(params, state, gradnorm.balancer_init(bal_cfg), shard, None,
                        neg_edges=neg, drop_keep=keep)
res = {f"m/{k}": v.numpy() for k, v in metrics.items()}
res.update({f"s{i}": t.numpy() for i, t in enumerate(param_leaves(st))})
res.update({f"p{i}": t.detach().numpy() for i, t in enumerate(leaves)})
res["avg"] = bal["avg"]["total"].numpy()
np.savez(f"{out}/{rank}.npz", **res)
dist.destroy_process_group()
'''


def test_dp2_balancer_step_matches_jax(tmp_path):
    """A dp = 2 Balancer step (SGD, lr 0.1) over two gloo processes against
    JAX's ``make_balancer_train_step(cfg, opt, bal_cfg, mesh)``: each rank
    takes JAX's draws of its shard (``fold_in(rng, d)``); metrics and scales
    rtol 1e-5 / atol 1e-6, params within 5e-6, BN state atol 1e-6 on both
    ranks (``tests/test_torch_dp.py``'s bounds)."""
    dp, lr, weights = 2, 0.1, [1.0, 4.0, 2.0]
    kw = dict(CFG)
    jcfg = J.DGConfig(**kw)
    rngs = [np.random.default_rng(30 + d) for d in range(dp)]
    shards = [[jrandom_circuit(r, "mig", num_inputs=4, num_gates=32, num_tt_pairs=16)
               for _ in range(3)] for r in rngs]
    dl = [batching.natural_dims(s) for s in shards]
    hb = jbatching.collate_shards(shards, dims={k: max(d[k] for d in dl) for k in dl[0]})
    params, state = J.init_params(jax.random.PRNGKey(2), jcfg)
    inputs = _inputs(params, state, kw, weights)
    inputs.update(_flat(hb, "batch/", {}), lr=lr)
    rng = jax.random.PRNGKey(9)
    for d in range(dp):
        neg, keep, _ = _jax_draws(jax.random.fold_in(rng, d), {k: v[d] for k, v in hb.items()},
                                  jcfg)
        inputs.update({f"neg{d}/{i}": x for i, x in enumerate(neg)})
        inputs.update({f"keep{d}/{i}": x for i, x in enumerate(keep)})
    opt = optax.sgd(lr)
    bal_cfg = JG.BalancerConfig(weights=tuple(weights))
    mesh_j = Mesh(np.asarray(jax.devices()[:dp]), ("dp",))
    step_j = jbal.make_balancer_train_step(jcfg, opt, bal_cfg, mesh_j)
    p_j, s_j, bal_j, _, m_j = step_j(params, state, JG.balancer_init(bal_cfg), opt.init(params),
                                     jax.tree.map(jnp.asarray, hb), rng)

    inp = tmp_path / "bal.npz"
    np.savez(inp, **inputs)
    script = tmp_path / "worker.py"
    script.write_text(BAL_WORKER)
    _torchrun([script, inp, tmp_path], dp, WORKER_TIMEOUT)
    pj = [np.asarray(x) for x in jax.tree.leaves(p_j)]
    sj = [np.asarray(x) for x in jax.tree.leaves(s_j)]
    for rank in range(dp):
        o = dict(np.load(tmp_path / f"{rank}.npz"))
        for k, v in m_j.items():
            np.testing.assert_allclose(o[f"m/{k}"], np.asarray(v), rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {rank} {k}")
        np.testing.assert_allclose(o["avg"], np.asarray(bal_j["avg"]["total"]), rtol=1e-5)
        delta = max(float(np.abs(o[f"p{i}"] - v).max()) for i, v in enumerate(pj))
        assert delta < 5e-6, (rank, delta)
        for i, v in enumerate(sj):
            np.testing.assert_allclose(o[f"s{i}"], v, rtol=0, atol=1e-6)
