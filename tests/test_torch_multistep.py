"""The port's K-step calls (``train.step.make_multi_step`` /
``make_multi_eval``) and the trainer's grouped epochs on the CPU: against
the JAX package's ``make_multi_step`` / ``make_multi_eval`` on one stacked
group, against K calls of the port's own ``train_step`` / ``eval_step``
bit for bit (plain, chunked on the step route and split groups), the
trainer at ``steps_per_call=3`` against ``steps_per_call=1`` with the JAX
trainer's grouping rules, the CLI's ``--steps_per_call``, and the parts:
the static device batch, the padded level walk and the optimizer's
settings across a loaded state dict.

The JAX comparison patches both packages' negative sampler and readout
dropout to the same closed-form draws and leaves the prob term out of the
loss, as ``tests/test_torch_trainer.py`` does (the readout's hidden biases
feed BatchNorm, so their gradient is rounding noise that Adam scales to
+-lr). Tolerances: metrics rtol 1e-5, params atol 1e-5 (the
softmax-invariant attention leaves within K * lr, Adam's bound), BatchNorm
running statistics atol 1e-6. Bit for bit needs one CPU thread: the
threaded index backward is not repeatable.
"""
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mgvae_tpu.data import batching as jbatching
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.ops import mlp as jmlp
from mgvae_tpu.train import losses as jlosses
from mgvae_tpu.train import step as JS
from mgvae_tpu_torch import cli
from mgvae_tpu_torch.data import batching
from mgvae_tpu_torch.data.synthetic import random_circuit
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import level_kernel
from mgvae_tpu_torch.ops import mlp as pmlp
from mgvae_tpu_torch.train import losses as plosses
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.train import trainer as ptrainer
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax

torch.set_num_threads(1)
CFG = dict(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
WEIGHTS = [1.0, 4.0, 2.0, 0.0]
SMOOTH = [1.0, 0.0, 4.0, 0.0]     # the JAX comparison: no prob term
LR = 1e-3
RTOL = 1e-5
K = 3
_SOFTMAX_INVARIANT = ("wq", "bq", "wa_q", "ba", "bk")


def _graphs(n, seed=0, gates=24):
    rng = np.random.default_rng(seed)
    return [random_circuit(rng, "mig", num_inputs=4, num_gates=gates + (i % 3) * 4,
                           num_tt_pairs=16, name=f"g{i}") for i in range(n)]


def _shards(graphs, bs=4):
    return [graphs[i * bs:(i + 1) * bs] for i in range(len(graphs) // bs)]


def _dims(shards, num_chunks=1):
    d = {}
    for sh in shards:
        new = (batching.natural_dims(sh) if num_chunks == 1
               else batching.chunked_shard_dims(sh, num_chunks)
               or batching._chunked_dims_of(batching.collate_chunked(sh, num_chunks),
                                            num_chunks))
        for k, v in new.items():
            d[k] = max(d.get(k, 0), v)
    return d


def _group(layout, shards):
    """(stacked group, the per-step batches) of one layout."""
    if layout == "split":
        dims = batching.split_dims(shards, 2)
        return (batching.collate_split_step(shards, dims),
                [batching.collate_split(s, 2, dims=dims) for s in shards])
    C = 2 if layout == "chunked" else 1
    dims = _dims(shards, C)
    sb = batching.collate_shards(shards, dims=dims, num_chunks=C)
    if C == 1:
        return sb, [batching.collate(s, dims=dims) for s in shards]
    return sb, [batching.collate_chunked(s, C, dims=dims) for s in shards]


# the same draws in both packages: closed forms of the batch's arrays
def _jax_negatives(rng, num_samples, batch):
    i = jnp.arange(num_samples, dtype=jnp.int32)
    n = jnp.maximum(batch["n_nodes"].astype(jnp.int32), 2)
    src = (batch["edge_dst"] * 5 + i * 3 + 1) % n
    off = (batch["edge_src"] * 7 + i * 11) % (n - 1)
    return src, (src + 1 + off) % n


def _torch_negatives(gen, num_samples, b):
    i = torch.arange(num_samples, dtype=torch.int32)
    n = torch.as_tensor(b["n_nodes"]).to(torch.int32).clamp(min=2)
    src = (b["edge_dst"] * 5 + i * 3 + 1) % n
    off = (b["edge_src"] * 7 + i * 11) % (n - 1)
    return src, (src + 1 + off) % n


def _keep(n, d, xp):
    r, c = xp.arange(n)[:, None], xp.arange(d)[None, :]
    return (r * 7 + c * 13 + r // 3) % 5 != 0


def _jax_dropout(key, x, p, train):
    if not train or p <= 0.0:
        return x
    return jnp.where(_keep(*x.shape, jnp), x / (1.0 - p), 0.0)


def _torch_dropout(x, p, train, gen=None, keep=None):
    if not train or p <= 0.0:
        return x
    return torch.where(_keep(*x.shape, torch), x / (1.0 - p), 0.0)


def _closed_form_draws(monkeypatch):
    monkeypatch.setattr(jlosses, "sample_negative_edges", _jax_negatives)
    monkeypatch.setattr(jmlp, "dropout", _jax_dropout)
    monkeypatch.setattr(plosses, "sample_negative_edges", _torch_negatives)
    monkeypatch.setattr(pmlp, "dropout", _torch_dropout)


def _jax_side():
    jcfg = J.DGConfig(**CFG)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    shards = _shards(_graphs(4 * K))
    dims = _dims(shards)
    jsb = jax.tree.map(jnp.asarray, jbatching.collate_shards(shards, dims=dims))
    return jcfg, params, state, shards, dims, jsb


def _port(params, state):
    np_ = jax.tree.map(np.asarray, (params, state))
    return (params_from_jax(np_[0], device="cpu"), state_from_jax(np_[1], device="cpu"))


def test_multi_step_matches_jax_make_multi_step(monkeypatch):
    _closed_form_draws(monkeypatch)
    jcfg, params, state, shards, dims, jsb = _jax_side()
    opt = JS.make_optimizer(LR)
    j_multi = JS.make_multi_step(jcfg, opt, mesh=None, donate=False)
    rngs = jax.random.split(jax.random.PRNGKey(1), K)
    p_j, s_j, _, m_j = j_multi(params, state, opt.init(params), jsb, rngs, jnp.asarray(SMOOTH))

    pp, ps = _port(params, state)
    multi = PS.make_multi_step(P.DGConfig(**CFG), PS.make_optimizer(pp, LR))
    ps, m_p = multi(pp, ps, batching.collate_shards(shards, dims=dims),
                    torch.Generator().manual_seed(0), SMOOTH)
    assert m_p.shape == (K, len(PS.METRIC_KEYS))
    np.testing.assert_allclose(m_p.numpy(), np.asarray(m_j), rtol=RTOL)
    got, want = params_to_numpy(pp), jax.tree.map(np.asarray, p_j)
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        name = jax.tree_util.keystr(path)
        b = got
        for k in path:
            b = b[k.key] if hasattr(k, "key") else b[k.idx]
        inv = any(f"['{n}']" in name for n in _SOFTMAX_INVARIANT) and "experts" in name
        np.testing.assert_allclose(b, a, rtol=0, atol=K * LR if inv else 1e-5, err_msg=name)
    for a, b in zip(PS.param_leaves(ps), jax.tree.leaves(jax.tree.map(np.asarray, s_j)),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)


def test_multi_eval_matches_jax_make_multi_eval(monkeypatch):
    _closed_form_draws(monkeypatch)
    jcfg, params, state, shards, dims, jsb = _jax_side()
    j_eval = JS.make_multi_eval(jcfg, mesh=None)
    m_j = j_eval(params, state, jsb, jax.random.split(jax.random.PRNGKey(1), K),
                 jnp.asarray(WEIGHTS))
    pp, ps = _port(params, state)
    m_p = PS.make_multi_eval(P.DGConfig(**CFG))(
        pp, ps, batching.collate_shards(shards, dims=dims), torch.Generator().manual_seed(0),
        WEIGHTS)
    np.testing.assert_allclose(m_p.numpy(), np.asarray(m_j), rtol=RTOL)


def _equal_trees(a, b):
    la, lb = PS.param_leaves(a), PS.param_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _adam(opt, params):
    return [t for p in PS.param_leaves(params) for t in opt.state[p].values()]


@pytest.mark.parametrize("layout", ["plain", "chunked", "split"])
def test_multi_step_equals_k_train_steps_bit_for_bit(layout, monkeypatch):
    """Params, Adam's state, BN state, metric rows and the generator's state
    after one group equal those after K ``train_step`` calls. The chunked
    group's chunks fail the patched size gate and take the step route; the
    split group has G = 2."""
    if layout == "chunked":
        monkeypatch.setattr(level_kernel, "KERNEL_MAX_NODES", 64)
    cfg = P.DGConfig(**CFG)
    sb, batches = _group(layout, _shards(_graphs(4 * K, gates=40)))
    out = []
    for grouped in (True, False):
        params, state = P.init_params(cfg, seed=2, device="cpu")
        opt = PS.make_optimizer(params, LR)
        gen = torch.Generator().manual_seed(5)
        if grouped:
            state, rows = PS.make_multi_step(cfg, opt)(params, state, sb, gen, WEIGHTS)
        else:
            train_step, _ = PS.make_train_step(cfg, opt)
            rows = []
            for b in batches:
                state, m = train_step(params, state, b, gen, WEIGHTS)
                rows.append(torch.stack([m[k] for k in PS.METRIC_KEYS]))
            rows = torch.stack(rows)
        out.append((params, state, rows, _adam(opt, params), gen.get_state()))
    (p1, s1, r1, a1, g1), (p2, s2, r2, a2, g2) = out
    assert torch.equal(r1, r2)
    assert _equal_trees(p1, p2) and _equal_trees(s1, s2) and _equal_trees(a1, a2)
    assert torch.equal(g1, g2)


def test_multi_step_takes_explicit_draws_per_step():
    """DG_VAE with no generator: each step's explicit negatives, dropout
    masks and variational noise (lists of K) reach its step as they reach
    ``train_step``, bit for bit."""
    cfg = P.DGConfig(**CFG, variational=True)
    sb, batches = _group("plain", _shards(_graphs(4 * K)))
    rng = np.random.default_rng(3)
    N, E = batches[0]["gate"].shape[0], batches[0]["edge_src"].shape[0]
    neg = [tuple(torch.as_tensor(rng.integers(0, 20, E), dtype=torch.int32) for _ in range(2))
           for _ in range(K)]
    keep = [[torch.as_tensor(rng.random((N, cfg.dim_mlp)) < 0.8) for _ in range(2)]
            for _ in range(K)]
    eps = [tuple(torch.as_tensor(rng.standard_normal((N, 16)), dtype=torch.float32)
                 for _ in range(2)) for _ in range(K)]
    out = []
    for grouped in (True, False):
        params, state = P.init_params(cfg, seed=2, device="cpu")
        opt = PS.make_optimizer(params, LR)
        if grouped:
            state, rows = PS.make_multi_step(cfg, opt)(params, state, sb, None, WEIGHTS[:3] + [
                0.5], neg_edges=neg, drop_keep=keep, vae_eps=eps)
        else:
            train_step, _ = PS.make_train_step(cfg, opt)
            rows = []
            for k, b in enumerate(batches):
                state, m = train_step(params, state, b, None, WEIGHTS[:3] + [0.5],
                                      neg_edges=neg[k], drop_keep=keep[k], vae_eps=eps[k])
                rows.append(torch.stack([m[x] for x in PS.METRIC_KEYS]))
            rows = torch.stack(rows)
        out.append((rows, params, state))
    assert torch.equal(out[0][0], out[1][0]) and bool(out[0][0][:, 3].ne(0).all())
    assert _equal_trees(out[0][1], out[1][1]) and _equal_trees(out[0][2], out[1][2])


@pytest.mark.parametrize("layout", ["plain", "chunked", "split"])
def test_multi_eval_equals_k_eval_steps_bit_for_bit(layout, monkeypatch):
    if layout == "chunked":
        monkeypatch.setattr(level_kernel, "KERNEL_MAX_NODES", 64)
    cfg = P.DGConfig(**CFG)
    sb, batches = _group(layout, _shards(_graphs(4 * K, gates=40)))
    params, state = P.init_params(cfg, seed=2, device="cpu")
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    rows = PS.make_multi_eval(cfg)(params, state, sb, g1, WEIGHTS)
    _, eval_step = PS.make_train_step(cfg, PS.make_optimizer(params, LR))
    want = torch.stack([torch.stack([m[k] for k in PS.METRIC_KEYS])
                        for m in (eval_step(params, state, b, g2, WEIGHTS) for b in batches)])
    assert torch.equal(rows, want) and torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("layout", ["plain", "chunked", "split"])
def test_static_batch_views_equal_batch_to_device(layout):
    """The static buffers hold, after one staged load, what
    ``batch_to_device`` gives for that step: same keys, dtypes, shapes,
    values."""
    sb, batches = _group(layout, _shards(_graphs(4 * K)))
    static = P.StaticBatch(PS.step_of(sb, 0), "cpu")
    area = static.stage(sb, K)
    for k in range(K):
        static.load(area[k])
        want = P.batch_to_device(batches[k], "cpu")
        got = static.views
        pairs = [(got, want)] + (list(zip(got["groups"], want["groups"], strict=True))
                                 if layout == "split" else [])
        for g, w in pairs:
            assert set(g) == set(w)
            for key in w:
                if key != "groups":
                    assert g[key].dtype == w[key].dtype and torch.equal(g[key], w[key]), key
    static.staged_loaded()


def test_table_levels_walk_equals_the_real_levels():
    """The padded walk a captured step bakes in: every row of the level
    tables, one count per chunk or group; on the fused route hs and hf
    equal the real-level walk's bit for bit, and so does a gradient."""
    cfg = P.DGConfig(**CFG)
    params, _ = P.init_params(cfg, seed=2, device="cpu")
    params["experts"]["w_ih"].requires_grad_(True)
    shards = _shards(_graphs(8, gates=40))
    sb, batches = _group("plain", shards)
    b = min(batches, key=lambda x: P.level_counts(x)[0])   # padded at the group's L
    L = b["lv_nodes"].shape[0]
    assert P.table_levels(b) == (L,) and P.level_counts(b)[0] < L
    assert P.table_levels(_group("chunked", shards)[1][0]) == (
        _group("chunked", shards)[1][0]["lv_nodes"].shape[1],) * 2
    split = _group("split", shards)[1][0]
    assert P.table_levels(split) == tuple((g["lv_nodes"].shape[0],) for g in split["groups"])
    db = P.batch_to_device(b, "cpu")
    outs = []
    for levels in (P.level_counts(b), P.table_levels(b)):
        hs, hf, _ = P.forward_device(params, db, cfg, levels)
        (g,) = torch.autograd.grad(hf.square().sum(), [params["experts"]["w_ih"]])
        outs.append((hs, hf, g))
    assert all(torch.equal(x, y) for x, y in zip(*outs))


def test_optimizer_keeps_its_settings_across_a_loaded_state_dict():
    """A state dict whose groups hold a device optimizer's settings (a
    tensor lr, ``capturable``) loads into the CPU optimizer as a float lr
    with its own settings; the moments and the lr's value come through."""
    cfg = P.DGConfig(**CFG)
    params, _ = P.init_params(cfg, seed=2, device="cpu")
    opt = PS.make_optimizer(params, LR)
    saved = opt.state_dict()
    for g in saved["param_groups"]:
        g.update(lr=torch.tensor(2.0 ** -12), capturable=True, foreach=True)
    opt.load_state_dict(saved)
    (group,) = opt.param_groups
    assert group["lr"] == 2.0 ** -12 and not isinstance(group["lr"], torch.Tensor)
    assert not group["capturable"] and group["foreach"] is None
    PS.set_lr(opt, 1e-5)
    assert opt.param_groups[0]["lr"] == 1e-5


def _trainer(tmp_path, name, spc, **kw):
    cfg = P.DGConfig(**CFG)
    params, state = P.init_params(cfg, seed=4, device="cpu")
    t = ptrainer.Trainer(types.SimpleNamespace(model="DG_AE"), cfg, params=params,
                         state=state, training_id=name, save_dir=str(tmp_path), batch_size=2,
                         distributed=kw.pop("distributed", False), seed=3, steps_per_call=spc,
                         device="cpu", **kw)
    calls = {"group": [], "single": 0}
    multi, single = t.multi_step, t.train_step

    def spy_multi(params, state, sbatch, *a, **k):
        calls["group"].append(int(np.shape(sbatch["gate"])[0]))
        return multi(params, state, sbatch, *a, **k)

    def spy_single(*a, **k):
        calls["single"] += 1
        return single(*a, **k)

    t.multi_step, t.train_step = spy_multi, spy_single
    return t, calls


@pytest.mark.parametrize("split", [0, 2], ids=["plain", "split"])
def test_trainer_groups_equal_single_steps(tmp_path, capsys, split):
    """7 train steps (2 groups of 3 and 1 single) and a val phase of 2 steps
    (< K: per step) over two epochs with an lr decay: every meter, param,
    Adam moment, BN statistic and the generator bit for bit; the progress
    lines fall at the same steps."""
    train_ds, val_ds = _graphs(14, seed=1), _graphs(4, seed=2)
    runs = []
    for spc in (K, 1):
        t, calls = _trainer(tmp_path, f"k{spc}", spc, split=split, log_every=K)
        t.set_training_args(rc_prob_func_weight=WEIGHTS[:3], lr=LR, lr_step=1)
        capsys.readouterr()
        outs = [t.train(1, train_ds, val_ds) for _ in range(2)]
        lines = [ln for ln in capsys.readouterr().out.splitlines() if " it " in ln]
        runs.append((t, calls, outs, lines))
    (tg, cg, og, lg), (ts, cs, os_, ls) = runs
    assert cg == {"group": [K, K] * 2, "single": 2} and cs == {"group": [], "single": 14}
    untimed = [[{k: v for k, v in o[ph].items() if k != "time"} for o in outs
                for ph in ("train", "val")] for outs in (og, os_)]
    assert untimed[0] == untimed[1] and lg == ls and len(lg) == 4, (lg, ls)
    assert re.search(rf"it {K} ", lg[0]) and re.search(rf"it {2 * K} ", lg[1])
    assert _equal_trees(tg.params, ts.params) and _equal_trees(tg.state, ts.state)
    assert _equal_trees(_adam(tg.optimizer, tg.params), _adam(ts.optimizer, ts.params))
    assert torch.equal(tg._gen.get_state(), ts._gen.get_state())
    assert tg.lr == ts.lr == LR * 0.01


@pytest.mark.parametrize("rule", ["free_dims", "fewer_steps_than_k", "group_of_one"])
def test_trainer_steps_singly_where_the_jax_trainer_does(tmp_path, monkeypatch, rule):
    """Per step throughout with free dims, with fewer steps than K, and
    under a (gloo) process group of a multi-host launch (torchrun's
    ``WORLD_SIZE`` past its ``LOCAL_WORLD_SIZE``), as the JAX trainer's
    ``use_multi`` (``jax.process_count() == 1``). A single-host group
    groups (``tests/test_torch_multistep_dp.py``)."""
    train_ds = _graphs(14, seed=1)
    kw = {"free_dims": dict(fixed_dims=False), "fewer_steps_than_k": dict(spc=8),
          "group_of_one": dict(distributed=True)}[rule]
    spc = kw.pop("spc", K)
    if rule == "group_of_one":
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                                world_size=1)
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    try:
        t, calls = _trainer(tmp_path, rule, spc, **kw)
        assert (t.group is not None) == (rule == "group_of_one")
        assert not t.grouped or rule != "group_of_one"
        t.train(1, train_ds, [])
    finally:
        if rule == "group_of_one":
            dist.destroy_process_group()
    assert calls == {"group": [], "single": 7}


CLI = ["--exp_id", "v", "--model", "DG_AE", "--type", "mig", "--batch_size", "2",
       "--layernorm", "--dim_hidden", "16", "--s_rounds", "1", "--t_rounds", "1",
       "--stage_epochs", "1,1,1", "--synthetic_circuits", "24"]


def test_cli_honours_steps_per_call(tmp_path, monkeypatch, capsys):
    """``--steps_per_call 4``: the train phases run in groups (10 train
    steps a stage: 2 groups of 4 and 2 singles), no "not ported" note,
    and every epoch line equals the per-step run's but for its time."""
    monkeypatch.setenv("MGVAE_PLATFORM", "cpu")
    make = ptrainer.make_multi_step
    groups = []

    def counting(cfg, optimizer, group=None):
        multi = make(cfg, optimizer, group=group)

        def call(params, state, sbatch, *a, **kw):
            groups.append(int(np.shape(sbatch["gate"])[0]))
            return multi(params, state, sbatch, *a, **kw)
        return call

    monkeypatch.setattr(ptrainer, "make_multi_step", counting)
    lines = {}
    for spc in ("4", "1"):
        save = tmp_path / spc
        trainer = cli.main(CLI + ["--steps_per_call", spc, "--save_dir", str(save)])
        assert trainer.steps_per_call == int(spc)
        assert "not ported" not in capsys.readouterr().out
        (log,) = (save / "v").glob("log-*.txt")
        lines[spc] = [re.sub(r"\|Net: .*", "", ln) for ln in log.read_text().splitlines()
                      if "| Epoch:" in ln]
    assert groups == [4, 4] * 3
    assert len(lines["4"]) == 6 and lines["4"] == lines["1"]
