"""The port's training runtime (mgvae_tpu_torch.train.trainer) against the
JAX package's ``Trainer`` on the CPU, and its parts: checkpoints, the npz
front-end, the batch layout and the prefetch thread.

The epoch comparison runs both trainers from the same params on the same
graphs with ``fixed_dims=False`` and ``steps_per_call=1`` (and, on the JAX
side, ``thin_wire=False``), so that neither depends on the JAX package's
native library. Their random draws cannot match bit for bit, so the test
patches the negative sampler and the readout dropout of both packages to
the same closed-form draws of the batch. The loss weights leave the prob
term out: the readout's hidden biases feed BatchNorm, so their gradient is 0
in exact arithmetic and rounding noise in each package, which Adam scales
up to +-lr per step whatever the implementation; with the prob weight 0 each
package's gradient there is exactly 0. Tolerances: meters rtol 1e-5 (as
tests/test_torch_train_step.py), params atol 1e-5 (the softmax-invariant
attention leaves apart, below), BatchNorm running statistics atol 1e-6.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgvae_tpu.data import npz as jnpz
from mgvae_tpu.data.synthetic import random_circuit as jrandom_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.ops import mlp as jmlp
from mgvae_tpu.train import losses as jlosses
from mgvae_tpu.train import trainer as jtrainer
from mgvae_tpu.utils import checkpoint as jckpt
import mgvae_tpu_torch
from mgvae_tpu_torch.data import batching, npz
from mgvae_tpu_torch.data.synthetic import random_circuit
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import mlp as pmlp
from mgvae_tpu_torch.train import losses as plosses
from mgvae_tpu_torch.train import step as pstep
from mgvae_tpu_torch.train import trainer as ptrainer
from mgvae_tpu_torch.utils import checkpoint as pckpt
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax

torch.set_num_threads(1)
RTOL = 1e-5
WEIGHTS = [1.0, 0.0, 4.0]
CFG = dict(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)


def _graphs(make, n, seed=0, gates=24):
    rng = np.random.default_rng(seed)
    return [make(rng, "mig", num_inputs=4, num_gates=gates + (i % 3) * 4, num_tt_pairs=16,
                 name=f"g{i}") for i in range(n)]


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


def _recorder(fn, out):
    def wrapped(graphs, *a, **kw):
        out.append([g.name for g in graphs])
        return fn(graphs, *a, **kw)
    return wrapped


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# Every attention logit into a node shifts by the same amount with these
# leaves (the query side and the key bias are the destination's), so the
# softmax cancels their gradient in exact arithmetic; what is left is each
# package's rounding noise, which Adam scales to at most lr per step. They
# are held to that bound over the run's 3 + 3 steps at lr 1e-3 and 1e-4.
_SOFTMAX_INVARIANT = {f"['experts']['{k}']" for k in ("wq", "bq", "wa_q", "ba", "bk")}


def test_trainer_epochs_match_jax_trainer(tmp_path, monkeypatch):
    monkeypatch.setattr(jlosses, "sample_negative_edges", _jax_negatives)
    monkeypatch.setattr(jmlp, "dropout", _jax_dropout)
    monkeypatch.setattr(plosses, "sample_negative_edges", _torch_negatives)
    monkeypatch.setattr(pmlp, "dropout", _torch_dropout)
    j_order, p_order = [], []
    monkeypatch.setattr(jtrainer, "collate", _recorder(jtrainer.collate, j_order))
    monkeypatch.setattr(ptrainer, "collate", _recorder(ptrainer.collate, p_order))

    jcfg, pcfg = J.DGConfig(**CFG), P.DGConfig(**CFG)
    params, state = J.init_params(jax.random.PRNGKey(0), jcfg)
    common = dict(save_dir=str(tmp_path), batch_size=4, distributed=False, seed=3,
                  fixed_dims=False, steps_per_call=1)
    jt = jtrainer.Trainer(None, jcfg, params=params, state=state, training_id="j",
                          thin_wire=False, **common)
    pt = ptrainer.Trainer(None, pcfg, params=params_from_jax(_np(params), device="cpu"),
                          state=state_from_jax(_np(state), device="cpu"), training_id="p",
                          device="cpu", **common)
    for t in (jt, pt):
        t.set_training_args(rc_prob_func_weight=WEIGHTS, lr=1e-3, lr_step=1)
    j_train, j_val = _graphs(jrandom_circuit, 12), _graphs(jrandom_circuit, 4, seed=1)
    p_train, p_val = _graphs(random_circuit, 12), _graphs(random_circuit, 4, seed=1)
    p0 = [np.asarray(x) for x in jax.tree.leaves(params)]

    for epoch in range(2):
        out_j = jt.train(1, j_train, j_val)
        out_p = pt.train(1, p_train, p_val)
        for phase in ("train", "val"):
            for k, v in out_j[phase].items():
                if k != "time":
                    np.testing.assert_allclose(out_p[phase][k], v, rtol=RTOL,
                                               err_msg=f"epoch {epoch} {phase} {k}")
        assert pt.lr == jt.lr == pytest.approx(1e-3 * 0.1 ** (epoch + 1))
        np.testing.assert_allclose(pt.optimizer.param_groups[0]["lr"],
                                   float(jt.opt_state.hyperparams["learning_rate"]), rtol=1e-6)
    assert pt.model_epoch == jt.model_epoch == 2
    assert p_order == j_order and len(p_order) == 2 * (3 + 1)

    p_leaves = [np.asarray(x) for x in jax.tree.leaves(params_to_numpy(pt.params))]
    j_paths = jax.tree_util.tree_leaves_with_path(jt.params)
    assert [a.shape for a in p_leaves] == [np.shape(c) for _, c in j_paths]
    moved = 0
    for a, (path, c), x0 in zip(p_leaves, j_paths, p0):
        name = jax.tree_util.keystr(path)
        if name in _SOFTMAX_INVARIANT:
            np.testing.assert_allclose(a, c, rtol=0, atol=2 * 3 * (1e-3 + 1e-4), err_msg=name)
            continue
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-5, err_msg=name)
        moved += int((np.abs(a - x0) > 1e-3).sum())
    # the runs trained: most params moved by far more than the tolerance
    assert moved > 0.5 * sum(a.size for a in p0)
    for a, c in zip(jax.tree.leaves(params_to_numpy(pt.state)), jax.tree.leaves(jt.state)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c), rtol=0, atol=1e-6)


def test_forced_split_has_the_jax_trainers_stratified_batches(tmp_path, monkeypatch):
    """--split 2 with fixed dims: the same graphs in each batch, epoch after
    epoch (the stratified layout draws from the same numpy stream)."""
    j_seen, p_seen = [], []
    monkeypatch.setattr(jtrainer, "collate_split", _recorder(jtrainer.collate_split, j_seen))
    monkeypatch.setattr(ptrainer, "collate_split", _recorder(ptrainer.collate_split, p_seen))
    common = dict(save_dir=str(tmp_path), batch_size=4, distributed=False, seed=5,
                  fixed_dims=True, steps_per_call=1, split=2)
    jt = jtrainer.Trainer(None, J.DGConfig(**CFG), training_id="j", thin_wire=False, **common)
    pt = ptrainer.Trainer(None, P.DGConfig(**CFG), training_id="p", device="cpu", **common)
    j_train, j_val = _graphs(jrandom_circuit, 16, gates=12), _graphs(jrandom_circuit, 8, 1, 12)
    p_train, p_val = _graphs(random_circuit, 16, gates=12), _graphs(random_circuit, 8, 1, 12)
    for _ in range(2):
        for jd, pd in ((j_train, p_train), (j_val, p_val)):
            list(jt._iter_batches(jd, shuffle=True))
            list(pt._iter_batches(pd))
    assert pt._split == 2 and pt._split_layout == jt._split_layout == "stratified"
    assert p_seen == j_seen and len(p_seen) == 2 * (4 + 2)


def _assert_running_max(t, datasets):
    """Each epoch plan's dims are the running max of the natural dims of
    every shard seen so far, under the plan's own order."""
    want: dict = {}
    for ds in datasets:
        before = dict(t._dims_max)
        idx, n_steps, dims, C = t._epoch_plan(ds)
        for s in range(n_steps):
            bs = t.batch_size
            shard = [ds[i] for i in idx[s * bs:(s + 1) * bs]]
            for k, v in ptrainer.shard_dims(shard, C).items():
                want[k] = max(want.get(k, 0), v)
        assert dims == want
        assert all(dims[k] >= v for k, v in before.items())   # monotone
    return C


def test_running_max_dims_are_monotone_natural_maxima(tmp_path):
    t = ptrainer.Trainer(None, P.DGConfig(**CFG), save_dir=str(tmp_path), batch_size=4,
                         distributed=False, steps_per_call=1, device="cpu")
    small, big = _graphs(random_circuit, 12, gates=12), _graphs(random_circuit, 8, 2, 40)
    assert _assert_running_max(t, [small, small, big, small]) == 1
    b = t._collate_step(small[:4], dict(t._dims_max), 1)
    assert batching._dims_of(b) == t._dims_max


def test_chunk_count_picked_once_and_again_past_the_gate(tmp_path, monkeypatch):
    """On CUDA the chunk count is picked on the first step and picked again
    only when the running max outgrows the kernel's size gate (here
    shrunk); the plan makes no CUDA call, so the device is only named."""
    limit = {"N": 10_000}
    monkeypatch.setattr(ptrainer, "kernel_fits", lambda n, ep, np_, d: n <= limit["N"])
    t = ptrainer.Trainer(None, P.DGConfig(**CFG), save_dir=str(tmp_path), batch_size=8,
                         distributed=False, steps_per_call=1, device="cpu")
    t.device = torch.device("cuda")
    small, big = _graphs(random_circuit, 16, gates=12), _graphs(random_circuit, 16, 2, 60)
    limit["N"] = ptrainer.shard_dims(small, 1)["N"]    # C = 1 fits any 8 small graphs
    assert _assert_running_max(t, [small, small]) == 1
    picks = []
    monkeypatch.setattr(t, "_pick_chunks", lambda *a, _f=t._pick_chunks: picks.append(1) or _f(*a))
    _assert_running_max(t, [small])
    assert picks == []                       # no growth, no re-pick
    t._epoch_plan(big)                       # the max grows past the gate
    assert picks == [1] and t._chunks > 1
    assert t._dims_max["N"] <= limit["N"]


def test_prefetch_reraises_the_producers_error(tmp_path):
    class Broken(list):
        def __getitem__(self, i):
            if i == 5:
                raise ValueError("graph 5 is broken")
            return list.__getitem__(self, i)

    t = ptrainer.Trainer(None, P.DGConfig(**CFG), save_dir=str(tmp_path), batch_size=2,
                         distributed=False, steps_per_call=1, fixed_dims=False, device="cpu")
    ds = Broken(_graphs(random_circuit, 8, gates=8))
    with pytest.raises(ValueError, match="graph 5 is broken"):
        list(t._iter_batches(ds))


def test_prefetch_thread_stops_when_the_epoch_is_left(tmp_path):
    t = ptrainer.Trainer(None, P.DGConfig(**CFG), save_dir=str(tmp_path), batch_size=2,
                         distributed=False, steps_per_call=1, fixed_dims=False, device="cpu")
    before = set(threading.enumerate())
    it = t._iter_batches(_graphs(random_circuit, 16, gates=8))
    next(it)
    it.close()
    assert set(threading.enumerate()) <= before


# ---- checkpoints -------------------------------------------------------------

_TEMPLATE = {"a": np.zeros(3, np.float32), "b": [np.zeros(2, np.float32),
                                                  np.zeros((2, 2), np.float32)]}


@pytest.mark.parametrize("loaded", [
    {"a": np.ones(3, np.float32), "b": [np.ones(2, np.float32), np.ones((3, 3), np.float32)]},
    {"b": [np.ones(2, np.float32)]},
    {"a": np.ones(3, np.float32), "b": [np.ones(2, np.float32), np.ones((2, 2), np.float32)],
     "c": np.ones(4, np.float32)},
], ids=["shape_mismatch", "missing_key", "unknown_key"])
def test_tolerant_merge_matches_jax(loaded):
    got = pckpt.tolerant_merge(_TEMPLATE, loaded)
    want = jckpt.tolerant_merge(_TEMPLATE, loaded)
    assert set(got) == set(want) == {"a", "b"}
    for a, c in zip((got["a"], *got["b"]), (want["a"], *want["b"]), strict=True):
        assert np.asarray(a).shape == np.asarray(c).shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_jax_and_reference_checkpoints_raise_value_error(tmp_path):
    """The JAX package's checkpoint and a reference state dict now load; a
    reference dict missing ``hs_linear.weight`` raises KeyError naming it,
    as the JAX package's reader does, and bytes of no known format raise
    ValueError."""
    from benchmarks.torch_reference import ReferenceModel
    from mgvae_tpu.utils.torch_compat import params_from_torch_state as jparams_from_torch_state

    params, state = J.init_params(jax.random.PRNGKey(0), J.DGConfig(**CFG))
    jpath = str(tmp_path / "jax.pth")
    jckpt.save_checkpoint(jpath, 0, params, state, (), 0.0)
    model = mgvae_tpu_torch.Model(device="cpu", **{k: v for k, v in CFG.items()})
    model.load(jpath)
    for a, c in zip(pstep.param_leaves(model.params), pstep.param_leaves(
            params_from_jax(_np(params), device="cpu")), strict=True):
        assert torch.equal(a, c)
    sd = ReferenceModel("mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True).state_dict()
    rpath = str(tmp_path / "ref.pth")
    torch.save({"epoch": 3, "state_dict": sd}, rpath)
    model.load(rpath)
    assert torch.equal(model.params["hs_linear"]["w"], sd["hs_linear.weight"].T)
    del sd["hs_linear.weight"]
    torch.save({"epoch": 3, "state_dict": sd}, rpath)
    with pytest.raises(KeyError, match="hs_linear.weight"):
        jparams_from_torch_state(sd, J.DGConfig(**CFG))
    with pytest.raises(KeyError, match="hs_linear.weight"):
        model.load(rpath)
    upath = str(tmp_path / "unknown.pth")
    with open(upath, "wb") as f:
        f.write(b"\x00not a checkpoint")
    with pytest.raises(ValueError, match="unknown format"):
        pckpt.load_checkpoint(upath, model.params, model.state, None, "cpu")
    with pytest.raises(ValueError, match="unknown format"):
        model.load(upath)


def test_model_save_load_roundtrip(tmp_path):
    a = mgvae_tpu_torch.Model(seed=3, device="cpu", **CFG)
    path = str(tmp_path / "m.pth")
    a.save(path)
    b = mgvae_tpu_torch.Model(seed=99, device="cpu", **CFG).load(path)
    for x, y in zip(pstep.param_leaves(a.params) + pstep.param_leaves(a.state),
                    pstep.param_leaves(b.params) + pstep.param_leaves(b.state)):
        assert torch.equal(x, y)


def test_resume_restores_everything_and_steps_alike(tmp_path):
    """A trainer loaded from another's checkpoint holds the same params, BN
    state, Adam state, epoch and lr bit for bit, and its next step is the
    same step, bit for bit."""
    kw = dict(save_dir=str(tmp_path), batch_size=4, distributed=False, steps_per_call=1,
              fixed_dims=False, device="cpu")
    a = ptrainer.Trainer(None, P.DGConfig(**CFG), training_id="a", **kw)
    a.set_training_args(rc_prob_func_weight=[1.0, 4.0, 4.0], lr=1e-3, lr_step=50)
    graphs = _graphs(random_circuit, 8)
    a.train(1, graphs, graphs[:4])
    a.model_epoch = 7
    a.save(str(tmp_path / "a" / "model_last.pth"))
    b = ptrainer.Trainer(None, P.DGConfig(**CFG), training_id="a", seed=9, **kw)
    assert b.resume() and b.model_epoch == 7 and b.lr == a.lr
    b.set_training_args(rc_prob_func_weight=a.rc_prob_func_weight)   # not in the file, as in JAX

    def snapshot(t):
        opt = t.optimizer.state_dict()["state"]
        return (pstep.param_leaves(t.params) + pstep.param_leaves(t.state)
                + [v for i in sorted(opt) for _, v in sorted(opt[i].items())])

    for x, y in zip(snapshot(a), snapshot(b), strict=True):
        assert x.device == y.device and x.dtype == y.dtype and torch.equal(x, y)
    batch = mgvae_tpu_torch.collate(graphs[:4])
    for t in (a, b):
        t.state, _ = t.train_step(t.params, t.state, batch,
                                  torch.Generator().manual_seed(1), t.weights)
    for x, y in zip(snapshot(a), snapshot(b), strict=True):
        assert torch.equal(x, y)


# ---- the npz front-end -------------------------------------------------------

@pytest.mark.parametrize("modality", ["aig", "mig"])
def test_npz_parser_matches_jax_and_caches_apart(tmp_path, modality):
    rng = np.random.default_rng(4)
    graphs = [random_circuit(rng, modality, num_inputs=4, num_gates=20, num_tt_pairs=8,
                             name=f"c{i}") for i in range(6)]
    cpath, lpath = str(tmp_path / "graphs.npz"), str(tmp_path / "labels.npz")
    npz.save_npz(graphs, cpath, lpath, modality)
    got = npz.NpzParser(str(tmp_path), cpath, lpath, modality, seed=2).get_dataset()
    want = jnpz.NpzParser(str(tmp_path), cpath, lpath, modality, seed=2).get_dataset()
    again = npz.NpzParser(str(tmp_path), cpath, lpath, modality, seed=2).get_dataset()  # cached
    assert (tmp_path / "inmemory_torch" / "data.npy").exists()
    assert (tmp_path / "inmemory" / "data.npy").exists()
    for split in range(2):
        assert [g.name for g in got[split]] == [g.name for g in want[split]] \
            == [g.name for g in again[split]]
        for g, w, r in zip(got[split], want[split], again[split]):
            assert type(g).__module__ == type(r).__module__ == "mgvae_tpu_torch.data.graph"
            for f in ("gate", "edge_index", "forward_level", "backward_level", "prob",
                      "tt_pair_index", "tt_dis"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
                np.testing.assert_array_equal(getattr(r, f), getattr(w, f))
