"""The port's multi-task trainers (``BalancerTrainer``, ``GradNormTrainer``),
``EarlyTrainer`` and ``Trainer(trace_dir=)`` against the JAX package's on
the CPU.

The epochs run both packages from the same params on the same graphs with
``fixed_dims=False`` and ``steps_per_call=1`` (and ``thin_wire=False``), the
negative sampler and the readout dropout of both packages patched to the
same closed-form draws (``tests/test_torch_trainer.py``'s, whose reasons
hold here): meters rtol 1e-5, the epoch lines with their times cut, params
atol 1e-5 with the leaves whose gradient is rounding noise held to Adam's
bound (2 * lr a step: the attention's softmax-invariant leaves and, where
the prob term trains, the readout's biases before BatchNorm).
"""
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from mgvae_tpu.data.synthetic import random_circuit as jrandom_circuit
from mgvae_tpu.models import dg_ae as J
from mgvae_tpu.ops import mlp as jmlp
from mgvae_tpu.train import losses as jlosses
from mgvae_tpu.train import trainer_balancer as jbal
from mgvae_tpu.train import trainer_early_stop as jearly
from mgvae_tpu.train import trainer_gradnorm as jgn
from mgvae_tpu_torch.data.synthetic import random_circuit
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.ops import mlp as pmlp
from mgvae_tpu_torch.train import losses as plosses
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.train import trainer as ptrainer
from mgvae_tpu_torch.train import trainer_balancer as pbal
from mgvae_tpu_torch.train import trainer_early_stop as pearly
from mgvae_tpu_torch.train import trainer_gradnorm as pgn
from mgvae_tpu_torch.utils.params import params_from_jax, params_to_numpy, state_from_jax
from test_torch_trainer import (_SOFTMAX_INVARIANT, _graphs, _jax_dropout, _jax_negatives,
                                _torch_dropout, _torch_negatives)

torch.set_num_threads(1)
RTOL = 1e-5
LR = 1e-3
CFG = dict(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
# the prob term's weight 0 for the Balancer: its scale is then 0, and the
# readout's biases before BatchNorm get no noise to move on
BAL_WEIGHTS = [1.0, 0.0, 4.0]
PRE_BN_BIASES = {f"['readout_prob']['layers'][{i}]['b']" for i in (0, 1)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _graphs16(make, n, seed=9):
    """MIG circuits of 4 inputs and 16 gates; from seed 9 every batch of 4
    over the trainers' two shuffles pads to one shape, so that the JAX
    package compiles each step function once."""
    rng = np.random.default_rng(seed)
    return [make(rng, "mig", num_inputs=4, num_gates=16, num_tt_pairs=16, name=f"g{seed}_{i}")
            for i in range(n)]


@pytest.fixture
def same_draws(monkeypatch):
    monkeypatch.setattr(jlosses, "sample_negative_edges", _jax_negatives)
    monkeypatch.setattr(jmlp, "dropout", _jax_dropout)
    monkeypatch.setattr(plosses, "sample_negative_edges", _torch_negatives)
    monkeypatch.setattr(pmlp, "dropout", _torch_dropout)


def _pair(tmp_path, jcls, pcls, seed=0, **kw):
    jcfg, pcfg = J.DGConfig(**CFG), P.DGConfig(**CFG)
    params, state = J.init_params(jax.random.PRNGKey(seed), jcfg)
    p0 = [np.asarray(x) for x in jax.tree.leaves(params)]
    common = dict(save_dir=str(tmp_path), batch_size=4, distributed=False, seed=3,
                  fixed_dims=False, steps_per_call=1, **kw)
    pt = pcls(None, pcfg, params=params_from_jax(_np(params), device="cpu"),
              state=state_from_jax(_np(state), device="cpu"), training_id="p", device="cpu",
              **common)
    jt = jcls(None, jcfg, params=params, state=state, training_id="j", thin_wire=False,
              **common)
    return jt, pt, p0


def _lines(t, head):
    """The trainer's epoch lines starting with ``head``, times cut."""
    logs = [f for f in os.listdir(t.log_dir) if f.startswith("log-")]
    assert len(logs) == 1
    with open(os.path.join(t.log_dir, logs[0])) as f:
        return [re.sub(r"\|Net: [\d.]+s$", "", ln.rstrip("\n")) for ln in f
                if ln.startswith(head)]


def _params_close(pt, jt, p0, noise=frozenset(), steps=4):
    p_leaves = jax.tree.leaves(params_to_numpy(pt.params))
    j_paths = jax.tree_util.tree_leaves_with_path(jt.params)
    moved = 0
    for a, (path, c), x0 in zip(p_leaves, j_paths, p0, strict=True):
        name = jax.tree_util.keystr(path)
        atol = 2 * steps * LR if name in _SOFTMAX_INVARIANT | noise else 1e-5
        np.testing.assert_allclose(a, np.asarray(c), rtol=0, atol=atol, err_msg=name)
        moved += int((np.abs(a - x0) > 1e-4).sum())
    assert moved > 0.5 * sum(x.size for x in p0)


@pytest.mark.parametrize("kind", ["balancer", "gradnorm"])
def test_multitask_trainer_epochs_match_jax(kind, tmp_path, same_draws):
    if kind == "balancer":
        jt, pt, p0 = _pair(tmp_path, jbal.BalancerTrainer, pbal.BalancerTrainer,
                           rc_prob_func_weight=BAL_WEIGHTS, ema_decay=0.9)
    else:
        jt, pt, p0 = _pair(tmp_path, jgn.GradNormTrainer, pgn.GradNormTrainer, gn_lr=0.05)
    for t in (jt, pt):
        t.set_training_args(lr=LR)
    j_train, p_train = _graphs16(jrandom_circuit, 8), _graphs16(random_circuit, 8)
    out_j = jt.train(2, j_train, [])
    out_p = pt.train(2, p_train, [])
    assert set(out_p) == set(out_j)
    for k, v in out_j.items():
        if k != "time":
            np.testing.assert_allclose(out_p[k], v, rtol=RTOL, err_msg=k)
    assert pt.model_epoch == jt.model_epoch == 2
    lines = _lines(pt, kind)
    assert lines == _lines(jt, kind) and len(lines) == 2
    if kind == "gradnorm":
        np.testing.assert_allclose(pt.task_weights, jt.task_weights, rtol=RTOL)
        assert abs(sum(pt.task_weights) - 3.0) < 1e-5 and pt.task_weights != [1.0] * 3
        np.testing.assert_allclose(out_p["task_weights"], out_j["task_weights"], rtol=RTOL)
    else:
        np.testing.assert_allclose(pt.bal_state["avg"]["total"].numpy(),
                                   np.asarray(jt.bal_state["avg"]["total"]), rtol=RTOL)
    # no val phase, no checkpoint, as in the JAX package
    assert not any(f.endswith(".pth") for f in os.listdir(pt.log_dir))
    _params_close(pt, jt, p0, noise=PRE_BN_BIASES if kind == "gradnorm" else frozenset())


@pytest.mark.parametrize("delta", [0.0, 10.0], ids=["improves", "stops"])
def test_early_trainer_matches_jax(delta, tmp_path, same_draws, capsys):
    jt, pt, p0 = _pair(tmp_path, jearly.EarlyTrainer, pearly.EarlyTrainer, patience=1,
                       delta=delta)
    for t in (jt, pt):
        t.set_training_args(rc_prob_func_weight=[1.0, 0.0, 4.0], lr=LR)
    j_train, j_val = _graphs16(jrandom_circuit, 8), _graphs16(jrandom_circuit, 4, seed=1)
    p_train, p_val = _graphs16(random_circuit, 8), _graphs16(random_circuit, 4, seed=1)
    best = []
    for t in (jt, pt):
        def recorded(path, _t=t, _save=t.save):
            best.append((_t is pt, _t.model_epoch, os.path.basename(path)))
            return _save(path)
        t.save = recorded
    out_j = jt.train(3, j_train, j_val)
    out_p = pt.train(3, p_train, p_val)
    for k in ("recon", "prob", "func", "acc"):
        np.testing.assert_allclose(out_p[k], out_j[k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(pt.best_loss, jt.best_loss, rtol=RTOL)
    assert (pt.early_stop, pt.early_stop_counter, pt.model_epoch) == \
        (jt.early_stop, jt.early_stop_counter, jt.model_epoch)
    assert pt.model_epoch == (2 if delta else 3) and pt.early_stop == bool(delta)
    bests = [[e for side, e, name in best if side == s and name == "model_best.pth"]
             for s in (False, True)]
    assert bests[0] == bests[1] == ([1] if delta else [1, 2, 3])
    assert os.path.isfile(os.path.join(pt.log_dir, "model_best.pth"))
    assert capsys.readouterr().out.count("[INFO] Early stopping at epoch 2/3") == (2 if delta
                                                                                   else 0)
    _params_close(pt, jt, p0, steps=2 * pt.model_epoch)


def _traced(tmp_path, monkeypatch, trace_dir):
    """A CPU trainer on 12 graphs at bs4 whose captures record the
    ``model_epoch`` they stop at."""
    stops = []
    cfg = P.DGConfig(**CFG)
    tr = ptrainer.Trainer(None, cfg, training_id="t", save_dir=str(tmp_path), batch_size=4,
                          distributed=False, seed=3, device="cpu", trace_dir=trace_dir)
    real = tr._start_trace

    def start():
        trace = real()
        if trace is not None:
            stop = trace.stop
            trace.stop = lambda: (stops.append(tr.model_epoch), stop())[1]
        return trace

    monkeypatch.setattr(tr, "_start_trace", start)
    return tr, stops


def test_trace_dir_captures_epoch_zero_and_changes_nothing(tmp_path, monkeypatch):
    ds = _graphs(random_circuit, 12)
    trace_dir = tmp_path / "trace"
    traced, stops = _traced(tmp_path / "a", monkeypatch, str(trace_dir))
    plain, none = _traced(tmp_path / "b", monkeypatch, None)
    out_t = traced.train(2, ds, ds[:4])
    out_p = plain.train(2, ds, ds[:4])
    assert stops == [0] and none == []
    files = sorted(os.listdir(trace_dir))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(trace_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    for phase in ("train", "val"):
        assert out_t[phase] == {**out_p[phase], "time": out_t[phase]["time"]}
    for a, c in zip(PS.param_leaves(traced.params) + PS.param_leaves(traced.state),
                    PS.param_leaves(plain.params) + PS.param_leaves(plain.state)):
        assert torch.equal(a, c)
    # the next call captures its own first epoch; a raising call stops its capture
    traced.train(1, ds, ds[:4])
    calls = []

    def failing(*a, **k):
        calls.append(1)
        raise RuntimeError("a step failed")

    monkeypatch.setattr(traced, "train_step", failing)
    with pytest.raises(RuntimeError, match="a step failed"):
        traced.train(1, ds, ds[:4])
    assert stops == [0, 2, 3] and calls == [1] and len(os.listdir(trace_dir)) == 3


def test_multitask_subclasses_capture_nothing(tmp_path, monkeypatch):
    cfg = P.DGConfig(**CFG)
    for cls in (pbal.BalancerTrainer, pgn.GradNormTrainer):
        tr = cls(None, cfg, training_id=cls.__name__, save_dir=str(tmp_path), batch_size=4,
                 distributed=False, seed=3, device="cpu", trace_dir=str(tmp_path / "tr"))
        monkeypatch.setattr(tr, "_start_trace", lambda: pytest.fail("captured"))
        out = tr.train(1, _graphs(random_circuit, 4), [])
        assert np.isfinite([out["recon"], out["prob"], out["func"]]).all()
    assert not (tmp_path / "tr").exists()
