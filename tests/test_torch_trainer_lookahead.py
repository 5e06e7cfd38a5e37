"""The trainer's look-ahead (``Trainer._look_ahead``): the prefetch thread
plans the phase that follows and collates its first item while the steps
of this phase run, across epochs and ``train`` calls.

The steps are stubs that record what the step thread hands them, so that
an epoch costs only its collates. Each collate in the trainer module is
wrapped to carry its graphs' names beside the batch, so the steps see each
step's shard ids whichever thread collated it. What the trainer must give
is a plain replay: one permutation of ``default_rng(seed + 2)`` per phase,
train and val in turn, drop_last, the dims the running max of every shard
planned so far, and the batches ``collate_shards`` / ``collate`` make of
those shards at those dims, bit for bit.
"""
import gc
import json
import os
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from mgvae_tpu_torch.data import batching
from mgvae_tpu_torch.data.synthetic import random_circuit
from mgvae_tpu_torch.models.dg_ae import DGConfig
from mgvae_tpu_torch.train import trainer as T
from mgvae_tpu_torch.train.step import METRIC_KEYS

torch.set_num_threads(1)
CFG = dict(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
SEED, BS, K = 7, 2, 4
NAMES = "names"     # the key the wrapped collates add to a batch


def _graphs(n, seed, tag):
    rng = np.random.default_rng(seed)
    return [random_circuit(rng, "mig", num_inputs=4, num_gates=6 + (i * 5) % 17,
                           num_tt_pairs=8, name=f"{tag}{i}") for i in range(n)]


TRAIN, VAL = _graphs(12, 1, "t"), _graphs(10, 2, "v")      # 1 group + 2 singles; 1 + 1
TRAIN2, VAL2 = _graphs(12, 3, "T"), _graphs(9, 4, "V")     # TRAIN's length; 1 group


def _named(fn, shards_of, made):
    def wrapped(graphs, *a, **kw):
        out = dict(fn(graphs, *a, **kw))
        out[NAMES] = [[g.name for g in shard] for shard in shards_of(graphs)]
        made.append(out[NAMES])
        return out
    return wrapped


@pytest.fixture
def named(monkeypatch):
    """The shard names of every item the trainer module collates, in the
    order the collates return."""
    made = []
    monkeypatch.setattr(T, "collate_shards", _named(T.collate_shards, lambda s: s, made))
    monkeypatch.setattr(T, "collate", _named(T.collate, lambda g: [g], made))
    return made


def _trainer(tmp_path, steps, **kw):
    """A CPU trainer whose four step calls append (phase, batch) to
    ``steps`` and return zero metrics."""
    t = T.Trainer(None, DGConfig(**CFG), save_dir=str(tmp_path), training_id="la",
                  batch_size=BS, distributed=False, seed=SEED, steps_per_call=K,
                  device="cpu", **kw)
    zero = lambda n: torch.zeros(n, len(METRIC_KEYS))

    def multi(phase):
        def call(params, state, sbatch, gen, weights):
            steps.append((phase, sbatch))
            rows = zero(K)
            return (state, rows) if phase == "train" else rows
        return call

    def single(phase):
        def call(params, state, batch, gen, weights):
            steps.append((phase, batch))
            m = dict(zip(METRIC_KEYS, zero(1)[0]))
            return (state, m) if phase == "train" else m
        return call

    t.multi_step, t.multi_eval = multi("train"), multi("val")
    t.train_step, t.eval_step = single("train"), single("val")
    assert t.grouped
    return t


def _plain_shards(phases):
    """(phase, its shards) of a plain run of these (phase, dataset), and
    its shuffle stream after them."""
    rng = np.random.default_rng(SEED + 2)
    out = []
    for phase, ds in phases:
        idx = np.arange(len(ds))
        rng.shuffle(idx)
        out.append((phase, [[ds[i] for i in idx[s * BS:(s + 1) * BS]]
                            for s in range(len(ds) // BS)]))
    return out, rng


def _replay(phases):
    """[(phase, batch)] that a plain run of these (phase, dataset) gives; a
    phase None is planned but runs no step (a phase left early)."""
    dims: dict = {}
    out = []
    for phase, shards in _plain_shards(phases)[0]:
        for shard in shards:
            T._running_max(dims, T.shard_dims(shard, 1))
        if phase is None:
            continue
        n_groups = len(shards) // K if len(shards) >= K else 0
        for g in range(n_groups):
            out.append((phase, batching.collate_shards(shards[g * K:(g + 1) * K],
                                                       dims=dict(dims))))
        for shard in shards[n_groups * K:]:
            out.append((phase, batching.collate(shard, dims=dict(dims))))
    return out


def _assert_same_steps(got, want):
    assert [p for p, _ in got] == [p for p, _ in want]
    for n, ((_, a), (_, b)) in enumerate(zip(got, want)):
        a = dict(a)
        names = a.pop(NAMES)
        assert sorted(a) == sorted(b), n
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (n, k)
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (n, k)
        assert len(names) in (1, K)


def _shard_names(steps) -> list:
    return [names for _, b in steps for names in b[NAMES]]


def _replay_names(phases) -> list:
    return [[g.name for g in shard] for phase, shards in _plain_shards(phases)[0]
            if phase is not None for shard in shards]


def _count_live_plans(t):
    live = []
    plan = t._epoch_plan
    t._epoch_plan = lambda ds: live.append(ds) or plan(ds)
    return live


@pytest.mark.parametrize("calls", ["train1_x3", "train3", "train1_x3_no_val"])
def test_lookahead_keeps_the_plain_shuffle_order_bit_for_bit(tmp_path, named, calls):
    """Three epochs, as three ``train(1)``, as one ``train(3)``, and as
    three ``train(1)`` with an empty val split (planned on the way to the
    next train phase): every step's shard ids and batch equal the plain
    replay's; only the first phase is planned on the step's thread, the
    others were planned ahead; between calls the trainer's shuffle stream
    is the replay's after the phases run, whatever the thread has planned
    since; each item is collated once, and the next epoch's first ahead."""
    steps = []
    t = _trainer(tmp_path, steps)
    live = _count_live_plans(t)
    val = [] if calls.endswith("no_val") else VAL
    phases = [("train", TRAIN), ("val", val)] * 3
    if calls == "train3":
        t.train(3, TRAIN, val)
    else:
        for e in range(3):
            t.train(1, TRAIN, val)
            rng = _plain_shards(phases[:2 * (e + 1)])[1]
            assert t._np_rng.bit_generator.state == rng.bit_generator.state
    assert _shard_names(steps) == _replay_names(phases)
    _assert_same_steps(steps, _replay(phases))
    assert len(live) == 1 and live[0] is TRAIN
    assert t._ahead.made.wait(10.0)
    next_first = _replay_names(phases + [("train", TRAIN)])[len(_shard_names(steps)):][:K]
    assert sorted(map(str, named)) == sorted(map(str, [b[NAMES] for _, b in steps]
                                                 + [next_first]))


@pytest.mark.parametrize("change", ["swap_val", "swap_train", "load", "set_args", "left_early"])
def test_lookahead_dropped_or_kept_the_next_epoch_is_the_plain_one(tmp_path, named, change):
    """Between two ``train(1)`` calls: another val dataset (the look-ahead
    had planned train: kept), another train dataset (dropped), ``load``
    and ``set_training_args`` (dropped), and a phase left after its first
    item (dropped). Every epoch after is still the plain replay's; a
    dropped look-ahead leaves the next train phase to the step's thread."""
    steps = []
    t = _trainer(tmp_path, steps)
    live = _count_live_plans(t)
    t.train(1, TRAIN, VAL)
    phases = [("train", TRAIN), ("val", VAL)]
    tr, va = TRAIN, VAL
    if change == "swap_val":
        va = VAL2
    elif change == "swap_train":
        tr = TRAIN2
    elif change == "load":
        path = os.path.join(str(tmp_path), "ck.pth")
        t.save(path)
        t.load(path)
    elif change == "set_args":
        t.set_training_args(lr=1e-3)
    else:
        it = t._iter_grouped(TRAIN, t.grouped, (VAL, TRAIN))
        next(it)
        it.close()
        phases.append((None, TRAIN))
    t.train(1, tr, va)
    t.train(1, tr, va)
    phases += [("train", tr), ("val", va)] * 2
    assert _shard_names(steps) == _replay_names(phases)
    _assert_same_steps(steps, _replay(phases))
    want = {"swap_val": [TRAIN], "swap_train": [TRAIN, TRAIN2]}.get(change, [TRAIN, TRAIN])
    assert len(live) == len(want) and all(a is b for a, b in zip(live, want))


def test_lookahead_error_is_raised_at_the_phase_that_uses_it(tmp_path, named, monkeypatch):
    """A collate that fails on the val shards fails in the look-ahead during
    the train phase, and is raised when the val phase takes it up, after
    every train step ran."""
    collate_shards = T.collate_shards

    def broken(shards, *a, **kw):
        if shards[0][0].name.startswith("v"):
            raise ValueError("val shard broken")
        return collate_shards(shards, *a, **kw)

    monkeypatch.setattr(T, "collate_shards", broken)
    steps = []
    t = _trainer(tmp_path, steps)
    with pytest.raises(ValueError, match="val shard broken"):
        t.train(1, TRAIN, VAL)
    assert [p for p, _ in steps] == ["train"] * 3


def test_lookahead_thread_ends_and_the_trainer_is_freed(tmp_path):
    """After ``train`` returns the thread looks ahead and ends by itself;
    ``del`` and ``gc.collect()`` free the trainer and its host batch."""
    before = set(threading.enumerate())
    steps = []
    t = _trainer(tmp_path, steps)
    t.train(1, TRAIN, VAL)
    ref = weakref.ref(t)
    mine = [th for th in set(threading.enumerate()) - before if th.name == "mgvae-prefetch"]
    del t, steps
    gc.collect()
    deadline = time.monotonic() + 2.0
    while any(th.is_alive() for th in mine) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not any(th.is_alive() for th in mine)
    gc.collect()
    assert ref() is None


def test_lookahead_spans_one_plan_a_phase_and_thread_ranges_in_the_trace(tmp_path):
    """Recorded epochs hold one ``plan:<phase>`` entry a phase and nothing
    from the thread; a ``trace_dir`` capture holds the thread's
    ``trainer.plan_ahead`` and ``trainer.collate_ahead`` ranges."""
    steps = []
    t = _trainer(tmp_path, steps, trace_dir=str(tmp_path / "trace"))
    t.step_times = []
    t.train(1, TRAIN, VAL)
    t.train(1, TRAIN, VAL)
    names = [n for n, _, _ in t.step_times]
    assert names.count("plan:train") == 2 and names.count("plan:val") == 2
    assert {n.split(":")[0] for n in names} <= {"plan", "prefetch_wait", "train", "val",
                                                "fetch", "log", "save"}
    (first, *_) = sorted((tmp_path / "trace").iterdir())
    with open(first) as f:
        traced = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"trainer.plan_ahead", "trainer.collate_ahead", "trainer.plan"} <= traced
