"""The trainer's span log (``utils/spans``, ``Trainer.step_times``) at mini
size: off, it opens no profiler range and changes no number; on, every span
of the trainer and the K-step call shows in each phase, under the names the
benchmark's readers read. The cases marked ``cuda`` need a card and skip
without one: the captures, the staging area's wait, and an idle gap on the
device named by the span open on the host (the profiler's clock). On a
machine with a card (no JAX here):
python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -q"""
import collections
import json
import os
import time

import numpy as np
import pytest
import torch

from mgvae_tpu_torch.data.synthetic import random_circuit
from mgvae_tpu_torch.models import dg_ae as P
from mgvae_tpu_torch.train import step as PS
from mgvae_tpu_torch.train import trainer as ptrainer
from mgvae_tpu_torch.utils import spans as spans_mod

torch.set_num_threads(1)
CFG = dict(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
K = 4
# 16 train graphs at bs2: 8 steps, two K-step calls; 8 val graphs: one call
TRAIN_STEPS, VAL_STEPS = 8, 4
PHASE_SPANS = ("plan", "prefetch_wait", "stage", "stage_wait", "{phase}", "fetch", "log")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _graphs(n, seed=0, gates=12):
    rng = np.random.default_rng(seed)
    return [random_circuit(rng, "mig", num_inputs=4, num_gates=gates + (i % 3) * 4,
                           num_tt_pairs=8, name=f"g{i}") for i in range(n)]


def _trainer(tmp_path, device="cpu", **kw):
    return ptrainer.Trainer(None, P.DGConfig(**CFG), training_id="t", save_dir=str(tmp_path),
                            batch_size=2, distributed=False, seed=3, device=device,
                            steps_per_call=K, **kw)


def _entry(short, phase):
    return short.format(phase=phase) if short == "{phase}" else f"{short}:{phase}"


def _count_ranges(monkeypatch) -> list:
    """The names of the ranges opened through ``torch.profiler.record_function``."""
    opened, real = [], torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return opened


def _epochs(log: list) -> list:
    """The span log cut at each epoch's first entry (its ``plan:train``)."""
    out = []
    for entry in log:
        if entry[0] == "plan:train":
            out.append([])
        out[-1].append(entry)
    return out


def test_spans_off_open_no_range_and_change_no_number(tmp_path, monkeypatch):
    ds, val = _graphs(16), _graphs(8, seed=1)
    opened = _count_ranges(monkeypatch)
    off = _trainer(tmp_path / "off")
    out_off = off.train(2, ds, val)
    assert opened == [] and off.step_times is None
    on = _trainer(tmp_path / "on")
    on.step_times = []
    out_on = on.train(2, ds, val)
    assert opened and set(opened) >= {"trainer.plan", "trainer.step", "kstep.stage"}
    # the prefetch thread's look-ahead opens bare ranges, which log nothing
    bare = {"trainer.plan_ahead", "trainer.collate_ahead"}
    assert len(on.step_times) == len([n for n in opened if n not in bare])
    for phase in ("train", "val"):
        assert out_on[phase] == {**out_off[phase], "time": out_on[phase]["time"]}
    for a, b in zip(PS.param_leaves(on.params) + PS.param_leaves(on.state),
                    PS.param_leaves(off.params) + PS.param_leaves(off.state), strict=True):
        assert torch.equal(a, b)


def test_off_span_is_one_shared_no_op():
    spans = spans_mod.Spans()
    assert spans("trainer.plan") is spans("kstep.stage") is spans_mod.OFF("trainer.log")
    with spans.recording(None, "train"):
        assert not spans.on and spans("trainer.plan") is spans_mod.OFF("trainer.plan")
    log = []
    with spans.recording(log, "val"):
        spans.steps = 3
        with spans("trainer.readback"), spans("kstep.stage_wait"):
            pass
        with pytest.raises(ValueError), spans("trainer.log"):
            raise ValueError("a span that raises logs nothing")
    assert not spans.on and spans.log is None
    assert [(n, s) for n, s, _ in log] == [("stage_wait:val", 3), ("fetch:val", 3)]


@pytest.mark.parametrize("start", [0, 9])
@pytest.mark.parametrize("chief", [True, False])
def test_span_log_names_every_span_in_each_phase(tmp_path, start, chief):
    tr = _trainer(tmp_path)
    tr.model_epoch, tr.is_chief = start, chief
    tr.step_times = []
    tr.train(2, _graphs(16), _graphs(8, seed=1))
    assert all(len(e) == 3 and isinstance(e[0], str) and isinstance(e[1], int)
               and e[2] >= 0.0 for e in tr.step_times)
    epochs = _epochs(tr.step_times)
    assert len(epochs) == 2
    for e, log in enumerate(epochs):
        names = collections.Counter(n for n, _, _ in log)
        saved = chief and (start + e) % 10 == 0
        for phase, steps in (("train", TRAIN_STEPS), ("val", VAL_STEPS)):
            for short in PHASE_SPANS:
                assert names[_entry(short, phase)] >= 1, (e, short, phase)
            assert names[f"plan:{phase}"] == names[f"log:{phase}"] == 1
            # the trainer's older entries: one a call with the steps done, one read-back
            calls = [s for n, s, _ in log if n == phase]
            assert calls == list(range(K, steps + 1, K))
            assert [s for n, s, _ in log if n == f"fetch:{phase}"] == [steps]
            assert names[f"stage:{phase}"] == names[f"stage_wait:{phase}"] == steps // K
            # the prefetch queue's wait for every call and for its end
            assert names[f"prefetch_wait:{phase}"] == steps // K + 1
        assert names["save:train"] == int(saved) and names["save:val"] == 0
        assert not [n for n in names if n.startswith("capture:")]   # the CPU captures none


def test_trace_dir_file_carries_the_spans(tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    opened = _count_ranges(monkeypatch)
    tr = _trainer(tmp_path / "run", trace_dir=str(trace_dir))
    tr.train(2, _graphs(16), _graphs(8, seed=1))
    assert tr.step_times is None
    # epoch 0 only: its ranges, and none in epoch 1
    assert opened.count("trainer.plan") == 2 and opened.count("trainer.save") == 1
    (name,) = os.listdir(trace_dir)
    with open(trace_dir / name) as f:
        events = {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}
    assert {"trainer.plan", "trainer.prefetch_wait", "trainer.step", "trainer.readback",
            "trainer.log", "trainer.save", "kstep.stage", "kstep.stage_wait"} <= events


# ---- on the card ----------------------------------------------------------


@pytest.mark.cuda
def test_capture_entries_count_the_captures(card, tmp_path):
    tr = _trainer(tmp_path, device="cuda")
    tr.step_times = []
    before = tr.multi_step.captures + tr.multi_eval.captures
    tr.train(1, _graphs(16), _graphs(8, seed=1))
    # a larger circuit grows the running-max dims: new layouts, new captures
    tr.train(1, _graphs(16, gates=40), _graphs(8, seed=1, gates=40))
    made = tr.multi_step.captures + tr.multi_eval.captures - before
    names = collections.Counter(n for n, _, _ in tr.step_times)
    assert made >= 4
    assert names["capture:train"] + names["capture:val"] == made
    assert names["capture:train"] == tr.multi_step.captures


@pytest.mark.cuda
def test_stage_wait_lies_inside_stage(card, tmp_path):
    tr = _trainer(tmp_path, device="cuda")
    tr.train(1, _graphs(16), _graphs(8, seed=1))      # epoch 0: the captures
    tr.step_times = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        tr.train(2, _graphs(16), _graphs(8, seed=1))
    host = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA]
    stages = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in host
              if e.name() == "kstep.stage"]
    waits = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in host
             if e.name() == "kstep.stage_wait"]
    assert len(waits) == len(stages) == 2 * (TRAIN_STEPS + VAL_STEPS) // K
    for s, f in waits:
        assert any(a <= s and f <= b for a, b in stages)
    names = collections.Counter(n for n, _, _ in tr.step_times)
    assert names["stage_wait:train"] == names["stage:train"] == 2 * TRAIN_STEPS // K


@pytest.mark.cuda
def test_idle_gap_is_named_by_the_open_span(card, tmp_path):
    from portbench import trace

    tr = _trainer(tmp_path, device="cuda")
    tr.train(1, _graphs(16), _graphs(8, seed=1))
    write, pause = tr.logger.write, 0.05
    tr.logger.write = lambda text: (time.sleep(pause), write(text))
    tr.step_times = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        tr.train(1, _graphs(16), _graphs(8, seed=1))
        torch.cuda.synchronize()
        t1 = time.time_ns()
    events = list(prof.profiler.kineto_results.events())
    main = next(e.start_thread_id() for e in events if e.name() == "trainer.log")
    gaps = dict(trace.reduce(events, t0, t1, main)["idle_gaps"])
    # two epoch lines, each a pause inside the train or val phase's trainer.log
    assert gaps.get("trainer.log", 0.0) >= 2 * pause * 0.9
    assert max(gaps, key=gaps.get) == "trainer.log"
