"""The readers of the trainer's and the K-step call's spans
(``Trainer.step_times``): nothing to read from a program without the spans,
the right number from a handmade span log, and ``trainer.host_ms_per_step``
unmoved by the spans' entries. A traced CPU run of the tiny cell reports
the one-card cells' four."""
import time

import pytest

from portbench import cell, run, spec
from portbench_tiny import cell as tiny_cell, random_traffic

NEW = ("trainer.prefetch_wait_ms_per_step.train", "trainer.edge_ms_per_epoch.train",
       "kstep.host_ms_per_step.train", "kstep.captures.train", "dp.edge_ms_per_epoch.train")
ONE_CARD = NEW[:4]

# two epochs of two train calls (K = 8) and one val call, as a program
# without the spans logs them: each call, each read-back
OLD_LOG = [("train", 8, 0.020), ("train", 16, 0.030), ("fetch:train", 16, 0.004),
           ("val", 8, 0.010), ("fetch:val", 8, 0.002)] * 2
# the same epochs with the spans: plan, prefetch waits, staging and its
# wait inside each call, log, the chief's save in epoch 0, a capture in
# epoch 1's val call
EPOCH0 = [("plan:train", 0, 0.050), ("prefetch_wait:train", 0, 0.008),
          ("stage_wait:train", 0, 0.000), ("stage:train", 0, 0.002), ("train", 8, 0.020),
          ("prefetch_wait:train", 8, 0.001), ("stage_wait:train", 8, 0.015),
          ("stage:train", 8, 0.017), ("train", 16, 0.030), ("prefetch_wait:train", 16, 0.0),
          ("fetch:train", 16, 0.004), ("log:train", 16, 0.003), ("save:train", 16, 0.100),
          ("plan:val", 0, 0.006), ("prefetch_wait:val", 0, 0.004), ("stage_wait:val", 0, 0.0),
          ("stage:val", 0, 0.001), ("val", 8, 0.010), ("prefetch_wait:val", 8, 0.0),
          ("fetch:val", 8, 0.002), ("log:val", 8, 0.001)]
EPOCH1 = [e for e in EPOCH0 if e[0] != "save:train"]
EPOCH1.insert(EPOCH1.index(("val", 8, 0.010)), ("capture:val", 0, 0.005))
NEW_LOG = EPOCH0 + EPOCH1
STEPS = {"train": 32, "val": 16}


def _run(log):
    return {"steps": dict(STEPS), "step_times": log}


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("log", [OLD_LOG, [], None], ids=["without_spans", "empty", "none"])
def test_nothing_to_read_without_the_spans(name, log):
    assert spec.reader(name)(_run(log)) is None


def test_readings_of_a_handmade_span_log():
    read = {n: spec.reader(n)(_run(NEW_LOG)) for n in NEW}
    # prefetch waits of the train phase: (0.008 + 0.001 + 0.0) x 2 over 32 steps
    assert read["trainer.prefetch_wait_ms_per_step.train"] == pytest.approx(0.018 / 32 * 1e3)
    # plan, log and save of both phases over 2 epochs
    edges = (0.050 + 0.003 + 0.006 + 0.001) * 2 + 0.100
    assert read["trainer.edge_ms_per_epoch.train"] == pytest.approx(edges / 2 * 1e3)
    assert read["dp.edge_ms_per_epoch.train"] == read["trainer.edge_ms_per_epoch.train"]
    # the calls less the waits on the card inside them, over 32 steps
    assert read["kstep.host_ms_per_step.train"] == pytest.approx(
        ((0.020 + 0.030) * 2 - 0.015 * 2) / 32 * 1e3)
    assert read["kstep.captures.train"] == 1.0
    assert spec.reader("kstep.captures.train")(_run(EPOCH0)) == 0.0


def test_host_ms_per_step_reads_the_same_with_the_spans():
    read = spec.reader("trainer.host_ms_per_step.train")
    assert read(_run(NEW_LOG)) == pytest.approx(read(_run(OLD_LOG)))
    assert read(_run(OLD_LOG)) == pytest.approx((0.020 + 0.030 + 0.004) * 2 / 32 * 1e3)


def test_entries_name_the_cells_they_read_in():
    bench = spec.benchmark()
    one = {m["name"] for m in spec.per_layer(bench, "mig_train_bs16")}
    assert set(ONE_CARD) <= one
    assert set(ONE_CARD) <= {m["name"] for m in spec.per_layer(bench, "xmg_train_giant")}
    dp4 = {m["name"] for m in spec.per_layer(bench, "mig_train_dp4")}
    assert "dp.edge_ms_per_epoch.train" in dp4 and not set(ONE_CARD) & dp4
    moves = {m["name"]: m["moves"] for m in bench["per_layer"]}
    assert moves["dp.edge_ms_per_epoch.train"] == "dp_train_gates_per_s"
    assert {moves[n] for n in ONE_CARD} == {"train_gates_per_s"}


def test_traced_tiny_run_reports_the_span_metrics():
    c = tiny_cell("mig_train_bs16", "dgae_mig_d64", random_traffic())
    res = cell.run(c, 2**31 + 11, 0.5, True, time.time())
    line = run.result_line(spec.benchmark(), "mig_train_bs16", res, True, 1, "cpu")
    got = line["metrics"]
    assert set(ONE_CARD) <= set(got) and "dp.edge_ms_per_epoch.train" not in got
    assert got["kstep.captures.train"]["value"] == 0.0       # the CPU captures none
    assert got["trainer.edge_ms_per_epoch.train"]["value"] > 0.0
    assert got["kstep.host_ms_per_step.train"]["value"] <= (
        got["trainer.host_ms_per_step.train"]["value"])
