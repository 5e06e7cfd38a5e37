"""The reader of the row gathers' backward launches
(``glue.gather_launches_per_step.train``): the counter over the train
steps from a run's launch counts, nothing to read without train steps or
from a program without the counter, its entry in ``BENCHMARK.json``, and
a traced CPU run of the tiny cell that reports it (0: the CPU takes the
plain version and counts no launch)."""
import time

import pytest

from portbench import cell, run, spec
from portbench_tiny import cell as tiny_cell, random_traffic

NAME = "glue.gather_launches_per_step.train"
COUNTS = {"struct_kernel.launches": 128, "level_kernel.launches": 16,
          "gather.bwd_launches": 224}


def _run(train_steps, counts):
    return {"steps": {"train": train_steps, "val": 4},
            "launches": {"train": dict(counts), "val": {"gather.bwd_launches": 0}}}


def test_reads_the_counter_over_the_train_steps():
    assert spec.reader(NAME)(_run(16, COUNTS)) == pytest.approx(14.0)


@pytest.mark.parametrize("steps,counts", [
    (0, COUNTS),
    (16, {k: v for k, v in COUNTS.items() if not k.startswith("gather.")}),
], ids=["no_train_steps", "no_counter"])
def test_nothing_to_read(steps, counts):
    assert spec.reader(NAME)(_run(steps, counts)) is None


def test_entry_names_the_one_card_cells():
    bench = spec.benchmark()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "launches", "better": "lower",
                     "source": "program_counter", "layer": "model glue and autograd",
                     "moves": "train_gates_per_s",
                     "workloads": ["mig_train_bs16", "xmg_train_giant"]}
    assert NAME in {m["name"] for m in spec.per_layer(bench, "xmg_train_giant")}
    assert NAME not in {m["name"] for m in spec.per_layer(bench, "mig_train_dp4")}


def test_traced_tiny_run_reports_it():
    c = tiny_cell("mig_train_bs16", "dgae_mig_d64", random_traffic())
    res = cell.run(c, 2**31 + 13, 0.5, True, time.time())
    line = run.result_line(spec.benchmark(), "mig_train_bs16", res, True, 1, "cpu")
    assert line["metrics"][NAME]["value"] == 0.0
