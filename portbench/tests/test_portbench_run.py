"""The run's result line and its refusals: the required keys in order,
with ``checks`` last; no result and a nonzero exit without a card."""
import json
import time

import pytest

from portbench import cell, run, spec
from portbench_tiny import cell as tiny_cell, random_traffic

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def results():
    out = {}
    for trace in (False, True):
        c = tiny_cell("mig_train_bs16", "dgae_mig_d64", random_traffic())
        out[trace] = cell.run(c, 2**31 + 5, 0.5, trace, time.time())
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_line_keys(results, trace):
    bench = spec.benchmark()
    line = run.result_line(bench, "mig_train_bs16", results[trace], trace, 1, "cpu")
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert set(line["checks"]) == set(spec.limits("mig_train_bs16"))
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ({"busy_s", "window_s"} <= set(dev)) == trace
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        names = {m["name"] for m in spec.per_layer(bench, "mig_train_bs16")}
        assert set(line["metrics"]) <= names
    else:
        assert set(line["metrics"]) == {m["name"] for m in spec.end_to_end(bench,
                                                                             "mig_train_bs16")}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(line)


def test_window_counts_whole_epochs(results):
    res = results[False]
    w = res["window"]
    assert w["epochs"] >= 1 and w["seconds"] >= 0.5
    nodes = 32 * 36           # train entries x nodes a circuit
    assert res["end_to_end"]["train_gates_per_s"] == pytest.approx(
        w["epochs"] * nodes / w["seconds"])
    assert res["attempted"] == w["epochs"] * 8


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "mig_train_bs16", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_too_few_cards_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = run.main(["--workload", "mig_train_dp4", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.cuda
def test_one_short_cell_on_the_card(card):
    """A short window of the one-card cell on the card: correct, and every
    end-to-end metric there."""
    bench = spec.benchmark()
    wl = spec.workload(bench, "mig_train_bs16")
    c = cell.Cell("mig_train_bs16", spec.config(bench, wl["config"]),
                  spec.traffic(wl["traffic"]), spec.limits("mig_train_bs16"))
    res = cell.run(c, 2**31 + 9, 3.0, False, time.time())
    assert res["correct"], res["checks"]
    assert res["end_to_end"]["train_gates_per_s"] > 0
