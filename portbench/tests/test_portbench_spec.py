"""BENCHMARK.json against the format's limits, and the harness finding
every part of a cell by name, a cell added as files alone included."""
import json
import re
import shutil

import pytest

from portbench import check, spec, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(one_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keys_and_names(bench, section):
    entries = bench[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = set(e) - ENTRY_KEYS[section]
        assert extra <= ({"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert ENTRY_KEYS[section] <= set(e)
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert one_line(e[key]), (e["name"], key)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    assert any("mfu" in m["name"] for m in bench["per_layer"])


def test_cells(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == configs
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("w", [w["name"] for w in spec.benchmark()["workloads"]])
def test_workload_resolves(bench, w):
    wl = spec.workload(bench, w)
    cfg = spec.config(bench, wl["config"])
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    assert entry["file"].startswith(bench["paths"][0] + "/")
    assert cfg["reduced"] == entry["reduced"]
    t = spec.traffic(wl["traffic"])
    traffic.check(t)
    assert t["dp"] == wl["chips"]
    assert spec.limits(w) and set(spec.limits(w)) <= set(check.NAMES)
    ends = spec.end_to_end(bench, w)
    assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
    layered = spec.per_layer(bench, w)
    assert layered
    for m in layered:
        assert m["moves"] in {e["name"] for e in ends}
        assert callable(spec.reader(m["name"]))


def test_a_cell_added_as_files_is_found(tmp_path, monkeypatch):
    """A later cell brings a traffic file, a limits file, a metric reader and
    entries, and edits no file the harness has."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    t = spec.traffic("train_bs16")
    t.update(num_gates=528)
    (root / "portbench" / "traffic" / "train_bs16_g528.json").write_text(json.dumps(t))
    (root / "portbench" / "limits" / "xmg_train_g528.json").write_text(
        json.dumps(spec.limits("mig_train_bs16")))
    (root / "portbench" / "metrics" / "demo.count.train.py").write_text(
        "def read(run):\n    return float(run['steps']['train'])\n")
    bench["workloads"].append({"name": "xmg_train_g528", "config": "dgae_xmg_d64",
                               "traffic": "train_bs16_g528", "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "demo.count.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "trainer",
                               "moves": "train_gates_per_s", "workloads": ["xmg_train_g528"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", root / "portbench")
    monkeypatch.setattr(spec, "ROOT", root)
    b = spec.benchmark()
    wl = spec.workload(b, "xmg_train_g528")
    assert spec.traffic(wl["traffic"])["num_gates"] == 528
    assert spec.config(b, wl["config"])["modality"] == "xmg"
    assert set(spec.limits("xmg_train_g528")) <= set(check.NAMES)
    names = [m["name"] for m in spec.per_layer(b, "xmg_train_g528")]
    assert "demo.count.train" in names and "dp.nccl_ms_per_step.train" not in names
    assert spec.reader("demo.count.train")({"steps": {"train": 7}}) == 7.0
    assert "demo.count.train" not in [m["name"] for m in spec.per_layer(b, "mig_train_bs16")]
