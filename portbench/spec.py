"""Finding a cell's parts by name: ``BENCHMARK.json`` at the checkout's root
names each workload's configuration and traffic mix, and each metric; the
files live under ``portbench/``:

  configs/<config>.json       (the path ``BENCHMARK.json`` gives the config)
  traffic/<traffic>.json      (``traffic.py``)
  limits/<workload>.json      the check's limits (``check.py``)
  metrics/<metric>.py         a per-layer metric's reader: read(run) -> value or None

A cell, a mix or a metric is added by adding its files and its entries;
nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(there are: {', '.join(w['name'] for w in bench['workloads'])})")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return _json(HERE / "limits" / f"{workload_name}.json")


def end_to_end(bench: dict, workload_name: str) -> list:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload_name in m["workloads"]]


def per_layer(bench: dict, workload_name: str) -> list:
    """The per-layer metrics a cell's traced run reports: those that list it,
    and those without a list that move one of its end-to-end metrics."""
    mine = {m["name"] for m in end_to_end(bench, workload_name)}
    return [m for m in bench["per_layer"]
            if (workload_name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def reader(metric_name: str):
    """The ``read`` function of ``metrics/<metric_name>.py``."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric_name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
