"""What the benchmark loads: no JAX and not the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), no
file of the JAX package's benchmark, and a plain reference and yardstick
that import nothing of the program."""
import ast
import os
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "mgvae_tpu"}
# the yardstick: they work from the circuits, the weights and the shapes alone
STANDALONE = ("reference.py", "circuits.py", "flops.py", "check.py", "traffic.py")


def imported(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_benchmark_files(path):
    """No string names the JAX package's benchmark: its folder, its script
    or its result files (this file spells them in pieces)."""
    bad = ("benchmarks" + "/", "bench" + ".py", "BENCH" + "_r0")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not any(b in node.value for b in bad), path.name


@pytest.mark.parametrize("name", STANDALONE)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "mgvae_tpu_torch" not in imported(HERE / name)


def test_run_process_refuses_forbidden_modules(monkeypatch):
    import sys
    import types

    from portbench import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mgvae_tpu.models", types.ModuleType("mgvae_tpu.models"))
    assert run.forbidden_modules() == ["mgvae_tpu"]


@pytest.mark.parametrize("rank", ["0", "1", "3"])
@pytest.mark.parametrize("loaded", [False, True])
def test_every_rank_refuses_forbidden_modules(monkeypatch, capsys, rank, loaded):
    """Each rank of a four-card launch looks at its own modules once its
    run is over: one that finds a forbidden module exits nonzero, so the
    launch fails and nothing is printed."""
    import sys
    import types

    import torch
    import torch.distributed as dist

    from portbench import cell, run

    fake = {"correct": True, "attempted": 1, "failed": 0, "numbers": {}, "where": {},
            "checks": {}, "end_to_end": {"dp_train_gates_per_s": 1.0, "setup_s": 1.0},
            "window": {"epochs": 1, "seconds": 1.0}, "marks": {}, "check_s": 0.0,
            "memory_peak_bytes": 1, "busy_s": 0.0, "readings": None}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card")
    monkeypatch.setattr(cell, "run", lambda *a, **k: None if rank != "0" else fake)
    monkeypatch.setattr(dist, "destroy_process_group", lambda *a, **k: None)
    monkeypatch.setenv("RANK", rank)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("PORTBENCH_RESULT", os.devnull)
    if loaded:
        monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    rc = run.main(["--workload", "mig_train_dp4", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert out.out == ""
    assert (rc != 0) == loaded
    assert ("jaxlib" in out.err) == loaded
