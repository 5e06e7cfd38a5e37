"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's chips must be CUDA devices here;
without them it exits 3 and prints no result. A cell of several chips
starts its ranks itself (``torch.distributed.run --standalone``, NCCL, one
card each); rank 0 hands its line to this process, which prints it.

Standard output carries one line: the JSON object of the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit).
Everything else, the program's own prints included, goes to standard
error, which ends with the compared numbers.
"""
from __future__ import annotations

import os
import time

T0 = float(os.environ.get("PORTBENCH_T0", time.time()))   # before any heavy import

import argparse   # noqa: E402
import json       # noqa: E402
import subprocess  # noqa: E402
import sys        # noqa: E402
import tempfile   # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mgvae_tpu")   # top-level module names, compared whole
CACHE = spec.ROOT / ".portbench_cache"
LAUNCH_TIMEOUT = 1150        # a checkout's first run builds the kernels on every rank


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _cache_dirs() -> None:
    """Build and kernel caches at fixed places inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(CACHE / sub))


def launch_ranks(module: str, argv: list, chips: int, env: dict) -> int:
    """``python -m module argv`` on ``chips`` ranks of this host
    (``torch.distributed.run --standalone``), their standard output sent to
    this process's standard error; waits for them and returns their exit
    code (124 when they run past the time allowed, after stopping them)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(chips), "-m", module, *argv]
    p = subprocess.Popen(cmd, env=dict(os.environ, PORTBENCH_T0=repr(T0), **env),
                         cwd=str(spec.ROOT), stdout=sys.stderr.fileno())
    try:
        return p.wait(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        p.terminate()
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        print(f"portbench: the ranks ran past {LAUNCH_TIMEOUT} s and were stopped",
              file=sys.stderr)
        return 124


def _launch(argv: list, chips: int, out) -> int:
    """The ranks of a multi-chip cell; prints rank 0's checks and line."""
    fd, path = tempfile.mkstemp(prefix="portbench_result_", suffix=".json")
    os.close(fd)
    try:
        rc = launch_ranks("portbench.run", argv, chips, {"PORTBENCH_RESULT": path})
        with open(path) as f:
            got = json.load(f) if os.path.getsize(path) else None
    finally:
        os.unlink(path)
    if rc != 0 or got is None:
        print(f"portbench: the ranks exited {rc} without a result", file=sys.stderr)
        return rc or 1
    return _emit(got["check_lines"], got["line"], out)


def _refuse_forbidden(where: str) -> int:
    """5, after naming them, when this process holds a forbidden module; else 0."""
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded ({where}): {', '.join(found)}",
              file=sys.stderr)
        return 5
    return 0


def _emit(check_lines: list, line: dict, out) -> int:
    if _refuse_forbidden("the printing process"):
        return 5
    for text in check_lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0


def result_line(bench: dict, name: str, res: dict, trace: bool, chips: int, kind: str) -> dict:
    metrics = {}
    if trace:
        for m in spec.per_layer(bench, name):
            value = spec.reader(m["name"])(res["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.end_to_end(bench, name):
            metrics[m["name"]] = {"value": res["end_to_end"][m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if trace:
        tr = res["window"]["trace"]
        device["busy_s"], device["window_s"] = res["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    out = sys.stdout
    sys.stdout = sys.stderr          # the program's prints; the result line goes to ``out``
    try:
        return _main(args, argv, out)
    finally:
        sys.stdout = out


def _main(args, argv: list, out) -> int:
    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    chips = int(wl["chips"])
    _cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), this machine has {have}",
              file=sys.stderr)
        return 3
    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    if chips > 1 and "RANK" not in os.environ:
        return _launch(argv, chips, out)
    if world != chips:
        print(f"portbench: {args.workload} runs on {chips} ranks, this launch has {world}",
              file=sys.stderr)
        return 2
    from . import cell as cell_mod

    c = cell_mod.Cell(name=args.workload, cfg=spec.config(bench, wl["config"]),
                      traffic=spec.traffic(wl["traffic"]), limits=spec.limits(args.workload))
    res = cell_mod.run(c, args.seed, args.seconds, bool(args.trace), T0, rank=rank, world=world)
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    if rank != 0:
        # each rank looks at its own modules: one that finds any exits
        # nonzero, so the launch fails and no line is printed
        return _refuse_forbidden(f"rank {rank}")
    line = result_line(bench, args.workload, res, bool(args.trace), chips,
                       torch.cuda.get_device_name(0))
    check_lines = [f"also {k}: {v:.6g} ({res['where'][k]})" for k, v in res["numbers"].items()
                   if k not in res["checks"]]
    check_lines += [f"check {k}: {v['value']:.6g} (limit {v['limit']:g}; at {res['where'][k]})"
                    for k, v in res["checks"].items()]
    print(f"portbench: {args.workload} seed {args.seed}: {res['window']['epochs']} epochs in "
          f"{res['window']['seconds']:.3f} s; set-up {res['end_to_end']['setup_s']:.3f} s ("
          + ", ".join(f"{k} at {v:.3f} s" for k, v in res["marks"].items())
          + f"); check {res['check_s']:.3f} s; peak {res['memory_peak_bytes'] / 2**30:.3f} GiB",
          file=sys.stderr)
    if world > 1:
        if _refuse_forbidden("rank 0"):
            return 5
        with open(os.environ["PORTBENCH_RESULT"], "w") as f:
            json.dump({"check_lines": check_lines, "line": line}, f)
        return 0
    return _emit(check_lines, line, out)


if __name__ == "__main__":
    sys.exit(main())
