"""The readings that the check's limits are set from: the program's
numbers (``check.py``) on many seeds, and those of the control and of the
faults, planted in the program, at the cell's own sizes. The benchmark's
runs never run this.

    python3 -m portbench.calibrate --workload <name> --seeds 1-12 \\
        --plants none,tf32,half [--plant-seeds 3]

  none        the program as the configuration states it (the lower readings)
  tf32        the control: the program's own TF32 path ("default" matmul
              precision) in place of the configuration's fp32
  half        half of every loss's rows left out, the mean taken over the rest
  noexchange  the gradient all-reduce left out (data-parallel cells)

(A step that returns its state unchanged reads 1 on ``grad`` and ``change``
by their definition, and needs no run.) Each run is a cell's set-up, no
window, and its check; one JSON line per run on standard output, then
the largest reading of ``none`` and the smallest of every other plant per
number. A cell of several chips starts its ranks as ``run.py`` does.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import check, spec


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b) + 1) if b else [int(a)])
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,9")
    ap.add_argument("--plants", default="none,tf32,half")
    ap.add_argument("--plant-seeds", type=int, default=3,
                    help="the first this many seeds for every plant but none")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    chips = int(wl["chips"])
    import torch

    from . import run as run_mod

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"calibrate: {args.workload} needs {chips} CUDA device(s)", file=sys.stderr)
        return 3
    if chips > 1 and "RANK" not in os.environ:
        return run_mod.launch_ranks("portbench.calibrate", argv, chips, {})
    from . import cell as cell_mod

    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    c = cell_mod.Cell(name=args.workload, cfg=spec.config(bench, wl["config"]),
                      traffic=spec.traffic(wl["traffic"]), limits=spec.limits(args.workload))
    seeds = seeds_of(args.seeds)
    found: dict = {}
    for plant in args.plants.split(","):
        for seed in (seeds if plant == "none" else seeds[:args.plant_seeds]):
            t0 = time.time()
            res = cell_mod.run(c, seed, 0.0, False, t0, rank=rank, world=world,
                               plant=None if plant == "none" else plant)
            if rank != 0:
                continue
            vals = res["numbers"]
            print(json.dumps({"plant": plant, "seed": seed, **vals, "where": res["where"],
                              "seconds": round(time.time() - t0, 3)}), flush=True)
            found.setdefault(plant, []).append(vals)
    if rank == 0:
        for plant, rows in found.items():
            pick = max if plant == "none" else min
            print(json.dumps({"plant": plant, "runs": len(rows),
                              "largest" if plant == "none" else "smallest":
                              {k: pick(r[k] for r in rows) for k in check.NAMES}}), flush=True)
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
