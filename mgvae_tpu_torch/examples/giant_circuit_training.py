"""Training on a single circuit too large for the fused level-scan route.

Counterpart of ``examples/giant_circuit_training.py``: one layered MIG
circuit (width 512 x depth 200: 102,912 nodes, 205,273 edges, 201 levels),
collated alone, through ``make_train_step`` for 4 steps with the loss weights
[1, 4, 2, 0]. The batch fails ``kernel_fits``, so the level recurrence takes
``ops.level_kernel.level_scan_giant``: the forward keeps hf alone and the
backward recomputes each level from it, so the step's memory does not grow
with L * Ep. Past 131,072 nodes (depth 256 and up) the struct towers are
rematerialised in the backward (``DGConfig.remat_struct``).

Prints per step the loss and the wall time, then the median step time, the
peak device memory and the launch counts of the giant kernels, with the
card's name and power limit.

    python -m mgvae_tpu_torch.examples.giant_circuit_training [depth] [remat]

``remat`` is ``on`` or ``off`` and sets ``DGConfig.remat_struct``; left
out, the config's own rule decides.

Needs one CUDA card and raises without one.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..data.batching import collate
from ..data.synthetic import layered_circuit
from ..models import dg_ae
from ..ops import level_kernel, struct_kernel
from ..train.step import make_optimizer, make_train_step

WIDTH, STEPS, LR = 512, 4, 1e-4
WEIGHTS = [1.0, 4.0, 2.0, 0.0]


def main(depth: int = 200, remat: bool | None = None) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("giant_circuit_training needs a CUDA card "
                           "(torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    g = layered_circuit(np.random.default_rng(0), "mig", width=WIDTH, depth=depth,
                        num_tt_pairs=512)
    t1 = time.perf_counter()
    batch = collate([g])
    t2 = time.perf_counter()
    n, ep, np_ = batch["gate"].shape[0], batch["lv_edge_src"].shape[1], batch["lv_nodes"].shape[1]
    print(f"layered circuit width {WIDTH} x depth {depth}: nodes {g.num_nodes} edges "
          f"{g.num_edges} levels {g.num_levels} (generated in {t1 - t0:.1f} s, collated in "
          f"{t2 - t1:.1f} s on the host)", flush=True)

    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, layernorm=True, remat_struct=remat,
                         matmul_precision="highest")
    print(f"padded N={n} E={batch['edge_src'].shape[0]} L={batch['lv_nodes'].shape[0]} Ep={ep} "
          f"Np={np_}; hf {n * cfg.dim_hidden * 4 / 1e6:.1f} MB; kernel_fits "
          f"{level_kernel.kernel_fits(n, ep, np_, cfg.dim_hidden)}; struct remat "
          f"{dg_ae.remat_struct(cfg, n)}", flush=True)
    params, state = dg_ae.init_params(cfg, seed=0, device=dev)
    train_step, _ = make_train_step(cfg, make_optimizer(params, LR))
    gen = torch.Generator(device=dev).manual_seed(0)

    level_kernel.giant_launches = level_kernel.giant_bwd_launches = 0
    struct_kernel.launches = struct_kernel.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for step in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(params, state, batch, gen, WEIGHTS)
        loss = float(m["loss"])            # reads the device: the step has ended
        times.append(time.perf_counter() - t0)
        tag = " (first step: builds or loads the kernels)" if step == 0 else ""
        print(f"step {step}: loss {loss:.4f} recon {float(m['recon_loss']):.4f} "
              f"[{times[-1] * 1e3:.1f} ms]{tag}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"train step at N={g.num_nodes} (padded {n}), depth {depth}: median of steps 1-"
          f"{STEPS - 1} {statistics.median(times[1:]) * 1e3:.1f} ms; peak device memory "
          f"{peak / 2**30:.3f} GiB; per step giant launches "
          f"{level_kernel.giant_launches // STEPS} forward / "
          f"{level_kernel.giant_bwd_launches // STEPS} backward, struct launches "
          f"{struct_kernel.launches // STEPS} / {struct_kernel.bwd_launches // STEPS}; "
          f"card: {card}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 200,
         {"on": True, "off": False}[sys.argv[2]] if len(sys.argv) > 2 else None)
