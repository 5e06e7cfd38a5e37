"""Host and device time of the step route (a chunked batch whose chunks are
too large for the fused scan: one ``level_step`` per (chunk, level)).

64 synthetic MIG circuits (16 inputs, 264 gates; D = 64, random weights from
seed 0) collated into two chunks, as ``chip_smoke.py``'s step-route phases;
``models.dg_ae.level_scan_step`` forward and backward, five times: per run
the host's time to enqueue it and the wall time to the end of the device's
work (equal where the host is what the route waits for), then under
``torch.profiler`` the device time of one run in all and by kernel name.

    python -m mgvae_tpu_torch.examples.step_route_profile

Needs one CUDA card and raises without one.
"""
from __future__ import annotations

import collections
import subprocess
import time

import numpy as np
import torch

from ..data.batching import collate_chunked
from ..data.synthetic import random_circuit
from ..models import dg_ae
from ..ops import level_kernel

CIRCUITS, CHUNKS, DIM, ROUNDS, RUNS = 64, 2, 64, 4, 5


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("step_route_profile needs a CUDA card "
                           "(torch.cuda.is_available() is False)")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(7)
    graphs = [random_circuit(rng, "mig", num_inputs=16, num_gates=264, num_tt_pairs=64)
              for _ in range(CIRCUITS)]
    batch = collate_chunked(graphs, CHUNKS)
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                         layernorm=True)
    params, _ = dg_ae.init_params(cfg, seed=0, device=dev)
    b = dg_ae.batch_to_device(batch, dev)
    counts = dg_ae.level_counts(batch)
    with torch.no_grad():
        hs = dg_ae.struct_hs(params, b, cfg)
        args = [a.detach().clone() for a in dg_ae.level_scan_inputs(params, b, cfg, hs)]
    for i in level_kernel.FLOAT_ARGS:
        args[i].requires_grad_(True)
    n_sub = hs.shape[0] // CHUNKS
    print(f"card: {card}; {CIRCUITS} MIG circuits in {CHUNKS} chunks: N_sub={n_sub} "
          f"Ep={args[0].shape[1]} Np={args[4].shape[1]}, real levels {counts}", flush=True)

    def run():
        dg_ae.level_scan_step(tuple(args), counts, n_sub).sum().backward()

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        run()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        times.append((round((t1 - t0) * 1e3, 1), round((time.perf_counter() - t0) * 1e3, 1)))
    print(f"forward and backward, {RUNS} runs, (host enqueue, wall) ms: {times}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    us = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name][0] += e.time_range.elapsed_us()
            us[e.name][1] += 1
    print(f"device time of one run: {sum(v[0] for v in us.values()) / 1e3:.3f} ms", flush=True)
    for name, (t, n) in sorted(us.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t / 1e3:8.3f} ms in {n:5d} launches  {name[:100]}", flush=True)


if __name__ == "__main__":
    main()
