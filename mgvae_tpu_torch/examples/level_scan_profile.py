"""Where the fused level scan and its backward spend their time on the card.

One bs16 MIG batch of synthetic circuits (16 inputs, 264 gates; D = 64,
4 struct rounds, layernorm, random weights from seed 0: the batch of
``chip_smoke.py``'s timing phases) through ``ops.level_kernel.level_scan``
three ways: the serving forward (no residuals), the training forward (with
residuals) and the backward alone. For each it prints

  * the call's time by CUDA events (mean of ``REPS`` calls) and the host's
    time to enqueue one call;
  * under ``torch.profiler``, the device time per call of every device
    kernel and copy by name (the port's kernels and PyTorch's fills and
    copies that the wrapper issues), their sum, and the call's remainder:
    what the card waits between and around the launches.

    python -m mgvae_tpu_torch.examples.level_scan_profile

Needs one CUDA card and raises without one.
"""
from __future__ import annotations

import collections
import subprocess
import time

import numpy as np
import torch

from ..data.batching import collate
from ..data.synthetic import random_circuit
from ..models import dg_ae
from ..ops import _build, level_kernel

BATCH, DIM, ROUNDS, REPS = 16, 64, 4, 20


def event_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / reps * 1e3


def by_name(fn, reps: int) -> dict:
    """Device microseconds per call of each device-side event, by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name][0] += e.time_range.elapsed_us() / reps
            us[e.name][1] += 1
    return {k: (v[0], v[1] / reps) for k, v in us.items()}


def report(tag: str, fn) -> None:
    for _ in range(3):
        fn()
    ms = event_ms(fn, REPS)
    host = enqueue_ms(fn, REPS)
    names = by_name(fn, REPS)
    total = sum(v[0] for v in names.values())
    print(f"[{tag}] {ms:.4f} ms per call by CUDA events; host enqueue {host:.4f} ms per call; "
          f"device time of its kernels and copies {total / 1e3:.4f} ms; remainder "
          f"{ms - total / 1e3:.4f} ms", flush=True)
    for name, (t, n) in sorted(names.items(), key=lambda kv: -kv[1][0]):
        print(f"[{tag}]   {t:10.2f} us in {n:6.1f} launches  {name[:100]}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("level_scan_profile needs a CUDA card "
                           "(torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    built = _build.build()
    print(f"card: {card}; kernels built in {built.seconds:.1f} s", flush=True)
    rng = np.random.default_rng(7)
    graphs = [random_circuit(rng, "mig", num_inputs=16, num_gates=264, num_tt_pairs=64)
              for _ in range(BATCH)]
    batch = collate(graphs)
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                         layernorm=True)
    params, _ = dg_ae.init_params(cfg, seed=0, device=dev)
    b = dg_ae.batch_to_device(batch, dev)
    n_lv = dg_ae.num_levels(batch)
    with torch.no_grad():
        hs = dg_ae.struct_hs(params, b, cfg)
        args = [a.detach().clone() for a in dg_ae.level_scan_inputs(params, b, cfg, hs)]
    N = hs.shape[0]
    print(f"MIG bs{BATCH}: N={N} L={args[0].shape[0]} real levels {n_lv} Ep={args[0].shape[1]} "
          f"Np={args[4].shape[1]} T={cfg.num_experts} D={DIM}; valid edges "
          f"{int(args[3][:n_lv].sum())}, updated slots {int(args[5][:n_lv].sum())}", flush=True)
    scan = dict(num_nodes=N, num_levels=n_lv)

    def serve():
        with torch.no_grad():
            return level_kernel.level_scan(*args, **scan)

    report("forward", serve)
    for i in level_kernel.FLOAT_ARGS:
        args[i].requires_grad_(True)
    report("forward with residuals", lambda: level_kernel.level_scan(*args, **scan))
    hf = level_kernel.level_scan(*args, **scan)
    diff = [args[i] for i in level_kernel.FLOAT_ARGS]
    ghf = torch.randn(hf.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    report("backward", lambda: torch.autograd.grad(hf, diff, ghf, retain_graph=True))
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
