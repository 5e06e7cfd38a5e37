"""Where the level scans and their backwards spend their time on the card.

Default mode: one bs16 MIG batch of synthetic circuits (16 inputs, 264
gates; D = 64, 4 struct rounds, layernorm, random weights from seed 0: the
batch of ``chip_smoke.py``'s timing phases) through
``ops.level_kernel.level_scan`` three ways: the serving forward (no
residuals), the training forward (with residuals) and the backward alone.

``bf16`` mode: the same three calls with bf16 values
(``compute_dtype="bfloat16"``: kernels 1 and 2's bf16 instantiations).

``giant`` mode: the giant batch of ``chip_smoke.py`` phases 15-18 (one
layered MIG circuit, width 512 x depth 200, collated alone) through the
giant route's wrappers, the forward (kernel 3) and the backward that
recomputes from hf (kernel 4), and beside them the fused kernels on the
same inputs (kernel 1 without residuals, kernel 2 from saved residuals);
then kernel 4 at other chunk sizes K, in turns with the default
(``giant_chunk_levels``); then the peak device memory of the
giant route's level recurrence alone
(forward and backward through its autograd Function, above what is held
before) against hf + ghf's copy + d_pack_lv, the bytes of
``chip_smoke.py`` phase 17's check.

``giant bf16`` mode: kernels 3 and 4 on the giant batch with fp32 and with
bf16 values (``compute_dtype="bfloat16"``), in turns fp32, bf16, bf16, fp32
in one call, and the level recurrence's peak memory in both value types.
For each call it prints

  * the call's time by CUDA events (mean of ``REPS`` calls) and the host's
    time to enqueue one call;
  * under ``torch.profiler``, the device time per call of every device
    kernel and copy by name (the port's kernels and PyTorch's fills and
    copies that the wrapper issues), their sum, and the call's remainder:
    what the card waits between and around the launches.

    python -m mgvae_tpu_torch.examples.level_scan_profile [giant [bf16] | bf16]

Needs one CUDA card and raises without one.
"""
from __future__ import annotations

import collections
import subprocess
import sys
import time

import numpy as np
import torch

from ..data.batching import collate
from ..data.synthetic import layered_circuit, random_circuit
from ..models import dg_ae
from ..ops import _build, level_kernel

BATCH, DIM, ROUNDS, REPS = 16, 64, 4, 20
GIANT_WIDTH, GIANT_DEPTH, GIANT_REPS = 512, 200, 5


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


def report(tag: str, fn, reps: int = REPS) -> None:
    for _ in range(3):
        fn()
    ms = event_ms(fn, reps)
    host = enqueue_ms(fn, reps)
    names = by_name(fn, reps)
    total = sum(v[0] for v in names.values())
    count = sum(v[1] for v in names.values())
    print(f"[{tag}] {ms:.4f} ms per call by CUDA events; host enqueue {host:.4f} ms per call; "
          f"device time of its kernels and copies {total / 1e3:.4f} ms in {count:.1f} launches; "
          f"remainder {ms - total / 1e3:.4f} ms, {(ms - total / 1e3) / max(count, 1) * 1e3:.2f} "
          f"us a launch", flush=True)
    for name, (t, n) in sorted(names.items(), key=lambda kv: -kv[1][0]):
        print(f"[{tag}]   {t:10.2f} us in {n:6.1f} launches  {name[:100]}", flush=True)


def scan_args(batch, dev, tag: str, compute_dtype: str = "float32"):
    """The level scan's 12 arguments of a host batch (MIG, D = 64, random
    weights from seed 0) in ``compute_dtype``, its node count and its real
    levels."""
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                         layernorm=True, matmul_precision="highest", compute_dtype=compute_dtype)
    params, _ = dg_ae.init_params(cfg, seed=0, device=dev)
    b = dg_ae.batch_to_device(batch, dev)
    n_lv = dg_ae.num_levels(batch)
    with torch.no_grad():
        params = dg_ae.cast_params(params, cfg)
        hs = dg_ae.struct_hs(params, b, cfg)
        args = [a.detach().clone() for a in dg_ae.level_scan_inputs(params, b, cfg, hs)]
    N = hs.shape[0]
    print(f"{tag}: N={N} L={args[0].shape[0]} real levels {n_lv} Ep={args[0].shape[1]} "
          f"Np={args[4].shape[1]} T={cfg.num_experts} D={DIM}; valid edges "
          f"{int(args[3][:n_lv].sum())}, updated slots {int(args[5][:n_lv].sum())}", flush=True)
    return args, N, n_lv


def giant(dev) -> None:
    batch = collate([layered_circuit(np.random.default_rng(0), "mig", width=GIANT_WIDTH,
                                     depth=GIANT_DEPTH, num_tt_pairs=512)])
    args, N, n_lv = scan_args(batch, dev, f"giant MIG {GIANT_WIDTH} x {GIANT_DEPTH}")
    args = tuple(args)
    k = level_kernel.giant_chunk_levels(args[0].shape[1], args[4].shape[1], DIM,
                                        args[0].shape[0], N, args[11].shape[0])
    print(f"giant backward: levels per chunk K = {k}, "
          f"{level_kernel.giant_bwd_launch_count(n_lv, min(k, n_lv))} launches a call",
          flush=True)
    with torch.no_grad():
        report("giant forward (kernel 3)",
               lambda: level_kernel._giant_forward_cuda(args, N, n_lv), GIANT_REPS)
        report("fused forward on the giant batch (kernel 1)",
               lambda: level_kernel._forward_cuda(args, N, n_lv, residuals=False), GIANT_REPS)
        hf, res_e, res_n = level_kernel._forward_cuda(args, N, n_lv, residuals=True)
        ghf = torch.randn(hf.shape, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(5))
        report("giant backward (kernel 4)",
               lambda: level_kernel._giant_backward_cuda(ghf, hf, args, n_lv), GIANT_REPS)
        report("fused backward on the giant batch, from saved residuals (kernel 2)",
               lambda: level_kernel._backward_cuda(ghf, res_e, res_n, args, n_lv), GIANT_REPS)
        del res_e, res_n
        # kernel 4 at other chunk sizes, in turns with the default
        lists, packed = level_kernel._prepared(args, backward=True)
        per_level, fixed = level_kernel._giant_scratch_floats(
            args[0].shape[1], args[4].shape[1], DIM, args[11].shape[0])
        for kv in (k, 1, 3, 2 * k, 4 * k, k):
            run = lambda: level_kernel._giant_backward_cuda(ghf, hf, args, n_lv, lists, packed,
                                                            chunk_levels=kv)
            run()
            print(f"[giant backward by chunk] K = {kv}: {event_ms(run, GIANT_REPS):.4f} ms per "
                  f"call (lists built before), "
                  f"{level_kernel.giant_bwd_launch_count(n_lv, kv)} launches, scratch "
                  f"{4 * (kv * per_level + fixed) / 2**20:.2f} MiB", flush=True)
    recurrence_peak("giant memory", args, N, n_lv, ghf)


def recurrence_peak(tag: str, args, N: int, n_lv: int, ghf) -> None:
    """Prints the peak device memory of the giant route's level recurrence
    alone, forward and backward, against hf + ghf's copy + d_pack_lv (hf
    and d_pack_lv in the value type, the copy fp32)."""
    t = [a.clone().requires_grad_(i in level_kernel.FLOAT_ARGS) for i, a in enumerate(args)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = level_kernel.level_scan_giant(*t, num_nodes=N, num_levels=n_lv)
    torch.autograd.grad(out, [t[i] for i in level_kernel.FLOAT_ARGS], ghf)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    vb = args[0].element_size()
    law = N * DIM * (vb + 4) + args[0].numel() * vb
    print(f"[{tag}] level recurrence alone ({args[0].dtype}), forward and backward: peak "
          f"{peak / 2**20:.2f} MiB above what was held before; hf + ghf's copy + d_pack_lv "
          f"{law / 2**20:.2f} MiB; ratio {peak / law:.4f} (chip_smoke.py phase 17 allows 1.25 "
          f"in fp32)", flush=True)


def giant_bf16(dev) -> None:
    """Kernels 3 and 4 on the giant batch with fp32 and bf16 values, in
    turns, and the level recurrence's peak memory in both."""
    batch = collate([layered_circuit(np.random.default_rng(0), "mig", width=GIANT_WIDTH,
                                     depth=GIANT_DEPTH, num_tt_pairs=512)])
    calls = {}
    for dtype in ("float32", "bfloat16"):
        args, N, n_lv = scan_args(batch, dev, f"giant MIG {GIANT_WIDTH} x {GIANT_DEPTH} {dtype}",
                                  dtype)
        args = tuple(args)
        with torch.no_grad():
            hf = level_kernel._giant_forward_cuda(args, N, n_lv)
        ghf = torch.randn(hf.shape, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(5)).to(hf.dtype)
        calls[dtype] = (args, N, n_lv, hf, ghf)
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        args, N, n_lv, hf, ghf = calls[dtype]
        with torch.no_grad():
            report(f"giant forward (kernel 3) {dtype}",
                   lambda: level_kernel._giant_forward_cuda(args, N, n_lv), GIANT_REPS)
            report(f"giant backward (kernel 4) {dtype}",
                   lambda: level_kernel._giant_backward_cuda(ghf, hf, args, n_lv), GIANT_REPS)
    for dtype, (args, N, n_lv, _, ghf) in calls.items():
        recurrence_peak(f"giant memory {dtype}", args, N, n_lv, ghf)


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
    if sys.argv[1:2] == ["giant"]:
        giant_bf16(dev) if sys.argv[2:] == ["bf16"] else giant(dev)
        print(f"card: {card}", flush=True)
        return
    rng = np.random.default_rng(7)
    graphs = [random_circuit(rng, "mig", num_inputs=16, num_gates=264, num_tt_pairs=64)
              for _ in range(BATCH)]
    dtype = "bfloat16" if sys.argv[1:] == ["bf16"] else "float32"
    args, N, n_lv = scan_args(collate(graphs), dev, f"MIG bs{BATCH} {dtype}", dtype)
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
    ghf = torch.randn(hf.shape, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(5)).to(hf.dtype)
    report("backward", lambda: torch.autograd.grad(hf, diff, ghf, retain_graph=True))
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
