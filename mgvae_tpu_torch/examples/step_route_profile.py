"""Where the step route spends its time on the card: a chunked batch whose
chunks are too large for the fused scan, through
``models.dg_ae.level_scan_step``.

64 synthetic MIG circuits (16 inputs, 264 gates; D = 64, random weights from
seed 0) collated into two chunks, as ``chip_smoke.py``'s step-route phases.
The forward and the backward (a fixed random cotangent) are measured apart:

  * the time of each by CUDA events and the host's time to enqueue it,
    means over ``RUNS`` runs;
  * under ``torch.profiler``, one run of each: the host time of every
    top-level host operation by name (the wrappers' autograd Functions, and
    the indexing, scatter, selection and accumulation nodes around them),
    the device time of every kernel and copy by name, the device's busy
    time (the union of its kernels' intervals) and its idle gaps within the
    run;
  * the launches of the step kernels that each pass counted;
  * the peak device memory of one forward and backward above what was held
    before, beside the stacked residuals + hf + ghf's copy + d_pack_lv.

    python -m mgvae_tpu_torch.examples.step_route_profile [loop | bf16]

``loop``: the same for ``dg_ae.level_step_loop`` on the card, one
``level_step`` per (chunk, level) with the scatter in torch between the
calls, the route's plain structure. ``bf16``: the route with bf16 values
(``compute_dtype="bfloat16"``: kernels 5 and 6's bf16 instantiations), its
timed runs in turns with fp32's (fp32, bf16, bf16, fp32) in one call, the
profile and the peak of the bf16 route. Needs one CUDA card and raises
without one.
"""
from __future__ import annotations

import collections
import dataclasses
import subprocess
import sys
import time

import numpy as np
import torch

from ..data.batching import collate_chunked
from ..data.synthetic import random_circuit
from ..models import dg_ae
from ..ops import level_kernel

CIRCUITS, CHUNKS, DIM, ROUNDS, RUNS = 64, 2, 64, 4, 5


def _profiled(fn):
    """(host ms by top-level host operation, device (ms, launches) by kernel
    name, device busy ms, wall ms of the window) of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    host = collections.defaultdict(float)
    dev = collections.defaultdict(lambda: [0.0, 0])
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.name][0] += e.time_range.elapsed_us() / 1e3
            dev[e.name][1] += 1
            spans.append((e.time_range.start, e.time_range.end))
        elif e.cpu_parent is None:
            host[e.name] += e.cpu_time_total / 1e3
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return host, dev, busy / 1e3, wall


def _report(tag, host, dev, busy, wall, launches):
    n = sum(v[1] for v in dev.values())
    print(f"[{tag}] one run under the profiler: wall {wall:.3f} ms; host time of top-level "
          f"operations {sum(host.values()):.3f} ms; device busy {busy:.3f} ms in {n} kernels and "
          f"copies; device idle {wall - busy:.3f} ms; step kernels launched "
          f"{launches}", flush=True)
    for name, ms in sorted(host.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[{tag}]   host {ms:9.3f} ms  {name[:100]}", flush=True)
    for name, (ms, k) in sorted(dev.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"[{tag}]   device {ms:9.3f} ms in {k:5d} launches  {name[:90]}", flush=True)


def _scan_args(params, b, cfg):
    """The route's 12 arguments in ``cfg``'s value type, the float ones
    requiring grad, and hs's row count."""
    with torch.no_grad():
        params = dg_ae.cast_params(params, cfg)
        hs = dg_ae.struct_hs(params, b, cfg)
        args = [a.detach().clone() for a in dg_ae.level_scan_inputs(params, b, cfg, hs)]
    for i in level_kernel.FLOAT_ARGS:
        args[i].requires_grad_(True)
    return args, hs.shape[0]


def main(argv=()) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("step_route_profile needs a CUDA card "
                           "(torch.cuda.is_available() is False)")
    loop, bf16 = "loop" in argv, "bf16" in argv
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
                         layernorm=True, matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, seed=0, device=dev)
    b = dg_ae.batch_to_device(batch, dev)
    counts = dg_ae.level_counts(batch)
    dtypes = ("float32", "bfloat16") if bf16 else ("float32",)
    cases = {d: _scan_args(params, b, dataclasses.replace(cfg, compute_dtype=d)) for d in dtypes}
    args, N = cases[dtypes[-1]]
    n_sub = N // CHUNKS
    route = dg_ae.level_step_loop if loop else dg_ae.level_scan_step
    name = "loop" if loop else "route"
    print(f"[{name}] card: {card}; {CIRCUITS} MIG circuits in {CHUNKS} chunks: N_sub={n_sub} "
          f"Ep={args[0].shape[1]} Np={args[4].shape[1]}, real levels {counts}; "
          f"{'dg_ae.level_step_loop' if loop else 'dg_ae.level_scan_step'}, values "
          f"{' and '.join(dtypes)}", flush=True)
    g = torch.randn((N, DIM), device=dev, generator=torch.Generator(device=dev).manual_seed(1))

    def forward(args):
        lists, packed = dg_ae.kernel_inputs(tuple(args))
        return route(tuple(args), counts, n_sub, lists, packed)

    def backward(args, hf):
        torch.autograd.grad(hf, [args[i] for i in level_kernel.FLOAT_ARGS], g.to(hf.dtype))

    def timed(dtype):
        args = cases[dtype][0]
        for _ in range(3):
            backward(args, forward(args))
        fwd_ev, bwd_ev, fwd_host, bwd_host = [], [], [], []
        for _ in range(RUNS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            ev[0].record()
            t0 = time.perf_counter()
            hf = forward(args)
            t1 = time.perf_counter()
            ev[1].record()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            backward(args, hf)
            t3 = time.perf_counter()
            ev[2].record()
            torch.cuda.synchronize()
            fwd_ev.append(ev[0].elapsed_time(ev[1]))
            bwd_ev.append(ev[1].elapsed_time(ev[2]))
            fwd_host.append((t1 - t0) * 1e3)
            bwd_host.append((t3 - t2) * 1e3)
        mean = lambda x: sum(x) / len(x)
        print(f"[{name} {dtype}] {RUNS} runs, means: forward {mean(fwd_ev):.3f} ms by CUDA "
              f"events, host enqueue {mean(fwd_host):.3f} ms; backward {mean(bwd_ev):.3f} ms by "
              f"CUDA events (from the end of its forward), host enqueue {mean(bwd_host):.3f} ms; "
              f"per run (forward, backward) ms: "
              f"{[(round(a, 3), round(c, 3)) for a, c in zip(fwd_ev, bwd_ev)]}", flush=True)

    for dtype in ((*dtypes, *dtypes[::-1]) if bf16 else dtypes):
        timed(dtype)

    held = []
    level_kernel.step_launches = level_kernel.step_bwd_launches = 0
    prof = _profiled(lambda: held.append(forward(args)))
    _report(f"{name} forward", *prof, level_kernel.step_launches)
    prof = _profiled(lambda: backward(args, held.pop()))
    _report(f"{name} backward", *prof, level_kernel.step_bwd_launches)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    backward(args, forward(args))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    L, ep, np_ = args[0].shape[0], args[0].shape[1], args[4].shape[1]
    vb = args[0].element_size()     # the residuals, hf, ghf's copy and d_pack_lv: the value type
    res = vb * L * (ep * (3 * DIM + 1) + np_ * 4 * DIM)
    law = res + 2 * vb * N * DIM + args[0].numel() * vb
    print(f"[{name}] level recurrence alone ({args[0].dtype}), forward and backward: peak "
          f"{peak / 2**20:.2f} MiB above what was held before; stacked residuals "
          f"{res / 2**20:.2f} + hf + ghf's copy + d_pack_lv = {law / 2**20:.2f} MiB (ratio "
          f"{peak / law:.3f}); {card}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
