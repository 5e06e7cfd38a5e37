"""Where the struct-tower forward and backward spend their time and memory
on the card.

Two MIG batches, D = 64, 4 struct rounds, layernorm, random weights from
seed 0: the bs16 batch of ``chip_smoke.py``'s timing phases (16 synthetic
circuits of 16 inputs and 264 gates) and the giant batch (one layered
circuit of width 512 x depth 200, collated alone). On each, through the
wrappers of ``ops.struct_kernel``, the forward without residuals (serving),
the forward with residuals (training), and then the backward alone on those
residuals with a fixed random cotangent. For each it prints

  * the call's time by CUDA events (mean of ``REPS`` calls) and the host's
    time to enqueue one call;
  * under ``torch.profiler``, the device time per call of every device
    kernel and copy by name, and their sum;
  * ``torch.cuda.max_memory_allocated`` of one call above what was
    allocated before it (outputs and scratch).

    python -m mgvae_tpu_torch.examples.struct_towers_profile [bf16]

With ``bf16`` the same calls take bf16 values (``compute_dtype="bfloat16"``:
kernels 7 and 8's bf16 instantiations).

Needs one CUDA card and raises without one.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ..data.batching import collate
from ..data.synthetic import layered_circuit, random_circuit
from ..models import dg_ae
from ..ops import _build, struct_kernel
from .level_scan_profile import by_name, enqueue_ms, event_ms

DIM, ROUNDS = 64, 4
REPS = {"bs16": 20, "giant": 5}


def peak_mib(fn) -> float:
    """MiB allocated at the peak of one call of ``fn``, above the start."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def report(tag: str, fn, reps: int) -> None:
    for _ in range(2):
        fn()
    ms = event_ms(fn, reps)
    host = enqueue_ms(fn, reps)
    names = by_name(fn, reps)
    total = sum(v[0] for v in names.values())
    print(f"[{tag}] {ms:.4f} ms per call by CUDA events; host enqueue {host:.4f} ms per call; "
          f"device time of its kernels and copies {total / 1e3:.4f} ms; "
          f"peak above the start {peak_mib(fn):.1f} MiB", flush=True)
    for name, (t, n) in sorted(names.items(), key=lambda kv: -kv[1][0]):
        print(f"[{tag}]   {t:10.2f} us in {n:6.1f} launches  {name[:100]}", flush=True)


def profile_batch(label: str, batch: dict, dev, compute_dtype: str = "float32") -> None:
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                         layernorm=True, matmul_precision="highest", compute_dtype=compute_dtype)
    params, _ = dg_ae.init_params(cfg, seed=0, device=dev)
    b = dg_ae.batch_to_device(batch, dev)
    with torch.no_grad():
        params = dg_ae.cast_params(params, cfg)
        args = struct_kernel.struct_inputs(params["struct"], dg_ae.struct_input(b["gate"], cfg),
                                           b, True)
        tables = struct_kernel.struct_tables(b)
    N = args[0].shape[2]
    res_mib = 2 * ROUNDS * 2 * N * 7 * DIM * args[0].element_size() / 2**20
    print(f"[{label}] {compute_dtype}: N={N} edges {int(batch['n_edges'])} D={DIM} half-rounds "
          f"{2 * ROUNDS}; residuals {res_mib:.1f} MiB", flush=True)
    reps = REPS[label]
    serve = lambda: struct_kernel._forward_cuda(args, tables, ROUNDS, True, residuals=False)
    struct_kernel.launches = 0
    serve()
    print(f"[{label}] forward launches per call {struct_kernel.launches}", flush=True)
    report(f"{label} forward without residuals", serve, reps)
    fwd = lambda: struct_kernel._forward_cuda(args, tables, ROUNDS, True, residuals=True)
    report(f"{label} forward with residuals", fwd, reps)
    _, res = fwd()
    dstate = torch.randn((2, N, DIM), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6)).to(res.dtype)
    bwd = lambda: struct_kernel._backward_cuda(dstate, res, args[1], args[2], args[4], tables,
                                               ROUNDS, True)
    struct_kernel.bwd_launches = 0
    bwd()
    print(f"[{label}] backward launches per call {struct_kernel.bwd_launches}", flush=True)
    report(f"{label} backward", bwd, reps)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("struct_towers_profile needs a CUDA card "
                           "(torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    built = _build.build()
    print(f"card: {card}; kernels built in {built.seconds:.1f} s", flush=True)
    rng = np.random.default_rng(7)
    bs16 = collate([random_circuit(rng, "mig", num_inputs=16, num_gates=264, num_tt_pairs=64)
                    for _ in range(16)])
    dtype = "bfloat16" if sys.argv[1:] == ["bf16"] else "float32"
    profile_batch("bs16", bs16, dev, dtype)
    giant = collate([layered_circuit(np.random.default_rng(0), "mig", width=512, depth=200,
                                     num_tt_pairs=512)])
    profile_batch("giant", giant, dev, dtype)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
