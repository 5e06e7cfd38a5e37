"""The fp32 outputs and times of the level kernels (TPU kernels 1 to 6) on
``chip_smoke.py``'s batches, so that two trees of the port can be held
against each other on one card: bit for bit, and in time.

    PYTHONPATH=<tree> python <this file> dump OUT.pt     # once per tree
    python <this file> compare A.pt B.pt [C.pt ...]      # the dumps of one card

``dump`` imports ``mgvae_tpu_torch`` from ``PYTHONPATH`` (this file uses
absolute imports only, so it runs against any tree whose wrappers take the
same arguments), builds that tree's kernels, and on three batches (MIG,
D = 64, 4 struct rounds, layernorm, random weights from seed 0) runs each
kernel's wrapper in fp32 with fixed random cotangents: kernels 1 and 2 (the
fused scan with residuals and its backward) on a bs16 batch of synthetic
circuits (16 inputs, 264 gates), kernels 5 and 6 (the step route's passes)
on 64 of them in two chunks, kernels 3 and 4 (the giant scan and its
backward) on the layered circuit of width 512 and depth 200. It saves the
outputs (the residuals on the rows the kernels write) and prints each
call's time by CUDA events (mean of ``REPS`` calls, the giant backward's
of ``GIANT_REPS``) with the card's name and power limit. ``compare`` says
for each output whether the dumps are equal bit for bit, and prints the
times of the dumps side by side: run ``dump`` for the two trees in turns
(A, B, B, A) in one call.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

REPS, GIANT_REPS = 10, 5


def _event_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _written(level_kernel, args, n_rows, res_e, res_n):
    """The residuals with the rows the kernels do not write set to 0."""
    e_live, s_live = level_kernel.live_rows(args[2], args[3], args[5])
    e_live[n_rows:], s_live[n_rows:] = False, False
    return torch.where(e_live[..., None], res_e, 0.0), torch.where(s_live[..., None], res_n, 0.0)


def dump(path: str) -> None:
    import mgvae_tpu_torch
    from mgvae_tpu_torch import collate, collate_chunked, layered_circuit, random_circuit
    from mgvae_tpu_torch.models import dg_ae
    from mgvae_tpu_torch.ops import _build, level_kernel

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_outputs needs a CUDA card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    built = _build.build()
    print(f"tree {mgvae_tpu_torch.__file__}; card {card}; kernels built in {built.seconds:.1f} s",
          flush=True)
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=64, s_rounds=4, t_rounds=4, layernorm=True,
                         matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, seed=0, device=dev)

    def scan_args(batch):
        b = dg_ae.batch_to_device(batch, dev)
        with torch.no_grad():
            hs = dg_ae.struct_hs(params, b, cfg)
            return tuple(a.detach().clone() for a in dg_ae.level_scan_inputs(params, b, cfg, hs))

    def cotangent(shape, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, device=dev, generator=gen)

    rng = np.random.default_rng(0)
    graphs = [random_circuit(rng, "mig", num_inputs=16, num_gates=264, num_tt_pairs=64)
              for _ in range(64)]
    out, times = {}, {}
    with torch.no_grad():
        # kernels 1 and 2 on bs16
        bs16 = collate(graphs[:16])
        args, n_lv, N = scan_args(bs16), dg_ae.num_levels(bs16), bs16["gate"].shape[0]
        hf, re, rn = level_kernel._forward_cuda(args, N, n_lv, residuals=True)
        ghf = cotangent(hf.shape, 1)
        out["k1 hf"] = hf
        out["k1 res_e"], out["k1 res_n"] = _written(level_kernel, args, n_lv, re, rn)
        for name, x in zip(("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak"),
                           level_kernel._backward_cuda(ghf, re, rn, args, n_lv)):
            out[f"k2 {name}"] = x
        times["kernel 1 (with residuals)"] = _event_ms(
            lambda: level_kernel._forward_cuda(args, N, n_lv, residuals=True), REPS)
        times["kernel 2"] = _event_ms(
            lambda: level_kernel._backward_cuda(ghf, re, rn, args, n_lv), REPS)
        # kernels 5 and 6: the step route's passes on 64 circuits in two chunks
        chunked = collate_chunked(graphs, 2)
        args, counts = scan_args(chunked), dg_ae.level_counts(chunked)
        n_sub = chunked["gate"].shape[0] // 2
        prep = level_kernel._prepared(args, backward=True)
        hf, re, rn = level_kernel._step_route_forward_cuda(args, counts, n_sub, True, *prep)
        ghf = cotangent(hf.shape, 2)
        out["k5 hf"] = hf
        out["k5 res_e"], out["k5 res_n"] = _written(level_kernel, args, args[0].shape[0], re, rn)
        for name, x in zip(("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak"),
                           level_kernel._step_route_backward_cuda(ghf, re, rn, args, counts,
                                                                  n_sub, *prep)):
            out[f"k6 {name}"] = x
        times["kernel 5 (the route's forward pass)"] = _event_ms(
            lambda: level_kernel._step_route_forward_cuda(args, counts, n_sub, True, *prep), REPS)
        times["kernel 6 (the route's backward pass)"] = _event_ms(
            lambda: level_kernel._step_route_backward_cuda(ghf, re, rn, args, counts, n_sub,
                                                           *prep), REPS)
        # kernels 3 and 4 on the giant batch
        giant = collate([layered_circuit(np.random.default_rng(0), "mig", width=512, depth=200,
                                         num_tt_pairs=512)])
        args, n_lv, N = scan_args(giant), dg_ae.num_levels(giant), giant["gate"].shape[0]
        hf = level_kernel._giant_forward_cuda(args, N, n_lv)
        ghf = cotangent(hf.shape, 3)
        out["k3 hf"] = hf
        for name, x in zip(("d_pack", "d_wkv", "d_wih", "d_bih", "d_bhh", "d_wak"),
                           level_kernel._giant_backward_cuda(ghf, hf, args, n_lv)):
            out[f"k4 {name}"] = x
        times["kernel 3"] = _event_ms(lambda: level_kernel._giant_forward_cuda(args, N, n_lv),
                                      REPS)
        times["kernel 4"] = _event_ms(
            lambda: level_kernel._giant_backward_cuda(ghf, hf, args, n_lv), GIANT_REPS)
    for name, ms in times.items():
        print(f"[time] {name}: {ms:.4f} ms (CUDA events); {card}", flush=True)
    torch.save({"outputs": {k: v.cpu() for k, v in out.items()}, "times": times, "card": card,
                "tree": mgvae_tpu_torch.__file__}, path)


def compare(paths) -> int:
    dumps = [torch.load(p) for p in paths]
    first = dumps[0]["outputs"]
    differ = []
    for name, x in first.items():
        same = all(torch.equal(x, d["outputs"][name]) for d in dumps[1:])
        if not same:
            differ.append(name)
        print(f"[outputs] {name} {tuple(x.shape)}: {'equal bit for bit' if same else 'DIFFER'} "
              f"across {len(dumps)} dumps", flush=True)
    for name in dumps[0]["times"]:
        print(f"[time] {name}: " + ", ".join(f"{d['tree']} {d['times'][name]:.4f} ms"
                                             for d in dumps), flush=True)
    print(f"card {dumps[0]['card']}; outputs that differ: {differ or 'none'}", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["dump"] and len(sys.argv) == 3:
        dump(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) >= 4:
        sys.exit(compare(sys.argv[2:]))
    else:
        sys.exit("usage: kernel_outputs.py dump OUT.pt | compare A.pt B.pt [...]")
