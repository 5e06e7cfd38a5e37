"""Variants of the struct-tower forward kernel side by side on the card.

Each variant is a CUDA source with the C entry point
``mgvae_struct_towers_forward`` (``csrc/struct_towers.cu`` or a copy of it,
for example one with a phase switched off by a ``-D`` switch) and its
defines. Each is built alone with nvcc into its own library (all at once),
and ``ops.struct_kernel._forward_cuda`` is run through each in turn on two
MIG batches (D = 64, 4 rounds, layernorm, random weights from seed 0): the
bs16 batch of ``chip_smoke.py``'s timing phases and the giant batch (one
layered circuit of width 512 x depth 200). For each batch, without and with
residuals, it prints per variant the time by CUDA events in two turns
(variants in order, then in reverse), the device time of its kernels under
``torch.profiler``, its registers and stack from ``-Xptxas -v``, and
whether its outputs equal the first variant's bit for bit.

    python -m mgvae_tpu_torch.examples.struct_forward_variants \\
        new=mgvae_tpu_torch/csrc/struct_towers.cu old=/path/old.cu:SWITCH=1,OTHER

Needs one CUDA card and nvcc, and raises without them.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..data.batching import collate
from ..data.synthetic import layered_circuit, random_circuit
from ..models import dg_ae
from ..ops import _build, struct_kernel
from .level_scan_profile import by_name, event_ms

DIM, ROUNDS = 64, 4
REPS = {"bs16": 50, "giant": 5}


def build(source: Path, defines: list[str], out: Path) -> list[str]:
    """nvcc ``source`` alone into the shared library ``out``; returns the
    ptxas lines on registers, stack and spills."""
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(source),
           f"-I{_build.CSRC_DIR}", f"-I{source.parent}", *(f"-D{d}" for d in defines)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {source} {defines}:\n{r.stdout}{r.stderr}")
    return [l.strip() for l in (r.stdout + r.stderr).splitlines()
            if "registers" in l or "stack frame" in l]


class Library:
    """The variant's forward entry point beside the port's error strings."""

    def __init__(self, path: Path, main: ctypes.CDLL):
        fn = ctypes.CDLL(str(path)).mgvae_struct_towers_forward
        fn.argtypes = main.mgvae_struct_towers_forward.argtypes
        fn.restype = ctypes.c_int
        self.mgvae_struct_towers_forward = fn
        self.mgvae_cuda_error_string = main.mgvae_cuda_error_string


def inputs(batch: dict, dev) -> tuple:
    cfg = dg_ae.DGConfig(modality="mig", dim_hidden=DIM, s_rounds=ROUNDS, t_rounds=ROUNDS,
                         layernorm=True, matmul_precision="highest")
    params, _ = dg_ae.init_params(cfg, seed=0, device=dev)
    b = dg_ae.batch_to_device(batch, dev)
    with torch.no_grad():
        args = struct_kernel.struct_inputs(params["struct"], dg_ae.struct_input(b["gate"], cfg),
                                           b, True)
    return args, struct_kernel.struct_tables(b)


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("struct_forward_variants needs a CUDA card")
    variants = []
    for arg in argv:
        name, spec = arg.split("=", 1)
        source, _, defines = spec.partition(":")
        variants.append((name, Path(source).resolve(), [d for d in defines.split(",") if d]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    main_lib = _build.library()
    tmp = Path(tempfile.mkdtemp(prefix="struct_variants_"))
    with ThreadPoolExecutor(len(variants)) as ex:
        reports = list(ex.map(lambda v: build(v[1], v[2], tmp / f"{v[0]}.so"), variants))
    libs = {}
    for (name, source, defines), report in zip(variants, reports):
        libs[name] = Library(tmp / f"{name}.so", main_lib)
        for line in report:
            print(f"[{name}] {source.name} {defines}: {line}", flush=True)
    library = _build.library
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    batches = {
        "bs16": collate([random_circuit(rng, "mig", num_inputs=16, num_gates=264,
                                        num_tt_pairs=64) for _ in range(16)]),
        "giant": collate([layered_circuit(np.random.default_rng(0), "mig", width=512,
                                          depth=200, num_tt_pairs=512)]),
    }
    names = [v[0] for v in variants]
    try:
        for label, batch in batches.items():
            args, tables = inputs(batch, dev)
            for res in (False, True):
                call = lambda: struct_kernel._forward_cuda(args, tables, ROUNDS, True,
                                                           residuals=res)
                times, device_us, out = {n: [] for n in names}, {}, {}
                for n in names + names[::-1]:
                    _build.library = lambda n=n: libs[n]
                    call()
                    times[n].append(event_ms(call, REPS[label]))
                    if n not in out:
                        device_us[n] = sum(t for k, (t, _) in by_name(call, REPS[label]).items()
                                           if "struct_fwd" in k)
                        o = call()
                        out[n] = o if isinstance(o, tuple) else (o,)
                for n in names:
                    same = all(torch.equal(a, b) for a, b in zip(out[n], out[names[0]]))
                    diff = max((a - b).abs().max().item() for a, b in zip(out[n], out[names[0]]))
                    print(f"[{label} residuals={int(res)}] {n}: {times[n][0]:.4f} / "
                          f"{times[n][1]:.4f} ms by events, kernels' device time "
                          f"{device_us[n]:.1f} us a call; outputs equal to {names[0]}'s bit "
                          f"for bit: {same} (max |d| {diff:.3e})", flush=True)
    finally:
        _build.library = library
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
