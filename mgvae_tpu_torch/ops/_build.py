"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into one shared
library with a plain C interface, at first use, and loaded with ``ctypes``:
one ``nvcc -c`` per source, all started together, then one link. The
library is keyed by a hash of the sources, the headers (``csrc/*.cuh``) and
the flags, and lives in ``mgvae_tpu_torch/_build/`` (git-ignored), so an
unchanged checkout builds once. A failed build raises with nvcc's output.

nvcc is found through ``CUDA_HOME``, then ``PATH``, then
``/usr/local/cuda/bin``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output (ptxas register / shared-memory report)


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def build() -> BuildResult:
    """Compile the kernels unless the library for these sources exists."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(srcs + list(CSRC_DIR.glob("*.cuh"))):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libmgvae_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs, logs = [], []
    try:
        for s, o in zip(srcs, objs):  # one compiler per source, all at once
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        for cmd, proc in procs:
            log = proc.communicate()[0]
            logs.append(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{logs[-1]}")
        os.replace(tmp, out)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for o in objs:
            o.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return BuildResult(out, time.perf_counter() - t0, "".join(logs))


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with argtypes set for every entry point
    (c_void_p for each pointer and the stream, so no pointer is cut to 32
    bits)."""
    lib = ctypes.CDLL(str(build().path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, pointers, ints in (("mgvae_level_lists", 10, 4),
                                 ("mgvae_level_scan_forward", 18, 6),
                                 ("mgvae_level_scan_backward", 24, 7),
                                 ("mgvae_level_scan_giant_backward", 31, 7),
                                 ("mgvae_level_step_forward", 17, 5),
                                 ("mgvae_level_step_backward", 22, 5),
                                 ("mgvae_level_scan_step_forward", 19, 8),
                                 ("mgvae_level_scan_step_backward", 25, 9)):
        fn = getattr(lib, name)
        fn.argtypes = [p] * pointers + [i] * ints + [p]     # ..., then the stream
        fn.restype = i
    fn = lib.mgvae_struct_towers_forward
    fn.argtypes = [p] * 12 + [i] * 5 + [p]
    fn.restype = i
    fn = lib.mgvae_struct_towers_backward
    fn.argtypes = [p] * 17 + [i] * 6 + [p]
    fn.restype = i
    fn = lib.mgvae_struct_towers_forward_layout
    fn.argtypes = [i, i, p]
    fn.restype = i
    lib.mgvae_cuda_error_string.argtypes = [i]
    lib.mgvae_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.mgvae_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
