"""ctypes loader of the port's native host library (``mgvae_native.cpp``).

The C++ source is a byte-identical copy of the JAX package's
(``mgvae_tpu/native/mgvae_native.cpp``, ABI 3): levelization, binary AIGER
decoding, and the collate's table builders (``mg_collate_stats`` /
``mg_collate_fill`` per batch, ``mg_group_stats`` for many groups at once,
``mg_collate_step`` for a whole data-parallel step, threaded over shards).
The port keeps its own copy and its own build; it never loads the JAX
package's library.

The library is built by g++ at first use (``get_lib``) into
``mgvae_tpu_torch/_build/`` (git-ignored), under a name keyed by a hash of
the source and the flags, so an unchanged checkout builds once. Each build
writes a file of its own and ``os.replace``-s it into place, so processes
that build at once (test workers, data-parallel ranks) each load a whole
library. A failed build or load warns once with the compiler's output and
``get_lib`` returns None: every caller keeps its numpy branch, which gives
the same bytes. ``MGVAE_NO_NATIVE=1`` takes the numpy branches on purpose;
``MGVAE_COLLATE_THREADS`` caps the threads of the two threaded entry points
(default: the host's cores).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import time
import warnings
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "mgvae_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# must match mg_abi_version() in mgvae_native.cpp
ABI_VERSION = 3

_lib = None   # None: not loaded yet; False: unavailable (warned once)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float   # 0.0 when the library for this source was already built


def library_path() -> Path:
    """The library's path for this source and these flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libmgvae_native_{h.hexdigest()[:16]}.so"


def build() -> BuildResult:
    """Compile the library unless it exists for this source; raises
    RuntimeError with g++'s output when the compile fails."""
    out = library_path()
    if out.exists():
        return BuildResult(out, 0.0)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {SRC}:\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: a loader sees no file or a whole one
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {SRC}: {e}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return BuildResult(out, time.perf_counter() - t0)


def get_lib():
    """The loaded library, or None: under ``MGVAE_NO_NATIVE``, or after a
    failed build or load, which warns once. The first result is kept for
    the process's life."""
    global _lib
    if _lib is not None:
        return _lib or None
    if os.environ.get("MGVAE_NO_NATIVE"):
        _lib = False
        return None
    try:
        lib = ctypes.CDLL(str(build().path))
        _bind(lib)
        if lib.mg_abi_version() != ABI_VERSION:
            raise RuntimeError(f"{SRC.name} exports ABI {lib.mg_abi_version()}, the loader "
                               f"binds ABI {ABI_VERSION}")
    except (OSError, AttributeError, RuntimeError) as e:
        warnings.warn(f"the native host library is unavailable; the numpy branches run "
                      f"instead: {e}", RuntimeWarning, stacklevel=2)
        _lib = False
        return None
    _lib = lib
    return lib


def num_threads(work_items: int) -> int:
    """Threads for a threaded entry point: ``MGVAE_COLLATE_THREADS`` or the
    host's cores, at most one per work item."""
    want = int(os.environ.get("MGVAE_COLLATE_THREADS", "0")) or (os.cpu_count() or 1)
    return max(1, min(want, work_items))


def _bind(lib):
    lib.mg_abi_version.restype = ctypes.c_int32
    lib.mg_abi_version.argtypes = []
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    lib.mg_levelize.restype = i64
    lib.mg_levelize.argtypes = [i64, i64, i64p, i64p, i32p]
    lib.mg_aig_decode.restype = ctypes.c_int32
    lib.mg_aig_decode.argtypes = [u8p, i64, i32p, i64, i64p, i64p, i64, i64p, i64p]
    lib.mg_collate_stats.restype = i64
    lib.mg_collate_stats.argtypes = [i64, i32p, i64, i64p, i64p, i64, i64p]
    lib.mg_collate_fill.restype = ctypes.c_int32
    lib.mg_collate_fill.argtypes = (
        [i64, i32p, i64, i64p, i64p] + [i64] * 7
        + [i32p, i32p, i32p, i32p,
           i32p, u8p,
           i32p, i32p, u8p, i32p,
           i32p,
           i32p, i32p, u8p,
           i32p, i32p, u8p,
           f32p, f32p,
           i32p, i32p, i32p])
    lib.mg_group_stats.restype = ctypes.c_int32
    lib.mg_group_stats.argtypes = [i64, i64p, i64p, i64p, i64p, i64p, i64p,
                                   i32p, i64p, i64p, i64, i64, i64p]
    lib.mg_collate_step.restype = ctypes.c_int32
    lib.mg_collate_step.argtypes = (
        [i64, i64p, i64p, i64p, i64p,
         i32p, i32p, f32p, i64p, i64p, i64p, i64p, f32p]
        + [i64] * 10
        + [i32p, i32p, i32p, u8p, i32p, i32p, f32p,
           i32p, i32p, u8p,
           i32p, i32p, u8p, f32p,
           i32p, u8p, i32p, i32p, u8p, i32p, i32p,
           i32p, i32p, u8p, i32p, i32p, u8p,
           f32p, f32p, i32p, i32p, i32p,
           i32p, i32p, i32p])


_CTYPE = {np.dtype(np.int32): ctypes.c_int32, np.dtype(np.int64): ctypes.c_int64,
          np.dtype(np.uint8): ctypes.c_uint8, np.dtype(np.float32): ctypes.c_float}


def _ptr(a: np.ndarray, dtype):
    """A pointer to ``a``'s data, which must be C-contiguous and of
    ``dtype`` exactly (a bool array is passed as its uint8 view)."""
    if a.dtype == np.bool_ and np.dtype(dtype) == np.uint8:
        a = a.view(np.uint8)
    if a.dtype != np.dtype(dtype) or not a.flags.c_contiguous:
        raise ValueError(f"native call: expected a C-contiguous {np.dtype(dtype)} array, got "
                         f"{a.dtype} (contiguous: {a.flags.c_contiguous})")
    return a.ctypes.data_as(ctypes.POINTER(_CTYPE[np.dtype(dtype)]))


def _i32p(a):
    return _ptr(a, np.int32)


def _i64p(a):
    return _ptr(a, np.int64)


def _u8p(a):
    return _ptr(a, np.uint8)


def _f32p(a):
    return _ptr(a, np.float32)


def collate_stats_native(fwd: np.ndarray, esrc: np.ndarray, edst: np.ndarray, block: int):
    """(lv_real, np_real, ep_real, ebf_real, ebr_real) or None."""
    lib = get_lib()
    if lib is None:
        return None
    fwd = np.ascontiguousarray(fwd, dtype=np.int32)
    esrc = np.ascontiguousarray(esrc, dtype=np.int64)
    edst = np.ascontiguousarray(edst, dtype=np.int64)
    stats = np.zeros(5, dtype=np.int64)
    lib.mg_collate_stats(fwd.shape[0], _i32p(fwd), esrc.shape[0],
                         _i64p(esrc), _i64p(edst), block, _i64p(stats))
    return tuple(int(x) for x in stats)


def collate_fill_native(fwd, esrc, edst, dims: dict, block: int, dump: int,
                        out: dict | None = None):
    """The level and blocked tables built in C++, as a dict of arrays, or
    None without the library. ``dims``: the padded N / E / L / NP / EP /
    EBF / EBR. The arrays equal the numpy branch's.

    ``out``: optional dict of preallocated C-contiguous arrays (the same
    keys, the masks bool) filled in place: ``data/batching.collate(out=)``
    writes a shard straight into views of a stacked buffer. They are reset
    to the padding values here; the C++ side writes the live entries."""
    lib = get_lib()
    if lib is None:
        return None
    n = fwd.shape[0]
    e = esrc.shape[0]
    fwd = np.ascontiguousarray(fwd, dtype=np.int32)
    esrc = np.ascontiguousarray(esrc, dtype=np.int64)
    edst = np.ascontiguousarray(edst, dtype=np.int64)
    N, E, L, NP, EP, EBF, EBR = (dims[k] for k in ("N", "E", "L", "NP", "EP", "EBF", "EBR"))
    nb = N // block
    if out is None:
        o = {
            "perm": np.arange(N, dtype=np.int32),
            "inv": np.arange(N, dtype=np.int32),
            "edge_src": np.zeros(E, dtype=np.int32),
            "edge_dst": np.zeros(E, dtype=np.int32),
            "lv_nodes": np.full((L, NP), dump, dtype=np.int32),
            "lv_node_valid": np.zeros((L, NP), dtype=bool),
            "lv_edge_src": np.full((L, EP), dump, dtype=np.int32),
            "lv_edge_dst_slot": np.zeros((L, EP), dtype=np.int32),
            "lv_edge_valid": np.zeros((L, EP), dtype=bool),
            "lv_edge_id": np.full((L, EP), E - 1, dtype=np.int32),
            "edge_lv_row": np.zeros(E, dtype=np.int32),
            "lv_start": np.full(L, n, dtype=np.int32),
            "fa_src": np.full((nb, EBF), dump, dtype=np.int32),
            "fa_slot": np.zeros((nb, EBF), dtype=np.int32),
            "fa_valid": np.zeros((nb, EBF), dtype=bool),
            "ra_src": np.full((nb, EBR), dump, dtype=np.int32),
            "ra_slot": np.zeros((nb, EBR), dtype=np.int32),
            "ra_valid": np.zeros((nb, EBR), dtype=bool),
            "fa_eid": np.full((nb, EBF), E - 1, dtype=np.int32),
            "ra_eid": np.full((nb, EBR), E - 1, dtype=np.int32),
            "deg_in": np.zeros(N, dtype=np.float32),
            "deg_out": np.zeros(N, dtype=np.float32),
        }
    else:
        o = out
        o["perm"][:] = np.arange(N, dtype=np.int32)
        o["inv"][:] = o["perm"]
        for k in ("edge_src", "edge_dst", "lv_node_valid", "lv_edge_dst_slot",
                  "lv_edge_valid", "fa_slot", "fa_valid", "ra_slot",
                  "ra_valid", "deg_in", "deg_out", "edge_lv_row"):
            o[k].fill(0)
        for k in ("lv_nodes", "lv_edge_src", "fa_src", "ra_src"):
            o[k].fill(dump)
        for k in ("lv_edge_id", "fa_eid", "ra_eid"):
            o[k].fill(E - 1)
        o["lv_start"].fill(n)
    r = lib.mg_collate_fill(
        n, _i32p(fwd), e, _i64p(esrc), _i64p(edst),
        E, L, NP, EP, EBF, EBR, block,
        _i32p(o["perm"]), _i32p(o["inv"]),
        _i32p(o["edge_src"]), _i32p(o["edge_dst"]),
        _i32p(o["lv_nodes"]), _u8p(o["lv_node_valid"]),
        _i32p(o["lv_edge_src"]), _i32p(o["lv_edge_dst_slot"]),
        _u8p(o["lv_edge_valid"]), _i32p(o["lv_edge_id"]),
        _i32p(o["lv_start"]),
        _i32p(o["fa_src"]), _i32p(o["fa_slot"]), _u8p(o["fa_valid"]),
        _i32p(o["ra_src"]), _i32p(o["ra_slot"]), _u8p(o["ra_valid"]),
        _f32p(o["deg_in"]), _f32p(o["deg_out"]),
        _i32p(o["fa_eid"]), _i32p(o["ra_eid"]), _i32p(o["edge_lv_row"]),
    )
    if r != 0:
        raise ValueError(f"mg_collate_fill failed: {r} (dims too small?)")
    return o


def group_stats_native(group_ptr, graph_ids, graph_nodes, graph_edges,
                       node_off, edge_off, fwd_all, esrc_all, edst_all,
                       block: int, num_threads: int = 1):
    """The real table extents of many graph groups in one threaded C++ call
    (the trainer's dims scan): int64 [n_groups, 5] rows of {lv, np, ep,
    ebf, ebr}, or None without the library. Graphs are addressed by id
    into the dataset-wide arrays (``data/batching.GroupStatsCache``)."""
    lib = get_lib()
    if lib is None:
        return None
    n_groups = group_ptr.shape[0] - 1
    out = np.zeros(n_groups * 5, dtype=np.int64)
    r = lib.mg_group_stats(
        n_groups, _i64p(group_ptr), _i64p(graph_ids),
        _i64p(graph_nodes), _i64p(graph_edges),
        _i64p(node_off), _i64p(edge_off),
        _i32p(fwd_all), _i64p(esrc_all), _i64p(edst_all),
        block, num_threads, _i64p(out),
    )
    if r != 0:
        raise ValueError(f"mg_group_stats failed: {r}")
    return out.reshape(n_groups, 5)


def collate_step_native(shard_graphs, graph_nodes, graph_edges, graph_tt,
                        gate_all, fwd_all, prob_all, esrc_all, edst_all,
                        tta_all, ttb_all, ttdis_all,
                        dims: dict, block: int, big: dict,
                        num_threads: int = 1):
    """Collate every shard of a data-parallel step into the stacked
    [dp, ...] buffers ``big`` with one C++ call, threaded over the shards
    (ctypes releases the GIL for the call). The inputs are the step's graphs
    concatenated in shard order with their own node ids
    (``data/batching._collate_step_native``). Returns ``big``, or None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    dp = shard_graphs.shape[0]
    N, E, P, L, NP, EP, EBF, EBR = (dims[k] for k in ("N", "E", "P", "L", "NP", "EP", "EBF", "EBR"))
    r = lib.mg_collate_step(
        dp, _i64p(shard_graphs), _i64p(graph_nodes), _i64p(graph_edges),
        _i64p(graph_tt),
        _i32p(gate_all), _i32p(fwd_all), _f32p(prob_all),
        _i64p(esrc_all), _i64p(edst_all),
        _i64p(tta_all), _i64p(ttb_all), _f32p(ttdis_all),
        N, E, P, L, NP, EP, EBF, EBR, block, num_threads,
        _i32p(big["node_perm"]), _i32p(big["node_inv"]),
        _i32p(big["gate"]), _u8p(big["node_valid"]),
        _i32p(big["forward_level"]), _i32p(big["graph_id"]),
        _f32p(big["prob"]),
        _i32p(big["edge_src"]), _i32p(big["edge_dst"]), _u8p(big["edge_valid"]),
        _i32p(big["tt_pair_a"]), _i32p(big["tt_pair_b"]), _u8p(big["tt_valid"]),
        _f32p(big["tt_dis"]),
        _i32p(big["lv_nodes"]), _u8p(big["lv_node_valid"]),
        _i32p(big["lv_edge_src"]), _i32p(big["lv_edge_dst_slot"]),
        _u8p(big["lv_edge_valid"]), _i32p(big["lv_edge_id"]), _i32p(big["lv_start"]),
        _i32p(big["fa_src"]), _i32p(big["fa_slot"]), _u8p(big["fa_valid"]),
        _i32p(big["ra_src"]), _i32p(big["ra_slot"]), _u8p(big["ra_valid"]),
        _f32p(big["deg_in"]), _f32p(big["deg_out"]),
        _i32p(big["n_nodes"]), _i32p(big["n_edges"]), _i32p(big["n_tt"]),
        _i32p(big["fa_eid"]), _i32p(big["ra_eid"]), _i32p(big["edge_lv_row"]),
    )
    if r != 0:
        raise ValueError(f"mg_collate_step failed: {r} (dims too small?)")
    return big


def levelize_native(edge_index: np.ndarray, num_nodes: int):
    """int32 levels, or None without the library. Raises ValueError on a
    cycle, as the numpy branch does."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(edge_index[0], dtype=np.int64)
    dst = np.ascontiguousarray(edge_index[1], dtype=np.int64)
    out = np.zeros(num_nodes, dtype=np.int32)
    r = lib.mg_levelize(num_nodes, src.shape[0], _i64p(src), _i64p(dst), _i32p(out))
    if r < 0:
        raise ValueError("levelize: graph contains a cycle")
    return out


def aig_decode_native(data: bytes):
    """Decode binary AIGER: (gates int32 [N], edge_index int64 [2, E]), or
    None without the library or for a file it does not take."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    # capacity bounds of mgvae_native.cpp's mg_aig_decode
    header = data.split(b"\n", 1)[0].split()
    try:
        i, l, o, a = (int(x) for x in header[2:6])
    except ValueError:   # a malformed header: the Python decoder says why
        return None
    gates_cap = i + a + 2 * a + o + 4
    edges_cap = 2 * a + 2 * a + o + 4
    gates = np.zeros(gates_cap, dtype=np.int32)
    esrc = np.zeros(edges_cap, dtype=np.int64)
    edst = np.zeros(edges_cap, dtype=np.int64)
    nn = ctypes.c_int64()
    ne = ctypes.c_int64()
    r = lib.mg_aig_decode(
        _u8p(buf), buf.shape[0], _i32p(gates), gates_cap,
        _i64p(esrc), _i64p(edst), edges_cap,
        ctypes.byref(nn), ctypes.byref(ne),
    )
    if r != 0:
        return None
    n, e = nn.value, ne.value
    return gates[:n].copy(), np.stack([esrc[:e], edst[:e]]).copy()
