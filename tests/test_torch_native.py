"""The port's native host library (``mgvae_tpu_torch/native``) on the CPU:
its build and load, its entry points against the port's numpy branches, and
its batches and dims against the JAX package's.

The library is built here by g++ (no card needed), so none of these tests
skips. Native against numpy in one process: ``native._lib`` set to False
(what ``get_lib`` keeps after ``MGVAE_NO_NATIVE=1``) sends every caller to
its numpy branch, and is restored after. The whole-epoch comparison also
runs under ``MGVAE_NO_NATIVE=1`` in a subprocess. The threaded entry
points are pinned to two threads (``MGVAE_COLLATE_THREADS``), as the tests
share the host with other workers. Everything is compared byte for byte:
keys, dtypes, shapes and values."""
import json
import os
import runpy
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

from mgvae_tpu.data import aiger as jaiger
from mgvae_tpu.data import batching as jbatching
from mgvae_tpu.data import synthetic as jsynthetic
from mgvae_tpu_torch import native
from mgvae_tpu_torch.data import aiger, batching, levelize, synthetic
from test_torch_aiger import _circuit, _write

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODALITIES = ("mig", "aig", "xag", "xmg")


@pytest.fixture(autouse=True)
def two_threads(monkeypatch):
    monkeypatch.setenv("MGVAE_COLLATE_THREADS", "2")


@pytest.fixture
def numpy_branch(monkeypatch):
    """Within the test: every caller takes its numpy branch."""
    def on():
        monkeypatch.setattr(native, "_lib", False)

    return on


def _lib():
    lib = native.get_lib()
    assert lib is not None, "the native library must build and load here"
    return lib


def _same(a: dict, b: dict, path=""):
    assert set(a) == set(b), path
    for k in a:
        if k == "groups":
            for g, (x, y) in enumerate(zip(a[k], b[k], strict=True)):
                _same(x, y, f"{path}groups/{g}/")
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, path + k
        assert np.array_equal(x, y), path + k


def _pair(seed, n, gates=(30, 200), tt=(0, 24)):
    """The same ragged circuits of every modality from both packages."""
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    kw = []
    r = np.random.default_rng(seed + 1000)
    for i in range(n):
        kw.append(dict(modality=MODALITIES[i % 4], num_inputs=6,
                       num_gates=int(r.integers(*gates)), num_tt_pairs=int(r.integers(*tt))))
    ga = [jsynthetic.random_circuit(ra, k.pop("modality"), **k) for k in [dict(x) for x in kw]]
    gb = [synthetic.random_circuit(rb, k.pop("modality"), **k) for k in [dict(x) for x in kw]]
    return ga, gb


# ---- the build ---------------------------------------------------------------

def test_source_is_the_jax_packages_at_abi_3():
    """The port's .cpp is the JAX package's byte for byte; the port loads its
    own build of it, from the port's build directory."""
    with open(os.path.join(REPO, "mgvae_tpu", "native", "mgvae_native.cpp"), "rb") as f:
        assert native.SRC.read_bytes() == f.read()
    lib = _lib()
    assert lib.mg_abi_version() == native.ABI_VERSION == 3
    assert native.library_path().parent == native.BUILD_DIR
    assert str(native.BUILD_DIR) == os.path.join(REPO, "mgvae_tpu_torch", "_build")
    assert lib._name == str(native.library_path())


BUILDER = r'''
import importlib.util, sys, time
from pathlib import Path
spec = importlib.util.spec_from_file_location("port_native", sys.argv[1])
n = importlib.util.module_from_spec(spec)
sys.modules["port_native"] = n
spec.loader.exec_module(n)
n.BUILD_DIR = Path(sys.argv[2])
while time.time() < float(sys.argv[3]):   # start the four builds together
    time.sleep(0.001)
lib = n.get_lib()
assert lib is not None and lib.mg_abi_version() == 3
import numpy as np
print(n.levelize_native(np.array([[0, 1, 0], [1, 2, 2]]), 3).tolist())
'''


def test_four_processes_building_at_once_each_load_a_whole_library(tmp_path):
    """Four processes build into one empty directory at the same moment:
    each writes a file of its own and renames it into place, so each loads
    a valid library, and no partial file is left."""
    script = tmp_path / "builder.py"
    script.write_text(BUILDER)
    build = tmp_path / "build"
    start = time.time() + 2.0
    env = {k: v for k, v in os.environ.items() if k != "MGVAE_NO_NATIVE"}
    argv = [sys.executable, "-W", "error::RuntimeWarning", str(script), native.__file__,
            str(build), str(start)]
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for _ in range(4)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert all(o.strip().splitlines()[-1] == "[0, 1, 2]" for o in outs), outs
    assert sorted(p.name for p in build.iterdir()) == [native.library_path().name]


def test_no_native_takes_the_numpy_branch(monkeypatch):
    """MGVAE_NO_NATIVE=1: no library, no warning, and every caller's numpy
    branch gives the native bytes."""
    ga, gb = _pair(3, 6)
    want = batching.collate(gb, mp=2)
    cache = batching.GroupStatsCache(gb)
    assert cache.group_dims([np.arange(3)]) is not None
    monkeypatch.setenv("MGVAE_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert native.get_lib() is None
    assert native._lib is False
    assert batching.shard_dims(gb) is None and cache.group_dims([np.arange(3)]) is None
    assert batching.chunked_shard_dims(gb, 2) is None
    assert native.levelize_native(gb[0].edge_index, gb[0].num_nodes) is None
    _same(batching.collate(gb, mp=2), want)


def test_a_failed_build_warns_once_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "mgvae_native.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("MGVAE_NO_NATIVE", raising=False)
    with pytest.warns(RuntimeWarning, match=r"(?s)g\+\+ failed .*error"):
        assert native.get_lib() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert native.get_lib() is None
    assert not list((tmp_path / "build").glob("*"))   # no partial library left


def test_native_module_imports_no_jax():
    """The loader and the data layer on it import neither jax nor the JAX
    package, and the library they load is the port's."""
    code = ("import sys; import mgvae_tpu_torch.native as n, mgvae_tpu_torch.data.batching as b; "
            "from mgvae_tpu_torch.data.synthetic import random_circuit; import numpy as np; "
            "lib = n.get_lib(); assert lib is not None and 'mgvae_tpu_torch' in lib._name; "
            "g = [random_circuit(np.random.default_rng(0), 'mig', num_gates=20)]; "
            "b.collate(g); b.GroupStatsCache(g).group_dims([np.arange(1)]); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'mgvae_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "MGVAE_NO_NATIVE")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


# ---- the entry points against the numpy branches -------------------------------

def test_native_levelize_matches_numpy(numpy_branch):
    rng = np.random.default_rng(0)
    gs = [synthetic.random_circuit(rng, "xmg", num_inputs=6, num_gates=80) for _ in range(5)]
    _lib()
    got = [native.levelize_native(g.edge_index, g.num_nodes) for g in gs]
    numpy_branch()
    for g, a in zip(gs, got):
        b = levelize.levelize(g.edge_index, g.num_nodes)
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
        assert np.array_equal(a, g.forward_level)


def test_native_levelize_cycle(numpy_branch):
    edge = np.array([[0, 1, 2], [1, 2, 0]])
    _lib()
    with pytest.raises(ValueError, match="cycle"):
        levelize.levelize(edge, 3)
    numpy_branch()
    with pytest.raises(ValueError, match="cycle"):
        levelize.levelize(edge, 3)


@pytest.mark.parametrize("seed,inputs,ands,outputs", [(0, 2, 3, 1), (1, 8, 60, 6),
                                                      (3, 16, 150, 9)])
def test_native_aig_decode_matches_python(seed, inputs, ands, outputs, tmp_path, numpy_branch):
    """Binary AIGER, inverted fanins and outputs: the native decode equals
    the Python decoder's and the JAX package's ``aig_to_xdata``."""
    rng = np.random.default_rng(seed)
    outs, and_lits = _circuit(rng, inputs, ands, outputs)
    outs[0] |= 1
    _, aig = _write(tmp_path, f"c{seed}", inputs, outs, and_lits)
    _lib()
    with open(aig, "rb") as f:
        gates, edges = native.aig_decode_native(f.read())
    assert gates.dtype == np.int32 and edges.dtype == np.int64
    got = aiger.aig_to_xdata(aig)
    assert got == ([[k, int(g)] for k, g in enumerate(gates)], edges.T.tolist())
    assert got == jaiger.aig_to_xdata(aig)
    numpy_branch()
    assert aiger.aig_to_xdata(aig) == got


def test_native_collate_matches_numpy(numpy_branch):
    """Across modalities, paddings and tt-pair layouts, at mp = 2 and 1,
    and into preallocated buffers (``out=``)."""
    rng = np.random.default_rng(7)
    cases = []
    for modality, ng, nc in (("mig", 40, 5), ("xmg", 300, 3), ("aig", 24, 1)):
        cases.append([synthetic.random_circuit(rng, modality, num_inputs=6, num_gates=ng,
                                               num_tt_pairs=16) for _ in range(nc)])
    cases.append([synthetic.random_circuit(rng, "xag", num_inputs=6, num_gates=50,
                                           num_tt_pairs=0) for _ in range(3)])
    _lib()
    got = [(batching.collate(g, mp=2), batching.collate(g)) for g in cases]
    outs = []
    for g, (_, b1) in zip(cases, got):
        buf = {k: np.full_like(v, 7) for k, v in b1.items() if isinstance(v, np.ndarray)
               and v.ndim}
        r = batching.collate(g, dims=batching._dims_of(b1), out=buf)
        assert all(r[k] is buf[k] for k in buf)
        outs.append(r)
    numpy_branch()
    for g, (b2, b1), bo in zip(cases, got, outs):
        _same(b2, batching.collate(g, mp=2))
        _same(b1, batching.collate(g))
        _same(bo, b1)
        buf = {k: np.full_like(v, 7) for k, v in bo.items() if isinstance(v, np.ndarray)
               and v.ndim}
        _same(batching.collate(g, dims=batching._dims_of(b1), out=buf), b1)


def _shards(seed, dp, per, gates=(30, 200), tt=(0, 24)):
    _, gb = _pair(seed, dp * per, gates, tt)
    return [gb[i * per:(i + 1) * per] for i in range(dp)]


def test_native_collate_step_matches_per_shard(monkeypatch):
    """One mg_collate_step call over the step's shards, and the per-shard
    zero-copy branch, both equal np.stack of per-shard collates: mixed
    modalities, ragged sizes, empty tt lists."""
    shards = _shards(11, 4, 8)
    dims = {k: max(d[k] for d in map(batching.natural_dims, shards)) for k in batching._DIM_KEYS}
    ref = batching.stack_batches([batching.collate(s, dims=dims) for s in shards])
    _lib()
    calls = []
    real = batching.collate_step_native
    monkeypatch.setattr(batching, "collate_step_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _same(batching.collate_shards(shards, dims=dims), ref)
    assert calls == [1]
    with monkeypatch.context() as m:
        m.setattr(batching, "_collate_step_native", lambda *a, **k: None)
        _same(batching.collate_shards(shards, dims=dims), ref)
    monkeypatch.setattr(native, "_lib", False)
    _same(batching.collate_shards(shards, dims=dims), ref)
    _same(batching.collate_shards(shards), ref)


def test_native_collate_step_multithreaded(monkeypatch):
    """Threads over shards write disjoint slices: 8 threads give 1's bytes."""
    shards = _shards(13, 8, 4, gates=(60, 70), tt=(8, 9))
    dims = {k: max(d[k] for d in map(batching.natural_dims, shards)) for k in batching._DIM_KEYS}
    _lib()
    monkeypatch.setenv("MGVAE_COLLATE_THREADS", "8")
    a = batching.collate_shards(shards, dims=dims)
    monkeypatch.setenv("MGVAE_COLLATE_THREADS", "1")
    _same(a, batching.collate_shards(shards, dims=dims))


def test_group_stats_cache_matches_shard_dims(numpy_branch):
    """GroupStatsCache.group_dims (one mg_group_stats call) reproduces
    shard_dims and chunked_shard_dims, and the numpy branch's natural dims."""
    _, graphs = _pair(5, 48, gates=(30, 300), tt=(0, 32))
    cache = batching.GroupStatsCache(graphs)
    idx = np.arange(48)
    np.random.default_rng(1).shuffle(idx)
    groups = [idx[i * 8:(i + 1) * 8] for i in range(6)]
    _lib()
    dl = cache.group_dims(groups)
    assert dl == [batching.shard_dims([graphs[i] for i in g]) for g in groups]
    chunked = []
    for g in groups:
        bins = batching._partition_by_size(cache.n[g], 2)
        sub = cache.group_dims([g[b] for b in bins])
        chunked.append({k: max(d[k] for d in sub) for k in sub[0]})
        assert batching.chunked_shard_dims([graphs[i] for i in g], 2) == chunked[-1]
    assert cache.group_dims(groups, mp=2) == [
        batching.shard_dims([graphs[i] for i in g], mp=2) for g in groups]
    numpy_branch()
    assert dl == [batching.natural_dims([graphs[i] for i in g]) for g in groups]
    assert chunked == [batching._chunked_dims_of(
        batching.collate_chunked([graphs[i] for i in g], 2), 2) for g in groups]


@pytest.mark.parametrize("limits", [dict(), dict(max_nodes=384, max_ep=512, max_np=512),
                                    dict(max_nodes=8192, max_ep=64, max_np=512),
                                    dict(max_nodes=128, max_ep=16, max_np=8)],
                         ids=["fits", "nodes", "edges", "nothing_fits"])
def test_native_layouts_match_numpy(limits, numpy_branch):
    """collate_fit's probes, collate_chunked, collate_split, collate_shards
    (chunked) and collate_split_step, and pick_chunks_for: the stats pass
    against the numpy branch's trial collates."""
    _, graphs = _pair(21, 9, gates=(10, 90), tt=(4, 16))
    shards = [graphs[:5], graphs[4:]]
    _lib()

    def layouts():
        split_dims = batching.split_dims(shards, 2)
        return {
            "fit": batching.collate_fit(graphs, **limits),
            "chunked": batching.collate_chunked(graphs, 3),
            "split": batching.collate_split(graphs, 3),
            "shards_chunked": batching.collate_shards(shards, num_chunks=2),
            "split_step": batching.collate_split_step(shards, split_dims),
            "pick": {"C": np.int64(batching.pick_chunks_for(graphs, 64))},
        }

    got = layouts()
    numpy_branch()
    want = layouts()
    for k in want:
        _same(got[k], want[k], k + "/")


# ---- against the JAX package ----------------------------------------------------

def _jax_native():
    from mgvae_tpu import native as jnative

    return jnative.get_lib() is not None


def test_native_batches_equal_the_jax_packages():
    """The same graphs through both packages' native paths (the JAX side's
    numpy branch gives the same bytes where its library is missing):
    collate at mp = 2, the stacked step, the split step and the chunked
    batch at common dims."""
    ga, gb = _pair(31, 16)
    _lib()
    _same(batching.collate(gb, mp=2), jbatching.collate(ga, mp=2))
    sa, sb = [ga[:8], ga[8:]], [gb[:8], gb[8:]]
    dims = {k: max(d[k] for d in map(batching.natural_dims, sb)) for k in batching._DIM_KEYS}
    assert dims == {k: max(d[k] for d in map(jbatching.natural_dims, sa)) for k in dims}
    _same(batching.collate_shards(sb, dims=dims), jbatching.collate_shards(sa, dims=dims))
    sd = batching.split_dims(sb, 2)
    _same(batching.collate_split_step(sb, sd), jbatching.collate_split_step(sa, sd))
    d3 = batching.chunked_shard_dims(gb, 3)
    _same(batching.collate_chunked(gb, 3), jbatching.collate_chunked(ga, 3, dims=d3))
    if _jax_native():
        assert d3 == jbatching.chunked_shard_dims(ga, 3)
        _same(batching.collate_chunked(gb, 3), jbatching.collate_chunked(ga, 3))


def test_group_dims_equal_the_jax_packages():
    ga, gb = _pair(33, 24, gates=(30, 300), tt=(0, 32))
    idx = np.random.default_rng(2).permutation(24)
    groups = [idx[i * 6:(i + 1) * 6] for i in range(4)]
    _lib()
    got = batching.GroupStatsCache(gb).group_dims(groups)
    want = jbatching.GroupStatsCache(ga).group_dims(groups)
    if want is None:   # the JAX package's library did not load in this process
        want = [jbatching.natural_dims([ga[i] for i in g]) for g in groups]
    assert got == want
    cache = batching.GroupStatsCache(gb)
    jcache = jbatching.GroupStatsCache(ga)
    for a in ("n", "e", "p", "node_off", "edge_off", "fwd_all", "esrc_all", "edst_all",
              "lmax"):
        x, y = getattr(cache, a), getattr(jcache, a)
        assert x.dtype == y.dtype and np.array_equal(x, y), a


# ---- the trainer ---------------------------------------------------------------

EPOCHS = r'''
import json, sys
import numpy as np
import torch

torch.set_num_threads(1)
from mgvae_tpu_torch.data.synthetic import random_circuit
from mgvae_tpu_torch.models.dg_ae import DGConfig
from mgvae_tpu_torch.train import trainer as T

CFG = dict(modality="mig", dim_hidden=16, s_rounds=1, t_rounds=1, layernorm=True)
CASES = ("plain", "chunked", "split")


def graphs(n, seed, gates):
    rng = np.random.default_rng(seed)
    return [random_circuit(rng, "mig", num_inputs=4, num_gates=gates + (i % 5) * 6,
                           num_tt_pairs=16, name=f"g{i}") for i in range(n)]


def run(case, save_dir):
    """Two epochs of a CPU Trainer with fixed dims: each epoch's dims (and
    chunk count), every train step's metrics and the params after."""
    searched, fits = T.Trainer._chunks_searched, T.kernel_fits
    if case == "chunked":   # the card's chunk search, with a small size gate
        T.Trainer._chunks_searched = lambda self: True
        T.kernel_fits = lambda n, ep, np_, d: n <= 256
    try:
        t = T.Trainer(None, DGConfig(**CFG), training_id=case, save_dir=save_dir,
                      batch_size=4, distributed=False, seed=3, steps_per_call=1,
                      device="cpu", split=2 if case == "split" else "auto")
        t.set_training_args(lr=1e-3)
        step, losses, dims = t.train_step, [], []

        def recorded(*a, **k):
            out = step(*a, **k)
            losses.append([float(out[1][m]) for m in sorted(out[1])])
            return out

        t.train_step = recorded
        train = graphs(16, 0, 60 if case == "chunked" else 12)
        val = graphs(8, 1, 20)
        for _ in range(2):
            t.train(1, train, val)
            dims.append([t._chunks, t._dims_max, t._split_dims_max])
        params = np.concatenate([x.detach().reshape(-1).numpy()
                                 for x in T.param_leaves(t.params)])
        return {"dims": json.dumps(dims), "losses": np.array(losses), "params": params,
                "caches": len(t._stats_caches)}
    finally:
        T.Trainer._chunks_searched, T.kernel_fits = searched, fits


if __name__ == "__main__":
    out = {}
    for case in CASES:
        for k, v in run(case, sys.argv[1]).items():
            out[f"{case}/{k}"] = v
    np.savez(sys.argv[2], **out)
'''


def _same_epochs(a: dict, b: dict, case: str):
    assert json.loads(str(a["dims"])) == json.loads(str(b["dims"])), case
    assert a["losses"].shape == b["losses"].shape and a["losses"].size, case
    assert np.array_equal(a["losses"], b["losses"]), case
    assert np.array_equal(a["params"], b["params"]), case


@pytest.mark.parametrize("case", ["plain", "chunked", "split"])
def test_trainer_epochs_with_the_stats_cache_equal_trial_collates(case, tmp_path, monkeypatch):
    """Two epochs with the stats cache (one native call per scan) against
    two with the trial-collate scan (the cache off): the same dims, chunk
    count, per-step metrics and params, bit for bit."""
    from mgvae_tpu_torch.train import trainer as T

    script = tmp_path / "epochs.py"
    script.write_text(EPOCHS)
    run = runpy.run_path(str(script))["run"]
    _lib()
    calls = []
    real = batching.GroupStatsCache.group_dims
    with monkeypatch.context() as m:
        m.setattr(batching.GroupStatsCache, "group_dims",
                  lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
        cached = run(case, str(tmp_path / "cached"))
    assert calls and cached["caches"] == 2
    chunks, _, split_dims = json.loads(cached["dims"])[0]
    assert ((chunks or 1) > 1) == (case == "chunked") and bool(split_dims) == (case == "split")
    monkeypatch.setattr(T.Trainer, "_get_stats_cache", lambda self, ds: None)
    _same_epochs(cached, run(case, str(tmp_path / "trial")), case)


def test_trainer_epochs_native_equal_no_native_subprocess(tmp_path):
    """The same two epochs in a process under MGVAE_NO_NATIVE=1 (numpy
    collates, trial-collate scans) and in this one (the native library):
    dims, per-step metrics and params bit for bit, in every layout."""
    script = tmp_path / "epochs.py"
    script.write_text(EPOCHS)
    env = dict(os.environ, MGVAE_NO_NATIVE="1", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = tmp_path / "no_native.npz"
    r = subprocess.run([sys.executable, str(script), str(tmp_path / "np"), str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    z = dict(np.load(out))
    run = runpy.run_path(str(script))["run"]
    _lib()
    for case in ("plain", "chunked", "split"):
        got = run(case, str(tmp_path / "native"))
        assert got["caches"] == 2 and int(z[f"{case}/caches"]) == 0
        _same_epochs(got, {k: z[f"{case}/{k}"] for k in ("dims", "losses", "params")}, case)
