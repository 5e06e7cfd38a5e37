"""The rest of the port's surface against the JAX package on the CPU: the
numpy modules it carries as copies (byte for byte, and their outputs on
seeded inputs), the aggregators (plain torch, params carried across from
the JAX init, within 1e-5), the ``deepgate`` shim's names and
``parse_pyg_mlpgate``, the host allocator tuning at the batching import,
and the three training examples at mini size with ``--device cpu``."""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepgate as jdeepgate
from mgvae_tpu.data import levelize as jlevelize
from mgvae_tpu.data.synthetic import random_circuit as jrandom_circuit
from mgvae_tpu.ops import aggregators as jagg
from mgvae_tpu.utils import circuit as jcircuit
from mgvae_tpu.utils import sat as jsat
from mgvae_tpu_torch import deepgate
from mgvae_tpu_torch.data import levelize
from mgvae_tpu_torch.data.synthetic import random_circuit
from mgvae_tpu_torch.examples import large_batch_training, resume
from mgvae_tpu_torch.examples import train as train_example
from mgvae_tpu_torch.ops import aggregators as agg
from mgvae_tpu_torch.utils import circuit, hostmem, sat

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("path", ["utils/circuit.py", "utils/sat.py", "utils/hostmem.py",
                                  "data/edge_split.py", "data/dataset.py"])
def test_numpy_modules_are_byte_identical_copies(path):
    with open(os.path.join(REPO, "mgvae_tpu", path), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "mgvae_tpu_torch", path), "rb") as f:
        assert f.read() == want


def _class_body(path):
    with open(os.path.join(REPO, path)) as f:
        s = f.read()
    return s[s.index("@dataclasses.dataclass\nclass CircuitGraph"):s.index("\n\ndef build_graph(")]


def test_circuit_graph_is_the_jax_dataclass():
    assert _class_body("mgvae_tpu_torch/data/graph.py") == _class_body("mgvae_tpu/data/graph.py")
    g, h = (make(np.random.default_rng(3), "mig", num_inputs=5, num_gates=30)
            for make in (random_circuit, jrandom_circuit))
    for name in ("forward_index", "backward_index", "PIs", "POs", "no_connect", "x"):
        np.testing.assert_array_equal(getattr(g, name), getattr(h, name), err_msg=name)
    assert g.min_tt_dis is g.rc_pair_index is g.is_rc is None


def test_return_order_info_matches_jax():
    g = random_circuit(np.random.default_rng(4), "xmg", num_inputs=6, num_gates=50)
    for a, c in zip(levelize.return_order_info(g.edge_index, g.num_nodes),
                    jlevelize.return_order_info(g.edge_index, g.num_nodes), strict=True):
        np.testing.assert_array_equal(a, c)


def test_batching_tunes_the_host_allocator():
    if os.environ.get("MGVAE_NO_MALLOC_TUNE"):
        pytest.skip("the allocator tuning is switched off in this environment")
    assert hostmem._done and hostmem.tune_malloc()


@pytest.mark.parametrize("case", ["aig_simulation", "subcircuit", "function_acc", "cop",
                                  "reconvergence", "simulator", "graph_checks", "vectors",
                                  "bench_lines"])
def test_circuit_utils_match_jax(case):
    def run(mod, make):
        rng = np.random.default_rng(6)
        g = make(rng, "mig", num_inputs=6, num_gates=50, num_tt_pairs=40)
        if case == "vectors":
            return [mod.generate_orthogonal_vectors(10, 16, seed=0),
                    mod.generate_hs_init(6, 16, seed=1)]
        if case == "graph_checks":
            return [mod.check_reconvergence(g), mod.simulate_graph(g, seed=2)]
        if case == "bench_lines":
            lines = ["INPUT(a)", "INPUT(b)", "INPUT(c)", "OUTPUT(z)", "0: e = AND(a, b)",
                     "1: f = OR(e, c)", "2: g = NOT(e)", "3: z = AND(f, g)"]
            x, edges, levels, fanin, fanout = mod.feature_generation(
                lines, {"INPUT": 0, "AND": 1, "NOT": 2, "OR": 3})
            return [x, edges, levels, fanin, fanout,
                    mod.dfs_reconvergent_circuit(3, 6, fanout, x),
                    mod.backward_search(6, fanin, x, min_level=0)]
        if case == "aig_simulation":
            a = make(np.random.default_rng(7), "aig", num_inputs=5, num_gates=40)
            return mod.aig_simulation(a.gate, a.edge_index, num_patterns=64 * 16, seed=1)
        if case == "subcircuit":
            sub, kept = mod.extract_subcircuit(g, [int(g.POs[0])])
            return [sub.gate, sub.edge_index, sub.forward_level, np.asarray(kept),
                    sorted(mod.circuit_statistics(g).items())]
        if case == "function_acc":
            return mod.get_function_acc(g, rng.normal(size=(g.num_nodes, 16)), samples=50)
        fanin, fanout = mod.get_fanin_fanout(g.num_nodes, g.edge_index)
        levels = mod.get_level_list(g.forward_level)
        x = [[f"n{i}", int(t), int(lv)] for i, (t, lv) in enumerate(zip(g.gate, g.forward_level))]
        if case == "cop":
            x = mod.generate_prob_cont(x, list(g.PIs), levels, fanin)
            return mod.generate_prob_obs(x, levels, fanin, fanout)
        if case == "simulator":
            return mod.simulator(x, list(g.PIs), levels, fanin, num_patterns=64 * 8, seed=3)
        return mod.identify_reconvergence(x, levels, fanin, fanout)

    got, want = run(circuit, random_circuit), run(jcircuit, jrandom_circuit)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("case", ["solve", "iclause", "cnf", "circuit"])
def test_sat_utils_match_jax(case):
    def run(mod):
        if case == "solve":
            return [mod.solve_sat(3, [[1, 2], [-1, 2], [-2, 3]]),
                    mod.solve_sat_iteratively([[1, 2], [-1, 2], [-2, 3]], 3, [0.9, 0.1, 0.5])]
        if case == "iclause":
            return mod.gen_iclause_pair(6, rng=np.random.default_rng(0))
        if case == "cnf":
            g = random_circuit(np.random.default_rng(2), "aig", num_inputs=5, num_gates=30)
            return mod.aig_to_cnf(g.gate, g.edge_index, po_idx=int(g.num_nodes - 1))
        g = mod.cnf_to_circuit([[1, -2], [2, 3], [-1, -3]], 3)
        return [g.gate, g.edge_index, g.forward_level, g.POs]

    assert repr(run(sat)) == repr(run(jsat))


def _graph_inputs(n=10, e=24, din=8, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, din)).astype(np.float32)
    src, dst = rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32)
    valid = np.r_[np.ones(e - 6, bool), np.zeros(6, bool)]
    return x, src, dst, valid


def _shapes(tree):
    """The tree's keys and list lengths, with each leaf's shape."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(np.shape(tree))


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("name", ["mlp_aggr", "deepset_conv", "attn_mlp", "agnn_conv",
                                  "gated_sum_conv", "gcn_conv", "gcn_encoder"])
def test_aggregators_match_jax(name):
    n, din, dout = 10, 8, 6
    x, src, dst, valid = _graph_inputs(n=n, din=din)
    init = getattr(jagg, f"{name}_init")
    p = init(jax.random.PRNGKey(1), din) if name == "gated_sum_conv" else init(
        jax.random.PRNGKey(1), din, dout)
    want = getattr(jagg, f"{name}_apply")(p, jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                                          jnp.asarray(valid), n)
    got = getattr(agg, f"{name}_apply")(_to_torch(p), torch.tensor(x), torch.tensor(src),
                                        torch.tensor(dst), torch.tensor(valid), n)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the port's own init: the JAX tree's keys and shapes
    gen = torch.Generator().manual_seed(0)
    mine = getattr(agg, f"{name}_init")(gen, din) if name == "gated_sum_conv" else getattr(
        agg, f"{name}_init")(gen, din, dout)
    assert _shapes(mine) == _shapes(p)


def test_decoders_match_jax():
    rng = np.random.default_rng(3)
    z, t = (rng.normal(size=(7, 4)).astype(np.float32) for _ in range(2))
    src, dst = rng.integers(0, 7, 12), rng.integers(0, 7, 12)
    for sig in (True, False):
        pairs = [(agg.inner_product_decode(torch.tensor(z), torch.tensor(src), torch.tensor(dst),
                                           sig),
                  jagg.inner_product_decode(jnp.asarray(z), src, dst, sig)),
                 (agg.inner_product_decode_all(torch.tensor(z), sig),
                  jagg.inner_product_decode_all(jnp.asarray(z), sig)),
                 (agg.directed_inner_product_decode_all(torch.tensor(z), torch.tensor(t), sig),
                  jagg.directed_inner_product_decode_all(jnp.asarray(z), jnp.asarray(t), sig))]
        for a, c in pairs:
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5, atol=1e-6)
    zt = torch.tensor(z)
    assert agg.dummy_encoder_apply(zt, 1, k=2) is zt
    assert agg.dummy_pair_encoder_apply(zt, zt, 3)[1] is zt


def test_deepgate_shim_names_and_parser():
    public = {n for n in dir(jdeepgate) if not n.startswith("_")}
    assert {n for n in dir(deepgate) if not n.startswith("_")} == public
    assert all(getattr(deepgate, n).__module__.startswith("mgvae_tpu_torch")
               for n in public if hasattr(getattr(deepgate, n), "__module__"))
    assert deepgate.Model.__init__.__defaults__[0] == "xag"
    rng = np.random.default_rng(5)
    x = np.c_[np.arange(6), [0, 0, 0, 1, 2, 1]]
    edges = np.array([[0, 1, 2, 3, 4], [3, 3, 4, 5, 5]])
    y = rng.uniform(size=6)
    for tt in ((rng.uniform(size=3), np.array([[0, 1, 3], [4, 5, 5]])), ([], [])):
        a = deepgate.parse_pyg_mlpgate(x, edges, y, *tt)
        c = jdeepgate.parse_pyg_mlpgate(x, edges, y, *tt)
        for k in ("gate", "edge_index", "forward_level", "backward_level", "prob",
                  "tt_pair_index", "tt_dis"):
            np.testing.assert_array_equal(getattr(a, k), getattr(c, k), err_msg=k)


def test_examples_train_and_resume_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("EPOCHS", "1")
    monkeypatch.delenv("DATA_DIR", raising=False)
    mini = ["--device", "cpu", "--save_dir", str(tmp_path), "--num_graphs", "16"]
    tr = train_example.main(mini)
    assert tr.model_epoch == 2 and tr.rc_prob_func_weight == [3.0, 1.0, 2.0]
    _, resumed = resume.main(mini)
    assert not resumed
    again, resumed = resume.main(mini)
    assert resumed and again.model_epoch == 2
    assert os.path.isfile(tmp_path / "resume_demo" / "model_last.pth")


def test_large_batch_example_on_cpu(capsys):
    out = large_batch_training.main(["--device", "cpu", "--num_graphs", "8", "--num_gates", "24"])
    assert len(out) == 5 and all(np.isfinite(m["loss"]) for m in out)
    assert out[-1]["loss"] < out[0]["loss"]
    text = capsys.readouterr().out
    assert "bs8 collated as" in text and "step 4: loss" in text


def test_dataset_front_end_matches_jax(tmp_path):
    """The legacy Dataset on a small circuits / labels pair, against the
    JAX package's: the same graphs and labels."""
    from mgvae_tpu.data.dataset import Dataset as JDataset

    rng = np.random.default_rng(8)
    circuits, labels = {}, {}
    for i in range(3):
        g = random_circuit(rng, "mig", num_inputs=4, num_gates=20, num_tt_pairs=6)
        x = np.c_[np.arange(g.num_nodes), g.gate]
        circuits[f"c{i}"] = {"x": x, "edge_index": g.edge_index}
        labels[f"c{i}"] = {"prob": g.prob, "tt_pair_index": g.tt_pair_index.T,
                           "tt_dis": g.tt_dis, "min_tt_dis": g.tt_dis,
                           "rc_pair_index": g.tt_pair_index.T[:2], "is_rc": np.ones(2)}
    np.savez(tmp_path / "circuits.npz", circuits=circuits)
    np.savez(tmp_path / "labels.npz", labels=labels)
    out = []
    for cls, sub in ((deepgate.Dataset, "p"), (JDataset, "j")):
        args = SimpleNamespace(data_dir=str(tmp_path), circuit_file="circuits.npz",
                               label_file="labels.npz", small_train=False, no_rc=False,
                               reload_dataset=True)
        ds = cls(str(tmp_path / sub), args)
        out.append([[getattr(ds[i], k) for k in ("name", "gate", "edge_index", "tt_pair_index",
                                                 "min_tt_dis", "rc_pair_index", "is_rc")]
                    for i in range(len(ds))])
    assert repr(out[0]) == repr(out[1]) and len(out[0]) == 3
