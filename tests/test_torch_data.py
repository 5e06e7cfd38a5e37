"""Port data layer (mgvae_tpu_torch.data) against the JAX package's: the same
circuits from the same seed, and byte-identical collated batches."""
import os

import numpy as np
import pytest

from mgvae_tpu.data import batching as jbatching
from mgvae_tpu.data import bench as jbench
from mgvae_tpu.data import synthetic as jsynthetic
from mgvae_tpu_torch.data import batching, bench, synthetic

_GRAPH_FIELDS = ("gate", "edge_index", "forward_level", "backward_level", "prob",
                 "tt_pair_index", "tt_dis")
_FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _assert_same_graph(a, b):
    assert a.name == b.name
    for f in _GRAPH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _pair(modality, seed, n, **kw):
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    ga = [jsynthetic.random_circuit(ra, modality, **kw) for _ in range(n)]
    gb = [synthetic.random_circuit(rb, modality, **kw) for _ in range(n)]
    return ga, gb


@pytest.mark.parametrize("modality", ["aig", "mig", "xag", "xmg"])
def test_random_circuit_same_graphs_from_same_seed(modality):
    ga, gb = _pair(modality, 11, 3, num_inputs=6, num_gates=40)
    for a, b in zip(ga, gb):
        _assert_same_graph(a, b)


@pytest.mark.parametrize("modality", ["aig", "mig", "xag", "xmg"])
def test_collate_matches_jax_key_by_key(modality):
    ga, gb = _pair(modality, 3, 4, num_inputs=6, num_gates=48)
    bj, bp = jbatching.collate(ga), batching.collate(gb)
    assert set(bj) == set(bp)
    for k in bj:
        x, y = np.asarray(bj[k]), np.asarray(bp[k])
        assert x.dtype == y.dtype, k
        assert np.array_equal(x, y), k


def test_collate_edgeless_graph_matches_jax():
    from mgvae_tpu.data.graph import build_graph as jbuild
    from mgvae_tpu_torch.data.graph import build_graph

    gate = np.zeros(3, np.int32)
    e = np.zeros((2, 0), np.int64)
    bj = jbatching.collate([jbuild("pi", gate, e)])
    bp = batching.collate([build_graph("pi", gate, e)])
    for k in bj:
        assert np.array_equal(np.asarray(bj[k]), np.asarray(bp[k])), k


def test_bucket_matches_jax():
    for x in range(0, 5000, 7):
        assert batching.bucket(x) == jbatching.bucket(x)


# the fixtures use NAND/NOR: parse them with the circuit toolkit's gate ids
_TOOLKIT = {"INPUT": 0, "AND": 1, "NAND": 2, "OR": 3, "NOR": 4, "NOT": 5, "XOR": 6}


@pytest.mark.parametrize("name", ["c17.bench", "fa.bench", "mux21.bench"])
def test_bench_parser_matches_jax(name):
    path = os.path.join(_FIXTURES, name)
    _assert_same_graph(jbench.BenchParser(_TOOLKIT).read_bench(path),
                       bench.BenchParser(_TOOLKIT).read_bench(path))


def test_bench_parser_rejects_sequential(tmp_path):
    p = tmp_path / "seq.bench"
    p.write_text("INPUT(a)\nq = DFF(a)\n")
    with pytest.raises(ValueError, match="DFF"):
        bench.BenchParser().read_bench(str(p))


# ---- batches larger than one bucket: chunked, fit, split -------------------

def _assert_same_batch(bj, bp, path=""):
    """Key by key: same keys, dtypes, shapes and bytes ("groups": per group)."""
    assert set(bj) == set(bp), set(bj) ^ set(bp)
    for k in bj:
        if k == "groups":
            assert len(bj[k]) == len(bp[k])
            for i, (x, y) in enumerate(zip(bj[k], bp[k])):
                _assert_same_batch(x, y, f"{path}groups[{i}].")
            continue
        x, y = np.asarray(bj[k]), np.asarray(bp[k])
        assert x.dtype == y.dtype and x.shape == y.shape, path + k
        assert np.array_equal(x, y), path + k


def _have_native():
    from mgvae_tpu.native import collate_stats_native

    return collate_stats_native(np.zeros(1, np.int32), np.zeros(0, np.int64),
                                np.zeros(0, np.int64), jbatching.BLOCK_D) is not None


def _jax_chunked(ga, c):
    """The JAX package's chunked batch by its main branch: common dims from
    the stats pass, each chunk collated at them. Without the native library
    the same dims are handed over explicitly."""
    if _have_native():
        return jbatching.collate_chunked(ga, c)
    pre = [jbatching.natural_dims([ga[i] for i in b])
           for b in jbatching._partition_chunks(ga, c)]
    return jbatching.collate_chunked(ga, c, dims={k: max(d[k] for d in pre) for k in pre[0]})


def _ragged(modality, seed, n=9):
    """n circuits of growing size, so that chunks and groups differ in dims."""
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    kw = [dict(num_inputs=4 + i % 5, num_gates=10 + 9 * i) for i in range(n)]
    return ([jsynthetic.random_circuit(ra, modality, **k) for k in kw],
            [synthetic.random_circuit(rb, modality, **k) for k in kw])


@pytest.mark.parametrize("chunks", [2, 3])
@pytest.mark.parametrize("modality", ["aig", "xmg"])
def test_collate_chunked_matches_jax_key_by_key(modality, chunks):
    ga, gb = _ragged(modality, 5)
    bp = batching.collate_chunked(gb, chunks)
    assert bp["lv_nodes"].ndim == 3 and bp["lv_nodes"].shape[0] == chunks
    assert bp["chunk_counts"].sum() == bp["n_nodes"]
    _assert_same_batch(_jax_chunked(ga, chunks), bp)
    # explicit common dims, and C == 1: plain collate
    d = batching._chunked_dims_of(bp, chunks)
    _assert_same_batch(jbatching.collate_chunked(ga, chunks, dims=d),
                       batching.collate_chunked(gb, chunks, dims=d))
    _assert_same_batch(jbatching.collate_chunked(ga, 1), batching.collate_chunked(gb, 1))
    assert jbatching._chunked_dims_of(bp, chunks) == d


@pytest.mark.parametrize("groups", [2, 3])
@pytest.mark.parametrize("modality", ["aig", "xmg"])
def test_collate_split_matches_jax_key_by_key(modality, groups):
    ga, gb = _ragged(modality, 6)
    bp = batching.collate_split(gb, groups)
    assert len(bp["groups"]) == groups and "prob" not in bp["groups"][0]
    assert len({g["gate"].shape[0] for g in bp["groups"]}) > 1     # dims differ by group
    _assert_same_batch(jbatching.collate_split(ga, groups), bp)
    dims = batching.split_dims([gb[:5], gb[4:]], groups)
    assert dims == jbatching.split_dims([ga[:5], ga[4:]], groups)
    _assert_same_batch(jbatching.collate_split(ga[:5], groups, dims=dims),
                       batching.collate_split(gb[:5], groups, dims=dims))


@pytest.mark.parametrize("limits,chunked", [
    (dict(), False),                                         # the gate's own constants: fits
    (dict(max_nodes=384, max_ep=512, max_np=512), True),     # too many nodes
    (dict(max_nodes=8192, max_ep=64, max_np=512), True),     # a level's edges too wide
    (dict(max_nodes=128, max_ep=16, max_np=8), True),        # nothing fits: one graph per chunk
])
@pytest.mark.parametrize("modality", ["aig", "xmg"])
def test_collate_fit_matches_jax_key_by_key(modality, limits, chunked):
    ga, gb = _ragged(modality, 7)
    bp = batching.collate_fit(gb, **limits)
    assert (bp["lv_nodes"].ndim == 3) == chunked
    if _have_native() or not chunked:
        bj = jbatching.collate_fit(ga, **limits)
    else:
        bj = _jax_chunked(ga, bp["lv_nodes"].shape[0])
    _assert_same_batch(bj, bp)
    if chunked and limits["max_nodes"] > 128:
        c = bp["lv_nodes"].shape[0]
        assert bp["gate"].shape[0] // c <= limits["max_nodes"]
        assert bp["lv_edge_src"].shape[2] <= limits["max_ep"]


def test_chunk_pickers_and_natural_dims_match_jax():
    from mgvae_tpu.ops.pallas import level_kernel as jk
    from mgvae_tpu_torch.ops import level_kernel as pk

    ga, gb = _ragged("mig", 8)
    assert batching.natural_dims(gb) == jbatching.natural_dims(ga)
    assert batching._partition_chunks(gb, 4) == jbatching._partition_chunks(ga, 4)
    assert (pk.KERNEL_MAX_NODES, pk.KERNEL_MAX_EP, pk.KERNEL_MAX_NP) == (
        jk.KERNEL_MAX_NODES, jk.KERNEL_MAX_EP, jk.KERNEL_MAX_NP)
    for shape in ((8192, 512, 512, 64), (8193, 512, 512, 64), (4096, 640, 64, 64),
                  (4096, 64, 640, 64), (4096, 64, 64, 160)):
        assert pk.kernel_fits(*shape) == jk.kernel_fits(*shape)
    if _have_native():
        assert batching.pick_chunks_for(gb, 64) == jbatching.pick_chunks_for(ga, 64) == 1
    with pytest.raises(ValueError, match="fewer graphs"):
        batching.collate_chunked(gb[:2], 3)
    with pytest.raises(ValueError, match="too small"):
        batching.collate(gb, dims={"N": 128})


def test_jax_padded_branch_differs_only_in_padding_edge_ids(monkeypatch):
    """Without its native stats pass the JAX package collates each chunk at
    its natural dims and pads it up (``_pad_batch_to``): the padding entries
    of lv_edge_id (and fa_eid / ra_eid) then keep the chunk's own last edge
    instead of the common one. Those entries are masked everywhere, so the
    forward is the same; the port builds the stats-pass layout."""
    import mgvae_tpu.native as native

    ga, gb = _ragged("mig", 5)
    bp = batching.collate_chunked(gb, 3)
    monkeypatch.setattr(native, "collate_stats_native", lambda *a, **k: None)
    padded = jbatching.collate_chunked(ga, 3)
    differ = {k for k in bp if not np.array_equal(np.asarray(bp[k]), np.asarray(padded[k]))}
    assert differ and differ <= {"lv_edge_id", "fa_eid", "ra_eid"}
    assert np.array_equal(bp["lv_edge_id"][bp["lv_edge_valid"]],
                          padded["lv_edge_id"][padded["lv_edge_valid"]])
    assert (bp["lv_edge_valid"] == padded["lv_edge_valid"]).all()


@pytest.mark.parametrize("modality", ["aig", "mig"])
def test_layered_circuit_same_graph_from_same_seed(modality):
    kw = dict(width=24, depth=3, num_tt_pairs=16)
    a = jsynthetic.layered_circuit(np.random.default_rng(2), modality, **kw)
    b = synthetic.layered_circuit(np.random.default_rng(2), modality, **kw)
    _assert_same_graph(a, b)
    assert b.num_nodes == 24 * 4 and int(b.forward_level.max()) == 3
