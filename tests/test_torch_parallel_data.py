"""The data layer of data and model parallelism (mgvae_tpu_torch.data.batching)
against the JAX package's: ``collate``'s mp hint, ``collate_shards`` (plain
and chunked), ``stack_batches``, ``collate_split_step`` and
``shard_levels_by_dst``, byte for byte, on 8 graphs x 120 gates per shard
as ``tests/test_sharded.py`` builds them. The JAX side is given its dims
explicitly, so that its result does not depend on whether its native
library loaded (with it and without it, the JAX package writes the same
bytes at agreed dims)."""
import numpy as np
import pytest

from mgvae_tpu.data import batching as jbatching
from mgvae_tpu.data import synthetic as jsynthetic
from mgvae_tpu_torch.data import batching, synthetic

_DIM_KEYS = ("N", "E", "P", "L", "NP", "EP", "EBF", "EBR")


def _shards(modality="mig", n_shards=2, n_graphs=8, num_gates=120, seed=10):
    """The same shards of circuits from both packages' generators."""
    out = []
    for pkg in (jsynthetic, synthetic):
        out.append([[pkg.random_circuit(np.random.default_rng(seed + d * 100 + i), modality,
                                        num_inputs=16, num_gates=num_gates)
                     for i in range(n_graphs)] for d in range(n_shards)])
    return out


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype, x.shape, y.shape)
        assert np.array_equal(x, y), path


def _jax_dims(batch):
    return {"N": batch["gate"].shape[0], "E": batch["edge_src"].shape[0],
            "P": batch["tt_pair_a"].shape[0], "L": batch["lv_nodes"].shape[0],
            "NP": batch["lv_nodes"].shape[1], "EP": batch["lv_edge_src"].shape[1],
            "EBF": batch["fa_src"].shape[1], "EBR": batch["ra_src"].shape[1]}


def _common(dl):
    return {k: max(d[k] for d in dl) for k in _DIM_KEYS}


@pytest.mark.parametrize("mp", [1, 2, 4, 8])
@pytest.mark.parametrize("modality", ["aig", "xmg"])
def test_collate_mp_hint_matches_jax(modality, mp):
    (js,), (ps,) = _shards(modality, n_shards=1)
    bj, bp = jbatching.collate(js, mp=mp), batching.collate(ps, mp=mp)
    _assert_same(bj, bp)
    assert bp["gate"].shape[0] % (128 * mp) == 0 and bp["lv_edge_src"].shape[1] % mp == 0
    assert batching.natural_dims(ps, mp=mp) == _jax_dims(bj)


@pytest.mark.parametrize("mp", [1, 2])
def test_collate_shards_matches_jax(mp):
    js, ps = _shards()
    dims = _common([_jax_dims(jbatching.collate(s, mp=mp)) for s in js])
    bj = jbatching.collate_shards(js, mp=mp, dims=dims)
    _assert_same(bj, batching.collate_shards(ps, mp=mp, dims=dims))
    # without dims: the shards' common natural dims, which are these
    _assert_same(bj, batching.collate_shards(ps, mp=mp))
    assert bj["gate"].shape[0] == 2


def test_collate_shards_chunked_matches_jax():
    js, ps = _shards(n_graphs=8)
    C = 2
    per = [jbatching._chunked_dims_of(jbatching.collate_chunked(s, C), C) for s in js]
    dims = _common(per)
    bj = jbatching.collate_shards(js, dims=dims, num_chunks=C)
    _assert_same(bj, batching.collate_shards(ps, dims=dims, num_chunks=C))
    _assert_same(bj, batching.collate_shards(ps, num_chunks=C))
    assert bj["lv_nodes"].shape[:2] == (2, C)


def test_stack_batches_of_split_batches_matches_jax():
    js, ps = _shards(n_graphs=8)
    G = 2
    dims = jbatching.split_dims(js, G)
    assert batching.split_dims(ps, G) == dims

    def strip(b):
        return {k: v for k, v in b.items() if k != "node_inv"}

    bj = jbatching.stack_batches([strip(jbatching.collate_split(s, G, dims)) for s in js])
    bp = batching.stack_batches([strip(batching.collate_split(s, G, dims)) for s in ps])
    _assert_same(bj, bp)


@pytest.mark.parametrize("G", [2, 3])
def test_collate_split_step_matches_jax(G):
    js, ps = _shards(n_shards=3, n_graphs=8)
    dims = jbatching.split_dims(js, G)
    bj = jbatching.collate_split_step(js, dims)
    bp = batching.collate_split_step(ps, dims)
    _assert_same(bj, bp)
    # the stack of the per-shard split batches without node_inv
    ref = batching.stack_batches([{k: v for k, v in batching.collate_split(s, G, dims).items()
                                   if k != "node_inv"} for s in ps])
    _assert_same(ref, bp)


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_shard_levels_by_dst_matches_jax(mp):
    js, ps = _shards(n_graphs=6)
    bj = jbatching.shard_levels_by_dst(jbatching.collate(js[0], mp=mp), mp)
    _assert_same(bj, batching.shard_levels_by_dst(batching.collate(ps[0], mp=mp), mp))
    # a dp-stacked batch: [dp, L, mp, ...] tables with one common Ep_m
    dims = _common([_jax_dims(jbatching.collate(s, mp=mp)) for s in js])
    sj = jbatching.shard_levels_by_dst(jbatching.collate_shards(js, mp=mp, dims=dims), mp)
    sp = batching.shard_levels_by_dst(batching.collate_shards(ps, mp=mp, dims=dims), mp)
    _assert_same(sj, sp)
    assert sp["mp_lv_edge_src"].shape[:3] == (2, dims["L"], mp)


def test_shard_levels_by_dst_invariants():
    """Every valid edge appears exactly once, on the member owning its
    destination slot; node slots partition cleanly (the JAX package's
    ``tests/test_sharded.py`` invariants, on the port's tables)."""
    mp = 4
    rng = np.random.default_rng(5)
    graphs = [synthetic.random_circuit(rng, "mig", num_inputs=16, num_gates=150)
              for _ in range(12)]
    batch = batching.collate(graphs, mp=mp)
    out = batching.shard_levels_by_dst(batch, mp)
    np_m = out["mp_lv_nodes"].shape[-1]
    assert int(out["mp_lv_edge_valid"].sum()) == int(batch["lv_edge_valid"].sum())
    L = batch["lv_nodes"].shape[0]
    for lv in range(L):
        for m in range(mp):
            v = out["mp_lv_edge_valid"][lv, m]
            if not v.any():
                continue
            ls = out["mp_lv_edge_dst_slot"][lv, m][v]
            assert ls.min() >= 0 and ls.max() < np_m
            glob = np.sort(ls + m * np_m)
            orig = batch["lv_edge_dst_slot"][lv][batch["lv_edge_valid"][lv]]
            np.testing.assert_array_equal(glob, np.sort(orig[orig // np_m == m]))
            # the member's edges keep their source order
            src = out["mp_lv_edge_src"][lv, m][v]
            assert np.all(np.diff(src) >= 0)
    nodes_flat = out["mp_lv_nodes"].reshape(L, -1)
    NP = batch["lv_nodes"].shape[1]
    np.testing.assert_array_equal(nodes_flat[:, :NP], batch["lv_nodes"])
    assert not out["mp_lv_node_valid"].reshape(L, -1)[:, NP:].any()
