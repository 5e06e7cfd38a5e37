"""Static-shape, level-bucketed batch construction (host side, numpy).

Copy of the numpy branch of ``mgvae_tpu.data.batching``: ``collate`` and the
layouts for batches larger than one bucket, ``collate_chunked`` (C balanced
sub-batches with common dims in one node space), ``collate_fit`` (the
smallest such C whose chunks pass the fused level kernel's size gate) and
``collate_split`` (G shape-sorted groups, each with its own dims). They give
the same keys, dtypes and bytes as the JAX package's, so one batch feeds
both packages. Graphs are disjoint-union batched, nodes renumbered
level-major, and edges sorted by destination level into padded [L, Ep]
tables. Every padded dim is rounded up to a 4/5/6/7 * 2^k bucket.

Valid nodes are contiguous at the front ([0, n_nodes)); at least one padding
node always exists and slot ``n_nodes`` is the dump for padded level-table
entries.

For data and model parallelism (``parallel/``): ``collate``'s ``mp`` hint
(N a multiple of mp * 128, the level tables' Ep of mp), ``collate_shards``
(one shard per dp rank at common dims, stacked on a leading axis),
``stack_batches``, ``collate_split_step`` (split shards at agreed per-group
dims, stacked) and ``shard_levels_by_dst`` (the dst-complete member tables
of the model-parallel kernel route), byte-identical to the JAX package's.

The native host library (``mgvae_tpu_torch/native``, the JAX package's C++
source) builds the tables when it loads, as in the JAX package: ``collate``
through ``mg_collate_stats`` / ``mg_collate_fill`` (``_collate_native``,
also into preallocated ``out`` buffers), the dims without a collate
(``shard_dims``, ``chunked_shard_dims``; the probes of ``collate_fit`` and
``pick_chunks_for``), a whole step of shards into one stacked buffer in one
threaded call (``_collate_shards_zero_copy`` -> ``mg_collate_step``; the
path of ``collate_shards`` and ``collate_split_step``), and the dims of many
graph groups in one threaded call (``GroupStatsCache``, the trainer's dims
scan). Each has its numpy branch beside it, taken when the library is
unavailable (``MGVAE_NO_NATIVE=1``), with the same bytes. Not ported: the
JAX package's pad-to-max branch for shards without agreed dims
(``_pad_batch_to``; it differs only in masked padding entries) and the
stats cache's level histograms, which serve the JAX trainer's split
pre-grow.
"""
from __future__ import annotations

import numpy as np

from ..native import (
    collate_fill_native,
    collate_stats_native,
    collate_step_native,
    get_lib,
    group_stats_native,
    num_threads,
)
from ..utils.hostmem import tune_malloc
from .graph import CircuitGraph

# batch buffers are a few MB and re-allocated per step: keep them on the
# glibc heap instead of mmap round trips (utils/hostmem), as the JAX
# package's batching does at import
tune_malloc()

BLOCK_D = 128  # dst-block width of the blocked-CSR tables (fa_*/ra_*)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket(x: int, minimum: int = 8) -> int:
    """Smallest m * 2^e >= x with m in {4,5,6,7} (<= 25% padding waste)."""
    if x <= minimum:
        return minimum
    e = max(0, (x - 1).bit_length() - 3)
    for m in (4, 5, 6, 7, 8):
        v = m << e
        if v >= x:
            return v
    raise AssertionError


_DIM_KEYS = ("N", "E", "P", "L", "NP", "EP", "EBF", "EBR")


def collate(graphs: list[CircuitGraph], dims: dict | None = None, mp: int = 1,
            out: dict | None = None) -> dict:
    """Disjoint-union + pad a list of circuits into one static-shape batch
    (a dict of numpy arrays and numpy scalars).

    ``dims``: optional overrides of the padded dims ('N', 'E', 'P', 'L',
    'NP', 'EP', 'EBF', 'EBR'), so that several sub-batches share one shape.
    ``mp``: the model-parallel degree (``parallel/sharded``): N is rounded
    up to a multiple of mp * 128 and EP to a multiple of mp, so that the
    node blocks and the level tables' edge columns split evenly.
    ``out``: optional preallocated arrays of this batch's shapes, one per
    array key, written in place (the returned dict aliases them), so that
    a caller collates straight into views of a stacked buffer."""
    if not graphs:
        raise ValueError("collate: empty batch")
    n_graphs = len(graphs)
    sizes = np.array([g.num_nodes for g in graphs], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    n = int(offsets[-1])

    gate = np.concatenate([g.gate for g in graphs])
    fwd = np.concatenate([g.forward_level for g in graphs]).astype(np.int32)
    prob = np.concatenate([g.prob for g in graphs])
    graph_id = np.repeat(np.arange(n_graphs, dtype=np.int32), sizes)

    edge = np.concatenate(
        [g.edge_index + offsets[i] for i, g in enumerate(graphs)], axis=1
    ) if any(g.num_edges for g in graphs) else np.zeros((2, 0), dtype=np.int64)
    e = edge.shape[1]

    tt_pairs = np.concatenate(
        [g.tt_pair_index + offsets[i] for i, g in enumerate(graphs)], axis=1
    ) if any(g.tt_pair_index.size for g in graphs) else np.zeros((2, 0), dtype=np.int64)
    tt_dis = np.concatenate([g.tt_dis for g in graphs]) if tt_pairs.size else np.zeros(0, np.float32)
    p = tt_pairs.shape[1]

    # the native library's table builders: the same bytes, less host time
    nat = _collate_native(gate, fwd, prob, graph_id, edge, tt_pairs, tt_dis,
                          n_graphs, n, e, p, dims, mp, out=out)
    if nat is not None:
        return nat

    # ---- level-major renumbering -----------------------------------------
    # each forward level occupies a contiguous id range; ``node_perm`` maps
    # new -> original ids, ``node_inv`` original -> new (the API uses it to
    # return embeddings in input order)
    node_perm = np.argsort(fwd, kind="stable").astype(np.int64)
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[node_perm] = np.arange(n)
    gate = gate[node_perm]
    prob = prob[node_perm]
    graph_id = graph_id[node_perm]
    fwd = fwd[node_perm]
    if e:
        edge = inv_perm[edge]
    if p:
        tt_pairs = inv_perm[tt_pairs]

    # ---- level tables -------------------------------------------------
    max_level = int(fwd.max()) if n else 0  # update levels are 1..max_level
    lv_real = max_level
    node_order = np.argsort(fwd, kind="stable")
    lv_counts = np.bincount(fwd, minlength=max_level + 1)
    dst_level = fwd[edge[1]] if e else np.zeros(0, np.int32)
    # edges ordered by (dst level, source id, original index)
    edge_order = (np.lexsort((np.arange(e), edge[0], dst_level))
                  if e else np.zeros(0, np.int64))
    ecounts = np.bincount(dst_level, minlength=max_level + 1) if e else np.zeros(max_level + 1, np.int64)

    np_real = int(lv_counts[1:].max()) if max_level else 0
    ep_real = int(ecounts[1:].max()) if max_level else 0

    # ---- padded dims ---------------------------------------------------
    dims = dims or {}
    N, E, P, L, NP, EP = _padded_dims(dims, mp, n, e, p, lv_real, np_real, ep_real)
    dump = n  # first padding node

    perm_pad = np.arange(N, dtype=np.int32)
    perm_pad[:n] = node_perm
    inv_pad = np.arange(N, dtype=np.int32)
    inv_pad[:n] = inv_perm
    res = {
        "node_perm": perm_pad,   # new id -> original id (padding: identity)
        "node_inv": inv_pad,     # original id -> new id
        "gate": _pad(gate.astype(np.int32), N),
        "node_valid": _mask(n, N),
        "forward_level": _pad(fwd, N),
        "graph_id": _pad(graph_id, N, fill=-1),
        "prob": _pad(prob.astype(np.float32), N),
        "edge_src": _pad(edge[0].astype(np.int32), E),
        "edge_dst": _pad(edge[1].astype(np.int32), E),
        "edge_valid": _mask(e, E),
        "tt_pair_a": _pad(tt_pairs[0].astype(np.int32), P),
        "tt_pair_b": _pad(tt_pairs[1].astype(np.int32), P),
        "tt_valid": _mask(p, P),
        "tt_dis": _pad(tt_dis.astype(np.float32), P),
        "n_nodes": np.int32(n),
        "n_edges": np.int32(e),
        "n_tt": np.int32(p),
        "n_graphs": np.int32(n_graphs),
    }

    lv_nodes = np.full((L, NP), dump, dtype=np.int32)
    lv_node_valid = np.zeros((L, NP), dtype=bool)
    lv_edge_src = np.full((L, EP), dump, dtype=np.int32)
    lv_edge_dst_slot = np.zeros((L, EP), dtype=np.int32)
    lv_edge_valid = np.zeros((L, EP), dtype=bool)
    lv_edge_id = np.full((L, EP), E - 1, dtype=np.int32)  # index into edge arrays
    edge_lv_row = np.zeros(E, dtype=np.int32)  # edge -> flat (level, rank) slot

    # vectorized fill: rank-within-level for nodes and edges
    slot_of = np.zeros(N, dtype=np.int32)
    lv_start = np.full(L, n, dtype=np.int32)  # first node id of each level
    if lv_real:
        upd_nodes = node_order[int(lv_counts[0]) :]          # sorted by level
        lv_of_node = fwd[upd_nodes].astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(lv_counts[1:])])
        lv_start[:lv_real] = (int(lv_counts[0]) + starts[:lv_real]).astype(np.int32)
        rank = np.arange(len(upd_nodes)) - starts[lv_of_node - 1]
        lv_nodes[lv_of_node - 1, rank] = upd_nodes
        lv_node_valid[lv_of_node - 1, rank] = True
        slot_of[upd_nodes] = rank.astype(np.int32)
        if e:
            eidx = edge_order[int(ecounts[0]) :]
            lv_of_edge = dst_level[eidx].astype(np.int64)
            estarts = np.concatenate([[0], np.cumsum(ecounts[1:])])
            erank = np.arange(len(eidx)) - estarts[lv_of_edge - 1]
            lv_edge_src[lv_of_edge - 1, erank] = edge[0][eidx]
            lv_edge_dst_slot[lv_of_edge - 1, erank] = slot_of[edge[1][eidx]]
            lv_edge_valid[lv_of_edge - 1, erank] = True
            lv_edge_id[lv_of_edge - 1, erank] = eidx
            edge_lv_row[eidx] = ((lv_of_edge - 1) * EP + erank).astype(np.int32)
    res.update(
        lv_nodes=lv_nodes,
        lv_node_valid=lv_node_valid,
        lv_edge_src=lv_edge_src,
        lv_edge_dst_slot=lv_edge_dst_slot,
        lv_edge_valid=lv_edge_valid,
        lv_edge_id=lv_edge_id,
        edge_lv_row=edge_lv_row,
        lv_start=lv_start,
    )

    # ---- blocked-CSR whole-graph tables -----------------------------------
    # the struct-tower kernels build their neighbor lists from fa_src / ra_src
    # (ops/struct_kernel.struct_tables)
    nb = N // BLOCK_D
    fa_src, fa_slot, fa_valid, fa_eid = _blocked_tables(
        by=edge[1] if e else np.zeros(0, np.int64),
        other=edge[0] if e else np.zeros(0, np.int64),
        nb=nb, eb=dims.get("EBF"), dump=dump, eid_fill=E - 1,
    )
    ra_src, ra_slot, ra_valid, ra_eid = _blocked_tables(
        by=edge[0] if e else np.zeros(0, np.int64),
        other=edge[1] if e else np.zeros(0, np.int64),
        nb=nb, eb=dims.get("EBR"), dump=dump, eid_fill=E - 1,
    )
    deg_in = np.zeros(N, np.float32)
    deg_out = np.zeros(N, np.float32)
    if e:
        deg_in[: n] = np.bincount(edge[1], minlength=n)[:n]
        deg_out[: n] = np.bincount(edge[0], minlength=n)[:n]
    res.update(
        fa_src=fa_src, fa_slot=fa_slot, fa_valid=fa_valid, fa_eid=fa_eid,
        ra_src=ra_src, ra_slot=ra_slot, ra_valid=ra_valid, ra_eid=ra_eid,
        deg_in=deg_in, deg_out=deg_out,
    )
    if out is not None:   # the in-place contract without the library
        for k, v in res.items():
            if isinstance(v, np.ndarray):
                np.copyto(out[k], v)
                res[k] = out[k]
    return res


def _padded_dims(dims: dict, mp: int, n, e, p, lv_real, np_real, ep_real) -> tuple:
    """(N, E, P, L, NP, EP): the overrides in ``dims``, else the buckets of
    the real extents; raises when an override is too small."""
    N = dims.get("N", _round_up(bucket(n + 1), BLOCK_D * mp))
    E = dims.get("E", bucket(e))
    P = dims.get("P", bucket(p))
    L = dims.get("L", bucket(max(lv_real, 1)))
    NP = dims.get("NP", bucket(max(np_real, 1)))
    EP = dims.get("EP", _round_up(bucket(max(ep_real, 1)), mp))
    if not (N > n and N % BLOCK_D == 0 and E >= e and P >= p and L >= lv_real
            and NP >= np_real and EP >= ep_real):
        raise ValueError(f"collate: dims {dims} too small for this batch (n={n}, e={e}, "
                         f"p={p}, levels={lv_real}, np={np_real}, ep={ep_real})")
    return N, E, P, L, NP, EP


def _block_width(dims: dict, key: str, real: int) -> int:
    """EBF / EBR: the override, else the bucket of the real extent."""
    eb = dims.get(key)
    if eb is None:
        return bucket(max(real, 1))
    if eb < real:
        raise ValueError(f"collate: EBF/EBR override {eb} < {real}")
    return eb


_FILL_KEYS = {  # batch key -> collate_fill_native key
    "node_perm": "perm", "node_inv": "inv",
    "edge_src": "edge_src", "edge_dst": "edge_dst",
    "lv_nodes": "lv_nodes", "lv_node_valid": "lv_node_valid",
    "lv_edge_src": "lv_edge_src", "lv_edge_dst_slot": "lv_edge_dst_slot",
    "lv_edge_valid": "lv_edge_valid", "lv_edge_id": "lv_edge_id",
    "edge_lv_row": "edge_lv_row",
    "lv_start": "lv_start",
    "fa_src": "fa_src", "fa_slot": "fa_slot", "fa_valid": "fa_valid",
    "ra_src": "ra_src", "ra_slot": "ra_slot", "ra_valid": "ra_valid",
    "fa_eid": "fa_eid", "ra_eid": "ra_eid",
    "deg_in": "deg_in", "deg_out": "deg_out",
}


def _pad_into(dst: np.ndarray, a: np.ndarray, fill=0) -> np.ndarray:
    dst[: a.shape[0]] = a
    dst[a.shape[0] :] = fill
    return dst


def _mask_into(dst: np.ndarray, k: int) -> np.ndarray:
    dst[:k] = True
    dst[k:] = False
    return dst


def _collate_native(gate, fwd, prob, graph_id, edge, tt_pairs, tt_dis,
                    n_graphs, n, e, p, dims, mp, out=None):
    """``collate``'s tables built by the native library
    (``mg_collate_stats``, then ``mg_collate_fill``): the whole batch dict,
    byte-identical to the numpy branch, or None when the library is
    unavailable. ``out``: preallocated arrays (one per batch key) filled in
    place."""
    fwd32 = fwd.astype(np.int32, copy=False)
    stats = collate_stats_native(fwd32, edge[0], edge[1], BLOCK_D)
    if stats is None:
        return None
    lv_real, np_real, ep_real, ebf_real, ebr_real = stats
    dims = dims or {}
    N, E, P, L, NP, EP = _padded_dims(dims, mp, n, e, p, lv_real, np_real, ep_real)
    EBF = _block_width(dims, "EBF", ebf_real)
    EBR = _block_width(dims, "EBR", ebr_real)
    t = collate_fill_native(
        fwd32, edge[0], edge[1],
        {"N": N, "E": E, "L": L, "NP": NP, "EP": EP, "EBF": EBF, "EBR": EBR},
        BLOCK_D, n,
        out={fk: out[bk] for bk, fk in _FILL_KEYS.items()} if out is not None else None,
    )
    perm_n = t["perm"][:n]
    inv = t["inv"]
    tt_a = inv[tt_pairs[0]].astype(np.int32) if p else np.zeros(0, np.int32)
    tt_b = inv[tt_pairs[1]].astype(np.int32) if p else np.zeros(0, np.int32)
    if out is not None:
        res = dict(out)
        _pad_into(res["gate"], gate[perm_n].astype(np.int32))
        _mask_into(res["node_valid"], n)
        _pad_into(res["forward_level"], fwd32[perm_n])
        _pad_into(res["graph_id"], graph_id[perm_n], fill=-1)
        _pad_into(res["prob"], prob[perm_n].astype(np.float32))
        _mask_into(res["edge_valid"], e)
        _pad_into(res["tt_pair_a"], tt_a)
        _pad_into(res["tt_pair_b"], tt_b)
        _mask_into(res["tt_valid"], p)
        _pad_into(res["tt_dis"], tt_dis.astype(np.float32))
    else:
        res = {bk: t[fk] for bk, fk in _FILL_KEYS.items()}
        res.update(
            gate=_pad(gate[perm_n].astype(np.int32), N),
            node_valid=_mask(n, N),
            forward_level=_pad(fwd32[perm_n], N),
            graph_id=_pad(graph_id[perm_n], N, fill=-1),
            prob=_pad(prob[perm_n].astype(np.float32), N),
            edge_valid=_mask(e, E),
            tt_pair_a=_pad(tt_a, P),
            tt_pair_b=_pad(tt_b, P),
            tt_valid=_mask(p, P),
            tt_dis=_pad(tt_dis.astype(np.float32), P),
        )
    res.update(n_nodes=np.int32(n), n_edges=np.int32(e), n_tt=np.int32(p),
               n_graphs=np.int32(n_graphs))
    return res


def _blocked_tables(by, other, nb, eb, dump, eid_fill):
    """Group edges by ``by``-node block of width BLOCK_D; returns padded
    [nb, Eb] tables: message-source node, local slot (by - block_start),
    valid mask, and the original edge index of each slot. ``eb`` overrides
    the bucketed table width."""
    order = np.argsort(by, kind="stable")
    by_s, other_s = by[order], other[order]
    blk = (by_s // BLOCK_D).astype(np.int64)
    counts = np.bincount(blk, minlength=nb) if len(blk) else np.zeros(nb, np.int64)
    eb_real = int(counts.max()) if len(counts) else 0
    if eb is None:
        eb = bucket(max(eb_real, 1))
    elif eb < eb_real:
        raise ValueError(f"collate: EBF/EBR override {eb} < {eb_real}")
    src = np.full((nb, eb), dump, dtype=np.int32)
    slot = np.zeros((nb, eb), dtype=np.int32)
    valid = np.zeros((nb, eb), dtype=bool)
    eid = np.full((nb, eb), eid_fill, dtype=np.int32)
    if len(blk):
        starts = np.concatenate([[0], np.cumsum(counts)])
        rank = np.arange(len(blk)) - starts[blk]
        src[blk, rank] = other_s
        slot[blk, rank] = by_s - blk * BLOCK_D
        valid[blk, rank] = True
        eid[blk, rank] = order.astype(np.int32)
    return src, slot, valid, eid


def _pad(a: np.ndarray, size: int, fill=0) -> np.ndarray:
    out = np.full((size,) + a.shape[1:], fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _mask(k: int, size: int) -> np.ndarray:
    m = np.zeros(size, dtype=bool)
    m[:k] = True
    return m


def natural_dims(graphs: list[CircuitGraph], mp: int = 1) -> dict:
    """The padded dims ``collate(graphs, mp=mp)`` picks: from the native
    stats pass (``shard_dims``), else from a trial collate."""
    d = shard_dims(graphs, mp=mp)
    return d if d is not None else _dims_of(collate(graphs, mp=mp))


def shard_dims(graphs: list[CircuitGraph], mp: int = 1) -> dict | None:
    """The padded dims ``collate`` would pick, computed without building the
    tables (``mg_collate_stats``); None when the library is unavailable."""
    sizes = np.array([g.num_nodes for g in graphs], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    n = int(offsets[-1])
    fwd = np.concatenate([g.forward_level for g in graphs]).astype(np.int32)
    edge = np.concatenate(
        [g.edge_index + offsets[i] for i, g in enumerate(graphs)], axis=1
    ) if any(g.num_edges for g in graphs) else np.zeros((2, 0), dtype=np.int64)
    stats = collate_stats_native(fwd, edge[0], edge[1], BLOCK_D)
    if stats is None:
        return None
    p = sum(int(g.tt_pair_index.shape[1]) if g.tt_pair_index.size else 0 for g in graphs)
    return _bucketed(stats, n, edge.shape[1], p, mp)


def _bucketed(stats, n: int, e: int, p: int, mp: int) -> dict:
    """The padded dims of real extents (stats = lv, np, ep, ebf, ebr)."""
    lv_real, np_real, ep_real, ebf_real, ebr_real = (int(x) for x in stats)
    return {
        "N": _round_up(bucket(n + 1), BLOCK_D * mp),
        "E": bucket(e),
        "P": bucket(p),
        "L": bucket(max(lv_real, 1)),
        "NP": bucket(max(np_real, 1)),
        "EP": _round_up(bucket(max(ep_real, 1)), mp),
        "EBF": bucket(max(ebf_real, 1)),
        "EBR": bucket(max(ebr_real, 1)),
    }


def _dims_of(b: dict) -> dict:
    return {
        "N": b["gate"].shape[0], "E": b["edge_src"].shape[0], "P": b["tt_pair_a"].shape[0],
        "L": b["lv_nodes"].shape[0], "NP": b["lv_nodes"].shape[1],
        "EP": b["lv_edge_src"].shape[1], "EBF": b["fa_src"].shape[1],
        "EBR": b["ra_src"].shape[1],
    }


def _collate_common(groups: list[list[CircuitGraph]]) -> list[dict]:
    """Each group collated at the elementwise max of the groups' natural
    dims, as the JAX package's stats pass gives them: from the native stats
    pass, else from trial collates (a group whose natural dims are already
    the common ones is not collated twice)."""
    pre = [shard_dims(g) for g in groups]
    if all(d is not None for d in pre):
        dims = {k: max(d[k] for d in pre) for k in _DIM_KEYS}
        return [collate(g, dims=dims) for g in groups]
    batches = [collate(g) for g in groups]
    pre = [_dims_of(b) for b in batches]
    dims = {k: max(d[k] for d in pre) for k in _DIM_KEYS}
    return [b if d == dims else collate(g, dims=dims)
            for g, b, d in zip(groups, batches, pre)]


def _partition_chunks(graphs: list[CircuitGraph], num_chunks: int) -> list[list[int]]:
    """Greedy node-count balance into num_chunks bins, deterministic, input
    order preserved within each bin."""
    return _partition_by_size([g.num_nodes for g in graphs], num_chunks)


def _partition_by_size(sizes, num_chunks: int) -> list[list[int]]:
    if len(sizes) < num_chunks:
        raise ValueError(f"fewer graphs ({len(sizes)}) than chunks ({num_chunks})")
    order = sorted(range(len(sizes)), key=lambda i: -int(sizes[i]))
    bins: list[list[int]] = [[] for _ in range(num_chunks)]
    loads = [0] * num_chunks
    for gi in order:
        k = loads.index(min(loads))
        bins[k].append(gi)
        loads[k] += int(sizes[gi])
    for b in bins:
        b.sort()
    return bins


def _chunked_dims_of(batch: dict, C: int) -> dict:
    """Per-chunk padded dims of a chunked batch."""
    return {
        "N": batch["gate"].shape[0] // C, "E": batch["edge_src"].shape[0] // C,
        "P": batch["tt_pair_a"].shape[0] // C, "L": batch["lv_nodes"].shape[1],
        "NP": batch["lv_nodes"].shape[2], "EP": batch["lv_edge_src"].shape[2],
        "EBF": batch["fa_src"].shape[1], "EBR": batch["ra_src"].shape[1],
    }


def chunked_shard_dims(graphs: list[CircuitGraph], num_chunks: int) -> dict | None:
    """The per-chunk dims ``collate_chunked`` uses, from the native stats
    pass (no collate); None when the library is unavailable."""
    if num_chunks == 1:
        return shard_dims(graphs)
    pre = [shard_dims([graphs[i] for i in b]) for b in _partition_chunks(graphs, num_chunks)]
    if any(d is None for d in pre):
        return None
    return {k: max(d[k] for d in pre) for k in _DIM_KEYS}


def collate_chunked(graphs: list[CircuitGraph], num_chunks: int,
                    dims: dict | None = None) -> dict:
    """Partition graphs into ``num_chunks`` balanced groups, collate each
    with common padded dims, and merge into one batch whose node space is the
    concatenation of the chunks: chunk k occupies rows
    [k * N_sub, (k + 1) * N_sub), keeping its own padding tail and dump slot.

    Graphs are disjoint, so a large batch is exactly C independent
    sub-batches for the level recurrence, while every loss stays global
    (masked over the concatenated space).

    Layout (read by ``models/dg_ae.forward`` and ``train/losses``):
      * node, edge and tt arrays are global: per-chunk local ids plus
        k * N_sub (k * E_sub for edge ids); the blocked tables merge the same
        way, so the struct towers read them as one batch;
      * the level tables keep local node ids under a leading [C, L] axis;
        ``lv_edge_id`` and ``edge_lv_row`` are global;
      * ``chunk_counts`` [C] carries the chunks' valid-node counts, so that
        negative sampling skips the interior padding tails.
    """
    if not graphs or num_chunks < 1:
        raise ValueError("collate_chunked: empty batch or num_chunks < 1")
    if num_chunks == 1:
        return collate(graphs, dims=dims)
    bins = _partition_chunks(graphs, num_chunks)
    groups = [[graphs[i] for i in b] for b in bins]
    if dims is not None:
        batches = [collate(g, dims=dims) for g in groups]
    else:
        batches = _collate_common(groups)

    C = num_chunks
    N_sub = batches[0]["gate"].shape[0]
    E_sub = batches[0]["edge_src"].shape[0]
    in_sizes = np.array([g.num_nodes for g in graphs], dtype=np.int64)
    in_offsets = np.concatenate([[0], np.cumsum(in_sizes)])

    def cat(key):
        return np.concatenate([b[key] for b in batches])

    def cat_off(key, off):
        return np.concatenate([b[key] + k * off for k, b in enumerate(batches)])

    def stk(key):
        return np.stack([b[key] for b in batches])

    out = {
        "gate": cat("gate"),
        "node_valid": cat("node_valid"),
        "forward_level": cat("forward_level"),
        "prob": cat("prob"),
        "deg_in": cat("deg_in"),
        "deg_out": cat("deg_out"),
        "edge_src": cat_off("edge_src", N_sub),
        "edge_dst": cat_off("edge_dst", N_sub),
        "edge_valid": cat("edge_valid"),
        "tt_pair_a": cat_off("tt_pair_a", N_sub),
        "tt_pair_b": cat_off("tt_pair_b", N_sub),
        "tt_valid": cat("tt_valid"),
        "tt_dis": cat("tt_dis"),
        "fa_src": cat_off("fa_src", N_sub),
        "fa_slot": cat("fa_slot"),
        "fa_valid": cat("fa_valid"),
        "ra_src": cat_off("ra_src", N_sub),
        "ra_slot": cat("ra_slot"),
        "ra_valid": cat("ra_valid"),
        # values are edge ids: offset by E_sub
        "fa_eid": cat_off("fa_eid", E_sub),
        "ra_eid": cat_off("ra_eid", E_sub),
        # level tables: leading [C, L], node ids local, edge ids global
        "lv_nodes": stk("lv_nodes"),
        "lv_node_valid": stk("lv_node_valid"),
        "lv_edge_src": stk("lv_edge_src"),
        "lv_edge_dst_slot": stk("lv_edge_dst_slot"),
        "lv_edge_valid": stk("lv_edge_valid"),
        "lv_edge_id": np.stack([b["lv_edge_id"] + k * E_sub for k, b in enumerate(batches)]),
        # flat (chunk, level, rank) slot of each edge: offset by the chunk's
        # level-table size (the stacked [C, L, EP] tables flatten that way)
        "edge_lv_row": cat_off(
            "edge_lv_row",
            batches[0]["lv_edge_src"].shape[0] * batches[0]["lv_edge_src"].shape[1],
        ),
        "lv_start": stk("lv_start"),
        "n_nodes": np.int32(sum(int(b["n_nodes"]) for b in batches)),
        "n_edges": np.int32(sum(int(b["n_edges"]) for b in batches)),
        "n_tt": np.int32(sum(int(b["n_tt"]) for b in batches)),
        "n_graphs": np.int32(len(graphs)),
        "chunk_counts": np.array([int(b["n_nodes"]) for b in batches], dtype=np.int32),
        "chunk_ecounts": np.array([int(b["n_edges"]) for b in batches], dtype=np.int32),
        "chunk_tts": np.array([int(b["n_tt"]) for b in batches], dtype=np.int32),
    }
    # graph ids: chunk-local 0..len-1 -> input indices
    gids = []
    for k, b in enumerate(batches):
        lut = np.asarray(bins[k], dtype=np.int32)
        g = b["graph_id"]
        gids.append(np.where(g >= 0, lut[np.clip(g, 0, len(lut) - 1)], -1))
    out["graph_id"] = np.concatenate(gids)
    # node_perm / node_inv over the global original ordering (input graph
    # order, unpadded): new global row -> original id and back
    node_perm = np.arange(C * N_sub, dtype=np.int32)
    node_inv = np.arange(C * N_sub, dtype=np.int32)
    for k, b in enumerate(batches):
        n_k = int(b["n_nodes"])
        orig_to_global = np.concatenate(
            [in_offsets[g] + np.arange(in_sizes[g]) for g in bins[k]]
        ).astype(np.int32)
        node_perm[k * N_sub : k * N_sub + n_k] = orig_to_global[b["node_perm"][:n_k]]
        node_inv[orig_to_global] = k * N_sub + b["node_inv"][:n_k]
    out["node_perm"] = node_perm
    out["node_inv"] = node_inv
    return out


def collate_fit(
    graphs: list[CircuitGraph],
    max_nodes: int | None = None,
    max_ep: int | None = None,
    max_np: int | None = None,
) -> dict:
    """Collate with the smallest chunking whose per-chunk padded dims pass
    the fused level kernel's size gate (``ops/level_kernel.kernel_fits``):
    C = 1, plain ``collate``, when the batch already does. The defaults are
    that gate's constants."""
    if max_nodes is None or max_ep is None or max_np is None:
        from ..ops.level_kernel import KERNEL_MAX_EP, KERNEL_MAX_NODES, KERNEL_MAX_NP

        max_nodes = KERNEL_MAX_NODES if max_nodes is None else max_nodes
        max_ep = KERNEL_MAX_EP if max_ep is None else max_ep
        max_np = KERNEL_MAX_NP if max_np is None else max_np
    b = collate(graphs)
    if (b["gate"].shape[0] <= max_nodes and b["lv_edge_src"].shape[1] <= max_ep
            and b["lv_nodes"].shape[1] <= max_np):
        return b
    total = sum(g.num_nodes for g in graphs)
    biggest = max(g.num_nodes for g in graphs)
    last = None
    for c in range(2, len(graphs) + 1):
        # cheap lower-bound reject before paying for a stats pass or a collate
        per = max(biggest + 1, (total + c) // c)
        if _round_up(bucket(per), BLOCK_D) > max_nodes and c < len(graphs):
            continue
        d = chunked_shard_dims(graphs, c)
        if d is not None:   # the native stats pass: probe without collating
            fits = d["N"] <= max_nodes and d["EP"] <= max_ep and d["NP"] <= max_np
            if fits or c == len(graphs):
                return collate_chunked(graphs, c, dims=d)
            continue
        last = collate_chunked(graphs, c)
        if (last["gate"].shape[0] // c <= max_nodes and last["lv_edge_src"].shape[2] <= max_ep
                and last["lv_nodes"].shape[2] <= max_np):
            return last
    return last if last is not None else b


def pick_chunks_for(graphs: list[CircuitGraph], dim_hidden: int) -> int:
    """Smallest chunk count C whose per-chunk padded dims pass the fused
    kernel's size gate; 1 when the batch already fits or no C does."""
    from ..ops.level_kernel import kernel_fits

    for c in range(1, len(graphs) + 1):
        d = chunked_shard_dims(graphs, c)
        if d is None:   # no native stats pass: trial collates
            d = _chunked_dims_of(collate_chunked(graphs, c), c) if c > 1 else natural_dims(graphs)
        if kernel_fits(d["N"], d["EP"], d["NP"], dim_hidden):
            return c
    return 1


# a split batch's groups carry what the forward reads, not the loss arrays
_SPLIT_FWD_DROP = {"tt_pair_a", "tt_pair_b", "tt_valid", "tt_dis", "prob",
                   "node_perm", "node_inv", "graph_id"}


def split_groups_by_shape(lmax, edges, nodes, num_groups: int) -> list[np.ndarray]:
    """The shape-sort partition of ``collate_split`` and ``split_dims``:
    members sorted by (max level, edge count, node count) with stable ties,
    then split into ``num_groups`` equal-count groups."""
    order = np.lexsort((np.asarray(nodes), np.asarray(edges), np.asarray(lmax)))
    return [np.asarray(a) for a in np.array_split(order, num_groups)]


def _split_partition(graphs: list[CircuitGraph], num_groups: int) -> list[np.ndarray]:
    lmax = [int(g.forward_level.max(initial=0)) for g in graphs]
    return split_groups_by_shape(lmax, [g.num_edges for g in graphs],
                                 [g.num_nodes for g in graphs], num_groups)


def split_dims(shards: list[list[CircuitGraph]], num_groups: int) -> list[dict]:
    """Per-group dims agreed across several shards: the elementwise max of
    each shard's group-g natural dims."""
    per_group: list[list[dict]] = [[] for _ in range(num_groups)]
    for graphs in shards:
        for g, gi in enumerate(_split_partition(graphs, num_groups)):
            per_group[g].append(natural_dims([graphs[i] for i in gi]))
    return [{k: max(d[k] for d in ds) for k in ds[0]} for ds in per_group]


def collate_split(graphs: list[CircuitGraph], num_groups: int,
                  dims: list[dict] | None = None) -> dict:
    """Shape-aware split batch: graphs sorted by shape (levels, edges, nodes)
    and partitioned into ``num_groups`` equal-count groups, each collated
    with its own bucketed dims, so that the padding hugs each group's
    members. The forward runs per group (``batch["groups"]``); the losses
    stay global: the top-level edge, tt and prob arrays are expressed in the
    concatenated (group-offset) node order.

    Negative sampling maps uniform ids through ``chunk_counts`` /
    ``chunk_offsets`` (the groups' valid-node runs), never hitting interior
    padding.
    """
    gidx = [list(a) for a in _split_partition(graphs, num_groups)]
    gbs = [collate([graphs[i] for i in gi], dims=dims[g] if dims is not None else None)
           for g, gi in enumerate(gidx)]

    n_pad = [gb["gate"].shape[0] for gb in gbs]
    offs = np.concatenate([[0], np.cumsum(n_pad)]).astype(np.int32)

    def cat(k, off_by_node=False):
        # node-id offsets keep padding entries in range: each group's dump
        # and fill ids land inside its own padded rows (masked by *_valid)
        return np.concatenate([gb[k] + offs[g] if off_by_node else gb[k]
                               for g, gb in enumerate(gbs)])

    out = {
        "gate": cat("gate"),
        "node_valid": cat("node_valid"),
        "forward_level": cat("forward_level"),
        "prob": cat("prob"),
        "edge_src": cat("edge_src", True),
        "edge_dst": cat("edge_dst", True),
        "edge_valid": cat("edge_valid"),
        "tt_pair_a": cat("tt_pair_a", True),
        "tt_pair_b": cat("tt_pair_b", True),
        "tt_valid": cat("tt_valid"),
        "tt_dis": cat("tt_dis"),
        "n_nodes": np.int32(sum(int(gb["n_nodes"]) for gb in gbs)),
        "n_edges": np.int32(sum(int(gb["n_edges"]) for gb in gbs)),
        "n_tt": np.int32(sum(int(gb["n_tt"]) for gb in gbs)),
        "n_graphs": np.int32(len(graphs)),
        "chunk_counts": np.asarray([int(gb["n_nodes"]) for gb in gbs], np.int32),
        "chunk_offsets": offs[:-1],
    }
    # global node_inv: original-input-order concat id -> split-layout id
    orig_off = np.concatenate([[0], np.cumsum([g.num_nodes for g in graphs])])
    inv = np.zeros(int(orig_off[-1]), np.int32)
    for g, gi in enumerate(gidx):
        ginv = np.asarray(gbs[g]["node_inv"])
        pos = 0
        for i in gi:
            n = graphs[i].num_nodes
            inv[orig_off[i]:orig_off[i] + n] = ginv[pos:pos + n] + offs[g]
            pos += n
    out["node_inv"] = inv
    out["groups"] = tuple(
        {k: v for k, v in gb.items() if k not in _SPLIT_FWD_DROP} for gb in gbs
    )
    return out


def collate_shards(shards: list[list[CircuitGraph]], mp: int = 1,
                   dims: dict | None = None, num_chunks: int = 1) -> dict:
    """Collate one shard per dp rank with common padded dims and stack them
    on a leading dp axis. ``mp`` passes the model-parallel hint to
    ``collate``. ``dims``: explicit common dims (the trainer's running max);
    otherwise the elementwise max of the shards' natural dims. With all
    eight dims known, every shard is collated straight into one stacked
    buffer (``_collate_shards_zero_copy``). With ``num_chunks > 1`` each
    shard is ``collate_chunked`` into that many chunks at common per-chunk
    dims, and the leaves stack to [dp, C, L, ...] and so on; ``mp`` does
    not apply there, as in the JAX package."""
    if num_chunks > 1:
        if dims is None:
            per = [chunked_shard_dims(s, num_chunks) for s in shards]
            if any(d is None for d in per):   # no native stats pass: trial collates
                per = [_chunked_dims_of(collate_chunked(s, num_chunks), num_chunks)
                       for s in shards]
            dims = {k: max(d[k] for d in per) for k in per[0]}
        return stack_batches([collate_chunked(s, num_chunks, dims=dims) for s in shards])
    if dims is None:
        pre = [natural_dims(s, mp=mp) for s in shards]
        dims = {k: max(d[k] for d in pre) for k in _DIM_KEYS}
    if all(k in dims for k in _DIM_KEYS):
        return _collate_shards_zero_copy(shards, dims, mp)
    return stack_batches([collate(s, dims=dims, mp=mp) for s in shards])


def stacked_batch_buffers(dp: int, dims: dict) -> dict:
    """Uninitialised [dp, ...] buffers for ``dp`` shards collated at
    ``dims``: the destination of ``_collate_shards_zero_copy``."""
    N, E, P, L, NP, EP, EBF, EBR = (dims[k] for k in _DIM_KEYS)
    nb = N // BLOCK_D

    def a(shape, dt):
        return np.empty((dp,) + shape, dt)

    return {
        "node_perm": a((N,), np.int32), "node_inv": a((N,), np.int32),
        "gate": a((N,), np.int32), "node_valid": a((N,), bool),
        "forward_level": a((N,), np.int32), "graph_id": a((N,), np.int32),
        "prob": a((N,), np.float32),
        "edge_src": a((E,), np.int32), "edge_dst": a((E,), np.int32),
        "edge_valid": a((E,), bool),
        "tt_pair_a": a((P,), np.int32), "tt_pair_b": a((P,), np.int32),
        "tt_valid": a((P,), bool), "tt_dis": a((P,), np.float32),
        "n_nodes": a((), np.int32), "n_edges": a((), np.int32),
        "n_tt": a((), np.int32), "n_graphs": a((), np.int32),
        "lv_nodes": a((L, NP), np.int32), "lv_node_valid": a((L, NP), bool),
        "lv_edge_src": a((L, EP), np.int32),
        "lv_edge_dst_slot": a((L, EP), np.int32),
        "lv_edge_valid": a((L, EP), bool), "lv_edge_id": a((L, EP), np.int32),
        "edge_lv_row": a((E,), np.int32),
        "lv_start": a((L,), np.int32),
        "fa_src": a((nb, EBF), np.int32), "fa_slot": a((nb, EBF), np.int32),
        "fa_valid": a((nb, EBF), bool),
        "ra_src": a((nb, EBR), np.int32), "ra_slot": a((nb, EBR), np.int32),
        "ra_valid": a((nb, EBR), bool),
        "fa_eid": a((nb, EBF), np.int32), "ra_eid": a((nb, EBR), np.int32),
        "deg_in": a((N,), np.float32), "deg_out": a((N,), np.float32),
    }


def _concat(arrs: list, dtype) -> np.ndarray:
    """The arrays concatenated into one C-contiguous array of ``dtype``."""
    return np.ascontiguousarray(np.concatenate(arrs), dtype=dtype) if arrs else np.zeros(0, dtype)


class GroupStatsCache:
    """A dataset's per-graph arrays concatenated once, for the native
    library's batched stats pass (``mg_group_stats``): ``group_dims`` gives
    the padded dims of every group of graph ids in one threaded call, the
    trainer's dims scan of a whole epoch. The cache snapshots the graphs'
    sizes, levels and edges; build a new one when they change (the trainer
    keys it on the dataset's identity and length)."""

    def __init__(self, graphs: list[CircuitGraph]):
        self.num_graphs = len(graphs)
        self.n = np.array([g.num_nodes for g in graphs], np.int64)
        self.e = np.array([g.num_edges for g in graphs], np.int64)
        self.p = np.array(
            [g.tt_pair_index.shape[1] if g.tt_pair_index.size else 0 for g in graphs],
            np.int64,
        )
        self.node_off = np.concatenate([[0], np.cumsum(self.n)]).astype(np.int64)
        self.edge_off = np.concatenate([[0], np.cumsum(self.e)]).astype(np.int64)
        self.fwd_all = _concat([g.forward_level for g in graphs], np.int32)
        self.esrc_all = _concat([g.edge_index[0] for g in graphs if g.num_edges], np.int64)
        self.edst_all = _concat([g.edge_index[1] for g in graphs if g.num_edges], np.int64)
        # per-graph max forward level: the split partition's first sort key
        if len(graphs) and self.fwd_all.size:
            self.lmax = np.maximum.reduceat(self.fwd_all, self.node_off[:-1])
        else:
            self.lmax = np.zeros(len(graphs), np.int32)

    def group_dims(self, groups: list[np.ndarray], mp: int = 1) -> list[dict] | None:
        """``shard_dims`` of every group of graph ids, in one native call;
        None when the library is unavailable."""
        ids = np.ascontiguousarray(np.concatenate([np.asarray(g) for g in groups]),
                                   dtype=np.int64)
        group_ptr = np.zeros(len(groups) + 1, np.int64)
        np.cumsum([len(g) for g in groups], out=group_ptr[1:])
        stats = group_stats_native(
            group_ptr, ids, self.n, self.e, self.node_off, self.edge_off,
            self.fwd_all, self.esrc_all, self.edst_all, BLOCK_D,
            num_threads=num_threads(len(groups)),
        )
        if stats is None:
            return None
        return [_bucketed(stats[gi], int(self.n[g].sum()), int(self.e[g].sum()),
                          int(self.p[g].sum()), mp)
                for gi, g in enumerate(np.asarray(g) for g in groups)]


def _collate_shards_zero_copy(shards, dims: dict, mp: int) -> dict:
    """Every shard collated straight into one stacked [dp, ...] buffer: no
    per-shard arrays, no stack pass. With the native library the whole step
    is one call (``mg_collate_step``) threaded over the shards (ctypes
    releases the GIL); otherwise each shard's ``collate`` writes into its
    views of the buffer."""
    big = stacked_batch_buffers(len(shards), dims)
    if _collate_step_native(shards, dims, big) is not None:
        return big
    for d, s in enumerate(shards):
        b = collate(s, dims=dims, mp=mp, out={k: big[k][d] for k in big})
        for k in ("n_nodes", "n_edges", "n_tt", "n_graphs"):
            big[k][d] = b[k]
    return big


def _collate_step_native(shards, dims: dict, big: dict):
    """The step's graphs concatenated in shard order (each with its own node
    ids) and handed to ``mg_collate_step``. Returns ``big``, or None when
    the library is unavailable."""
    if get_lib() is None:
        return None
    graphs = [g for s in shards for g in s]
    shard_graphs = np.array([len(s) for s in shards], np.int64)
    graph_nodes = np.array([g.num_nodes for g in graphs], np.int64)
    graph_edges = np.array([g.num_edges for g in graphs], np.int64)
    graph_tt = np.array(
        [g.tt_pair_index.shape[1] if g.tt_pair_index.size else 0 for g in graphs], np.int64)
    with_tt = [g for g in graphs if g.tt_pair_index.size]
    out = collate_step_native(
        shard_graphs, graph_nodes, graph_edges, graph_tt,
        _concat([g.gate for g in graphs], np.int32),
        _concat([g.forward_level for g in graphs], np.int32),
        _concat([g.prob for g in graphs], np.float32),
        _concat([g.edge_index[0] for g in graphs if g.num_edges], np.int64),
        _concat([g.edge_index[1] for g in graphs if g.num_edges], np.int64),
        _concat([g.tt_pair_index[0] for g in with_tt], np.int64),
        _concat([g.tt_pair_index[1] for g in with_tt], np.int64),
        _concat([g.tt_dis for g in with_tt], np.float32),
        dims, BLOCK_D, big, num_threads=num_threads(len(shards)),
    )
    if out is None:
        return None
    big["n_graphs"][:] = shard_graphs
    return big


def stack_batches(batches: list[dict]) -> dict:
    """np.stack structurally identical batch dicts leaf-wise on a leading
    axis. Split batches stack too: the ``groups`` tuple is stacked per group
    and key. Host-only keys that vary per member (``node_inv``) must be
    dropped by the caller first."""
    first = batches[0]
    out = {}
    for k, v in first.items():
        if k == "groups":
            out[k] = tuple(
                {kk: np.stack([np.asarray(b["groups"][g][kk]) for b in batches])
                 for kk in v[g]}
                for g in range(len(v))
            )
        else:
            out[k] = np.stack([np.asarray(b[k]) for b in batches])
    return out


def collate_split_step(shards: list[list[CircuitGraph]], dims: list[dict]) -> dict:
    """The stacked [K, ...] split batch of K shards at agreed per-group dims:
    ``stack_batches([collate_split(s, G, dims) for s in shards])`` without
    the host-only ``node_inv``. Group position g of every shard is collated
    at ``dims[g]`` and stacked; the global loss arrays (the groups' node
    order, each group offset by the padded rows before it) are
    concatenated along axis 1."""
    G, K = len(dims), len(shards)
    parts = [_split_partition(s, G) for s in shards]
    # group position g of every shard at dims[g]: one stacked collate (one
    # native call, threaded over the shards)
    gstk = [collate_shards([[s[i] for i in p[g]] for s, p in zip(shards, parts)], dims=dims[g])
            for g in range(G)]
    offs = np.concatenate([[0], np.cumsum([gb["gate"].shape[1] for gb in gstk])]).astype(np.int32)

    def cat(k, off_by_node=False):
        return np.concatenate([np.asarray(gb[k]) + offs[g] if off_by_node else np.asarray(gb[k])
                               for g, gb in enumerate(gstk)], axis=1)

    def tot(k):
        return np.sum([gb[k] for gb in gstk], axis=0).astype(np.int32)

    out = {
        "gate": cat("gate"),
        "node_valid": cat("node_valid"),
        "forward_level": cat("forward_level"),
        "prob": cat("prob"),
        "edge_src": cat("edge_src", True),
        "edge_dst": cat("edge_dst", True),
        "edge_valid": cat("edge_valid"),
        "tt_pair_a": cat("tt_pair_a", True),
        "tt_pair_b": cat("tt_pair_b", True),
        "tt_valid": cat("tt_valid"),
        "tt_dis": cat("tt_dis"),
        "n_nodes": tot("n_nodes"),
        "n_edges": tot("n_edges"),
        "n_tt": tot("n_tt"),
        "n_graphs": np.array([len(s) for s in shards], np.int32),
        "chunk_counts": np.stack([gb["n_nodes"].astype(np.int32) for gb in gstk], axis=1),
        "chunk_offsets": np.broadcast_to(offs[:-1], (K, G)).copy(),
    }
    out["groups"] = tuple({k: v for k, v in gb.items() if k not in _SPLIT_FWD_DROP}
                          for gb in gstk)
    return out


def shard_levels_by_dst(batch: dict, mp: int) -> dict:
    """Re-group the level tables DST-COMPLETE across ``mp`` members, for the
    model-parallel kernel route (``parallel/sharded.sharded_forward_kernel``).

    Member m owns destination slots [m * Np_m, (m + 1) * Np_m) of every
    level and ALL edges pointing at them, so the per-destination softmax is
    member-local and each member runs the single-level step kernel on its
    slice. Destination slots are renumbered member-locally; the source order
    within a level (src-sorted) is kept.

    Returns a new dict: the batch and the member tables
      mp_lv_edge_src / mp_lv_edge_dst_slot / mp_lv_edge_valid /
      mp_lv_edge_id                                  [L, mp, Ep_m]
      mp_lv_nodes / mp_lv_node_valid                 [L, mp, Np_m]
    padded as ``collate`` pads (sources and nodes -> the dump node, edge ids
    -> the last padding edge, slots -> 0). Np_m rounds up to 8 and Ep_m to
    128, the JAX package's alignments, kept so that the tables stay
    byte-identical (the kernel takes any Ep). Takes a ``collate`` batch
    ([L, ...] tables) or a ``collate_shards`` one ([dp, L, ...] tables ->
    [dp, L, mp, ...], common Ep_m); unchunked batches only."""
    lv_src = np.asarray(batch["lv_edge_src"])
    stacked = lv_src.ndim == 3
    if lv_src.ndim not in (2, 3):
        raise ValueError("shard_levels_by_dst expects an unchunked batch")

    def rows(key):
        a = np.asarray(batch[key])
        return a if stacked else a[None]

    lv_src = rows("lv_edge_src")
    lv_dslot = rows("lv_edge_dst_slot")
    lv_evalid = rows("lv_edge_valid")
    lv_eid = rows("lv_edge_id")
    lv_nodes = rows("lv_nodes")
    lv_nvalid = rows("lv_node_valid")
    B, L, EP = lv_src.shape
    NP = lv_nodes.shape[2]
    dumps = np.asarray(batch["n_nodes"]).reshape(-1).astype(np.int64)
    E = int(np.asarray(batch["edge_src"]).shape[-1])

    np_m = _round_up(-(-NP // mp), 8)

    # per-(shard, level, member) edge counts -> one common padded Ep_m
    emember = np.where(lv_evalid, lv_dslot // np_m, -1)
    ep_m = 0
    for m in range(mp):
        ep_m = max(ep_m, int((emember == m).sum(axis=2).max(initial=0)))
    ep_m = max(_round_up(ep_m, 128), 128)

    e_src = np.empty((B, L, mp, ep_m), dtype=np.int32)
    e_src[:] = dumps[:, None, None, None]
    e_dslot = np.zeros((B, L, mp, ep_m), dtype=np.int32)
    e_valid = np.zeros((B, L, mp, ep_m), dtype=bool)
    e_id = np.full((B, L, mp, ep_m), E - 1, dtype=np.int32)
    for b in range(B):
        for lv in range(L):
            for m in range(mp):
                sel = np.flatnonzero(emember[b, lv] == m)  # keeps the source order
                k = len(sel)
                if k == 0:
                    continue
                e_src[b, lv, m, :k] = lv_src[b, lv, sel]
                e_dslot[b, lv, m, :k] = lv_dslot[b, lv, sel] - m * np_m
                e_valid[b, lv, m, :k] = True
                e_id[b, lv, m, :k] = lv_eid[b, lv, sel]

    nodes_pad = np.empty((B, L, mp * np_m), dtype=np.int32)
    nodes_pad[:] = dumps[:, None, None]
    nodes_pad[:, :, :NP] = lv_nodes
    nvalid_pad = np.zeros((B, L, mp * np_m), dtype=bool)
    nvalid_pad[:, :, :NP] = lv_nvalid

    sq = (lambda a: a) if stacked else (lambda a: a[0])
    out = dict(batch)
    out.update(
        mp_lv_edge_src=sq(e_src),
        mp_lv_edge_dst_slot=sq(e_dslot),
        mp_lv_edge_valid=sq(e_valid),
        mp_lv_edge_id=sq(e_id),
        mp_lv_nodes=sq(nodes_pad.reshape(B, L, mp, np_m)),
        mp_lv_node_valid=sq(nvalid_pad.reshape(B, L, mp, np_m)),
    )
    return out
