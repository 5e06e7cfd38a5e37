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

Not ported: the model-parallel ``mp`` hint and the in-place ``out`` buffers
of ``collate``, ``collate_shards``, ``collate_split_step``,
``stack_batches``, ``GroupStatsCache`` and ``shard_levels_by_dst``.
"""
from __future__ import annotations

import numpy as np

from .graph import CircuitGraph

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


def collate(graphs: list[CircuitGraph], dims: dict | None = None) -> dict:
    """Disjoint-union + pad a list of circuits into one static-shape batch
    (a dict of numpy arrays and numpy scalars).

    ``dims``: optional overrides of the padded dims ('N', 'E', 'P', 'L',
    'NP', 'EP', 'EBF', 'EBR'), so that several sub-batches share one shape."""
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
    N = dims.get("N", _round_up(bucket(n + 1), BLOCK_D))
    E = dims.get("E", bucket(e))
    P = dims.get("P", bucket(p))
    L = dims.get("L", bucket(max(lv_real, 1)))
    NP = dims.get("NP", bucket(max(np_real, 1)))
    EP = dims.get("EP", bucket(max(ep_real, 1)))
    if not (N > n and N % BLOCK_D == 0 and E >= e and P >= p and L >= lv_real
            and NP >= np_real and EP >= ep_real):
        raise ValueError(f"collate: dims {dims} too small for this batch (n={n}, e={e}, "
                         f"p={p}, levels={lv_real}, np={np_real}, ep={ep_real})")
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


def natural_dims(graphs: list[CircuitGraph]) -> dict:
    """The padded dims ``collate`` picks for these graphs."""
    return _dims_of(collate(graphs))


def _dims_of(b: dict) -> dict:
    return {
        "N": b["gate"].shape[0], "E": b["edge_src"].shape[0], "P": b["tt_pair_a"].shape[0],
        "L": b["lv_nodes"].shape[0], "NP": b["lv_nodes"].shape[1],
        "EP": b["lv_edge_src"].shape[1], "EBF": b["fa_src"].shape[1],
        "EBR": b["ra_src"].shape[1],
    }


def _collate_common(groups: list[list[CircuitGraph]]) -> list[dict]:
    """Each group collated at the elementwise max of the groups' natural
    dims: what the JAX package's ``collate(g, dims=...)`` gives after its
    stats pass. A group whose natural dims are already the common ones is
    not collated twice."""
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
        # cheap lower-bound reject before paying for a collate
        per = max(biggest + 1, (total + c) // c)
        if _round_up(bucket(per), BLOCK_D) > max_nodes and c < len(graphs):
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
