"""Within-level model parallelism: the counterpart of
``mgvae_tpu/parallel/sharded.py``.

The model's unbounded dimension is DAG depth, walked level by level. When
one level's nodes and edges outgrow a device, each level is split across
the ``mp`` members of a model-parallel group:

  * the struct towers (``sharded_struct_tower``): each member sums the
    neighbours of its node blocks (rows [m * N / mp, (m + 1) * N / mp)),
    runs the GRU and LayerNorm on them, and the new state is all-gathered
    each half-round (plain torch, as the JAX package has no kernel here);
  * the level recurrence, by one of two routes:
      - ``sharded_forward_body``, edge-split: member m holds columns
        [m * Ep / mp, (m + 1) * Ep / mp) of every level's edge table; the
        per-destination softmax is normalised across members with a max
        (of detached scores), a sum of the exponentials and a sum of the
        messages: 3 collectives per level; plain torch;
      - ``sharded_forward_kernel``, dst-complete: the tables of
        ``data.batching.shard_levels_by_dst`` give member m every edge into
        its destination slots, so the softmax is member-local and each
        member runs ``ops.level_kernel.level_step`` (TPU kernels 5 and 6 on
        the JAX side, ``csrc/level_step*.cu`` here) on its own tables; one
        all-gather of the new rows per level.

``make_sharded_forward`` and ``make_sharded_train_step`` take the route
the batch and the width select (``route_of``): dst-complete when the batch
carries ``shard_levels_by_dst(batch, mp)`` tables and D fits the kernels
(``level_kernel.MAX_DIM``), edge-split otherwise. The train step composes
it with data parallelism on a (dp, mp) mesh (``parallel.mesh.make_mesh``). Gradients follow the sum
convention of ``parallel.collectives``: every member scales its loss by
1 / mp, each collective's backward sums over the members, and one
all-reduce over the whole mesh after ``backward()`` adds the members'
shares and the dp shards (divided by dp), together with the BN running
state and the metrics (divided by dp * mp: equal on the members of a
shard). Each rank passes its own dp shard (``collate(mp=...)``, and
``shard_levels_by_dst(batch, mp)`` for the kernel route); ``member_slices``
says which part of it member m reads.

As in the JAX package: ``num_rounds == 1`` and not variational.
``compute_dtype="bfloat16"`` computes what the JAX package's sharded routes
compute, which is fp32 (``mgvae_tpu/parallel/sharded.py:84-100, 170-190``):
they never cast the params, as the single-device forward does; the
``struct_input`` one-hot is made in bf16 (exact) and enters the fp32
products promoted; each tower's initial state of ones is bf16, so its first
neighbour sums are rounded once to bf16 (exact up to 256 in-edges); and the
level statics, hs and hf, and kernels 5 and 6 on the member tables are
fp32. At these shapes a bf16 step equals the fp32 one bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..data.batching import BLOCK_D
from ..models import dg_ae
from ..models.dg_ae import DGConfig, level_statics, select_expert, struct_input
from ..ops.init import gru_cell_apply, layernorm_apply, linear_apply
from ..ops.level_kernel import MAX_DIM, level_step
from ..ops.precision import matmul_precision
from ..ops.segment import segment_max, segment_sum
from ..train.step import fold_generator, losses_from_forward, param_leaves
from .collectives import all_gather, all_reduce_max, all_reduce_sum, mean_

# a member's slice of each sharded key: node rows, node-block rows, level
# edge columns (the edge route) and the member axis of the dst-complete
# tables (the kernel route); every other key stays whole
NODE_SHARDED = ("deg_in", "deg_out")
BLOCK_SHARDED = ("fa_src", "fa_slot", "fa_valid", "ra_src", "ra_slot", "ra_valid")
EDGE_SHARDED = ("lv_edge_src", "lv_edge_dst_slot", "lv_edge_valid", "lv_edge_id")
MEMBER_SHARDED = ("mp_lv_edge_src", "mp_lv_edge_dst_slot", "mp_lv_edge_valid",
                  "mp_lv_edge_id", "mp_lv_nodes", "mp_lv_node_valid")
# read off the member's tables on the host (member_slices): its valid
# blocked-table entries as (local destination row, source) lists, the
# struct towers' neighbour sums; the kernel route's valid entries as flat
# positions in its [L, Ep_m] tables and their edge ids
TOWER_EDGES = ("fa_dst_l", "fa_src_l", "ra_dst_l", "ra_src_l")
EDGE_POS, EDGE_POS_ID = "mp_lv_edge_pos", "mp_lv_edge_pos_id"
FULL_NODES = "mp_lv_nodes_full"   # [L, mp * Np_m]: every member's slots, in member order
FULL_VALID = "mp_lv_node_valid_full"
# what the forward and the losses read on the device
DEVICE_KEYS = (("gate", "edge_src", "edge_dst", "edge_valid", "lv_nodes", "lv_node_valid")
               + dg_ae.LOSS_KEYS + NODE_SHARDED + TOWER_EDGES)


def check_supported(cfg: DGConfig) -> None:
    """Raises before any data is read for what the sharded routes do not
    take."""
    if cfg.num_rounds != 1 or cfg.variational or cfg.struct_encoder != "multigcn":
        raise ValueError("the sharded forward takes num_rounds == 1, DG_AE's multigcn towers "
                         "and no variational head, as the JAX package's")


def route_of(batch: dict, cfg: DGConfig, mp: int) -> str:
    """"kernel" (dst-complete) when ``batch`` carries the tables of
    ``shard_levels_by_dst(batch, mp)`` and D <= ``MAX_DIM``, the kernels'
    width; "edge" (edge-split) otherwise, as the single-device forward
    leaves the kernels past that width (``dg_ae.level_recurrence``)."""
    tables = batch.get("mp_lv_edge_src")
    if tables is None or cfg.dim_hidden > MAX_DIM:
        return "edge"
    if tables.shape[1] != mp:
        raise ValueError(f"the batch's dst-complete tables are for mp = {tables.shape[1]}, "
                         f"the group has {mp}: shard_levels_by_dst(batch, {mp})")
    return "kernel"


def member_slices(batch: dict, m: int, mp: int, route: str = "kernel") -> dict:
    """Member m's view of a host batch (one dp shard): its node rows of the
    degrees, its node blocks of the blocked tables, and for the edge route
    its columns of the level edge tables, for the kernel route its
    dst-complete tables [L, ...] with every member's slots beside them
    (``FULL_NODES`` / ``FULL_VALID``, the rows the gathered h_new fills).
    Everything else, the gates and the losses' arrays included, stays
    whole: the expert lookup and the losses read every node and edge.

    Read off those slices on the host: the valid entries of the member's
    blocked tables as (local destination row, source) lists (``TOWER_EDGES``),
    and for the kernel route the flat positions of its valid table entries
    with their edge ids (``EDGE_POS``, ``EDGE_POS_ID``). The device then
    gathers valid entries only: the padding entries, which all point at
    one dump node or edge, would pile every one of their gradients onto one
    row in PyTorch's index backward."""
    n = batch["gate"].shape[0]
    if n % (BLOCK_D * mp):
        raise ValueError(f"N = {n} must be a multiple of mp * {BLOCK_D}: collate with mp={mp}")
    out = dict(batch)
    n_l, nb_l = n // mp, n // BLOCK_D // mp
    for k in NODE_SHARDED:
        out[k] = batch[k][m * n_l:(m + 1) * n_l]
    for k in BLOCK_SHARDED:
        out[k] = batch[k][m * nb_l:(m + 1) * nb_l]
    for tag in ("fa", "ra"):
        blk, col = np.nonzero(out[f"{tag}_valid"])
        out[f"{tag}_dst_l"] = (blk * BLOCK_D + out[f"{tag}_slot"][blk, col]).astype(np.int64)
        out[f"{tag}_src_l"] = out[f"{tag}_src"][blk, col].astype(np.int64)
    if route == "edge":
        ep = batch["lv_edge_src"].shape[1]
        if ep % mp:
            raise ValueError(f"Ep = {ep} must be a multiple of mp: collate with mp={mp}")
        ep_l = ep // mp
        for k in EDGE_SHARDED:
            out[k] = batch[k][:, m * ep_l:(m + 1) * ep_l]
    else:
        if batch.get("mp_lv_edge_src") is None or batch["mp_lv_edge_src"].shape[1] != mp:
            raise ValueError(f"the kernel route needs shard_levels_by_dst(batch, {mp}) tables")
        L = batch["mp_lv_nodes"].shape[0]
        out[FULL_NODES] = batch["mp_lv_nodes"].reshape(L, -1)
        out[FULL_VALID] = batch["mp_lv_node_valid"].reshape(L, -1)
        for k in MEMBER_SHARDED:
            out[k] = batch[k][:, m]
        out[EDGE_POS] = np.flatnonzero(out["mp_lv_edge_valid"])
        out[EDGE_POS_ID] = out["mp_lv_edge_id"].reshape(-1)[out[EDGE_POS]].astype(np.int64)
    return out


def member_to_device(mb: dict, device, route: str) -> dict:
    """The member view's arrays that the forward and the losses read, as
    tensors on ``device``."""
    keys = DEVICE_KEYS + tuple(k for k in dg_ae.RUN_KEYS if k in mb)
    keys += (EDGE_SHARDED if route == "edge"
             else MEMBER_SHARDED + (FULL_NODES, FULL_VALID, EDGE_POS, EDGE_POS_ID))
    return {k: torch.as_tensor(np.asarray(mb[k])).to(device, non_blocking=True) for k in keys}


def sharded_struct_tower(p: dict, x_feat_l, b: dict, num_rounds: int, layernorm: bool,
                         n: int, group) -> torch.Tensor:
    """One multigcn tower with the node blocks split over ``group``:
    ``x_feat_l``, the degrees and the neighbour lists (``TOWER_EDGES``) are
    the member's (``member_slices``). Returns the whole [n, D] state,
    all-gathered each half-round. The neighbour sums are ``index_add_``
    (atomics on CUDA: their order changes from run to run), in fp32 and
    rounded once to the state's dtype, as the JAX tower's one-hot product
    gives them. The initial state of ones has ``x_feat_l``'s dtype, as in
    the JAX tower; with the fp32 params every product is fp32 (a bf16
    operand promoted, as jnp promotes it), and so is every later state."""
    m = dist.get_rank(group)
    dim = p["aggr"]["w"].shape[1]
    n_l = x_feat_l.shape[0]
    state = x_feat_l.new_ones((n, dim))
    x_in = x_feat_l.float()

    def half_round(state, aggr_p, gru_p, rev):
        tag, deg = ("ra", b["deg_out"]) if rev else ("fa", b["deg_in"])
        nbr_l = torch.zeros((n_l, dim), device=state.device).index_add_(
            0, b[f"{tag}_dst_l"], state.index_select(0, b[f"{tag}_src_l"]).float())
        msg_l = nbr_l.to(state.dtype).float() @ aggr_p["w"] + deg[:, None] * aggr_p["b"]
        new_l = gru_cell_apply(gru_p, torch.cat([msg_l, x_in], dim=-1),
                               state[m * n_l:(m + 1) * n_l].float())
        if layernorm:
            new_l = layernorm_apply(p["ln"], new_l)
        return all_gather(new_l, group)

    for _ in range(num_rounds):
        state = half_round(state, p["aggr"], p["update"], False)
        state = half_round(state, p["aggr_r"], p["update_r"], True)
    return state


def _sharded_hs(params, b: dict, cfg: DGConfig, group):
    """hs [N, D], whole on every member, and each node's expert (-1: none)."""
    mp = dist.get_world_size(group)
    m = dist.get_rank(group)
    n = b["gate"].shape[0]
    n_l = n // mp
    x_feat_l = struct_input(b["gate"][m * n_l:(m + 1) * n_l], cfg)
    s = sharded_struct_tower(params["struct"]["source"], x_feat_l, b, cfg.s_rounds,
                             cfg.layernorm, n, group)
    t = sharded_struct_tower(params["struct"]["target"], x_feat_l, b, cfg.t_rounds,
                             cfg.layernorm, n, group)
    hs = linear_apply(params["hs_linear"], torch.cat([s, t], dim=-1))
    return hs, cfg.expert_of_gate(hs.device)[b["gate"].long()]


def sharded_forward_body(params, b: dict, cfg: DGConfig, num_levels: int, group):
    """(hs, hf) of the edge-split route on a member's device batch
    (``member_slices(..., route="edge")``), both whole on every member.

    Per level the member computes the keys, values and scores of its edge
    columns; the per-slot maximum is taken over the members on detached
    scores (softmax does not depend on the shift), the exponentials' sums
    and the messages are summed over them. With a constant shift the
    single-device path's upper clip at 0 is dropped (``mgvae_tpu/parallel/
    sharded.py:131-142``): the shifted scores are <= 0 anyway, and only the
    underflow clip at -80 stays. Levels past the batch's real ones are not
    walked (the JAX scan's padding levels write zeros to the dump row)."""
    D, T = cfg.dim_hidden, cfg.num_experts
    ex = params["experts"]
    hs, expert = _sharded_hs(params, b, cfg, group)
    e_node = expert.clamp(min=0)
    q = select_expert(hs @ ex["wq"][:D], e_node, T) + ex["bq"][e_node]
    aq_n = (q * ex["wa_q"][e_node]).sum(-1) + ex["ba"][e_node]
    wkv = torch.cat([ex["wk"], ex["wv"]], dim=1)                  # [2D, 2TD]
    hf = torch.zeros_like(hs)
    for lv in range(num_levels):
        src, dslot = b["lv_edge_src"][lv].long(), b["lv_edge_dst_slot"][lv].long()
        evalid, nodes = b["lv_edge_valid"][lv], b["lv_nodes"][lv].long()
        np_ = nodes.shape[0]
        e_dst = expert[nodes].clamp(min=0)
        e_edge = e_dst[dslot]
        kv = torch.cat([hs[src], hf[src]], dim=1) @ wkv
        k = select_expert(kv[:, : T * D], e_edge, T) + ex["bk"][e_edge]
        v = select_expert(kv[:, T * D:], e_edge, T) + ex["bv"][e_edge]
        score = aq_n[nodes][dslot] + (k * ex["wa_k"][e_edge]).sum(-1)
        score_m = torch.where(evalid, score, -1e30)
        smax = all_reduce_max(segment_max(score_m.detach(), dslot, np_), group)
        ex_s = torch.exp((score_m - smax[dslot]).clamp(min=-80.0)) * evalid.to(hs.dtype)
        denom = all_reduce_sum(segment_sum(ex_s, dslot, np_), group) + 1e-16
        attn = ex_s / denom[dslot]
        msg = all_reduce_sum(segment_sum(v * attn[:, None], dslot, np_), group)
        gi = select_expert(msg @ ex["w_ih"], e_dst, T) + ex["b_ih"][e_dst]
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = ex["b_hh"][e_dst].chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        upd = b["lv_node_valid"][lv] & (expert[nodes] >= 0)
        h_new = torch.where(upd[:, None], (1.0 - z) * torch.tanh(i_n + r * h_n), 0.0)
        hf = hf.index_copy(0, nodes, h_new)
    return hs, hf


def member_level_inputs(params, b: dict, cfg: DGConfig, hs, expert) -> tuple:
    """``dg_ae.level_scan_inputs``' 12 arguments for a member's
    dst-complete tables [L, Ep_m] / [L, Np_m]: the per-edge statics of the
    whole batch (``dg_ae.level_statics``) gathered at the member's valid
    edges (0 on the padding entries), its tables, and its slots' update
    masks and experts; ``level_step`` takes row lv of the first seven with
    the five weights."""
    pack, wkv_hf = level_statics(params, b, cfg, hs, expert)
    ex = params["experts"]
    nodes_l = b["mp_lv_nodes"]
    e_nodes = expert[nodes_l.long()]
    # the valid entries' rows of the pack; the padding entries' rows stay 0
    # (the kernels and their plain versions read no padding entry)
    L, ep = b["mp_lv_edge_id"].shape
    pack_lv = pack.new_zeros((L * ep, pack.shape[1])).index_copy(
        0, b[EDGE_POS], pack.index_select(0, b[EDGE_POS_ID])).view(L, ep, -1)
    return (pack_lv, b["mp_lv_edge_src"], b["mp_lv_edge_dst_slot"],
            b["mp_lv_edge_valid"].to(torch.int32), nodes_l,
            (b["mp_lv_node_valid"] & (e_nodes >= 0)).to(torch.int32),
            e_nodes.clamp(min=0).to(torch.int32),
            wkv_hf, ex["w_ih"], ex["b_ih"], ex["b_hh"], ex["wa_k"])


def sharded_forward_kernel(params, b: dict, cfg: DGConfig, num_levels: int, group):
    """(hs, hf) of the dst-complete route on a member's device batch
    (``member_slices(..., route="kernel")``), both whole on every member:
    the counterpart of ``_sharded_forward_pallas``
    (``mgvae_tpu/parallel/sharded.py:170``).

    The level statics (``dg_ae.level_statics``) are computed whole on every
    member; per real level the member calls ``level_step`` on the whole hf,
    its rows of the per-edge pack and its member tables, all-gathers the new
    rows, and writes hf[nodes_full] = where(upd_full, h_full, 0) in place
    (``level_step`` saves no hf). On the card that is kernel 5 forward and
    kernel 6 backward per real level and member, with the member's level
    lists built once per forward and the weights' expert-major copies once
    per step, as ``dg_ae.level_step_loop`` builds them. The pack is not
    padded to a TPU lane width. Every member's slots (``FULL_NODES``) and
    their update mask come from the batch, which every member holds, where
    the JAX function all-gathers them."""
    hs, expert = _sharded_hs(params, b, cfg, group)
    args = member_level_inputs(params, b, cfg, hs, expert)
    lists, packed = dg_ae.kernel_inputs(args)
    rows = lists and [type(lists)(*r) for r in zip(*(t[:, None].unbind(0) for t in lists))]
    nodes_full = b[FULL_NODES].long()
    upd_full = b[FULL_VALID] & (expert[nodes_full] >= 0)
    # the levels' pack rows as one unbind: its backward stacks their
    # cotangents once, where indexing per level would write a zero-filled
    # [L, Ep_m, D+2] cotangent and add it up for every level
    packs = args[0].unbind(0)
    hf = hs.new_zeros(hs.shape)
    for lv in range(num_levels):
        h_new = level_step(hf, packs[lv], *(a[lv] for a in args[1:4]), args[5][lv],
                           args[6][lv], *args[7:], lists=rows and rows[lv], packed=packed)
        h_full = all_gather(h_new, group)
        hf[nodes_full[lv]] = torch.where(upd_full[lv][:, None], h_full, 0.0)
    return hs, hf


FORWARDS = {"kernel": sharded_forward_kernel, "edge": sharded_forward_body}


def make_sharded_forward(cfg: DGConfig, group):
    """fn(params, batch) -> (hs, hf): the sharded forward on a host batch
    (``collate(mp=...)``, with ``shard_levels_by_dst`` tables for the
    dst-complete route; ``route_of`` picks it), run by every member of
    ``group``; hs and hf whole on each, on the params' device."""
    check_supported(cfg)

    def fn(params, batch):
        mp, m = dist.get_world_size(group), dist.get_rank(group)
        route = route_of(batch, cfg, mp)
        device = params["hs_linear"]["w"].device
        b = member_to_device(member_slices(batch, m, mp, route), device, route)
        with matmul_precision(cfg.matmul_precision):
            return FORWARDS[route](params, b, cfg, dg_ae.num_levels(batch), group)

    return fn


def make_sharded_train_step(cfg: DGConfig, optimizer: torch.optim.Optimizer, mesh):
    """train_step(params, state, batch, gen, weights, neg_edges=None,
    drop_keep=None) -> (state, metrics), ``train.step.make_train_step``'s
    step on a (dp, mp) ``mesh``: ``batch`` is this rank's dp shard, split
    across the mp members by ``member_slices`` for the route ``route_of``
    picks. The loss is the single-device step's (``losses_from_forward`` on
    the whole hs and hf), scaled by 1 / mp for the backward; then one
    all-reduce over the mesh of the gradients (divided by dp), the BN
    running state and the metrics (divided by dp * mp), and the optimizer
    step, the same on every rank. Draws come from ``gen`` folded by the dp
    rank (the members of a shard draw alike), or are passed in, per dp
    shard."""
    check_supported(cfg)
    dp, mp = mesh.dp, mesh.mp
    folded: dict = {}

    def train_step(params, state, batch, gen, weights, neg_edges=None, drop_keep=None):
        optimizer.zero_grad(set_to_none=True)
        route = route_of(batch, cfg, mp)
        device = params["hs_linear"]["w"].device
        b = member_to_device(member_slices(batch, mesh.mp_rank, mp, route), device, route)
        with matmul_precision(cfg.matmul_precision):
            hs, hf = FORWARDS[route](params, b, cfg, dg_ae.num_levels(batch), mesh.mp_group)
            total, (new_state, metrics) = losses_from_forward(
                params, state, b, hs, hf, fold_generator(gen, mesh.dp_rank, folded), weights,
                cfg, True, neg_edges=neg_edges, drop_keep=drop_keep)
            (total / mp).backward()
        grads = [t.grad for t in param_leaves(params) if t.grad is not None]
        rest = param_leaves(new_state) + [metrics[k] for k in sorted(metrics)]
        mean_([(grads, dp), (rest, dp * mp)], dist.group.WORLD)
        optimizer.step()
        return state | new_state, metrics

    return train_step
