"""DG_AE / DG_VAE / AE: the multi-gate auto-encoder's forward and its
decoder heads.

Counterpart of ``mgvae_tpu/models/dg_ae.py`` in fp32. The per-gate-type
attention aggregators and GRUs ("experts") are stacked along a T axis in
single [in, T*out] matrices, as in the JAX package, so one params tree
serves both packages.

The forward:
  1. ``struct_input`` and the two struct towers, the variational head when
     ``cfg.variational`` (DG_VAE: s = s_mu + exp(s_logstd) * eps, and
     likewise t; ``aux`` holds the four posterior tensors), then
     ``hs_linear`` -> hs (``encode_struct``). The towers are the recurrent
     multigcn ones (``--model DG_*``) or, with ``struct_encoder="gcn"``
     (``--model AE``), the 2-layer directed GCN of ``models/gcn``, fed
     ``x_feat`` on both sides; the gcn is plain torch, as in the JAX
     package. With s_rounds == t_rounds the multigcn towers run through
     ``ops.struct_kernel.struct_towers`` (the CUDA kernels on the card, an
     autograd Function when training), which reads the batch's blocked
     ``fa_src`` / ``ra_src`` tables.
  2. With ``num_rounds == 1``, ``level_statics``: everything the level
     recurrence needs that does not depend on hf (with one round, a node's
     hf is zero until its own level runs), packed per edge as
     [vhs | score_static | expert].
  3. The level recurrence over DAG depth (``level_recurrence``), by the
     route the batch's shapes select, as ``_level_scan_pallas`` does in the
     JAX package (``mgvae_tpu/models/dg_ae.py:600-620``). A plain batch
     (C == 1) that passes ``kernel_fits`` (N <= 8192, Ep and Np <= 512)
     takes the fused ``ops.level_kernel.level_scan``; one that fails it, a
     giant single graph or any large unchunked batch, takes
     ``ops.level_kernel.level_scan_giant``, which keeps no residuals and
     recomputes from hf in the backward, at any size (the JAX package leaves
     its kernels past two further size gates of the TPU's; the CUDA kernels
     have no such limit). A chunked batch takes the fused scan chunk by chunk
     where its chunks pass ``kernel_fits``; else ``level_scan_step``, one
     level at a time from an explicit hf, where they pass
     ``step_kernel_fits``; else the giant scan chunk by chunk. All are the
     CUDA kernels on the card and their plain versions on the CPU, and
     autograd differentiates all, so the forward trains (``train/step.py``).
     On the card the index lists that the kernels read
     (``ops.level_kernel.level_lists``) are built once per batch. Past the
     kernels' width (D > 128) every layout takes ``level_scan_fast``, plain
     torch on every device, and the struct towers their eager version, as
     the JAX package's width gates send such a model to its XLA paths.

Batches larger than one bucket come chunked (``data.batching.collate_chunked``
/ ``collate_fit``: [C, L] level tables with chunk-local node ids) or split
(``collate_split``: ``batch["groups"]``, each group a plain batch with its
own dims that runs the whole forward; hs and hf are concatenated in group
order, the layout the batch's top-level loss arrays index).

Past ``REMAT_STRUCT_NODES`` nodes the struct towers are rematerialised in the
backward (``DGConfig.remat_struct``, ``struct_towers``): their residuals
[2R, 2, N, 7D], the largest arrays of a giant graph's step, are then not held
from the forward through the level recurrence's backward; only the struct
backward holds them, beside one half-round of its own scratch. On an H100
that lowers a giant step's peak by 13% (depth 1000, ~513k nodes) for ~2%
more step time.

With ``num_rounds > 1`` steps 2 and 3 are ``level_loop`` instead, the JAX
package's general loop (``mgvae_tpu/models/dg_ae.py:339-396``): plain
torch on every device, since neither package has a kernel for it (the level
kernels assume hf == 0 before a node's own level).

Random draws of the variational head come from an explicit
``torch.Generator`` (``gen``) or are passed in (``vae_eps``).

The two precision modes of the JAX package (``mgvae_tpu/models/dg_ae.py:58``,
``:76-82``, ``:225``, ``:250-258``): ``forward_device`` runs under
``ops.precision.matmul_precision(cfg.matmul_precision)`` ("default": TF32
for PyTorch's fp32 products on the card, the JAX default; "highest": full
fp32, ``api.Model``'s parity mode), and with ``compute_dtype="bfloat16"``
the fp32 master params are cast to bf16 once per forward, so that the
activations, hs, hf and ``aux`` are bf16 and autograd carries the gradients
back to the fp32 leaves. The struct towers and every route of the level
recurrence (fused, step and giant) then run their bf16 kernels (bf16 values,
fp32 accumulation), each rounding where its JAX kernel rounds.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..data.graph import MODALITY_GATES, NUM_GATE_TYPES
from ..ops import level_kernel
from ..ops.gather import gather_rows
from ..ops.init import gru_cell_init, linear_apply, linear_init
from ..ops.level_kernel import (FLOAT_ARGS, kernel_fits, level_lists, level_scan,
                                level_scan_giant, level_step, repack_expert_major, select_expert)
from ..ops.mlp import mlp_init
from ..ops.precision import matmul_precision, uses_tf32
from ..ops.segment import segment_softmax, segment_sum
from ..utils.spans import OFF as OFF_SPANS
from .encoder import direct_multigcn_apply, direct_multigcn_init
from .gcn import directed_gcn_encoder_apply, directed_gcn_encoder_init


@dataclasses.dataclass(frozen=True)
class DGConfig:
    modality: str = "mig"
    dim_hidden: int = 64
    dim_feature: int = 6
    s_rounds: int = 4
    t_rounds: int = 4
    layernorm: bool = False
    num_rounds: int = 1
    input_quirk: bool = True
    variational: bool = False
    # Recompute the struct towers in the backward instead of keeping their
    # residuals [2R, 2, N, 7D] (3.3 GB at N = 114,688, D = 64, 4 rounds) from
    # the forward on. None: on when the batch has more than
    # REMAT_STRUCT_NODES nodes.
    remat_struct: bool | None = None
    dim_mlp: int = 32
    compute_dtype: str = "float32"
    # struct encoder: "multigcn" (--model DG_*, the recurrent towers) or
    # "gcn" (--model AE, the 2-layer directed GCN of models/gcn)
    struct_encoder: str = "multigcn"
    # mask sampled negatives that hit a real edge (train/losses.recon_loss)
    neg_collision_mask: bool = False
    # fp32 matmul mode of the forward and its backward (ops.precision):
    # "default" / "high" TF32 on the card, "highest" / "float32" full fp32
    matmul_precision: str = "default"

    @property
    def gate_types(self) -> tuple:
        return MODALITY_GATES[self.modality]

    @property
    def num_experts(self) -> int:
        return len(self.gate_types)

    def expert_of_gate(self, device) -> torch.Tensor:
        """[NUM_GATE_TYPES] expert id of each gate id, -1 for non-expert gates.
        Made once per gate set and device and kept: a table built from a
        Python list is a host-to-device copy, which a captured step
        (``train/step.make_multi_step``) may not make."""
        return _expert_table(self.gate_types, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _expert_table(gate_types: tuple, device: str) -> torch.Tensor:
    table = [-1] * NUM_GATE_TYPES
    for i, g in enumerate(gate_types):
        table[g] = i
    return torch.tensor(table, dtype=torch.int64, device=device)


# The node count past which ``remat_struct=None`` turns the remat on: the JAX
# package's threshold (``mgvae_tpu/models/dg_ae.py:304-313``), here a plain
# constant.
REMAT_STRUCT_NODES = 131_072
# the variational head's linears (D -> D), in their draw order
VAE_HEADS = ("fc_s_mu", "fc_s_logstd", "fc_t_mu", "fc_t_logstd")


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: DGConfig) -> None:
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {tuple(COMPUTE_DTYPES)}, "
                         f"got {cfg.compute_dtype!r}")
    uses_tf32(cfg.matmul_precision)   # raises on an unknown name


def compute_dtype(cfg: DGConfig) -> torch.dtype:
    return COMPUTE_DTYPES[cfg.compute_dtype]


def cast_params(params, cfg: DGConfig):
    """The params tree in the compute dtype (``mgvae_tpu/models/dg_ae.py:250-258``):
    floating leaves cast, differentiably, so that autograd carries their
    gradients back to the fp32 master leaves, which stay as they are."""
    dtype = compute_dtype(cfg)
    if dtype == torch.float32:
        return params

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cast(v) for v in tree)
        return tree.to(dtype) if tree.is_floating_point() else tree

    return cast(params)


def init_params(cfg: DGConfig, seed: int = 0, device="cuda"):
    """(params, state) with the JAX package's tree and shapes, drawn with
    torch's default init from ``torch.Generator().manual_seed(seed)`` on the
    CPU and moved to ``device``. The struct tree follows
    ``cfg.struct_encoder``; ``cfg.variational`` adds the posterior heads
    ``fc_{s,t}_{mu,logstd}`` (D -> D linears), drawn last. The params are
    fp32 whatever ``cfg.compute_dtype``: the master params, as in the JAX
    package."""
    check_supported(cfg)
    D = cfg.dim_hidden
    gen = torch.Generator().manual_seed(seed)
    if cfg.struct_encoder == "gcn":
        struct = directed_gcn_encoder_init(gen, cfg.dim_feature, D, D)
    else:
        struct = direct_multigcn_init(gen, D, cfg.dim_feature, cfg.layernorm)
    params = {
        "struct": struct,
        "hs_linear": linear_init(gen, 2 * D, D),
        "hs_decompose": linear_init(gen, D, 2 * D),
        "experts": _experts_init(gen, cfg),
    }
    # probability readout MLP (D -> dim_mlp -> dim_mlp -> 1, BatchNorm after
    # the hidden layers); read by the prob loss, not by the encode path
    params["readout_prob"], readout_state = mlp_init(gen, D, cfg.dim_mlp)
    if cfg.variational:
        for name in VAE_HEADS:
            params[name] = linear_init(gen, D, D)
    state = {"readout_prob": readout_state}
    return _to(params, device), _to(state, device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _experts_init(gen: torch.Generator, cfg: DGConfig) -> dict:
    """Per-gate-type attention + GRU params, stacked along a T axis: matmul
    weights concatenated to [in, T*out], biases and vectors as [T, out]."""
    D, T = cfg.dim_hidden, cfg.num_experts
    per = {k: [] for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wa_q", "wa_k", "ba",
                           "w_ih", "w_hh", "b_ih", "b_hh")}
    for _ in range(T):
        q = linear_init(gen, 2 * D, D)
        k = linear_init(gen, 2 * D, D)
        v = linear_init(gen, 2 * D, D)
        a = linear_init(gen, 2 * D, 1)  # attention Linear(2D, 1): query | key halves
        gru = gru_cell_init(gen, D, D)
        per["wq"].append(q["w"]); per["bq"].append(q["b"])
        per["wk"].append(k["w"]); per["bk"].append(k["b"])
        per["wv"].append(v["w"]); per["bv"].append(v["b"])
        per["wa_q"].append(a["w"][:D, 0]); per["wa_k"].append(a["w"][D:, 0])
        per["ba"].append(a["b"][0])
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            per[name].append(gru[name])
    cat = ("wq", "wk", "wv", "w_ih", "w_hh")
    return {k: (torch.cat(v, dim=1) if k in cat else torch.stack(v)) for k, v in per.items()}


def struct_input(gate: torch.Tensor, cfg: DGConfig) -> torch.Tensor:
    """Struct-encoder input features [N, dim_feature]. With ``input_quirk``
    the reference model's one_hot(x[:, 1]) of already one-hot features, i.e.
    one_hot(gate == 1); otherwise one_hot(gate). In the compute dtype."""
    ids = (gate == 1).long() if cfg.input_quirk else gate.long()
    return torch.nn.functional.one_hot(ids, cfg.dim_feature).to(compute_dtype(cfg))


# batch keys the encode path reads on the device
DEVICE_KEYS = ("gate", "edge_src", "edge_dst", "edge_valid", "deg_in", "deg_out",
               "fa_src", "ra_src", "lv_nodes", "lv_node_valid", "lv_edge_src",
               "lv_edge_dst_slot", "lv_edge_valid", "lv_edge_id")
# the ones the losses read (train/losses.py)
LOSS_KEYS = ("node_valid", "prob", "tt_pair_a", "tt_pair_b", "tt_valid", "tt_dis",
             "n_nodes", "n_edges", "n_tt")
# and the valid-node runs of a chunked or split batch, for the negatives
RUN_KEYS = ("chunk_counts", "chunk_offsets")


def device_layout(batch: dict) -> list:
    """The host batch's arrays that the encode path and the losses read, as
    (group, key) pairs: group None for a top-level array, g for the g-th
    group of a split batch (which keeps its loss arrays at the top)."""
    runs = tuple(k for k in RUN_KEYS if k in batch)
    if "groups" in batch:
        return ([(None, k) for k in ("edge_src", "edge_dst", "edge_valid") + LOSS_KEYS + runs]
                + [(g, k) for g in range(len(batch["groups"])) for k in DEVICE_KEYS])
    return [(None, k) for k in DEVICE_KEYS + LOSS_KEYS + runs]


def _source(batch: dict, group, key: str):
    return batch[key] if group is None else batch["groups"][group][key]


def _nest(batch: dict, tensors: dict) -> dict:
    """{(group, key): tensor} as a device batch: the top-level arrays, and
    for a split batch ``"groups"``, a tuple of the groups' arrays."""
    out = {k: t for (g, k), t in tensors.items() if g is None}
    if "groups" in batch:
        out["groups"] = tuple({k: t for (h, k), t in tensors.items() if h == g}
                              for g in range(len(batch["groups"])))
    return out


def batch_to_device(batch: dict, device) -> dict:
    """The host batch's arrays that the encode path and the losses read, as
    tensors on ``device`` (numpy dtypes kept: int32 indices, bool masks, f32
    values; the counts become 0-d int32 tensors). A split batch keeps its
    loss arrays at the top and gets ``"groups"``: a tuple of the groups'
    encode arrays."""
    return _nest(batch, {
        (g, k): torch.as_tensor(np.asarray(_source(batch, g, k))).to(device, non_blocking=True)
        for g, k in device_layout(batch)})


# byte alignment of each array in a StaticBatch's buffer
STATIC_ALIGN = 256


class StaticBatch:
    """Device buffers that hold one step's batch at fixed addresses, for a
    captured step (``train/step.make_multi_step``), which reads its inputs
    where the capture found them: the arrays of ``batch_to_device``, as
    views of one byte buffer, ``views``.

    A group of K steps of this layout (a host batch with a leading step
    axis, as ``data.batching.collate_shards`` stacks it) is first written
    into a host staging area on the caller's thread, one numpy copy per
    array (``stage``); each step then reaches the device buffer with ONE
    copy of its row (``load``), enqueued on the current stream outside
    any graph. On the card the staging area is pinned and double-buffered:
    a group is staged into the area the previous group did not use, after
    the copies out of it have completed (an event recorded after them),
    so that a fill never races an in-flight copy."""

    def __init__(self, batch: dict, device):
        self.device = torch.device(device)
        self.layout = []          # (group, key, shape, numpy dtype, byte offset, bytes)
        at = 0
        for g, k in device_layout(batch):
            a = np.asarray(_source(batch, g, k))
            self.layout.append((g, k, a.shape, a.dtype, at, a.nbytes))
            at += -(-max(a.nbytes, 1) // STATIC_ALIGN) * STATIC_ALIGN
        self.nbytes = at
        self.buffer = torch.empty((at,), dtype=torch.uint8, device=self.device)
        self.views = _nest(batch, {
            (g, k): self.buffer[off:off + n].view(torch.from_numpy(np.empty(0, dt)).dtype)
            .view(shape) for g, k, shape, dt, off, n in self.layout})
        self._areas = [None, None]   # staging areas [K, nbytes] and their last copies' events
        self._turn = 0

    @staticmethod
    def signature(batch: dict) -> tuple:
        """What a layout is: every device array's place, shape and dtype."""
        return tuple((g, k, np.shape(a), np.asarray(a).dtype.str)
                     for g, k in device_layout(batch) for a in [_source(batch, g, k)])

    def stage(self, sbatch: dict, steps: int, spans=OFF_SPANS) -> torch.Tensor:
        """The K = ``steps`` rows of the stacked batch ``sbatch`` in a host
        staging area [K, nbytes] (pinned on the card); returns it. Call
        ``staged_loaded`` once the rows' loads are enqueued. ``spans`` (the
        trainer's, ``utils/spans``) times the wait for the area's last
        copies as ``kstep.stage_wait``."""
        turn = self._turn
        self._turn = 1 - turn
        area, done = self._areas[turn] or (None, None)
        with spans("kstep.stage_wait"):
            if done is not None:
                done.synchronize()
        if area is None or area.shape[0] < steps:
            area = torch.empty((steps, self.nbytes), dtype=torch.uint8,
                               pin_memory=self.device.type == "cuda")
        host = area.numpy()
        for g, k, shape, dt, off, n in self.layout:
            a = np.ascontiguousarray(_source(sbatch, g, k), dtype=dt)
            if a.shape != (steps,) + shape:
                raise ValueError(f"stage: {k} of group {g} is {a.shape}, this layout holds "
                                 f"{(steps,) + shape}")
            host[:steps, off:off + n] = a.reshape(steps, -1).view(np.uint8)
        self._areas[turn] = (area, None)
        return area[:steps]

    def load(self, row: torch.Tensor) -> None:
        """One staged step into the device buffer: one copy, on the current
        stream."""
        self.buffer.copy_(row, non_blocking=self.device.type == "cuda")

    def staged_loaded(self) -> None:
        """The last staged area's loads are enqueued on the current stream:
        its next ``stage`` waits until they have run."""
        turn = 1 - self._turn
        if self.device.type == "cuda" and self._areas[turn] is not None:
            done = torch.cuda.Event()
            done.record()
            self._areas[turn] = (self._areas[turn][0], done)


def num_levels(batch: dict) -> int:
    """Real level count of a host batch (update levels are 1..max level):
    the deepest chunk's or group's, for a chunked or split batch."""
    return int(np.max(batch["forward_level"]))


def table_levels(batch: dict) -> tuple:
    """The level counts that walk every row of a batch's level tables,
    padding levels included, in ``level_counts``' structure: the padded L
    for each chunk, or for a split batch one such tuple per group. Shapes
    alone fix them, so a captured step bakes them in for every batch of its
    layout; a padding level has no valid slot and changes nothing (the JAX
    kernels walk them all too, ``grid=(L,)``). Host or device batch."""
    if "groups" in batch:
        return tuple(table_levels(g) for g in batch["groups"])
    shape = tuple(batch["lv_nodes"].shape)
    return (shape[-2],) * (shape[0] if len(shape) == 3 else 1)


def level_counts(batch: dict) -> tuple:
    """Real level counts of a host batch, read on the host: one int per
    chunk (a plain batch is one chunk), or for a split batch one such tuple
    per group."""
    if "groups" in batch:
        return tuple(level_counts(g) for g in batch["groups"])
    lv = np.asarray(batch["lv_nodes"])
    chunks = lv.shape[0] if lv.ndim == 3 else 1
    deepest = np.asarray(batch["forward_level"]).reshape(chunks, -1).max(axis=1)
    return tuple(int(x) for x in deepest)


def remat_struct(cfg: DGConfig, num_nodes: int) -> bool:
    """Whether the struct towers of a batch of ``num_nodes`` (padded) nodes
    are rematerialised in the backward."""
    if cfg.remat_struct is None:
        return num_nodes > REMAT_STRUCT_NODES
    return cfg.remat_struct


def struct_towers(params, b: dict, cfg: DGConfig):
    """(s, t) [N, D] of the struct encoder on a device batch. The multigcn
    towers run under ``torch.utils.checkpoint`` with ``remat_struct`` and
    grad enabled: the backward runs them a second time, in place of keeping
    their residuals. The struct kernels sum in a fixed order, so the second
    run equals the first bit for bit. The gcn encoder (``struct_encoder ==
    "gcn"``) reads ``x_feat`` on both sides and never the struct kernels."""
    x_feat = struct_input(b["gate"], cfg)
    if cfg.struct_encoder == "gcn":
        return directed_gcn_encoder_apply(params["struct"], x_feat, x_feat, b["edge_src"],
                                          b["edge_dst"], b["edge_valid"])

    def towers(struct_params):
        return direct_multigcn_apply(struct_params, x_feat, b, cfg.s_rounds, cfg.t_rounds,
                                     cfg.layernorm)

    if remat_struct(cfg, x_feat.shape[0]) and torch.is_grad_enabled():
        # the towers draw nothing: no RNG state to stash and restore (reading
        # the CUDA generators' state is not allowed inside a captured step)
        return checkpoint(towers, params["struct"], use_reentrant=False,
                          preserve_rng_state=False)
    return towers(params["struct"])


def variational_head(params, s, t, eps) -> tuple:
    """DG_VAE's reparametrisation (``mgvae_tpu/models/dg_ae.py:316-325``):
    returns (s, t, aux) with s = s_mu + exp(s_logstd) * eps[0], likewise t,
    and aux the four posterior tensors. The noise is taken in the
    activations' dtype, as the JAX package draws it."""
    aux = {name[3:]: linear_apply(params[name], x)
           for name, x in zip(VAE_HEADS, (s, s, t, t))}
    s = aux["s_mu"] + torch.exp(aux["s_logstd"]) * eps[0].to(s.dtype)
    t = aux["t_mu"] + torch.exp(aux["t_logstd"]) * eps[1].to(t.dtype)
    return s, t, aux


def encode_struct(params, b: dict, cfg: DGConfig, gen=None, vae_eps=None):
    """(hs [N, D], aux) of a device batch: the struct towers, the
    variational head when ``cfg.variational`` (outside the towers'
    checkpoint, so that a recompute draws nothing), then ``hs_linear``.
    ``vae_eps``: explicit (eps_s, eps_t) [N, D]; else two standard normal
    draws from ``gen``, on the generator's device."""
    s, t = struct_towers(params, b, cfg)
    aux = {}
    if cfg.variational:
        if vae_eps is None:
            if gen is None:
                raise ValueError("the variational forward needs a generator or vae_eps")
            vae_eps = [torch.randn(s.shape, generator=gen, device=gen.device).to(s.device)
                       for _ in range(2)]
        s, t, aux = variational_head(params, s, t, vae_eps)
    return linear_apply(params["hs_linear"], torch.cat([s, t], dim=-1)), aux


def struct_hs(params, b: dict, cfg: DGConfig) -> torch.Tensor:
    """hs [N, D] of a device batch (``encode_struct`` without ``aux``)."""
    return encode_struct(params, b, cfg)[0]


def level_statics(params, b: dict, cfg: DGConfig, hs: torch.Tensor, expert: torch.Tensor):
    """Per-edge statics pack [E, D+2] = [vhs | score_static | expert] and the
    hf-side key/value weights wkv_hf [D, 2TD]. An edge's expert is its
    DESTINATION's.

    The row gathers whose indices repeat in long runs go through
    ``ops.gather.gather_rows``, whose backward sums each run across the
    card: the experts' T-row tables (by each node's and each edge's
    expert), and hs and aq_n by the edge lists, whose padding edges all
    name the dump node; ``ba`` (width 1) shares bq's index."""
    D, T = cfg.dim_hidden, cfg.num_experts
    ex = params["experts"]
    src, dst = b["edge_src"], b["edge_dst"]
    e_dst = expert[dst].clamp(min=0)                        # [E]
    # per-node query score: q depends on [hs, hf = 0] only
    e_node = expert.clamp(min=0)
    bq, wa_q, ba = gather_rows(e_node, ex["bq"], ex["wa_q"], ex["ba"])
    q = select_expert(hs @ ex["wq"][:D], e_node, T) + bq
    aq_n = (q * wa_q).sum(-1) + ba                              # [N]
    # per-edge hs-side key/value
    wkv_hs = torch.cat([ex["wk"][:D], ex["wv"][:D]], dim=1)     # [D, 2TD]
    kv_hs = gather_rows(src, hs)[0] @ wkv_hs                    # [E, 2TD]
    bk, bv, wa_k = gather_rows(e_dst, ex["bk"], ex["bv"], ex["wa_k"])
    khs = select_expert(kv_hs[:, : T * D], e_dst, T) + bk
    vhs = select_expert(kv_hs[:, T * D :], e_dst, T) + bv
    score_static = (khs * wa_k).sum(-1) + gather_rows(dst, aq_n)[0]
    pack = torch.cat([vhs, score_static[:, None], e_dst[:, None].to(hs.dtype)], dim=1)
    wkv_hf = torch.cat([ex["wk"][D:], ex["wv"][D:]], dim=1)     # [D, 2TD]
    return pack, wkv_hf


LV_KEYS = ("lv_nodes", "lv_node_valid", "lv_edge_src", "lv_edge_dst_slot",
           "lv_edge_valid", "lv_edge_id")


def lv_views(b: dict):
    """Level tables as flat [C * L, ...] rows, each row's offset of its
    chunk-local node ids into the global node space [C * L], and C.

    A chunked batch carries a leading [C, L] axis with local node ids; chunk
    k's nodes live at global rows [k * N_sub, (k + 1) * N_sub). A plain batch
    is the C == 1 case (offset 0)."""
    lv_nodes = b["lv_nodes"]
    if lv_nodes.dim() == 2:
        return {k: b[k] for k in LV_KEYS}, lv_nodes.new_zeros(lv_nodes.shape[0]), 1
    C, L = lv_nodes.shape[:2]
    n_sub = b["gate"].shape[0] // C
    tabs = {k: b[k].reshape((C * L,) + b[k].shape[2:]) for k in LV_KEYS}
    off = (torch.arange(C, dtype=lv_nodes.dtype, device=lv_nodes.device) * n_sub)
    return tabs, off.repeat_interleave(L), C


def level_scan_inputs(params, b: dict, cfg: DGConfig, hs: torch.Tensor) -> tuple:
    """The 12 tensor arguments of ``level_scan`` for a device batch; for a
    chunked batch the tables are its flat [C * L, ...] rows with chunk-local
    node ids (chunk k's are rows [k * L, (k + 1) * L))."""
    ex = params["experts"]
    expert = cfg.expert_of_gate(hs.device)[b["gate"].long()]   # [N], -1: no expert
    pack, wkv_hf = level_statics(params, b, cfg, hs, expert)
    tabs, off, _ = lv_views(b)
    # every padding slot of the tables names edge E - 1
    (pack_lv,) = gather_rows(tabs["lv_edge_id"].long(), pack)  # [C*L, Ep, D+2]
    lv_nodes = tabs["lv_nodes"]
    e_nodes = expert[(lv_nodes + off[:, None]).long()]
    lv_upd = (tabs["lv_node_valid"] & (e_nodes >= 0)).to(torch.int32)
    lv_e_n = e_nodes.clamp(min=0).to(torch.int32)
    return (pack_lv, tabs["lv_edge_src"], tabs["lv_edge_dst_slot"],
            tabs["lv_edge_valid"].to(torch.int32), lv_nodes, lv_upd, lv_e_n,
            wkv_hf, ex["w_ih"], ex["b_ih"], ex["b_hh"], ex["wa_k"])


def step_kernel_fits(n_sub: int, ep: int, np_: int, dim: int) -> bool:
    """The JAX package's size gate of its single-level step kernel
    (``mgvae_tpu/models/dg_ae.py:623``): shape arithmetic, kept so that both
    packages route a batch the same way."""
    return n_sub <= 65536 and ep <= 2048 and np_ <= 2048 and dim <= 128


def level_recurrence(args: tuple, num_nodes: int, n_levels: tuple) -> torch.Tensor:
    """hf [num_nodes, D] from ``level_scan_inputs``' arguments and the real
    level count of each chunk, by the route the shapes select, for
    ``num_rounds == 1`` (``forward_device`` takes ``level_loop`` for
    ``num_rounds > 1``, where neither package has a kernel). Where the JAX
    package's ``_level_scan_pallas`` (``mgvae_tpu/models/dg_ae.py:600-620``)
    takes a kernel, this takes that kernel's counterpart; where it falls
    back to its XLA scan past a size gate of the TPU's, this takes the giant
    scan, whose working memory does not grow with L * Ep and whose hf equals
    the fused scan's bit for bit:

      * one chunk that passes ``kernel_fits``: the fused scan
        (``dg_ae.py:600-602``);
      * one chunk that fails it: the giant scan ``level_scan_giant``
        (``dg_ae.py:605-610``), at any size;
      * C chunks that pass ``kernel_fits``: the fused scan per chunk (they
        are independent sub-batches with chunk-local ids) on its own rows of
        the tables and its own real levels, concatenated;
      * C chunks that fail it and pass ``step_kernel_fits``:
        ``level_scan_step``;
      * C chunks that fail both: the giant scan per chunk.

    bf16 values take the same routes as fp32. In the last case the port
    differs from the JAX package, which runs its XLA scan there
    (``dg_ae.py:621``): the giant scan's bf16 rounding points are those of
    the JAX giant kernels, not of that scan, so such a batch agrees with
    JAX within the JAX package's bf16 bounds, not to an ulp.

    Past the kernels' width (D > ``level_kernel.MAX_DIM``, 128) every layout
    takes ``level_scan_fast`` on every device, before any kernel or list is
    built: each of the JAX package's kernel gates caps D at 128, and past
    them it runs its XLA scan ``_level_scan_fast``
    (``mgvae_tpu/models/dg_ae.py:621``).

    On the card the tables' index lists and the weights' expert-major copies
    are built here, once for all chunks and levels, and handed to every call
    (``kernel_inputs``).
    """
    C = len(n_levels)
    pack_lv, lv_nodes = args[0], args[4]
    n_sub, L = num_nodes // C, pack_lv.shape[0] // C
    ep, np_, D = pack_lv.shape[1], lv_nodes.shape[1], pack_lv.shape[2] - 2
    if D > level_kernel.MAX_DIM:
        return level_scan_fast(args, num_nodes, n_levels)
    fits = kernel_fits(n_sub, ep, np_, D)
    lists, packed = kernel_inputs(args)
    if C == 1:
        scan = level_scan if fits else level_scan_giant
        return scan(*args, num_nodes=num_nodes, num_levels=n_levels[0], lists=lists,
                    packed=packed)
    if not fits and step_kernel_fits(n_sub, ep, np_, D):
        return level_scan_step(args, n_levels, n_sub, lists, packed)
    scan = level_scan if fits else level_scan_giant
    return torch.cat([
        scan(*(t[k * L : (k + 1) * L] for t in args[:7]), *args[7:], num_nodes=n_sub,
             num_levels=n_levels[k], lists=lists and lists.rows(k * L, (k + 1) * L),
             packed=packed)
        for k in range(C)])


def level_scan_fast(args: tuple, num_nodes: int, n_levels: tuple) -> torch.Tensor:
    """hf [num_nodes, D] from ``level_scan_inputs``' arguments in plain
    torch, differentiable by autograd: the JAX package's XLA scan for
    ``num_rounds == 1`` (``_level_scan_fast``, ``mgvae_tpu/models/dg_ae.py:470-556``),
    the route of every layout past the kernels' width. Per real (chunk,
    level) row: one gather of hf at the edges' sources, the [Ep, D] x
    [D, 2TD] product with the hf-side key and value weights, the masked
    segment softmax (scores masked before the exp), the message sum, and
    the GRU with h = 0 (its hidden side is b_hh alone); the new rows are
    written out of place, 0 where a slot is not updated. In bf16 every
    operation rounds to bf16 as it does in that scan, which runs wholly in
    the compute dtype; the weights enter each level as bf16 casts of fp32
    copies, so that their cotangents are summed over rows and levels in
    fp32 (in fp32 the casts are no-ops). The JAX scan also walks the
    padding levels, which write zeros to the dump rows and change
    nothing."""
    (pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n, *weights) = args
    C = len(n_levels)
    n_sub, L = num_nodes // C, pack_lv.shape[0] // C
    D, T, dt = pack_lv.shape[2] - 2, weights[-1].shape[0], pack_lv.dtype
    wkv_hf, w_ih, b_ih, b_hh, wa_k = (w.float() for w in weights)
    hf = pack_lv.new_zeros((num_nodes, D))
    for k in range(C):
        for row in range(k * L, k * L + n_levels[k]):
            pk, off = pack_lv[row], k * n_sub
            src, dslot = lv_src[row].long() + off, lv_dslot[row].long()
            nodes, e_n = lv_nodes[row].long() + off, lv_e_n[row].long()
            e_edge = pk[:, -1].long()
            kv_hf = hf[src] @ wkv_hf.to(dt)                          # [Ep, 2TD]
            khf = select_expert(kv_hf[:, : T * D], e_edge, T)
            vhf = select_expert(kv_hf[:, T * D :], e_edge, T)
            score = pk[:, D] + (khf * wa_k[e_edge].to(dt)).sum(-1)
            v = pk[:, :D] + vhf
            np_ = nodes.shape[0]
            attn = segment_softmax(score, dslot, np_, valid=lv_evalid[row] > 0)
            msg = segment_sum(v * attn[:, None], dslot, np_)
            gi = select_expert(msg @ w_ih.to(dt), e_n, T) + b_ih[e_n].to(dt)
            i_r, i_z, i_n = gi.chunk(3, dim=-1)
            h_r, h_z, h_n = b_hh[e_n].to(dt).chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            h_new = (1.0 - z) * torch.tanh(i_n + r * h_n)
            hf = hf.index_copy(0, nodes, torch.where(lv_upd[row][:, None] > 0, h_new, 0.0))
    return hf


def level_loop(params, b: dict, cfg: DGConfig, hs: torch.Tensor, n_levels: tuple) -> torch.Tensor:
    """The general level recurrence, ``num_rounds`` passes over the real
    (chunk, level) rows with hf carried across passes: the JAX package's
    loop for ``num_rounds > 1`` (``mgvae_tpu/models/dg_ae.py:339-396``), as
    plain torch. Per level: the query from [hs, hf] of the level's nodes,
    keys and values from [hs, hf] of its edges' sources, the masked segment
    softmax, the GRU with ``w_hh @ hf`` and both biases, and hf written out
    of place (``index_copy``) where a node has an expert, its old row
    elsewhere (the padding slots all point at the chunk's dump row and write
    it unchanged). The JAX loop also walks the padding levels, which change
    nothing."""
    D, T = cfg.dim_hidden, cfg.num_experts
    ex = params["experts"]
    expert = cfg.expert_of_gate(hs.device)[b["gate"].long()]     # [N], -1: no expert
    tabs, off, C = lv_views(b)
    L = tabs["lv_nodes"].shape[0] // C
    nodes_all = (tabs["lv_nodes"] + off[:, None]).long()
    src_all = (tabs["lv_edge_src"] + off[:, None]).long()
    dslot_all = tabs["lv_edge_dst_slot"].long()
    upd_all = tabs["lv_node_valid"] & (expert[nodes_all] >= 0)
    e_all = expert[nodes_all].clamp(min=0)
    wkv = torch.cat([ex["wk"], ex["wv"]], dim=1)                  # [2D, 2TD]
    rows = [k * L + lv for k in range(C) for lv in range(n_levels[k])]
    hf = torch.zeros_like(hs)
    for _ in range(cfg.num_rounds):
        for row in rows:
            nodes, e_n, dslot = nodes_all[row], e_all[row], dslot_all[row]
            src, evalid = src_all[row], tabs["lv_edge_valid"][row]
            hf_dst = hf[nodes]
            q = (select_expert(torch.cat([hs[nodes], hf_dst], dim=1) @ ex["wq"], e_n, T)
                 + ex["bq"][e_n])
            aq = (q * ex["wa_q"][e_n]).sum(-1) + ex["ba"][e_n]
            e_edge = e_n[dslot]
            kv = torch.cat([hs[src], hf[src]], dim=1) @ wkv
            k = select_expert(kv[:, : T * D], e_edge, T) + ex["bk"][e_edge]
            v = select_expert(kv[:, T * D :], e_edge, T) + ex["bv"][e_edge]
            score = aq[dslot] + (k * ex["wa_k"][e_edge]).sum(-1)
            np_ = nodes.shape[0]
            attn = segment_softmax(score, dslot, np_, valid=evalid)
            msg = segment_sum(v * attn[:, None], dslot, np_)
            gi = select_expert(msg @ ex["w_ih"], e_n, T) + ex["b_ih"][e_n]
            gh = select_expert(hf_dst @ ex["w_hh"], e_n, T) + ex["b_hh"][e_n]
            i_r, i_z, i_n = gi.chunk(3, dim=-1)
            h_r, h_z, h_n = gh.chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            h_new = (1.0 - z) * torch.tanh(i_n + r * h_n) + z * hf_dst
            hf = hf.index_copy(0, nodes, torch.where(upd_all[row][:, None], h_new, hf_dst))
    return hf


def kernel_inputs(args: tuple) -> tuple:
    """(lists, packed) of ``level_scan_inputs``' arguments on the card, where
    the kernels read them: the tables' index lists, all chunks' and levels'
    at once, and the weights' expert-major copies (with the transposed ones
    when a gradient will be asked for). (None, None) on the CPU, where the
    plain versions read the tables and the weights themselves."""
    if not args[0].is_cuda:
        return None, None
    T = args[11].shape[0]
    training = torch.is_grad_enabled() and any(args[i].requires_grad for i in FLOAT_ARGS)
    return (level_lists(args[1], args[2], args[3], args[5], args[6], T),
            repack_expert_major(args[7], args[8], T, backward=training))


def level_scan_step(args: tuple, n_levels: tuple, n_sub: int, lists=None,
                    packed=None) -> torch.Tensor:
    """The level recurrence of a chunked batch one level at a time from an
    explicit hf (``mgvae_tpu/models/dg_ae.py:629-652``, which scans the
    padding levels too; they write zeros to the dump rows, so skipping them
    changes nothing). On the card ``ops.level_kernel.level_scan_step``: one
    launch per level index for all chunks, the new rows scattered into hf
    inside the kernel, and as one autograd Function for training; on the
    CPU the same function with both plain versions, so that the CPU rounds
    where the kernels do. ``lists``, ``packed``: ``kernel_inputs(args)``,
    built where the caller has none."""
    return level_kernel.level_scan_step(*args, n_levels=n_levels, n_sub=n_sub, lists=lists,
                                        packed=packed)


def level_step_loop(args: tuple, n_levels: tuple, n_sub: int, lists=None,
                    packed=None) -> torch.Tensor:
    """The step route as one ``level_step`` per real (chunk, level) row, each
    on its chunk's rows of hf, with the scatter hf[nodes + off] =
    where(upd, h_new, 0) in plain torch between the calls: the route's plain
    structure, which ``level_scan_step`` equals (on the card it runs the
    single-level kernels, a call per row). hf is written in place:
    ``level_step`` saves none of it."""
    (pack_lv, lv_src, lv_dslot, lv_evalid, lv_nodes, lv_upd, lv_e_n, *weights) = args
    C = len(n_levels)
    L, D = pack_lv.shape[0] // C, pack_lv.shape[2] - 2
    if lists is None:
        lists, packed = kernel_inputs(args)
    hf = pack_lv.new_zeros((C * n_sub, D))
    # each level's row of the lists as its own [1, ...] view, all rows in one go
    rows = lists and [type(lists)(*r) for r in zip(*(t[:, None].unbind(0) for t in lists))]
    for k in range(C):
        nodes_g = lv_nodes[k * L : (k + 1) * L].long() + k * n_sub
        for lv in range(n_levels[k]):
            row = k * L + lv
            h_new = level_step(hf.narrow(0, k * n_sub, n_sub), pack_lv[row], lv_src[row],
                               lv_dslot[row], lv_evalid[row], lv_upd[row], lv_e_n[row],
                               *weights, lists=rows and rows[row], packed=packed)
            hf[nodes_g[lv]] = torch.where(lv_upd[row][:, None] > 0, h_new, 0.0)
    return hf


def forward(params, batch: dict, cfg: DGConfig, gen=None, vae_eps=None):
    """Model forward on a host batch (``data.batching.collate``,
    ``collate_chunked`` / ``collate_fit`` or ``collate_split``); returns
    (hs, hf, aux) on the params' device, rows in the batch's own order
    (level-major per chunk or group; ``batch["node_inv"]`` maps input order
    to it). ``aux`` holds the posterior tensors s_mu, s_logstd, t_mu,
    t_logstd [N, D] when ``cfg.variational``, rows as hs's, and is empty
    otherwise. The variational draws: ``vae_eps`` (eps_s, eps_t) [N, D] in
    the same rows, or from ``gen``. Differentiable with respect to the
    params; ``api.Model`` runs it under ``inference_mode``."""
    device = params["hs_linear"]["w"].device
    return forward_device(params, batch_to_device(batch, device), cfg, level_counts(batch),
                          gen=gen, vae_eps=vae_eps)


def forward_device(params, b: dict, cfg: DGConfig, n_levels, gen=None, vae_eps=None):
    """``forward`` on a batch already on the device (``batch_to_device``),
    with its real level counts (``level_counts``; an int will do for a plain
    batch). Level counts come from the host so that no launch waits for the
    device. Runs under ``cfg.matmul_precision``, with the params cast to
    ``cfg.compute_dtype`` (once, for all groups of a split batch)."""
    check_supported(cfg)
    with matmul_precision(cfg.matmul_precision):
        params = cast_params(params, cfg)
        if "groups" in b:
            return forward_split(params, b, cfg, n_levels, gen, vae_eps)
        return _forward_plain(params, b, cfg, n_levels, gen, vae_eps)


def _forward_plain(params, b: dict, cfg: DGConfig, n_levels, gen=None, vae_eps=None):
    """``forward_device`` of a plain or chunked batch, params already cast."""
    if isinstance(n_levels, int):
        n_levels = (n_levels,)
    hs, aux = encode_struct(params, b, cfg, gen, vae_eps)
    if cfg.num_rounds > 1:
        # plain torch on every device: the level kernels of both packages
        # assume hf == 0 before a node's own level (the GRU's hidden side is
        # b_hh alone), and the JAX package runs this loop as plain XLA
        return hs, level_loop(params, b, cfg, hs, tuple(n_levels)), aux
    hf = level_recurrence(level_scan_inputs(params, b, cfg, hs), hs.shape[0], tuple(n_levels))
    return hs, hf, aux


def forward_split(params, b: dict, cfg: DGConfig, n_levels, gen=None, vae_eps=None):
    """A split batch: each group runs the whole forward at its own padded
    dims, drawing its variational noise in group order (or reading its rows
    of ``vae_eps``); hs, hf and aux are concatenated in group order."""
    sizes = [g["gate"].shape[0] for g in b["groups"]]
    eps = (zip(*(e.split(sizes) for e in vae_eps)) if vae_eps is not None
           else [None] * len(sizes))
    outs = [_forward_plain(params, g, cfg, n, gen, e)
            for g, n, e in zip(b["groups"], n_levels, eps, strict=True)]
    aux = {k: torch.cat([o[2][k] for o in outs]) for k in outs[0][2]}
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]), aux


def hs_decompose(params, hs: torch.Tensor):
    """hs -> (s, t) for the directed inner-product decoder."""
    st = linear_apply(params["hs_decompose"], hs)
    return st.chunk(2, dim=-1)


def decode_edges(s, t, src, dst, sigmoid: bool = True):
    """Directed inner-product decoder: sigmoid(s[src] . t[dst]), or the
    logits."""
    logits = (s[src.long()] * t[dst.long()]).sum(-1)
    return torch.sigmoid(logits) if sigmoid else logits
