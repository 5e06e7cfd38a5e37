"""DG_AE: the multi-gate auto-encoder's forward and its decoder heads.

Counterpart of ``mgvae_tpu/models/dg_ae.py`` for ``num_rounds == 1`` in
fp32. The per-gate-type attention aggregators and GRUs ("experts") are
stacked along a T axis in single [in, T*out] matrices, as in the JAX
package, so one params tree serves both packages.

The forward:
  1. ``struct_input`` and the two struct towers, then ``hs_linear`` -> hs.
  2. ``level_statics``: everything the level recurrence needs that does not
     depend on hf (with one round, a node's hf is zero until its own level
     runs), packed per edge as [vhs | score_static | expert].
  3. The level recurrence over DAG depth: ``ops.level_kernel.level_scan``
     (the CUDA kernels on the card, the plain version on the CPU), which
     autograd differentiates, so the forward trains (``train/step.py``).

Parity mode is full fp32: set ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False on the card (``api.Model``
does so).

Not ported yet, and raising ``NotImplementedError``: ``variational``,
``num_rounds > 1``, ``compute_dtype="bfloat16"``, chunked ([C, L] level
tables) and split batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.graph import MODALITY_GATES, NUM_GATE_TYPES
from ..ops.init import gru_cell_init, linear_apply, linear_init
from ..ops.level_kernel import level_scan, select_expert
from ..ops.mlp import mlp_init
from .encoder import direct_multigcn_apply, direct_multigcn_init


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
    dim_mlp: int = 32
    compute_dtype: str = "float32"
    # mask sampled negatives that hit a real edge (train/losses.recon_loss)
    neg_collision_mask: bool = False

    @property
    def gate_types(self) -> tuple:
        return MODALITY_GATES[self.modality]

    @property
    def num_experts(self) -> int:
        return len(self.gate_types)

    def expert_of_gate(self, device) -> torch.Tensor:
        """[NUM_GATE_TYPES] expert id of each gate id, -1 for non-expert gates."""
        table = [-1] * NUM_GATE_TYPES
        for i, g in enumerate(self.gate_types):
            table[g] = i
        return torch.tensor(table, dtype=torch.int64, device=device)


def check_supported(cfg: DGConfig) -> None:
    if cfg.variational:
        raise NotImplementedError("variational=True is not ported yet")
    if cfg.num_rounds != 1:
        raise NotImplementedError("num_rounds > 1 is not ported yet")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(f"compute_dtype={cfg.compute_dtype!r}: only float32 is ported")


def init_params(cfg: DGConfig, seed: int = 0, device="cpu"):
    """(params, state) with the JAX package's tree and shapes, drawn with
    torch's default init from ``torch.Generator().manual_seed(seed)``."""
    check_supported(cfg)
    D = cfg.dim_hidden
    gen = torch.Generator().manual_seed(seed)
    params = {
        "struct": direct_multigcn_init(gen, D, cfg.dim_feature, cfg.layernorm),
        "hs_linear": linear_init(gen, 2 * D, D),
        "hs_decompose": linear_init(gen, D, 2 * D),
        "experts": _experts_init(gen, cfg),
    }
    # probability readout MLP (D -> dim_mlp -> dim_mlp -> 1, BatchNorm after
    # the hidden layers); read by the prob loss, not by the encode path
    params["readout_prob"], readout_state = mlp_init(gen, D, cfg.dim_mlp)
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
    one_hot(gate == 1); otherwise one_hot(gate)."""
    ids = (gate == 1).long() if cfg.input_quirk else gate.long()
    return torch.nn.functional.one_hot(ids, cfg.dim_feature).to(torch.float32)


# batch keys the encode path reads on the device
DEVICE_KEYS = ("gate", "edge_src", "edge_dst", "edge_valid", "deg_in", "deg_out",
               "lv_nodes", "lv_node_valid", "lv_edge_src", "lv_edge_dst_slot",
               "lv_edge_valid", "lv_edge_id")
# and the ones the losses read (train/losses.py)
LOSS_KEYS = ("node_valid", "prob", "tt_pair_a", "tt_pair_b", "tt_valid", "tt_dis",
             "n_nodes", "n_edges", "n_tt")


def batch_to_device(batch: dict, device) -> dict:
    """The host batch's arrays that the encode path and the losses read, as
    tensors on ``device`` (numpy dtypes kept: int32 indices, bool masks, f32
    values; the counts become 0-d int32 tensors)."""
    if "groups" in batch:
        raise NotImplementedError("split batches are not ported yet")
    if np.ndim(batch["lv_nodes"]) != 2:
        raise NotImplementedError("chunked batches ([C, L] level tables) are not ported yet")
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device, non_blocking=True)
            for k in DEVICE_KEYS + LOSS_KEYS}


def num_levels(batch: dict) -> int:
    """Real level count of a host batch (update levels are 1..max level)."""
    return int(np.max(batch["forward_level"]))


def struct_hs(params, b: dict, cfg: DGConfig) -> torch.Tensor:
    """hs [N, D] of a device batch."""
    x_feat = struct_input(b["gate"], cfg)
    s, t = direct_multigcn_apply(params["struct"], x_feat, b, cfg.s_rounds, cfg.t_rounds,
                                 cfg.layernorm)
    return linear_apply(params["hs_linear"], torch.cat([s, t], dim=-1))


def level_statics(params, b: dict, cfg: DGConfig, hs: torch.Tensor, expert: torch.Tensor):
    """Per-edge statics pack [E, D+2] = [vhs | score_static | expert] and the
    hf-side key/value weights wkv_hf [D, 2TD]. An edge's expert is its
    DESTINATION's."""
    D, T = cfg.dim_hidden, cfg.num_experts
    ex = params["experts"]
    src, dst = b["edge_src"], b["edge_dst"]
    e_dst = expert[dst].clamp(min=0)                        # [E]
    # per-node query score: q depends on [hs, hf = 0] only
    e_node = expert.clamp(min=0)
    q = select_expert(hs @ ex["wq"][:D], e_node, T) + ex["bq"][e_node]
    aq_n = (q * ex["wa_q"][e_node]).sum(-1) + ex["ba"][e_node]  # [N]
    # per-edge hs-side key/value
    wkv_hs = torch.cat([ex["wk"][:D], ex["wv"][:D]], dim=1)     # [D, 2TD]
    kv_hs = hs[src] @ wkv_hs                                    # [E, 2TD]
    khs = select_expert(kv_hs[:, : T * D], e_dst, T) + ex["bk"][e_dst]
    vhs = select_expert(kv_hs[:, T * D :], e_dst, T) + ex["bv"][e_dst]
    score_static = (khs * ex["wa_k"][e_dst]).sum(-1) + aq_n[dst]
    pack = torch.cat([vhs, score_static[:, None], e_dst[:, None].to(hs.dtype)], dim=1)
    wkv_hf = torch.cat([ex["wk"][D:], ex["wv"][D:]], dim=1)     # [D, 2TD]
    return pack, wkv_hf


def level_scan_inputs(params, b: dict, cfg: DGConfig, hs: torch.Tensor) -> tuple:
    """The 12 tensor arguments of ``level_scan`` for a device batch."""
    ex = params["experts"]
    expert = cfg.expert_of_gate(hs.device)[b["gate"].long()]   # [N], -1: no expert
    pack, wkv_hf = level_statics(params, b, cfg, hs, expert)
    pack_lv = pack[b["lv_edge_id"].long()]                      # [L, Ep, D+2]
    lv_nodes = b["lv_nodes"]
    e_nodes = expert[lv_nodes.long()]
    lv_upd = (b["lv_node_valid"] & (e_nodes >= 0)).to(torch.int32)
    lv_e_n = e_nodes.clamp(min=0).to(torch.int32)
    return (pack_lv, b["lv_edge_src"], b["lv_edge_dst_slot"],
            b["lv_edge_valid"].to(torch.int32), lv_nodes, lv_upd, lv_e_n,
            wkv_hf, ex["w_ih"], ex["b_ih"], ex["b_hh"], ex["wa_k"])


def forward(params, batch: dict, cfg: DGConfig):
    """Model forward on a host batch (``data.batching.collate``); returns
    (hs, hf, aux) on the params' device, rows in the batch's level-major
    order. ``aux`` is empty (it holds the posterior stats of the
    variational mode, which is not ported yet). Differentiable with respect
    to the params; ``api.Model`` runs it under ``inference_mode``."""
    device = params["hs_linear"]["w"].device
    return forward_device(params, batch_to_device(batch, device), cfg, num_levels(batch))


def forward_device(params, b: dict, cfg: DGConfig, n_levels: int):
    """``forward`` on a batch already on the device (``batch_to_device``),
    with its real level count (``num_levels``)."""
    check_supported(cfg)
    hs = struct_hs(params, b, cfg)
    hf = level_scan(*level_scan_inputs(params, b, cfg, hs), num_nodes=hs.shape[0],
                    num_levels=n_levels)
    return hs, hf, {}


def hs_decompose(params, hs: torch.Tensor):
    """hs -> (s, t) for the directed inner-product decoder."""
    st = linear_apply(params["hs_decompose"], hs)
    return st.chunk(2, dim=-1)


def decode_edges(s, t, src, dst, sigmoid: bool = True):
    """Directed inner-product decoder: sigmoid(s[src] . t[dst]), or the
    logits."""
    logits = (s[src.long()] * t[dst.long()]).sum(-1)
    return torch.sigmoid(logits) if sigmoid else logits
