"""Degree-normalised directed GCN encoders and the DirectedGAE wrapper.

Counterpart of ``mgvae_tpu/models/gcn.py``: the struct encoder of
``--model AE`` (``DGConfig(struct_encoder="gcn")``) and the reference's
GAE surface.

  * ``directed_gcn_conv_apply``: out_v = sum over u -> v of
    in_deg(v)^-alpha * out_deg(u)^-beta * (W x_u + b), with a self loop on
    every row (padding rows included), degrees over the valid edges;
  * the 2-layer ``DirectedGCNConvEncoder`` (source tower: forward edges,
    then flipped; target tower: the mirror) and the single-layer encoder
    with its cross-wiring;
  * ``DirectedGAE``: encode, decode, recon_loss on logits, test (ROC-AUC
    and AP from ``utils/metrics``).

Plain torch on every device: the JAX package runs this path as plain XLA,
with no kernel. The sums are ``ops.segment.segment_sum_ordered``, whose
order is fixed on the card too.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.init import linear_apply, linear_init
from ..ops.segment import segment_sum_ordered


def _with_self_loops(src, dst, valid, n: int):
    """One self loop per row appended to the edge list (PyG add_self_loops)."""
    loops = torch.arange(n, dtype=src.dtype, device=src.device)
    return (torch.cat([src, loops]), torch.cat([dst, loops]),
            torch.cat([valid, torch.ones(n, dtype=valid.dtype, device=valid.device)]))


def directed_gcn_conv_init(gen: torch.Generator, dim_in: int, dim_out: int) -> dict:
    return {"lin": linear_init(gen, dim_in, dim_out)}


def directed_gcn_conv_apply(p, x, src, dst, valid, alpha=1.0, beta=0.0, self_loops=True):
    n = x.shape[0]
    if self_loops:
        src, dst, valid = _with_self_loops(src, dst, valid, n)
    src, dst = src.long(), dst.long()
    h = linear_apply(p["lin"], x)
    vf = valid.to(x.dtype)
    in_deg = segment_sum_ordered(vf, dst, n)
    out_deg = segment_sum_ordered(vf, src, n)
    # pow(0, -a) is inf: rows of degree 0 get the reference's 0 (in) and 1 (out)
    in_norm = torch.where(in_deg > 0, in_deg.clamp(min=1e-30).pow(-alpha), 0.0)
    out_norm = torch.where(out_deg > 0, out_deg.clamp(min=1e-30).pow(-beta), 1.0)
    coef = in_norm[dst] * out_norm[src] * vf
    return segment_sum_ordered(h[src] * coef[:, None], dst, n)


def directed_gcn_encoder_init(gen: torch.Generator, dim_in: int, dim_hidden: int,
                              dim_out: int) -> dict:
    return {
        "source": {"conv1": directed_gcn_conv_init(gen, dim_in, dim_hidden),
                   "conv2": directed_gcn_conv_init(gen, dim_hidden, dim_out)},
        "target": {"conv1": directed_gcn_conv_init(gen, dim_in, dim_hidden),
                   "conv2": directed_gcn_conv_init(gen, dim_hidden, dim_out)},
    }


def directed_gcn_encoder_apply(p, s, t, src, dst, valid, alpha=1.0, beta=0.0, self_loops=True):
    """The source tower runs conv1 on the forward edges, then conv2 on the
    flipped ones; the target tower mirrors it. Returns (s, t)."""
    conv = directed_gcn_conv_apply
    s1 = torch.relu(conv(p["source"]["conv1"], s, src, dst, valid, alpha, beta, self_loops))
    s2 = conv(p["source"]["conv2"], s1, dst, src, valid, alpha, beta, self_loops)
    t1 = torch.relu(conv(p["target"]["conv1"], t, dst, src, valid, alpha, beta, self_loops))
    t2 = conv(p["target"]["conv2"], t1, src, dst, valid, alpha, beta, self_loops)
    return s2, t2


def single_layer_directed_encoder_init(gen: torch.Generator, dim_in: int, dim_out: int) -> dict:
    return {"source": directed_gcn_conv_init(gen, dim_in, dim_out),
            "target": directed_gcn_conv_init(gen, dim_in, dim_out)}


def single_layer_directed_encoder_apply(p, s0, t0, src, dst, valid, alpha=1.0, beta=0.0,
                                        self_loops=True):
    """Cross-wired: s reads t0 over the flipped edges, t reads s0 forward."""
    s1 = directed_gcn_conv_apply(p["source"], t0, dst, src, valid, alpha, beta, self_loops)
    t1 = directed_gcn_conv_apply(p["target"], s0, src, dst, valid, alpha, beta, self_loops)
    return s1, t1


class DirectedGAE:
    """The reference's DirectedGAE surface over the 2-layer encoder. Params
    are drawn from ``torch.Generator().manual_seed(seed)`` on the CPU and
    moved to ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, dim_in=6, dim_hidden=64, dim_out=64, alpha=1.0, beta=0.0, seed=0,
                 params=None, device="cuda"):
        self.alpha, self.beta = alpha, beta
        self.device = torch.device(device)
        if params is None:
            params = directed_gcn_encoder_init(torch.Generator().manual_seed(seed), dim_in,
                                               dim_hidden, dim_out)
        self.params = _to(params, self.device)

    def encode(self, s, t, src, dst, valid=None):
        """(s, t) of node features s, t [N, dim_in] over the edges src -> dst
        (numpy arrays or tensors)."""
        dev = self.device
        src = torch.as_tensor(src, dtype=torch.int64, device=dev)
        dst = torch.as_tensor(dst, dtype=torch.int64, device=dev)
        valid = (torch.ones(src.shape[0], dtype=torch.bool, device=dev) if valid is None
                 else torch.as_tensor(valid, dtype=torch.bool, device=dev))
        return directed_gcn_encoder_apply(
            self.params, torch.as_tensor(s, dtype=torch.float32, device=dev),
            torch.as_tensor(t, dtype=torch.float32, device=dev), src, dst, valid,
            self.alpha, self.beta)

    @staticmethod
    def decode(s, t, src, dst, sigmoid=True):
        src = torch.as_tensor(src, dtype=torch.int64, device=s.device)
        dst = torch.as_tensor(dst, dtype=torch.int64, device=s.device)
        v = (s[src] * t[dst]).sum(-1)
        return torch.sigmoid(v) if sigmoid else v

    def recon_loss(self, s, t, pos_edge_index, neg_edge_index):
        """(loss, pred_bin, gt_bin): the logit-side softplus form of
        -log(sigmoid + EPS) (``train.losses.log_sigmoid_loss``), finite at
        saturation."""
        from ..train.losses import log_sigmoid_loss

        pos = self.decode(s, t, pos_edge_index[0], pos_edge_index[1], sigmoid=False)
        neg = self.decode(s, t, neg_edge_index[0], neg_edge_index[1], sigmoid=False)
        loss = log_sigmoid_loss(pos, True).mean() + log_sigmoid_loss(neg, False).mean()
        pred_bin = torch.cat([pos > 0.0, neg > 0.0]).to(torch.int32)
        gt_bin = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)]).to(torch.int32)
        return loss, pred_bin, gt_bin

    @torch.no_grad()
    def test(self, s, t, pos_edge_index, neg_edge_index):
        """(ROC-AUC, AP) of the decoded probabilities."""
        from ..utils.metrics import average_precision_score, roc_auc_score

        pos = self.decode(s, t, pos_edge_index[0], pos_edge_index[1]).cpu().numpy()
        neg = self.decode(s, t, neg_edge_index[0], neg_edge_index[1]).cpu().numpy()
        y = np.concatenate([np.ones_like(pos), np.zeros_like(neg)])
        pred = np.concatenate([pos, neg])
        return roc_auc_score(y, pred), average_precision_score(y, pred)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(tree), dtype=torch.float32, device=device)
