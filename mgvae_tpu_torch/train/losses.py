"""Training losses, masked for padding.

Counterpart of ``mgvae_tpu/train/losses.py``:

  recon: -log sigma(s_u . t_v) over the positive edges plus -log(1 - sigma)
         over E uniformly sampled negative pairs (no self loops), both from
         the logits.
  prob:  L1(clamp(readout_prob(hf), 0, 1), prob).
  func:  L1(zscore(1 - cos(hf_a, hf_b)), zscore(tt_dis)), torch's unbiased
         std.
  kl:    DG_VAE's term over the posterior tensors in ``aux``, with the
         reference's double 1/N (trainer.py:146-148).

Random draws (negatives, dropout) come from an explicit ``torch.Generator``
and cannot match ``jax.random`` bit for bit; ``recon_loss`` takes explicit
``neg_edges`` and ``prob_loss`` explicit dropout ``drop_keep`` masks, so the
parity tests hand both packages the same draws.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.dg_ae import decode_edges, hs_decompose
from ..ops.mlp import mlp_apply

EPS = 1e-15
LOG_EPS = 34.538776394910684  # -log(EPS): the reference's saturation ceiling
COS_EPS = 1e-8


def log_sigmoid_loss(logit: torch.Tensor, positive: bool) -> torch.Tensor:
    """-log(sigmoid(x) + EPS) / -log(1 - sigmoid(x) + EPS), computed from the
    logit as softplus(-x) / softplus(x) and clipped at -log(EPS). Never as
    -log(1 - sigma + eps): that saturates to log(0) once sigma rounds to 1."""
    return F.softplus(-logit if positive else logit).clamp(max=LOG_EPS)


def masked_mean(x, valid, count=None):
    v = valid.to(x.dtype)
    if count is None:
        count = v.sum().clamp(min=1.0)
    return (x * v).sum() / count


def masked_zscore(x, valid, count):
    """z-normalisation with torch.std's unbiased (n - 1) denominator."""
    v = valid.to(x.dtype)
    mean = (x * v).sum() / count
    var = ((x - mean).square() * v).sum() / (count - 1.0).clamp(min=1.0)
    return (x - mean) * torch.rsqrt(var.clamp(min=1e-30))


def _count(b: dict, key: str, like: torch.Tensor) -> torch.Tensor:
    """A batch count as a float scalar of ``like``'s dtype, at least 1."""
    return torch.as_tensor(b[key], device=like.device).to(like.dtype).clamp(min=1.0)


def to_valid_runs(ids: torch.Tensor, b: dict) -> torch.Tensor:
    """Ids over the valid-node count [0, n_nodes) mapped into the batch's
    node rows. The valid nodes of a chunked batch lie in C runs (chunk k at
    [k * N_sub, k * N_sub + chunk_counts[k])), those of a split batch at
    ``chunk_offsets``; ids are mapped into the runs, so that a negative
    never hits an interior padding row. A plain batch has one run at 0."""
    counts = b.get("chunk_counts")
    if counts is None or counts.shape[0] < 2:
        return ids
    counts = torch.as_tensor(counts, device=ids.device)
    cum = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(ids.dtype)
    offsets = b.get("chunk_offsets")
    if offsets is None:
        n_sub = b["gate"].shape[0] // counts.shape[0]
        offsets = n_sub * torch.arange(counts.shape[0], dtype=ids.dtype, device=ids.device)
    offsets = torch.as_tensor(offsets, device=ids.device)
    k = torch.searchsorted(cum, ids, right=True) - 1
    return (offsets[k] + ids - cum[k]).to(torch.int32)


def sample_negative_edges(gen: torch.Generator, num_samples: int, b: dict):
    """Uniform negative pairs over the valid nodes, self loop free by
    construction: dst = (src + 1 + u * (n - 1)) % n over [0, n_nodes), then
    ``to_valid_runs``. Drawn on the generator's device, returned on
    n_nodes' device as int32."""
    n_nodes = torch.as_tensor(b["n_nodes"])
    n = n_nodes.to(gen.device).clamp(min=2).to(torch.float32)
    u1 = torch.rand(num_samples, generator=gen, device=gen.device)
    u2 = torch.rand(num_samples, generator=gen, device=gen.device)
    src = (u1 * n).to(torch.int32)
    off = (u2 * (n - 1)).to(torch.int32)
    dst = (src + 1 + off) % n.to(torch.int32)
    return tuple(to_valid_runs(x.to(n_nodes.device), b) for x in (src, dst))


def recon_loss(params, hs, b: dict, gen: torch.Generator | None = None, neg_edges=None,
               mask_collisions: bool = False):
    """Returns (loss, metrics of scalar counts: tp, fn, fp, tn, n_pred).

    ``neg_edges``: explicit (src, dst) negatives; without them E pairs are
    drawn from ``gen``. ``mask_collisions`` masks sampled negatives that
    coincide with a valid real edge and renormalises over the survivors
    (an [E, E] equality test). ``params`` are the fp32 master params: a
    bf16 ``hs`` is upcast before ``hs_decompose``, as JAX promotes it
    (``mgvae_tpu/train/losses.py:119``), while the counts keep hs's dtype
    (in bf16 they round, as in JAX)."""
    s, t = hs_decompose(params, hs.float())
    ev = b["edge_valid"]
    e_count = _count(b, "n_edges", hs)
    pos_logit = decode_edges(s, t, b["edge_src"], b["edge_dst"], sigmoid=False)
    pos_loss = masked_mean(log_sigmoid_loss(pos_logit, True), ev, e_count)

    if neg_edges is None:
        if gen is None:
            raise ValueError("recon_loss needs a generator or explicit neg_edges")
        neg_src, neg_dst = sample_negative_edges(gen, b["edge_src"].shape[0], b)
    else:
        neg_src, neg_dst = (torch.as_tensor(x, device=hs.device) for x in neg_edges)
    neg_logit = decode_edges(s, t, neg_src, neg_dst, sigmoid=False)
    neg_valid, neg_count = ev, e_count
    if mask_collisions:
        hit = ((neg_src[:, None] == b["edge_src"][None, :])
               & (neg_dst[:, None] == b["edge_dst"][None, :])
               & ev[None, :]).any(dim=1)
        neg_valid = ev & ~hit
        neg_count = neg_valid.to(hs.dtype).sum().clamp(min=1.0)
    neg_loss = masked_mean(log_sigmoid_loss(neg_logit, False), neg_valid, neg_count)

    with torch.no_grad():
        pos_bin = ((pos_logit > 0.0) & ev).to(hs.dtype).sum()
        neg_bin = ((neg_logit > 0.0) & neg_valid).to(hs.dtype).sum()
        metrics = {"tp": pos_bin, "fn": e_count - pos_bin, "fp": neg_bin,
                   "tn": neg_count - neg_bin, "n_pred": e_count + neg_count}
    return pos_loss + neg_loss, metrics


def prob_loss(params, state, hf, b: dict, train: bool, gen: torch.Generator | None = None,
              drop_keep=None):
    """Returns (loss, {"readout_prob": new_state}). The readout is the BN-MLP
    with dropout 0.2 in train mode, clipped to [0, 1]; ``drop_keep`` is an
    optional list of explicit keep masks, one per hidden layer. The fp32
    readout takes a bf16 ``hf`` upcast, as JAX promotes it
    (``mgvae_tpu/train/losses.py:174``); the count keeps hf's dtype."""
    valid = b["node_valid"]
    out, new_state = mlp_apply(params["readout_prob"], state["readout_prob"], hf.float(),
                               valid=valid, train=train, gen=gen, drop_keep=drop_keep)
    pred = out[:, 0].clamp(0.0, 1.0)
    l1 = (pred - b["prob"]).abs()
    return masked_mean(l1, valid, _count(b, "n_nodes", hf)), {"readout_prob": new_state}


def kl_loss(aux: dict, b: dict):
    """Per tower -0.5 / N * masked_mean over the valid nodes of
    sum_d (1 + 2 logstd - mu^2 - exp(logstd)^2), with N = n_nodes: the
    reference's double 1/N, kept (``mgvae_tpu/train/losses.py:205-216``).
    Returns the s tower's plus the t tower's."""
    n = _count(b, "n_nodes", aux["s_mu"])
    valid = b["node_valid"]

    def one(mu, logstd):
        per_node = (1.0 + 2.0 * logstd - mu.square() - torch.exp(logstd).square()).sum(1)
        return (-0.5 / n) * masked_mean(per_node, valid, n)

    return one(aux["s_mu"], aux["s_logstd"]) + one(aux["t_mu"], aux["t_logstd"])


def func_loss(hf, b: dict):
    """Masked BEFORE the norm: padding pairs may gather all-zero hf rows,
    whose norm has a 0/0 = NaN cotangent that the clamp does not stop."""
    valid = b["tt_valid"]
    a = torch.where(valid[:, None], hf[b["tt_pair_a"].long()], 1.0)
    c = torch.where(valid[:, None], hf[b["tt_pair_b"].long()], 1.0)
    # torch.cosine_similarity(eps): norms clamped to eps one by one
    na = torch.linalg.vector_norm(a, dim=-1).clamp(min=COS_EPS)
    nc = torch.linalg.vector_norm(c, dim=-1).clamp(min=COS_EPS)
    emb_dis = 1.0 - (a * c).sum(-1) / (na * nc)
    count = _count(b, "n_tt", hf)
    emb_z = masked_zscore(emb_dis, valid, count)
    tt_z = masked_zscore(b["tt_dis"], valid, count)
    return masked_mean((emb_z - tt_z).abs(), valid, count)
