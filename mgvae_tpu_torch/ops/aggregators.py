"""Alternative message-passing aggregators, in plain PyTorch.

Counterpart of ``mgvae_tpu/ops/aggregators.py``: the reference's arch
variants that it imports but does not instantiate on its live path,
provided so that experiments which swap aggregators port over. Neither
package has a kernel here.

  MlpAggr      arch/mlp_aggr.py:     sum_j MLP(x_j)
  AttnMLP      arch/aggnmlp.py:      MLP-projected Q/K/V with segment softmax
  DeepSetConv  arch/deepset_conv.py: sum_j MLP(x_j) (DeepSet phi)
  AGNNConv     arch/gat_conv.py:     additive GAT-style attention
  GatedSumConv arch/gated_sum_conv.py: sum_j sigmoid(gate(x_j)) * msg(x_j)
  GCNConv      digae_layer.py:40-56: symmetric-normalized undirected GCN
  InnerProductDecoder digae_layer.py:13-20

Every apply takes (params, x [N, Din], edge_src, edge_dst, edge_valid,
num_nodes) and returns [N, Dout]; ``reverse=True`` in the reference flips
the flow: pass swapped src / dst instead. Inits draw from a
``torch.Generator`` on the CPU (torch's ``nn.Linear`` bounds) into the JAX
package's trees, so a JAX init carries across as a plain copy.
"""
from __future__ import annotations

import torch

from .init import linear_apply, linear_init, rsqrt
from .segment import segment_softmax, segment_sum


def _masked(x, valid):
    return x * valid[:, None].to(x.dtype)


# -- MlpAggr ----------------------------------------------------------------

def mlp_aggr_init(gen: torch.Generator, dim_in: int, dim_out: int) -> dict:
    """The reference's MLP(dim_in, dim_out, dim_out, num_layer=3) without
    normalisation: three linears, ReLU between them."""
    dims = [dim_in, dim_out, dim_out, dim_out]
    layers = [linear_init(gen, dims[i], dims[i + 1]) for i in range(3)]
    return {"mlp": {"layers": layers}, "mlp_state": {"bn": []}}


def _mlp(params: dict, x):
    layers = params["layers"]
    for layer in layers[:-1]:
        x = torch.relu(linear_apply(layer, x))
    return linear_apply(layers[-1], x)


def mlp_aggr_apply(params, x, src, dst, valid, num_nodes):
    msg = _mlp(params["mlp"], x[src])
    return segment_sum(_masked(msg, valid), dst, num_nodes)


# -- DeepSetConv --------------------------------------------------------------

deepset_conv_init = mlp_aggr_init
deepset_conv_apply = mlp_aggr_apply


# -- AttnMLP (aggnmlp.py) -----------------------------------------------------

def attn_mlp_init(gen: torch.Generator, dim_in: int, dim_out: int) -> dict:
    return {
        "q": linear_init(gen, dim_in, dim_out),
        "k": linear_init(gen, dim_in, dim_out),
        "v": linear_init(gen, dim_in, dim_out),
        "attn": linear_init(gen, 2 * dim_out, 1),
    }


def attn_mlp_apply(params, x, src, dst, valid, num_nodes):
    q = linear_apply(params["q"], x[dst])
    k = linear_apply(params["k"], x[src])
    score = linear_apply(params["attn"], torch.cat([q, k], dim=-1))[:, 0]
    a = segment_softmax(score, dst, num_nodes, valid=valid)
    v = linear_apply(params["v"], x[src]) * a[:, None]
    return segment_sum(v, dst, num_nodes)


# -- AGNNConv (gat_conv.py additive attention) --------------------------------

def agnn_conv_init(gen: torch.Generator, dim_in: int, dim_out: int) -> dict:
    return {
        "lin": linear_init(gen, dim_in, dim_out),
        "att_l": linear_init(gen, dim_out, 1),
        "att_r": linear_init(gen, dim_out, 1),
    }


def agnn_conv_apply(params, x, src, dst, valid, num_nodes, negative_slope=0.2):
    h = linear_apply(params["lin"], x)
    alpha = (linear_apply(params["att_l"], h[dst])[:, 0]
             + linear_apply(params["att_r"], h[src])[:, 0])
    alpha = torch.nn.functional.leaky_relu(alpha, negative_slope)
    a = segment_softmax(alpha, dst, num_nodes, valid=valid)
    return segment_sum(h[src] * a[:, None], dst, num_nodes)


# -- GatedSumConv --------------------------------------------------------------

def gated_sum_conv_init(gen: torch.Generator, dim: int) -> dict:
    return {"gate": linear_init(gen, dim, dim), "msg": linear_init(gen, dim, dim)}


def gated_sum_conv_apply(params, x, src, dst, valid, num_nodes):
    g = torch.sigmoid(linear_apply(params["gate"], x[src]))
    m = g * linear_apply(params["msg"], x[src])
    return segment_sum(_masked(m, valid), dst, num_nodes)


# -- undirected GCNConv / GCNEncoder (digae_layer.py:40-66) --------------------

def gcn_conv_init(gen: torch.Generator, dim_in: int, dim_out: int) -> dict:
    return {"lin": linear_init(gen, dim_in, dim_out)}


def gcn_conv_apply(params, x, src, dst, valid, num_nodes):
    loops = torch.arange(num_nodes, dtype=src.dtype, device=src.device)
    src = torch.cat([src, loops])
    dst = torch.cat([dst, loops])
    valid = torch.cat([valid, torch.ones(num_nodes, dtype=valid.dtype, device=valid.device)])
    h = linear_apply(params["lin"], x)
    vf = valid.to(x.dtype)
    deg = segment_sum(vf, dst, num_nodes)
    dis = torch.where(deg > 0, rsqrt(deg.clamp(min=1e-30)), 0.0)
    norm = dis[src] * dis[dst] * vf
    return segment_sum(h[src] * norm[:, None], dst, num_nodes)


def gcn_encoder_init(gen: torch.Generator, dim_in: int, dim_out: int) -> dict:
    return {"conv1": gcn_conv_init(gen, dim_in, 2 * dim_out),
            "conv2": gcn_conv_init(gen, 2 * dim_out, dim_out)}


def gcn_encoder_apply(params, x, src, dst, valid, num_nodes):
    h = torch.relu(gcn_conv_apply(params["conv1"], x, src, dst, valid, num_nodes))
    return gcn_conv_apply(params["conv2"], h, src, dst, valid, num_nodes)


# -- decoders -------------------------------------------------------------------

def inner_product_decode(z, src, dst, sigmoid=True):
    v = (z[src] * z[dst]).sum(-1)
    return torch.sigmoid(v) if sigmoid else v


def inner_product_decode_all(z, sigmoid=True):
    adj = z @ z.T
    return torch.sigmoid(adj) if sigmoid else adj


def directed_inner_product_decode_all(s, t, sigmoid=True):
    adj = s @ t.T
    return torch.sigmoid(adj) if sigmoid else adj


# -- dummy encoders (digae_layer.py:215-230) --------------------------------------

def dummy_encoder_apply(x, *_args, **_kw):
    return x


def dummy_pair_encoder_apply(s, t, *_args, **_kw):
    return s, t
