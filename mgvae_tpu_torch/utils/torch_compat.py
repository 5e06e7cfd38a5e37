"""Reference-style PyTorch state dicts -> the port's params and state trees.

The port's copy of ``mgvae_tpu/utils/torch_compat.py``. It understands the
parameter names of the reference models (dg_ae_model_{aig,mig,xag,xmg}.py
and digae_layer.py:232-297):
  * the per-modality struct-encoder attribute (``struct_encoder`` /
    ``mig_struct_encoder`` / ...);
  * ``module.`` prefixes of DDP-saved checkpoints (stripped, as the
    reference's tolerant Model.load does, dg_ae_model_mig.py:139-162);
  * the MLP's inner ``fc`` Sequential (``readout_prob.fc.0.weight``);
  * DG_VAE's posterior heads ``fc_{s,t}_{mu,logstd}``, where present.

Linear weights [out, in] become [in, out] and each gate type's attention
and GRU are stacked along the expert axis in ``cfg.gate_types`` order, the
layouts of ``models.dg_ae.init_params``. A missing key raises KeyError, as
in the JAX package; a tensor whose shape does not fit ``cfg`` (a D = 64
file read under D = 256, say) raises ValueError here, before any kernel
sees it.
"""
from __future__ import annotations

import numpy as np
import torch

STRUCT_ATTR = {
    "aig": "struct_encoder",
    "mig": "mig_struct_encoder",
    "xag": "xag_struct_encoder",
    "xmg": "xmg_struct_encoder",
}
GATE_MODULES = {
    "aig": {1: "and", 2: "not"},
    "mig": {2: "not", 3: "and", 4: "or", 1: "maj"},
    "xag": {3: "and", 2: "not", 5: "xor"},
    "xmg": {3: "and", 2: "not", 5: "xor", 1: "maj", 4: "or"},
}
EXPERT_KEYS = ("wq", "bq", "wk", "bk", "wv", "bv", "wa_q", "wa_k", "ba",
               "w_ih", "w_hh", "b_ih", "b_hh")
# concatenated along the output axis ([in, T * out]); the rest are stacked ([T, ...])
EXPERT_CAT = ("wq", "wk", "wv", "w_ih", "w_hh")
VAE_HEADS = ("fc_s_mu", "fc_s_logstd", "fc_t_mu", "fc_t_logstd")


def _normalize_keys(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        if k.startswith("module.") and not k.startswith("module_list"):
            k = k[7:]
        k = k.replace("readout_prob.fc.", "readout_prob.")
        out[k] = v
    return out


def _f32(sd: dict, key: str) -> torch.Tensor:
    if key not in sd:
        raise KeyError(key)
    v = sd[key]
    v = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return v.to(torch.float32)


def _linear(sd, prefix):
    return {"w": _f32(sd, prefix + ".weight").T.contiguous(), "b": _f32(sd, prefix + ".bias")}


def _gru(sd, prefix):
    return {
        "w_ih": _f32(sd, prefix + ".weight_ih_l0").T.contiguous(),
        "w_hh": _f32(sd, prefix + ".weight_hh_l0").T.contiguous(),
        "b_ih": _f32(sd, prefix + ".bias_ih_l0"),
        "b_hh": _f32(sd, prefix + ".bias_hh_l0"),
    }


def _multigcn(sd, prefix, layernorm):
    p = {
        "aggr": _linear(sd, prefix + ".aggr.msg"),
        "update": _gru(sd, prefix + ".update"),
        "aggr_r": _linear(sd, prefix + ".aggr_r.msg"),
        "update_r": _gru(sd, prefix + ".update_r"),
    }
    if layernorm:
        p["ln"] = {"w": _f32(sd, prefix + ".ln.weight"), "b": _f32(sd, prefix + ".ln.bias")}
    return p


def _experts(sd, cfg) -> dict:
    """Each gate type's attention and GRU, stacked in ``cfg.gate_types`` order."""
    D = cfg.dim_hidden
    gm = GATE_MODULES[cfg.modality]
    per = {k: [] for k in EXPERT_KEYS}
    for gid in cfg.gate_types:
        name = gm[gid]
        q = _linear(sd, f"aggr_{name}_func.msg_q")
        k = _linear(sd, f"aggr_{name}_func.msg_k")
        v = _linear(sd, f"aggr_{name}_func.msg_v")
        a = _linear(sd, f"aggr_{name}_func.attn_lin")
        g = _gru(sd, f"update_{name}_func")
        per["wq"].append(q["w"]); per["bq"].append(q["b"])
        per["wk"].append(k["w"]); per["bk"].append(k["b"])
        per["wv"].append(v["w"]); per["bv"].append(v["b"])
        per["wa_q"].append(a["w"][:D, 0]); per["wa_k"].append(a["w"][D:, 0])
        per["ba"].append(a["b"][0])
        for key in ("w_ih", "w_hh", "b_ih", "b_hh"):
            per[key].append(g[key])
    return {k: (torch.cat(v, dim=1) if k in EXPERT_CAT else torch.stack(v))
            for k, v in per.items()}


def params_from_torch_state(state_dict: dict, cfg, device="cuda") -> tuple[dict, dict]:
    """(params, state) trees of ``models.dg_ae.init_params``' layout, f32
    tensors on ``device`` (the card unless the caller asks for the CPU),
    from a reference model's state dict. ``cfg``: a ``DGConfig`` of the
    multigcn struct encoder; its ``variational`` heads are read where the
    file holds them."""
    if cfg.struct_encoder != "multigcn":
        raise ValueError("reference state dicts hold the DirectMultiGCN struct encoder; got "
                         f"struct_encoder={cfg.struct_encoder!r}")
    sd = _normalize_keys(state_dict)
    attr = STRUCT_ATTR[cfg.modality]
    params = {
        "struct": {
            "source": _multigcn(sd, f"{attr}.source_conv", cfg.layernorm),
            "target": _multigcn(sd, f"{attr}.target_conv", cfg.layernorm),
        },
        "hs_linear": _linear(sd, "hs_linear"),
        "hs_decompose": _linear(sd, "hs_decompose"),
        "experts": _experts(sd, cfg),
        # readout_prob: Sequential indices 0/4/8 Linear, 1/5 BatchNorm
        "readout_prob": {
            "layers": [_linear(sd, f"readout_prob.{i}") for i in (0, 4, 8)],
            "bn": [{"w": _f32(sd, f"readout_prob.{i}.weight"),
                    "b": _f32(sd, f"readout_prob.{i}.bias")} for i in (1, 5)],
        },
    }
    state = {"readout_prob": {"bn": [
        {"mean": _f32(sd, f"readout_prob.{i}.running_mean"),
         "var": _f32(sd, f"readout_prob.{i}.running_var")} for i in (1, 5)]}}
    if cfg.variational:
        for head in VAE_HEADS:
            if f"{head}.weight" in sd:
                params[head] = _linear(sd, head)
    _check_shapes(params, state, cfg)
    device = torch.device(device)
    return _to(params, device), _to(state, device)


def _check_shapes(params, state, cfg) -> None:
    """Every converted leaf against the shape ``init_params(cfg)`` draws."""
    from ..models.dg_ae import init_params

    want_p, want_s = init_params(cfg, device="meta")

    def walk(got, want, path):
        if isinstance(got, dict):
            for k, v in got.items():
                walk(v, want[k], f"{path}.{k}")
        elif isinstance(got, list):
            for i, v in enumerate(got):
                walk(v, want[i], f"{path}[{i}]")
        elif tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{path}: shape {tuple(got.shape)} in the state dict, "
                             f"{tuple(want.shape)} for {cfg} (another width or modality?)")

    walk(params, want_p, "params")
    walk(state, want_s, "state")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
