"""Bridge between the JAX package's params and state trees and the port's
tensors.

Both packages keep the same tree and the same [in, out] layouts, so the
bridge is a plain copy. It takes the tree as nested dicts and lists of numpy
arrays (``jax.tree.map(np.asarray, params)``) and raises on any key it does
not know, so a tree from a configuration the port does not run yet (e.g.
the variational heads) is refused instead of silently dropped.
``params_to_numpy`` goes the other way, for comparing updated trees.
"""
from __future__ import annotations

import numpy as np
import torch

_LINEAR = frozenset({"w", "b"})
_GRU = frozenset({"w_ih", "w_hh", "b_ih", "b_hh"})
_TOWER = {"aggr": _LINEAR, "update": _GRU, "aggr_r": _LINEAR, "update_r": _GRU, "ln": _LINEAR}
_SCHEMA = {
    "struct": {"source": _TOWER, "target": _TOWER},
    "hs_linear": _LINEAR,
    "hs_decompose": _LINEAR,
    "experts": frozenset({"wq", "bq", "wk", "bk", "wv", "bv", "wa_q", "wa_k", "ba",
                          "w_ih", "w_hh", "b_ih", "b_hh"}),
    "readout_prob": {"layers": [_LINEAR], "bn": [_LINEAR]},
}
_STATE_SCHEMA = {"readout_prob": {"bn": [frozenset({"mean", "var"})]}}


def params_from_jax(tree: dict, device="cuda") -> dict:
    """JAX params tree (numpy leaves) -> the port's params (f32 tensors on
    ``device``: the card unless the caller asks for the CPU, as
    ``init_params``). Raises KeyError on an unknown key."""
    return _convert(tree, _SCHEMA, "params", torch.device(device))


def state_from_jax(tree: dict, device="cuda") -> dict:
    """JAX state tree (the BatchNorm running statistics, numpy leaves) ->
    the port's state. Raises KeyError on an unknown key."""
    return _convert(tree, _STATE_SCHEMA, "state", torch.device(device))


def params_to_numpy(tree):
    """A params or state tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def _convert(node, schema, path: str, device):
    if isinstance(schema, list):
        if not isinstance(node, (list, tuple)):
            raise TypeError(f"{path}: expected a list, got {type(node).__name__}")
        return [_convert(v, schema[0], f"{path}[{i}]", device) for i, v in enumerate(node)]
    if not isinstance(node, dict):
        raise TypeError(f"{path}: expected a dict, got {type(node).__name__}")
    out = {}
    for k, v in node.items():
        if k not in schema:
            raise KeyError(f"{path}: unknown parameter key {k!r}")
        if isinstance(schema, frozenset):
            out[k] = torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
        else:
            out[k] = _convert(v, schema[k], f"{path}.{k}", device)
    return out
