"""Checkpoint save and restore: the port's own format, and readers of the
JAX package's checkpoints and of reference ``.pth`` state dicts.

The logical contract of ``mgvae_tpu/utils/checkpoint.py``: a payload of
``epoch``, ``lr``, ``params``, ``state`` and the optimizer state, written
atomically (``.tmp``, then ``os.replace``), and a tolerant restore with the
reference ``Model.load`` semantics (dg_ae_model_mig.py:148-162). Files keep
the reference's ``model_last.pth`` naming.

The port writes with ``torch.save`` and reads with ``torch.load(...,
weights_only=True)``, which executes no pickled code (the JAX package's
reason for msgpack). The optimizer state is ``optimizer.state_dict()``,
whose parameter ids follow ``train.step.param_leaves`` (sorted keys), so
they are stable across processes.

``_read_any`` tells the three formats apart by their bytes, as
``mgvae_tpu/api.py:166-176, 186-189`` does, and decodes a file once:
  * "port": a torch zip holding a dict with ``params``;
  * "jax": the JAX package's flax msgpack (``utils/msgpack_read``, no flax
    needed): ``load_checkpoint`` reads its params and state through
    ``tolerant_merge``, its epoch and lr, and maps the Adam state of
    ``optax.inject_hyperparams(optax.adam)`` (count, mu, nu) onto torch
    Adam's (step, exp_avg, exp_avg_sq) in ``param_leaves`` order, so that
    a trainer resumes a run started on a TPU;
  * "reference": a torch file (zip or legacy pickle) holding a reference
    model's state dict, bare or as ``{"epoch", "state_dict", ...}``:
    ``load_torch_checkpoint`` converts it (``utils/torch_compat``). The
    JAX package reads it with ``weights_only=False``; here a file that
    needs pickled code is refused.
Anything else raises ValueError.
"""
from __future__ import annotations

import os
import pickle
import zipfile

import numpy as np
import torch

from . import msgpack_read

_ZIP_MAGIC = b"PK\x03\x04"    # torch.save's format
# torch.save's legacy format: pickle protocols 2 to 5
_PICKLE_MAGIC = (b"\x80\x02", b"\x80\x03", b"\x80\x04", b"\x80\x05")


def _tree_detach(tree):
    if isinstance(tree, dict):
        return {k: _tree_detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_detach(v) for v in tree]
    return tree.detach()


def save_checkpoint(path: str, epoch: int, params, state, optimizer_state, lr: float):
    """Write {epoch, lr, params, state, optimizer} to ``path`` atomically.
    ``optimizer_state`` is ``optimizer.state_dict()`` or None."""
    payload = {
        "epoch": int(epoch),
        "lr": float(lr),
        "params": _tree_detach(params),
        "state": _tree_detach(state),
        "optimizer": optimizer_state,
    }
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _is_msgpack_map(head: bytes) -> bool:
    # msgpack maps start with 0x81-0x8f (fixmap), 0xde or 0xdf
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def _torch_load(path: str, device):
    try:
        return torch.load(path, map_location=device, weights_only=True)
    except (pickle.UnpicklingError, zipfile.BadZipFile, RuntimeError, EOFError) as e:
        raise ValueError(f"{path}: a torch file that torch.load(..., weights_only=True) "
                         f"refuses (does it need pickled code?): {e}") from e


def _read_any(path: str, device) -> tuple[str, object]:
    """(format, raw payload) of a checkpoint file: "port" (the payload dict),
    "jax" (the decoded msgpack tree) or "reference" ((epoch, state dict)).
    Raises ValueError for any other content, FileNotFoundError for no file."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == _ZIP_MAGIC or head[:2] in _PICKLE_MAGIC:
        raw = _torch_load(path, device)
        if isinstance(raw, dict) and "params" in raw:
            return "port", raw
        sd = raw.get("state_dict", raw) if isinstance(raw, dict) else None
        if isinstance(sd, dict) and sd and all(
                isinstance(k, str) and isinstance(v, torch.Tensor) for k, v in sd.items()):
            return "reference", (int(raw.get("epoch", 0)), sd)
        raise ValueError(f"{path}: a torch file that is neither a checkpoint of mgvae_tpu_torch "
                         "(no 'params' key) nor a reference state dict")
    if _is_msgpack_map(head):
        raw = msgpack_read.read(path)
        if not (isinstance(raw, dict) and "params" in raw):
            raise ValueError(f"{path}: a msgpack file with no 'params' key")
        return "jax", raw
    raise ValueError(f"{path}: an unknown format (not a torch file, not the JAX package's "
                     "msgpack)")


def _read(path: str, device) -> dict:
    """The raw payload of a checkpoint of this package, tensors on
    ``device``. Raises ValueError for any other format."""
    fmt, raw = _read_any(path, device)
    if fmt != "port":
        raise ValueError(f"{path}: a {fmt} checkpoint, not one of mgvae_tpu_torch")
    return raw


def load_checkpoint(path: str, params, state, optimizer, device):
    """Restore a checkpoint of this package or of the JAX package into the
    given templates, tensors on ``device``; returns (epoch, lr, params,
    state).

    ``params`` and ``state`` are merged by ``tolerant_merge`` (new trees;
    the caller copies them where it needs them in place). ``optimizer``, when
    given, gets the saved state through ``load_state_dict``, its ``step``
    counts kept on the CPU as torch keeps them; a saved state that does not
    fit it (other groups or shapes) leaves it as it was, like the JAX
    package's tolerance of optimizer-layout drift. A reference state dict
    raises ValueError: it holds no optimizer or lr, and
    ``load_torch_checkpoint`` reads it."""
    fmt, raw = _read_any(path, device)
    if fmt == "reference":
        raise ValueError(f"{path}: a reference state dict; read it with "
                         "load_torch_checkpoint(path, cfg, device) or Model.load")
    return _restore(path, fmt, raw, params, state, optimizer)


def _restore(path: str, fmt: str, raw, params, state, optimizer):
    """``load_checkpoint`` of a file that ``_read_any`` has decoded."""
    new_params = tolerant_merge(params, raw["params"])
    new_state = tolerant_merge(state, raw["state"])
    if fmt == "jax":
        saved = _adam_from_optax(raw.get("opt_state"), params, optimizer)
    else:
        saved = raw.get("optimizer")
        for st in (saved or {}).get("state", {}).values():
            if isinstance(st.get("step"), torch.Tensor):
                st["step"] = st["step"].cpu()
    if optimizer is not None:
        if saved and _fits(optimizer, saved):
            optimizer.load_state_dict(saved)
        elif saved or fmt == "jax":
            print(f"[WARN] {path}: optimizer state does not fit this model; kept fresh")
    return int(raw["epoch"]), float(raw["lr"]), new_params, new_state


def load_torch_checkpoint(path: str, cfg, device="cuda"):
    """A reference model's ``.pth`` (``{"epoch", "state_dict", ...}`` or a
    bare state dict) -> (epoch, params, state), f32 tensors on ``device``,
    through ``utils.torch_compat.params_from_torch_state`` (KeyError on a
    missing key, ValueError on a shape that does not fit ``cfg``). Any
    other file raises ValueError."""
    fmt, raw = _read_any(path, "cpu")
    if fmt != "reference":
        raise ValueError(f"{path}: a {fmt} checkpoint, not a reference state dict; read it "
                         "with load_checkpoint")
    return _from_reference(raw, cfg, device)


def _from_reference(raw, cfg, device):
    from .torch_compat import params_from_torch_state

    epoch, sd = raw
    params, state = params_from_torch_state(sd, cfg, device)
    return epoch, params, state


def load_weights(path: str, params, state, cfg, device):
    """(params, state) of a checkpoint in any of the three formats, merged
    into the templates by ``tolerant_merge`` (leaves the file lacks keep the
    templates'), tensors on ``device``; the file is decoded once.
    ``api.Model.load``'s reader."""
    fmt, raw = _read_any(path, device)
    if fmt == "reference":
        _, new_params, new_state = _from_reference(raw, cfg, device)
        return tolerant_merge(params, new_params), tolerant_merge(state, new_state)
    return _restore(path, fmt, raw, params, state, None)[2:]


def _leaves_like(template, tree) -> list | None:
    """The tensors of ``tree`` in ``train.step.param_leaves``' order of
    ``template`` (dict keys sorted; flax's ``{"0": ..}`` lists read as
    lists), on the template leaves' devices; None where a leaf is missing
    or its shape differs."""
    if isinstance(template, dict):
        if not isinstance(tree, dict):
            return None
        out = []
        for k in sorted(template):
            sub = _leaves_like(template[k], tree.get(k))
            if sub is None:
                return None
            out += sub
        return out
    if isinstance(template, (list, tuple)):
        if isinstance(tree, dict):
            tree = [tree.get(str(i)) for i in range(len(template))]
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            return None
        out = []
        for tv, v in zip(template, tree):
            sub = _leaves_like(tv, v)
            if sub is None:
                return None
            out += sub
        return out
    if tree is None or tuple(np.shape(tree)) != tuple(template.shape):
        return None
    return [torch.as_tensor(np.asarray(tree, np.float32)).to(template.device)]


def _adam_from_optax(opt_state, params, optimizer) -> dict | None:
    """torch Adam's ``state_dict`` from the JAX package's
    ``optax.inject_hyperparams(optax.adam)`` state ({"count", "hyperparams",
    "inner_state": {"0": {"count", "mu", "nu"}, ...}}): optax's count is
    torch's step (both bias-correct with the number of updates taken), mu
    is exp_avg and nu exp_avg_sq. None where it does not fit."""
    if optimizer is None or not isinstance(opt_state, dict):
        return None
    inner = opt_state.get("inner_state")
    inner = inner.get("0") if isinstance(inner, dict) else None
    if not (isinstance(inner, dict) and {"count", "mu", "nu"} <= set(inner)):
        return None
    mu, nu = _leaves_like(params, inner["mu"]), _leaves_like(params, inner["nu"])
    saved = optimizer.state_dict()
    ids = [i for g in saved["param_groups"] for i in g["params"]]
    if mu is None or nu is None or len(mu) != len(ids):
        return None
    step = float(np.asarray(inner["count"]))
    saved["state"] = {i: {"step": torch.tensor(step), "exp_avg": m, "exp_avg_sq": v}
                      for i, m, v in zip(ids, mu, nu)}
    return saved


def _fits(optimizer, saved: dict) -> bool:
    """Whether a saved optimizer state matches the optimizer's groups and
    each parameter's shape."""
    groups = saved.get("param_groups", [])
    if [len(g["params"]) for g in groups] != [len(g["params"]) for g in optimizer.param_groups]:
        return False
    params = [p for g in optimizer.param_groups for p in g["params"]]
    ids = [i for g in groups for i in g["params"]]
    for pid, p in zip(ids, params):
        st = saved.get("state", {}).get(pid, {})
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st and tuple(st[k].shape) != tuple(p.shape):
                return False
    return True


def tolerant_merge(template, loaded):
    """Model.load semantics: skip shape mismatches, keep the template for
    missing keys, drop unknown keys (dg_ae_model_mig.py:148-162). A merged
    leaf is a tensor on the template leaf's device."""
    if isinstance(template, dict):
        loaded = loaded if isinstance(loaded, dict) else {}
        return {k: tolerant_merge(tv, loaded[k]) if k in loaded else tv
                for k, tv in template.items()}
    if isinstance(template, (list, tuple)):
        if isinstance(loaded, dict):  # flax's msgpack stores lists as {'0': ..}
            loaded = [loaded.get(str(i)) for i in range(len(template))]
        loaded = loaded if isinstance(loaded, (list, tuple)) else []
        merged = [tolerant_merge(tv, loaded[i]) if i < len(loaded) and loaded[i] is not None
                  else tv for i, tv in enumerate(template)]
        return tuple(merged) if isinstance(template, tuple) else merged
    if loaded is None:
        return template
    arr = loaded if isinstance(loaded, torch.Tensor) else torch.as_tensor(np.asarray(loaded))
    if tuple(arr.shape) != tuple(np.shape(template)):
        return template  # shape-mismatch skip
    return arr.to(template.device) if isinstance(template, torch.Tensor) else arr
