"""Checkpoint save and restore in the port's own format.

The logical contract of ``mgvae_tpu/utils/checkpoint.py``: a payload of
``epoch``, ``lr``, ``params``, ``state`` and the optimizer state, written
atomically (``.tmp``, then ``os.replace``), and a tolerant restore with the
reference ``Model.load`` semantics (dg_ae_model_mig.py:148-162). Files keep
the reference's ``model_last.pth`` naming.

Serialised with ``torch.save``; read with ``torch.load(...,
weights_only=True)``, which executes no pickled code (the JAX package's
reason for msgpack). The optimizer state is ``optimizer.state_dict()``,
whose parameter ids follow ``train.step.param_leaves`` (sorted keys), so
they are stable across processes.

A file in another format (a JAX msgpack checkpoint, a reference ``.pth``
state dict) raises ``ValueError``: readers for those wait for ROADMAP 1.8.
"""
from __future__ import annotations

import os
import pickle
import zipfile

import numpy as np
import torch

_ZIP_MAGIC = b"PK\x03\x04"    # torch.save's format


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


def _foreign(path: str, what: str) -> ValueError:
    return ValueError(
        f"{path}: {what}, not a checkpoint of mgvae_tpu_torch (torch.save of "
        "{epoch, lr, params, state, optimizer}); readers of other formats "
        "are ROADMAP 1.8")


def _read(path: str, device) -> dict:
    """The raw payload of a checkpoint of this package, tensors on
    ``device``. Raises ValueError for any other format."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head != _ZIP_MAGIC:
        # msgpack maps start with 0x80-0x8f (fixmap), 0xde or 0xdf
        msgpack = bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))
        raise _foreign(path, "a JAX msgpack checkpoint (mgvae_tpu.utils.checkpoint)"
                       if msgpack else "an unknown format")
    try:
        raw = torch.load(path, map_location=device, weights_only=True)
    except (pickle.UnpicklingError, zipfile.BadZipFile, RuntimeError) as e:
        raise _foreign(path, f"a torch file this package cannot read ({e})") from e
    if not isinstance(raw, dict) or "params" not in raw:
        raise _foreign(path, "a torch file with no 'params' key (a reference .pth "
                             "state dict?)")
    return raw


def load_checkpoint(path: str, params, state, optimizer, device):
    """Restore into the given templates, tensors on ``device``; returns
    (epoch, lr, params, state).

    ``params`` and ``state`` are merged by ``tolerant_merge`` (new trees;
    the caller copies them where it needs them in place). ``optimizer``, when
    given, gets the saved state through ``load_state_dict``, its ``step``
    counts kept on the CPU as torch keeps them; a saved state that does not
    fit it (other groups or shapes) leaves it as it was, like the JAX
    package's tolerance of optimizer-layout drift."""
    raw = _read(path, device)
    new_params = tolerant_merge(params, raw["params"])
    new_state = tolerant_merge(state, raw["state"])
    saved = raw.get("optimizer")
    if optimizer is not None and saved:
        for st in saved.get("state", {}).values():
            if isinstance(st.get("step"), torch.Tensor):
                st["step"] = st["step"].cpu()
        if _fits(optimizer, saved):
            optimizer.load_state_dict(saved)
        else:
            print(f"[WARN] {path}: optimizer state does not fit this model; kept fresh")
    return int(raw["epoch"]), float(raw["lr"]), new_params, new_state


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
