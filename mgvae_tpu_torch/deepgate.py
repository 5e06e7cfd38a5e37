"""``import deepgate``-style shim of the port: the reference's names, every
one from this package.

Counterpart of the repository's ``deepgate/__init__.py`` (the reference's
DG_VAE/deepgate/__init__.py:1-11 and what its trainers export). As in the
reference, whose four ``from .dg_ae_model_* import Model`` lines shadow each
other, ``Model`` is the XAG model: ``api.Model`` defaults to
modality="xag". Use it as ``from mgvae_tpu_torch import deepgate``.
"""
import numpy as _np

from .api import Model  # noqa: F401
from .data.aiger import AigParser  # noqa: F401
from .data.batching import collate  # noqa: F401
from .data.bench import BenchParser  # noqa: F401
from .data.dataset import Dataset  # noqa: F401
from .data.graph import CircuitGraph, build_graph  # noqa: F401
from .data.levelize import levelize, return_order_info  # noqa: F401
from .data.npz import NpzParser  # noqa: F401
from .models.dg_ae import DGConfig  # noqa: F401
from .train.gradnorm import BalancerConfig, GradNormConfig  # noqa: F401
from .train.trainer import Trainer  # noqa: F401
from .train.trainer_balancer import BalancerTrainer  # noqa: F401
from .train.trainer_early_stop import EarlyTrainer  # noqa: F401
from .train.trainer_gradnorm import GradNormTrainer  # noqa: F401
from .utils.logger import AverageMeter, Logger  # noqa: F401


def parse_pyg_mlpgate(x, edge_index, y, tt_dis, tt_pair_index, num_gate_types=6):
    """Reference-signature graph constructor (parser_func.py:43 /
    parser_func_others.py:43): x is the [N, >=2] node table with gate ids in
    column 1; returns a CircuitGraph. Layout quirks (transposed vs raw
    edge/pair storage) must be resolved by the caller, exactly as in the
    reference where the two parser_func variants differ."""
    x = _np.asarray(x)
    return build_graph(
        "parsed",
        x[:, 1].astype(_np.int32),
        _np.asarray(edge_index).reshape(2, -1),
        _np.asarray(y, dtype=_np.float32).reshape(-1),
        _np.asarray(tt_pair_index).reshape(2, -1) if _np.asarray(tt_pair_index).size else None,
        _np.asarray(tt_dis, dtype=_np.float32).reshape(-1) if _np.asarray(tt_dis).size else None,
    )
