"""Segment (per-destination-group) reductions for message passing.

Counterpart of ``mgvae_tpu/ops/segment.py``: scatter-add aggregation and
PyG's segment ``softmax``. On CUDA ``index_add_`` and ``scatter_reduce_``
use atomics, so the order of a sum changes from run to run; every tolerance
that covers these ops on the card says so. ``segment_sum_ordered`` sums in
a fixed order on every device.
"""
from __future__ import annotations

import torch

# PyG's softmax adds 1e-16 to the normalizer
_SOFTMAX_EPS = 1e-16
_NEG_INF = -1e30


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets keyed by ``segment_ids``."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_sum_ordered(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """``segment_sum`` in a fixed order: ``index_put_`` with ``accumulate``,
    which on CUDA sorts the ids (stably) and sums each segment's rows in
    their order, with no atomics; two runs agree bit for bit."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_put_((segment_ids.long(),), data, accumulate=True)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment max of a 1-D ``data``; empty segments give -1e30."""
    out = data.new_full((num_segments,), _NEG_INF)
    return out.scatter_reduce_(0, segment_ids.long(), data, reduce="amax", include_self=True)


def segment_softmax(
    scores: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Softmax of ``scores`` within each segment, PyG semantics.

    Invalid entries are masked BEFORE the max and the exp, so padding never
    reaches ``exp`` and gets weight exactly 0; the normalizer gets +1e-16.
    The shift is clipped to [-80, 0] as in the level scan
    (``mgvae_tpu/models/dg_ae._level_scan_fast``): exp(-80) is 1.8e-35, so
    the clip changes no weight by more than that.

    Args:
      scores: [E] float scores.
      segment_ids: [E] int group ids (destination slots).
      num_segments: group count.
      valid: optional [E] bool mask.
    Returns:
      [E] weights, 0 on invalid entries.
    """
    if valid is not None:
        scores = torch.where(valid, scores, _NEG_INF)
    seg_max = segment_max(scores, segment_ids, num_segments)
    shifted = (scores - seg_max[segment_ids]).clamp(-80.0, 0.0)
    ex = torch.exp(shifted)
    if valid is not None:
        ex = ex * valid.to(ex.dtype)
    denom = segment_sum(ex, segment_ids, num_segments) + _SOFTMAX_EPS
    return ex / denom[segment_ids]
