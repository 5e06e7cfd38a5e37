"""Topological (longest-path) levelization of circuit DAGs.

A copy of ``mgvae_tpu/data/levelize.py``: the port's native library
(``mgvae_tpu_torch/native``) when it loads, else a numpy Kahn propagation
over in-degrees, O(V + E); the two give identical levels.

A node's level is the length of the longest path from any source to it, so
for every edge u->v ``level[u] < level[v]``: all message sources of a level
are final before the level runs, which the level scan relies on.
"""
from __future__ import annotations

import numpy as np


def levelize(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Longest-path level per node.

    Args:
      edge_index: [2, E] int array (src row 0, dst row 1).
      num_nodes: node count.
    Returns:
      [num_nodes] int32 levels (sources = 0).
    Raises:
      ValueError on cycles.
    """
    level = np.zeros(num_nodes, dtype=np.int32)
    if edge_index.size == 0:
        return level
    from ..native import levelize_native

    out = levelize_native(np.asarray(edge_index), num_nodes)
    if out is not None:
        return out
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    indeg = np.bincount(dst, minlength=num_nodes).astype(np.int64)

    # CSR of out-edges for frontier expansion
    order = np.argsort(src, kind="stable")
    src_sorted, dst_sorted = src[order], dst[order]
    out_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(src_sorted, minlength=num_nodes), out=out_ptr[1:])

    frontier = np.flatnonzero(indeg == 0)
    placed = frontier.size
    cur = 0
    while frontier.size:
        starts, ends = out_ptr[frontier], out_ptr[frontier + 1]
        counts = ends - starts
        total = int(counts.sum())
        if total == 0:
            break
        # flat indices of the frontier's out-edge block
        idx = np.repeat(starts, counts) + (
            np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        )
        children = dst_sorted[idx]
        np.subtract.at(indeg, children, 1)
        ready = np.unique(children[indeg[children] == 0])
        cur += 1
        level[ready] = cur
        frontier = ready
        placed += ready.size
    if placed != num_nodes and (indeg > 0).any():
        raise ValueError("levelize: graph contains a cycle")
    return level


def return_order_info(edge_index: np.ndarray, num_nodes: int):
    """API-parity port of dag_utils.return_order_info (dag_utils.py:80-88).

    Returns (forward_level, forward_index, backward_level, backward_index);
    the index arrays are arange(num_nodes) exactly as in the reference.
    """
    forward_level = levelize(edge_index, num_nodes)
    backward_level = levelize(np.stack([edge_index[1], edge_index[0]]) if edge_index.size else edge_index, num_nodes)
    idx = np.arange(num_nodes, dtype=np.int64)
    return forward_level, idx, backward_level, idx.copy()
