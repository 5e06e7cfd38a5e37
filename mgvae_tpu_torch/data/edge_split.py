"""Edge train/val/test splitting.

Functional rebuild of DG_VAE/deepgate/preprocessing.py. On the reference's
live path this is called with ratios 0, making it a pure shuffle that still
allocates an O(N^2) ``train_neg_adj_mask`` (SURVEY.md §8 quirk 7) — the
training pipeline here elides that no-op entirely. These functions exist for
the experiment workflows that DO split edges, with the dense mask replaced
by rejection-sampled negative edges (O(samples), not O(N^2)).

All functions take/return numpy arrays; edges are [2, E] (src, dst).
"""
from __future__ import annotations

import numpy as np


def general_train_test_split_edges(edge_index, num_nodes, val_ratio=0.0, test_ratio=0.0,
                                   directed=True, rng=None):
    """preprocessing.py:8-83 semantics: permute edges, carve val/test
    prefixes, sample matching negative sets. Returns a dict."""
    rng = rng or np.random.default_rng()
    edge_index = np.asarray(edge_index).reshape(2, -1)
    row, col = edge_index
    if not directed:
        mask = row < col
        row, col = row[mask], col[mask]
    e = row.shape[0]
    n_v = int(np.floor(val_ratio * e))
    n_t = int(np.floor(test_ratio * e))
    perm = rng.permutation(e)
    row, col = row[perm], col[perm]

    out = {
        "val_pos_edge_index": np.stack([row[:n_v], col[:n_v]]),
        "test_pos_edge_index": np.stack([row[n_v : n_v + n_t], col[n_v : n_v + n_t]]),
        "train_pos_edge_index": np.stack([row[n_v + n_t :], col[n_v + n_t :]]),
    }
    if not directed:
        tp = out["train_pos_edge_index"]
        out["train_pos_edge_index"] = np.concatenate([tp, tp[::-1]], axis=1)

    neg = sample_negative_edges(edge_index, num_nodes, n_v + n_t, directed=directed, rng=rng)
    out["val_neg_edge_index"] = neg[:, :n_v]
    out["test_neg_edge_index"] = neg[:, n_v : n_v + n_t]
    return out


def sample_negative_edges(edge_index, num_nodes, num_samples, directed=True, rng=None):
    """Rejection sampling of non-edges (replaces the N x N neg_adj_mask)."""
    rng = rng or np.random.default_rng()
    existing = set(map(tuple, np.asarray(edge_index).reshape(2, -1).T.tolist()))
    out = []
    attempts = 0
    while len(out) < num_samples and attempts < 50 * max(num_samples, 1) + 100:
        attempts += 1
        u = int(rng.integers(num_nodes))
        v = int(rng.integers(num_nodes))
        if u == v:
            continue
        if not directed and u > v:
            u, v = v, u
        if (u, v) in existing:
            continue
        existing.add((u, v))
        out.append((u, v))
    return np.asarray(out, dtype=np.int64).reshape(-1, 2).T


def biased_train_test_split_edges(edge_index, num_nodes, val_ratio=0.05, test_ratio=0.10, rng=None):
    """preprocessing.py:86+ capability: negatives biased toward reversed
    positives (hard negatives for directed reconstruction)."""
    rng = rng or np.random.default_rng()
    out = general_train_test_split_edges(edge_index, num_nodes, val_ratio, test_ratio, rng=rng)
    for split in ("val", "test"):
        pos = out[f"{split}_pos_edge_index"]
        if pos.size:
            rev = pos[::-1]
            k = rev.shape[1]
            neg = out[f"{split}_neg_edge_index"]
            take = min(k, neg.shape[1]) // 2
            if take:
                neg = np.concatenate([rev[:, :take], neg[:, take:]], axis=1)
                out[f"{split}_neg_edge_index"] = neg
    return out


def bidirectional_train_test_split_edges(edge_index, num_nodes, val_ratio=0.05, test_ratio=0.10, rng=None):
    """preprocessing.py:146+ capability: splits treating each edge and its
    reverse as one unit."""
    rng = rng or np.random.default_rng()
    und = np.unique(np.sort(np.asarray(edge_index).reshape(2, -1).T, axis=1), axis=0).T
    out = general_train_test_split_edges(und, num_nodes, val_ratio, test_ratio, directed=False, rng=rng)
    return out
