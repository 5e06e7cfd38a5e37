"""Evaluation metrics, numpy-only (replaces the sklearn dependency the
reference pulls in for GAE.test, digae_model.py:5,156-168)."""
from __future__ import annotations

import numpy as np


def roc_auc_score(y_true, y_score) -> float:
    """Rank-statistic AUC with tie handling (matches sklearn on untied and
    tied inputs)."""
    y_true = np.asarray(y_true).astype(bool).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc_score needs both classes present")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(y_score.size, dtype=np.float64)
    sorted_scores = y_score[order]
    # average ranks over ties
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return float((ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def average_precision_score(y_true, y_score) -> float:
    """AP = sum_n (R_n - R_{n-1}) * P_n (sklearn definition)."""
    y_true = np.asarray(y_true).astype(np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    order = np.argsort(-y_score, kind="mergesort")
    y = y_true[order]
    tp = np.cumsum(y)
    n_pos = y_true.sum()
    if n_pos == 0:
        raise ValueError("average_precision_score needs positive samples")
    precision = tp / np.arange(1, len(y) + 1)
    recall = tp / n_pos
    # collapse threshold ties: keep last index of each distinct score
    scores_sorted = y_score[order]
    distinct = np.r_[scores_sorted[1:] != scores_sorted[:-1], True]
    precision, recall = precision[distinct], recall[distinct]
    prev_recall = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - prev_recall) * precision))


def confusion_counts(pred_bin, gt_bin):
    """acc/TP/FP/TN/FN fractions as in trainer.py:240-244."""
    pred_bin = np.asarray(pred_bin)
    gt_bin = np.asarray(gt_bin)
    n = max(len(pred_bin), 1)
    return {
        "acc": float((pred_bin == gt_bin).sum() / n),
        "TP": float(((pred_bin == 1) & (gt_bin == 1)).sum() / n),
        "FP": float(((pred_bin == 1) & (gt_bin == 0)).sum() / n),
        "TN": float(((pred_bin == 0) & (gt_bin == 0)).sum() / n),
        "FN": float(((pred_bin == 0) & (gt_bin == 1)).sum() / n),
    }
