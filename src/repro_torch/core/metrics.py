"""Pair-classification metrics: Precision / Recall / F1 / Accuracy / AP —
a numpy copy of `repro/core/metrics.py`.

Mirrors sentence-transformers' BinaryClassificationEvaluator, which is
what the paper's Figures 1-2 and Table 1 report: accuracy at the best
accuracy threshold, P/R/F1 at the best-F1 threshold, plus average
precision over the full ranking.  Implemented in numpy on host (metric
computation is not a device hot path).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _metrics_at(scores: np.ndarray, labels: np.ndarray, thr: float):
    pred = scores >= thr
    tp = float(np.sum(pred & (labels == 1)))
    fp = float(np.sum(pred & (labels == 0)))
    fn = float(np.sum(~pred & (labels == 1)))
    tn = float(np.sum(~pred & (labels == 0)))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    accuracy = (tp + tn) / max(len(labels), 1)
    return precision, recall, f1, accuracy


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    order = np.argsort(-scores, kind="stable")
    lab = labels[order]
    n_pos = int(lab.sum())
    if n_pos == 0:
        return 0.0
    tp_cum = np.cumsum(lab)
    k = np.arange(1, len(lab) + 1)
    precision_at_k = tp_cum / k
    return float(np.sum(precision_at_k * lab) / n_pos)


def pair_classification_metrics(scores, labels) -> Dict[str, float]:
    """scores: cosine similarities (N,); labels: 0/1 (N,).

    Returns {precision, recall, f1, accuracy, ap, f1_threshold,
    acc_threshold} with thresholds chosen on this set (the evaluator
    convention used by the paper's numbers).
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.int32)
    assert scores.shape == labels.shape

    # candidate thresholds: midpoints between sorted unique scores
    uniq = np.unique(scores)
    if len(uniq) > 1:
        cands = np.concatenate([[uniq[0] - 1e-6],
                                (uniq[:-1] + uniq[1:]) / 2,
                                [uniq[-1] + 1e-6]])
    else:
        cands = uniq
    best_f1, best_f1_thr = -1.0, 0.0
    best_acc, best_acc_thr = -1.0, 0.0
    best_p, best_r = 0.0, 0.0
    for thr in cands:
        p, r, f1, acc = _metrics_at(scores, labels, thr)
        if f1 > best_f1:
            best_f1, best_f1_thr, best_p, best_r = f1, float(thr), p, r
        if acc > best_acc:
            best_acc, best_acc_thr = acc, float(thr)
    return {
        "precision": best_p,
        "recall": best_r,
        "f1": best_f1,
        "accuracy": best_acc,
        "ap": average_precision(scores, labels),
        "f1_threshold": best_f1_thr,
        "acc_threshold": best_acc_thr,
    }


def metrics_at_threshold(scores, labels, threshold: float) -> Dict[str, float]:
    """Fixed-threshold metrics — what a deployed cache actually sees."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.int32)
    p, r, f1, acc = _metrics_at(scores, labels, threshold)
    return {"precision": p, "recall": r, "f1": f1, "accuracy": acc,
            "threshold": threshold}
