"""Threshold calibration for deployed caches.

The paper evaluates at the best-F1 threshold; a production cache
operator instead fixes a FALSE-HIT budget (serving a wrong answer is
much worse than a miss) and wants the loosest threshold that respects
it.  Given scored eval pairs, these utilities map an operating
constraint to a threshold with held-out estimates.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Calibration:
    threshold: float
    expected_precision: float
    expected_recall: float
    false_hit_rate: float      # P(score >= thr | negative)
    true_hit_rate: float       # P(score >= thr | positive)


def calibrate_for_precision(scores, labels, min_precision: float = 0.95
                            ) -> Calibration:
    """Loosest threshold whose eval precision >= min_precision.

    Candidate cuts are *distinct* score boundaries only: with tied
    scores, ``score >= thr`` admits every tie, so a cut landing inside
    a tie group would report cumulative stats the threshold cannot
    realize.  When no cut reaches ``min_precision`` (e.g. all-negative
    labels) the threshold is placed just above the top score — an
    empty, vacuously precise hit set — rather than a top-1 cut whose
    actual precision silently misses the target.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.int32)
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    lab = labels[order]
    tp = np.cumsum(lab)
    fp = np.cumsum(1 - lab)
    precision = tp / np.maximum(tp + fp, 1)
    n_pos = max(int(labels.sum()), 1)
    n_neg = max(int((1 - labels).sum()), 1)
    # a cut at i means thr = s[i]: only valid where s[i] > s[i+1]
    # (ties below i would be admitted too); the last row always is
    boundary = np.ones(len(s), bool)
    boundary[:-1] = s[:-1] > s[1:]
    ok = np.nonzero(boundary & (precision >= min_precision))[0]
    if len(ok) == 0:
        thr = float(s[0]) + 1e-9 if len(s) else 1.0  # admit nothing
        return Calibration(threshold=thr, expected_precision=1.0,
                           expected_recall=0.0, false_hit_rate=0.0,
                           true_hit_rate=0.0)
    i = ok[-1]
    return Calibration(
        threshold=float(s[i]),
        expected_precision=float(precision[i]),
        expected_recall=float(tp[i] / n_pos),
        false_hit_rate=float(fp[i] / n_neg),
        true_hit_rate=float(tp[i] / n_pos),
    )


def calibrate_for_false_hit_budget(scores, labels, max_false_hit_rate: float
                                   = 0.01) -> Calibration:
    """Loosest threshold with P(hit | negative) <= budget."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.int32)
    neg = np.sort(scores[labels == 0])
    n_neg = len(neg)
    pos = scores[labels == 1]
    if n_neg == 0:
        # no negatives observed: any threshold satisfies the budget, so
        # take the loosest one that still hits every positive
        thr = float(pos.min()) if len(pos) else 1.0
    else:
        # threshold just above the (1-budget) negative quantile
        idx = int(np.ceil((1.0 - max_false_hit_rate) * n_neg))
        thr = float(neg[min(idx, n_neg - 1)] + 1e-9)
    tp = float((pos >= thr).sum())
    fp = float((neg >= thr).sum())
    return Calibration(
        threshold=thr,
        expected_precision=tp / max(tp + fp, 1.0),
        expected_recall=tp / max(len(pos), 1),
        false_hit_rate=fp / max(n_neg, 1),
        true_hit_rate=tp / max(len(pos), 1),
    )
