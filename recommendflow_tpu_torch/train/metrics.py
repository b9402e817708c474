"""Exact offline ranking metrics over host numpy arrays (AUC, AUPR,
recall at a precision floor), sklearn semantics
(backend/utils/eval_utils.py:33-82,270-293 of the reference system).
The streaming on-device accumulators arrive with the trainer.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Exact AUC via rank statistic (ties handled by average rank)."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score).ravel()
    pos = y_true > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _average_ranks(y_score)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks with ties averaged — fully vectorized (a python
    per-distinct-score loop here cost seconds per million rows on the
    evaluate() path)."""
    x = np.asarray(x).ravel()
    order = np.argsort(x, kind="mergesort")
    _, inv, counts = np.unique(x[order], return_inverse=True,
                               return_counts=True)
    ends = np.cumsum(counts).astype(np.float64)          # 1-based group ends
    starts = ends - counts + 1.0
    avg = (starts + ends) / 2.0                          # per distinct value
    ranks = np.empty(len(x), np.float64)
    ranks[order] = avg[inv]
    return ranks


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AUPR (average precision), computed over distinct score THRESHOLDS.

    Tied scores are one atomic operating point (sklearn semantics): the
    naive per-item cumsum credited positives by their arbitrary row order
    inside a tied run, so the same (label, score) multiset scored
    differently depending on eval-set row order — common in practice with
    float32 sigmoid saturation at 0.0/1.0."""
    # binarize like roc_auc: raw label VALUES in the cumsum would yield
    # precision/AP > 1 for weighted or soft labels
    y_true = (np.asarray(y_true).ravel() > 0.5).astype(np.float64)
    scores = np.asarray(y_score).ravel()
    order = np.argsort(-scores, kind="mergesort")
    y = y_true[order]
    s = scores[order]
    total_pos = y.sum()
    if total_pos == 0:
        return float("nan")
    cum_pos = np.cumsum(y)
    k = np.arange(1, len(y) + 1)
    last = np.empty(len(y), bool)            # last index of each tied run
    last[:-1] = s[:-1] > s[1:]
    last[-1] = True
    p_end = cum_pos[last] / k[last]          # precision at each threshold
    pos_in_run = np.diff(np.concatenate([[0.0], cum_pos[last]]))
    return float(np.sum(p_end * pos_in_run) / total_pos)


def recall_at_precision(y_true: np.ndarray, y_score: np.ndarray,
                        precision_floor: float = 0.6) -> Tuple[float, float]:
    """Max recall subject to precision >= floor, and the threshold achieving
    it (parity: eval_utils.py:270-293)."""
    y_true = (np.asarray(y_true).ravel() > 0.5).astype(np.float64)
    order = np.argsort(-np.asarray(y_score).ravel(), kind="mergesort")
    y = y_true[order]
    scores = np.asarray(y_score).ravel()[order]
    cum_pos = np.cumsum(y)
    k = np.arange(1, len(y) + 1)
    precision = cum_pos / k
    total_pos = max(y.sum(), 1e-12)
    recall = cum_pos / total_pos
    ok = precision >= precision_floor
    # the returned threshold is DEPLOYED as `score >= t`: a cut inside a
    # tied-score run admits the whole run, so only the last index of each
    # run is an achievable operating point
    achievable = np.empty(len(y), bool)
    achievable[:-1] = scores[:-1] > scores[1:]
    achievable[-1] = True
    ok &= achievable
    if not ok.any():
        return 0.0, float("inf")
    best = np.argmax(np.where(ok, recall, -1.0))
    return float(recall[best]), float(scores[best])
