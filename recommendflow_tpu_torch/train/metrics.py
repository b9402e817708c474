"""Metrics (the counterpart of `recommendflow_tpu/train/metrics.py`): the
streaming AUC, binned TP/FP/TN/FN counts that stay on the device of the
scores they are given (`AucState`, `auc_init`, `auc_update`, `auc_result`),
and exact offline metrics over host numpy arrays (AUC, AUPR, recall at a
precision floor, Spearman), sklearn semantics
(backend/utils/eval_utils.py:33-82,270-293 of the reference system).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from recommendflow_tpu_torch.device import resolve_device


class AucState(NamedTuple):
    """Binned TP/FP/TN/FN accumulators over score thresholds."""
    tp: torch.Tensor
    fp: torch.Tensor
    tn: torch.Tensor
    fn: torch.Tensor


def auc_init(num_thresholds: int = 200, device="cuda") -> AucState:
    """Zero counts on `device` (default "cuda"; raises without a card unless
    "cpu" is asked for)."""
    z = torch.zeros((num_thresholds,), dtype=torch.float32,
                    device=resolve_device(device))
    return AucState(z, z, z, z)


def _thresholds(n: int, device) -> torch.Tensor:
    # keras-style: [-eps, n-2 inner points, 1+eps] -> n thresholds total
    eps = 1e-7
    if n <= 2:
        return torch.tensor([-eps, 1.0 + eps], dtype=torch.float32,
                            device=device)
    inner = torch.linspace(0.0, 1.0, n, dtype=torch.float32,
                           device=device)[1:-1]
    edge = torch.tensor([-eps, 1.0 + eps], dtype=torch.float32, device=device)
    return torch.cat([edge[:1], inner, edge[1:]])


def auc_update(state: AucState, y_true: torch.Tensor, y_score: torch.Tensor,
               axis_name: Optional[str] = None) -> AucState:
    """Accumulate one batch (on the state's device, no host read); y_score
    in [0, 1] (sigmoid, or cosine rescaled). With `axis_name` (an axis of
    the current mesh, parallel/mesh.py) each rank passes its own rows and
    the batch's counts are summed over the axis (an all-reduce), so every
    rank's state counts the global batch."""
    # [B, 1] model outputs must not broadcast against [T, 1] thresholds
    y_true = torch.as_tensor(y_true, device=state.tp.device).reshape(-1)
    y_score = torch.as_tensor(y_score, device=state.tp.device).reshape(-1)
    thr = _thresholds(state.tp.shape[0], state.tp.device)[:, None]  # [T, 1]
    pred_pos = y_score[None, :] > thr                               # [T, B]
    pos = (y_true > 0.5)[None, :]
    tp = torch.sum(pred_pos & pos, dim=1, dtype=torch.float32)
    fp = torch.sum(pred_pos & ~pos, dim=1, dtype=torch.float32)
    tn = torch.sum(~pred_pos & ~pos, dim=1, dtype=torch.float32)
    fn = torch.sum(~pred_pos & pos, dim=1, dtype=torch.float32)
    if axis_name is not None:
        from recommendflow_tpu_torch.parallel.distributed import (
            all_reduce_nograd)
        from recommendflow_tpu_torch.parallel.mesh import axis_group
        group = axis_group(axis_name)[0]
        tp, fp, tn, fn = all_reduce_nograd(
            torch.stack([tp, fp, tn, fn]), group).unbind(0)
    return AucState(state.tp + tp, state.fp + fp, state.tn + tn,
                    state.fn + fn)


def auc_result(state: AucState) -> torch.Tensor:
    """ROC-AUC by trapezoidal interpolation over the threshold bins, a
    device scalar. NaN when the stream held only one class (roc_auc
    parity)."""
    tpr = state.tp / torch.clamp(state.tp + state.fn, min=1e-7)
    fpr = state.fp / torch.clamp(state.fp + state.tn, min=1e-7)
    # thresholds ascend -> fpr/tpr descend; integrate over fpr
    auc = torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)
    # tp+fn == total positives (constant across thresholds); idx 0 = -eps
    defined = (state.tp[0] + state.fn[0] > 0) & (state.fp[0] + state.tn[0] > 0)
    return torch.where(defined, auc, torch.full_like(auc, float("nan")))


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


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation (parity: eval_utils.py:79-82), with average
    ranks on ties (scipy.stats.spearmanr's semantics)."""
    ra, rb = _average_ranks(a), _average_ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else float("nan")
