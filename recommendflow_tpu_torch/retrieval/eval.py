"""Retrieval evaluation: hit / MRR / NDCG @ K (the counterpart of
`recommendflow_tpu/retrieval/eval.py`), computed against FlatSearcher.

Rank-of-label extraction with a miss sentinel, batched search + eval and
report formatting, as backend/utils/eval_utils.py:85-220 of the reference
system.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from recommendflow_tpu_torch.retrieval.flat import FlatSearcher

MISS = 10 ** 14  # rank sentinel for "label not retrieved" (eval_utils.py:85-99)


def build_eval_corpus(q, d, y=None):
    """Dedup positive item vectors into an eval corpus.

    Rows are deduplicated by rounded item vector (byte-view np.unique);
    returns (corpus, labels, pos_mask) where labels[i] is the corpus index
    of the i-th POSITIVE row's item (aligned with q[pos_mask]) and
    pos_mask selects label > 0.5 rows (all rows when y is None).
    corpus is None when the eval set has no positives. The same dedup as
    the JAX package's, so both evaluate the same corpus.
    """
    q = np.asarray(q)
    pos = (np.asarray(y) > 0.5) if y is not None else np.ones(len(q), bool)
    if pos.sum() == 0:
        return None, None, pos
    d_pos = np.asarray(d)[pos]
    keys = np.ascontiguousarray(np.round(d_pos, 5)).view(
        [("", d_pos.dtype)] * d_pos.shape[1]).ravel()
    _, first_idx, inverse = np.unique(keys, return_index=True,
                                      return_inverse=True)
    return d_pos[first_idx], inverse, pos


def clamp_topk(topk_list: Sequence[int], num_items: int) -> List[int]:
    """Ks that fit the corpus; tiny corpora keep at least the smallest K
    (the searcher clamps internally) instead of crashing on an empty
    list. One definition shared by the in-fit evaluator and
    cli/evaluate so the degenerate-case semantics cannot drift."""
    return [k for k in topk_list if k <= num_items] or [min(topk_list)]


def click_ranks(recommended: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Rank (0-based) of each row's true label inside its recommendation list;
    MISS when absent (parity: get_click_index, eval_utils.py:85-99)."""
    hit = recommended == labels[:, None]
    found = hit.any(axis=1)
    ranks = np.where(found, hit.argmax(axis=1), MISS)
    return ranks.astype(np.int64)


def _weighted_mean(vals: np.ndarray, weights: Optional[np.ndarray]) -> float:
    """NaN (deliberately, not a 0/0 RuntimeWarning) when the total weight
    is zero — e.g. a group whose rows were all down-weighted to 0."""
    w = np.ones_like(vals, np.float64) if weights is None \
        else np.asarray(weights, np.float64)
    denom = np.sum(w)
    return float(np.sum(vals * w) / denom) if denom > 0 else float("nan")


def hit_at_k(ranks: np.ndarray, k: int, weights: Optional[np.ndarray] = None) -> float:
    return _weighted_mean((ranks < k).astype(np.float64), weights)


def mrr_at_k(ranks: np.ndarray, k: int, weights: Optional[np.ndarray] = None) -> float:
    return _weighted_mean(np.where(ranks < k, 1.0 / (ranks + 1.0), 0.0), weights)


def ndcg_at_k(ranks: np.ndarray, k: int, weights: Optional[np.ndarray] = None) -> float:
    """Single-relevant-item NDCG: DCG = 1/log2(rank+2), IDCG = 1."""
    return _weighted_mean(
        np.where(ranks < k, 1.0 / np.log2(ranks + 2.0), 0.0), weights)


def recall_metrics(ranks: np.ndarray,
                   topk_list: Sequence[int] = (5, 10, 50, 100, 200, 300),
                   weights: Optional[np.ndarray] = None) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k in topk_list:
        out[f"hit@{k}"] = hit_at_k(ranks, k, weights)
        out[f"mrr@{k}"] = mrr_at_k(ranks, k, weights)
        out[f"ndcg@{k}"] = ndcg_at_k(ranks, k, weights)
    return out


def batch_compute_recall_score(searcher: FlatSearcher,
                               query_vecs: np.ndarray,
                               label_items: np.ndarray,
                               topk_list: Sequence[int] = (5, 10, 50, 100, 200, 300),
                               weights: Optional[np.ndarray] = None,
                               batch_size: int = 8192) -> Dict[str, float]:
    """Search queries and score rank-of-label metrics (parity:
    eval_utils.py:120-147)."""
    k_max = max(topk_list)
    ranks = batch_click_ranks(searcher, query_vecs, label_items, k_max, batch_size)
    return recall_metrics(ranks, topk_list, weights)


def batch_click_ranks(searcher: FlatSearcher, query_vecs: np.ndarray,
                      label_items: np.ndarray, k_max: int,
                      batch_size: int = 8192) -> np.ndarray:
    ranks: List[np.ndarray] = []
    label_items = np.asarray(label_items)
    for start in range(0, len(query_vecs), batch_size):
        items, _, _ = searcher.search(query_vecs[start:start + batch_size],
                                      topk=int(k_max))
        ranks.append(click_ranks(np.asarray(items),
                                 label_items[start:start + batch_size]))
    return np.concatenate(ranks)


def recall_report(metrics: Dict[str, float],
                  topk_list: Sequence[int] = (5, 10, 50, 100, 200, 300)) -> str:
    """Aligned report string (parity: get_recall_eval_info,
    eval_utils.py:206-220)."""
    lines = [f"{'K':>6} {'hit':>10} {'mrr':>10} {'ndcg':>10}"]
    for k in topk_list:
        lines.append(f"{k:>6} {metrics.get(f'hit@{k}', 0):>10.4f} "
                     f"{metrics.get(f'mrr@{k}', 0):>10.4f} "
                     f"{metrics.get(f'ndcg@{k}', 0):>10.4f}")
    return "\n".join(lines)
