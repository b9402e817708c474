"""Shared retrieval pieces: metric resolution and the tournament top-k
selector (the counterpart of `recommendflow_tpu/retrieval/_kernels.py`).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

NEG = -1e30

# tournament-pruned exact top-k parameters (see FlatSearcher._build_search):
# items are max-pooled in groups of _GROUP, group maxima in supergroups of
# _SUPERGROUP; the hierarchical path engages from _HIER_MIN_ITEMS padded items
_GROUP = 16
_SUPERGROUP = 16
_HIER_MIN_ITEMS = 262144

# FAISS MetricType enum values -> names (configs may pass the raw ints)
_FAISS_METRIC_INTS = {0: "ip", 1: "l2", 2: "l1", 3: "l_inf", 4: "l_p",
                      20: "canberra", 21: "brayCurtis", 22: "jensen_shannon"}


def _l2_normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def resolve_metric(measurement: Union[str, int]) -> str:
    """A metric name, or a raw FAISS MetricType int."""
    if isinstance(measurement, (int, np.integer)):
        if int(measurement) not in _FAISS_METRIC_INTS:
            raise ValueError(
                f"unknown FAISS MetricType int {measurement}; known: "
                f"{_FAISS_METRIC_INTS}")
        return _FAISS_METRIC_INTS[int(measurement)]
    return str(measurement)


def _tournament_select(queries: torch.Tensor, m1: torch.Tensor,
                       vecs_g: torch.Tensor, sqn_g: Optional[torch.Tensor],
                       k: int, select_k: int, valid: int, metric: str):
    """Two-level tournament select + exact vector rescore.

    m1      [Q, n_groups] per-group score maxima (masked by the caller).
    vecs_g  [n_groups, G, D] grouped corpus view; sqn_g [n_groups, G] squared
            norms (l2 only). Item indices >= valid score NEG at rescore.
    select_k >= k supergroups/groups survive each tournament level.

    Exactness: at most k groups can contain a top-k element and each such
    group's max is >= the k-th best score, so the top-select_k groups by max
    cover every top-k element, at any nesting depth. Full scores of the
    winning groups are re-computed from the gathered group vectors.
    Returns (top scores [Q, k], item indices [Q, k])."""
    nq = queries.shape[0]
    G2 = _SUPERGROUP
    G, dim = vecs_g.shape[1], vecs_g.shape[2]
    n_sg = m1.shape[1] // G2
    m1s = m1.reshape(nq, n_sg, G2)
    m2 = m1s.amax(dim=-1)
    sg = torch.topk(m2, select_k, dim=1).indices              # [Q, sk]
    c1 = torch.gather(m1s, 1, sg[:, :, None].expand(nq, select_k, G2))
    pos = torch.topk(c1.reshape(nq, select_k * G2), select_k, dim=1).indices
    gids = (sg[:, :, None] * G2 + torch.arange(G2, device=sg.device)
            ).reshape(nq, select_k * G2)
    gidx = torch.gather(gids, 1, pos)                         # [Q, sk] groups
    gv = vecs_g[gidx.reshape(-1)].reshape(nq, select_k, G, dim)
    cs = torch.einsum("qkgd,qd->qkg", gv.to(queries.dtype), queries)
    cand = (gidx[:, :, None] * G + torch.arange(G, device=gidx.device)
            ).reshape(nq, select_k * G)
    if metric == "l2":
        cs = 2.0 * cs - sqn_g[gidx.reshape(-1)].reshape(nq, select_k, G)
    cs = torch.where(cand.reshape(nq, select_k, G) < valid, cs,
                     torch.full_like(cs, NEG)).reshape(nq, select_k * G)
    top_scores, p2 = torch.topk(cs, k, dim=1)
    return top_scores, torch.gather(cand, 1, p2)
