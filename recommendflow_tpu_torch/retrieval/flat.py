"""FlatSearcher: exact top-k retrieval on the card (the counterpart of
`recommendflow_tpu/retrieval/flat.py:TpuSearcher`, metrics ip / cos / l2).

  * items live on the device as a [N_pad, D] f32 matrix, zero-padded to a
    block multiple (padded rows score NEG);
  * search streams query blocks through one of three exact paths, picked by
    corpus size exactly as the JAX package picks them:
      - hierarchical tournament (large corpora): kernel 2
        (ops/cuda/grouped_topk.py) computes the per-16-item group maxima
        without writing the [Q, N] score matrix, then `_tournament_select`
        rescoring the winning groups;
      - single-level group-max prune (mid-size corpora);
      - plain matmul + top-k (small corpora);
  * cos = L2-normalize then ip; l2 ranks by the surrogate 2q·v − ‖v‖² and
    reports the real distance.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.ops.cuda.grouped_topk import grouped_score_max
from recommendflow_tpu_torch.retrieval import _kernels
from recommendflow_tpu_torch.retrieval._kernels import (
    NEG, _GROUP, _SUPERGROUP, _l2_normalize, _tournament_select,
    resolve_metric)


class FlatSearcher:
    """Exact top-k searcher over an item embedding matrix.

    metric : 'ip' | 'cos' | 'l2', or a raw FAISS MetricType int for those.
    items  : optional identifier array aligned with the vectors (returned by
             search).
    device : where the corpus lives and the search runs (default "cuda";
             raises without a card unless "cpu" is asked for).
    """

    SUPPORTED_METRICS = ("ip", "cos", "l2")

    def __init__(self, dim: int, metric: Union[str, int] = "cos",
                 query_block: int = 4096, pad_multiple: int = 512,
                 device: Union[str, torch.device] = "cuda"):
        metric = resolve_metric(metric)
        if metric not in self.SUPPORTED_METRICS:
            raise ValueError(f"metric '{metric}' not in {self.SUPPORTED_METRICS}"
                             f" (the distance metrics come in a later slice)")
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = metric
        self.query_block = query_block
        self.pad_multiple = pad_multiple
        self.items: Optional[np.ndarray] = None
        self._vecs: Optional[torch.Tensor] = None       # [N_pad, D]
        self._sq_norms: Optional[torch.Tensor] = None   # [N_pad], l2 only
        self.num_items = 0
        self._search_fn = {}

    # --------------------------------------------------------------- build
    def train(self, vectors: np.ndarray, items: Optional[Sequence[Any]] = None):
        """Load the item corpus (FAISS naming: exact search needs no
        training). Replaces any earlier corpus."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}] vectors, got {vectors.shape}")
        if self.metric == "cos":
            vectors = _l2_normalize(vectors)
        self.num_items = len(vectors)
        # large corpora pad to the top-k chunk size so the group reshapes
        # divide the item axis evenly
        pad_to = 65536 if self.num_items > 131072 else self.pad_multiple
        n_pad = -(-self.num_items // pad_to) * pad_to
        padded = torch.zeros((n_pad, self.dim), dtype=torch.float32,
                             device=self.device)
        padded[:self.num_items] = torch.from_numpy(vectors).to(self.device)
        self._vecs = padded
        self._sq_norms = None
        if self.metric == "l2":
            sq = torch.full((n_pad,), float("inf"), dtype=torch.float32,
                            device=self.device)
            sq[:self.num_items] = torch.from_numpy(
                (vectors ** 2).sum(-1)).to(self.device)
            self._sq_norms = sq
        self.items = np.asarray(items) if items is not None \
            else np.arange(self.num_items)
        self._search_fn = {}
        return self

    def add(self, vectors: np.ndarray, items=None):
        """APPEND vectors to the corpus (FAISS index.add semantics)."""
        vectors = np.asarray(vectors, np.float32)
        if self._vecs is None:
            return self.train(vectors, items)
        existing = self._vecs[:self.num_items].cpu().numpy()
        new_items = np.asarray(items) if items is not None else \
            np.arange(self.num_items, self.num_items + len(vectors))
        return self.train(np.concatenate([existing, vectors], axis=0),
                          items=np.concatenate([self.items, new_items]))

    # -------------------------------------------------------------- search
    def _build_search(self, k: int):
        metric = self.metric
        num_items = self.num_items
        n_pad = int(self._vecs.shape[0])
        dim = self.dim
        dev = self.device

        def raw_scores(queries):
            if metric == "l2":
                scores = 2.0 * (queries @ self._vecs.T) - self._sq_norms[None, :]
            else:
                scores = queries @ self._vecs.T
            scores[:, num_items:] = NEG
            return scores

        def finish(queries, top_scores, top_idx):
            if metric == "l2":
                # the 2q·v − ‖v‖² surrogate back to the real L2 distance
                q_sq = torch.sum(queries ** 2, dim=-1, keepdim=True)
                top_scores = torch.sqrt(torch.clamp(q_sq - top_scores, min=0.0))
            return top_scores, top_idx

        G, G2 = _GROUP, _SUPERGROUP
        if n_pad % (G * G2) == 0 and n_pad // (G * G2) > max(k, 64) \
                and n_pad >= _kernels._HIER_MIN_ITEMS:
            # hierarchical tournament: kernel 2 forms the group maxima, so
            # the [Q, N] score matrix never reaches device memory
            vecs_g = self._vecs.view(n_pad // G, G, dim)
            sqn_g = self._sq_norms.view(n_pad // G, G) \
                if self._sq_norms is not None else None

            def search_block(queries):
                m1 = grouped_score_max(
                    queries, self._vecs,
                    self._sq_norms if metric == "l2" else None,
                    group=G, num_items=num_items)
                return finish(queries, *_tournament_select(
                    queries, m1, vecs_g, sqn_g, k, k, num_items, metric))

        elif n_pad % G == 0 and n_pad // G > 4 * k and n_pad > 262144:
            def search_block(queries):
                # single-level group-max prune (mid-size corpora)
                nq = queries.shape[0]
                scores = raw_scores(queries)
                gmax = scores.view(nq, n_pad // G, G).amax(dim=-1)
                gidx = torch.topk(gmax, k, dim=1).indices           # [Q, k]
                member = gidx[:, :, None] * G + torch.arange(G, device=dev)
                cand_idx = member.reshape(nq, k * G)
                cand_s = torch.gather(scores, 1, cand_idx)
                top_scores, pos = torch.topk(cand_s, k, dim=1)
                return finish(queries, top_scores,
                              torch.gather(cand_idx, 1, pos))

        else:
            def search_block(queries):
                top_scores, top_idx = torch.topk(raw_scores(queries), k, dim=1)
                return finish(queries, top_scores, top_idx)

        return search_block

    def search(self, queries: np.ndarray,
               topk: Union[int, Sequence[int]] = 10,
               return_items: bool = True):
        """Top-k per query. topk may be a list: results are computed at
        max(topk) and sliced per k.

        Returns (items, scores, indices) numpy arrays [Q, k] (dicts by k for
        a list); items omitted when return_items=False."""
        if self._vecs is None:
            raise RuntimeError("searcher is empty — call train(vectors) first")
        ks = sorted({int(k) for k in (topk if isinstance(topk, (list, tuple))
                                      else [topk])})
        k_max = min(max(ks), self.num_items)
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if self.metric == "cos":
            queries = _l2_normalize(queries)
        fn = self._search_fn.get(k_max)
        if fn is None:
            fn = self._search_fn[k_max] = self._build_search(k_max)

        scores, idx = [], []
        with torch.no_grad():
            for start in range(0, len(queries), self.query_block):
                q = torch.from_numpy(
                    queries[start:start + self.query_block]).to(self.device)
                s, i = fn(q)
                scores.append(s)
                idx.append(i)
        scores = torch.cat(scores).cpu().numpy()
        idx = torch.cat(idx).cpu().numpy()

        def slice_k(arr):
            return arr if len(ks) == 1 else {k: arr[:, :k] for k in ks}

        if return_items and self.items is not None:
            return slice_k(self.items[idx]), slice_k(scores), slice_k(idx)
        return slice_k(scores), slice_k(idx)
