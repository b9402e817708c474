"""IvfSearcher: IVF approximate search, FAISS 'IVF{n},Flat' (the
counterpart of `recommendflow_tpu/retrieval/ivf.py`).

A k-means coarse quantizer over a sample of the corpus and capped inverted
lists, probed per query:

  * the lists are a dense [nlist, M] matrix of item indices, -1 padded,
    M = cap_factor * N / nlist; items past their list's cap go to an
    overflow pool that every query scans exactly, so capping never loses
    recall silently;
  * search: centroid scores -> top nprobe lists -> their members' vectors
    gathered one probed list at a time ([Qb, M, D], the peak temporary) ->
    scores -> top-k over the candidates and the overflow pool. A k beyond
    the candidate pool pads with NEG scores and index 0, as FAISS pads
    with -1.

Recall depends on the data (clustered corpora probe well, isotropic ones do
not). No TPU kernel is on this path: the gathers and products are torch ops.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.retrieval._kernels import (
    NEG, _assign_blocks, _build_capped_lists, _l2_from_surrogate, _to_host,
    kmeans)
from recommendflow_tpu_torch.retrieval.flat import FlatSearcher, _npz_path


def _probe_lists(queries: torch.Tensor, centroids: torch.Tensor, metric: str,
                 nprobe: int):
    """(q·c [Q, nlist], the nprobe best lists [Q, P]): the metric's own score
    (2 q·c − ‖c‖² for l2)."""
    qc = queries @ centroids.T
    s = 2.0 * qc - torch.sum(centroids * centroids, dim=1)[None, :] \
        if metric == "l2" else qc
    return qc, torch.topk(s, nprobe, dim=1).indices


def _top_k_padded(s: torch.Tensor, cand: torch.Tensor, k: int):
    """Top-k of the candidate scores; a pool smaller than k pads with NEG
    scores and index 0 (in-pool -1 pads clamp to 0 as well)."""
    k_eff = min(k, s.shape[1])
    top, pos = torch.topk(s, k_eff, dim=1)
    idx = torch.clamp(torch.gather(cand, 1, pos), min=0)
    if k_eff < k:
        top = torch.nn.functional.pad(top, (0, k - k_eff), value=NEG)
        idx = torch.nn.functional.pad(idx, (0, k - k_eff))
    return top, idx


class IvfSearcher(FlatSearcher):
    """IVF approximate top-k (k-means coarse quantizer + capped inverted
    lists + overflow pool), with FAISS's nprobe attribute."""

    # quantized decode-and-score math assumes the matmul family
    SUPPORTED_METRICS = ("ip", "cos", "l2")

    def __init__(self, dim: int, metric: str = "cos", nlist: int = 1024,
                 nprobe: int = 8, query_block: int = 256,
                 cap_factor: float = 2.0, kmeans_iters: int = 10,
                 train_sample: int = 262144, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(dim, metric, query_block=query_block, device=device)
        self.nlist = nlist
        self.nprobe = nprobe
        self.cap_factor = cap_factor
        self.kmeans_iters = kmeans_iters
        self.train_sample = train_sample
        self.seed = seed
        self._centroids: Optional[torch.Tensor] = None  # [nlist, D]
        self._lists: Optional[torch.Tensor] = None      # [nlist, M] int64, -1 pad
        self._overflow: Optional[torch.Tensor] = None   # [O, D] scanned exactly
        self._overflow_idx: Optional[np.ndarray] = None  # [O] their indices

    # --------------------------------------------------------------- build
    def train(self, vectors: np.ndarray, items: Optional[Sequence[Any]] = None,
              centroids: Optional[np.ndarray] = None):
        """Index the corpus. The coarse quantizer is k-means over a sample of
        train_sample rows (drawn by numpy's RandomState(seed), as the JAX
        package draws it), or `centroids` [nlist, D] when given, e.g. carried
        from another index."""
        vectors = self._prepare(vectors)
        n = len(vectors)
        self.num_items = n
        self.items = np.asarray(items) if items is not None else np.arange(n)
        self.nlist = max(1, min(self.nlist, n))

        # one corpus upload; row n stays zero for the -1 pads of the lists
        vecs = torch.zeros((n + 1, self.dim), dtype=torch.float32,
                           device=self.device)
        vecs[:n] = torch.from_numpy(vectors).to(self.device)
        self._vecs = vecs
        if centroids is not None:
            centroids = np.array(centroids, np.float32)      # own copy
            if centroids.shape != (self.nlist, self.dim):
                raise ValueError(f"centroids {centroids.shape} are not "
                                 f"[{self.nlist}, {self.dim}]")
            self._centroids = torch.from_numpy(centroids).to(self.device)
        else:
            rng = np.random.RandomState(self.seed)
            sample = vecs[:n] if n <= self.train_sample else vecs[
                torch.from_numpy(rng.choice(n, self.train_sample,
                                            replace=False)).to(self.device)]
            self._centroids = kmeans(
                sample, self.nlist, iters=self.kmeans_iters, seed=self.seed,
                spherical=self.metric in ("cos", "ip"))

        assign = _assign_blocks(vecs, self._centroids, n)
        lists, ov = _build_capped_lists(assign, self.nlist, self.cap_factor)
        self._lists = torch.from_numpy(lists.astype(np.int64)).to(self.device)
        self._overflow_idx = ov
        self._overflow = vecs[torch.from_numpy(ov).to(self.device)]
        self._sq_norms = None
        if self.metric == "l2":
            sqn = torch.full((n + 1,), float("inf"), device=self.device)
            sqn[:n] = (vecs[:n] ** 2).sum(-1)
            self._sq_norms = sqn
        self._search_fn = {}
        return self

    def add(self, vectors, items=None):
        """Append = retrain the quantizer and the lists over the whole
        corpus (as the JAX package does)."""
        return super().add(vectors, items)

    # -------------------------------------------------------------- search
    def _build_search(self, k: int):
        metric = self.metric
        num_items = self.num_items
        vecs, lists, sqn = self._vecs, self._lists, self._sq_norms
        over, n_over = self._overflow, len(self._overflow_idx)
        over_idx = torch.from_numpy(self._overflow_idx.astype(np.int64)).to(
            self.device)

        def search_block(queries):
            nq = queries.shape[0]
            nprobe = min(self.nprobe, self.nlist)    # read at search time
            _, probe = _probe_lists(queries, self._centroids, metric, nprobe)
            cand = lists[probe]                                  # [Q, P, M]
            parts = []
            for p in range(nprobe):      # one probed list at a time: [Q, M, D]
                ids = cand[:, p]
                safe = torch.where(ids >= 0, ids, num_items)     # zero pad row
                sp = torch.bmm(vecs[safe], queries[:, :, None])[..., 0]
                if metric == "l2":
                    sp = 2.0 * sp - sqn[safe]
                parts.append(torch.where(ids >= 0, sp, NEG))
            s = torch.stack(parts, dim=1).reshape(nq, -1)
            cand = cand.reshape(nq, -1)
            if n_over:
                so = queries @ over.T
                if metric == "l2":
                    so = 2.0 * so - sqn[over_idx][None, :]
                s = torch.cat([s, so], dim=1)
                cand = torch.cat([cand, over_idx[None, :].expand(nq, n_over)],
                                 dim=1)
            top, idx = _top_k_padded(s, cand, k)
            if metric == "l2":
                top = _l2_from_surrogate(queries, top)
            return top, idx

        return search_block

    # ------------------------------------------------------------- persist
    def save(self, path: str):
        """The JAX package's `.npz` keys; the quantizer is rebuilt at load
        from the saved parameters, as there."""
        if self._vecs is None:
            raise RuntimeError("nothing to save")
        np.savez_compressed(
            path, vecs=_to_host(self._vecs[:self.num_items]),
            items=self.items, dim=self.dim, metric=self.metric,
            nlist=self.nlist, nprobe=self.nprobe, ivf=True,
            cap_factor=self.cap_factor, kmeans_iters=self.kmeans_iters,
            train_sample=self.train_sample, seed=self.seed)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"
             ) -> "IvfSearcher":
        data = np.load(_npz_path(path), allow_pickle=True)
        kw = {key: t(data[key]) for key, t in
              [("cap_factor", float), ("kmeans_iters", int),
               ("train_sample", int), ("seed", int)] if key in data}
        s = cls(int(data["dim"]), str(data["metric"]),
                nlist=int(data["nlist"]), nprobe=int(data["nprobe"]),
                device=device, **kw)
        return s.train(data["vecs"], items=data["items"])

    def __getstate__(self):
        """The corpus and the centroids: unpickling rebuilds the lists from
        the same quantizer."""
        state = super().__getstate__()
        state["_centroids"] = _to_host(self._centroids) \
            if self._centroids is not None else None
        state.update(_lists=None, _overflow=None, _overflow_idx=None)
        return state

    def __setstate__(self, state):
        vecs, centroids = state.pop("_vecs"), state.pop("_centroids")
        self.__dict__.update(state)
        self.device = resolve_device(state["device"])
        self._vecs = self._centroids = None
        if vecs is not None:
            self.train(vecs, items=state.get("items"), centroids=centroids)
