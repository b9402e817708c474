"""FlatSearcher: exact top-k retrieval on the card (the counterpart of
`recommendflow_tpu/retrieval/flat.py:TpuSearcher`).

  * items live on the device as a [N_pad, D] f32 matrix, zero-padded to a
    block multiple (padded rows score NEG);
  * search streams query blocks through one of three exact paths, picked by
    corpus size exactly as the JAX package picks them:
      - hierarchical tournament (large corpora): grouped_score_max
        (ops/cuda/grouped_topk.py) computes the per-16-item group maxima
        without writing the [Q, N] score matrix, then `_tournament_select`
        rescoring the winning groups;
      - single-level group-max prune (mid-size corpora);
      - plain matmul + top-k (small corpora);
  * cos = L2-normalize then ip; l2 ranks by the surrogate 2q·v − ‖v‖² and
    reports the real distance;
  * the six distance metrics (l1, l_inf, l_p, brayCurtis, canberra,
    jensen_shannon) scan query and item blocks of pairwise distances and
    return them ascending, FAISS-style;
  * save/load write and read the JAX package's `.npz` keys, so an index
    crosses between the two packages; a pickle keeps the device by name and
    restores onto it.
"""
from __future__ import annotations

import pickle
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.ops.cuda.grouped_topk import grouped_score_max
from recommendflow_tpu_torch.retrieval import _kernels
from recommendflow_tpu_torch.retrieval._kernels import (
    NEG, _DISTANCE_METRICS, _GROUP, _SUPERGROUP, _l2_from_surrogate,
    _l2_normalize, _make_pairwise_distance, _to_host, _tournament_select,
    resolve_metric)
from recommendflow_tpu_torch.utils.profiling import span

# the [Qb, nb, D] f32 temporary of a distance block stays under ~256 MB
_DISTANCE_TEMP_ELEMS = 1 << 26


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


class FlatSearcher:
    """Exact top-k searcher over an item embedding matrix.

    metric : 'ip' | 'cos' | 'l2' (matmul family), or a distance metric 'l1' |
             'l_inf' | 'l_p' | 'brayCurtis' | 'canberra' | 'jensen_shannon'
             (returned ascending), or a raw FAISS MetricType int.
    metric_arg : p of 'l_p' (sum|x-y|^p, no 1/p root: the FAISS formula).
    items  : optional identifier array aligned with the vectors (returned by
             search).
    device : where the corpus lives and the search runs (default "cuda";
             raises without a card unless "cpu" is asked for).
    """

    SUPPORTED_METRICS = ("ip", "cos", "l2") + _DISTANCE_METRICS

    def __init__(self, dim: int, metric: Union[str, int] = "cos",
                 query_block: int = 4096, pad_multiple: int = 512,
                 metric_arg: float = 3.0,
                 device: Union[str, torch.device] = "cuda"):
        metric = resolve_metric(metric)
        if metric not in self.SUPPORTED_METRICS:
            raise ValueError(f"metric '{metric}' not in {self.SUPPORTED_METRICS}")
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = metric
        self.metric_arg = float(metric_arg)
        self.query_block = query_block
        self.pad_multiple = pad_multiple
        self.items: Optional[np.ndarray] = None
        self._vecs: Optional[torch.Tensor] = None       # [N_pad, D]
        self._sq_norms: Optional[torch.Tensor] = None   # [N_pad], l2 only
        self.num_items = 0
        self._search_fn = {}

    # --------------------------------------------------------------- build
    def _prepare(self, vectors) -> np.ndarray:
        """[N, dim] f32 vectors, L2-normalized for cos."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}] vectors, got {vectors.shape}")
        return _l2_normalize(vectors) if self.metric == "cos" else vectors

    def train(self, vectors: np.ndarray, items: Optional[Sequence[Any]] = None):
        """Load the item corpus (FAISS naming: exact search needs no
        training). Replaces any earlier corpus."""
        vectors = self._prepare(vectors)
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
        existing = _to_host(self._vecs[:self.num_items])
        new_items = np.asarray(items) if items is not None else \
            np.arange(self.num_items, self.num_items + len(vectors))
        return self.train(np.concatenate([existing, vectors], axis=0),
                          items=np.concatenate([self.items, new_items]))

    # -------------------------------------------------------------- search
    def _is_empty(self) -> bool:
        """True when no corpus is loaded; subclasses that keep the corpus in
        another form (codes) override this."""
        return self._vecs is None

    def _build_search(self, k: int):
        metric = self.metric
        num_items = self.num_items
        n_pad = int(self._vecs.shape[0])
        dim = self.dim
        dev = self.device

        if metric in _DISTANCE_METRICS:
            # blocked pairwise distances: no matmul form exists for these,
            # and unlike XLA torch does not fuse the broadcast-sub-reduce, so
            # query and item blocks bound the [Qb, nb, D] temporary
            dist = _make_pairwise_distance(metric, self.metric_arg)
            nb = 512
            while n_pad % nb:          # pad_multiple is caller-configurable
                nb //= 2
            qb = max(1, _DISTANCE_TEMP_ELEMS // (nb * dim))

            def search_block(queries):
                out_s, out_i = [], []
                for q0 in range(0, queries.shape[0], qb):
                    qq = queries[q0:q0 + qb]
                    d = torch.cat([dist(qq, self._vecs[s:s + nb])
                                   for s in range(0, n_pad, nb)], dim=1)
                    d[:, num_items:] = -NEG
                    top, idx = torch.topk(-d, k, dim=1)
                    out_s.append(-top)
                    out_i.append(idx)
                return torch.cat(out_s), torch.cat(out_i)

            return search_block

        def raw_scores(queries):
            if metric == "l2":
                scores = 2.0 * (queries @ self._vecs.T) - self._sq_norms[None, :]
            else:
                scores = queries @ self._vecs.T
            scores[:, num_items:] = NEG
            return scores

        def finish(queries, top_scores, top_idx):
            if metric == "l2":
                top_scores = _l2_from_surrogate(queries, top_scores)
            return top_scores, top_idx

        G, G2 = _GROUP, _SUPERGROUP
        if n_pad % (G * G2) == 0 and n_pad // (G * G2) > max(k, 64) \
                and n_pad >= _kernels._HIER_MIN_ITEMS:
            # hierarchical tournament: grouped_score_max forms the group
            # maxima, so the [Q, N] score matrix never reaches device memory
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
        a list); items omitted when return_items=False. Spans: `search`,
        `search.normalise`, then per query block
        `search.copy_in` and `search.launch`, `search.fetch` (the results
        to the host) and `search.items`."""
        if self._is_empty():
            raise RuntimeError("searcher is empty — call train(vectors) first")
        ks = sorted({int(k) for k in (topk if isinstance(topk, (list, tuple))
                                      else [topk])})
        k_max = min(max(ks), self.num_items)
        with span("search"):
            with span("search.normalise"):
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
                    with span("search.copy_in"):
                        q = torch.from_numpy(queries[
                            start:start + self.query_block]).to(self.device)
                    with span("search.launch"):
                        s, i = fn(q)
                    scores.append(s)
                    idx.append(i)
            with span("search.fetch"):
                scores = torch.cat(scores).cpu().numpy()
                idx = torch.cat(idx).cpu().numpy()

            def slice_k(arr):
                return arr if len(ks) == 1 else {k: arr[:, :k] for k in ks}

            if return_items and self.items is not None:
                with span("search.items"):
                    items = slice_k(self.items[idx])
                return items, slice_k(scores), slice_k(idx)
            return slice_k(scores), slice_k(idx)

    # ------------------------------------------------------------- persist
    def save(self, path: str):
        """The JAX package's `.npz` keys (vecs, items, dim, metric)."""
        if self._vecs is None:
            raise RuntimeError("nothing to save")
        np.savez_compressed(path, vecs=_to_host(self._vecs[:self.num_items]),
                            items=self.items, dim=self.dim, metric=self.metric)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"
             ) -> "FlatSearcher":
        data = np.load(_npz_path(path), allow_pickle=True)
        s = cls(int(data["dim"]), str(data["metric"]), device=device)
        # cos vectors were saved normalized; train() re-normalizes (no-op)
        return s.train(data["vecs"], items=data["items"])

    def __getstate__(self):
        """Tensors as numpy and the device by name; the search closures are
        rebuilt after unpickling."""
        state = self.__dict__.copy()
        state["device"] = str(self.device)
        state["_vecs"] = _to_host(self._vecs[:self.num_items]) \
            if self._vecs is not None else None
        state["_sq_norms"] = None
        state["_search_fn"] = {}
        return state

    def __setstate__(self, state):
        vecs = state.pop("_vecs")
        self.__dict__.update(state)
        # raises where the recorded device is absent: no quiet move to the CPU
        self.device = resolve_device(state["device"])
        self._vecs = None
        if vecs is not None:
            self.train(vecs, items=state.get("items"))

    def dump(self, path: str):
        """Whole-searcher pickle."""
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def load_pickle(cls, path: str) -> "FlatSearcher":
        with open(path, "rb") as f:
            return pickle.load(f)
