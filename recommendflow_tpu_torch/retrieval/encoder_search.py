"""Encoder-attached search: raw text in, joined DataFrames out (the
counterpart of `recommendflow_tpu/retrieval/encoder_search.py`).

Construct with an encoder (anything exposing `.encode(list_of_texts) ->
[N, D]`, e.g. the port's TextEncoderService) and an items DataFrame whose
FIRST column holds the text to encode; `train()` encodes and indexes the
items; `search(texts, topK, keep_rank_no=...)` returns the exploded join
[source_item, sim_item, sim_val, (rank_no), *extra item columns]. With no
encoder, items is an [N, D] array and search returns (items, sims[,
indices]) arrays. topK may be a list: per-k results, filtered by rank_no.

The index underneath is `index_factory` (Flat, IVF, PQ, IVF-PQ, SQ), any
supported metric; extra keyword arguments (`device` among them) go to it.
pandas is imported only where a DataFrame is built.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from recommendflow_tpu_torch.retrieval.searcher import (
    _l2_normalize, _make_pairwise_distance, index_factory, resolve_metric)


class EncoderSearcher:
    def __init__(self,
                 encoder: Any = None,
                 items: Any = None,          # DataFrame (encoder) or ndarray
                 item_list: Optional[Sequence[Any]] = None,
                 index_param: str = "Flat",
                 measurement: Union[str, int] = "cos",
                 norm_vec: bool = False,
                 **kwargs):
        if encoder is not None and not hasattr(encoder, "encode"):
            raise AttributeError(
                "encoder must expose an encode(texts) -> [N, D] method")
        self.encoder = encoder
        if items is None:
            raise ValueError("items must be given")
        if encoder is None and not isinstance(items, np.ndarray):
            raise TypeError("without an encoder, items must be a [N, D] ndarray")
        if encoder is not None and not hasattr(items, "columns"):
            raise TypeError(
                "with an encoder, items must be a DataFrame whose first "
                "column holds the text to encode")
        if item_list is not None and len(item_list) != len(items):
            raise ValueError(
                f"len(item_list)={len(item_list)} != len(items)={len(items)}")
        self.items = items
        self.item_list = np.asarray(item_list) if item_list is not None else None
        self.index_param = index_param
        self.measurement = resolve_metric(measurement)
        # cos always normalizes; norm_vec forces it for other metrics
        self.norm_vec = True if self.measurement == "cos" else bool(norm_vec)
        self.kwargs = kwargs
        self.index = None
        self.vecs: Optional[np.ndarray] = None

    # --------------------------------------------------------------- build
    def _item_texts(self) -> List[str]:
        return list(self.items[self.items.columns[0]])

    def get_vecs(self, items) -> np.ndarray:
        if self.encoder is not None:
            vecs = np.asarray(self.encoder.encode(list(items)), np.float32)
        else:
            vecs = np.asarray(items, np.float32)
            if vecs.ndim != 2:
                raise ValueError(f"expected [N, D] vectors, got {vecs.shape}")
        return _l2_normalize(vecs) if self.norm_vec else vecs

    def train(self) -> "EncoderSearcher":
        src = self._item_texts() if self.encoder is not None else self.items
        self.vecs = self.get_vecs(src)
        # the index normalizes again under metric='cos' (idempotent)
        self.index = index_factory(self.vecs.shape[1], self.index_param,
                                   self.measurement, **self.kwargs)
        self.index.train(self.vecs)
        return self

    # -------------------------------------------------------------- search
    def _join(self, target: Sequence[str], indexes: np.ndarray,
              sims: np.ndarray, keep_rank_no: bool):
        """Explode per-query hits into the joined DataFrame (or the array
        tuple without an encoder)."""
        if self.encoder is None:
            ids = (self.item_list[indexes] if self.item_list is not None
                   else indexes)
            return (ids, sims, indexes) if keep_rank_no else (ids, sims)
        import pandas as pd
        q, k = indexes.shape
        out = pd.DataFrame({
            "source_item": np.repeat(np.asarray(target, object), k),
            "sim_val": sims.reshape(-1).astype(np.float32),
            "rank_no": np.tile(np.arange(k), q),
        })
        sim_item = self.items.iloc[indexes.reshape(-1)].reset_index(drop=True)
        sim_item.columns = ["sim_item"] + list(sim_item.columns[1:])
        clash = {"source_item", "sim_val", "rank_no"} & set(sim_item.columns)
        if clash:
            raise ValueError(
                f"items DataFrame columns {sorted(clash)} clash with the "
                "join's output columns — rename them before searching")
        res = pd.concat([out, sim_item], axis=1)
        if not keep_rank_no:
            res = res.drop(columns=["rank_no"])
        lead = ["source_item", "sim_item", "sim_val"] + (
            ["rank_no"] if keep_rank_no else [])
        rest = [c for c in res.columns if c not in lead]
        return res[lead + rest].reset_index(drop=True)

    def search(self, target: Union[Sequence[str], np.ndarray],
               topK: Union[int, List[int]] = 10, keep_rank_no: bool = False):
        if self.index is None:
            raise RuntimeError("searcher not trained — call train() before search")
        if isinstance(target, str):
            target = [target]          # not character by character
        qvecs = self.get_vecs(target)
        if isinstance(topK, int):
            sims, idx = self.index.search(qvecs, topK, return_items=False)
            return self._join(target, idx, sims, keep_rank_no)
        if isinstance(topK, (list, tuple)):
            sims, idx = self.index.search(qvecs, max(topK), return_items=False)
            res: Dict[int, Any] = {}
            if self.encoder is not None:
                full = self._join(target, idx, sims, keep_rank_no=True)
                for k in topK:
                    sub = full.query(f"rank_no < {k}").reset_index(drop=True)
                    res[k] = sub if keep_rank_no else sub.drop(
                        columns=["rank_no"])
            else:
                for k in topK:
                    ids = (self.item_list[idx[:, :k]]
                           if self.item_list is not None else idx[:, :k])
                    res[k] = ((ids, sims[:, :k], idx[:, :k]) if keep_rank_no
                              else (ids, sims[:, :k]))
            return res
        raise TypeError(f"topK does not support type: {type(topK)}")

    def cal_sim(self, item1: str, items2: List[str]):
        """Similarity of one item against a list, ranked as this searcher's
        metric ranks: dot product descending for ip/cos, distance ascending
        for l2 and the distance metrics."""
        import pandas as pd
        v1 = self.get_vecs([item1])
        v2 = self.get_vecs(items2)
        m = self.measurement
        if m in ("ip", "cos"):
            score, ascending = (v1 @ v2.T)[0], False
        elif m == "l2":
            score, ascending = np.linalg.norm(v2 - v1, axis=1), True
        else:
            dist = _make_pairwise_distance(
                m, float(self.kwargs.get("metric_arg", 3.0)))
            score = dist(torch.from_numpy(v1), torch.from_numpy(v2))[0].numpy()
            ascending = True
        df = pd.DataFrame({"item": items2, "score": score})
        return df.sort_values(
            "score", ascending=ascending).reset_index(drop=True)

    # ------------------------------------------------------------- persist
    def save_searcher(self, path: str):
        """Whole-searcher pickle. An encoder that cannot pickle is dropped
        with a warning (vector search keeps working on reload; text queries
        then need a fresh encoder attached)."""
        try:
            blob = pickle.dumps(self)
        except (pickle.PicklingError, TypeError, AttributeError):
            encoder, self.encoder = self.encoder, None
            try:
                blob = pickle.dumps(self)
            finally:
                self.encoder = encoder
            import warnings
            warnings.warn("EncoderSearcher: encoder is not picklable and "
                          "was omitted from the saved searcher")
        with open(path, "wb") as f:
            f.write(blob)

    @staticmethod
    def load_searcher(path: str) -> "EncoderSearcher":
        with open(path, "rb") as f:
            return pickle.load(f)
