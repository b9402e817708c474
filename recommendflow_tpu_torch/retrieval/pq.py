"""Product-quantized searchers, FAISS 'PQ{m}' and 'IVF{n},PQ{m}' (the
counterparts of `recommendflow_tpu/retrieval/pq.py`): the memory tier, for
corpora whose f32 vectors do not fit the card.

PqSearcher keeps uint8 codes [N, M] and per-subspace codebooks
[M, 256, D/M] (4·D/M x compression). Each item block decodes its codes
against the codebooks rounded to bf16, as the JAX package's one-hot bf16
decode does (a one-hot row selects one codebook entry, so a gather gives the
same values), scores the query block against it in f32, keeps a per-block
top-k, and the blocks' top-k are merged: the decoded corpus never exists
whole.

IvfPqSearcher codes the residual x − centroid[assign] inside an IVF coarse
quantizer (IVFADC). A probed list gathers its members' code rows and scores
them from per-query lookup tables lut[q, s, c] = q_s · codebook_s[c],
rounded to bf16 and summed in f32, plus the q·c coarse term; the overflow
pool is decoded in f32 at build and scanned exactly.

No TPU kernel is on these paths: the gathers and products are torch ops.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.retrieval._kernels import (
    NEG, _assign_blocks, _blocked_topk, _build_capped_lists,
    _l2_from_surrogate, _pq_decode_np, _pq_encode, _pq_train_codebooks,
    _to_host, kmeans)
from recommendflow_tpu_torch.retrieval.flat import FlatSearcher, _npz_path
from recommendflow_tpu_torch.retrieval.ivf import _probe_lists, _top_k_padded


def _sample(rng: np.random.RandomState, x, n: int, size: int):
    """All n rows, or `size` of them drawn without replacement."""
    return x if n <= size else x[rng.choice(n, size, replace=False)]


class PqSearcher(FlatSearcher):
    """Product-quantized top-k over uint8 codes (approximate scores, like
    FAISS PQ)."""

    # quantized decode-and-score math assumes the matmul family
    SUPPORTED_METRICS = ("ip", "cos", "l2")

    def __init__(self, dim: int, metric: str = "cos", num_subspaces: int = 8,
                 kmeans_iters: int = 10, train_sample: int = 131072,
                 item_block: int = 4096, query_block: int = 1024,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        super().__init__(dim, metric, query_block=query_block, device=device)
        if dim % num_subspaces != 0:
            raise ValueError(f"dim {dim} not divisible by num_subspaces "
                             f"{num_subspaces}")
        self.num_subspaces = num_subspaces
        self.kmeans_iters = kmeans_iters
        self.train_sample = train_sample
        self.item_block = item_block
        self.seed = seed
        self._codebooks: Optional[torch.Tensor] = None  # [M, 256, ds] f32
        self._codes: Optional[torch.Tensor] = None      # [N_pad, M] uint8

    # --------------------------------------------------------------- build
    def train(self, vectors: np.ndarray, items: Optional[Sequence[Any]] = None):
        vectors = self._prepare(vectors)
        n = len(vectors)
        self.num_items = n
        self.items = np.asarray(items) if items is not None else np.arange(n)
        rng = np.random.RandomState(self.seed)
        self._codebooks = _pq_train_codebooks(
            _sample(rng, vectors, n, self.train_sample), self.num_subspaces,
            self.kmeans_iters, self.seed, self.device)
        self._set_codes(_pq_encode(vectors, self._codebooks))
        return self

    def _set_codes(self, codes: np.ndarray):
        """Pad [N, M] uint8 codes to an item_block multiple (the padded slots
        are masked in the scan) and place them on the device."""
        n_pad = -(-len(codes) // self.item_block) * self.item_block
        padded = np.zeros((n_pad, self.num_subspaces), np.uint8)
        padded[:len(codes)] = codes
        self._codes = torch.from_numpy(padded).to(self.device)
        self._vecs = None            # no raw vectors on the device
        self._search_fn = {}

    def add(self, vectors, items=None):
        raise NotImplementedError(
            "PqSearcher.add: PQ drops the raw vectors after encoding, so an "
            "append cannot retrain the codebooks — rebuild with train() over "
            "the full corpus (FAISS PQ also requires train before add)")

    # -------------------------------------------------------------- search
    def _is_empty(self) -> bool:
        return self._codes is None

    def _build_search(self, k: int):
        metric = self.metric
        num_items = self.num_items
        bn = self.item_block
        codes = self._codes
        n_pad = int(codes.shape[0])
        cb16 = self._codebooks.to(torch.bfloat16).float()
        sub = torch.arange(self.num_subspaces, device=self.device)

        def block_scores(queries, start):
            dec = cb16[sub, codes[start:start + bn].long()].reshape(
                -1, self.dim)                                    # [Bn, D]
            s = queries @ dec.T
            if metric == "l2":
                s = 2.0 * s - torch.sum(dec * dec, dim=-1)[None, :]
            return s

        def search_block(queries):
            top, idx = _blocked_topk(lambda start: block_scores(queries, start),
                                     n_pad, bn, num_items, k)
            return (_l2_from_surrogate(queries, top) if metric == "l2"
                    else top), idx

        return search_block

    def reconstruct(self, indices) -> np.ndarray:
        """Decoded (approximate) vectors with the f32 codebooks (FAISS
        Index.reconstruct)."""
        codes = _to_host(self._codes)[np.asarray(indices)]
        return _pq_decode_np(codes, _to_host(self._codebooks))

    # ------------------------------------------------------------- persist
    def save(self, path: str):
        """The JAX package's `.npz` keys."""
        if self._codes is None:
            raise RuntimeError("nothing to save")
        np.savez_compressed(
            path, codes=_to_host(self._codes[:self.num_items]),
            codebooks=_to_host(self._codebooks), items=self.items,
            dim=self.dim, metric=self.metric, pq=True,
            num_subspaces=self.num_subspaces, item_block=self.item_block,
            query_block=self.query_block, seed=self.seed,
            kmeans_iters=self.kmeans_iters, train_sample=self.train_sample)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"
             ) -> "PqSearcher":
        data = np.load(_npz_path(path), allow_pickle=True)
        s = cls(int(data["dim"]), str(data["metric"]),
                num_subspaces=int(data["num_subspaces"]),
                item_block=int(data["item_block"]),
                query_block=int(data.get("query_block", 1024)),
                seed=int(data.get("seed", 0)),
                kmeans_iters=int(data.get("kmeans_iters", 10)),
                train_sample=int(data.get("train_sample", 131072)),
                device=device)
        s._codebooks = torch.from_numpy(data["codebooks"]).to(s.device)
        s.num_items = len(data["codes"])
        s.items = data["items"]
        s._set_codes(data["codes"])
        return s

    def __getstate__(self):
        state = super().__getstate__()
        state["_codes"] = _to_host(self._codes[:self.num_items]) \
            if self._codes is not None else None
        state["_codebooks"] = _to_host(self._codebooks) \
            if self._codebooks is not None else None
        return state

    def __setstate__(self, state):
        codes, cbs = state.pop("_codes"), state.pop("_codebooks")
        state.pop("_vecs")
        self.__dict__.update(state)
        self.device = resolve_device(state["device"])
        self._vecs = self._codes = self._codebooks = None
        if codes is not None:
            self._codebooks = torch.from_numpy(cbs).to(self.device)
            self._set_codes(codes)


class IvfPqSearcher(FlatSearcher):
    """IVF coarse quantizer + residual product quantization (IVFADC): the
    device holds the uint8 residual codes [N, M], the centroids, the capped
    lists and the decoded overflow pool."""

    # quantized decode-and-score math assumes the matmul family
    SUPPORTED_METRICS = ("ip", "cos", "l2")

    def __init__(self, dim: int, metric: str = "cos", nlist: int = 1024,
                 nprobe: int = 8, num_subspaces: int = 8,
                 query_block: int = 256, cap_factor: float = 2.0,
                 kmeans_iters: int = 10, train_sample: int = 262144,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        super().__init__(dim, metric, query_block=query_block, device=device)
        if dim % num_subspaces != 0:
            raise ValueError(f"dim {dim} not divisible by num_subspaces "
                             f"{num_subspaces}")
        self.nlist = nlist
        self.nprobe = nprobe
        self.num_subspaces = num_subspaces
        self.cap_factor = cap_factor
        self.kmeans_iters = kmeans_iters
        self.train_sample = train_sample
        self.seed = seed
        self._centroids: Optional[torch.Tensor] = None    # [nlist, D] f32
        self._codebooks: Optional[torch.Tensor] = None    # [M, 256, D/M]
        self._codes: Optional[torch.Tensor] = None        # [N+1, M] uint8
        self._assign: Optional[np.ndarray] = None         # [N] int32 (host)
        self._lists: Optional[torch.Tensor] = None        # [nlist, cap] int64
        self._overflow_idx: Optional[np.ndarray] = None   # [O]
        self._overflow_dec: Optional[torch.Tensor] = None  # [O, D] decoded
        self._xhat_sq: Optional[torch.Tensor] = None      # [N+1] (l2)

    # --------------------------------------------------------------- build
    def train(self, vectors: np.ndarray, items: Optional[Sequence[Any]] = None):
        vectors = self._prepare(vectors)
        n = len(vectors)
        self.num_items = n
        self.items = np.asarray(items) if items is not None else np.arange(n)
        self.nlist = max(1, min(self.nlist, n))

        # 1. coarse quantizer on a sample (one transient corpus upload; raw
        # vectors do not stay on the device)
        rng = np.random.RandomState(self.seed)
        dev = torch.from_numpy(vectors).to(self.device)
        sample = dev if n <= self.train_sample else dev[torch.from_numpy(
            rng.choice(n, self.train_sample, replace=False)).to(self.device)]
        self._centroids = kmeans(sample, self.nlist, iters=self.kmeans_iters,
                                 seed=self.seed,
                                 spherical=self.metric in ("cos", "ip"))
        self._assign = _assign_blocks(dev, self._centroids, n).astype(np.int32)
        del dev, sample

        # 2. residual PQ codebooks + encode
        resid = vectors - _to_host(self._centroids)[self._assign]
        self._codebooks = _pq_train_codebooks(
            _sample(rng, resid, n, self.train_sample), self.num_subspaces,
            self.kmeans_iters, self.seed, self.device)
        self._install(_pq_encode(resid, self._codebooks))
        return self

    def _install(self, codes: np.ndarray):
        """Lists, overflow and derived norms from self._assign and the codes,
        placed on the device. Shared by train / add / load / unpickle."""
        n = self.num_items
        lists, ov = _build_capped_lists(
            self._assign.astype(np.int64), self.nlist, self.cap_factor)
        self._lists = torch.from_numpy(lists.astype(np.int64)).to(self.device)
        padded = np.zeros((n + 1, self.num_subspaces), np.uint8)
        padded[:n] = codes
        self._codes = torch.from_numpy(padded).to(self.device)
        cb, centroids = _to_host(self._codebooks), _to_host(self._centroids)
        # decode only what the scan needs: a whole-corpus decode would cost
        # the N·D·4 bytes this class exists to avoid
        self._overflow_idx = ov
        self._overflow_dec = torch.from_numpy(
            (_pq_decode_np(codes[ov], cb) + centroids[self._assign[ov]])
            .astype(np.float32) if len(ov) else
            np.zeros((0, self.dim), np.float32)).to(self.device)
        self._xhat_sq = None
        if self.metric == "l2":
            xsq = np.zeros((n + 1,), np.float32)
            for s in range(0, n, 65536):       # blockwise: only sums persist
                dec = _pq_decode_np(codes[s:s + 65536], cb) \
                    + centroids[self._assign[s:s + 65536]]
                xsq[s:s + len(dec)] = (dec ** 2).sum(-1)
            self._xhat_sq = torch.from_numpy(xsq).to(self.device)
        self._vecs = None
        self._search_fn = {}

    def add(self, vectors, items=None):
        """Append: encode with the EXISTING quantizers (FAISS IVFPQ add
        semantics: train once, add many) and rebuild the lists."""
        if self._codes is None:
            return self.train(vectors, items)
        vectors = self._prepare(vectors)
        n_new = len(vectors)
        assign_new = _assign_blocks(torch.from_numpy(vectors).to(self.device),
                                    self._centroids, n_new).astype(np.int32)
        resid = vectors - _to_host(self._centroids)[assign_new]
        codes_new = _pq_encode(resid, self._codebooks)
        old_codes = _to_host(self._codes[:self.num_items])
        new_items = np.asarray(items) if items is not None else \
            np.arange(self.num_items, self.num_items + n_new)
        self.items = np.concatenate([self.items, new_items])
        self._assign = np.concatenate([self._assign, assign_new])
        self.num_items += n_new
        self._install(np.concatenate([old_codes, codes_new]))
        return self

    # -------------------------------------------------------------- search
    def _is_empty(self) -> bool:
        return self._codes is None

    def _build_search(self, k: int):
        metric = self.metric
        num_items = self.num_items
        msub, ds = self.num_subspaces, self.dim // self.num_subspaces
        codes, lists, xsq = self._codes, self._lists, self._xhat_sq
        over, n_over = self._overflow_dec, len(self._overflow_idx)
        over_idx = torch.from_numpy(self._overflow_idx.astype(np.int64)).to(
            self.device)

        def search_block(queries):
            nq = queries.shape[0]
            nprobe = min(self.nprobe, self.nlist)    # read at search time
            qc, probe = _probe_lists(queries, self._centroids, metric, nprobe)
            qct = torch.gather(qc, 1, probe)                     # [Q, P] q·c
            # per-query residual lookup tables, rounded to bf16 as the JAX
            # package's bf16 one-hot contraction reads them
            lut = torch.einsum("qsd,skd->qsk", queries.reshape(nq, msub, ds),
                               self._codebooks)                  # [Q, Msub, 256]
            lut = lut.to(torch.bfloat16).float()
            cand = lists[probe]                                  # [Q, P, M]
            parts = []
            for p in range(nprobe):
                ids = cand[:, p]                                 # [Q, M]
                safe = torch.where(ids >= 0, ids, num_items)
                cg = codes[safe].long()                          # [Q, M, Msub]
                vals = torch.gather(
                    lut[:, None].expand(nq, ids.shape[1], msub, 256), 3,
                    cg[..., None])[..., 0]
                sp = vals.sum(-1) + qct[:, p, None]              # q·(c + r̂)
                if metric == "l2":
                    sp = 2.0 * sp - xsq[safe]
                parts.append(torch.where(ids >= 0, sp, NEG))
            s = torch.stack(parts, dim=1).reshape(nq, -1)
            cand = cand.reshape(nq, -1)
            if n_over:
                so = queries @ over.T                            # exact pool
                if metric == "l2":
                    so = 2.0 * so - xsq[over_idx][None, :]
                s = torch.cat([s, so], dim=1)
                cand = torch.cat([cand, over_idx[None, :].expand(nq, n_over)],
                                 dim=1)
            top, idx = _top_k_padded(s, cand, k)
            if metric == "l2":
                top = _l2_from_surrogate(queries, top)
            return top, idx

        return search_block

    def reconstruct(self, indices) -> np.ndarray:
        """centroid[assign] + decode(residual codes) (FAISS
        Index.reconstruct)."""
        idx = np.atleast_1d(np.asarray(indices))
        codes = _to_host(self._codes)[idx]
        return _pq_decode_np(codes, _to_host(self._codebooks)) \
            + _to_host(self._centroids)[self._assign[idx]]

    # ------------------------------------------------------------- persist
    def save(self, path: str):
        """The JAX package's `.npz` keys (the whole index state)."""
        if self._codes is None:
            raise RuntimeError("nothing to save")
        np.savez_compressed(
            path, codes=_to_host(self._codes[:self.num_items]),
            codebooks=_to_host(self._codebooks),
            centroids=_to_host(self._centroids), assign=self._assign,
            items=self.items, dim=self.dim, metric=self.metric, ivfpq=True,
            nlist=self.nlist, nprobe=self.nprobe,
            num_subspaces=self.num_subspaces, cap_factor=self.cap_factor,
            kmeans_iters=self.kmeans_iters, train_sample=self.train_sample,
            seed=self.seed, query_block=self.query_block)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"
             ) -> "IvfPqSearcher":
        data = np.load(_npz_path(path), allow_pickle=True)
        s = cls(int(data["dim"]), str(data["metric"]),
                nlist=int(data["nlist"]), nprobe=int(data["nprobe"]),
                num_subspaces=int(data["num_subspaces"]),
                cap_factor=float(data["cap_factor"]),
                kmeans_iters=int(data["kmeans_iters"]),
                train_sample=int(data["train_sample"]),
                seed=int(data["seed"]),
                query_block=int(data["query_block"]), device=device)
        s._centroids = torch.from_numpy(data["centroids"]).to(s.device)
        s._codebooks = torch.from_numpy(data["codebooks"]).to(s.device)
        s._assign = data["assign"].astype(np.int32)
        s.items = data["items"]
        s.num_items = len(s._assign)
        s._install(data["codes"])
        return s

    def __getstate__(self):
        state = super().__getstate__()
        for key in ("_codes", "_centroids", "_codebooks"):
            t = getattr(self, key)
            state[key] = None if t is None else _to_host(
                t[:self.num_items] if key == "_codes" else t)
        state.update(_lists=None, _overflow_idx=None, _overflow_dec=None,
                     _xhat_sq=None)
        return state

    def __setstate__(self, state):
        codes = state.pop("_codes")
        state.pop("_vecs")
        self.__dict__.update(state)
        self.device = resolve_device(state["device"])
        self._vecs = self._codes = None
        if codes is not None:
            self._centroids = torch.from_numpy(state["_centroids"]).to(self.device)
            self._codebooks = torch.from_numpy(state["_codebooks"]).to(self.device)
            self._install(codes)
