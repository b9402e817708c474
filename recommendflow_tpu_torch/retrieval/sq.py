"""SqSearcher: scalar-quantized exact scan, FAISS 'SQ8' / 'SQfp16' (the
counterpart of `recommendflow_tpu/retrieval/sq.py`), the default compressed
tier of `index_factory`.

qtype='sq8': per-dim affine uint8 codes (4x compression). The scan never
dequantizes the corpus: with x̂ = vmin + scale ⊙ code,
q·x̂ = q·vmin + (q ⊙ scale)·code, so each block is one [Q, D] x [D, N]
product over the codes plus a per-query base.

qtype='bf16': bf16 codes, the stand-in for FAISS SQfp16 (2x compression).

Two search paths, picked by corpus size as the JAX package picks them:

  * hierarchical tournament (from `_HIER_MIN_ITEMS` padded items):
    grouped_score_max (ops/cuda/grouped_topk.py) forms the group maxima
    from the codes (the CUDA kernel's uint8 form for sq8, its bf16 form for
    bf16) with the queries rounded to bf16, as the Pallas kernel does; the
    winning groups are rescored in f32 with the affine base added back.
    (The JAX package's CPU path forms m1 in f32 instead: the two can differ
    only where a group's max lies within one bf16 ulp of the k-th best.)
  * item blocks (smaller corpora): bf16-rounded queries against each block
    of codes, f32 accumulation, per-block top-k and a merge.

bf16 x bf16 products: torch.matmul of two bf16 tensors returns bf16 on the
card, rounding every score, where the JAX package accumulates and returns
f32. So the queries are rounded to bf16 and both operands widened to f32
before an f32 matmul: the products are exact, so this equals the
f32-accumulated bf16 product. TF32 must stay off
(torch.backends.cuda.matmul.allow_tf32 = False, PyTorch's default).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.ops.cuda.grouped_topk import grouped_score_max
from recommendflow_tpu_torch.retrieval import _kernels
from recommendflow_tpu_torch.retrieval._kernels import (
    _GROUP, _SUPERGROUP, _blocked_topk, _l2_from_surrogate, _to_host,
    _tournament_select)
from recommendflow_tpu_torch.retrieval.flat import FlatSearcher, _npz_path

_ROWS = 1 << 20          # rows per host -> device block (bounds temporaries)


class SqSearcher(FlatSearcher):
    """Scalar-quantized exact scan over uint8 (sq8) or bf16 codes.

    Unlike PQ there is no codebook training; SQ8's only loss is 8-bit
    rounding of each dimension inside its trained [vmin, vmax] range.
    """

    # quantized decode-and-score math assumes the matmul family
    SUPPORTED_METRICS = ("ip", "cos", "l2")

    def __init__(self, dim: int, metric: str = "cos", qtype: str = "sq8",
                 item_block: int = 65536, query_block: int = 1024,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(dim, metric, query_block=query_block, device=device)
        if qtype not in ("sq8", "bf16"):
            raise ValueError(f"qtype must be sq8|bf16, got '{qtype}'")
        self.qtype = qtype
        self.item_block = item_block
        self._codes: Optional[torch.Tensor] = None    # [N_pad, D] uint8 | bf16
        self._vmin: Optional[torch.Tensor] = None     # [D] f32 (sq8)
        self._scale: Optional[torch.Tensor] = None    # [D] f32 (sq8)
        self._xhat_sq: Optional[torch.Tensor] = None  # [N_pad] f32 (l2)

    @property
    def _code_dtype(self) -> torch.dtype:
        return torch.uint8 if self.qtype == "sq8" else torch.bfloat16

    # --------------------------------------------------------------- build
    def train(self, vectors: np.ndarray, items: Optional[Sequence[Any]] = None):
        vectors = self._prepare(vectors)
        n = len(vectors)
        self.num_items = n
        self.items = np.asarray(items) if items is not None else np.arange(n)
        if self.qtype == "sq8":
            vmin = vectors.min(axis=0)
            vdiff = vectors.max(axis=0) - vmin
            scale = np.where(vdiff > 0, vdiff / 255.0, 1.0).astype(np.float32)
            self._vmin = torch.from_numpy(vmin.astype(np.float32)).to(self.device)
            self._scale = torch.from_numpy(scale).to(self.device)
            self._restore_codes(self._encode(vectors))
        else:
            self._restore_codes(vectors)
        return self

    def _encode(self, vectors: np.ndarray) -> torch.Tensor:
        """Quantize with the CURRENT per-dim ranges (out-of-range values clip:
        the quantizer is fit at train and frozen, FAISS SQ semantics) on the
        searcher's device, in row blocks: the same f32 operations as the JAX
        package's numpy encode, so the same codes."""
        out = torch.empty((len(vectors), self.dim), dtype=torch.uint8,
                          device=self.device)
        for s in range(0, len(vectors), _ROWS):
            x = torch.from_numpy(np.ascontiguousarray(
                vectors[s:s + _ROWS])).to(self.device)
            out[s:s + len(x)] = torch.clamp(torch.round(
                (x - self._vmin) / self._scale), 0, 255).to(torch.uint8)
        return out

    def add(self, vectors, items=None):
        """Append, encoding with the EXISTING quantizer (FAISS SQ add
        semantics: ranges are fit at train() and frozen). Values outside the
        trained ranges clip; rebuild with train() when the data drifts."""
        if self._codes is None:
            return self.train(vectors, items)
        vectors = self._prepare(vectors)
        new_items = np.asarray(items) if items is not None else \
            np.arange(self.num_items, self.num_items + len(vectors))
        new = self._encode(vectors) if self.qtype == "sq8" else \
            torch.from_numpy(np.ascontiguousarray(vectors)).to(
                self.device).to(torch.bfloat16)
        codes = torch.cat([self._codes[:self.num_items], new])
        self.items = np.concatenate([self.items, new_items])
        self.num_items += len(vectors)
        self._restore_codes(codes)
        return self

    # padding/placement hooks, as the JAX package keeps them for its sharded
    # subclass
    def _pad_rows(self, n: int) -> int:
        return -(-n // self.item_block) * self.item_block

    def _put_codes(self, padded: torch.Tensor) -> torch.Tensor:
        return padded.to(self.device)

    def _put_norms(self, xsq: torch.Tensor) -> torch.Tensor:
        return xsq.to(self.device)

    def _restore_codes(self, codes: Union[np.ndarray, torch.Tensor]):
        """Pad (via _pad_rows) and place (via _put_*) the codes: a uint8
        array or tensor for sq8; for bf16, vectors in f32 (numpy) or bf16
        codes, rounded to bf16 on the device. l2 also needs each item's
        ‖x̂‖², decoded in row blocks. The one home of train / add / load /
        unpickle."""
        n = len(codes)
        n_pad = self._pad_rows(n)
        padded = torch.zeros((n_pad, self.dim), dtype=self._code_dtype,
                             device=self.device)
        for s in range(0, n, _ROWS):
            blk = codes[s:s + _ROWS]
            if isinstance(blk, np.ndarray):
                blk = torch.from_numpy(np.ascontiguousarray(blk))
            padded[s:s + len(blk)] = blk.to(self.device).to(self._code_dtype)
        self._codes = self._put_codes(padded)
        self._xhat_sq = None
        if self.metric == "l2":
            xsq = torch.zeros((n_pad,), dtype=torch.float32, device=self.device)
            for s in range(0, n, _ROWS):
                dec = self._decode(self._codes[s:min(n, s + _ROWS)])
                xsq[s:s + len(dec)] = (dec * dec).sum(-1)
            self._xhat_sq = self._put_norms(xsq)
        self._vecs = None
        self._search_fn = {}

    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        """Codes -> x̂ in f32."""
        if self.qtype == "sq8":
            return self._vmin + self._scale * codes.float()
        return codes.float()

    # -------------------------------------------------------------- search
    def _is_empty(self) -> bool:
        return self._codes is None

    def _build_search(self, k: int):
        metric = self.metric
        sq8 = self.qtype == "sq8"
        num_items = self.num_items
        dim = self.dim
        bn = self.item_block
        codes = self._codes
        n_pad = int(codes.shape[0])
        xsq = self._xhat_sq

        def affine(queries):
            """(q ⊙ scale, q·vmin) for sq8; (q, 0) for bf16."""
            if sq8:
                return queries * self._scale[None, :], queries @ self._vmin
            return queries, torch.zeros(queries.shape[0], device=queries.device)

        def finish(queries, top_scores, top_idx):
            if metric == "l2":
                top_scores = _l2_from_surrogate(queries, top_scores)
            return top_scores, top_idx

        G, G2 = _GROUP, _SUPERGROUP
        if (n_pad % (G * G2) == 0 and n_pad // (G * G2) > max(k, 64)
                and n_pad >= _kernels._HIER_MIN_ITEMS and bn % G == 0):
            # grouped tournament over the codes: the kernel forms the group
            # maxima of qs·codes (2 qs·codes − ‖x̂‖² for l2; the per-query
            # base leaves each query's group order unchanged), the winners
            # are rescored in f32 with the base added back. Views, no copy.
            codes_g = codes.view(n_pad // G, G, dim)
            xsq_g = xsq.view(n_pad // G, G) if metric == "l2" else None

            def search_hier(queries):
                qs, base = affine(queries)
                m1 = grouped_score_max(qs, codes, xsq if metric == "l2" else None,
                                       group=G, num_items=num_items)
                return finish(queries, *_tournament_select(
                    qs, m1, codes_g, xsq_g, k, k, num_items, metric, base=base))

            return search_hier

        def search_block(queries):
            qs, base = affine(queries)
            qs = qs.to(torch.bfloat16).float()     # bf16 operand, f32 sums

            def block_scores(start):
                s = qs @ codes[start:start + bn].float().T + base[:, None]
                return 2.0 * s - xsq[None, start:start + bn] \
                    if metric == "l2" else s

            return finish(queries, *_blocked_topk(block_scores, n_pad, bn,
                                                  num_items, k))

        return search_block

    def reconstruct(self, indices) -> np.ndarray:
        """Dequantized items (FAISS Index.reconstruct)."""
        idx = torch.from_numpy(np.atleast_1d(np.asarray(indices)).astype(np.int64))
        return _to_host(self._decode(self._codes[idx.to(self.device)]))

    # ------------------------------------------------------------- persist
    def save(self, path: str):
        """The JAX package's `.npz` keys: codes (uint8, or the bf16 codes as
        f32), vmin and scale (sq8), items, dim, metric, sq, qtype,
        item_block, query_block."""
        if self._codes is None:
            raise RuntimeError("nothing to save")
        extra = {}
        if self.qtype == "sq8":
            extra = {"vmin": _to_host(self._vmin), "scale": _to_host(self._scale)}
        np.savez_compressed(
            path, codes=_to_host(self._codes[:self.num_items]),
            items=self.items, dim=self.dim, metric=self.metric, sq=True,
            qtype=self.qtype, item_block=self.item_block,
            query_block=self.query_block, **extra)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"
             ) -> "SqSearcher":
        data = np.load(_npz_path(path), allow_pickle=True)
        s = cls(int(data["dim"]), str(data["metric"]),
                qtype=str(data["qtype"]), item_block=int(data["item_block"]),
                query_block=int(data["query_block"]), device=device)
        s.items = data["items"]
        s.num_items = len(data["codes"])
        if s.qtype == "sq8":
            s._vmin = torch.from_numpy(data["vmin"]).to(s.device)
            s._scale = torch.from_numpy(data["scale"]).to(s.device)
        s._restore_codes(data["codes"])
        return s

    def __getstate__(self):
        state = self.__dict__.copy()
        state["device"] = str(self.device)
        for key in ("_codes", "_vmin", "_scale"):
            t = getattr(self, key)
            state[key] = None if t is None else _to_host(
                t[:self.num_items] if key == "_codes" else t)
        state.update(_vecs=None, _sq_norms=None, _xhat_sq=None, _search_fn={})
        return state

    def __setstate__(self, state):
        codes = state.pop("_codes")
        self.__dict__.update(state)
        self.device = resolve_device(state["device"])
        for key in ("_vmin", "_scale"):
            if state[key] is not None:
                setattr(self, key, torch.from_numpy(state[key]).to(self.device))
        self._codes = None
        if codes is not None:
            self._restore_codes(codes)
