"""Host-RAM corpus tier: search over a catalogue held in host memory and
streamed through the card (the counterpart of
`recommendflow_tpu/retrieval/host_tier.py`).

The device-resident searchers cap at one card's memory. Here the corpus
(scalar-quantized codes, or raw f32 for the exact tier) lives in a host
tensor and search() streams it through the device in double-buffered blocks
of `block_items` rows:

  * on a card the codes (and l2's ‖x̂‖² sidecar, `xsq`) are held in pinned
    host memory, so a copy is a real DMA that overlaps the scan. Block i+1
    is copied on a side stream into the second of two device buffers while
    the compute stream scans block i; an event per buffer orders the scan
    after its copy, and a second event keeps the next copy into a buffer
    from starting before the scan that reads it has finished. The tail
    block's rows past the corpus are zeroed on the device (xsq +inf);
  * each block is reduced to its local top-k by kernel 5
    (`grouped_score_max`: the f32 form for 'f32', the bf16 tensor-core form
    for 'bf16', the uint8 form for 'sq8'; `num_items` masks the tail) and
    the grouped tournament (`_kernels._tournament_select`), as the resident
    `SqSearcher` does; blocks too small for the tournament
    (block_items // 256 < k) take a full-score top-k in f32;
  * the per-block winners (padded with NEG to k) merge into one [Q, k]
    top-k: exact over the block scores, since a global top-k item is a
    local top-k item of its block. The sq8 affine base q·vmin and l2's
    surrogate -> distance are applied after selection, on the host in f32,
    as the JAX package does.

Every search streams the whole code matrix once per query block, so it is
bound by the host link at (link bytes/s) / (bytes per row) rows/s or by the
scan, whichever is slower; batch queries as large as possible
(query_block=2048 default).

`HostIvfSearcher` keeps the corpus cluster-contiguous on the host and ships
only the union of the probed clusters of a query block: packed on the host
into one pinned buffer, one async copy, then scored by kernel 5 and the
tournament (the JAX package scores the union in XLA).

Kernel 5 rounds the queries of a bf16 or uint8 corpus to bf16, on every
device (the Pallas kernel feeds its matrix unit bf16 x bf16); the JAX
package's CPU path forms those group maxima in f32. The two can differ only
where a group's max lies within one bf16 rounding of the k-th best.

Host bf16 codes are a torch bf16 tensor (numpy has no bf16); `save` writes
them as a uint16 view under the JAX package's keys, so a `.npz` crosses
between the packages both ways.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.ops.cuda.grouped_topk import grouped_score_max
from recommendflow_tpu_torch.retrieval._kernels import (
    NEG, _GROUP, _SUPERGROUP, _blocked_topk, _l2_normalize, _nearest,
    _to_host, _tournament_select, kmeans, resolve_metric)
from recommendflow_tpu_torch.retrieval.flat import _npz_path

_CODE_DTYPES = {"bf16": torch.bfloat16, "sq8": torch.uint8,
                "f32": torch.float32}
_ASSIGN_ROWS = 65536     # rows per nearest-centroid product ([rows, nlist])


class StreamingSqSearcher:
    """Host-resident (streamed) scalar-quantized or exact searcher.

    qtype: 'bf16' (2x compression), 'sq8' (4x) or 'f32' (the exact host Flat
    tier). train() takes one [N, D] array or a sequence of [n_i, D] blocks
    (sq8 makes two passes, so a generator must be a list first). `device`
    (default "cuda") is where the blocks are scanned; without a card it
    raises unless "cpu" is asked for.
    """

    SUPPORTED_METRICS = ("ip", "cos", "l2")

    def __init__(self, dim: int, metric: Union[str, int] = "cos",
                 qtype: str = "bf16", block_items: int = 1 << 20,
                 query_block: int = 2048,
                 device: Union[str, torch.device] = "cuda"):
        metric = resolve_metric(metric)
        if metric not in self.SUPPORTED_METRICS:
            raise ValueError(
                f"metric '{metric}' not in {self.SUPPORTED_METRICS}")
        if qtype not in _CODE_DTYPES:
            raise ValueError(f"qtype must be bf16|sq8|f32, got '{qtype}'")
        if block_items % (_GROUP * _SUPERGROUP):
            raise ValueError(
                f"block_items must be a multiple of {_GROUP * _SUPERGROUP}")
        self.dim = dim
        self.metric = metric
        self.qtype = qtype
        self.block_items = int(block_items)
        self.query_block = int(query_block)
        self.device = resolve_device(device)
        self.items: Optional[np.ndarray] = None
        self.num_items = 0
        self._codes: Optional[torch.Tensor] = None  # [N, D] host (pinned on a card)
        self._xsq: Optional[torch.Tensor] = None    # [N] f32 host (l2)
        self._vmin: Optional[np.ndarray] = None     # [D] f32 (sq8)
        self._scale: Optional[np.ndarray] = None

    # --------------------------------------------------------------- build
    @staticmethod
    def _as_blocks(vectors) -> Sequence[np.ndarray]:
        if isinstance(vectors, np.ndarray):
            return [vectors]
        return list(vectors)

    def _host_empty(self, shape, dtype) -> torch.Tensor:
        """A host tensor, pinned when the scans run on a card (a copy from
        pageable memory would be synchronous and overlap nothing)."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def train(self, vectors, items: Optional[Sequence[Any]] = None):
        blocks = self._as_blocks(vectors)
        n = sum(len(b) for b in blocks)
        if any(b.ndim != 2 or b.shape[1] != self.dim for b in blocks):
            raise ValueError(f"expected [*, {self.dim}] blocks")
        if self.qtype == "sq8":
            # pass 1: global per-dim ranges (FAISS SQ semantics: the
            # quantizer is fit over the whole corpus, then frozen)
            vmin = np.full((self.dim,), np.inf, np.float32)
            vmax = np.full((self.dim,), -np.inf, np.float32)
            for b in blocks:
                for s in range(0, len(b), self.block_items):
                    v = self._normalized(b[s:s + self.block_items])
                    np.minimum(vmin, v.min(axis=0), out=vmin)
                    np.maximum(vmax, v.max(axis=0), out=vmax)
            diff = vmax - vmin
            self._vmin = vmin
            self._scale = np.where(diff > 0, diff / 255.0, 1.0) \
                .astype(np.float32)
        self._codes = self._host_empty((n, self.dim), _CODE_DTYPES[self.qtype])
        self._xsq = self._host_empty((n,), torch.float32) \
            if self.metric == "l2" else None
        pos = 0
        for b in blocks:
            pos = self._encode_into(b, pos)
        self.num_items = n
        self.items = np.asarray(items) if items is not None else np.arange(n)
        return self

    def _normalized(self, block: np.ndarray) -> np.ndarray:
        v = block.astype(np.float32, copy=False)
        return _l2_normalize(v) if self.metric == "cos" else v

    def _encode_into(self, block: np.ndarray, pos: int) -> int:
        """Encode `block` into the codes from row `pos`, in row chunks (the
        operations are per element and per row, so the codes and xsq are
        those of the JAX package's whole-block numpy encode). sq8 codes are
        computed on the searcher's device with the same f32 operations
        (IEEE division, round half to even), as SqSearcher encodes."""
        for s in range(0, len(block), self.block_items):
            v = self._normalized(block[s:s + self.block_items])
            e = pos + len(v)
            if self.qtype == "sq8":
                x = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                vmin = torch.from_numpy(self._vmin).to(self.device)
                scale = torch.from_numpy(self._scale).to(self.device)
                self._codes[pos:e] = torch.clamp(torch.round(
                    (x - vmin) / scale), 0, 255).to(torch.uint8).cpu()
                xhat = self._vmin + self._scale * self._codes[pos:e].numpy()
            else:
                # bf16 rounds here (to nearest even, as numpy's ml_dtypes)
                self._codes[pos:e] = torch.from_numpy(v)
                xhat = _to_host(self._codes[pos:e])
            if self._xsq is not None:
                self._xsq[pos:e] = torch.from_numpy((xhat ** 2).sum(-1))
            pos = e
        return pos

    def add(self, vectors, items=None):
        """Append with the frozen quantizer (FAISS SQ add semantics)."""
        if self._codes is None:
            return self.train(vectors, items)
        blocks = self._as_blocks(vectors)
        n_new = sum(len(b) for b in blocks)
        old_n = self.num_items
        codes = self._host_empty((old_n + n_new, self.dim), self._codes.dtype)
        codes[:old_n] = self._codes
        self._codes = codes
        if self._xsq is not None:
            xsq = self._host_empty((old_n + n_new,), torch.float32)
            xsq[:old_n] = self._xsq
            self._xsq = xsq
        pos = old_n
        for b in blocks:
            pos = self._encode_into(b, pos)
        new_items = np.asarray(items) if items is not None else \
            np.arange(old_n, old_n + n_new)
        self.items = np.concatenate([self.items, new_items])
        self.num_items += n_new
        return self

    # -------------------------------------------------------------- stream
    def _stream(self, with_xsq: bool = True
                ) -> Iterator[Tuple[int, int, torch.Tensor, Optional[torch.Tensor]]]:
        """Yield (start, valid rows, codes [bn, D], xsq [bn] or None) for
        every block of the host codes, on the device, the tail zero-padded
        (xsq +inf). Two device buffers alternate; on a card block i+1's
        copy is issued on a side stream before block i is handed out, and
        the consumer's work on the current stream (enqueued before it
        yields back) is what the next copy into the same buffer waits for,
        and the first copies wait for the work queued before the stream."""
        n, bn, dev = self.num_items, self.block_items, self.device
        with_xsq = with_xsq and self._xsq is not None
        bufs = [torch.empty((bn, self.dim), dtype=self._codes.dtype,
                            device=dev) for _ in range(2)]
        xbufs = [torch.empty((bn,), dtype=torch.float32, device=dev)
                 for _ in range(2)] if with_xsq else [None, None]
        card = dev.type == "cuda"
        compute = torch.cuda.current_stream(dev) if card else None
        copy = torch.cuda.Stream(device=dev) if card else None
        ready = [torch.cuda.Event() for _ in range(2)] if card else None
        done = [None, None]
        if card:
            # the buffers may reuse memory that work already queued on the
            # compute stream still reads (a tensor freed just before): the
            # first copies wait for that work, and the allocator learns
            # that the side stream uses them
            copy.wait_stream(compute)
            for t in bufs + [x for x in xbufs if x is not None]:
                t.record_stream(copy)

        def issue(i):
            b, s = i % 2, i * bn
            e = min(s + bn, n)
            if not card:
                self._fill(bufs[b], xbufs[b], s, e)
                return
            with torch.cuda.stream(copy):
                if done[b] is not None:       # the scan of block i - 2
                    copy.wait_event(done[b])
                self._fill(bufs[b], xbufs[b], s, e)
                ready[b].record(copy)

        n_blocks = -(-n // bn)
        issue(0)
        for i in range(n_blocks):
            if i + 1 < n_blocks:
                issue(i + 1)
            b = i % 2
            if card:
                compute.wait_event(ready[b])
            yield i * bn, min(bn, n - i * bn), bufs[b], xbufs[b]
            if card:
                done[b] = torch.cuda.Event()
                done[b].record(compute)

    def _fill(self, buf: torch.Tensor, xbuf: Optional[torch.Tensor],
              s: int, e: int) -> None:
        """Copy host rows [s, e) into a device buffer (asynchronously from
        pinned memory on a card) and pad its tail on the device."""
        buf[:e - s].copy_(self._codes[s:e], non_blocking=True)
        buf[e - s:].zero_()
        if xbuf is not None:
            xbuf[:e - s].copy_(self._xsq[s:e], non_blocking=True)
            xbuf[e - s:].fill_(float("inf"))

    # -------------------------------------------------------------- search
    def _scan(self, qs: torch.Tensor, codes: torch.Tensor,
              xsq: Optional[torch.Tensor], k: int, valid: int):
        """Local top-k of one padded block or union ([bn, D] codes, rows
        from `valid` masked): (surrogate scores [Q, k], local rows). The
        scores omit the sq8 base (rank-preserving within a query)."""
        G, G2 = _GROUP, _SUPERGROUP
        bn = codes.shape[0]
        l2 = self.metric == "l2"
        if bn // (G * G2) >= max(k, 2):
            m1 = grouped_score_max(qs, codes, xsq if l2 else None, group=G,
                                   num_items=valid)
            return _tournament_select(
                qs, m1, codes.view(bn // G, G, self.dim),
                xsq.view(bn // G, G) if l2 else None, k,
                min(k, bn // (G * G2)), valid, self.metric)
        # tiny-block fallback: full f32 scores + top-k
        s = qs @ codes.float().T
        if l2:
            s = 2.0 * s - xsq[None, :]
        s[:, valid:] = NEG
        return torch.topk(s, k, dim=1)

    def _affine(self, queries: np.ndarray):
        """(q ⊙ scale, q·vmin) for sq8, (q, None) otherwise: numpy f32."""
        if self.qtype == "sq8":
            return queries * self._scale[None, :], queries @ self._vmin
        return queries, None

    def _finish(self, queries: np.ndarray, top_s: np.ndarray,
                base: Optional[np.ndarray]) -> np.ndarray:
        """The deferred per-query corrections (rank-preserving, so applied
        after selection): the sq8 affine base, l2's surrogate -> distance."""
        if self.metric == "l2":
            q_sq = (queries ** 2).sum(-1, keepdims=True)
            surr = top_s + (2.0 * base[:, None] if base is not None else 0.0)
            return np.sqrt(np.maximum(q_sq - surr, 0.0))
        if base is not None:
            return top_s + base[:, None]
        return top_s

    def search(self, queries: np.ndarray,
               topk: Union[int, Sequence[int]] = 10,
               return_items: bool = True):
        """Same surface as FlatSearcher.search: (items, scores, idx) numpy
        [Q, k], dicts by k for a list topk; items omitted with
        return_items=False."""
        if self._codes is None:
            raise RuntimeError("searcher is empty — call train() first")
        ks = sorted({int(k) for k in
                     (topk if isinstance(topk, (list, tuple)) else [topk])})
        k_max = min(max(ks), self.num_items)
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if self.metric == "cos":
            queries = _l2_normalize(queries)
        out_scores, out_idx = [], []
        for qstart in range(0, len(queries), self.query_block):
            s, i = self._search_impl(queries[qstart:qstart + self.query_block],
                                     k_max)
            out_scores.append(s)
            out_idx.append(i)
        scores = np.concatenate(out_scores, axis=0)
        idx = np.concatenate(out_idx, axis=0)

        def slice_k(arr):
            return arr if len(ks) == 1 else {k: arr[:, :k] for k in ks}

        if return_items and self.items is not None:
            return slice_k(self.items[idx]), slice_k(scores), slice_k(idx)
        return slice_k(scores), slice_k(idx)

    def _search_impl(self, queries: np.ndarray, k: int):
        """One query block; HostIvfSearcher scores the probed union."""
        qs, base = self._affine(queries)
        qs = torch.from_numpy(np.ascontiguousarray(qs)).to(self.device)
        parts_s, parts_i = [], []
        for start, valid, codes, xsq in self._stream():
            s, li = self._scan(qs, codes, xsq, min(k, valid), valid)
            if s.shape[1] < k:        # a tail block smaller than k: pad NEG
                s = torch.nn.functional.pad(s, (0, k - s.shape[1]), value=NEG)
                li = torch.nn.functional.pad(li, (0, k - li.shape[1]))
            parts_s.append(s)
            parts_i.append(li + start)
        top_s, pos = torch.topk(torch.cat(parts_s, dim=1), k, dim=1)
        top_i = torch.gather(torch.cat(parts_i, dim=1), 1, pos)
        return self._finish(queries, _to_host(top_s), base), _to_host(top_i)

    # ------------------------------------------------------------- persist
    def _dequant(self, codes: torch.Tensor) -> np.ndarray:
        """Host codes -> x̂ f32 numpy, as the JAX package decodes them."""
        if self.qtype == "sq8":
            return self._vmin + self._scale * codes.numpy()
        return _to_host(codes)

    def reconstruct(self, indices) -> np.ndarray:
        idx = torch.from_numpy(np.asarray(indices, np.int64))
        return self._dequant(self._codes[idx])

    def _save_extra(self) -> dict:
        """Subclass hook: extra arrays to persist alongside the codes."""
        return {}

    def save(self, path: str):
        """The JAX package's `.npz` keys; bf16 codes as their uint16 bits."""
        if self._codes is None:
            raise RuntimeError("nothing to save")
        extra = self._save_extra()
        if self.qtype == "sq8":
            extra.update(vmin=self._vmin, scale=self._scale)
        if self._xsq is not None:
            extra["xsq"] = self._xsq.numpy()
        codes = self._codes
        codes = codes.view(torch.int16).numpy().view(np.uint16) \
            if codes.dtype == torch.bfloat16 else codes.numpy()
        np.savez(path, codes=codes, qtype=self.qtype, items=self.items,
                 dim=self.dim, metric=self.metric,
                 block_items=self.block_items, query_block=self.query_block,
                 host=True, **extra)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"
             ) -> "StreamingSqSearcher":
        data = np.load(_npz_path(path), allow_pickle=True)
        if "host_ivf" in data.files and cls is StreamingSqSearcher:
            # a HostIvf file's codes are cluster-permuted: loading it as the
            # streaming tier would return wrong item ids
            return HostIvfSearcher.load(path, device=device)
        s = cls(int(data["dim"]), str(data["metric"]),
                qtype=str(data["qtype"]),
                block_items=int(data["block_items"]),
                query_block=int(data["query_block"]), device=device)
        s._load_common(data)
        return s

    def _load_common(self, data):
        codes = data["codes"]
        if self.qtype == "bf16" and codes.dtype == np.uint16:
            host = torch.from_numpy(codes.view(np.int16)).view(torch.bfloat16)
        else:   # uint8, f32, or bf16 values a package wrote widened to f32
            host = torch.from_numpy(codes).to(_CODE_DTYPES[self.qtype])
        self._codes = self._host_empty(tuple(host.shape), host.dtype)
        self._codes.copy_(host)
        self.num_items = len(codes)
        self.items = data["items"]
        if self.qtype == "sq8":
            self._vmin = np.asarray(data["vmin"])
            self._scale = np.asarray(data["scale"])
        self._xsq = None
        if self.metric == "l2":
            self._xsq = self._host_empty((self.num_items,), torch.float32)
            if "xsq" in data.files:
                self._xsq.copy_(torch.from_numpy(
                    np.asarray(data["xsq"], np.float32)))
            else:  # no sidecar: one host pass over the stored codes
                for st in range(0, self.num_items, self.block_items):
                    xhat = self._dequant(self._codes[st:st + self.block_items])
                    self._xsq[st:st + len(xhat)] = torch.from_numpy(
                        (xhat ** 2).sum(-1))


class HostIvfSearcher(StreamingSqSearcher):
    """Host-resident IVF: cluster-contiguous inverted lists in host memory;
    search ships only the probed clusters.

    train() fits the quantizer and encodes (as StreamingSqSearcher), runs
    k-means on the device over a sample shipped as codes and dequantised
    there (`_kernels.kmeans`; its draws are torch's, not jax.random's, so
    parity tests carry the JAX package's centroids across in a `.npz`),
    assigns every row to its nearest centroid streaming the code blocks
    through the device, and reorders the codes so each cluster is one
    contiguous host slice. A query block's probed clusters are packed into
    one pinned buffer and shipped with one async copy; every query of the
    block is scored against the whole union (a superset of its own probes),
    padded to {1, 1.5} x powers of two of at least 512 rows on the device.
    """

    def __init__(self, dim: int, metric: Union[str, int] = "cos",
                 qtype: str = "sq8", nlist: int = 4096, nprobe: int = 16,
                 block_items: int = 1 << 20, query_block: int = 64,
                 train_sample: int = 1 << 20, kmeans_iters: int = 10,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        super().__init__(dim, metric, qtype=qtype, block_items=block_items,
                         query_block=query_block, device=device)
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.train_sample = int(train_sample)
        self.kmeans_iters = int(kmeans_iters)
        self.seed = int(seed)
        self._centroids: Optional[torch.Tensor] = None  # [nlist, D] f32 device
        self._offsets: Optional[np.ndarray] = None      # [nlist+1] int64
        self._order: Optional[np.ndarray] = None  # [N] original id per stored row
        self._inv_order: Optional[np.ndarray] = None

    # --------------------------------------------------------------- build
    def _dequant_device(self, codes: torch.Tensor) -> torch.Tensor:
        if self.qtype == "sq8":
            vmin = torch.from_numpy(self._vmin).to(codes.device)
            scale = torch.from_numpy(self._scale).to(codes.device)
            return vmin + scale * codes.float()
        return codes.float()

    def train(self, vectors, items: Optional[Sequence[Any]] = None):
        blocks = self._as_blocks(vectors)
        n = sum(len(b) for b in blocks)
        if n < max(self.nlist, 1):
            raise ValueError(f"corpus size {n} < nlist={self.nlist}")
        if min(self.train_sample, n) < self.nlist:
            raise ValueError(
                f"train_sample={self.train_sample} < nlist={self.nlist}: "
                "raise train_sample (kmeans needs >= nlist sample rows)")
        self._order = None
        self._inv_order = None
        # 1) the scalar quantizer and the codes, in the original order
        super().train(blocks, items=items)
        # 2) k-means centroids from a host sample, shipped as codes
        rng = np.random.RandomState(self.seed)
        take = min(self.train_sample, n)
        sample_idx = np.sort(rng.choice(n, size=take, replace=False))
        sample = self._dequant_device(
            self._codes[torch.from_numpy(sample_idx)].to(self.device))
        cents = kmeans(sample, self.nlist, iters=self.kmeans_iters,
                       seed=self.seed, spherical=self.metric == "cos")
        del sample
        self._centroids = cents
        # 3) every row's nearest centroid, streaming the code blocks
        c_sq = torch.sum(cents * cents, dim=1)
        assign = torch.empty((n,), dtype=torch.int64, device=self.device)
        for start, valid, codes, _ in self._stream(with_xsq=False):
            for s in range(0, valid, _ASSIGN_ROWS):
                e = min(s + _ASSIGN_ROWS, valid)
                assign[start + s:start + e] = _nearest(
                    self._dequant_device(codes[s:e]), cents, c_sq)
        assign = assign.cpu().numpy()
        # 4) reorder the codes so each cluster is one contiguous host slice
        order = np.argsort(assign, kind="stable")
        order_t = torch.from_numpy(order)
        codes = self._host_empty(tuple(self._codes.shape), self._codes.dtype)
        torch.index_select(self._codes, 0, order_t, out=codes)
        self._codes = codes
        if self._xsq is not None:
            xsq = self._host_empty((n,), torch.float32)
            torch.index_select(self._xsq, 0, order_t, out=xsq)
            self._xsq = xsq
        self._order = order
        counts = np.bincount(assign, minlength=self.nlist)
        self._offsets = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64)
        return self

    def add(self, vectors, items=None):
        raise NotImplementedError(
            "HostIvfSearcher rebuilds its contiguous cluster layout on "
            "train(); append-then-retrain, or use StreamingSqSearcher for "
            "incremental host-scale corpora")

    def reconstruct(self, indices) -> np.ndarray:
        idx = np.asarray(indices)
        if self._order is not None:
            # codes are stored cluster-sorted: map original -> stored row
            if self._inv_order is None:
                inv = np.empty_like(self._order)
                inv[self._order] = np.arange(len(self._order))
                self._inv_order = inv
            idx = self._inv_order[idx]
        return super().reconstruct(idx)

    # -------------------------------------------------------------- search
    def _probe(self, queries: np.ndarray) -> np.ndarray:
        """[Q, nprobe] cluster ids by centroid score."""
        c = self._centroids
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
            c.device)
        s = q @ c.T
        if self.metric == "l2":
            s = 2.0 * s - torch.sum(c * c, dim=1)[None, :]
        return torch.topk(s, min(self.nprobe, self.nlist), dim=1
                          ).indices.cpu().numpy()

    def _union_rows(self, queries: np.ndarray) -> np.ndarray:
        """The stored rows of the probed clusters' union, cluster by
        cluster (each a contiguous slice)."""
        clusters = np.unique(self._probe(queries))
        off = self._offsets
        sizes = off[clusters + 1] - off[clusters]
        before = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        return np.repeat(off[clusters] - before, sizes) + \
            np.arange(int(sizes.sum()))

    def _search_impl(self, queries: np.ndarray, k: int):
        rows = self._union_rows(queries)
        m = len(rows)
        if m == 0:  # every probed cluster empty: the worst score
            fill = np.float32(np.inf if self.metric == "l2" else NEG)
            return (np.full((len(queries), k), fill, np.float32),
                    np.zeros((len(queries), k), np.int64))
        # bucket to {1, 1.5} x powers of two (>= 512, multiples of 256, so
        # the group reshapes hold)
        p = max(512, 1 << int(np.ceil(np.log2(m))))
        m_pad = p if (p < 1024 or m > (p * 3) // 4) else (p * 3) // 4
        # pack the union on the host into one (pinned) buffer, then one
        # async copy; the padding rows are zeroed on the device
        rows_t = torch.from_numpy(rows)
        packed = self._host_empty((m, self.dim), self._codes.dtype)
        torch.index_select(self._codes, 0, rows_t, out=packed)
        codes = torch.empty((m_pad, self.dim), dtype=packed.dtype,
                            device=self.device)
        codes[:m].copy_(packed, non_blocking=True)
        codes[m:].zero_()
        xsq = None
        if self._xsq is not None:
            xpacked = self._host_empty((m,), torch.float32)
            torch.index_select(self._xsq, 0, rows_t, out=xpacked)
            xsq = torch.full((m_pad,), float("inf"), device=self.device)
            xsq[:m].copy_(xpacked, non_blocking=True)
        k_eff = min(k, m)
        qs, base = self._affine(queries)
        qs = torch.from_numpy(np.ascontiguousarray(qs)).to(self.device)
        top_s, top_pos = self._score_union(qs, codes, xsq, k_eff, m)
        top_s = _to_host(top_s)
        top_i = self._order[rows[_to_host(top_pos)]]
        if top_s.shape[1] < k:                      # union smaller than k
            padw = k - top_s.shape[1]
            top_s = np.pad(top_s, ((0, 0), (0, padw)), constant_values=NEG)
            top_i = np.pad(top_i, ((0, 0), (0, padw)))
        return self._finish(queries, top_s, base), top_i

    def _score_union(self, qs: torch.Tensor, codes: torch.Tensor,
                     xsq: Optional[torch.Tensor], k: int, valid: int):
        """(scores [Q, k], union positions [Q, k]): the grouped tournament
        over kernel 5's group maxima when the union is large enough, else
        full f32 scores in chunks of at most 32k rows, each chunk's top-k
        merged."""
        m_pad = codes.shape[0]
        if m_pad // (_GROUP * _SUPERGROUP) >= max(k, 2):
            return self._scan(qs, codes, xsq, k, valid)
        # chunk sizes divide m_pad: buckets are {1, 1.5} x powers of two
        limit = 1 << 15
        bs = m_pad if m_pad <= limit else (
            limit if m_pad % limit == 0 else limit // 2)

        def block_scores(start):
            s = qs @ codes[start:start + bs].float().T
            if self.metric == "l2":
                s = 2.0 * s - xsq[None, start:start + bs]
            return s

        return _blocked_topk(block_scores, m_pad, bs, valid, k)

    # ------------------------------------------------------------- persist
    def _save_extra(self) -> dict:
        return {"host_ivf": True, "nlist": self.nlist, "nprobe": self.nprobe,
                "centroids": _to_host(self._centroids),
                "offsets": self._offsets, "order": self._order}

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"
             ) -> "HostIvfSearcher":
        data = np.load(_npz_path(path), allow_pickle=True)
        if "host_ivf" not in data.files:
            raise ValueError(
                "not a HostIvfSearcher file (no cluster layout) — load it "
                "with StreamingSqSearcher.load")
        s = cls(int(data["dim"]), str(data["metric"]),
                qtype=str(data["qtype"]), nlist=int(data["nlist"]),
                nprobe=int(data["nprobe"]),
                block_items=int(data["block_items"]),
                query_block=int(data["query_block"]), device=device)
        s._centroids = torch.from_numpy(
            np.asarray(data["centroids"], np.float32)).to(s.device)
        s._offsets = np.asarray(data["offsets"])
        s._order = np.asarray(data["order"])
        # xsq comes from the sidecar in stored order, or is recomputed from
        # the stored-order codes: right for the cluster-sorted layout too
        s._load_common(data)
        return s
