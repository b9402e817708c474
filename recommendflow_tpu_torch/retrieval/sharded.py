"""Exact top-k retrieval over a corpus row-sharded across the ranks of a
mesh (the counterpart of `recommendflow_tpu/retrieval/sharded.py`):
`ShardedSearcher` (f32) and `ShardedSqSearcher` (bf16 and sq8 codes).

Every rank holds an equal block of the padded corpus (padded per shard to
a multiple of 65536 rows at scale, 512 for small corpora) and runs the same
exact scan over it: the grouped tournament, whose group maxima come from
kernel 5 (`grouped_score_max`: its f32, bf16 and uint8 forms), or plain
scores for a small block. An `all_gather` of every rank's (score, global
index) top-k and one top-k over the gathered candidates give the global
exact top-k (a global top-k item is a top-k item of its own shard).

A block cuts the corpus at an arbitrary offset, so a rank's valid row count
masks by over-inclusion: groups wholly past it score NEG, the one group
that straddles it is pinned to +BIG and always carried, and the exact
per-item mask applies at the rescore. The tournament therefore selects
k + 1 groups, so that the pinned group takes the extra slot instead of
displacing a true top-k group.

A search is a collective: every rank calls it with the same queries and
gets the same result. save / pickle gather the corpus first; a saved index
loads at any world size (the mesh is rebuilt over the restoring world, the
corpus re-cut).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from recommendflow_tpu_torch.ops.cuda.grouped_topk import grouped_score_max
from recommendflow_tpu_torch.parallel.distributed import all_gather_list
from recommendflow_tpu_torch.parallel.mesh import Mesh, make_mesh
from recommendflow_tpu_torch.retrieval._kernels import (
    NEG, _GROUP, _SUPERGROUP, _blocked_topk, _l2_from_surrogate,
    _l2_normalize, _to_host, _tournament_select)
from recommendflow_tpu_torch.retrieval.flat import FlatSearcher, _npz_path
from recommendflow_tpu_torch.retrieval.sq import SqSearcher

BIG = 1e30


def _mask_groups(m1: torch.Tensor, valid: int, group: int) -> torch.Tensor:
    """Over-inclusion masking of group maxima [Q, n_groups] against a
    shard's valid row count, in place: groups wholly below it keep their
    maxima, the single straddling group is pinned +BIG (always selected;
    the exact per-item mask applies at the rescore), groups past it score
    NEG. Two column writes: the [Q, n_groups] maxima are GBs at scale."""
    n_full, rem = divmod(int(valid), group)
    m1[:, n_full + (1 if rem else 0):] = NEG
    if rem:
        m1[:, n_full] = BIG
    return m1


def _gathered_merge(queries: torch.Tensor, s: torch.Tensor, i: torch.Tensor,
                    group, k: int, metric: str):
    """All-gather every rank's (surrogate scores, GLOBAL indices) [Q, k_l]
    and reduce to the global top-k; l2 surrogates become distances after
    the merge."""
    s_flat = torch.cat(all_gather_list(s, group), dim=1)
    i_flat = torch.cat(all_gather_list(i, group), dim=1)
    top, pos = torch.topk(s_flat, k, dim=1)
    idx = torch.gather(i_flat, 1, pos)
    if metric == "l2":
        top = _l2_from_surrogate(queries, top)
    return top, idx


def _items_axis_size(mesh: Mesh, axis: str) -> int:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    if axis not in mesh.axis_names:
        raise ValueError(
            f"mesh {mesh.shape} has no '{axis}' axis — sharded searchers "
            f"shard the corpus along an axis named '{axis}'")
    return mesh.size(axis)


def _per_shard(num_items: int, n_sh: int) -> int:
    """A shard's row multiple: 65536 at scale, 512 for small corpora (both
    multiples of _GROUP * _SUPERGROUP)."""
    return 65536 if num_items > 131072 * n_sh else 512


def _default_mesh(axis: str) -> Mesh:
    return make_mesh((axis,), current=False)


def _gather_rows(local: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every rank's block, concatenated (on the host) in rank order."""
    return torch.cat([t.cpu() for t in all_gather_list(local,
                                                        mesh.group(axis))])


class _Sharded:
    """What both sharded searchers share: the mesh, and the state of a
    pickle (the whole corpus on the host, no mesh: the restoring world
    builds its own)."""

    AXIS = "items"

    def _init_mesh(self, mesh: Optional[Mesh]) -> None:
        self.mesh = mesh if mesh is not None else _default_mesh(self.AXIS)
        _items_axis_size(self.mesh, self.AXIS)

    @property
    def _shard(self):
        """(shard count, this rank's shard index)."""
        return self.mesh.size(self.AXIS), self.mesh.rank(self.AXIS)

    def _local_window(self, n_local: int):
        """(offset, valid rows) of this rank's block."""
        n_sh, r = self._shard
        offset = r * n_local
        return offset, int(np.clip(self.num_items - offset, 0, n_local))

    def _hier(self, n_local: int, k_local: int) -> bool:
        """The JAX package's rule: the select_k = k_local + 1 tournament
        slots must fit in the local supergroup count."""
        G, G2 = _GROUP, _SUPERGROUP
        return (n_local % (G * G2) == 0
                and n_local // (G * G2) > max(k_local + 1, 64))

    def _merge(self, queries, s, i, k):
        return _gathered_merge(queries, s, i, self.mesh.group(self.AXIS), k,
                               self.metric)


class ShardedSearcher(_Sharded, FlatSearcher):
    """FlatSearcher with the item axis sharded over the mesh axis 'items'.

    Same surface as FlatSearcher (train / add / search / save / load /
    pickle; the matmul metrics ip, cos, l2). The corpus lives on each
    rank's device (the mesh's), N / n_shards rows per rank, so capacity
    scales with the mesh. `mesh` defaults to a one-axis mesh over the
    world."""

    SUPPORTED_METRICS = ("ip", "cos", "l2")

    def __init__(self, dim: int, metric: str = "cos",
                 mesh: Optional[Mesh] = None, query_block: int = 4096):
        self._init_mesh(mesh)
        super().__init__(dim, metric, query_block=query_block,
                         device=self.mesh.device)

    def train(self, vectors: np.ndarray,
              items: Optional[Sequence[Any]] = None):
        """Every rank passes the whole corpus and keeps its block."""
        vectors = self._prepare(vectors)
        self.num_items = len(vectors)
        n_sh, r = self._shard
        per = _per_shard(self.num_items, n_sh)
        local = -(-self.num_items // (per * n_sh)) * per
        lo, hi = r * local, min((r + 1) * local, self.num_items)
        block = torch.zeros((local, self.dim), dtype=torch.float32,
                            device=self.device)
        if hi > lo:
            block[:hi - lo] = torch.from_numpy(
                np.ascontiguousarray(vectors[lo:hi])).to(self.device)
        self._vecs = block
        self._sq_norms = None
        if self.metric == "l2":
            self._sq_norms = (block * block).sum(-1)
        self.items = np.asarray(items) if items is not None \
            else np.arange(self.num_items)
        self._search_fn = {}
        return self

    def _full_vectors(self) -> np.ndarray:
        return _to_host(_gather_rows(self._vecs, self.mesh, self.AXIS)
                        )[:self.num_items]

    def add(self, vectors: np.ndarray, items=None):
        vectors = np.asarray(vectors, np.float32)
        if self._vecs is None:
            return self.train(vectors, items)
        new_items = np.asarray(items) if items is not None else \
            np.arange(self.num_items, self.num_items + len(vectors))
        return self.train(np.concatenate([self._full_vectors(), vectors]),
                          items=np.concatenate([self.items, new_items]))

    def _build_search(self, k: int):
        metric, dim = self.metric, self.dim
        n_local = int(self._vecs.shape[0])
        offset, valid = self._local_window(n_local)
        k_local = min(k, n_local)
        vecs, sqn = self._vecs, self._sq_norms
        G = _GROUP
        if self._hier(n_local, k_local):
            vecs_g = vecs.view(n_local // G, G, dim)
            sqn_g = sqn.view(n_local // G, G) if metric == "l2" else None

            def run(queries):
                m1 = grouped_score_max(queries, vecs,
                                       sqn if metric == "l2" else None,
                                       group=G, num_items=n_local)
                m1 = _mask_groups(m1, valid, G)
                s, i = _tournament_select(queries, m1, vecs_g, sqn_g,
                                          k_local, k_local + 1, valid, metric)
                return self._merge(queries, s, i + offset, k)
            return run

        def run_plain(queries):
            s = queries @ vecs.T
            if metric == "l2":
                s = 2.0 * s - sqn[None, :]
            s[:, valid:] = NEG
            s, i = torch.topk(s, k_local, dim=1)
            return self._merge(queries, s, i + offset, k)
        return run_plain

    # ------------------------------------------------------------- persist
    def save(self, path: str):
        """The JAX package's `.npz` keys, the whole corpus gathered from
        every rank (a collective); rank 0 of the axis writes."""
        if self._vecs is None:
            raise RuntimeError("nothing to save")
        vecs = self._full_vectors()
        if self._shard[1] == 0:
            np.savez_compressed(path, vecs=vecs, items=self.items,
                                dim=self.dim, metric=self.metric)
        torch.distributed.barrier(group=self.mesh.group(self.AXIS))

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None
             ) -> "ShardedSearcher":
        """A saved Flat or sharded index, cut over this world's mesh."""
        data = np.load(_npz_path(path), allow_pickle=True)
        s = cls(int(data["dim"]), str(data["metric"]), mesh=mesh)
        return s.train(data["vecs"], items=data["items"])

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_vecs"] = self._full_vectors() if self._vecs is not None \
            else None
        state.update(mesh=None, device=None, _sq_norms=None, _search_fn={})
        return state

    def __setstate__(self, state):
        vecs = state.pop("_vecs")
        self.__dict__.update(state)
        self._init_mesh(None)
        self.device = self.mesh.device
        self._vecs = None
        if vecs is not None:
            self.train(vecs, items=state.get("items"))


class ShardedSqSearcher(_Sharded, SqSearcher):
    """SqSearcher with the quantized codes row-sharded over the mesh axis
    'items'. Scoring is SqSearcher's: q·x̂ = q·vmin + (q ⊙ scale)·codes for
    sq8 (the codes never dequantized), the per-query base a rank-preserving
    shift left out of the group selection; bf16 codes against the queries
    rounded to bf16. Each rank scans its block through kernel 5's bf16 or
    uint8 form, or by item blocks for a small block."""

    def __init__(self, dim: int, metric: str = "cos", qtype: str = "bf16",
                 mesh: Optional[Mesh] = None, item_block: int = 65536,
                 query_block: int = 2048):
        self._init_mesh(mesh)
        super().__init__(dim, metric, qtype=qtype, item_block=item_block,
                         query_block=query_block, device=self.mesh.device)

    def _pad_rows(self, n: int) -> int:
        n_sh, _ = self._shard
        per = _per_shard(n, n_sh)
        return max(-(-n // (per * n_sh)), 1) * per * n_sh

    def _restore_codes(self, codes: Union[np.ndarray, torch.Tensor]):
        """SqSearcher's padding, encoding of ‖x̂‖² and placement over the
        whole corpus, then this rank's block of each."""
        super()._restore_codes(codes)
        n_sh, r = self._shard
        local = self._codes.shape[0] // n_sh
        self._codes = self._codes[r * local:(r + 1) * local].clone()
        if self._xhat_sq is not None:
            self._xhat_sq = self._xhat_sq[r * local:(r + 1) * local].clone()

    def _full_codes(self) -> torch.Tensor:
        return _gather_rows(self._codes, self.mesh, self.AXIS)[:self.num_items]

    def add(self, vectors, items=None):
        if self._codes is None:
            return self.train(vectors, items)
        vectors = self._prepare(vectors)
        new_items = np.asarray(items) if items is not None else \
            np.arange(self.num_items, self.num_items + len(vectors))
        new = self._encode(vectors) if self.qtype == "sq8" else \
            torch.from_numpy(np.ascontiguousarray(vectors)).to(
                self.device).to(torch.bfloat16)
        codes = torch.cat([self._full_codes().to(self.device), new])
        self.items = np.concatenate([self.items, new_items])
        self.num_items += len(vectors)
        self._restore_codes(codes)
        return self

    def _build_search(self, k: int):
        metric, dim = self.metric, self.dim
        sq8 = self.qtype == "sq8"
        codes, xsq = self._codes, self._xhat_sq
        n_local = int(codes.shape[0])
        offset, valid = self._local_window(n_local)
        k_local = min(k, n_local)
        G = _GROUP
        # the largest power-of-two-scaled block <= item_block dividing the
        # block's rows (always a multiple of 512)
        bn = min(self.item_block, n_local)
        while bn > 512 and n_local % bn:
            bn //= 2
        if n_local % bn:
            bn = 512

        def affine(queries):
            if sq8:
                return queries * self._scale[None, :], queries @ self._vmin
            return queries, torch.zeros(queries.shape[0],
                                        device=queries.device)

        if self._hier(n_local, k_local) and bn % G == 0:
            codes_g = codes.view(n_local // G, G, dim)
            xsq_g = xsq.view(n_local // G, G) if metric == "l2" else None

            def run(queries):
                qs, base = affine(queries)
                m1 = grouped_score_max(qs, codes,
                                       xsq if metric == "l2" else None,
                                       group=G, num_items=n_local)
                m1 = _mask_groups(m1, valid, G)
                s, i = _tournament_select(qs, m1, codes_g, xsq_g, k_local,
                                          k_local + 1, valid, metric,
                                          base=base)
                return self._merge(queries, s, i + offset, k)
            return run

        def run_blocks(queries):
            qs, base = affine(queries)
            qs = qs.to(torch.bfloat16).float()     # bf16 operand, f32 sums

            def block_scores(start):
                s = qs @ codes[start:start + bn].float().T + base[:, None]
                return 2.0 * s - xsq[None, start:start + bn] \
                    if metric == "l2" else s

            s, i = _blocked_topk(block_scores, n_local, bn, valid, k_local)
            return self._merge(queries, s, i + offset, k)
        return run_blocks

    def reconstruct(self, indices) -> np.ndarray:
        idx = torch.from_numpy(np.atleast_1d(np.asarray(indices)).astype(
            np.int64))
        return _to_host(self._decode(self._full_codes()[idx].to(self.device)))

    # ------------------------------------------------------------- persist
    def save(self, path: str):
        """SqSearcher's `.npz`, the codes gathered from every rank (a
        collective); rank 0 of the axis writes."""
        if self._codes is None:
            raise RuntimeError("nothing to save")
        codes = _to_host(self._full_codes())
        if self._shard[1] == 0:
            extra = {}
            if self.qtype == "sq8":
                extra = {"vmin": _to_host(self._vmin),
                         "scale": _to_host(self._scale)}
            np.savez_compressed(
                path, codes=codes, items=self.items, dim=self.dim,
                metric=self.metric, sq=True, qtype=self.qtype,
                item_block=self.item_block, query_block=self.query_block,
                **extra)
        torch.distributed.barrier(group=self.mesh.group(self.AXIS))

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None
             ) -> "ShardedSqSearcher":
        """A saved SQ or sharded SQ index, cut over this world's mesh."""
        data = np.load(_npz_path(path), allow_pickle=True)
        s = cls(int(data["dim"]), str(data["metric"]),
                qtype=str(data["qtype"]), mesh=mesh,
                item_block=int(data["item_block"]),
                query_block=int(data["query_block"]))
        s.items = data["items"]
        s.num_items = len(data["codes"])
        if s.qtype == "sq8":
            s._vmin = torch.from_numpy(data["vmin"]).to(s.device)
            s._scale = torch.from_numpy(data["scale"]).to(s.device)
        s._restore_codes(data["codes"])
        return s

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_codes"] = _to_host(self._full_codes()) \
            if self._codes is not None else None
        for key in ("_vmin", "_scale"):
            t = getattr(self, key)
            state[key] = None if t is None else _to_host(t)
        state.update(mesh=None, device=None, _vecs=None, _sq_norms=None,
                     _xhat_sq=None, _search_fn={})
        return state

    def __setstate__(self, state):
        codes = state.pop("_codes")
        self.__dict__.update(state)
        self._init_mesh(None)
        self.device = self.mesh.device
        for key in ("_vmin", "_scale"):
            if state[key] is not None:
                setattr(self, key, torch.from_numpy(state[key]).to(self.device))
        self._codes = None
        if codes is not None:
            self._restore_codes(codes)
