"""Shared retrieval pieces: metric resolution, pairwise distances, the
tournament top-k selector, k-means and the IVF/PQ list and codebook tools
(the counterpart of `recommendflow_tpu/retrieval/_kernels.py`).

Every function runs on the device of the tensors it is given. Random draws
(k-means seeds) come from a CPU `torch.Generator`, so the card and the CPU
start from the same centroids; they cannot equal `jax.random`'s draws, so
parity tests carry the JAX package's k-means state across instead.
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

# distance metrics beyond the matmul family (smaller = better; search returns
# them ascending, FAISS-style)
_DISTANCE_METRICS = ("l1", "l_inf", "l_p", "brayCurtis", "canberra",
                     "jensen_shannon")
# FAISS MetricType enum values -> names (configs may pass the raw ints)
_FAISS_METRIC_INTS = {0: "ip", 1: "l2", 2: "l1", 3: "l_inf", 4: "l_p",
                      20: "canberra", 21: "brayCurtis", 22: "jensen_shannon"}


def _l2_normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _to_host(x: torch.Tensor) -> np.ndarray:
    """Device tensor -> host numpy (one process; a bf16 tensor widens to f32
    exactly, numpy having no bf16)."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def resolve_metric(measurement: Union[str, int]) -> str:
    """A metric name, or a raw FAISS MetricType int."""
    if isinstance(measurement, (int, np.integer)):
        if int(measurement) not in _FAISS_METRIC_INTS:
            raise ValueError(
                f"unknown FAISS MetricType int {measurement}; known: "
                f"{_FAISS_METRIC_INTS}")
        return _FAISS_METRIC_INTS[int(measurement)]
    return str(measurement)


def _make_pairwise_distance(metric: str, p: float):
    """[Q, D] x [Nb, D] -> [Q, Nb] distance block, FAISS formulas: Lp is
    sum|x-y|^p without the 1/p root; Canberra skips zero-denominator terms;
    JensenShannon assumes non-negative inputs and guards zeros. The block
    materialises a [Q, Nb, D] temporary: callers bound Q * Nb."""
    if metric not in _DISTANCE_METRICS:
        raise ValueError(f"not a distance metric: {metric}")

    def dist(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        x, y = q[:, None, :], v[None, :, :]
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        if metric == "jensen_shannon":
            m = torch.clamp(0.5 * (x + y), min=1e-20)
            t1 = torch.where(x > 0, x * torch.log(torch.clamp(x, min=1e-20) / m),
                             zero)
            t2 = torch.where(y > 0, y * torch.log(torch.clamp(y, min=1e-20) / m),
                             zero)
            return 0.5 * torch.sum(t1 + t2, -1)
        diff = torch.abs(x - y)
        if metric == "l1":
            return torch.sum(diff, -1)
        if metric == "l_inf":
            return torch.amax(diff, -1)
        if metric == "l_p":
            return torch.sum(diff ** p, -1)
        if metric == "brayCurtis":
            den = torch.sum(torch.abs(x + y), -1)
            return torch.sum(diff, -1) / torch.clamp(den, min=1e-20)
        den = torch.abs(x) + torch.abs(y)                       # canberra
        return torch.sum(torch.where(den > 0, diff / torch.clamp(den, min=1e-20),
                                     zero), -1)
    return dist


def _l2_from_surrogate(queries: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """The 2q·v − ‖v‖² surrogate the scans rank by, back to the real L2
    distance sqrt(‖q‖² − surrogate)."""
    q_sq = torch.sum(queries ** 2, dim=-1, keepdim=True)
    return torch.sqrt(torch.clamp(q_sq - top, min=0.0))


def _blocked_topk(block_scores, n_pad: int, block: int, num_items: int, k: int):
    """Top-k over item blocks: block_scores(start) -> [Q, block] scores of
    items start.., masked to NEG from num_items, a per-block top-k and one
    merge, so no [Q, N] score matrix exists. The caller clamps k to
    num_items, which the merged pool always covers."""
    k_eff = min(k, block)
    parts_s, parts_i = [], []
    for start in range(0, n_pad, block):
        s = block_scores(start)
        s[:, max(0, num_items - start):] = NEG
        bs, bp = torch.topk(s, k_eff, dim=1)
        parts_s.append(bs)
        parts_i.append(bp + start)
    top, pos = torch.topk(torch.cat(parts_s, dim=1), k, dim=1)
    return top, torch.gather(torch.cat(parts_i, dim=1), 1, pos)


def _tournament_select(queries: torch.Tensor, m1: torch.Tensor,
                       vecs_g: torch.Tensor, sqn_g: Optional[torch.Tensor],
                       k: int, select_k: int, valid: int, metric: str,
                       base: Optional[torch.Tensor] = None):
    """Two-level tournament select + exact vector rescore.

    m1      [Q, n_groups] per-group score maxima (masked by the caller).
    vecs_g  [n_groups, G, D] grouped corpus view (f32, or the quantized codes
            of SqSearcher: widened to the query dtype); sqn_g [n_groups, G]
            squared norms (l2 only). Item indices >= valid score NEG.
    base    optional [Q] per-query term added to each rescored dot product
            before the l2 surrogate (q·vmin for SQ8 codes).
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
    if base is not None:
        cs = cs + base[:, None, None]
    cand = (gidx[:, :, None] * G + torch.arange(G, device=gidx.device)
            ).reshape(nq, select_k * G)
    if metric == "l2":
        cs = 2.0 * cs - sqn_g[gidx.reshape(-1)].reshape(nq, select_k, G)
    cs = torch.where(cand.reshape(nq, select_k, G) < valid, cs,
                     torch.full_like(cs, NEG)).reshape(nq, select_k * G)
    top_scores, p2 = torch.topk(cs, k, dim=1)
    return top_scores, torch.gather(cand, 1, p2)


# ------------------------------------------------------------------ k-means
def _nearest(x: torch.Tensor, c: torch.Tensor, c_sq: torch.Tensor) -> torch.Tensor:
    """Nearest centroid in L2: argmax 2 x·c − ‖c‖² (the first on a tie)."""
    return torch.argmax(2.0 * (x @ c.T) - c_sq[None, :], dim=1)


def kmeans(vectors: torch.Tensor, nlist: int, iters: int = 10,
           seed: int = 0, spherical: bool = False) -> torch.Tensor:
    """Lloyd's k-means on the vectors' device: [N, D] -> [nlist, D] f32
    centroids. The assignment runs in row blocks (a monolithic [N, C] score
    matrix is 16 GB at N = 1M, C = 4096), the update is a segment sum
    (`index_add_`); empty clusters keep their centroid; spherical=True
    renormalises the centroids every step (cos/ip). The initial centroids
    are nlist rows drawn by a CPU `torch.Generator(seed)` (with replacement
    only when N < nlist)."""
    n, d = vectors.shape
    dev = vectors.device
    g = torch.Generator().manual_seed(int(seed))
    if n < nlist:
        init = torch.randint(0, n, (nlist,), generator=g)
    else:
        init = torch.randperm(n, generator=g)[:nlist]
    centroids = vectors[init.to(dev)].float()
    # bound the per-block [block, C] score temporary to ~256 MB f32
    block = max(256, min(n, (1 << 26) // max(nlist, 1)))
    for _ in range(iters):
        c_sq = torch.sum(centroids * centroids, dim=1)
        sums = torch.zeros((nlist, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((nlist,), dtype=torch.float32, device=dev)
        for start in range(0, n, block):
            xb = vectors[start:start + block].float()
            a = _nearest(xb, centroids, c_sq)
            sums.index_add_(0, a, xb)
            counts.index_add_(0, a, torch.ones_like(a, dtype=torch.float32))
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        new = torch.where(counts[:, None] > 0, new, centroids)   # keep empties
        if spherical:
            new = new / torch.clamp(torch.linalg.norm(new, dim=1, keepdim=True),
                                    min=1e-12)
        centroids = new
    return centroids


# ------------------------------------------------------- shared IVF/PQ tools
def _assign_blocks(vecs: torch.Tensor, centroids: torch.Tensor, n: int,
                   block: int = 16384) -> np.ndarray:
    """Nearest-centroid assignment of the first n rows of a device corpus,
    in row blocks to bound the [block, nlist] score temporary (slices are
    views: the corpus is never copied). Returns int64 [n] on the host."""
    c_sq = torch.sum(centroids * centroids, dim=1)
    parts = [_nearest(vecs[s:min(n, s + block)], centroids, c_sq)
             for s in range(0, n, block)]
    if not parts:
        return np.empty(0, np.int64)
    return torch.cat(parts).cpu().numpy().astype(np.int64)


def _build_capped_lists(assign: np.ndarray, nlist: int, cap_factor: float):
    """Capped dense inverted lists + overflow (vectorized ~3 numpy passes).

    Returns (lists [nlist, M] int32 with -1 pads, overflow item order)."""
    n = len(assign)
    m = max(1, int(np.ceil(cap_factor * n / nlist)))
    order = np.argsort(assign, kind="stable")       # cluster-contiguous
    sorted_assign = assign[order]
    starts = np.searchsorted(sorted_assign, np.arange(nlist))
    rank = np.arange(n) - starts[sorted_assign]     # position within cluster
    keep = rank < m
    lists = np.full((nlist, m), -1, np.int64)
    lists[sorted_assign[keep], rank[keep]] = order[keep]
    return lists.astype(np.int32), order[~keep]


def _pq_train_codebooks(sample: np.ndarray, m: int, iters: int, seed: int,
                        device: torch.device) -> torch.Tensor:
    """Per-subspace 256-centroid codebooks [M, 256, D/M] f32: one k-means per
    subspace s over its [S, D/M] slice, seeded seed + s."""
    ds = sample.shape[1] // m
    sub = torch.from_numpy(np.ascontiguousarray(
        sample.reshape(len(sample), m, ds).transpose(1, 0, 2))).to(device)
    return torch.stack([kmeans(sub[s], 256, iters=iters, seed=seed + s)
                        for s in range(m)])


def _pq_encode(vectors: np.ndarray, codebooks: torch.Tensor) -> np.ndarray:
    """Encode [N, D] to uint8 codes [N, M] in device blocks (the [B, M, 256]
    score temporary bounds the block size): per subspace, the nearest
    codeword by argmax 2 x·c − ‖c‖²."""
    m, ds = int(codebooks.shape[0]), int(codebooks.shape[2])
    n = len(vectors)
    blk = 65536
    codes = np.empty((n, m), np.uint8)
    cb_sq = torch.sum(codebooks * codebooks, dim=-1)              # [M, 256]
    for start in range(0, n, blk):
        x = torch.from_numpy(np.ascontiguousarray(
            vectors[start:start + blk])).to(codebooks.device).view(-1, m, ds)
        s = torch.einsum("bmd,mkd->bmk", x, codebooks)
        s = 2.0 * s - cb_sq[None, :, :]
        codes[start:start + blk] = torch.argmax(s, dim=-1).to(
            torch.uint8).cpu().numpy()
    return codes


def _pq_decode_np(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Host-side decode of uint8 codes [B, M] -> [B, D] (reconstruction)."""
    codes = np.atleast_2d(np.asarray(codes))   # scalar-key reconstruct: [1, M]
    m = codebooks.shape[0]
    return codebooks[np.arange(m)[None, :], codes.astype(np.int64)] \
        .reshape(len(codes), -1)
