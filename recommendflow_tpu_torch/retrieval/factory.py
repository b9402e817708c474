"""index_factory: FAISS-style index strings -> the port's searcher families
(the counterpart of `recommendflow_tpu/retrieval/factory.py`)."""
from __future__ import annotations

import re

from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
from recommendflow_tpu_torch.retrieval.host_tier import (HostIvfSearcher,
                                                        StreamingSqSearcher)
from recommendflow_tpu_torch.retrieval.ivf import IvfSearcher
from recommendflow_tpu_torch.retrieval.pq import IvfPqSearcher, PqSearcher
from recommendflow_tpu_torch.retrieval.sharded import (ShardedSearcher,
                                                       ShardedSqSearcher)
from recommendflow_tpu_torch.retrieval.sq import SqSearcher

_HOST_QTYPE = {"flat": "f32", "sq8": "sq8", "sqfp16": "bf16", "sqbf16": "bf16"}


def index_factory(dim: int, index_param: str = "Flat",
                  metric: str = "cos", **kwargs) -> FlatSearcher:
    """'Flat' -> exact FlatSearcher; 'IVF{n},Flat' / 'IVF{n}' -> IvfSearcher
    with n lists; 'PQ{m}' / 'PQ{m}x8' -> PqSearcher with m subspaces;
    'IVF{n},PQ{m}[x8]' -> IvfPqSearcher; 'SQ8' / 'SQfp16' / 'SQbf16' ->
    SqSearcher (fp16 maps to bf16). The host-RAM tier: 'HostFlat' /
    'HostSQ8' / 'HostSQfp16' / 'HostSQbf16' -> StreamingSqSearcher (qtype
    f32, sq8, bf16, bf16), 'HostIVF{n}[,Flat|SQ8|SQfp16|SQbf16]' ->
    HostIvfSearcher with n lists (SQ8 by default). Other keyword arguments,
    `device` among them, go to the searcher.

    `mesh=` (a parallel.mesh.Mesh with an 'items' axis) row-shards the
    corpus over the mesh's ranks: 'Flat' -> ShardedSearcher, 'SQ*' ->
    ShardedSqSearcher; any other string raises the JAX package's
    ValueError (IVF and PQ have no sharded form, the host tier streams from
    one host)."""
    spec = (index_param or "Flat").strip()
    mesh = kwargs.pop("mesh", None)
    m = re.match(r"^Host(Flat|SQ8|SQfp16|SQbf16)$", spec, re.IGNORECASE)
    m_ivf = re.match(r"^HostIVF(\d+)(?:,(Flat|SQ8|SQfp16|SQbf16))?$", spec,
                     re.IGNORECASE)
    if (m or m_ivf) and mesh is not None:
        raise ValueError("the host tier streams from one host — use "
                         "Sharded* (device-resident) for mesh scaling")
    if m:
        return StreamingSqSearcher(dim, metric, qtype=_HOST_QTYPE[
            m.group(1).lower()], **kwargs)
    if m_ivf:
        return HostIvfSearcher(dim, metric, qtype=_HOST_QTYPE[
            (m_ivf.group(2) or "SQ8").lower()], nlist=int(m_ivf.group(1)),
            **kwargs)
    m = re.match(r"^SQ(8|fp16|bf16)$", spec, re.IGNORECASE)
    if m:
        qtype = "sq8" if m.group(1) == "8" else "bf16"
        if mesh is not None:
            return ShardedSqSearcher(dim, metric, qtype=qtype, mesh=mesh,
                                     **kwargs)
        return SqSearcher(dim, metric, qtype=qtype, **kwargs)
    if mesh is not None:
        if spec.lower() != "flat":
            raise ValueError(
                f"mesh sharding supports Flat and SQ* indices, not '{spec}'")
        return ShardedSearcher(dim, metric, mesh=mesh, **kwargs)
    m = re.match(r"^IVF(\d+),PQ(\d+)(x8)?$", spec, re.IGNORECASE)
    if m:
        return IvfPqSearcher(dim, metric, nlist=int(m.group(1)),
                             num_subspaces=int(m.group(2)), **kwargs)
    m = re.match(r"^IVF(\d+)(,Flat)?$", spec, re.IGNORECASE)
    if m:
        return IvfSearcher(dim, metric, nlist=int(m.group(1)), **kwargs)
    m = re.match(r"^PQ(\d+)(x8)?$", spec, re.IGNORECASE)
    if m:
        return PqSearcher(dim, metric, num_subspaces=int(m.group(1)), **kwargs)
    if spec.lower() == "flat":
        return FlatSearcher(dim, metric, **kwargs)
    raise ValueError(f"unsupported index_param '{index_param}' "
                     "(supported: Flat, IVF{n}[,Flat], PQ{m}[x8], "
                     "IVF{n},PQ{m}[x8], SQ8, SQfp16/SQbf16, "
                     "Host(Flat|SQ8|SQfp16|SQbf16), HostIVF{n}[,...])")
