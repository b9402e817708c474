"""index_factory: FAISS-style index strings -> the port's searcher families
(the counterpart of `recommendflow_tpu/retrieval/factory.py`)."""
from __future__ import annotations

import re

from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
from recommendflow_tpu_torch.retrieval.ivf import IvfSearcher
from recommendflow_tpu_torch.retrieval.pq import IvfPqSearcher, PqSearcher
from recommendflow_tpu_torch.retrieval.sq import SqSearcher


def index_factory(dim: int, index_param: str = "Flat",
                  metric: str = "cos", **kwargs) -> FlatSearcher:
    """'Flat' -> exact FlatSearcher; 'IVF{n},Flat' / 'IVF{n}' -> IvfSearcher
    with n lists; 'PQ{m}' / 'PQ{m}x8' -> PqSearcher with m subspaces;
    'IVF{n},PQ{m}[x8]' -> IvfPqSearcher; 'SQ8' / 'SQfp16' / 'SQbf16' ->
    SqSearcher (fp16 maps to bf16). Other keyword arguments, `device` among
    them, go to the searcher.

    The host-RAM tier ('Host*', 'HostIVF*') and the mesh-sharded searchers
    (`mesh=`) are not ported yet and raise NotImplementedError."""
    spec = (index_param or "Flat").strip()
    if kwargs.pop("mesh", None) is not None:
        raise NotImplementedError(
            "mesh-sharded searchers (index_factory(..., mesh=)) come with "
            "the parallel slice of the port")
    if re.match(r"^Host", spec, re.IGNORECASE):
        raise NotImplementedError(
            f"'{spec}': the host-RAM tier (StreamingSqSearcher, "
            "HostIvfSearcher) comes with the host-tier slice of the port")
    m = re.match(r"^SQ(8|fp16|bf16)$", spec, re.IGNORECASE)
    if m:
        qtype = "sq8" if m.group(1) == "8" else "bf16"
        return SqSearcher(dim, metric, qtype=qtype, **kwargs)
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
                     "IVF{n},PQ{m}[x8], SQ8, SQfp16/SQbf16)")
