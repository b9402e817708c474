"""The searcher families and their shared pieces under one name (the
counterpart of `recommendflow_tpu/retrieval/searcher.py`, with the host-RAM
tier and the mesh-sharded searchers beside them)."""
from recommendflow_tpu_torch.retrieval._kernels import (  # noqa: F401
    NEG, _DISTANCE_METRICS, _FAISS_METRIC_INTS, _GROUP, _HIER_MIN_ITEMS,
    _SUPERGROUP, _assign_blocks, _build_capped_lists, _l2_normalize,
    _make_pairwise_distance, _pq_decode_np, _pq_encode, _pq_train_codebooks,
    _tournament_select, kmeans, resolve_metric,
)
from recommendflow_tpu_torch.retrieval.flat import FlatSearcher  # noqa: F401
from recommendflow_tpu_torch.retrieval.ivf import IvfSearcher  # noqa: F401
from recommendflow_tpu_torch.retrieval.pq import (  # noqa: F401
    IvfPqSearcher, PqSearcher,
)
from recommendflow_tpu_torch.retrieval.sq import SqSearcher  # noqa: F401
from recommendflow_tpu_torch.retrieval.host_tier import (  # noqa: F401
    HostIvfSearcher, StreamingSqSearcher,
)
from recommendflow_tpu_torch.retrieval.sharded import (  # noqa: F401
    ShardedSearcher, ShardedSqSearcher,
)
from recommendflow_tpu_torch.retrieval.factory import index_factory  # noqa: F401
