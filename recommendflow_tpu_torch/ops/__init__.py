"""The embedding engine, the model building blocks and the CUDA kernels'
wrappers (`ops/cuda/`)."""
from recommendflow_tpu_torch.ops.embedding import (  # noqa: F401
    embed_batch, gather_group, init_tables, lookup_feature, take_rows,
)
