"""The parallel layer: process groups, the device mesh and its sharding
rules, the row-sharded embedding (the counterpart of
`recommendflow_tpu/parallel/`)."""
from recommendflow_tpu_torch.parallel.distributed import (  # noqa: F401
    host_id, init_distributed, num_hosts,
)
from recommendflow_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, P, apply_shardings, data_parallel, expert_sharding_rules,
    is_table_param, make_mesh, merge_rules, shard_batch, table_sharding_rules,
)
from recommendflow_tpu_torch.parallel.sharded_embedding import (  # noqa: F401
    gather_local_rows, local_gather_psum, shard_tables, sharded_gather_group,
)
