from recommendflow_tpu_torch.data.schema import (
    PAD_ID, BatchSchema, FeatureSlot, TableGroup, TableSpec, compile_schema,
)
from recommendflow_tpu_torch.data.recordio import ColumnSpec, RecordWriter, iter_blocks, count_rows
from recommendflow_tpu_torch.data.pipeline import (
    Dataset, make_dataset, prefetch, resolve_paths, split_files, shard_for_host,
)
from recommendflow_tpu_torch.data.hashing import hash64, hash_bucket, hash_bucket_array
