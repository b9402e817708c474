"""A small DLRM-DCNv2 configuration and the tasks that the gloo worker
pool (tests/_torch_dist.py) runs for tests/test_torch_dlrm_dcnv2.py,
torch only.

The configuration keeps MLPerf's 26 sparse fields with their multi-hot
sizes (bags of 1 to 100 ids, 214 an example) and 13 dense fields, at
tiny cardinalities but for the first field's 140,000 rows: its stacked
dim-8 table then holds over 8192 stored rows, which the mesh row-shards
(`parallel.mesh.table_sharding_rules`)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
             27, 10, 3, 1, 1)
SPARSE = tuple(f"c{i + 1:02d}" for i in range(26))
DENSE = tuple(f"i{i + 1:02d}" for i in range(13))
CARD = (140_000,) + tuple(5 + 7 * i for i in range(1, 26))
DIM = 8
ARCH = {"bottom_units": [16, DIM], "cross_layers": 3, "low_rank": 4,
        "top_units": [16, 8]}


def port_conf(table_dtype: str = "float32") -> Dict:
    """The configuration dict (`Configuration(conf=...)`)."""
    lines = [f"{n},int,ad,lookup,{c},{DIM},sum,true"
             for n, c in zip(SPARSE, CARD)]
    lines += ["dense,float,ad,numeric,null,-1,null,true",
              "label,float,label,numeric,null,-1,null,true"]
    groups = {n: [n] for n in SPARSE}
    groups["dense"] = list(DENSE)
    return {
        "Features": {"feature_group": groups,
                     "feature_fields": ["group", "type", "tower", "deal",
                                        "vocab", "embedding_dim", "pooling",
                                        "working"],
                     "features": " ".join(lines)},
        "Variables": {"seeds": [2022, 2023],
                      "max_len_map": dict(zip(SPARSE, MULTI_HOT))},
        "Networks": {"class": "recommendflow_tpu_torch.models.ranking.dlrm."
                     "DlrmDcnV2", "table_dtype": table_dtype, **ARCH},
        "Train": {"epoch": 1, "batch_size": 16},
        "Experiments": {"feature_exp": {}, "experiment_fields": [],
                        "experiments": None}}


def make_batch(rows: int, seed: int) -> Dict[str, np.ndarray]:
    """Ids [B, 1, L] Zipf(1.2) folded into each field's rows (id 0, the pad,
    among them), dense fields [B, 1] uniform, labels a fair coin."""
    rng = np.random.default_rng(seed)
    batch = {n: ((rng.zipf(1.2, size=(rows, 1, L)) - 1) % (c + 1)
                 ).astype(np.int32)
             for n, L, c in zip(SPARSE, MULTI_HOT, CARD)}
    batch.update({n: rng.random((rows, 1), dtype=np.float32) for n in DENSE})
    batch["label"] = (rng.random(rows) > 0.5).astype(np.float32)
    return batch


def build(table_dtype: str = "float32", mesh=None, seed: int = 0):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.models.base import build_network
    conf = Configuration(conf=port_conf(table_dtype))
    model, _ = build_network(conf.networks["class"], {
        "conf": conf, "device": "cpu", "seed": seed, "mesh": mesh})
    return model


def load_whole(model, dense: Dict[str, np.ndarray], table: np.ndarray,
               rank: int = 0) -> None:
    """The dense weights and the whole stacked table (rank `rank`'s block
    of it where the model holds a block) into `model`."""
    import torch
    named = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in dense.items():
            named[k].copy_(torch.from_numpy(v))
        t = named[f"embedder.table_dim{DIM}"]
        whole = torch.from_numpy(table).view(-1, t.shape[1]).to(t.dtype)
        rows = t.shape[0]
        t.copy_(whole[rank * rows:(rank + 1) * rows] if rows < whole.shape[0]
                else whole)


def mesh_fit(rank: int, world: int, dense, table, batches: List[Dict],
             lr: float, table_lr: float):
    """Three steps of `Trainer.fit` on this rank's rows of each global
    batch, the model built at its block (`mesh=`) and loaded with the
    given weights: (the epoch's mean loss, the dense parameters, the whole
    table gathered, the table's row-shard mark's rows)."""
    from recommendflow_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from recommendflow_tpu_torch.parallel.sharded_embedding import full_rows
    from recommendflow_tpu_torch.train.trainer import Trainer
    mesh = make_mesh()
    model = build(mesh=mesh)
    load_whole(model, dense, table, mesh.rank("dp"))
    trainer = Trainer(model, learning_rate=lr, table_learning_rate=table_lr,
                      device="cpu", mesh=mesh, shard_tables=True)
    out = trainer.fit([shard_batch(mesh, b) for b in batches], verbose=False)
    named = dict(model.named_parameters())
    t = named[f"embedder.table_dim{DIM}"]
    return (out["history"][0]["loss"],
            {k: v.detach().numpy() for k, v in named.items() if "table" not in k},
            full_rows(t).detach().numpy(), t.row_shard.rows)


def lookup_spans(rank: int, world: int, rows: int):
    """One training forward and backward of this rank's `rows` rows under
    a CPU profiler: the recorded `shard.lookup` and `shard.lookup_grad`
    spans' counts."""
    import torch
    from recommendflow_tpu_torch.parallel.mesh import (data_parallel,
                                                       make_mesh, shard_batch)
    from recommendflow_tpu_torch.parallel.sharded_embedding import \
        mark_row_shard
    from recommendflow_tpu_torch.utils import profiling
    mesh = make_mesh()
    model = build(mesh=mesh).train()
    mark_row_shard(getattr(model.embedder, f"table_dim{DIM}"), mesh, "dp")
    batch = shard_batch(mesh, make_batch(rows * world, seed=5))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    profiling._SPANS.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with data_parallel(mesh):
            loss, _ = model(batch)
        loss.backward()
    return [(s.name, dict(s.counts)) for s in profiling.spans()
            if s.name.startswith("shard.")]
