"""The training runtime on one card (the counterpart of
`recommendflow_tpu/train/trainer.py`): `Trainer` with `init_state`,
`train_step`, `evaluate`, `predict` and `fit`, and the module-level
`predict`.

A step runs eagerly on the card:

  1. split path (table_update "split", or "auto" on a row_injection model):
     each table's stored rows for the batch's fused ids are gathered OUTSIDE
     autograd (gather_rows) and handed to the model, so autograd yields
     [N, P*dim] row gradients and no table gradient;
  2. forward (training mode: BatchNorm batch statistics, dropout) -> loss;
     backward;
  3. Adam on the dense parameters (the tables are in no Adam group), at the
     schedule's LR for this step when `lr_schedule` is given;
  4. the tables' row-wise Adagrad, in place under no_grad: on the split
     path `split_tables_update`, one grouped duplicate sum over every split
     table (`combine_row_grads`), then per table its strategy ("dense":
     scatter_add_rows + rowwise_adagrad_update; "sparse_set":
     sparse_adagrad_apply; "sparse": plain torch); otherwise from the
     dense table gradient that take_rows' backward built with
     scatter_add_rows: on the touched rows only
     (`sparse_rowwise_adagrad_update`: table_update "sparse", or "auto" on a
     model without row_injection where the legacy planner finds it cheaper)
     or over the whole table (rowwise_adagrad_update).

Each split table's strategy comes from this card's cost model
(`split_strategy="auto"`, the default; `plan_strategy`), as the JAX trainer
picks it from its TPU constants, or is given; so does the legacy planner's
choice between the touched-row and the whole-table update
(`plan_table_update`). A user-chosen optimizer (`Trainer(optimizer=
make_optimizer(...))` or `make_partitioned_optimizer(...)`) takes no split
and no touched-row path, as in the JAX trainer: it updates every parameter,
the tables from their dense gradients. Metrics stay on the device; `fit`
reads them back once an epoch (and every `log_every` steps).

Dropout: each step draws from the device's generator reseeded with
`step_seed(state.seed, state.step)` at the top of the step, the counterpart
of the JAX trainer's `fold_in(state.rng, state.step)`: a run restored at
step s draws the masks of an uninterrupted run's step s. The seed travels in
the checkpoint with the step (train/checkpoint.py), and on a restore the
checkpoint's seed wins over the Trainer's `seed`, which only seeds a fresh
state. Reseeding sets the generator's seed and offset on the host; the card
is not waited for.

Dispatch (the JAX trainer's `train_steps` and `fit(scan_steps=)`):
`train_steps(state, batches)` runs len(batches) steps and returns their mean
metrics; `fit(scan_steps=K)` stacks K batches at a time in the prefetch
thread and runs each stack through `train_steps`, the tail of fewer than K
as single steps (`scan_steps=None`: 8 on a card, 1 on the CPU). On a card
each step of `train_steps` is a replay of a CUDA graph of the step's device
work (train/graphs.py: one graph per batch signature, captured at the
signature's second step, the first runs eagerly), after the host has
reseeded the generator and written the learning rate, so a replay computes
what the eager step computes, bit for bit; on the CPU the steps run eagerly.
`predict` and `evaluate` replay a graph of the eval forward on a card in the
same way. The dense Adam on a card is `capturable` with its learning rate in
a device tensor (`set_learning_rate` writes it; `current_learning_rate`
reads the host's copy); the CPU keeps the plain Adam with a float LR.
Preemption is checked before every step, inside a stack too.

Long runs: `fit(preempt_dir=)` with `install_preemption_handler` stops after
the step in flight on SIGTERM or SIGINT, skips validation and the epoch-end
callbacks and writes `<preempt_dir>/<step>.pt`, from which a later `fit`
resumes mid-epoch on a dataset with a length and `iter_from`;
`fit(profile_dir=, profile_steps=)` traces a window of epoch 0's steps with
torch.profiler (utils/profiling.py).

Data parallel (`Trainer(mesh=make_mesh())`, one process per device,
parallel/): each process passes its own batches, its rows of the global
batch (`parallel.mesh.shard_batch` cuts them from a global one), and the
step computes what the JAX trainer computes on the global batch under pjit:

  * each rank embeds its own rows and runs the towers; inside the step's
    `data_parallel` block BatchNorm takes its statistics over the global
    batch (all-reduced sums) and the model's loss sees the global batch
    (an in-batch loss through its `axis_name` path; any other on the
    all-gathered inputs: `losses.match.global_batch_loss`);
  * the dense gradients are averaged over the ranks by an all-reduce (each
    rank's backward gives world-size times its share of the global
    gradient: parallel/distributed.py);
  * replicated tables: every rank's (stored-row ids, row gradients) are
    all-gathered and every rank applies the same update of the global
    batch (the split strategies, or the legacy update from the averaged
    table gradient over the global batch's touched rows), under
    deterministic algorithms on a card with more than one rank, so that the
    replicas stay bitwise equal;
  * `shard_tables=True`: each table the rules shard
    (`parallel.mesh.table_sharding_rules`: >= 8192 stored rows that the
    axis divides) and its accumulator hold this rank's block of rows; the
    embed pass gathers through `parallel.sharded_embedding`, and the
    legacy planner's update runs on each block (the split planner is off
    under shard_tables, as in the JAX trainer);
  * the metrics are each rank's value averaged over the ranks: the global
    batch's loss;
  * `predict` and `evaluate` return the global outputs on every rank (one
    all-gather a batch: every rank must iterate the same number of
    batches).

On a card the mesh step is captured into CUDA graphs as the single-card
step is (train/graphs.py): its NCCL collectives capture, and a replay is
bitwise the eager step (measured in a world of one; a capture across
cards is not measured). In a multi-process fit the ranks agree on the
preemption stop step
(`_PreemptSync`, `preempt_window`) and on the cluster-min batches per epoch;
`scan_steps` then defaults to 1 and a stacked run drops its tails, as in
the JAX trainer.

Every host batch's sparse ids are checked against their tables on the host
(`data.schema.check_batch_ids`, IndexError), in the prefetch thread for
`fit`, `evaluate` and `predict`, before the batch is copied to the card; the
gathers on the card then launch without a host check, so the host never
waits for them (the kernel's device-side assert still stops an id outside
its stacked table, in a batch that was put on the card by the caller).
"""
from __future__ import annotations

import functools
import re
import signal
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Tuple, Union)

import numpy as np
import torch

from recommendflow_tpu_torch.data.pipeline import prefetch
from recommendflow_tpu_torch.data.schema import check_batch_ids
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.encoder.pretrained import apply_pretrained
from recommendflow_tpu_torch.ops.cuda.embedding_bag import gather_rows
from recommendflow_tpu_torch.ops.cuda.table_update import rowwise_adagrad_update
from recommendflow_tpu_torch.ops.embedding import (fused_group_ids,
                                                   physical_ids, rows_key,
                                                   touched_stored_rows)
from recommendflow_tpu_torch.parallel.distributed import (all_gather_nograd,
                                                          all_reduce_nograd,
                                                          num_hosts)
from recommendflow_tpu_torch.parallel.mesh import (Mesh, data_parallel,
                                                   expert_sharding_rules,
                                                   table_sharding_rules)
from recommendflow_tpu_torch.parallel.sharded_embedding import mark_row_shard
from recommendflow_tpu_torch.train.callbacks import Callback, History
from recommendflow_tpu_torch.train.checkpoint import (HOST_LR, load_state,
                                                      save_step)
from recommendflow_tpu_torch.train.graphs import StepGraph, as_tensor
from recommendflow_tpu_torch.train.optimizers import (
    STRATEGIES, OptaxOptimizer, OptimizerSpec, default_table_lr,
    init_accumulator, make_lr_schedule, sparse_rowwise_adagrad_update,
    split_tables_update)
# make_optimizer lives in the JAX package's trainer module: importable here
from recommendflow_tpu_torch.train.optimizers import (  # noqa: F401
    make_optimizer, make_partitioned_optimizer)
from recommendflow_tpu_torch.utils.logger import get_logger
from recommendflow_tpu_torch.utils.profiling import (mark_phase, span,
                                                     spanned, start_trace,
                                                     stop_trace)
from recommendflow_tpu_torch.utils.tables import print_table

log = get_logger("recflow.trainer")

_TABLE = re.compile(r"table_dim(\d+)$")

# The split planner's cost model: one table update by split_table_update,
# the sort and duplicate sum included. "dense" takes DENSE_S_PER_BYTE per
# byte of the table (a zero-filled gradient written, then swept beside the
# accumulator); "sparse_set" takes SPARSE_S_PER_ID per id of the batch
# (duplicates counted) plus SPARSE_FIXED_S. Fitted on an NVIDIA H100 80GB
# HBM3 at 700.00 W to CUDA-event times of both strategies (chip_smoke.py's
# ranking phase; PERF.md §6): "dense" 1.042 ms over the 770 MB bench_recall
# table and 2.303 ms over the 2.5 GB bench_ranking table; "sparse_set"
# 0.503, 0.610 and 0.372 ms at 87,040, 106,496 and 53,248 ids.
DENSE_S_PER_BYTE = 9.6e-13
SPARSE_S_PER_ID = 4.4e-9
SPARSE_FIXED_S = 1.3e-4
# The legacy planner's cost model (table_update "sparse", or "auto" on a
# model without row_injection): one table's update from its dense gradient.
# "dense" (rowwise_adagrad_update over the table) takes
# LEGACY_DENSE_S_PER_BYTE per byte of the table; "sparse" (the batch's
# touched rows sorted by touched_stored_rows, then
# sparse_rowwise_adagrad_update) takes LEGACY_SPARSE_S_PER_ID per id of the
# batch (duplicates counted) plus LEGACY_SPARSE_FIXED_S. Fitted on an NVIDIA
# H100 80GB HBM3 at 700.00 W to CUDA-event times of both updates from a
# batch's dense gradient (chip_smoke.py's train_options phase; PERF.md §6):
# "dense" 0.301 ms over the 770 MB bench_recall table and 0.941 ms over the
# 2.5 GB bench_ranking table; "sparse" 0.293, 0.414 and 0.308 ms at 87,040,
# 106,496 and 53,248 ids. At bench_recall the two are 3% apart and the
# model takes "dense"; at bench_ranking "sparse".
LEGACY_DENSE_S_PER_BYTE = 3.8e-13
LEGACY_SPARSE_S_PER_ID = 1.7e-9
LEGACY_SPARSE_FIXED_S = 2.0e-4


def to_device(batch: Mapping[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors -> tensors on `device` (a host
    array copied asynchronously from pinned memory when the device is a
    card)."""
    out = {}
    for k, v in batch.items():
        t = as_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def check_host_batch(schema, batch: Mapping[str, Any]) -> Mapping[str, Any]:
    """`check_batch_ids` on a host batch (numpy arrays or CPU tensors); a
    batch with tensors on a card is not read back (that would make the host
    wait): there only gather_rows' device-side assert stops an id outside
    its stacked table, and an id past its own table but inside the stacked
    one reads the next table's row, as in the JAX package."""
    if not any(isinstance(v, torch.Tensor) and v.device.type != "cpu"
               for v in batch.values()):
        check_batch_ids(schema, batch)
    return batch


def checked_batches(model: torch.nn.Module,
                    batches: Iterable[Mapping[str, Any]]
                    ) -> Iterator[Mapping[str, Any]]:
    """`batches`, each checked by `check_host_batch` against the model's
    tables as it is drawn: inside prefetch's worker thread when prefetch
    draws them."""
    return map(functools.partial(check_host_batch, model.schema), batches)


def eval_outputs(model: torch.nn.Module, batch: Mapping[str, Any],
                 device: torch.device, graph: Optional[StepGraph] = None
                 ) -> Dict[str, torch.Tensor]:
    """The model's eval outputs on one host batch (no_grad and eval mode are
    the caller's): through `graph` (a replay, its outputs cloned) on a card,
    eagerly on the CPU."""
    if graph is None:
        return model(to_device(batch, device))
    return {k: v.clone() for k, v in graph(model, batch).items()}


def predict(model: torch.nn.Module, dataset: Iterable[Mapping[str, np.ndarray]],
            device: Union[str, torch.device] = "cuda",
            graph: Optional[StepGraph] = None,
            mesh: Optional[Mesh] = None) -> Dict[str, np.ndarray]:
    """Stacked model outputs over a dataset of host batches, as numpy.

    The model runs in eval mode under no_grad on `device` (default "cuda";
    raises without a card unless "cpu" is asked for); on a card through a
    CUDA graph of its forward per batch shape (`graph`, or one for this
    call, whose capture at the second batch pays off only over a dataset
    of more than a few batches: PERF.md §6). Host batches are prepared and
    their ids checked (IndexError) in a background thread
    (data.pipeline.prefetch) while the card runs; outputs stay on the
    device until the end, so the host does not wait on the card batch by
    batch. With a `mesh` each rank passes its own batches and every rank
    returns the global outputs (`gather_outputs`). Spans: `predict`,
    `predict.prefetch` (each wait on the thread, its start in the first),
    `predict.fetch` (the outputs to the host)."""
    dev = resolve_device(device)
    if graph is None and dev.type == "cuda":
        graph = StepGraph(dev, "predict")
    model.eval()
    chunks: Dict[str, List[torch.Tensor]] = {}
    with torch.no_grad(), span("predict"):
        for batch in spanned(prefetch(checked_batches(model, dataset)),
                             "predict.prefetch"):
            out = gather_outputs(eval_outputs(model, batch, dev, graph), mesh)
            for k, v in out.items():
                chunks.setdefault(k, []).append(v)
        with span("predict.fetch"):
            return {k: torch.cat(v).cpu().numpy() for k, v in chunks.items()}


def gather_outputs(out: Dict[str, torch.Tensor], mesh: Optional[Mesh],
                   axis: str = "dp") -> Dict[str, torch.Tensor]:
    """Each rank's outputs of its rows -> the global batch's outputs, in
    rank order (the JAX trainer's `_fetch`), or `out` without a mesh."""
    if mesh is None:
        return out
    return {k: all_gather_nograd(v, mesh.group(axis)) for k, v in out.items()}


def resolve_scan_steps(scan_steps: Optional[int],
                       device: Union[str, torch.device],
                       multiprocess: bool = False) -> int:
    """fit's steps per stack: `scan_steps`, or with None 8 on a card and 1
    on the CPU or in a multi-process run (the JAX trainer's rule)."""
    if scan_steps is not None:
        return max(int(scan_steps), 1)
    return 8 if torch.device(device).type == "cuda" and not multiprocess \
        else 1


class _PreemptSync:
    """Cross-process agreement on the preemption stop step (the JAX
    trainer's `_PreemptSync`).

    A SIGTERM lands on each rank at a slightly different time; a rank that
    stopped dispatching steps while another dispatched one more would leave
    the straggler blocked in that step's collectives. Every step each rank
    contributes its local flag to a one-element all-reduce MAX, dispatched
    without waiting (`async_op`), and reads the agreement of `window` steps
    ago, which has long since completed: on a card its value is copied to
    pinned host memory behind an event, so the read waits for that
    all-reduce only, not for the steps queued since. Agreements are
    consumed deterministically, each exactly `window` pushes after its
    dispatch, so every rank stops after the SAME number of steps."""

    def __init__(self, group, device: torch.device, window: int = 16):
        from collections import deque
        self.group, self.device = group, device
        self.window = max(int(window), 0)
        self.pending: "deque" = deque()

    def _agree(self, flag: bool):
        t = torch.full((1,), 1 if flag else 0, dtype=torch.int32,
                       device=self.device)
        work = torch.distributed.all_reduce(
            t, op=torch.distributed.ReduceOp.MAX, group=self.group,
            async_op=True)
        if self.device.type != "cuda":
            return t, work, None
        work.wait()              # the current stream waits; the host does not
        host = torch.empty((1,), dtype=torch.int32, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, None, event

    @staticmethod
    def _read(item) -> bool:
        value, work, event = item
        if work is not None:
            work.wait()
        if event is not None:
            event.synchronize()
        return int(value[0]) > 0

    def push(self, flag: bool) -> None:
        """This step's local flag (once per dispatched step on EVERY rank:
        the reduce is a collective)."""
        self.pending.append(self._agree(flag))

    def should_stop(self) -> bool:
        """The settled agreements older than `window` pushes (no
        collective)."""
        stop = False
        while len(self.pending) > self.window:
            stop |= self._read(self.pending.popleft())
        return stop

    def agree(self, flag: bool) -> bool:
        """One immediate agreement (a collective): True iff ANY rank raised
        `flag`."""
        return self._read(self._agree(flag))

    def drain(self, flag: bool) -> bool:
        """Epoch end: every pending agreement plus one fresh one (a
        collective, dispatched whatever this rank knows already)."""
        stop = any([self._read(x) for x in self.pending])
        self.pending.clear()
        return self.agree(flag) or stop


def split_costs(table_bytes: int, n_ids: int) -> Tuple[float, float]:
    """(dense, sparse_set) seconds of one update of a table of `table_bytes`
    that a batch touches at `n_ids` ids, by the cost model."""
    return (DENSE_S_PER_BYTE * table_bytes,
            SPARSE_S_PER_ID * n_ids + SPARSE_FIXED_S)


def plan_strategy(table_bytes: int, n_ids: int) -> str:
    """The split strategy that `split_costs` finds cheaper."""
    dense, sparse = split_costs(table_bytes, n_ids)
    return "sparse_set" if sparse < dense else "dense"


def table_update_costs(table_bytes: int, n_ids: int) -> Tuple[float, float]:
    """(dense, sparse) seconds of one update of a table of `table_bytes`
    from its dense gradient, with a batch of `n_ids` ids, by the legacy
    planner's cost model."""
    return (LEGACY_DENSE_S_PER_BYTE * table_bytes,
            LEGACY_SPARSE_S_PER_ID * n_ids + LEGACY_SPARSE_FIXED_S)


def plan_table_update(table_bytes: int, n_ids: int) -> str:
    """The update that `table_update_costs` finds cheaper ("sparse" where
    the whole-table pass costs more, as the JAX planner decides)."""
    dense, sparse = table_update_costs(table_bytes, n_ids)
    return "sparse" if dense > sparse else "dense"


_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of step `step` of a run seeded `seed`: splitmix64's
    finaliser (a bijection of 64-bit words) of seed and step packed into one
    word, so distinct (seed, step) pairs below 2^32 get distinct seeds."""
    z = ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def device_generator(device: torch.device) -> torch.Generator:
    """The default generator that dropout on `device` draws from."""
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.default_generators[index]
    return torch.default_generator


def set_learning_rate(state: "TrainState", lr: float) -> None:
    """Rewrite the dense optimizer's injected LR (no effect on the next
    update while a schedule is active: it re-derives the LR every step). An
    LR in a device tensor (the capturable Adam on a card) is written in
    place, where a captured step reads it, and its value kept on the host
    beside it (`HOST_LR`)."""
    for group in state.optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
            group[HOST_LR] = float(lr)
        else:
            group["lr"] = lr


def current_learning_rate(state: "TrainState") -> float:
    """The dense optimizer's injected LR: the last update's (the schedule's
    value at count 0 before any), as the host wrote it (no read from the
    card)."""
    group = state.optimizer.param_groups[0]
    return float(group.get(HOST_LR, group["lr"]))


@dataclass
class TrainState:
    """What a step reads and updates: the model (weights, BatchNorm
    statistics, logQ frequency buffers), the optimizer (Adam over the dense
    parameters, or a user-chosen `OptaxOptimizer`), one [R, 1] f32 row-wise
    Adagrad accumulator per table the trainer updates itself ('dim{d}': the
    split, touched-row and whole-table paths; none under a user-chosen
    optimizer), the step count and the run's seed (each step's dropout
    draws from `step_seed(seed, step)`)."""
    model: torch.nn.Module
    optimizer: Any
    table_acc: Dict[str, torch.Tensor]
    step: int = 0
    seed: int = 0


def table_params(model: torch.nn.Module) -> Dict[int, torch.nn.Parameter]:
    """dim -> the stacked table parameter 'table_dim{d}'."""
    return {int(m.group(1)): p for name, p in model.named_parameters()
            if (m := _TABLE.search(name))}


def _row_grad(rows: torch.Tensor) -> torch.Tensor:
    """The gradient of a split gather's rows: zeros where the loss did not
    reach them (a model whose fields leave a table's slots out, as Cold's
    field stack leaves out every slot of another width), as JAX's
    cotangent of an unused input is."""
    return rows.grad if rows.grad is not None else torch.zeros_like(rows)


class Trainer:
    """Trainer of one model on one device.

    optimizer: None (Adam on the dense parameters, row-wise Adagrad on the
    tables by the paths below) or an `OptimizerSpec` from `make_optimizer` /
    `make_partitioned_optimizer`, which then updates every parameter (no
    split, no touched-row path; `lr_schedule` is ignored: give the spec a
    schedule as its learning rate). lr_schedule: None, a dict of
    `make_lr_schedule`'s arguments ({"type": "cosine", "warmup_steps": ...,
    "decay_steps": ..., "min_ratio": ...}, peak learning_rate) or a
    function of the update count; while one is active, set_learning_rate
    and ReduceLROnPlateau's lr_scale have no effect, and the tables keep
    default_table_lr(learning_rate).
    table_update: "auto" (split when the model has row_injection, else the
    legacy planner), "split", "sparse" (the touched rows of the dense table
    gradient, every table) or "dense" (whole-table updates). split_strategy:
    "auto" (each split table's by `plan_strategy`, from the sample batch's
    ids) or one of "dense", "sparse_set", "sparse" for every split table.
    device defaults to "cuda" and raises without a card unless "cpu" is
    asked for; the model must live there.

    mesh: a `parallel.mesh.Mesh` with a 'dp' axis (the module docstring's
    data parallelism; the device is then the mesh's); shard_tables
    row-shards the large tables over 'dp'; shard_experts splits Mmoe's
    experts over an 'ep' axis (`parallel.mesh.expert_sharding_rules`: the
    mesh must have one), each rank running its block of experts."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: Optional[OptimizerSpec] = None,
                 learning_rate: float = 1e-3,
                 lr_schedule: Union[None, Dict[str, Any],
                                    Callable[[int], float]] = None,
                 table_learning_rate: Optional[float] = None,
                 table_update: str = "auto",
                 split_strategy: str = "auto",
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 mesh: Optional[Mesh] = None, shard_tables: bool = False,
                 shard_experts: bool = False):
        if table_update not in ("auto", "split", "sparse", "dense"):
            raise ValueError(f"table_update must be auto|split|sparse|dense, "
                             f"got '{table_update}'")
        if optimizer is not None and not isinstance(optimizer, OptimizerSpec):
            raise TypeError(f"optimizer must come from make_optimizer or "
                            f"make_partitioned_optimizer, got "
                            f"{type(optimizer).__name__}")
        if split_strategy != "auto" and split_strategy not in STRATEGIES:
            raise ValueError(f"split_strategy {split_strategy!r}: auto or one "
                             f"of {STRATEGIES}")
        if (shard_tables or shard_experts) and mesh is None:
            raise ValueError("shard_tables / shard_experts need a mesh "
                             "(parallel.make_mesh)")
        if shard_experts and "ep" not in mesh.shape:
            expert_sharding_rules({}, mesh)          # its ValueError
        self.mesh = mesh
        self.shard_tables = shard_tables
        self.shard_experts = shard_experts
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        if any(p.device.type != self.device.type for p in model.parameters()):
            raise ValueError(f"the model's parameters are not on {self.device}")
        self.model = model
        self.optimizer = optimizer
        if optimizer is not None and lr_schedule is not None:
            log.warning("lr_schedule is ignored beside a given optimizer "
                        "(as in the JAX trainer): give the optimizer a "
                        "schedule as its learning rate")
            lr_schedule = None
        self.lr_schedule = (make_lr_schedule(learning_rate, **lr_schedule)
                            if isinstance(lr_schedule, dict) else lr_schedule)
        self.base_lr = learning_rate
        self.table_lr = (default_table_lr(learning_rate)
                         if table_learning_rate is None else table_learning_rate)
        # the split planner is off under shard_tables, as in the JAX trainer
        self.split = optimizer is None and table_update in ("auto", "split") \
            and getattr(model, "row_injection", False) and not shard_tables
        if table_update == "split" and not self.split:
            log.warning("table_update='split' needs model.row_injection, "
                        "the default optimizer and unsharded tables; the "
                        "legacy planner decides")
        self.split_strategy = split_strategy
        self.table_update = table_update
        self._split_dims: Dict[int, str] = {}
        self._sparse_dims: List[int] = []
        self._planned = False
        self.seed = seed
        self.control: Dict[str, Any] = {"stop": False, "lr_scale": 1.0}
        # CUDA graphs of the train step and of the eval forward (a card only)
        self._graphs: Dict[str, StepGraph] = {}

    def graph(self, kind: str) -> StepGraph:
        """The trainer's StepGraph of `kind` ("train" or "eval") on its
        card."""
        if kind not in self._graphs:
            self._graphs[kind] = StepGraph(self.device, f"{kind} step of "
                                           f"{type(self.model).__name__}")
        return self._graphs[kind]

    def graph_stats(self) -> Dict[str, List[Dict[str, Any]]]:
        """Per StepGraph: each captured signature's capture seconds, pool
        MB, replays and launches a replay (graphs.StepGraph.stats)."""
        return {kind: g.stats() for kind, g in self._graphs.items()}

    # ------------------------------------------------------------- state
    def _put(self, batch: Mapping[str, Any], check: bool = True
             ) -> Dict[str, torch.Tensor]:
        """The batch on the trainer's device, its ids checked first by
        `check_host_batch` unless `check` is off (prefetch checked them)."""
        if check:
            check_host_batch(self.model.schema, batch)
        return to_device(batch, self.device)

    def plan(self, sample_batch: Mapping[str, Any]) -> List[int]:
        """Decide which tables take the split path (and with which strategy)
        or the touched-row path, from the sparse slots a sample batch
        carries. Returns the dims that need an accumulator (none under a
        user-chosen optimizer)."""
        schema = self.model.schema
        tables = table_params(self.model)
        # the planners cost the global batch (each rank holds its rows)
        ranks = self.mesh.size("dp") if self.mesh is not None else 1
        n_ids: Dict[int, int] = {}
        for name in schema.order:
            slot = schema.slots[name]
            if slot.kind == "sparse" and name in sample_batch:
                n_ids[slot.dim] = n_ids.get(slot.dim, 0) + \
                    int(np.prod(sample_batch[name].shape)) * ranks
        self._planned = True
        self._split_dims = {}
        self._sparse_dims = []
        if "train" in self._graphs:      # the step the graphs hold changes
            self._graphs["train"].reset()
        if self.optimizer is not None:
            return []
        if not self.split:
            if self.table_update != "dense":
                self._plan_sparse(tables, n_ids)
            return sorted(tables)
        for d in sorted(tables):
            if d not in n_ids:
                continue
            strategy = self.split_strategy
            if strategy == "auto":
                nbytes = tables[d].numel() * tables[d].element_size()
                strategy = plan_strategy(nbytes, n_ids[d])
                dense, sparse = split_costs(nbytes, n_ids[d])
                log.info("split planner: dim%d (%.1f MB, %d ids) -> %s "
                         "(cost model: dense %.3f ms, sparse_set %.3f ms)", d,
                         nbytes / 1e6, n_ids[d], strategy, dense * 1e3,
                         sparse * 1e3)
            self._split_dims[d] = strategy
        return list(self._split_dims)

    def _plan_sparse(self, tables: Dict[int, torch.nn.Parameter],
                     n_ids: Dict[int, int]) -> None:
        """The legacy planner (JAX `_plan_table_updates`): each table the
        batch touches takes the touched-row update where table_update is
        "sparse", or where `plan_table_update` finds it cheaper."""
        for d in sorted(tables):
            if d not in n_ids:
                continue
            nbytes = tables[d].numel() * tables[d].element_size()
            choice = plan_table_update(nbytes, n_ids[d])
            dense, sparse = table_update_costs(nbytes, n_ids[d])
            log.info("legacy planner: dim%d (%.1f MB, %d ids) -> %s (cost "
                     "model: dense %.3f ms, sparse %.3f ms)%s", d,
                     nbytes / 1e6, n_ids[d], choice, dense * 1e3, sparse * 1e3,
                     "; table_update='sparse' takes sparse"
                     if self.table_update == "sparse" else "")
            if self.table_update == "sparse" or choice == "sparse":
                self._sparse_dims.append(d)

    def init_state(self, sample_batch: Mapping[str, Any]) -> TrainState:
        """Graft the pretrained encoders that `Networks.pretrained` names
        (encoder/pretrained.py:apply_pretrained), plan the table updates from
        a sample batch and build the state, whose dropout seed is the
        Trainer's `seed`.

        The graft belongs to the weights' initialisation, which the port
        does once, when the model is built: a model already grafted (by
        another trainer, or by this one in an earlier call) keeps the
        weights it holds, trained or not."""
        if not getattr(self.model, "pretrained_grafted", False):
            apply_pretrained(self.model)
            self.model.pretrained_grafted = True
        dims = self.plan(sample_batch)
        if self.mesh is not None:
            self._place_on_mesh()
        tables = table_params(self.model)
        # an accumulator follows its table's placement (a row block)
        table_acc = {f"dim{d}": init_accumulator(tables[d]) for d in dims}
        if self.optimizer is not None:
            optimizer = self.optimizer.build(list(
                self.model.named_parameters()))
        else:
            dense = [p for name, p in self.model.named_parameters()
                     if not _TABLE.search(name)]
            lr = float(self.lr_schedule(0)) if self.lr_schedule is not None \
                else self.base_lr
            if self.device.type == "cuda":
                # a captured step reads the LR and the step count from the
                # card; the eager steps run the same Adam
                optimizer = torch.optim.Adam(
                    dense, lr=torch.tensor(lr, dtype=torch.float32,
                                           device=self.device),
                    capturable=True)
                optimizer.param_groups[0][HOST_LR] = lr
            else:
                optimizer = torch.optim.Adam(dense, lr=lr)
        if self._sparse_dims:
            log.info("touched-row table updates for %s (from the dense table "
                     "gradient)", [f"dim{d}" for d in self._sparse_dims])
        if self._split_dims:
            self._validate_row_injection(self._put(sample_batch))
            log.info("split table updates: %s (rows gathered outside "
                     "autograd; no table gradient)",
                     {f"dim{d}": s for d, s in self._split_dims.items()})
        n = sum(p.numel() for p in self.model.parameters())
        log.info("initialized %s: %.3fM params on %s%s",
                 type(self.model).__name__, n / 1e6, self.device,
                 f" (mesh {self.mesh.shape})" if self.mesh is not None else "")
        return TrainState(self.model, optimizer, table_acc, 0, self.seed)

    def _place_on_mesh(self) -> None:
        """Every rank starts from rank 0's weights and buffers (broadcast);
        under shard_tables each table the rules shard keeps this rank's
        block of rows, under shard_experts each expert leaf this rank's
        block of experts (`mark_row_shard`). Idempotent."""
        with torch.no_grad():
            for t in list(self.model.parameters()) + list(self.model.buffers()):
                if getattr(t, "row_shard", None) is None:
                    torch.distributed.broadcast(t.data, src=0)
        named = {name: p for name, p in self.model.named_parameters()
                 if getattr(p, "row_shard", None) is None}
        for on, axis, rules in (
                (self.shard_tables, "dp", table_sharding_rules),
                (self.shard_experts, "ep", expert_sharding_rules)):
            if not on:
                continue
            leaves = {n: p for n, p in named.items()
                      if axis == "ep" or _TABLE.search(n)}
            specs = rules(leaves, self.mesh, axis)
            sharded = [n for n, spec in specs.items() if spec]
            for n in sharded:
                mark_row_shard(named[n], self.mesh, axis)
            log.info("sharded over %s=%d: %s", axis, self.mesh.size(axis),
                     sharded)

    def _validate_row_injection(self, batch: Dict[str, torch.Tensor]) -> None:
        """One tiny forward/backward with the rows injected: every split
        table's .grad must still be None. A model flagged row_injection that
        reads a table anywhere else would train with that read's gradient
        silently dropped (the split path never applies a table gradient)."""
        tiny = {k: v[:2] for k, v in batch.items()}
        tables = table_params(self.model)
        saved = {k: b.clone() for k, b in self.model.named_buffers()}
        try:
            self._forward_backward(tiny)
            offending = [d for d in self._split_dims
                         if tables[d].grad is not None]
        finally:
            with torch.no_grad():
                for k, b in self.model.named_buffers():
                    b.copy_(saved[k])
            self.model.zero_grad(set_to_none=True)
        if offending:
            raise ValueError(
                f"{type(self.model).__name__} sets row_injection=True but "
                f"its training forward still reads table(s) "
                f"{[f'dim{d}' for d in offending]} outside the injected "
                f"embed pass: under the split path those reads' gradients "
                f"would be silently dropped. Route every table read through "
                f"the one embed_batch pass, or set row_injection = False.")

    # -------------------------------------------------------------- steps
    def _forward_backward(self, batch: Dict[str, torch.Tensor]):
        """Training forward and backward. Returns (loss, aux, phys, rows):
        on the split path phys[d] are the stored-row ids and rows[d] the
        gathered rows of table d, whose .grad holds the row gradients."""
        model = self.model
        model.train()
        model.zero_grad(set_to_none=True)
        mark_phase(self.device, "gather")
        phys, rows = self.split_rows(batch)
        mark_phase(self.device, "forward")
        loss, aux = model({**batch,
                           **{rows_key(d): r for d, r in rows.items()}})
        mark_phase(self.device, "backward")
        loss.backward()
        return loss, aux, phys, rows

    def split_rows(self, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[int, torch.Tensor], Dict[int, torch.Tensor]]:
        """The split path's gather, outside autograd: per split table d, the
        stored-row ids of the batch's fused ids (phys[d], int32) and those
        rows (rows[d], requiring grad). The ids are in range by construction
        once the batch's ids were checked, so the gather launches without
        the host check and the host does not wait."""
        phys: Dict[int, torch.Tensor] = {}
        rows: Dict[int, torch.Tensor] = {}
        if not self._split_dims:
            return phys, rows
        gids = fused_group_ids(self.model.schema, batch)
        tables = table_params(self.model)
        for d in self._split_dims:
            if d in gids:
                t = tables[d].detach()
                pid = physical_ids(t, d, gids[d]).to(torch.int32).contiguous()
                phys[d] = pid
                rows[d] = gather_rows(t, pid, check_ids=False).requires_grad_()
        return phys, rows

    def _apply_table_updates(self, state: TrainState,
                             phys: Dict[int, torch.Tensor],
                             rows: Dict[int, torch.Tensor],
                             batch: Optional[Dict[str, torch.Tensor]] = None
                             ) -> None:
        """`_apply_row_grads` with the split path's gathered rows, whose
        .grad holds the row gradients (`_row_grad`)."""
        self._apply_row_grads(state, phys,
                              {d: _row_grad(r) for d, r in rows.items()},
                              batch)

    def _apply_row_grads(self, state: TrainState,
                         phys: Dict[int, torch.Tensor],
                         row_grads: Dict[int, torch.Tensor],
                         batch: Optional[Dict[str, torch.Tensor]] = None
                         ) -> None:
        """The tables' row-wise Adagrad, in place (a user-chosen optimizer
        has updated them already): the split path from the stored-row ids
        and row gradients, the touched-row path from the batch's ids (on a
        row block, the rows of the whole table that fall in it)."""
        if self.optimizer is not None:
            return
        tables = table_params(self.model)
        with torch.no_grad():
            if self._split_dims:
                split_tables_update(
                    [(tables[d].detach(), state.table_acc[f"dim{d}"], phys[d],
                      row_grads[d], strategy)
                     for d, strategy in self._split_dims.items() if d in phys],
                    lr=self.table_lr)
                return
            touched = touched_stored_rows(
                self.model.schema, {f"dim{d}": tables[d]
                                    for d in self._sparse_dims}, batch) \
                if self._sparse_dims else {}
            for d, t in tables.items():
                if t.grad is None:
                    continue
                acc = state.table_acc[f"dim{d}"]
                shard = getattr(t, "row_shard", None)
                if f"dim{d}" in touched:
                    sparse_rowwise_adagrad_update(
                        t.detach(), acc, t.grad, touched[f"dim{d}"],
                        lr=self.table_lr,
                        row_offset=None if shard is None else shard.start)
                else:
                    rowwise_adagrad_update(t.detach(), acc, t.grad,
                                           lr=self.table_lr)
                t.grad = None

    def train_step(self, state: TrainState, batch: Mapping[str, Any]):
        """One step, in place on `state`. Returns (state, metrics) with the
        metrics as device scalars. A host batch's ids are checked first."""
        return self._step(state, self._put(batch))

    def _step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """train_step on a batch that is on the device already."""
        self._host_step(state)
        metrics = self._device_step(state, batch)
        state.step += 1
        return state, metrics

    def _host_step(self, state: TrainState) -> None:
        """What the host decides for step `state.step`, before its device
        work: the dropout reseed, the schedule's LR and, for a chosen
        optimizer, its update count and LR (written to the card)."""
        with span("fit.host_step"):
            device_generator(self.device).manual_seed(
                step_seed(state.seed, state.step))
            if self.lr_schedule is not None:
                set_learning_rate(state, float(self.lr_schedule(state.step)))
            if isinstance(state.optimizer, OptaxOptimizer):
                state.optimizer.prepare()

    def _device_step(self, state: TrainState, batch: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The step's device work, which a CUDA graph captures: forward,
        backward, the dense update and the table updates, each phase
        started by its marker (`mark_phase`: gather, forward, backward,
        optimizer, table_update, then end). Returns the metrics as device
        scalars."""
        if self.mesh is not None:
            return self._mesh_device_step(state, batch)
        loss, aux, phys, rows = self._forward_backward(batch)
        mark_phase(self.device, "optimizer")
        if isinstance(state.optimizer, OptaxOptimizer):
            state.optimizer.apply()
        else:
            state.optimizer.step()
        mark_phase(self.device, "table_update")
        self._apply_table_updates(state, phys, rows, batch)
        mark_phase(self.device, "end")
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    def _mesh_device_step(self, state: TrainState,
                          batch: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
        """The data-parallel step on this rank's rows (module docstring),
        with `_device_step`'s phase markers: the gradients' all-reduce
        falls in the backward phase, the row gradients' all-gather in the
        table update's, the metrics' all-reduce after the end marker."""
        mesh = self.mesh
        group, n = mesh.group("dp"), mesh.size("dp")
        with data_parallel(mesh, "dp"):
            loss, aux, phys, rows = self._forward_backward(batch)
        self._average_gradients()
        mark_phase(self.device, "optimizer")
        if isinstance(state.optimizer, OptaxOptimizer):
            state.optimizer.apply()
        else:
            state.optimizer.step()
        mark_phase(self.device, "table_update")
        # the global batch's ids and row gradients, in rank order: the rows
        # of the global batch in order (first summed over the mesh's other
        # axes, whose ranks hold the same rows: each has part of the
        # gradient when the experts are split)
        others = mesh.group_of([a for a in mesh.axis_names if a != "dp"])
        world = mesh.world_size
        phys = {d: all_gather_nograd(v, group) for d, v in phys.items()}
        row_grads = {}
        for d, r in rows.items():
            g = _row_grad(r) if others == "none" else \
                all_reduce_nograd(_row_grad(r), others)
            row_grads[d] = all_gather_nograd(g, group) / world
        if self._sparse_dims:      # the touched rows of the global batch
            schema = self.model.schema
            batch = {k: all_gather_nograd(v, group) for k, v in batch.items()
                     if k in schema.slots and schema.slots[k].kind == "sparse"}
        with _deterministic(self.device.type == "cuda" and world > 1):
            self._apply_row_grads(state, phys, row_grads, batch)
        mark_phase(self.device, "end")
        metrics = {"loss": loss.detach(), **{k: v.detach()
                                             for k, v in aux.items()}}
        names = sorted(metrics)
        mean = all_reduce_nograd(torch.stack(
            [metrics[k].float().reshape(()) for k in names]), group) / n
        return dict(zip(names, mean.unbind(0)))

    def _average_gradients(self) -> None:
        """Each parameter's gradient -> its global-batch gradient: summed
        over the ranks that hold the same block (a replicated parameter:
        every rank; a row block: the ranks of the mesh's other axes; one
        all-reduce per group and dtype, over a flat buffer) and divided by
        the world size (every rank's loss is the global loss)."""
        from torch._utils import (_flatten_dense_tensors,
                                  _unflatten_dense_tensors)
        mesh = self.mesh
        buckets: Dict[Tuple[Tuple[str, ...], torch.dtype],
                      List[torch.Tensor]] = {}
        for p in self.model.parameters():
            if p.grad is None:
                continue
            shard = getattr(p, "row_shard", None)
            axes = tuple(a for a in mesh.axis_names
                         if shard is None or a != shard.axis)
            buckets.setdefault((axes, p.grad.dtype), []).append(p.grad)
        with torch.no_grad():
            for (axes, _), grads in buckets.items():
                group = mesh.group_of(axes)
                if group == "none":
                    for g in grads:
                        g.div_(mesh.world_size)
                    continue
                flat = _flatten_dense_tensors(grads)
                torch.distributed.all_reduce(flat, group=group)
                flat.div_(mesh.world_size)
                for g, v in zip(grads, _unflatten_dense_tensors(flat, grads)):
                    g.copy_(v)

    def train_steps(self, state: TrainState,
                    batches: List[Mapping[str, Any]]):
        """len(batches) steps, in place on `state` (the JAX trainer's
        `train_steps`). Returns (state, metrics): each metric's mean over the
        steps, as device scalars. Host batches' ids are checked first. On a
        card each step replays the step's CUDA graph (module docstring)."""
        for b in batches:
            check_host_batch(self.model.schema, b)
        state, metrics, _ = self._train_steps_stacked(
            state, _stack_batches(batches))
        return state, metrics

    def _train_steps_stacked(self, state: TrainState,
                             stacked: Mapping[str, Any],
                             stop: Optional[Callable[[], bool]] = None):
        """Steps over a stack of batches ([K, B, ...] per key; ids checked).
        `stop()` is asked before every step: true ends the stack early.
        Returns (state, mean metrics, steps run)."""
        k = len(next(iter(stacked.values())))
        graph = None
        with span("fit.pin"):
            stacked = {key: as_tensor(v) for key, v in stacked.items()}
            if self.device.type == "cuda":
                stacked = {key: v.pin_memory() if v.device.type == "cpu"
                           else v for key, v in stacked.items()}
        if self.device.type == "cuda":
            graph = self.graph("train")
            graph.bind(state.optimizer, *state.table_acc.values())
        ms: List[Dict[str, torch.Tensor]] = []
        for i in range(k):
            if stop is not None and stop():
                break
            batch = {key: v[i] for key, v in stacked.items()}
            with span("fit.step"):
                if graph is None:
                    state, m = self._step(state, self._put(batch, check=False))
                else:
                    self._host_step(state)
                    try:
                        out = graph(functools.partial(self._device_step,
                                                      state), batch)
                    except RuntimeError:
                        # a failed capture ran no step: take back the host
                        # part's update count (the reseed and LR are
                        # rewritten by the next step's host part)
                        if isinstance(state.optimizer, OptaxOptimizer):
                            state.optimizer.count -= 1
                        raise
                    with span("fit.metrics"):
                        m = {name: v.clone() for name, v in out.items()}
                    state.step += 1
            ms.append(m)
        if not ms:
            return state, {}, 0
        with span("fit.metrics"):
            return state, {name: torch.stack([m[name] for m in ms]).mean(0)
                           for name in ms[0]}, len(ms)

    def set_learning_rate(self, state: TrainState, lr: float) -> None:
        """The dense LR (the tables keep their fixed Adagrad LR); no effect
        while a schedule is active."""
        set_learning_rate(state, lr)

    def _epoch_cap(self, train_ds) -> Optional[int]:
        """The cluster-min batches per epoch, agreed once (a collective
        every rank reaches); None when a rank's dataset has no length."""
        try:
            local = len(train_ds)
        except TypeError:
            local = -1
        counts = [int(c) for c in all_gather_nograd(torch.tensor(
            [local], dtype=torch.int64, device=self.device), None).cpu()]
        if min(counts) < 0:
            return None
        if min(counts) != max(counts):
            log.warning("per-rank batch counts differ %s; capping each epoch "
                        "at the cluster min %d to keep the collectives in "
                        "step", counts, min(counts))
        return min(counts)

    # --------------------------------------------------------------- loops
    def _eval_graph(self, model: torch.nn.Module) -> Optional[StepGraph]:
        """The eval forward's StepGraph on a card (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        graph = self.graph("eval")
        graph.bind(model)
        return graph

    def predict(self, state: TrainState, dataset: Iterable) -> Dict[str, np.ndarray]:
        return predict(state.model, dataset, self.device,
                       self._eval_graph(state.model), self.mesh)

    def evaluate(self, state: TrainState, dataset: Iterable) -> Dict[str, float]:
        """val_loss (the model's loss on eval outputs) and val_auc (cosine
        similarity against the label); under a mesh over the global batches
        (every rank passes its rows and gets the same numbers)."""
        from recommendflow_tpu_torch.train.metrics import roc_auc
        model = state.model
        try:
            loss_fn = model.resolve_loss()
        except (AttributeError, ValueError):
            loss_fn = None
        losses, scores, labels = [], [], []
        graph = self._eval_graph(model)
        model.eval()
        with torch.no_grad():
            for batch in prefetch(checked_batches(model, dataset)):
                out = gather_outputs(
                    eval_outputs(model, batch, self.device, graph), self.mesh)
                if "user" in out and "ad" in out:
                    y, u, a = out["label"], out["user"], out["ad"]
                    if loss_fn is not None:
                        losses.append(loss_fn(y, u, a))
                    scores.append(torch.sum(u * a, dim=1))
                    labels.append(y)
                elif "score" in out:
                    scores.append(out["score"].reshape(-1))
                    labels.append(out["label"].reshape(-1))
        logs: Dict[str, float] = {}
        if losses:
            logs["val_loss"] = float(torch.stack(losses).mean())
        if scores:
            auc = roc_auc(torch.cat(labels).cpu().numpy(),
                          torch.cat(scores).cpu().numpy())
            if np.isfinite(auc):
                logs["val_auc"] = auc
        return logs

    def fit(self, train_ds: Iterable, epochs: int = 1,
            valid_ds: Optional[Iterable] = None,
            callbacks: Optional[List[Callback]] = None,
            log_every: int = 100, state: Optional[TrainState] = None,
            profile_dir: Optional[str] = None,
            profile_steps: Tuple[int, int] = (10, 15),
            resume_data: bool = True, preempt_dir: Optional[str] = None,
            scan_steps: Optional[int] = None, preempt_window: int = 16,
            verbose: bool = True) -> Dict[str, Any]:
        """Train `epochs` epochs; returns {'state', 'history', 'preempted'}
        ('preempted': the run ended on control["preempt"]). Each epoch's
        logs hold the mean step metrics, examples_per_sec (the host clock
        around the epoch, read after the card finished it), the validation
        metrics and what the callbacks add. A given `state` with steps done
        resumes mid-stream when train_ds has a length (resume_data).

        scan_steps: steps per stack (`resolve_scan_steps`: None is 8 on a
        card, 1 on the CPU). The prefetch thread stacks that many batches of
        one shape, which `_train_steps_stacked` runs (on a card as replays of
        the step's CUDA graph); the rest of an epoch runs as single steps.
        The same steps in the same order as scan_steps=1: a stack's metrics
        are its mean, weighted by its steps in the epoch's.

        control["preempt"] (install_preemption_handler sets it) ends the
        epoch after the step in flight (checked before every step, inside a
        stack too); fit then skips validation and the epoch-end callbacks
        and, with a `preempt_dir`, writes `<preempt_dir>/<step>.pt` before
        the train-end callbacks. With a `profile_dir`, epoch 0's steps from
        profile_steps[0] up to profile_steps[1] are traced (torch.profiler,
        a Chrome trace under profile_dir; closed at the epoch's end if the
        epoch is shorter; a stack that crosses a bound moves it to the
        stack's end, as in the JAX trainer).

        Multi-process (a mesh over several processes): the ranks agree on
        the stop step through `_PreemptSync` (the agreed stop lands
        `preempt_window` steps after the signal; stacks are not cut), every
        epoch is capped at the cluster-min batch count when train_ds has a
        length, and scan_steps defaults to 1; an explicit scan_steps > 1
        drops each epoch's tail and rounds the cap down to whole stacks, so
        every rank runs the same items."""
        callbacks = list(callbacks or [])
        history = History()
        callbacks.append(history)
        start_epoch, skip = 0, 0
        first, it = None, None
        if state is None:
            it = iter(train_ds)
            first = next(it)
            state = self.init_state(first)
        elif not self._planned:
            # a state from another trainer (or a checkpoint): plan this one
            self.plan(next(iter(train_ds)))
        if state.step and resume_data and hasattr(train_ds, "__len__"):
            per_epoch = len(train_ds)
            if per_epoch:
                start_epoch = min(state.step // per_epoch, epochs)
                skip = state.step % per_epoch
                log.info("resuming at epoch %d, batch %d (step %d)",
                         start_epoch, skip, state.step)
        multiproc = self.mesh is not None and num_hosts() > 1
        k_scan = resolve_scan_steps(scan_steps, self.device, multiproc)
        psync = _PreemptSync(None, self.device, preempt_window) \
            if multiproc else None
        cap = self._epoch_cap(train_ds) if multiproc else None
        drop_tail = multiproc and k_scan > 1
        if drop_tail and cap is not None:
            rounded = cap // k_scan * k_scan
            if rounded == 0:
                k_scan, drop_tail = 1, False     # fewer batches than a stack
            elif rounded != cap:
                log.info("scan_steps=%d: epoch cap %d -> %d (whole stacks)",
                         k_scan, cap, rounded)
                cap = rounded
        # a previous fit's early stop or handled preemption must not make
        # this run train zero steps (the LR scale carries over on purpose)
        self.control["stop"] = False
        self.control.pop("preempt", None)
        for cb in callbacks:
            cb.on_train_begin(self)
        lr_scale = 1.0
        logs: Dict[str, float] = {}
        trace, traced = None, False
        for epoch in range(start_epoch, epochs):
            if psync is not None:
                # a signal or an early stop that reached one rank between
                # epochs: every rank agrees before the next epoch's steps
                if psync.agree(bool(self.control["stop"])):
                    self.control["stop"] = True
                if psync.agree(bool(self.control.get("preempt"))):
                    self.control["preempt"] = True
            if self.control["stop"] or self.control.get("preempt"):
                break
            if self.control["lr_scale"] != lr_scale:
                lr_scale = self.control["lr_scale"]
                self.set_learning_rate(state, self.base_lr * lr_scale)
                log.info("epoch %d: lr set to %.6g", epoch, self.base_lr * lr_scale)
            if first is not None:
                raw = _chain_first(first, it)
                first = None
            elif hasattr(train_ds, "iter_from"):
                raw = train_ds.iter_from(skip if epoch == start_epoch else 0,
                                         epoch=epoch)
            else:
                raw = iter(train_ds)
            t0 = time.perf_counter()
            n_steps, n_examples = 0, 0
            running: Dict[str, torch.Tensor] = {}
            items = checked_batches(self.model, raw)
            if k_scan > 1:
                items = _chunk_stack(items, k_scan, drop_tail)
            done = skip if epoch == start_epoch else 0
            for item in spanned(prefetch(items), "fit.next"):
                if profile_dir is not None and epoch == 0:
                    if not traced and n_steps >= profile_steps[0]:
                        trace, traced = start_trace(profile_dir), True
                    elif trace is not None and n_steps >= profile_steps[1]:
                        stop_trace(trace)
                        trace = None
                size = len(next(iter(item.stacked.values()))) \
                    if isinstance(item, _Stack) else 1
                if cap is not None and done + n_steps + size > cap:
                    break              # the cluster-min: collectives in step
                if psync is not None:
                    if psync.should_stop():
                        self.control["preempt"] = True
                        break
                elif self.control.get("preempt"):
                    break
                if isinstance(item, _Stack):
                    with span("fit.stack") as stack_span:
                        state, metrics, inc = self._train_steps_stacked(
                            state, item.stacked,
                            stop=None if psync is not None else
                            lambda: bool(self.control.get("preempt")))
                        stack_span.add(steps=inc)
                    n_ex = item.rows * inc
                else:
                    with span("fit.step"):
                        state, metrics = self._step(
                            state, self._put(item, check=False))
                    inc, n_ex = 1, _num_examples(item)
                if psync is not None:
                    psync.push(bool(self.control.get("preempt")))
                n_steps += inc
                n_examples += n_ex
                with span("fit.metrics"):
                    for k, v in metrics.items():
                        # a stack's metrics are its mean: weighted by its
                        # steps; the first value is copied, never kept (a
                        # replay's outputs are overwritten by the next)
                        v = v * inc if inc > 1 else v
                        running[k] = running[k] + v if k in running \
                            else v.clone()
                if inc and n_steps % log_every < inc:
                    log.info("epoch %d step %d: %s", epoch, n_steps, " ".join(
                        f"{k}={float(v):.5f}" for k, v in metrics.items()))
            if trace is not None:
                # the epoch ended before the window closed: an open trace
                # would be lost
                stop_trace(trace)
                trace = None
            # the read-back waits for the card, so dt covers the epoch's work
            logs = {k: float(v) / max(n_steps, 1) for k, v in running.items()}
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            logs["examples_per_sec"] = n_examples / max(dt, 1e-9)
            if psync is not None and psync.drain(
                    bool(self.control.get("preempt"))):
                # a flag raised inside the window or in the epoch's tail:
                # every rank agrees here, so all of them save below
                self.control["preempt"] = True
            if self.control.get("preempt"):
                # a spot VM's grace window is seconds: checkpoint first, no
                # validation pass and no epoch-end callbacks
                break
            if valid_ds is not None:
                logs.update(self.evaluate(state, valid_ds))
            for cb in callbacks:
                cb.on_epoch_end(self, state, epoch, logs)
            if "restore_state" in self.control:
                load_state(state, self.control.pop("restore_state"))
            if verbose:
                print_table([[k, f"{v:.6g}"] for k, v in sorted(logs.items())],
                            headers=["metric", "value"],
                            title=f"Epoch {epoch} ({dt:.1f}s, {n_steps} steps)")
        preempted = bool(self.control.pop("preempt", False))
        if preempted and preempt_dir:
            path = save_step(preempt_dir, state, state.step)
            log.warning("preempted: checkpoint of step %d written to %s",
                        state.step, path)
        for cb in callbacks:
            cb.on_train_end(self, state, logs)
        return {"state": state, "history": history.epochs,
                "preempted": preempted}


@contextmanager
def _deterministic(on: bool):
    """torch.use_deterministic_algorithms for the block when `on` (the
    replicated tables' update on a card: the duplicate-row sums' float
    atomics would otherwise let the replicas drift apart bit by bit)."""
    if not on or torch.are_deterministic_algorithms_enabled():
        yield
        return
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def install_preemption_handler(trainer: Trainer, signals=None
                               ) -> Dict[int, Any]:
    """SIGTERM and SIGINT (or `signals`) set trainer.control["stop"] and
    ["preempt"]: `fit` finishes the step in flight, writes its preempt_dir
    checkpoint and returns. Returns {signal: the handler it replaced}, so a
    caller can put them back (`signal.signal(s, h)` for each); the JAX
    function returns nothing. Call from the main thread."""
    sigs = signals if signals is not None else (signal.SIGTERM, signal.SIGINT)

    def handler(signum, frame):
        log.warning("signal %s: finishing the current step, then a "
                    "checkpoint and a clean exit", signum)
        trainer.control["stop"] = True
        trainer.control["preempt"] = True

    return {s: signal.signal(s, handler) for s in sigs}


def _chain_first(first, rest):
    yield first
    yield from rest


def _num_examples(batch: Mapping[str, Any]) -> int:
    return len(next(iter(batch.values())))


def _stack_batches(batches: List[Mapping[str, Any]]) -> Dict[str, np.ndarray]:
    """Batches of one shape -> {key: [K, B, ...]} (numpy, on the host)."""
    return {key: np.stack([np.asarray(b[key]) for b in batches])
            for key in batches[0]}


@dataclass
class _Stack:
    """K host batches of one shape stacked (fit's unit of `scan_steps`)."""
    stacked: Dict[str, np.ndarray]
    rows: int          # examples in each batch


def _shape(batch: Mapping[str, Any]):
    return sorted((k, np.shape(v), str(np.asarray(v).dtype))
                  for k, v in batch.items())


def _chunk_stack(batches: Iterable[Mapping[str, Any]], k: int,
                 drop_tail: bool = False):
    """Consecutive batches stacked k at a time (`_Stack`), in the thread
    that draws them (prefetch's), as the JAX trainer's `_chunk_stack`; a
    batch that does not share the stack's shape, and the tail of fewer than
    k, pass as single batches (dropped with `drop_tail`: a multi-process
    run's ranks must run the same items)."""
    buf: List[Mapping[str, Any]] = []
    for b in batches:
        if buf and _shape(b) != _shape(buf[0]):
            yield from buf
            buf = []
        buf.append(b)
        if len(buf) == k:
            yield _Stack(_stack_batches(buf), _num_examples(buf[0]))
            buf = []
    if not drop_tail:
        yield from buf
