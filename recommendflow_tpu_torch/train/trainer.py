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
  3. Adam on the dense parameters (the tables are in no Adam group);
  4. the tables' row-wise Adagrad, in place under no_grad: per table
     `split_table_update` with its strategy ("dense": scatter_add_rows +
     rowwise_adagrad_update; "sparse_set": sparse_adagrad_apply; "sparse":
     plain torch), or on the dense path (table_update "dense")
     rowwise_adagrad_update on the table gradient that take_rows' backward
     built with scatter_add_rows.

Each split table's strategy comes from this card's cost model
(`split_strategy="auto"`, the default; `plan_strategy`), as the JAX trainer
picks it from its TPU constants, or is given. Metrics stay on the device;
`fit` reads them back once an epoch (and every `log_every` steps).

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
import time
from dataclasses import dataclass
from typing import (Any, Dict, Iterable, Iterator, List, Mapping, Optional,
                    Tuple, Union)

import numpy as np
import torch

from recommendflow_tpu_torch.data.pipeline import prefetch
from recommendflow_tpu_torch.data.schema import check_batch_ids
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.ops.cuda.embedding_bag import gather_rows
from recommendflow_tpu_torch.ops.cuda.table_update import rowwise_adagrad_update
from recommendflow_tpu_torch.ops.embedding import (fused_group_ids,
                                                   physical_ids, rows_key)
from recommendflow_tpu_torch.train.callbacks import Callback, History
from recommendflow_tpu_torch.train.checkpoint import load_state
from recommendflow_tpu_torch.train.optimizers import (STRATEGIES,
                                                      default_table_lr,
                                                      init_accumulator,
                                                      split_table_update)
from recommendflow_tpu_torch.utils.logger import get_logger
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


def to_device(batch: Mapping[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A host numpy batch -> tensors on `device` (copied asynchronously from
    pinned memory when the device is a card)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
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


def predict(model: torch.nn.Module, dataset: Iterable[Mapping[str, np.ndarray]],
            device: Union[str, torch.device] = "cuda") -> Dict[str, np.ndarray]:
    """Stacked model outputs over a dataset of host batches, as numpy.

    The model runs in eval mode under no_grad on `device` (default "cuda";
    raises without a card unless "cpu" is asked for). Host batches are
    prepared and their ids checked (IndexError) in a background thread
    (data.pipeline.prefetch) while the card runs; outputs stay on the device
    until the end, so the host does not wait on the card batch by batch."""
    dev = resolve_device(device)
    model.eval()
    chunks: Dict[str, List[torch.Tensor]] = {}
    with torch.no_grad():
        for batch in prefetch(checked_batches(model, dataset)):
            out = model(to_device(batch, dev))
            for k, v in out.items():
                chunks.setdefault(k, []).append(v)
    return {k: torch.cat(v).cpu().numpy() for k, v in chunks.items()}


def split_costs(table_bytes: int, n_ids: int) -> Tuple[float, float]:
    """(dense, sparse_set) seconds of one update of a table of `table_bytes`
    that a batch touches at `n_ids` ids, by the cost model."""
    return (DENSE_S_PER_BYTE * table_bytes,
            SPARSE_S_PER_ID * n_ids + SPARSE_FIXED_S)


def plan_strategy(table_bytes: int, n_ids: int) -> str:
    """The split strategy that `split_costs` finds cheaper."""
    dense, sparse = split_costs(table_bytes, n_ids)
    return "sparse_set" if sparse < dense else "dense"


@dataclass
class TrainState:
    """What a step reads and updates: the model (weights, BatchNorm
    statistics), Adam over the dense parameters, one [R, 1] f32 row-wise
    Adagrad accumulator per updated table ('dim{d}') and the step count."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    table_acc: Dict[str, torch.Tensor]
    step: int = 0


def table_params(model: torch.nn.Module) -> Dict[int, torch.nn.Parameter]:
    """dim -> the stacked table parameter 'table_dim{d}'."""
    return {int(m.group(1)): p for name, p in model.named_parameters()
            if (m := _TABLE.search(name))}


class Trainer:
    """Trainer of one model on one device.

    table_update: "auto" (split when the model has row_injection, else
    dense), "split" or "dense"; "sparse" (the JAX package's touched-row
    update from a dense table gradient) is not ported. split_strategy:
    "auto" (each split table's by `plan_strategy`, from the sample batch's
    ids) or one of "dense", "sparse_set", "sparse" for every split table.
    device defaults to "cuda" and raises without a card unless "cpu" is
    asked for; the model must live there."""

    def __init__(self, model: torch.nn.Module, learning_rate: float = 1e-3,
                 table_learning_rate: Optional[float] = None,
                 table_update: str = "auto",
                 split_strategy: str = "auto",
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        if table_update == "sparse":
            raise NotImplementedError(
                "table_update='sparse' is not ported (ROADMAP Queue 1, item "
                "2); use 'split' or 'dense'")
        if table_update not in ("auto", "split", "dense"):
            raise ValueError(f"table_update must be auto|split|dense, got "
                             f"'{table_update}'")
        if split_strategy != "auto" and split_strategy not in STRATEGIES:
            raise ValueError(f"split_strategy {split_strategy!r}: auto or one "
                             f"of {STRATEGIES}")
        self.device = resolve_device(device)
        if any(p.device.type != self.device.type for p in model.parameters()):
            raise ValueError(f"the model's parameters are not on {self.device}")
        self.model = model
        self.base_lr = learning_rate
        self.table_lr = (default_table_lr(learning_rate)
                         if table_learning_rate is None else table_learning_rate)
        self.split = table_update in ("auto", "split") and \
            getattr(model, "row_injection", False)
        if table_update == "split" and not self.split:
            log.warning("table_update='split' needs model.row_injection; "
                        "the tables take the dense path")
        self.split_strategy = split_strategy
        self.table_update = table_update
        self._split_dims: Dict[int, str] = {}
        self._planned = False
        self.seed = seed
        self.control: Dict[str, Any] = {"stop": False, "lr_scale": 1.0}

    # ------------------------------------------------------------- state
    def _put(self, batch: Mapping[str, Any], check: bool = True
             ) -> Dict[str, torch.Tensor]:
        """The batch on the trainer's device, its ids checked first by
        `check_host_batch` unless `check` is off (prefetch checked them)."""
        if check:
            check_host_batch(self.model.schema, batch)
        if all(isinstance(v, torch.Tensor) for v in batch.values()):
            return {k: v.to(self.device, non_blocking=True)
                    for k, v in batch.items()}
        return to_device(batch, self.device)

    def plan(self, sample_batch: Mapping[str, Any]) -> List[int]:
        """Decide which tables take the split path (and with which strategy)
        from the sparse slots a sample batch carries. Returns the dims that
        need an accumulator."""
        schema = self.model.schema
        tables = table_params(self.model)
        n_ids: Dict[int, int] = {}
        for name in schema.order:
            slot = schema.slots[name]
            if slot.kind == "sparse" and name in sample_batch:
                n_ids[slot.dim] = n_ids.get(slot.dim, 0) + \
                    int(np.prod(sample_batch[name].shape))
        self._planned = True
        if not self.split:
            self._split_dims = {}
            return sorted(tables)
        self._split_dims = {}
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

    def init_state(self, sample_batch: Mapping[str, Any]) -> TrainState:
        """Plan the table updates from a sample batch and build the state.
        Dropout draws from torch's generator, seeded here with `seed`."""
        torch.manual_seed(self.seed)
        tables = table_params(self.model)
        table_acc = {f"dim{d}": init_accumulator(tables[d])
                     for d in self.plan(sample_batch)}
        dense = [p for name, p in self.model.named_parameters()
                 if not _TABLE.search(name)]
        optimizer = torch.optim.Adam(dense, lr=self.base_lr)
        if self._split_dims:
            self._validate_row_injection(self._put(sample_batch))
            log.info("split table updates: %s (rows gathered outside "
                     "autograd; no table gradient)",
                     {f"dim{d}": s for d, s in self._split_dims.items()})
        n = sum(p.numel() for p in self.model.parameters())
        log.info("initialized %s: %.3fM params on %s",
                 type(self.model).__name__, n / 1e6, self.device)
        return TrainState(self.model, optimizer, table_acc, 0)

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
        phys, rows = self.split_rows(batch)
        loss, aux = model({**batch,
                           **{rows_key(d): r for d, r in rows.items()}})
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
                             rows: Dict[int, torch.Tensor]) -> None:
        """The tables' row-wise Adagrad, in place."""
        tables = table_params(self.model)
        with torch.no_grad():
            if self._split_dims:
                for d, strategy in self._split_dims.items():
                    if d in phys:
                        split_table_update(
                            tables[d].detach(), state.table_acc[f"dim{d}"],
                            phys[d], rows[d].grad, lr=self.table_lr,
                            strategy=strategy)
                return
            for d, t in tables.items():
                if t.grad is not None:
                    rowwise_adagrad_update(t.detach(), state.table_acc[f"dim{d}"],
                                           t.grad, lr=self.table_lr)
                    t.grad = None

    def train_step(self, state: TrainState, batch: Mapping[str, Any]):
        """One step, in place on `state`. Returns (state, metrics) with the
        metrics as device scalars. A host batch's ids are checked first."""
        return self._step(state, self._put(batch))

    def _step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        """train_step on a batch that is on the device already."""
        loss, aux, phys, rows = self._forward_backward(batch)
        state.optimizer.step()
        self._apply_table_updates(state, phys, rows)
        state.step += 1
        return state, {"loss": loss.detach(),
                       **{k: v.detach() for k, v in aux.items()}}

    def set_learning_rate(self, state: TrainState, lr: float) -> None:
        """The dense LR (the tables keep their fixed Adagrad LR)."""
        for group in state.optimizer.param_groups:
            group["lr"] = lr

    # --------------------------------------------------------------- loops
    def predict(self, state: TrainState, dataset: Iterable) -> Dict[str, np.ndarray]:
        return predict(state.model, dataset, self.device)

    def evaluate(self, state: TrainState, dataset: Iterable) -> Dict[str, float]:
        """val_loss (the model's loss on eval outputs) and val_auc (cosine
        similarity against the label)."""
        from recommendflow_tpu_torch.train.metrics import roc_auc
        model = state.model
        try:
            loss_fn = model.resolve_loss()
        except (AttributeError, ValueError):
            loss_fn = None
        losses, scores, labels = [], [], []
        model.eval()
        with torch.no_grad():
            for batch in prefetch(checked_batches(model, dataset)):
                out = model(self._put(batch, check=False))
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
            resume_data: bool = True, verbose: bool = True) -> Dict[str, Any]:
        """Train `epochs` epochs; returns {'state', 'history'}. Each epoch's
        logs hold the mean step metrics, examples_per_sec (the host clock
        around the epoch, read after the card finished it), the validation
        metrics and what the callbacks add. A given `state` with steps done
        resumes mid-stream when train_ds has a length (resume_data)."""
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
        self.control["stop"] = False
        for cb in callbacks:
            cb.on_train_begin(self)
        lr_scale = 1.0
        logs: Dict[str, float] = {}
        for epoch in range(start_epoch, epochs):
            if self.control["stop"]:
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
            for batch in prefetch(checked_batches(self.model, raw)):
                state, metrics = self._step(state, self._put(batch,
                                                             check=False))
                n_steps += 1
                n_examples += len(next(iter(batch.values())))
                for k, v in metrics.items():
                    running[k] = running[k] + v if k in running else v
                if n_steps % log_every == 0:
                    log.info("epoch %d step %d: %s", epoch, n_steps, " ".join(
                        f"{k}={float(v):.5f}" for k, v in metrics.items()))
            # the read-back waits for the card, so dt covers the epoch's work
            logs = {k: float(v) / max(n_steps, 1) for k, v in running.items()}
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            logs["examples_per_sec"] = n_examples / max(dt, 1e-9)
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
        for cb in callbacks:
            cb.on_train_end(self, state, logs)
        return {"state": state, "history": history.epochs}


def _chain_first(first, rest):
    yield first
    yield from rest
