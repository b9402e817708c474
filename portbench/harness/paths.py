"""The program's timed paths, one per kind of traffic file ("path"):

  * "fit": `Trainer.fit` over a pool of seeded batches, cycled in whole
    stacks of `stack_steps` until the window closes (its CUDA graphs
    captured in set-up); on a mesh (`MeshFitPath`: a cell on several cards,
    or one whose configuration says `shard_tables`) the same on every rank,
    each fed its own rows of the global batches;
  * "recall_search": a closed loop of requests, each `Trainer.predict`'s
    graphed eval forward of the rows, then `FlatSearcher(metric="cos")
    .search(topk)` over a seeded catalogue;
  * "export_score": a closed loop of requests, each
    `ServingModel.predict` of a program traced by `trace_model` (served
    from memory, as `cli/serve --model` serves a loaded export).

A traced run traces a stretch in the middle of its window: `--trace 1`
reads the device's work from it and each step's or request's wall time
from the untraced rest of the same window.

Each path makes its weights and inputs from the run's seed (the same
values go to the program and, after the window, to the reference), runs
its window, and works out the numbers that decide `correct` from what the
timed path produced, against the plain reference.
"""
from __future__ import annotations

import gc
import sys
import time
import traceback
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from portbench.harness import traffic as gen
from portbench.harness.cell import Cell
from portbench.harness.trace import TraceSummary, read_profile
from portbench.reference.common import (TRAINED_KINDS, Adam, Precision,
                                        TouchedRows, default_generator,
                                        draw_rows,
                                        dropout_seed, exact_float32,
                                        exact_scores, make_dense, make_tables,
                                        normalize_rows, pooled_features,
                                        rowwise_adagrad, store_positions,
                                        stored_row_grads, table_store)
from portbench.reference.layout import Layout


def profiler(device: torch.device):
    """The device's activity on a card (`trace.py`); the host's operators
    on the CPU, where the tests run."""
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[act.CUDA if device.type == "cuda" else act.CPU])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tensors(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class Window:
    """What a window measured: `units` steps or requests attempted,
    `failed`, its host-clock `seconds`, the requests answered before it
    closed (`completed`), each request's latency (s), and for a traced run
    the trace, the host batches of the traced units, the traced stretch's
    host-clock seconds (`trace_s`) and the wall seconds of one untraced
    step or request (`unit_s`)."""

    def __init__(self):
        self.units = 0
        self.failed = 0
        self.completed = 0
        self.seconds = 0.0
        self.examples = 0
        self.latencies: List[float] = []
        self.trace: Optional[TraceSummary] = None
        self.traced_batches: List[Mapping[str, np.ndarray]] = []
        self.trace_s = 0.0
        self.unit_s: Optional[float] = None


class Path:
    """Set-up shared by every path: the layout, the weights from the seed
    and the program's model holding them. `world` is the number of ranks
    and `row_sharded` the table widths whose rows they divide (a mesh:
    `MeshFitPath`)."""

    world = 1
    row_sharded: Tuple[int, ...] = ()

    def __init__(self, cell: Cell, device: torch.device, seed: int):
        self.cell, self.device, self.seed = cell, torch.device(device), int(seed)
        self.config = cell.config
        self.traffic = cell.traffic
        self.args = self.config["model_args"]
        self.layout = Layout(self.config)
        self.ref = cell.reference
        self.specs = self.ref.param_specs(self.layout, self.args)

    def reference_weights(self) -> Tuple[Dict[int, torch.Tensor], Dict[str, torch.Tensor]]:
        return (make_tables(self.layout, self.seed, self.device),
                make_dense(self.specs, self.seed, self.device))

    def build_model(self) -> torch.nn.Module:
        """The program's model, holding the benchmark's weights: the dense
        ones copied in, each table handed over as the parameter's data."""
        mod = self.cell.config_module
        model = mod.build_model(self.config, self.device, self.seed)
        tables, dense = self.reference_weights()
        named = self.copy_dense(model, dense)
        with torch.no_grad():
            for d, t in tables.items():
                p = named[mod.table_name(d)]
                if p.numel() != t.numel() or p.dtype != t.dtype:
                    raise ValueError(f"table dim{d}: the program's {tuple(p.shape)} "
                                     f"{p.dtype} is not the layout's {tuple(t.shape)} {t.dtype}")
                p.data = t.view(p.shape)
        return model

    def copy_dense(self, model: torch.nn.Module, dense: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """Copy the benchmark's dense weights into the program's model;
        returns its parameters and buffers by name."""
        mod = self.cell.config_module
        named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
        with torch.no_grad():
            for name, shape, _ in self.specs:
                target = named[mod.port_name(name)]
                target.copy_(dense[name].view(target.shape))
        return named

    def free(self) -> None:
        for k in list(vars(self)):
            if k not in ("cell", "device", "seed", "config", "traffic", "args",
                         "layout", "ref", "specs", "answers", "program",
                         "pool", "group", "world", "row_sharded"):
                delattr(self, k)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ------------------------------------------------------------------ fit

class FitPath(Path):
    """Training through `Trainer.fit`. Set-up runs the run's first three
    steps through `Trainer.train_steps`, the call that drives the same
    StepGraph as fit's stacks (the first step eager, the second captured
    and replayed, the third replayed), and reads them: each step's loss,
    the first gradient as the optimizer holds it after step one (Adam's
    first moment / (1 - b1); a table's from its Adagrad accumulator) and
    each leaf's change after step three."""

    kind = "train"

    def setup(self) -> None:
        from recommendflow_tpu_torch.train.trainer import Trainer
        opt = self.config["optimizer"]
        self.batch_size = int(self.config["batch_size"])
        self.stack = int(self.traffic["stack_steps"])
        self.pool = gen.batch_pool(self.layout, self.batch_size,
                                   int(self.traffic["pool_batches"]), self.seed,
                                   float(self.traffic["zipf"]))
        model = self.build_model()
        self.trainer = Trainer(model, learning_rate=opt["dense"]["lr"],
                               table_learning_rate=opt["tables"]["lr"],
                               device=self.device, seed=self.seed,
                               **self.trainer_options())
        self.state = self.trainer.init_state(self.feed(self.pool[0]))
        self.program = self._first_steps()
        # fit's own feed and stacks, on graphs captured above
        self._fit(len(self.pool) // self.stack * self.stack, None)
        sync(self.device)

    # what a mesh changes (`MeshFitPath`); on one card these are plain
    def trainer_options(self) -> Dict[str, Any]:
        return {}

    def feed(self, batch: Mapping[str, np.ndarray]) -> Mapping[str, np.ndarray]:
        """The rows of a global batch that this process passes."""
        return batch

    def train_call(self, batch: Mapping[str, np.ndarray]):
        """One of the first steps, through the call that drives fit's
        stacks (`train_steps`: the same StepGraph)."""
        return self.trainer.train_steps(self.state, [batch])

    def agree(self, stop: bool) -> bool:
        """Whether the window closes here (at a stack's start)."""
        return stop

    def _leaves(self):
        mod = self.cell.config_module
        named = dict(self.trainer.model.named_parameters())
        dense = {n: named[mod.port_name(n)] for n, _, k in self.specs
                 if k in TRAINED_KINDS}
        tables = {d: named[mod.table_name(d)] for d in self.layout.groups}
        return dense, tables

    def _first_steps(self) -> Dict[str, Any]:
        opt = self.config["optimizer"]
        dense, tables = self._leaves()
        p0 = {n: p.detach().clone() for n, p in dense.items()}
        t0 = {d: t.detach().clone() for d, t in tables.items()}
        losses: List[float] = []
        grad: Dict[str, float] = {}
        for i in range(3):
            self.state, m = self.train_call(self.feed(self.pool[i]))
            losses.append(float(m["loss"]))
            if i == 0:
                b1 = opt["dense"]["b1"]
                for n, p in dense.items():
                    m1 = self.state.optimizer.state.get(p, {}).get("exp_avg")
                    grad[n] = 0.0 if m1 is None else \
                        float(torch.linalg.vector_norm(m1.double() / (1 - b1)))
                for d in tables:
                    grad[f"table_dim{d}"] = accumulated_norm(
                        self.state.table_acc[f"dim{d}"].reshape(-1),
                        opt["tables"]["init_acc"],
                        self.layout.groups[d].pack * d)
        change = {n: float(torch.linalg.vector_norm(p.detach().double() - p0[n].double()))
                  for n, p in dense.items()}
        for d, t in tables.items():
            change[f"table_dim{d}"] = table_change(t.detach(), t0[d])
        del p0, t0
        return {"loss": losses, "grad": grad, "change": change}

    def _batches(self, steps: Optional[int], deadline: Optional[float],
                 record: Optional[List]):
        """Pool batches cycled from where the last call stopped, in whole
        stacks: `steps` of them, or until `deadline` (perf_counter) at a
        stack's start."""
        i = 0
        while True:
            if i % self.stack == 0:
                if steps is not None and i >= steps:
                    return
                if deadline is not None and \
                        self.agree(time.perf_counter() >= deadline):
                    return
            b = self.feed(self.pool[self._next % len(self.pool)])
            self._next += 1
            if record is not None:
                record.append(b)
            yield b
            i += 1

    def _fit(self, steps: Optional[int], deadline: Optional[float],
             record: Optional[List] = None) -> int:
        if not hasattr(self, "_next"):
            self._next = 3
        before = self.state.step
        out = self.trainer.fit(self._batches(steps, deadline, record),
                               state=self.state, verbose=False)
        self.state = out["state"]
        return self.state.step - before

    def window(self, seconds: float, trace: bool) -> Window:
        """Fit until the window closes. Traced: `trace_stacks` stacks
        traced after half the window, and `unit_s` the wall time of a step
        outside them."""
        w = Window()
        t0 = time.perf_counter()
        if not trace:
            w.units = self._fit(None, t0 + seconds)
            sync(self.device)
        else:
            w.units = self._fit(None, t0 + seconds / 2)
            sync(self.device)
            ta = time.perf_counter()
            with profiler(self.device) as prof:
                tb = time.perf_counter()
                n = self._fit(int(self.traffic["trace_stacks"]) * self.stack,
                              None, w.traced_batches)
                sync(self.device)
                w.trace_s = time.perf_counter() - tb
            traced_s = time.perf_counter() - ta
            w.units += self._fit(None, t0 + seconds)
            sync(self.device)
            untraced = w.units
            w.units += n
            w.unit_s = (time.perf_counter() - t0 - traced_s) / max(untraced, 1)
        w.seconds = time.perf_counter() - t0
        if trace:
            w.trace = read_profile(prof)
        w.examples = w.units * self.batch_size
        return w

    def reference(self, precision: str = "float32") -> Dict[str, Any]:
        """The reference's three steps on the same batches and weights."""
        tables, dense = self.reference_weights()
        return self.reference_steps(precision, tables, dense)

    def reference_steps(self, precision: str, tables: Mapping, dense: Mapping
                        ) -> Dict[str, Any]:
        """The reference's three steps on the pool's first batches from the
        given weights (each table whole, or its `TouchedRows`), each step's
        dropout drawn over the whole batch."""
        opt = self.config["optimizer"]
        prec = Precision(precision)
        trained = [n for n, _, k in self.specs if k in TRAINED_KINDS]
        params = {n: dense[n].clone() for n in trained}
        buffers = {n: v for n, v in dense.items() if n not in params}
        p0 = {n: v.clone() for n, v in params.items()}
        t0 = {d: table_store(t).clone() for d, t in tables.items()}
        acc = {d: torch.full((table_store(tables[d]).shape[0] // g.pack,),
                             opt["tables"]["init_acc"],
                             dtype=torch.float32, device=self.device)
               for d, g in self.layout.groups.items()}
        od = opt["dense"]
        adam = Adam(od["lr"], od["b1"], od["b2"], od["eps"])
        losses: List[float] = []
        grad: Dict[str, float] = {}
        with exact_float32():
            for i in range(3):
                default_generator(self.device).manual_seed(dropout_seed(self.seed, i))
                batch = tensors(self.pool[i], self.device)
                leaves = {n: v.detach().requires_grad_() for n, v in params.items()}
                feats, rows = pooled_features(self.layout, tables, batch, grad=True)
                loss = self.ref.loss({**leaves, **buffers}, feats, batch,
                                     self.layout, self.args, prec)
                loss.backward()
                losses.append(float(loss.detach()))
                grads = {n: leaves[n].grad for n in leaves}
                if i == 0:
                    grad.update({n: float(torch.linalg.vector_norm(g.double()))
                                 for n, g in grads.items()})
                adam.step(params, grads)
                with torch.no_grad():
                    for d, r in rows.items():
                        ids, g = stored_row_grads(self.layout, d, r)
                        rowwise_adagrad(table_store(tables[d]), acc[d],
                                        self.layout.groups[d].pack,
                                        store_positions(tables[d], ids), g,
                                        opt["tables"]["lr"], opt["tables"]["eps"])
                if i == 0:
                    for d in tables:
                        grad[f"table_dim{d}"] = accumulated_norm(
                            acc[d], opt["tables"]["init_acc"],
                            self.layout.groups[d].pack * d)
        change = {n: float(torch.linalg.vector_norm(params[n].double() - p0[n].double()))
                  for n in params}
        for d in tables:
            change[f"table_dim{d}"] = table_change(table_store(tables[d]), t0[d])
        return {"loss": losses, "grad": grad, "change": change}

    @staticmethod
    def numbers(program: Mapping, ref: Mapping) -> Dict[str, float]:
        """loss1_gap: |loss - reference| / |reference| of the first step;
        loss_gap: the largest of the three steps'. grad_gap: the worst
        leaf's gap between the program's first-gradient norm and the
        reference's, over the larger of that leaf's reference norm and the
        median leaf's; dense_grad_gap: the same over the leaves that are not
        tables, and median_dense_grad_gap their median leaf's gap (steady
        where one activation's input rounds across the kink of a ReLU or
        selu and moves the worst leaf). change_gap: the same of each leaf's
        change after step three, median_change_gap: the median leaf's; both
        leave out the leaves whose reference gradient is under a thousandth
        of the median leaf's (they move by round-off alone)."""
        gaps = [abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(program["loss"], ref["loss"])]
        leaves = FitPath.leaf_gaps(program, ref)
        dense = [v["grad"] for k, v in leaves.items() if not k.startswith("table_")]
        g_med = float(np.median(list(ref["grad"].values())))
        moved = [k for k, v in ref["grad"].items() if v >= 1e-3 * g_med]
        return {"loss1_gap": gaps[0], "loss_gap": max(gaps),
                "grad_gap": max(v["grad"] for v in leaves.values()),
                "dense_grad_gap": max(dense),
                "median_dense_grad_gap": float(np.median(dense)),
                "change_gap": max(leaves[k]["change"] for k in moved),
                "median_change_gap": float(np.median([leaves[k]["change"]
                                                      for k in moved]))}

    @staticmethod
    def leaf_gaps(program: Mapping, ref: Mapping) -> Dict[str, Dict[str, float]]:
        """Each leaf's first-gradient and change gaps (`numbers`)."""
        g_med = float(np.median(list(ref["grad"].values())))
        moved = [k for k, v in ref["grad"].items() if v >= 1e-3 * g_med]
        c_med = float(np.median([ref["change"][k] for k in moved]))
        return {k: {"grad": abs(program["grad"][k] - v) / max(v, g_med, 1e-30),
                    "change": abs(program["change"][k] - ref["change"][k]) /
                    max(ref["change"][k], c_med, 1e-30)}
                for k, v in ref["grad"].items()}


def accumulated_norm(acc: torch.Tensor, init: float, width: int) -> float:
    """The norm of a table's first gradient from its row-wise Adagrad
    accumulator after one step: sqrt(width * sum(acc - init))."""
    seed = float(np.float32(init))
    return float(torch.sqrt(width * torch.sum(acc.double() - seed)))


def table_change(t: torch.Tensor, t0: torch.Tensor, elements: int = 1 << 27) -> float:
    """The norm of t - t0 in float64, in blocks of rows of about
    `elements` entries."""
    total = 0.0
    block = max(1, elements // max(1, t[0].numel()))
    for s in range(0, t.shape[0], block):
        d = t[s:s + block].double() - t0[s:s + block].double()
        total += float(torch.sum(d * d))
    return total ** 0.5


class MeshFitPath(FitPath):
    """`FitPath` on a mesh (`harness/ranks.py`), in every rank: the
    program's `Trainer(model, mesh=, shard_tables=)` with the
    configuration's `shard_tables`, fed this rank's rows of each global
    batch (`parallel.mesh.shard_batch`; `batch_size` is the global batch),
    the window closing where rank 0 says (at a stack's start).

    Weights by block (`reference.common.draw_rows`): a table that the
    program row-shards (its own `table_sharding_rules`) is drawn only for
    the stored rows this rank holds, and handed over as that rank's block;
    every other table whole.

    The first three steps go through the call that fit makes on this
    mesh: the graphed stacks' (`train_steps`) where fit stacks steps,
    else one eager step (`train_step`; a multi-process fit takes one step
    at a time). Each rank reads them as `FitPath` does; a row-sharded
    table's first-gradient and change numbers as squares over its own
    block, which rank 0 sums (`combine`). The reference runs the same
    three steps on the global batches, holding only the rows they touch
    (`TouchedRows`), its dropout drawn over each whole global batch as the
    JAX trainer draws it (the program's ranks draw alike: a cell with
    dropout on several ranks reads not correct, PERF.md §7)."""

    def __init__(self, cell: Cell, device: torch.device, seed: int, group):
        super().__init__(cell, device, seed)
        self.group = group
        self.world = group.world
        self.shard = bool(self.config["shard_tables"]) \
            if "shard_tables" in self.config else False

    def trainer_options(self) -> Dict[str, Any]:
        return {"mesh": self.group.mesh, "shard_tables": self.shard}

    def feed(self, batch):
        from recommendflow_tpu_torch.parallel.mesh import shard_batch
        return shard_batch(self.group.mesh, batch)

    def train_call(self, batch):
        from recommendflow_tpu_torch.train.trainer import resolve_scan_steps
        if resolve_scan_steps(None, self.device, self.group.world > 1) > 1:
            return super().train_call(batch)
        return self.trainer.train_step(self.state, batch)

    def agree(self, stop: bool) -> bool:
        return self.group.agree(stop)

    def build_model(self) -> torch.nn.Module:
        """The program's model holding the benchmark's weights: the dense
        ones copied in; a table that the program row-shards cut and marked
        by the program (`mark_row_shard`; one built at a rank's share first
        given the whole table's shape, without its memory) and handed this
        rank's block (drawn alone), every other table drawn whole."""
        from recommendflow_tpu_torch.parallel.mesh import table_sharding_rules
        from recommendflow_tpu_torch.parallel.sharded_embedding import \
            mark_row_shard
        mod = self.cell.config_module
        mesh, n = self.group.mesh, self.group.mesh.size("dp")
        model = mod.build_model(self.config, self.device, self.seed)
        named = self.copy_dense(model, make_dense(self.specs, self.seed, self.device))
        row_sharded = []
        with torch.no_grad():
            for d, g in self.layout.groups.items():
                name = mod.table_name(d)
                p = named[name]
                size = g.logical_rows * d
                if p.numel() == size:
                    shape = tuple(p.shape)
                elif p.numel() * n == size:
                    shape = (p.shape[0] * n,) + tuple(p.shape[1:])
                else:
                    raise ValueError(f"table dim{d}: the program's {tuple(p.shape)} "
                                     f"is neither the layout's {g.logical_rows} x {d} "
                                     f"nor one rank's share of it")
                if p.dtype != getattr(torch, self.layout.table_dtype):
                    raise ValueError(f"table dim{d}: the program's {p.dtype} is "
                                     f"not the layout's {self.layout.table_dtype}")
                spec = table_sharding_rules(
                    {name: torch.empty(shape, device="meta")}, mesh, "dp")[name]
                if self.shard and spec:
                    row_sharded.append(d)
                    if p.numel() != size:
                        p.data = p.data[:1].clone().expand(shape)
                    mark_row_shard(p, mesh, "dp")
                    share = g.logical_rows // n
                    t = draw_rows(self.layout, self.seed, d, mesh.rank("dp") * share,
                                  (mesh.rank("dp") + 1) * share, self.device)
                else:
                    t = draw_rows(self.layout, self.seed, d, 0, g.logical_rows,
                                  self.device)
                p.data = t.view(p.shape)
        self.row_sharded = tuple(row_sharded)
        print(f"rank {self.group.rank}: row-sharded over {n} rank(s): " +
              (" ".join(f"dim{d}" for d in row_sharded) or "none"),
              file=sys.stderr, flush=True)
        return model

    def _first_steps(self) -> Dict[str, Any]:
        """`FitPath._first_steps` on this rank, each table's numbers as
        squares: a row-sharded table's over this rank's block, any other
        table's on rank 0 alone (zero elsewhere)."""
        out = super()._first_steps()
        own = self.group.rank == 0
        out["tables"] = {}
        for d in self.layout.groups:
            key = f"table_dim{d}"
            g, c = out["grad"].pop(key), out["change"].pop(key)
            out["tables"][key] = (g * g, c * c) if d in self.row_sharded or own \
                else (0.0, 0.0)
        return out

    @staticmethod
    def combine(parts: List[Mapping[str, Any]]) -> Dict[str, Any]:
        """Every rank's `_first_steps` (rank order) -> `FitPath`'s form:
        rank 0's losses and dense numbers, each table's norms from the
        ranks' squares summed in float64."""
        first = parts[0]
        grad, change = dict(first["grad"]), dict(first["change"])
        for key in first["tables"]:
            grad[key] = float(np.sqrt(sum(float(p["tables"][key][0]) for p in parts)))
            change[key] = float(np.sqrt(sum(float(p["tables"][key][1]) for p in parts)))
        return {"loss": list(first["loss"]), "grad": grad, "change": change}

    def reference(self, precision: str = "float32") -> Dict[str, Any]:
        """The reference's three steps on the global batches, each table as
        the rows these steps touch, drawn by block (`TouchedRows`)."""
        touched: Dict[int, List[np.ndarray]] = {}
        for b in self.pool[:3]:
            for d, (gids, _) in self.layout.group_ids(b).items():
                touched.setdefault(d, []).append(gids)
        tables = {d: TouchedRows(self.layout, self.seed, d, torch.from_numpy(
            np.concatenate(ids)).to(self.device)) for d, ids in touched.items()}
        return self.reference_steps(precision, tables,
                                    make_dense(self.specs, self.seed, self.device))


# ------------------------------------------------------------- requests

class RequestPath(Path):
    """A closed loop of requests from one caller: each request is sent as
    soon as the last one's answer is back on the host, from a pool of
    seeded batches in turn, until the window closes, and is timed from its
    send to its answer. The requests answered by the close are the
    window's completed requests; a sample of the answered ones, drawn from
    the seed, keeps its answers for the check."""

    kind = "serve"

    def setup(self) -> None:
        t = self.traffic
        self.pool = gen.batch_pool(self.layout, int(t["rows"]), int(t["pool"]),
                                   self.seed, float(t["zipf"]))
        self.build()
        for i in range(int(t.get("warmup", 8))):
            self.serve(self.pool[i % len(self.pool)])
        sync(self.device)

    def window(self, seconds: float, trace: bool) -> Window:
        """Requests back to back until `seconds` have passed. Traced:
        `trace_requests` traced from half the window, and `unit_s` the mean
        latency of the requests outside them."""
        t = self.traffic
        sample = gen.Reservoir(int(t["sample"]), self.seed)
        n_traced = int(t.get("trace_requests", 0)) if trace else 0
        w = Window()
        prof = finished = None
        tb, first = 0.0, 0
        t0 = time.perf_counter()
        close, trace_at = t0 + seconds, t0 + seconds / 2
        i = 0
        while True:
            now = time.perf_counter()
            if now >= close:
                break
            if n_traced and prof is None and finished is None and now >= trace_at:
                sync(self.device)
                prof = profiler(self.device)
                prof.__enter__()
                tb, first = time.perf_counter(), i
            k = i % len(self.pool)
            sent = time.perf_counter()
            try:
                ans = self.serve(self.pool[k])
            except Exception:          # a request that fails counts as failed
                if not w.failed:
                    traceback.print_exc()
                w.failed += 1
                ans = None
            done = time.perf_counter()
            w.latencies.append(done - sent)
            if ans is not None:
                if done <= close:
                    w.completed += 1
                sample.offer(i, (k, ans))
            if prof is not None:
                w.traced_batches.append(self.pool[k])
                if len(w.traced_batches) == n_traced:
                    finished, prof = self._stop(prof, tb, w), None
            i += 1
        if prof is not None:               # fewer requests than were to be traced
            finished = self._stop(prof, tb, w)
        sync(self.device)
        w.seconds = time.perf_counter() - t0
        w.units = i
        if w.traced_batches:
            rest = w.latencies[:first] + w.latencies[first + len(w.traced_batches):]
            w.unit_s = float(np.mean(rest)) if rest else None
        self.answers: Dict[int, Tuple[int, Dict[str, np.ndarray]]] = sample.kept
        if finished is not None:            # read once the window has closed
            w.trace = read_profile(finished)
        return w

    def _stop(self, prof, tb: float, w: Window):
        sync(self.device)
        w.trace_s = time.perf_counter() - tb
        prof.__exit__(None, None, None)
        return prof


class RecallSearchPath(RequestPath):
    """Rows -> the user vectors of Trainer.predict's graphed eval forward
    -> the top-k of FlatSearcher(metric="cos") over the catalogue."""

    def build(self) -> None:
        from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
        from recommendflow_tpu_torch.train.trainer import Trainer
        cat = self.traffic["catalogue"]
        model = self.build_model()
        self.trainer = Trainer(model, device=self.device, seed=self.seed)
        self.state = self.trainer.init_state(self.pool[0])
        items = gen.catalogue(int(cat["items"]), int(cat["dim"]), int(cat["centres"]),
                              float(cat["noise"]), self.seed, self.device)
        self.searcher = FlatSearcher(int(cat["dim"]), metric="cos",
                                     device=self.device).train(items.cpu().numpy())
        del items

    def serve(self, batch) -> Dict[str, np.ndarray]:
        out = self.trainer.predict(self.state, [batch])
        ids, scores, _ = self.searcher.search(out["user"],
                                              topk=int(self.traffic["topk"]))
        return {"user": out["user"], "ids": ids, "scores": scores}

    def reference(self, precision: str = "float32", answers: Optional[Mapping] = None
                  ) -> Dict[int, Dict[str, np.ndarray]]:
        """Per sampled request: the reference's user vectors, its exact
        top-k (scores and ids) and its scores of the ids in `answers` (the
        program's, by default)."""
        prec = Precision(precision)
        cat = self.traffic["catalogue"]
        tables, dense = self.reference_weights()
        items = normalize_rows(gen.catalogue(
            int(cat["items"]), int(cat["dim"]), int(cat["centres"]),
            float(cat["noise"]), self.seed, self.device))
        k = int(self.traffic["topk"])
        out: Dict[int, Dict[str, np.ndarray]] = {}
        with exact_float32(), torch.no_grad():
            for i, (b, ans) in (answers or self.answers).items():
                batch = tensors(self.pool[b], self.device)
                feats, _ = pooled_features(self.layout, tables, batch)
                u = self.ref.vectors(dense, feats, self.layout, self.args, False,
                                     prec)["user"]
                s = exact_scores(normalize_rows(u), items, prec)
                top = torch.topk(s, k, dim=1)
                ids = torch.as_tensor(ans["ids"], device=self.device).long()
                out[i] = {"user": u.cpu().numpy(),
                          "top_scores": top.values.cpu().numpy(),
                          "top_ids": top.indices.cpu().numpy(),
                          "scores_of_ids": torch.gather(s, 1, ids).cpu().numpy()}
        return out

    def numbers(self, program: Mapping, ref: Mapping) -> Dict[str, float]:
        """user_gap: the largest gap of a user vector's entry. rank_gap: the
        widest gap by which the program's j-th item's reference score lies
        below the reference's j-th best. score_gap: the largest gap between
        a score the program returned and the reference's score of that id."""
        user = rank = score = 0.0
        for i, r in ref.items():
            a = program[i][1]
            user = max(user, float(np.abs(a["user"] - r["user"]).max()))
            rank = max(rank, float((r["top_scores"] - r["scores_of_ids"]).max()))
            score = max(score, float(np.abs(a["scores"] - r["scores_of_ids"]).max()))
        return {"user_gap": user, "rank_gap": rank, "score_gap": score}


class ExportScorePath(RequestPath):
    """Rows -> ServingModel.predict of the program traced at the request's
    shape, with the label columns baked in as constants (as cli/export
    does)."""

    def build(self) -> None:
        from recommendflow_tpu_torch.export.exporter import ServingModel, trace_model
        rows = int(self.traffic["rows"])
        model = self.build_model()
        model.eval()
        labels = self.layout.labels
        self.pool = [gen.to_features_only(b, labels) for b in self.pool]
        program, meta = trace_model(model, self.pool[0], constants={
            n: np.zeros((rows,), np.float32) for n in labels})
        self.serving = ServingModel(program, meta, self.device)
        self.model = model

    def serve(self, batch) -> Dict[str, np.ndarray]:
        return {"logit": self.serving.predict(batch)["logit"]}

    def reference(self, precision: str = "float32", answers: Optional[Mapping] = None
                  ) -> Dict[int, Dict[str, np.ndarray]]:
        prec = Precision(precision)
        tables, dense = self.reference_weights()
        out = {}
        with exact_float32(), torch.no_grad():
            for i, (b, _) in (answers or self.answers).items():
                batch = tensors(self.pool[b], self.device)
                feats, _ = pooled_features(self.layout, tables, batch)
                z = self.ref.vectors(dense, feats, self.layout, self.args, False,
                                     prec)["logit"]
                out[i] = {"logit": z.cpu().numpy()}
        return out

    def numbers(self, program: Mapping, ref: Mapping) -> Dict[str, float]:
        """logit_gap: the largest |logit - reference| over the sampled
        requests' rows."""
        gap = 0.0
        for i, r in ref.items():
            gap = max(gap, float(np.abs(program[i][1]["logit"] - r["logit"]).max()))
        return {"logit_gap": gap}


def control_answers(path: RequestPath, ref: Mapping) -> Dict[int, Tuple[int, Dict]]:
    """A reference's outputs (in another precision) in the form of the
    program's answers to the same sampled requests: the control put in the
    program's place."""
    out = {}
    for i, (b, _) in path.answers.items():
        r = ref[i]
        out[i] = (b, {"user": r["user"], "ids": r["top_ids"], "scores": r["top_scores"]}
                  if "user" in r else {"logit": r["logit"]})
    return out


PATHS = {"fit": FitPath, "recall_search": RecallSearchPath,
         "export_score": ExportScorePath}
MESH_PATHS = {"fit": MeshFitPath}


def make_path(cell: Cell, device, seed: int, group=None) -> Path:
    """The cell's path; on a mesh (`group`: `harness/ranks.py`'s Group) its
    mesh form, which only training has."""
    if group is None:
        return PATHS[cell.traffic["path"]](cell, device, seed)
    if cell.traffic["path"] not in MESH_PATHS:
        raise ValueError(f"{cell.name}: the {cell.traffic['path']!r} path does not "
                         f"run on a mesh (chips {cell.chips}, shard_tables "
                         f"{cell.config.get('shard_tables')!r}); only training does")
    return MESH_PATHS[cell.traffic["path"]](cell, device, seed, group)
