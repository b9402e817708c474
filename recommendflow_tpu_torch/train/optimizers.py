"""Optimizers for embedding-table training (the counterpart of
`recommendflow_tpu/train/optimizers.py` and of `make_optimizer` in
`recommendflow_tpu/train/trainer.py`).

The stacked embedding tables dominate the parameter count, so by default
they take row-wise Adagrad (one f32 accumulator per stored row, acc [R, 1])
and the dense towers take Adam (`torch.optim.Adam` over the non-table
parameters only; the trainer updates the tables itself, in place, under
no_grad):

  * `split_table_update` (`split_tables_update` over every split table of
    a step): row-wise Adagrad from sparse [N, W] row gradients
    (the trainer's split path), strategies "dense" (scatter_add_rows into a
    zero table, then rowwise_adagrad_update), "sparse_set"
    (sparse_adagrad_apply) and "sparse" (scatter-ADD of the update, plain
    torch: the JAX package has no kernel for it);
  * `sparse_rowwise_adagrad_update`: row-wise Adagrad on the rows a batch
    touches, read from a dense table gradient (table_update="sparse":
    gather_rows, then sparse_adagrad_apply);
  * `rowwise_adagrad_update` (ops/cuda/table_update.py) on a dense table
    gradient: the trainer's table_update="dense" path.

Every update runs in place on the table and its accumulator. The duplicate
sum before the kernels (`combine_row_grads`, ops/cuda/row_grad_combine.py:
one grouped call over every split table of a step, `split_tables_update`)
and the touched rows' compaction (`unique_sorted`) keep their unique count
on the device, so no step waits on the host for it.

A user-chosen optimizer (`make_optimizer`, `make_partitioned_optimizer`) is
an `OptimizerSpec` that the trainer builds over the model's parameters into
an `OptaxOptimizer`: optax's update rules in plain torch (not torch.optim's,
whose Adagrad and gradient clipping differ), with optax's injected learning
rate in `param_groups[0]["lr"]`. `make_lr_schedule` gives optax's schedules
as functions of the update count.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from recommendflow_tpu_torch.ops.cuda.embedding_bag import (
    gather_rows, scatter_add_rows, unique_sorted)
from recommendflow_tpu_torch.ops.cuda.row_grad_combine import (
    combine_row_grads)
from recommendflow_tpu_torch.ops.cuda.sparse_apply import sparse_adagrad_apply
from recommendflow_tpu_torch.ops.cuda.table_update import (
    rowwise_adagrad_update)
from recommendflow_tpu_torch.parallel.distributed import all_reduce_nograd

# the Adagrad accumulator seed, shared by every table-update path
ADAGRAD_INIT_ACCUMULATOR = 0.1
STRATEGIES = ("dense", "sparse", "sparse_set")
OPTIMIZERS = ("adam", "adamw", "adagrad", "sgd", "lamb")
DENSE_OPTIMIZERS = ("adam", "adamw", "sgd")    # make_partitioned_optimizer's
SCHEDULES = ("cosine", "linear", "warmup_constant")
_TABLE = re.compile(r"table_dim\d+$")


def default_table_lr(learning_rate: float) -> float:
    """The table LR derived from the dense LR (Adagrad wants a larger one)."""
    return max(learning_rate * 30.0, 0.01)


def init_accumulator(table: torch.Tensor) -> torch.Tensor:
    """A table's row-wise Adagrad accumulator: [R, 1] f32 at the seed."""
    return torch.full((table.shape[0], 1), ADAGRAD_INIT_ACCUMULATOR,
                      dtype=torch.float32, device=table.device)


def split_table_update(p: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                       g: torch.Tensor, *, lr: float, eps: float = 1e-10,
                       strategy: str = "dense"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise Adagrad from sparse per-row gradients, in place.

    p [R, W] (f32 or bf16), acc [R, 1] f32, ids [N] stored rows (duplicates
    allowed, any order), g [N, W] row gradients -> (p, acc), both updated in
    place. Every strategy squares the SUM of a row's duplicate gradients,
    summed in f32 (`combine_row_grads`, ops/cuda/row_grad_combine.py).

      "dense":      scatter_add_rows of the sums into a zero [R, W] table of
                    p's dtype (one rounding), then rowwise_adagrad_update
                    over the whole table (rows whose gradient is zero keep
                    their bits). The JAX strategy adds the duplicates into
                    the zero table one by one in p's dtype, rounding after
                    each add: for a bf16 table and a row a batch touches
                    many times the two sums differ by more than a rounding.
      "sparse_set": sparse_adagrad_apply on the unique rows only;
                    untouched rows keep their bits.
      "sparse":     the JAX package's ADD form in plain torch (no kernel):
                    the accumulator and the update, rounded to p's dtype, are
                    added at the unique rows.

    The one-table case of `split_tables_update`."""
    split_tables_update([(p, acc, ids, g, strategy)], lr=lr, eps=eps)
    return p, acc


def split_tables_update(updates: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor, torch.Tensor,
                                                str]],
                        *, lr: float, eps: float = 1e-10) -> None:
    """`split_table_update` of every split table of a step, in place: one
    `combine_row_grads` over all the tables (one grouped call on a card),
    then each table's strategy on its own sums. updates: (p, acc, ids, g,
    strategy) per table. A table's result does not depend on the tables it
    is grouped with."""
    for *_, strategy in updates:
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown split strategy {strategy!r} "
                             f"(one of {STRATEGIES})")
    combined = combine_row_grads(
        [(ids.to(torch.int32).contiguous(), g.contiguous(), p.shape[0])
         for p, _, ids, g, _ in updates])
    for (p, acc, _, _, strategy), sums in zip(updates, combined):
        _apply_row_sums(p, acc, *sums, lr=lr, eps=eps, strategy=strategy)


def _apply_row_sums(p: torch.Tensor, acc: torch.Tensor, summed: torch.Tensor,
                    uid: torch.Tensor, valid: torch.Tensor,
                    n_valid: torch.Tensor, *, lr: float, eps: float,
                    strategy: str) -> None:
    """One table's strategy (`split_table_update`) on its combined sums."""
    if strategy == "dense":
        gd = torch.zeros_like(p)
        scatter_add_rows(uid, summed, gd, n_valid)
        rowwise_adagrad_update(p, acc, gd, lr=lr, eps=eps)
    elif strategy == "sparse_set":
        sparse_adagrad_apply(p, acc, uid, summed, n_valid, lr=lr, eps=eps)
    else:
        # ADD semantics: padding entries point back IN bounds at the first
        # real row and add zero there
        rows = torch.where(valid, uid, uid[:1]).long()
        d_acc = torch.where(valid[:, None],
                            (summed * summed).mean(dim=1, keepdim=True), 0.0)
        acc.index_add_(0, rows, d_acc)
        upd = -lr * summed * torch.rsqrt(acc[rows] + eps)
        upd = torch.where(valid[:, None], upd, 0.0)
        p.index_add_(0, rows, upd.to(p.dtype))


def sparse_rowwise_adagrad_update(p: torch.Tensor, acc: torch.Tensor,
                                  g_dense: torch.Tensor, sids: torch.Tensor,
                                  *, lr: float, eps: float = 1e-10,
                                  row_offset: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise Adagrad on the rows a batch touches only, in place.

    p [R, W] (f32 or bf16), acc [R, 1] f32, g_dense [R, W] the dense table
    gradient (take_rows' backward), sids [N] SORTED touched stored rows,
    duplicates allowed (`ops/embedding.py:touched_stored_rows`) -> (p, acc).

    The sorted ids are compacted to unique rows at a fixed size with the
    unique count on the device (`unique_sorted`), those rows of g_dense are
    gathered (gather_rows) and widened to f32, and sparse_adagrad_apply
    updates them: acc[r] += mean(g[r]^2), p[r] -= lr * g[r] * rsqrt(acc[r] +
    eps), in f32 with one rounding to p's dtype, as the JAX package's
    gather / compute / sorted scatter-SET does. The kernel's contract is
    unique ids: its accumulator read-modify-write would add a duplicate's
    update twice, where the JAX scatter-SET writes the same bytes twice.
    Every other row keeps its bits.

    row_offset: p, acc and g_dense hold the stored rows [row_offset,
    row_offset + R) of a row-sharded table (parallel/sharded_embedding.py)
    and sids are rows of the whole table: the rows outside the block are
    skipped (kernel 3 skips an id outside [0, R))."""
    if sids.numel() == 0:
        return p, acc
    if row_offset is not None:
        sids = sids - row_offset
    uid, valid, n_valid, _ = unique_sorted(sids, num_rows=p.shape[0])
    if row_offset is not None:
        valid = valid & (uid >= 0) & (uid < p.shape[0])
    rows = torch.where(valid, uid, torch.zeros_like(uid))   # padding: row 0
    gs = gather_rows(g_dense, rows, check_ids=False).float()
    return sparse_adagrad_apply(p, acc, uid, gs, n_valid, lr=lr, eps=eps)


def sparse_rowwise_adagrad_update_plain(p: torch.Tensor, acc: torch.Tensor,
                                        g_dense: torch.Tensor,
                                        sids: torch.Tensor, *, lr: float,
                                        eps: float = 1e-10
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's form in plain torch, duplicates and all: gather the
    touched rows, compute, and write them back (every duplicate writes the
    same values). In place; returns (p, acc)."""
    ids = sids.long()
    g = g_dense[ids].float()
    a = acc[ids] + (g * g).mean(dim=1, keepdim=True)
    p[ids] = (p[ids].float() - lr * g * torch.rsqrt(a + eps)).to(p.dtype)
    acc[ids] = a
    return p, acc


# ------------------------------------------------------------- schedules
def make_lr_schedule(peak_lr: float, type: str = "cosine",
                     warmup_steps: int = 0, decay_steps: int = 100_000,
                     min_ratio: float = 0.0) -> Callable[[int], float]:
    """optax's warmup + decay schedule as a function of the update count
    (from 0): "cosine" (cosine_decay_schedule, alpha min_ratio), "linear"
    (linear_schedule from the peak to peak * min_ratio) or
    "warmup_constant"; with warmup_steps > 0 a linear warmup from 0 comes
    first (join_schedules: the decay reads count - warmup_steps). The first
    update of a warmup therefore runs at LR 0, as in optax."""
    end = peak_lr * min_ratio
    if type == "cosine":
        if not decay_steps > 0:
            raise ValueError(f"the cosine schedule needs decay_steps > 0, "
                             f"got {decay_steps}")

        def decay(count):
            c = min(count, decay_steps)
            return peak_lr * ((1 - min_ratio) * 0.5 *
                              (1 + math.cos(math.pi * c / decay_steps))
                              + min_ratio)
    elif type == "linear":
        decay = _linear(peak_lr, end, decay_steps)
    elif type == "warmup_constant":
        def decay(count):
            return peak_lr
    else:
        raise ValueError(f"lr schedule '{type}' ({'|'.join(SCHEDULES)})")
    if warmup_steps > 0:
        warmup = _linear(0.0, peak_lr, warmup_steps)
        return lambda count: (warmup(count) if count < warmup_steps
                              else decay(count - warmup_steps))
    return decay


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init to end over `steps` updates, then end (a
    constant init when steps <= 0)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


# ------------------------------------------------------ optimizer choice
@dataclass(frozen=True)
class OptimizerSpec:
    """What `make_optimizer` / `make_partitioned_optimizer` return: the
    optimizer the JAX package's optax transformation describes, not yet
    bound to parameters. `Trainer(optimizer=spec)` builds it over the
    model's named parameters (`build`)."""
    name: str
    learning_rate: Union[float, Callable[[int], float]]
    weight_decay: float = 0.0
    clip_norm: float = 0.0
    partitioned: bool = False
    table_learning_rate: Optional[float] = None

    def build(self, named_params: Sequence[Tuple[str, torch.nn.Parameter]]
              ) -> "OptaxOptimizer":
        return OptaxOptimizer(self, named_params)


def make_optimizer(learning_rate: Union[float, Callable[[int], float]] = 1e-3,
                   optimizer: str = "adam", weight_decay: float = 0.0,
                   clip_norm: float = 0.0) -> OptimizerSpec:
    """One optax optimizer over every parameter, tables included
    (elementwise over their dense gradients): adam, adamw, adagrad, sgd or
    lamb, with an injected learning rate (a float, or a schedule of the
    update count) and, with clip_norm > 0, clip_by_global_norm first."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer '{optimizer}'; have "
                         f"{sorted(OPTIMIZERS)}")
    return OptimizerSpec(optimizer, learning_rate, weight_decay, clip_norm)


def make_partitioned_optimizer(learning_rate: Union[float, Callable] = 1e-3,
                               table_learning_rate: Optional[float] = None,
                               dense_optimizer: str = "adam",
                               weight_decay: float = 0.0,
                               clip_norm: float = 0.0) -> OptimizerSpec:
    """adam, adamw or sgd (injected LR) on the dense parameters and row-wise
    Adagrad at a fixed table LR on the stacked tables (rowwise_adagrad_update
    over their dense gradients); clip_norm's global norm spans both."""
    if callable(learning_rate) and table_learning_rate is None:
        raise ValueError("a schedule needs an explicit table_learning_rate "
                         "(tables use a fixed Adagrad LR; pass "
                         "default_table_lr(peak_lr) like the Trainer does)")
    if dense_optimizer not in DENSE_OPTIMIZERS:
        raise ValueError(f"dense_optimizer must be one of {DENSE_OPTIMIZERS}, "
                         f"got '{dense_optimizer}'")
    table_lr = table_learning_rate if table_learning_rate is not None \
        else default_table_lr(learning_rate)
    return OptimizerSpec(dense_optimizer, learning_rate, weight_decay,
                         clip_norm, partitioned=True,
                         table_learning_rate=table_lr)


_ADAM = (0.9, 0.999)
_EPS = {"adam": 1e-8, "adamw": 1e-8, "lamb": 1e-6, "adagrad": 1e-7}


class OptaxOptimizer:
    """An `OptimizerSpec` bound to parameters: optax's update rules in plain
    torch, in place on the parameters from their `.grad` (None counts as a
    zero gradient, as a JAX gradient is). Each state leaf has its
    parameter's dtype and each operation runs in it, as optax's do.

      adam / adamw / lamb: scale_by_adam (b1 0.9, b2 0.999; eps 1e-8, lamb
        1e-6) with bias corrections at the incremented count; adamw and
        lamb add weight_decay * p (every leaf); lamb then scales by the
        trust ratio |p| / |u| (1 where either norm is 0);
      adagrad: accumulator from 0.1, u = g * rsqrt(acc + 1e-7), 0 where acc
        is 0;
      sgd: u = g;
    then p += -lr * u in f32, rounded once to p's dtype. clip_norm > 0
    first scales every gradient by clip_norm / |g| where the global norm
    |g| >= clip_norm (on the device: the host never reads the norm).
    Partitioned: the stacked tables take rowwise_adagrad_update at the
    fixed table LR instead (accumulators [R, 1] f32 from 0.1).

    On a mesh a parameter may hold one block of its leading axis (a table
    under `shard_tables`, an expert leaf under `shard_experts`: marked
    `row_shard` by parallel/sharded_embedding.py:mark_row_shard), and its
    state the same rows. The norms are those of the whole parameter, as
    XLA computes them over the global array: a block's sum of squares is
    all-reduced over its shard axis (one collective per axis for the
    global norm, one per block leaf for lamb's |p| and |u|; a CUDA graph of
    the step captures them with its other collectives), and a replicated
    leaf counts once. Without a marked parameter no collective runs.

    `param_groups[0]["lr"]` is optax's injected learning rate: a schedule
    re-derives it from the update count before each update (so rewriting
    it has no effect then), a fixed rate keeps what is written there.

    An update is two halves, so that a CUDA graph can hold the second:
    `prepare` on the host (the LR at this count, the count + 1 and optax's
    bias corrections 1 - b^count, in f32 as optax computes them, written
    into 0-d tensors on the parameters' device) and `apply` on the device
    (reading those tensors; the moments and accumulators updated in
    place). `step` is both."""

    def __init__(self, spec: OptimizerSpec,
                 named_params: Sequence[Tuple[str, torch.nn.Parameter]]):
        self.spec = spec
        self.params = dict(named_params)
        self.tables = {n for n in self.params
                       if spec.partitioned and _TABLE.search(n)}
        self.count = 0
        lr = spec.learning_rate
        self.param_groups = [{
            "lr": float(lr(0) if callable(lr) else lr),
            "params": [p for n, p in self.params.items()
                       if n not in self.tables]}]
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        dev = next((p.device for p in self.params.values()),
                   torch.device("cpu"))
        # what `apply` reads, written by `prepare`: the LR and the two bias
        # corrections
        self._lr = torch.zeros((), dtype=torch.float32, device=dev)
        self._bc = [torch.ones((), dtype=torch.float32, device=dev)
                    for _ in _ADAM]
        with torch.no_grad():
            for n, p in self.params.items():
                if n in self.tables:
                    self.state[n] = {"acc": init_accumulator(p)}
                elif spec.name in ("adam", "adamw", "lamb"):
                    self.state[n] = {"mu": torch.zeros_like(p),
                                     "nu": torch.zeros_like(p)}
                elif spec.name == "adagrad":
                    self.state[n] = {"sum_of_squares": torch.full_like(
                        p, ADAGRAD_INIT_ACCUMULATOR)}

    def step(self) -> None:
        self.prepare()
        self.apply()

    def prepare(self) -> None:
        """The host half of an update: this count's LR, the count + 1 and
        the bias corrections at the new count, written to the device."""
        spec = self.spec
        if callable(spec.learning_rate):
            self.param_groups[0]["lr"] = float(spec.learning_rate(self.count))
        self.count += 1
        self._lr.fill_(self.param_groups[0]["lr"])
        if spec.name in ("adam", "adamw", "lamb"):
            # optax's 1 - b ** count in f32 (b rounded to f32 first: 1 -
            # 0.999 is 1.3e-5 off 1 - f32(0.999))
            for t, b in zip(self._bc, _ADAM):
                t.fill_(float(1 - torch.tensor(b, dtype=torch.float32)
                              ** self.count))

    @torch.no_grad()
    def apply(self) -> None:
        """The device half of an update, from the parameters' .grad and
        what `prepare` wrote."""
        spec = self.spec
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.params.items()}
        shards = {n: s for n, p in self.params.items()
                  if (s := getattr(p, "row_shard", None)) is not None}
        if spec.clip_norm > 0:
            grads = _clip_by_global_norm(grads, spec.clip_norm, shards)
        neg_lr = -self._lr
        for n, p in self.params.items():
            g, st = grads[n], self.state.get(n)
            if n in self.tables:
                rowwise_adagrad_update(p.detach(), st["acc"], g,
                                       lr=spec.table_learning_rate)
                continue
            u = self._direction(g, p, st, shards.get(n))
            p.copy_((p.float() + u.float() * neg_lr).to(p.dtype))

    def _direction(self, g: torch.Tensor, p: torch.Tensor,
                   st: Optional[Dict[str, torch.Tensor]],
                   shard=None) -> torch.Tensor:
        """The update before the learning rate, in optax's order."""
        name = self.spec.name
        if name == "sgd":
            return g
        # the state is updated in place: a captured update writes where the
        # next one reads
        if name == "adagrad":
            sos = st["sum_of_squares"]
            sos.copy_(g * g + sos)
            inv = torch.where(sos > 0, torch.rsqrt(sos + _EPS[name]),
                              torch.zeros_like(sos))
            return inv * g
        b1, b2 = _ADAM
        mu, nu = st["mu"], st["nu"]
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        # the bias corrections (prepare), cast to the moment's dtype
        bc1, bc2 = self._bc
        u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype))
                                       + _EPS[name])
        if name in ("adamw", "lamb"):
            u = u + self.spec.weight_decay * p
        if name == "lamb":
            if shard is None:
                pn = torch.linalg.vector_norm(p)
                un = torch.linalg.vector_norm(u)
            else:       # the whole leaf's norms, from every block's
                sq = all_reduce_nograd(torch.stack(
                    [p.float().square().sum(), u.float().square().sum()]),
                    shard.mesh.group(shard.axis))
                pn, un = torch.sqrt(sq).to(p.dtype).unbind(0)
            ratio = torch.where((pn == 0) | (un == 0),
                                torch.ones_like(pn), pn / un)
            u = u * ratio
        return u

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count, "lr": self.param_groups[0]["lr"],
                "state": {n: dict(st) for n, st in self.state.items()}}

    def load_state_dict(self, saved: Dict[str, object]) -> None:
        if sorted(saved["state"]) != sorted(self.state):
            raise KeyError(f"optimizer state {sorted(saved['state'])} does "
                           f"not match {sorted(self.state)}")
        self.count = int(saved["count"])
        self.param_groups[0]["lr"] = float(saved["lr"])
        with torch.no_grad():
            for n, st in saved["state"].items():
                for k, v in st.items():
                    self.state[n][k].copy_(v)


def _clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                         shards: Optional[Dict[str, object]] = None
                         ) -> Dict[str, torch.Tensor]:
    """optax.clip_by_global_norm: each leaf's sum of squares in its dtype,
    the global norm in f32; where it is >= max_norm every leaf becomes
    (g / norm) * max_norm, the norm cast to the leaf's dtype. `shards`
    {name: RowShard} names the leaves that hold one block of a row-sharded
    parameter: their sums are all-reduced over each shard axis (one
    collective per axis) before the global sum."""
    sq = {n: torch.sum(g * g).float() for n, g in grads.items()}
    by_axis: Dict[Tuple[int, str], list] = {}
    for n, s in (shards or {}).items():
        by_axis.setdefault((id(s.mesh), s.axis), []).append(n)
    for names in by_axis.values():
        s = shards[names[0]]
        total = all_reduce_nograd(torch.stack([sq[n] for n in names]),
                                  s.mesh.group(s.axis))
        sq.update(zip(names, total.unbind(0)))
    norm = torch.sqrt(torch.stack(list(sq.values())).sum())
    keep = norm < max_norm
    return {n: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for n, g in grads.items()}
