"""Full-state training checkpoints of the port: model weights and buffers,
the dense optimizer's state, the tables' Adagrad accumulators, the step and
the run's dropout seed, in one `torch.save` file.

Layout: `<root>/<step>.pt` per save (the newest `keep` are kept) and
`<root>/best.pt` for the promoted model. The JAX package's orbax
checkpoints are not read; weights cross between the packages through
`interop.py`.

A checkpoint written before the seed travelled in it loads with the state's
own seed (the Trainer's). A restore writes into the state's tensors in place
(CUDA graphs of the step read and write those very tensors,
train/graphs.py), and the dense Adam's state is put where this state's Adam
keeps it whichever device wrote it: its step on the card for the
`capturable` Adam of a card, on the host for the CPU's, and its learning
rate in the state's own form (a device tensor on a card, a float on the
CPU), from the checkpoint's host copy (`HOST_LR`) where it has one. So a
checkpoint written by either path, or by the port before its card Adam was
capturable (step on the host, LR a float), loads on either. `save_variables` / `restore_variables` write and
read a weights-only file (a state dict, `torch.save`), and `backup_model`
copies a model directory into a `YYYYMMDD` directory of a backup root,
keeping the newest `keep_days`.

Under a row-sharded mesh (parallel/sharded_embedding.py) a checkpoint
always holds whole tables and accumulators: each rank's block is gathered
before the save (a collective every rank calls; in a run of several
processes rank 0 writes and the others wait at a barrier), and a restore
cuts each whole table to the block the restoring rank holds. The same
holds for the optimizer's per-row state of a block (torch's Adam moments,
an `OptaxOptimizer`'s moments and accumulators). So a
checkpoint written at one world size, sharded or not, restores at any
other.
"""
from __future__ import annotations

import os
import re
import shutil
import time
from typing import Any, Dict, Optional

import torch

from recommendflow_tpu_torch.parallel.distributed import host_id, num_hosts
from recommendflow_tpu_torch.parallel.sharded_embedding import (
    full_rows, gather_like, own_rows)
from recommendflow_tpu_torch.train.optimizers import OptaxOptimizer

_STEP_FILE = re.compile(r"^(\d+)\.pt$")
# the key of a param group's LR as the host last wrote it, beside an LR that
# lives in a device tensor (the capturable Adam on a card)
HOST_LR = "host_lr"


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


_TABLE = re.compile(r"table_dim(\d+)$")


def _acc_tables(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """'dim{d}' (an accumulator's key) -> its table parameter."""
    return {f"dim{m.group(1)}": p for name, p in model.named_parameters()
            if (m := _TABLE.search(name))}


def state_to_host(state) -> Dict[str, Any]:
    """A CPU copy of a TrainState's contents (train/trainer.py), for a
    checkpoint file or an in-memory snapshot; row blocks are gathered into
    whole tables and accumulators (a collective)."""
    params = dict(state.model.named_parameters())
    model = {k: full_rows(params[k]) if k in params else v
             for k, v in state.model.state_dict().items()}
    tables = _acc_tables(state.model)
    accs = {k: gather_like(tables.get(k), v)
            for k, v in state.table_acc.items()}
    return {"model": _to_cpu(model),
            "optimizer": _to_cpu(_optimizer_rows(
                state.optimizer, state.optimizer.state_dict(), gather_like)),
            "table_acc": _to_cpu(accs),
            "step": int(state.step), "seed": int(state.seed)}


def _optimizer_rows(opt, sd: Dict[str, Any], fn) -> Dict[str, Any]:
    """An optimizer's state dict `sd` with `fn(param, tensor)` applied to
    each per-row tensor of its parameters (an Adam moment of an expert
    block, a table block's accumulator): gather_like to save whole,
    own_rows to restore a block. A torch optimizer keys its state by
    parameter index, an `OptaxOptimizer` by parameter name."""
    if isinstance(opt, torch.optim.Optimizer):
        params = dict(enumerate(p for g in opt.param_groups
                                for p in g["params"]))
    elif isinstance(opt, OptaxOptimizer):
        params = opt.params
    else:
        return sd
    state = {i: {k: fn(params[i], v) if isinstance(v, torch.Tensor)
                 and v.dim() >= 1 else v for k, v in st.items()}
             for i, st in sd["state"].items()}
    return {**sd, "state": state}


def load_state(state, saved: Dict[str, Any]):
    """Copy what state_to_host returned back into `state`, in place, onto
    its devices; a whole table (and its accumulator) is cut to the block a
    row-sharded state holds. The saved seed replaces the state's (a file
    without one keeps it). Returns state."""
    params = dict(state.model.named_parameters())
    state.model.load_state_dict({k: own_rows(params[k], v) if k in params
                                 else v for k, v in saved["model"].items()})
    opt_sd = _optimizer_rows(state.optimizer, saved["optimizer"], own_rows)
    if isinstance(state.optimizer, torch.optim.Optimizer):
        load_torch_optimizer(state.optimizer, opt_sd)
    else:
        state.optimizer.load_state_dict(opt_sd)
    if sorted(saved["table_acc"]) != sorted(state.table_acc):
        raise KeyError(f"accumulators {sorted(saved['table_acc'])} do not "
                       f"match the state's {sorted(state.table_acc)}")
    tables = _acc_tables(state.model)
    with torch.no_grad():
        for k, v in saved["table_acc"].items():
            state.table_acc[k].copy_(own_rows(tables[k], v)
                                     if k in tables else v)
    state.step = int(saved["step"])
    state.seed = int(saved.get("seed", state.seed))
    return state


def assign_param_state(opt: torch.optim.Optimizer, group: Dict[str, Any],
                       param: torch.Tensor, values: Dict[str, Any]) -> None:
    """Set an optimizer's state of `param` (in `group`) to `values`, in
    place where it has a tensor of the same shape and dtype already; the
    step on the parameter's device as f32 for a capturable group, on the
    host otherwise."""
    have = opt.state.get(param, {})
    out = dict(have)
    for k, v in values.items():
        if not isinstance(v, torch.Tensor):
            out[k] = v
            continue
        if k == "step":
            v = v.to(torch.float32)
            dev = param.device if group.get("capturable") else \
                torch.device("cpu")
        else:
            dev = param.device
        keep = have.get(k)
        if isinstance(keep, torch.Tensor) and keep.shape == v.shape \
                and keep.dtype == v.dtype and keep.device == dev:
            with torch.no_grad():
                keep.copy_(v)
            out[k] = keep
        else:
            out[k] = v.to(dev, copy=True)
    opt.state[param] = out


def load_torch_optimizer(opt: torch.optim.Optimizer,
                         saved: Dict[str, Any]) -> None:
    """`opt.load_state_dict(saved)` into the optimizer's own tensors, each
    group keeping its own `capturable` flag and LR form (module
    docstring)."""
    have = {p: dict(st) for p, st in opt.state.items()}
    mine = [{k: v for k, v in g.items() if k != "params"}
            for g in opt.param_groups]
    opt.load_state_dict(saved)
    loaded = {p: opt.state.pop(p) for p in list(opt.state)}
    opt.state.update(have)
    for p in [p for p in have if p not in loaded]:
        del opt.state[p]      # no state saved for it: as load_state_dict
    for group, own in zip(opt.param_groups, mine):
        group["capturable"] = own.get("capturable", False)
        lr = float(group.get(HOST_LR, group["lr"]))
        if isinstance(own["lr"], torch.Tensor):
            own["lr"].fill_(lr)
            group["lr"], group[HOST_LR] = own["lr"], lr
        else:
            group["lr"] = lr
            group.pop(HOST_LR, None)
        for p in group["params"]:
            if p in loaded:
                assign_param_state(opt, group, p, loaded[p])


def _write(path: str, obj: Any) -> str:
    """Write `obj` to `path` atomically; in a run of several processes rank
    0 writes and every rank waits at a barrier until it has."""
    if host_id() == 0:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(obj, tmp)
        os.replace(tmp, path)      # a reader never sees half a file
    if num_hosts() > 1:
        torch.distributed.barrier()
    return path


def save_checkpoint(path: str, state) -> str:
    """Write one checkpoint file. Returns its path."""
    return _write(path, state_to_host(state))


def save_step(root: str, state, step: int, keep: int = 5) -> str:
    """Save under `<root>/<step>.pt`, keeping the newest `keep` saves."""
    path = save_checkpoint(os.path.join(root, f"{step}.pt"), state)
    if host_id() == 0:
        for old in sorted(_steps(root))[:-keep]:
            os.remove(os.path.join(root, f"{old}.pt"))
    return path


def _steps(root: str):
    if not os.path.isdir(root):
        return []
    return [int(m.group(1)) for f in os.listdir(root)
            if (m := _STEP_FILE.match(f))]


def latest_step(root: str) -> Optional[int]:
    steps = _steps(root)
    return max(steps) if steps else None


def checkpoint_path(path: str, step: Optional[int] = None) -> str:
    """A checkpoint file: `path` itself, or `<path>/<step>.pt` (the newest
    step when none is given) for a directory."""
    if os.path.isfile(path):
        return path
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    return os.path.join(path, f"{step}.pt")


def read_checkpoint(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    return torch.load(checkpoint_path(path, step), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, state, step: Optional[int] = None):
    """Load a checkpoint file (or a root's newest step) into `state`."""
    return load_state(state, read_checkpoint(path, step))


def save_variables(path: str, model: torch.nn.Module) -> str:
    """Weights only (parity surface with Keras save_weights): the model's
    state dict, parameters and buffers, in one file. Returns its path."""
    return _write(path, _to_cpu(model.state_dict()))


def restore_variables(path: str, model: Optional[torch.nn.Module] = None):
    """The state dict that save_variables wrote, loaded into `model` (onto
    its device; returns the model) when one is given."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if model is None:
        return saved
    model.load_state_dict(saved)
    return model


def backup_model(src_root: str, backup_root: str, keep_days: int = 7) -> str:
    """Copy a model directory to `<backup_root>/<YYYYMMDD>` (today's copy
    replaced), keeping the newest `keep_days` day directories (parity:
    backend/utils/model_utils.py:7-24 backup_model). Returns the copy."""
    dst = os.path.join(backup_root, time.strftime("%Y%m%d"))
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src_root, dst)
    days = sorted(d for d in os.listdir(backup_root)
                  if d.isdigit() and len(d) == 8)
    for old in days[:-keep_days]:
        shutil.rmtree(os.path.join(backup_root, old), ignore_errors=True)
    return dst
