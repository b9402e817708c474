"""Full-state training checkpoints of the port: model weights and buffers,
the dense optimizer's state, the tables' Adagrad accumulators, the step and
the run's dropout seed, in one `torch.save` file.

Layout: `<root>/<step>.pt` per save (the newest `keep` are kept) and
`<root>/best.pt` for the promoted model. The JAX package's orbax
checkpoints are not read; weights cross between the packages through
`interop.py`.

A checkpoint written before the seed travelled in it loads with the state's
own seed (the Trainer's). `save_variables` / `restore_variables` write and
read a weights-only file (a state dict, `torch.save`), and `backup_model`
copies a model directory into a `YYYYMMDD` directory of a backup root,
keeping the newest `keep_days`.
"""
from __future__ import annotations

import os
import re
import shutil
import time
from typing import Any, Dict, Optional

import torch

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def state_to_host(state) -> Dict[str, Any]:
    """A CPU copy of a TrainState's contents (train/trainer.py), for a
    checkpoint file or an in-memory snapshot."""
    return {"model": _to_cpu(state.model.state_dict()),
            "optimizer": _to_cpu(state.optimizer.state_dict()),
            "table_acc": _to_cpu(state.table_acc),
            "step": int(state.step), "seed": int(state.seed)}


def load_state(state, saved: Dict[str, Any]):
    """Copy what state_to_host returned back into `state`, in place, onto
    its devices; the saved seed replaces the state's (a file without one
    keeps it). Returns state."""
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    if sorted(saved["table_acc"]) != sorted(state.table_acc):
        raise KeyError(f"accumulators {sorted(saved['table_acc'])} do not "
                       f"match the state's {sorted(state.table_acc)}")
    with torch.no_grad():
        for k, v in saved["table_acc"].items():
            state.table_acc[k].copy_(v)
    state.step = int(saved["step"])
    state.seed = int(saved.get("seed", state.seed))
    return state


def _write(path: str, obj: Any) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)      # a reader never sees half a file
    return path


def save_checkpoint(path: str, state) -> str:
    """Write one checkpoint file. Returns its path."""
    return _write(path, state_to_host(state))


def save_step(root: str, state, step: int, keep: int = 5) -> str:
    """Save under `<root>/<step>.pt`, keeping the newest `keep` saves."""
    path = save_checkpoint(os.path.join(root, f"{step}.pt"), state)
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
