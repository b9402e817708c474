"""Full-state training checkpoints of the port: model weights and buffers,
the dense optimizer's state, the tables' Adagrad accumulators and the step,
in one `torch.save` file.

Layout: `<root>/<step>.pt` per save (the newest `keep` are kept) and
`<root>/best.pt` for the promoted model. The JAX package's orbax
checkpoints are not read; weights cross between the packages through
`interop.py`.
"""
from __future__ import annotations

import os
import re
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
            "step": int(state.step)}


def load_state(state, saved: Dict[str, Any]):
    """Copy what state_to_host returned back into `state`, in place, onto
    its devices. Returns state."""
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    if sorted(saved["table_acc"]) != sorted(state.table_acc):
        raise KeyError(f"accumulators {sorted(saved['table_acc'])} do not "
                       f"match the state's {sorted(state.table_acc)}")
    with torch.no_grad():
        for k, v in saved["table_acc"].items():
            state.table_acc[k].copy_(v)
    state.step = int(saved["step"])
    return state


def save_checkpoint(path: str, state) -> str:
    """Write one checkpoint file. Returns its path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state_to_host(state), tmp)
    os.replace(tmp, path)      # a reader never sees half a file
    return path


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
