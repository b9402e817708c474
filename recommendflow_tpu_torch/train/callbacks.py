"""Epoch-level callbacks: early stopping, LR plateau, checkpointing, eval
(the counterpart of `recommendflow_tpu/train/callbacks.py`).

A callback sees (trainer, state, epoch, logs) and may set trainer.control
(the stop flag, the LR scale, a state to restore) or write checkpoints.
The retrieval evaluator lives in retrieval/eval.py and is wired in through
EvalCallback.
"""
from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, List

from recommendflow_tpu_torch.train.checkpoint import (save_checkpoint,
                                                      save_step,
                                                      state_to_host)
from recommendflow_tpu_torch.utils.logger import get_logger

log = get_logger("recflow.callbacks")


class Callback:
    def on_train_begin(self, trainer):  # noqa: D401
        pass

    def on_epoch_end(self, trainer, state, epoch: int, logs: Dict[str, float]):
        pass

    def on_train_end(self, trainer, state, logs: Dict[str, float]):
        pass


def _improved(value: float, best: float, mode: str, min_delta: float) -> bool:
    if mode == "max":
        return value > best + min_delta
    return value < best - min_delta


def _auto_mode(monitor: str, mode: str) -> str:
    """Retrieval/quality metrics (auc/hit/mrr/ndcg/recall) maximize; losses
    minimize."""
    if mode != "auto":
        return mode
    return ("max" if any(k in monitor for k in
                         ("auc", "hit", "mrr", "ndcg", "recall"))
            else "min")


class _Monitor(Callback):
    """Best-value tracking shared by the monitoring callbacks."""

    def __init__(self, monitor: str, mode: str, min_delta: float):
        self.monitor = monitor
        self.mode = _auto_mode(monitor, mode)
        self.min_delta = min_delta
        self.on_train_begin(None)

    def on_train_begin(self, trainer):
        # a reused callback must not carry a previous fit()'s state
        self.best = -math.inf if self.mode == "max" else math.inf
        self.wait = 0


class EarlyStopping(_Monitor):
    def __init__(self, monitor: str = "val_loss", patience: int = 3,
                 mode: str = "auto", min_delta: float = 0.0,
                 restore_best: bool = True):
        self.patience = patience
        self.restore_best = restore_best
        super().__init__(monitor, mode, min_delta)

    def on_train_begin(self, trainer):
        super().on_train_begin(trainer)
        self.best_state = None

    def on_epoch_end(self, trainer, state, epoch, logs):
        value = logs.get(self.monitor)
        if value is None:
            return
        if _improved(value, self.best, self.mode, self.min_delta):
            self.best = value
            self.wait = 0
            if self.restore_best:
                # a host copy: the live state is updated in place
                self.best_state = state_to_host(state)
        else:
            self.wait += 1
            if self.wait >= self.patience:
                log.info("early stopping at epoch %d (%s=%.6f best=%.6f)",
                         epoch, self.monitor, value, self.best)
                trainer.control["stop"] = True
                if self.restore_best and self.best_state is not None:
                    trainer.control["restore_state"] = self.best_state


class ReduceLROnPlateau(_Monitor):
    def __init__(self, monitor: str = "val_loss", factor: float = 0.5,
                 patience: int = 2, min_lr_scale: float = 1e-3,
                 mode: str = "auto", min_delta: float = 0.0):
        self.factor = factor
        self.patience = patience
        self.min_lr_scale = min_lr_scale
        super().__init__(monitor, mode, min_delta)

    def on_epoch_end(self, trainer, state, epoch, logs):
        value = logs.get(self.monitor)
        if value is None:
            return
        if _improved(value, self.best, self.mode, self.min_delta):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                new_scale = max(trainer.control.get("lr_scale", 1.0) * self.factor,
                                self.min_lr_scale)
                log.info("plateau on %s: lr_scale -> %.6f", self.monitor, new_scale)
                trainer.control["lr_scale"] = new_scale
                self.wait = 0


class ModelCheckpoint(_Monitor):
    """Per-epoch full-state checkpoints `<root>/<epoch>.pt` and the best one
    by `monitor` at `<root>/best.pt` (train/checkpoint.py)."""

    def __init__(self, root: str, keep: int = 5, save_best: bool = True,
                 monitor: str = "val_loss", mode: str = "auto"):
        self.root = root
        self.keep = keep
        self.save_best = save_best
        super().__init__(monitor, mode, 0.0)

    def on_epoch_end(self, trainer, state, epoch, logs):
        save_step(self.root, state, step=epoch, keep=self.keep)
        value = logs.get(self.monitor)
        if self.save_best and value is not None \
                and _improved(value, self.best, self.mode, 0.0):
            self.best = value
            save_checkpoint(os.path.join(self.root, "best.pt"), state)
            log.info("epoch %d: new best %s=%.6f -> %s/best.pt",
                     epoch, self.monitor, value, self.root)


class EvalCallback(Callback):
    """Runs a function (e.g. the retrieval recall evaluation) and merges its
    metrics into the epoch's logs."""

    def __init__(self, eval_fn: Callable[[Any, Any], Dict[str, float]]):
        self.eval_fn = eval_fn

    def on_epoch_end(self, trainer, state, epoch, logs):
        logs.update(self.eval_fn(trainer, state))


class History(Callback):
    def __init__(self):
        self.epochs: List[Dict[str, float]] = []

    def on_epoch_end(self, trainer, state, epoch, logs):
        self.epochs.append(dict(logs))
