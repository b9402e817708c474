"""Tracing and profiling (the counterpart of
`recommendflow_tpu/utils/profiling.py`):

  * `StepTimer`: an EMA of the step time and examples per second;
  * `trace(logdir)`: a context manager around torch.profiler (CPU and, where
    a card is visible, CUDA activities) that writes one Chrome trace,
    `<host>_<pid>.<ms>.pt.trace.json`, under logdir (TensorBoard's profiler
    plugin and Perfetto read it; the JAX package writes jax.profiler's
    xplane instead); `start_trace` / `stop_trace` are its two halves, which
    `Trainer.fit`'s profile window calls;
  * `timed(name)`: a scope timer collecting into a registry, printed as a
    table by `scope_report`;
  * `memory_percent()`: the host's memory in use, from /proc/meminfo.

The profiler does not list every launch of the port's own kernels: they come
from a ctypes library with its own CUDA runtime (tools/profile_slice.py).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

_SCOPES: Dict[str, list] = defaultdict(list)


class StepTimer:
    def __init__(self, ema: float = 0.98):
        self.ema = ema
        self.avg_ms: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = (now - self._last) * 1000
            self.avg_ms = dt if self.avg_ms is None else \
                self.ema * self.avg_ms + (1 - self.ema) * dt
        self._last = now
        return self.avg_ms

    def examples_per_sec(self, batch_size: int) -> Optional[float]:
        if not self.avg_ms:
            return None
        return batch_size / (self.avg_ms / 1000)


def start_trace(logdir: str) -> torch.profiler.profile:
    """Start a torch.profiler trace (CPU activity, and CUDA where a card is
    visible) that `stop_trace` writes under `logdir`."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile) -> None:
    """Wait for the card, stop the trace and write it."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """A trace of the enclosed work under `logdir`. Wrap a handful of
    steady-state steps, not the whole run."""
    prof = start_trace(logdir)
    try:
        yield prof
    finally:
        stop_trace(prof)


@contextlib.contextmanager
def timed(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _SCOPES[name].append(time.perf_counter() - t0)


def scope_report(reset: bool = True) -> str:
    from recommendflow_tpu_torch.utils.tables import format_table
    rows = []
    for name, times in sorted(_SCOPES.items()):
        total = sum(times)
        rows.append([name, len(times), f"{total*1000:.1f}",
                     f"{total/len(times)*1000:.2f}"])
    if reset:
        _SCOPES.clear()
    return format_table(rows, headers=["scope", "calls", "total_ms", "avg_ms"],
                        title="Timing scopes")


def memory_percent() -> float:
    """Host memory usage fraction (parity: utils/util.py:328-329
    men_percentage gauge), from /proc/meminfo — no psutil dependency."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            parts = line.split()
            info[parts[0].rstrip(":")] = int(parts[1])
    total = info.get("MemTotal", 1)
    avail = info.get("MemAvailable", info.get("MemFree", 0))
    return 100.0 * (1.0 - avail / total)
