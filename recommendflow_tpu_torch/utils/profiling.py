"""Tracing and profiling (the counterpart of
`recommendflow_tpu/utils/profiling.py`):

  * `trace(logdir)`: a context manager around torch.profiler (CPU and, where
    a card is visible, CUDA activities) that writes one Chrome trace,
    `<host>_<pid>.<ms>.pt.trace.json`, under logdir (TensorBoard's profiler
    plugin and Perfetto read it; the JAX package writes jax.profiler's
    xplane instead); `start_trace` / `stop_trace` are its two halves, which
    `Trainer.fit`'s profile window calls;
  * `span(name)`: a named range of the program's host work (`fit.step`,
    `search.copy_in`, ...), recorded while a torch profiler runs and only
    then: its name, start and end (`time.perf_counter_ns`), parent span
    (the top-level one is the step or request it belongs to), thread and
    the counts `add` gives it. Recorded spans are kept in a bounded list
    that `spans()` returns, and each is also a profiler range of the same
    name, so a trace of the host's operators (fit's profile window) shows
    it. With no profiler running a span costs one flag test and returns a
    shared no-op;
  * `mark_phase(device, phase)`: the start of a phase of the train step's
    device work, as a one-thread empty kernel named `rf_span_<phase>`
    (ops/cuda/span_marker.py), so a device trace shows each phase replay by
    replay on the card's own timeline;
  * `mark_region(device, region)`: the same for a stretch inside a phase
    (the low-rank cross's forward and backward), one empty kernel named
    `rf_region_<region>` at its start and another at its end, a family of
    its own: a reader that pairs the phase markers sees none of these;
  * `memory_percent()`: the host's memory in use, from /proc/meminfo.

The profiler does not list every launch of the port's own kernels: they come
from a ctypes library with its own CUDA runtime (tools/profile_slice.py).
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# spans kept while recording; the oldest go first
MAX_SPANS = 1 << 16


class Span(NamedTuple):
    """One recorded span: times in the host's `perf_counter_ns`; `parent`
    is the enclosing span's id on the same thread (None at the top);
    `mark_ns` the time `mark()` took inside it (graph.replay: just after
    the launch returned), else None."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    thread: int
    counts: Dict[str, Any]
    mark_ns: Optional[int] = None


_SPANS: "deque[Span]" = deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_OPEN = threading.local()
# the profiler's range around a span: the fast C++ guard where this torch
# has it (a fraction of a microsecond; record_function's Python operator
# calls take several, and a profiler of the device alone keeps neither)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


def recording() -> bool:
    """Whether spans are recorded now: while a torch profiler runs, in any
    thread of the process (the profiler's own flag, which it sets at its
    start and clears at its stop)."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "start", "at", "_range")

    def __init__(self, name: str):
        self.name = name
        self.counts: Dict[str, Any] = {}
        self.at: Optional[int] = None

    def add(self, **counts: Any) -> None:
        """Counts of the span's work, known inside it (a stack's steps)."""
        self.counts.update(counts)

    def mark(self) -> None:
        """Take the host's time now, for a reader to pair with one event of
        the device trace (the launch just made)."""
        self.at = time.perf_counter_ns()

    def __enter__(self) -> "_Span":
        stack = _OPEN.__dict__.setdefault("stack", [])
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.start = time.perf_counter_ns()
        self._range = _RANGE(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        end = time.perf_counter_ns()
        _OPEN.stack.pop()
        _SPANS.append(Span(self.name, self.start, end, self.id, self.parent,
                           threading.get_ident(), self.counts, self.at))
        return False


class _NoSpan:
    """The span of a site while nothing records: does nothing."""
    __slots__ = ()

    def add(self, **counts: Any) -> None:
        pass

    def mark(self) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager over a named range of host work (module
    docstring), recorded only while a torch profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


_END = object()


def spanned(items: Iterable[Any], name: str) -> Iterator[Any]:
    """`items`, each drawn under a span `name` (the wait on a prefetch
    queue, say). Closing the returned generator closes `items`' iterator
    with it."""
    it = iter(items)
    try:
        while True:
            with span(name):
                item = next(it, _END)
            if item is _END:
                return
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def spans() -> List[Span]:
    """The recorded spans (at most MAX_SPANS, the newest), by start."""
    return sorted(list(_SPANS), key=lambda s: s.start_ns)


def mark_phase(device: torch.device, phase: str) -> None:
    """Mark the start of `phase` of the train step's device work on the
    current stream: on a card, into a CUDA graph whenever the stream is
    capturing (a graph is captured once, in set-up, and its replays carry
    the markers whether or not anything records), and launched eagerly only
    while spans are recorded; nothing on the CPU. The phases are
    ops/cuda/span_marker.py's PHASES."""
    if device.type != "cuda":
        return
    if recording() or torch.cuda.is_current_stream_capturing():
        from recommendflow_tpu_torch.ops.cuda.span_marker import \
            launch_marker
        launch_marker(phase, device)


def mark_region(device: torch.device, region: str) -> None:
    """Mark `region`'s start (or, for a name ending in `_end`, its end) on
    the current stream, when and where `mark_phase` would mark a phase.
    The regions are ops/cuda/span_marker.py's REGIONS."""
    if device.type != "cuda":
        return
    if recording() or torch.cuda.is_current_stream_capturing():
        from recommendflow_tpu_torch.ops.cuda.span_marker import \
            launch_region
        launch_region(region, device)


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
