"""The benchmark's reading of a torch.profiler trace.

The interval arithmetic is a frozen copy of the repository's
`utils/trace.py` (`_union_ms`, the device categories of
`report_from_events`): the device's busy time is the union of its events'
intervals, overlaps counted once and gaps not at all. On top of it: the
busy time inside a stretch, the time of the kernels whose names hold a
pattern, the device operations that took most time, and the longest gaps
in which the device idled, named by what the host was doing.

On a mesh the trace also holds the exchange between ranks: NCCL's kernels,
which spin on the card while they wait for the other ranks, so their time
grows with the other ranks' delays (and with the profiler's). The busy
time that the readers read (`busy_us`) is the card's own work, the
exchange left out; `occupied_us` counts every operation, the exchange
too, and `exchange_only_us` the time in which the exchange alone ran. A
trace of one card holds no NCCL kernel, and there the three agree.

On a card the benchmark records the device's activity only (kernels,
copies, and the CUDA runtime and driver calls that launched them), not the
host's operators: recording every operator would slow the host path that a
step's or a request's time measures. The traced stretch is the extent of
its events.
"""
from __future__ import annotations

import json
import os
import tempfile
from bisect import bisect_right
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function",
                   "cuda_runtime", "cuda_driver")

Interval = Tuple[float, float]
# the exchange between ranks: NCCL's kernels (ncclDevKernel_*, ncclKernel_*)
EXCHANGE_PREFIX = "nccl"


def is_exchange(name: str) -> bool:
    return name.startswith(EXCHANGE_PREFIX)


def merged(spans: Iterable[Interval]) -> List[Interval]:
    """The union of [start, end) intervals as disjoint sorted intervals:
    overlaps counted once and gaps not at all (the arithmetic of
    `utils/trace.py:_union_ms`, frozen here)."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_us(spans: Iterable[Interval]) -> float:
    """Length of the union of intervals, in the trace's microseconds."""
    return sum(e - s for s, e in merged(spans))


def clip(spans: Iterable[Interval], t0: float, t1: float) -> List[Interval]:
    return [(max(s, t0), min(e, t1)) for s, e in spans if e > t0 and s < t1]


@dataclass
class DeviceEvent:
    name: str
    start: float        # us
    end: float


@dataclass
class HostEvent:
    name: str
    cat: str
    start: float
    end: float


class TraceSummary:
    """A Chrome trace's device events and host events."""

    def __init__(self, events: Sequence[Mapping[str, Any]]):
        complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = sorted((DeviceEvent(str(e.get("name", "?")), float(e["ts"]),
                                          float(e["ts"]) + float(e["dur"]))
                              for e in complete if e.get("cat") in DEVICE_CATEGORIES),
                             key=lambda d: d.start)
        self.host = [HostEvent(str(e.get("name", "?")), str(e.get("cat")),
                               float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in complete if e.get("cat") in HOST_CATEGORIES]
        self.work = [d for d in self.device if not is_exchange(d.name)]
        self._busy = merged((d.start, d.end) for d in self.work)
        self._busy_starts = [s for s, _ in self._busy]
        self._occupied = merged((d.start, d.end) for d in self.device)
        self.exchange = len(self.work) < len(self.device)

    def window(self) -> Optional[Interval]:
        """The traced stretch: from the first event to the end of the last,
        device and host; None where the trace holds no event."""
        spans = [(d.start, d.end) for d in self.device] + \
            [(h.start, h.end) for h in self.host]
        if not spans:
            return None
        return min(s for s, _ in spans), max(e for _, e in spans)

    def busy_us(self, t0: float, t1: float) -> float:
        """Device busy time inside [t0, t1): the card's own work, the
        exchange between ranks left out (module docstring)."""
        i = max(bisect_right(self._busy_starts, t0) - 1, 0)
        total = 0.0
        for s, e in self._busy[i:]:
            if s >= t1:
                break
            total += max(0.0, min(e, t1) - max(s, t0))
        return total

    def occupied_us(self, t0: float, t1: float) -> float:
        """Time inside [t0, t1) in which any operation ran on the device,
        the exchange's too."""
        return union_us(clip(self._occupied, t0, t1))

    def exchange_only_us(self, t0: float, t1: float) -> float:
        """Time inside [t0, t1) in which the exchange ran and no work."""
        return self.occupied_us(t0, t1) - self.busy_us(t0, t1)

    def kernel_us(self, patterns: Sequence[str], t0: float, t1: float) -> float:
        """Summed time of the device events inside [t0, t1) whose names hold
        one of `patterns` (0 when none ran)."""
        return sum(max(0.0, min(d.end, t1) - max(d.start, t0))
                   for d in self.device
                   if d.end > t0 and d.start < t1
                   and any(p in d.name for p in patterns))

    def top_ops(self, t0: float, t1: float, n: int = 10) -> List[List[Any]]:
        """[[name, seconds], ...]: the device operations that took most time
        inside the window, by name."""
        tot: Dict[str, float] = {}
        for d in self.device:
            if d.end > t0 and d.start < t1:
                tot[d.name] = tot.get(d.name, 0.0) + \
                    min(d.end, t1) - max(d.start, t0)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], us / 1e6] for name, us in best]

    def idle_gaps(self, t0: float, t1: float, n: int = 10) -> List[List[Any]]:
        """[[what the host was doing, seconds], ...]: the longest gaps in
        the window in which no device event ran (the exchange's neither),
        each named by the
        innermost host event (a runtime or driver call on a card) under way
        at the gap's middle, or "host outside CUDA calls" where none was."""
        busy = clip(self._occupied, t0, t1)
        edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            under = [h for h in self.host if h.start <= mid < h.end]
            what = max(under, key=lambda h: h.start).name if under \
                else "host outside CUDA calls"
            out.append([what[:160], (e - s) / 1e6])
        return out


def read_profile(prof) -> TraceSummary:
    """A finished torch.profiler.profile, through its Chrome trace written
    to (and removed from) the temporary directory."""
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return TraceSummary(events)
