"""The program's own spans, read beside the benchmark's device trace.

The program (`recommendflow_tpu_torch/utils/profiling.py`) records named
spans of its host work while a torch profiler runs, on the host's
`perf_counter_ns` clock, each with its parent span, thread and counts, and
marks the phases of its graphed train step on the card with empty kernels
named `rf_span_<phase>`. Here:

  * `program_spans()`: the recorded spans, or None where the program has no
    recorder (a checkout from before it);
  * `clock_offset_us`: the offset that puts the host's clock on the
    trace's, from anchors the trace already holds: each span's start
    against its own range in the trace where the trace holds the host's
    operators (on the CPU), else each `graph.replay` span's start (the
    host's time just before the replay) against the start of the
    `cudaGraphLaunch` runtime call it made. The i-th anchor pairs with the
    i-th event, and only where their numbers are equal: a trace with
    another number of launches (a graph launched outside the program's
    StepGraph, say) has no offset. The offset is the least difference: no
    event starts before its span did, so the least is the one with the
    least host delay in it;
  * `offset_spread_us`: how far that offset can lie from the true one. The
    same pairs at their ends bound it from the other side: a span ends,
    and a replay's mark is taken, only after its event ended;
  * `phase_busy_us`: the device's busy time between consecutive
    `rf_span_` markers, by phase (a phase from its marker's start to the
    next marker's start), summed over the steps whose six markers the trace
    holds in order: a profiler can drop an event (the first of its
    session, say), and a step short of a marker is left out whole;
  * `SpanView`: the spans of the launching thread on the trace's clock,
    each span's self time (its interval less its children's) as pieces,
    the units they count, and the device's idle time under them.

Idle time is read in the traced stretch, which the profiler slows on the
host: its idle is longer than the untraced window's. So a reader reports
the share of the traced idle under some spans, or that share of the
untraced idle a unit (`untraced_idle_ms`), never traced idle time itself.
Busy and idle are the card's own work's (`TraceSummary.busy_us`): on a
mesh the time in which the exchange between ranks alone ran counts as
idle.

Every reader of these returns None where the program recorded no spans,
where no anchor puts them on the trace's clock, or where they count other
than the traced units. `view` logs the offset, its spread, the median
distance of an anchor from its event once aligned, and the units, on
stderr; `clock_readings` puts the spread, that distance and the wholly
marked steps in the traced result's `device`.
"""
from __future__ import annotations

import importlib
import re
import sys
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench.harness.trace import Interval, clip, merged

MARKER = re.compile(r"rf_span_([a-z_]+)")
# the train step's phase markers in their order (the program's
# ops/cuda/span_marker.py PHASES)
PHASES = ("gather", "forward", "backward", "optimizer", "table_update", "end")
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
RANGE_CATEGORIES = ("user_annotation", "cpu_op")
PROFILING = "recommendflow_tpu_torch.utils.profiling"


def program_spans() -> Optional[list]:
    """The program's recorded spans (`profiling.spans()`), or None where the
    program has no span recorder."""
    try:
        mod = importlib.import_module(PROFILING)
    except ImportError:
        return None
    spans = getattr(mod, "spans", None)
    return list(spans()) if callable(spans) else None


def _pairs(host_ns: Sequence[int], trace_us: Sequence[float]
           ) -> List[Tuple[float, float]]:
    """(host µs, trace µs) of the host times against the trace times, in
    order; none where their numbers differ."""
    if len(host_ns) != len(trace_us):
        return []
    return [(h / 1e3, t) for h, t in zip(sorted(host_ns), sorted(trace_us))]


def anchors(spans, trace, end: bool = True) -> List[Tuple[float, float]]:
    """(host µs, trace µs) pairs, each a host time just after its event's
    end: the spans' ends against their own ranges' ends by name where the
    trace holds them, else graph.replay's marks (their ends where they have
    none) against cudaGraphLaunch's ends; empty where no name's numbers
    agree. With `end` false, the same pairs at their starts: each host
    time just before its event's start."""
    by_name: Dict[str, List[int]] = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s.end_ns if end else s.start_ns)
    ranges: Dict[str, List[float]] = {}
    for h in trace.host:
        if h.cat in RANGE_CATEGORIES and h.name in by_name:
            ranges.setdefault(h.name, []).append(h.end if end else h.start)
    if ranges:
        return [p for name, ts in ranges.items()
                for p in _pairs(by_name[name], ts)]
    launches = [h.end if end else h.start for h in trace.host
                if h.cat in RUNTIME_CATEGORIES and "cudaGraphLaunch" in h.name]
    marks = [s.start_ns if not end else s.mark_ns if s.mark_ns is not None
             else s.end_ns for s in spans if s.name == "graph.replay"]
    return _pairs(marks, launches)


def clock_offset_us(spans, trace) -> Optional[float]:
    """trace µs = host ns / 1000 + offset (module docstring); None without
    an anchor."""
    pairs = anchors(spans, trace, end=False)
    if not pairs:
        return None
    return min(t - h for h, t in pairs)


def anchor_gap_us(spans, trace) -> Optional[float]:
    """The median distance, after alignment, from an anchor to its event's
    start: the host's usual delay before the event, beyond the least."""
    pairs = anchors(spans, trace, end=False)
    if not pairs:
        return None
    off = min(t - h for h, t in pairs)
    gaps = sorted(t - h - off for h, t in pairs)
    return gaps[len(gaps) // 2]


def offset_spread_us(spans, trace) -> Optional[float]:
    """The width of the range the true offset lies in: the offset (an upper
    bound) less the greatest difference of the end pairs (a lower bound:
    no host time after an event is taken before it ended); None without an
    anchor. The offset is off by at most this much."""
    off = clock_offset_us(spans, trace)
    pairs = anchors(spans, trace)
    if off is None or not pairs:
        return None
    return off - max(t - h for h, t in pairs)


def phase_busy_us(trace, t0: float, t1: float
                  ) -> Tuple[Dict[str, float], int]:
    """({phase: the device's busy µs from its marker to the next marker,
    summed over the wholly marked steps inside [t0, t1)}, the number of
    those steps): a step is wholly marked where its markers run gather to
    end in PHASES' order with none missing."""
    marks = sorted((d.start, MARKER.search(d.name).group(1))
                   for d in trace.device
                   if "rf_span_" in d.name and t0 <= d.start < t1)
    names = [m[1] for m in marks]
    busy: Dict[str, float] = {}
    steps = 0
    for i in range(len(marks) - len(PHASES) + 1):
        if tuple(names[i:i + len(PHASES)]) != PHASES:
            continue
        steps += 1
        step = marks[i:i + len(PHASES)]
        for (s, phase), (e, _) in zip(step, step[1:]):
            busy[phase] = busy.get(phase, 0.0) + trace.busy_us(s, e)
    return busy, steps


def _intersection_us(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_pieces(spans: Iterable[Tuple[float, float, object]]
                ) -> List[Tuple[float, float, str]]:
    """Each span's self time (start, end, span; the span with its `id` and
    `parent`) as pieces (start, end, name): its interval less its children's
    (the spans whose parent it is)."""
    spans = list(spans)
    children: Dict[object, List[Tuple[float, float]]] = {}
    for a, b, s in spans:
        children.setdefault(s.parent, []).append((a, b))
    out: List[Tuple[float, float, str]] = []
    for a, b, s in spans:
        t = a
        for ca, cb in sorted(children.get(s.id, ())):
            if ca > t:
                out.append((t, min(ca, b), s.name))
            t = max(t, cb)
        if b > t:
            out.append((t, b, s.name))
    return sorted(out)


class SpanView:
    """The program's spans of one traced stretch, on the trace's clock.
    `thread` is the launching thread: the one whose spans are named in
    `tops`."""

    def __init__(self, spans, trace, window: Interval, tops: Sequence[str]):
        self.trace = trace
        self.offset_us = clock_offset_us(spans, trace)
        off = self.offset_us or 0.0
        t0, t1 = window
        self.spans = [(s.start_ns / 1e3 + off, s.end_ns / 1e3 + off, s)
                      for s in spans]
        self.spans = [x for x in self.spans if x[1] > t0 and x[0] < t1]
        threads = Counter(s.thread for _, _, s in self.spans if s.name in tops)
        self.thread = threads.most_common(1)[0][0] if threads else None
        self.pieces = self_pieces(x for x in self.spans
                                  if x[2].thread == self.thread)
        busy = clip(merged((d.start, d.end) for d in trace.work), t0, t1)
        edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
        self.gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]

    def units(self, names: Iterable[str], count: Optional[str] = None) -> int:
        """The launching thread's spans named in `names`: their number, or
        the sum of their `count`."""
        names = set(names)
        return sum(1 if count is None else s.counts.get(count, 0)
                   for _, _, s in self.spans
                   if s.thread == self.thread and s.name in names)

    def idle_us(self) -> float:
        return sum(e - s for s, e in self.gaps)

    def idle_under(self, names: Iterable[str]) -> float:
        """Device idle µs while the innermost span on the launching thread
        is one of `names`."""
        names = set(names)
        under = merged((a, b) for a, b, n in self.pieces if n in names)
        return _intersection_us(self.gaps, under)

    def idle_unattributed(self, tops: Iterable[str]) -> float:
        """Device idle µs under no span but `tops` on the launching thread
        and under no CUDA runtime or driver call."""
        tops = set(tops)
        covered = merged(
            [(a, b) for a, b, n in self.pieces if n not in tops] +
            [(h.start, h.end) for h in self.trace.host
             if h.cat in RUNTIME_CATEGORIES])
        return self.idle_us() - _intersection_us(self.gaps, covered)


def view(ctx, tops: Sequence[str], unit: Sequence[str],
         count: Optional[str] = None) -> Optional[SpanView]:
    """The program's spans of the context's traced stretch; None where the
    program recorded none there, no anchor puts them on the trace's clock,
    or the spans named `unit` (their number, or the sum of their `count`)
    count other than the traced units."""
    spans = program_spans()
    if not spans or ctx.span is None:
        return None
    v = SpanView(spans, ctx.trace, ctx.span, tops)
    if v.offset_us is None or not v.spans:
        return None
    units = v.units(unit, count)
    print(f"spans: offset {v.offset_us!r} us, within "
          f"{offset_spread_us(spans, ctx.trace)!r} us; anchor gap "
          f"{anchor_gap_us(spans, ctx.trace)!r} us; {units} units of "
          f"{len(ctx.batches)} traced", file=sys.stderr, flush=True)
    return v if units == len(ctx.batches) else None


def clock_readings(ctx, steps: bool = True) -> Dict[str, float]:
    """For the traced result's `device`: the clock's `offset_spread_us` and
    `anchor_gap_us` where an anchor puts the spans on the trace's clock, and
    with `steps` the traced stretch's wholly marked steps (`marked_steps`,
    `phase_busy_us`); empty where the program recorded no spans. No metric
    reads them."""
    spans = program_spans()
    if not spans or ctx.span is None:
        return {}
    out: Dict[str, float] = {}
    spread, gap = offset_spread_us(spans, ctx.trace), anchor_gap_us(spans, ctx.trace)
    if spread is not None:
        out["offset_spread_us"] = spread
    if gap is not None:
        out["anchor_gap_us"] = gap
    if steps:
        out["marked_steps"] = phase_busy_us(ctx.trace, *ctx.span)[1]
    return out


def untraced_idle_ms(ctx, v: SpanView, names: Iterable[str]) -> Optional[float]:
    """The share of the traced stretch's idle time under `names` (the
    innermost span on the launching thread) of the device's idle time a
    unit outside the stretch: the untraced unit's wall time (`unit_s`)
    less the device's busy time a unit; ms. None without an untraced
    unit or idle time."""
    idle = v.idle_us()
    if not ctx.unit_s or idle <= 0:
        return None
    untraced = max(ctx.unit_s - ctx.busy_per_unit_s(), 0.0)
    return 1e3 * untraced * v.idle_under(names) / idle


def phases(ctx) -> Optional[Dict[str, float]]:
    """{phase: the device's busy µs a step}, the mean over the traced
    stretch's wholly marked steps (`phase_busy_us`); None where the program
    recorded no spans, marked no whole step, or marked more steps than were
    traced."""
    if not program_spans() or ctx.span is None:
        return None
    busy, steps = phase_busy_us(ctx.trace, *ctx.span)
    print(f"phases: {steps} steps wholly marked of {len(ctx.batches)} traced",
          file=sys.stderr, flush=True)
    if not steps or steps > len(ctx.batches):
        return None
    return {phase: us / steps for phase, us in busy.items()}
