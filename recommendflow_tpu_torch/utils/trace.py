"""Read torch.profiler Chrome traces into per-op time tables (the
counterpart of `recommendflow_tpu/utils/xplane.py`, which reads
jax.profiler's xplane.pb).

`Trainer.fit(profile_dir=, profile_steps=)` and `utils/profiling.py:trace`
write one `*.pt.trace.json` per window; `profile_report(prof)` writes and
reads one for a `torch.profiler.profile` the caller ran itself. The reader:

  * device "cuda": the card's own events (categories kernel, gpu_memcpy,
    gpu_memset; the card's copies of user annotations are not device work
    and are left out). `device_total_ms` is the union of their intervals
    (overlaps counted once, gaps not at all), `ops` each event name's total
    and count, each linked to the host op that launched it (the kernel's
    "External id", or its runtime call's through "correlation"): with
    `record_shapes` that op's input shapes give `bytes_est`, the bytes of
    its tensor inputs, read once;
  * device "cpu": the host's op events (category cpu_op), the same way;
  * `step_spans_ms`: the host's `ProfilerStep#` annotations (a profiler
    schedule's steps), else its `Optimizer.step` annotations (one a step of
    a torch optimizer).

Typical use:
    trainer.fit(ds, profile_dir="/tmp/prof", profile_steps=(3, 6))
    rep = parse_trace("/tmp/prof")
    print(format_report(rep, steps=3))
"""
from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import tempfile
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

DEVICE_CATEGORIES = {"cuda": ("kernel", "gpu_memcpy", "gpu_memset"),
                     "cpu": ("cpu_op",)}
# bytes of an element by the type names torch.profiler records
_ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8,
             "long int": 8, "int": 4, "short int": 2, "signed char": 1,
             "unsigned char": 1, "bool": 1, "c10::complex<float>": 8,
             "c10::complex<double>": 16, "c10::Float8_e4m3fn": 1,
             "c10::Float8_e5m2": 1, "unsigned int": 4}


@dataclasses.dataclass
class OpTime:
    name: str            # the launching host op (else the event's name)
    key: str             # aggregation key: the event's name (a kernel symbol)
    total_ms: float      # summed time across the trace
    count: int           # occurrences
    bytes_est: int       # the launching op's tensor inputs, bytes (0: unknown)

    @property
    def gbps(self) -> float:
        """GB/s if bytes_est is right (0 when unknown)."""
        if not self.total_ms:
            return 0.0
        return self.bytes_est * self.count / (self.total_ms * 1e-3) / 1e9


@dataclasses.dataclass
class TraceReport:
    device_total_ms: float       # union of the device class's intervals
    span_ms: float               # first event's start -> last event's end
    ops: List[OpTime]            # per-op aggregate, descending total time
    step_spans_ms: List[float]   # per-step durations (module docstring)
    plane: str                   # the process(es) the events came from

    @property
    def events(self) -> int:
        return sum(op.count for op in self.ops)


def input_bytes(dims: Sequence[Any], types: Sequence[str]) -> int:
    """The bytes of the tensor inputs an op recorded (record_shapes): each
    shape's element count times its type's size; scalars, lists of scalars
    and unknown types count 0."""
    total = 0
    for shape, t in zip(dims, types):
        size = _ITEMSIZE.get(t)
        if not size or not isinstance(shape, list) or not shape \
                or not all(isinstance(d, int) for d in shape):
            continue
        n = 1
        for d in shape:
            n *= d
        total += n * size
    return total


def _union_ms(spans: List[Tuple[float, float]]) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3                        # the trace's times are in us


def report_from_events(events: Sequence[Mapping[str, Any]],
                       device: str = "cuda",
                       source: str = "trace") -> TraceReport:
    """A TraceReport of a Chrome trace's `traceEvents`."""
    if device not in DEVICE_CATEGORIES:
        raise ValueError(f"device must be one of {sorted(DEVICE_CATEGORIES)}, "
                         f"got {device!r}")
    cats = DEVICE_CATEGORIES[device]
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    mine = [e for e in complete if e.get("cat") in cats]
    if not mine:
        raise ValueError(
            f"no populated '{device}' events in {source}; categories = "
            f"{sorted({str(e.get('cat')) for e in complete})}")
    host_ops = {e["args"]["External id"]: e for e in complete
                if e.get("cat") == "cpu_op"
                and "External id" in e.get("args", {})}
    runtime = {e["args"]["correlation"]: e for e in complete
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}

    def launcher(e):
        args = e.get("args", {})
        if e.get("cat") == "cpu_op":
            return e
        ext = args.get("External id")
        if ext is None and args.get("correlation") in runtime:
            ext = runtime[args["correlation"]].get("args", {}).get(
                "External id")
        return host_ops.get(ext)

    agg: Dict[str, List[Any]] = {}
    for e in mine:
        op = launcher(e)
        oargs = op.get("args", {}) if op is not None else {}
        nbytes = input_bytes(oargs.get("Input Dims", []),
                             oargs.get("Input type", []))
        name = str(e.get("name", "?"))
        a = agg.setdefault(name, [op["name"] if op is not None else name,
                                  0.0, 0, 0])
        a[1] += float(e["dur"]) / 1e3
        a[2] += 1
        a[3] += nbytes
    ops = [OpTime(name=str(full)[:200], key=key, total_ms=tot, count=cnt,
                  bytes_est=int(nb // cnt))
           for key, (full, tot, cnt, nb) in agg.items()]
    ops.sort(key=lambda o: -o.total_ms)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in mine]
    span_ms = (max(s[1] for s in spans) - min(s[0] for s in spans)) / 1e3

    annotations = sorted((e for e in complete
                          if e.get("cat") == "user_annotation"),
                         key=lambda e: float(e["ts"]))
    steps = [e for e in annotations
             if str(e.get("name", "")).startswith("ProfilerStep#")] or \
        [e for e in annotations
         if str(e.get("name", "")).startswith("Optimizer.step")]
    names = {e.get("pid"): e.get("args", {}).get("name")
             for e in events if e.get("ph") == "M"
             and e.get("name") == "process_name"}
    pids = sorted({e.get("pid") for e in mine}, key=str)
    plane = ", ".join(str(names.get(p) or f"{device} pid {p}") for p in pids)
    return TraceReport(device_total_ms=_union_ms(spans), span_ms=span_ms,
                       ops=ops,
                       step_spans_ms=[float(e["dur"]) / 1e3 for e in steps],
                       plane=plane)


def read_trace(path: str, device: str = "cuda") -> TraceReport:
    """A TraceReport of one Chrome trace file (gzipped when it ends in
    .gz)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return report_from_events(events, device, source=path)


def parse_trace(trace_dir: str, device: str = "cuda") -> TraceReport:
    """Aggregate the newest torch.profiler trace under trace_dir."""
    paths = sorted((p for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz")
                    for p in glob.glob(os.path.join(trace_dir, "**", pattern),
                                       recursive=True)),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {trace_dir}")
    return read_trace(paths[-1], device)


def profile_report(prof, device: str = "cuda") -> TraceReport:
    """A TraceReport of a finished `torch.profiler.profile`: its Chrome
    trace is written to a temporary file and read back."""
    with tempfile.TemporaryDirectory(prefix="recflow_trace_") as tmp:
        path = os.path.join(tmp, "profile.pt.trace.json")
        prof.export_chrome_trace(path)
        return read_trace(path, device)


def format_report(rep: TraceReport, steps: Optional[int] = None,
                  top: int = 15) -> str:
    lines = [f"device plane {rep.plane}: busy {rep.device_total_ms:.2f} ms "
             f"over a {rep.span_ms:.2f} ms span "
             f"({100 * rep.device_total_ms / max(rep.span_ms, 1e-9):.0f}% "
             f"device busy)"]
    if steps:
        lines.append(f"per-step device time: "
                     f"{rep.device_total_ms / steps:.3f} ms over {steps} steps")
    if rep.step_spans_ms:
        ss = sorted(rep.step_spans_ms)
        lines.append(f"step spans (incl. dispatch gaps): "
                     f"min {ss[0]:.2f} / median {ss[len(ss) // 2]:.2f} / "
                     f"max {ss[-1]:.2f} ms")
    lines.append(f"{'ms/occ':>8} {'occ':>4} {'~GB/s':>6}  op")
    for op in rep.ops[:top]:
        per = op.total_ms / max(op.count, 1)
        gbps = op.bytes_est / (per * 1e-3) / 1e9 if per else 0.0
        lines.append(f"{per:8.3f} {op.count:4d} {gbps:6.0f}  {op.key} "
                     f":: {op.name[:80]}")
    return "\n".join(lines)
