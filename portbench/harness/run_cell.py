"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line. `run.py` calls `run` after it has found
the cards the cell asks for; tests call it on the CPU at small sizes."""
from __future__ import annotations

import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Mapping

import numpy as np
import torch

from portbench.harness.cell import Cell
from portbench.harness.paths import Path, Window, make_path
from portbench.harness.peaks import peaks_of

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "recommendflow_tpu")


class Context:
    """What a per-layer metric's reader reads: the trace of the traced
    stretch (`span`, on the trace's clock), the host batches of its steps
    or requests, the wall seconds of one step or request outside it
    (`unit_s`, host clock), the cell's configuration, layout, traffic and
    reference model, and the card's peaks."""

    def __init__(self, path: Path, window: Window, peaks: Mapping[str, float]):
        self.trace = window.trace
        self.batches = window.traced_batches
        self.unit_s = window.unit_s
        self.config = path.config
        self.args = path.args
        self.layout = path.layout
        self.traffic = path.traffic
        self.reference = path.ref
        self.peaks = dict(peaks)
        self.span = self.trace.window() if self.trace is not None else None

    def busy_per_unit_s(self) -> float:
        """The device's busy seconds in the traced stretch, per traced step
        or request."""
        return self.trace.busy_us(*self.span) * 1e-6 / len(self.batches)


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between ranks."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN_MODULES))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def judge(numbers: Mapping[str, float], limits: Mapping[str, Any]
          ) -> Dict[str, Dict[str, Any]]:
    """Each number the cell compares (every number its limits file names)
    beside its limit; a number the file names and the run lacks reads
    None and fails."""
    return {name: {"value": None if numbers.get(name) is None
                   else float(numbers[name]), "limit": spec["limit"]}
            for name, spec in limits.get("numbers", {}).items()}


def passed(checks: Mapping[str, Mapping[str, Any]]) -> bool:
    return bool(checks) and all(c["value"] is not None and c["limit"] is not None
                                and c["value"] <= c["limit"] for c in checks.values())


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, started: float,
        log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True)
        ) -> Dict[str, Any]:
    """The result of one run (module docstring)."""
    path = make_path(cell, device, seed)
    path.setup()
    setup_s = time.monotonic() - started
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = path.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kind = path.kind

    metrics: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    dev: Dict[str, Any] = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    peaks = peaks_of(dev["kind"])
    if not trace:
        values = {"setup_s": setup_s}
        if kind == "train":
            values["train_examples_per_s"] = window.examples / window.seconds
        else:
            values["requests_per_s"] = window.completed / seconds
            lat_ms = [1e3 * x for x in window.latencies]
            values["request_ms_p50"] = percentile(lat_ms, 50)
            values["request_ms_p95"] = percentile(lat_ms, 95)
        log("window " + " ".join(f"{k}={v!r}" for k, v in values.items()))
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = Context(path, window, peaks)
        if ctx.span is None:
            raise RuntimeError("the traced stretch holds no event")
        dev["busy_s"] = ctx.trace.busy_us(*ctx.span) / 1e6
        dev["window_s"] = window.trace_s
        log(f"traced {len(ctx.batches)} units in {window.trace_s!r} s; "
            f"untraced unit {ctx.unit_s!r} s")
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = {"device_ops": ctx.trace.top_ops(*ctx.span),
                     "idle_gaps": ctx.trace.idle_gaps(*ctx.span)}
    attempted, failed = int(window.units), int(window.failed)
    program = path.answers if kind == "serve" else path.program
    del window
    path.free()
    log(f"set-up {setup_s:.3f} s; window done; reference check")
    numbers = path.numbers(program, path.reference("float32"))
    if kind == "serve":
        # every request answered, and some answer to check
        numbers["unanswered"] = float(failed + (0 if program else 1))
    log("readings " + " ".join(f"{k}={v!r}" for k, v in numbers.items()))
    checks = judge(numbers, cell.limits)
    correct = passed(checks)
    result: Dict[str, Any] = {
        "correct": bool(correct), "attempted": attempted, "failed": failed,
        "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["power_limit"] = power_limit() if device.type == "cuda" else ""
    result["checks"] = checks
    return result
