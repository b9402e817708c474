"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line. `run.py` calls `launch` after it has found
the cards the cell asks for; tests call `run` (one process) or `launch` on
the CPU at small sizes.

On a mesh (`harness/ranks.py`) every rank runs `run`: set-up, one barrier
(rank 0's `setup_s` ends there), the window, and its numbers gathered on
rank 0 over the host-side group. Rank 0 alone reads the per-layer metrics
(from its own trace and its own rows of the traced batches: one card's
work over one card's time), combines the ranks' numbers, runs the
reference and prints the result: `device.count` the ranks,
`memory_peak_bytes` the fullest rank's, traced `busy_s` the mean over the
ranks, `per_rank` each rank's peak (and, traced, its `busy_s`)."""
from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from portbench.harness import ranks
from portbench.harness.cell import Cell
from portbench.harness.paths import Path, Window, make_path
from portbench.harness.peaks import peaks_of
from portbench.harness.spans import clock_readings

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "recommendflow_tpu")


class Context:
    """What a per-layer metric's reader reads: the trace of the traced
    stretch (`span`, on the trace's clock), the host batches of its steps
    or requests, the wall seconds of one step or request outside it
    (`unit_s`, host clock), the cell's configuration, layout, traffic and
    reference model, and the card's peaks. On a mesh (`world` ranks) the
    trace and the batches are this rank's; `row_sharded` lists the table
    widths whose rows the ranks divide."""

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
        self.world = path.world
        self.row_sharded = tuple(path.row_sharded)

    def busy_per_unit_s(self) -> float:
        """The device's busy seconds in the traced stretch, per traced step
        or request."""
        return self.trace.busy_us(*self.span) * 1e-6 / len(self.batches)

    def lookups_for_other_ranks(self) -> bool:
        """Whether this rank looks up and updates table rows for the other
        ranks' ids too (row-sharded tables on several ranks): the rows it
        is fed then do not count its embedding or table-update work."""
        return self.world > 1 and bool(self.row_sharded)


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between ranks."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN_MODULES))


class ForbiddenLoaded(RuntimeError):
    """Another rank's run loaded JAX or the JAX package."""


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


def log_stderr(s: str) -> None:
    print(s, file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, started: float,
        log: Callable[[str], None] = log_stderr,
        group: Optional["ranks.Group"] = None,
        children: Optional["ranks.Children"] = None) -> Optional[Dict[str, Any]]:
    """The result of one run (module docstring); on a mesh, in rank 0 (None
    in the other ranks)."""
    path = make_path(cell, device, seed, group)
    path.setup()
    if group is not None:
        group.barrier()
    setup_s = time.monotonic() - started
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = path.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kind = path.kind

    lead = group is None or group.rank == 0
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
        dev["busy_s"] = ctx.trace.occupied_us(*ctx.span) / 1e6
        dev["window_s"] = window.trace_s
        log(f"traced {len(ctx.batches)} units in {window.trace_s!r} s; "
            f"untraced unit {ctx.unit_s!r} s")
        if lead:
            for m in cell.per_layer:
                value = cell.reader(m["name"]).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            dev.update(clock_readings(ctx, steps=kind == "train"))
            breakdown = {"device_ops": ctx.trace.top_ops(*ctx.span),
                         "idle_gaps": ctx.trace.idle_gaps(*ctx.span)}
    attempted, failed = int(window.units), int(window.failed)
    program = path.answers if kind == "serve" else path.program
    del window
    path.free()
    if group is not None:
        parts = group.gather({"program": program, "peak": int(peak),
                              "busy_s": dev.get("busy_s"),
                              "loaded": forbidden_modules()})
        if not lead:
            return None
        if children is not None:
            children.disarm()
        program = path.combine([p["program"] for p in parts])
        dev["memory_peak_bytes"] = max(p["peak"] for p in parts)
        if trace:
            dev["busy_s"] = float(np.mean([p["busy_s"] for p in parts]))
        dev["per_rank"] = [dict({"rank": k, "memory_peak_bytes": p["peak"]},
                                **({"busy_s": p["busy_s"]} if trace else {}))
                           for k, p in enumerate(parts)]
        loaded = sorted({m for p in parts[1:] for m in p["loaded"]})
        if loaded:
            raise ForbiddenLoaded(f"another rank loaded {loaded}")
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


def launch(cell: Cell, seed: int, seconds: float, trace: bool, started: float,
           command: Sequence[str], device_type: str = "cuda",
           log: Callable[[str], None] = log_stderr) -> int:
    """One run of `cell` in this process, its checks on standard error and
    its result as the last line of standard output; returns the exit code.
    A cell on a mesh (`ranks.on_mesh`) runs as rank 0, which starts the
    other ranks as `command` (this process's own command and arguments), or
    as the rank that the environment names. Exit 4 where a rank loaded JAX
    or the JAX package; 1 where a rank failed (no result is printed)."""
    mine = ranks.from_env()
    children = group = None
    try:
        if ranks.on_mesh(cell):
            if mine is None:
                init, children = ranks.start(cell.chips, command, log)
                rank = 0
            else:
                ranks.watch_parent()
                rank, init = mine["rank"], mine["init"]
                tag = f"rank {rank}: "
                log = lambda s, _log=log: _log(tag + s)  # noqa: E731
            group = ranks.Group(rank, cell.chips, init, device_type)
            device = group.device
        else:
            device = torch.device("cuda", 0) if device_type == "cuda" \
                else torch.device(device_type)
        try:
            result = run(cell, seed, seconds, trace, device, started, log,
                         group, children)
        except ForbiddenLoaded as e:
            log(f"portbench: {e}")
            return 4
        if group is not None:
            group.close()
        if children is not None:
            codes = children.join()
            if any(c != 0 for c in codes):
                log(f"portbench: the other ranks exited with {codes}")
                return 1
    finally:
        if children is not None:
            children.stop()
    loaded = forbidden_modules()
    if loaded:
        log(f"portbench: the run loaded {loaded}")
        return 4
    if result is None:
        return 0
    for name, c in result["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
