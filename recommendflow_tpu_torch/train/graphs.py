"""CUDA graphs of the trainer's device work: `StepGraph`, the port's
counterpart of the JAX trainer's `_build_train_step_scan` and
`_build_eval_step` (`recommendflow_tpu/train/trainer.py`), which put a step,
or K of them, into one dispatch.

A `StepGraph` holds one CUDA graph per batch signature (keys, shapes and
dtypes) of one function of a batch, over static input buffers:

  * the first batch of a signature is copied to the card and the function
    runs eagerly on a side stream: a real call, which also creates the
    state a capture must find (Adam's moments, cuBLAS workspaces, the
    gradients, the slot-offset caches); only the signature is kept;
  * the second is copied into fresh static buffers, the function is
    captured (PyTorch's whole-network recipe; capture runs nothing on the
    card) and the graph is replayed at once;
  * every later one is copied in and replayed.

A function whose capture allocates gradients sets them to None itself
first (the trainer's step does), so that backward allocates them from the
graph's private pool.

So no call runs twice and none is skipped. What the host decides for each
call (the dropout reseed, the learning rate, the step count) stays outside
the graph: the caller writes it before each call, and a replay reads the
generator's seed and offset and every device tensor as they stand then.

A replay's outputs live in static buffers that the next replay overwrites:
a caller clones what it keeps. A batch comes as host arrays (numpy or CPU
tensors, copied from pinned memory without making the host wait) or as
tensors on the card. A capture that fails raises, naming the last operation
it reached; nothing falls back to eager.

The graphs read and write the tensors they were captured against, so they
assume those tensors are updated in place: `bind` drops every graph when
the caller's state objects are not the ones of the capture. A graph's
private pool (its activations and gradients) lives as long as the graph:
`reset`, or dropping the StepGraph, frees it.

Launch counts: a replay calls no kernel wrapper, so the capture's counts
(`ops/cuda/launches.py`) are taken back and added again at every replay.

Spans (utils/profiling.py, recorded while a profiler runs): `graph.copy_in`,
`graph.eager`, `graph.capture` and `graph.replay`, whose start and mark
(the host's time just after the graph's launch returned) bracket the
launch. So a capture or an eager first run inside a traced stretch shows by
name.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from recommendflow_tpu_torch.ops.cuda import launches
from recommendflow_tpu_torch.utils.profiling import span

Signature = Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...]


def as_tensor(value: Any) -> torch.Tensor:
    """A batch value (numpy array or tensor) as a tensor, without a copy
    where numpy allows."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def signature(batch: Mapping[str, torch.Tensor]) -> Signature:
    return tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in batch.items()))


def copy_in(static: Dict[str, torch.Tensor],
            batch: Mapping[str, torch.Tensor]) -> None:
    """Copy a batch into static device buffers on the current stream: a
    host tensor through pinned memory (the copy does not make the host
    wait; the pinned block stays allocated until the copy is done), a
    device tensor directly."""
    for k, dst in static.items():
        src = batch[k]
        if src.device.type == "cpu" and not src.is_pinned():
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)


class _LastOp(TorchDispatchMode):
    """Remembers the last operation dispatched, to name it when a capture
    fails."""

    def __init__(self):
        super().__init__()
        self.last = "nothing"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = str(func)
        return func(*args, **(kwargs or {}))


def _innermost(err: BaseException) -> BaseException:
    """The first error of a chain (a capture's end raises after the
    operation that broke it)."""
    while err.__context__ is not None:
        err = err.__context__
    return err


@dataclass
class _Entry:
    inputs: Dict[str, torch.Tensor]
    graph: "torch.cuda.CUDAGraph"
    outputs: Any
    launches: launches.Counts
    capture_s: float
    pool_mb: float
    replays: int = 0


class StepGraph:
    """CUDA graphs of one function of a batch on `device`, one per batch
    signature (module docstring). `name` labels its errors and stats. Not
    thread-safe: a caller that shares one across threads serialises the
    calls."""

    def __init__(self, device: torch.device, name: str = "step"):
        if device.type != "cuda":
            raise ValueError(f"{name}: CUDA graphs need a card, got {device}")
        self.device = device
        self.name = name
        self._entries: Dict[Signature, _Entry] = {}     # captured
        self._seen: Set[Signature] = set()              # run once, eagerly
        self._owners: Tuple[Any, ...] = ()
        self._side: Optional[torch.cuda.Stream] = None

    def bind(self, *owners: Any) -> None:
        """Drop every graph unless `owners` are the objects (held here, so
        none is reused under another's id) that the graphs were captured
        against: the state the captured work reads and updates."""
        if len(owners) != len(self._owners) or \
                any(a is not b for a, b in zip(owners, self._owners)):
            self.reset()
            self._owners = owners

    def reset(self) -> None:
        """Drop every graph and its memory pool."""
        self._entries.clear()
        self._seen.clear()

    def stats(self) -> List[Dict[str, Any]]:
        """Per captured signature: capture seconds, the private pool's MB
        (device memory the allocator reserved for it), replays and the
        kernel launches a replay makes, in all and by counter (those it
        makes)."""
        return [{"signature": [[k, list(s), str(d)] for k, s, d in sig],
                 "capture_s": e.capture_s, "pool_mb": e.pool_mb,
                 "replays": e.replays,
                 "launches_per_replay": launches.total(e.launches),
                 "launches": {k: v for k, v in e.launches.items() if v}}
                for sig, e in self._entries.items()]

    def __call__(self, fn: Callable[[Dict[str, torch.Tensor]], Any],
                 batch: Mapping[str, Any]) -> Any:
        """fn(batch on the card) for one batch: eagerly on a signature's
        first batch, captured and replayed on its second, replayed after.
        Returns fn's outputs (a replay's are the graph's static outputs)."""
        tensors = {k: as_tensor(v) for k, v in batch.items()}
        sig = signature(tensors)
        entry = self._entries.get(sig)
        if entry is None:
            with span("graph.copy_in"):
                inputs = {k: torch.empty(v.shape, dtype=v.dtype,
                                         device=self.device)
                          for k, v in tensors.items()}
                copy_in(inputs, tensors)
            if sig not in self._seen:
                self._seen.add(sig)
                with span("graph.eager"):
                    side = self._side_stream()
                    side.wait_stream(torch.cuda.current_stream(self.device))
                    with torch.cuda.stream(side):
                        out = fn(inputs)
                    torch.cuda.current_stream(self.device).wait_stream(side)
                return out
            with span("graph.capture"):
                entry = self._entries[sig] = self._capture(inputs, fn)
        else:
            with span("graph.copy_in"):
                copy_in(entry.inputs, tensors)
        # the span's start and its mark, the host's time just after the
        # launch returned, bracket the replay's cudaGraphLaunch: a trace
        # reader puts the host's clock on the trace's from them
        with span("graph.replay") as sp:
            entry.graph.replay()
            sp.mark()
        entry.replays += 1
        launches.add(entry.launches)
        return entry.outputs

    def _side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _capture(self, inputs: Dict[str, torch.Tensor], fn) -> _Entry:
        side = self._side_stream()
        side.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        before = launches.snapshot()
        last = _LastOp()
        t0 = time.perf_counter()
        # no garbage collection inside the capture: a dead cycle that holds
        # another CUDA graph (a discarded trainer's) would destroy it there,
        # a call the capture forbids, and the capture would fail
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side):
                with last:
                    outputs = fn(inputs)
        except Exception as e:   # any failure: name where, then raise
            first = _innermost(e)
            raise RuntimeError(
                f"{self.name}: capturing a CUDA graph failed at "
                f"{last.last}: {type(first).__name__}: {first}") from e
        finally:
            if collecting:
                gc.enable()
            # the capture launched nothing on the card: a replay does
            captured = launches.difference(launches.snapshot(), before)
            launches.add(captured, -1)
        return _Entry(inputs, graph, outputs, captured,
                      time.perf_counter() - t0, pool_bytes(graph) / 1e6)


def pool_bytes(graph: "torch.cuda.CUDAGraph") -> int:
    """Device memory the caching allocator holds in a graph's private
    pool (its segments' sizes)."""
    pool = tuple(graph.pool())
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool)
