"""Model export for serving (the counterpart of
`recommendflow_tpu/export/exporter.py:25-78,239-271`).

The JAX package traces `model.apply` with its weights folded in and writes
the StableHLO as a pickle. The port traces the model with `torch.export` in
eval mode, at the static shapes and dtypes of a sample batch (the JAX
package's contract: no dynamic batch dimension), and writes the program, its
weights and a metadata file with `torch.export.save`:

    export_model(model, sample_batch, path)        -> path.rfx
    ServingModel.load(path).predict(batch)         -> {name: np.ndarray}

The hand-written kernels of the traced path are torch custom ops
(`torch.ops.recflow.gather_rows`, `torch.ops.recflow.flash_attention`), so
the program holds each as one node and a program loaded on a card launches
them; on the CPU the same nodes run their plain versions. One artifact loads
on either device (`ServingModel.load(path, device=...)`; the JAX package
lowers for both `cpu` and `tpu`): its weights are written from the host.

Where the JAX package's gather reads a NaN row or wraps for an embedding id
outside its table, the port raises: `ServingModel.predict` checks every
sparse feature's ids on the host against its table before they are copied
(ValueError), because the kernel's device-side assert at a bad id would end
the process's use of the card. The JAX package's TensorFlow formats
(`export_savedmodel`, `load_savedmodel`, `load_frozen_pb`) are not ported.

On a card, `ServingModel` runs the program as one CUDA graph, the
counterpart of the JAX export's single compiled call: when it is built it
calls the program once on static inputs at the exported shapes (zeros: id 0
is every table's pad row), then captures that call; `predict` copies the
checked inputs into the static buffers from pinned memory, replays and
copies the outputs to the host, under a lock (the static buffers are one
per model). The CPU runs the program's fx module.
"""
from __future__ import annotations

import json
import os
import threading
import zipfile
from collections import Counter
from contextlib import nullcontext
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

# the ops must be registered before a program that holds them is loaded
from recommendflow_tpu_torch.ops.cuda import embedding_bag  # noqa: F401
from recommendflow_tpu_torch.ops.cuda import flash_attention  # noqa: F401
from recommendflow_tpu_torch.data.schema import check_ids_in_range
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.train.graphs import StepGraph
from recommendflow_tpu_torch.train.trainer import to_device
from recommendflow_tpu_torch.utils.profiling import span

MAGIC = "RFX-TORCH1"
META_FILE = "recflow_meta.json"
OP_NAMESPACE = "recflow"


class _Served(torch.nn.Module):
    """model(batch) over positional inputs in `batch_keys` order, with the
    constant columns added to the batch and their echoes dropped from a dict
    output."""

    def __init__(self, model: torch.nn.Module, batch_keys, constants):
        super().__init__()
        self.model = model
        self.batch_keys = list(batch_keys)
        self.constant_keys = list(constants)
        for i, key in enumerate(self.constant_keys):
            self.register_buffer(f"constant{i}", constants[key],
                                 persistent=False)

    def forward(self, *arrays):
        batch = dict(zip(self.batch_keys, arrays))
        for i, key in enumerate(self.constant_keys):
            batch[key] = getattr(self, f"constant{i}")
        out = self.model(batch)
        if self.constant_keys and isinstance(out, dict):
            out = {k: v for k, v in out.items() if k not in self.constant_keys}
        return out


def _model_device(model: torch.nn.Module) -> torch.device:
    for t in model.state_dict().values():
        return t.device
    return torch.device("cpu")


def trace_model(model: torch.nn.Module, sample_batch: Mapping[str, Any],
                training: bool = False,
                constants: Optional[Mapping[str, Any]] = None
                ) -> Tuple[torch.export.ExportedProgram, Dict[str, Any]]:
    """The first half of `export_model`: the traced program and its
    metadata, not yet written."""
    constants = {k: np.asarray(v) for k, v in (constants or {}).items()}
    batch_keys = sorted(sample_batch)
    overlap = set(batch_keys) & set(constants)
    if overlap:
        raise ValueError(
            f"constants {sorted(overlap)} also appear in sample_batch — "
            "they would become required serving inputs whose values are "
            "silently ignored; remove them from one side")
    dev = _model_device(model)
    arrays = {k: np.asarray(sample_batch[k]) for k in batch_keys}
    inputs = tuple(torch.from_numpy(np.ascontiguousarray(arrays[k])).to(dev)
                   for k in batch_keys)
    served = _Served(model, batch_keys, {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        for k, v in constants.items()})
    was_training = model.training
    model.train(training)
    try:
        with torch.no_grad():
            program = torch.export.export(served, inputs, strict=False)
    finally:
        model.train(was_training)
    schema = getattr(model, "schema", None)
    id_rows = {} if schema is None else {
        s.name: int(s.num_rows) for s in schema.sparse_slots()
        if s.name in arrays}
    meta = {"magic": MAGIC, "batch_keys": batch_keys,
            "shapes": {k: list(arrays[k].shape) for k in batch_keys},
            "dtypes": {k: str(arrays[k].dtype) for k in batch_keys},
            "id_rows": id_rows}
    return program, meta


def save_export(program: torch.export.ExportedProgram, meta: Dict[str, Any],
                path: str) -> str:
    """The second half of `export_model`: write the program, its weights
    and its metadata to `path` (".rfx" appended if missing). The program is
    moved to the host first (in place), so the file holds no tensor bound
    to a card and loads on a machine without one."""
    if not path.endswith(".rfx"):
        path = path + ".rfx"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    program = move_to_device_pass(program, "cpu")
    # a file object: torch.export names its own files ".pt2"
    with open(path, "wb") as f:
        torch.export.save(program, f, extra_files={META_FILE: json.dumps(meta)})
    return path


def export_model(model: torch.nn.Module, sample_batch: Mapping[str, Any],
                 path: str, training: bool = False,
                 constants: Optional[Mapping[str, Any]] = None) -> str:
    """Trace `model(batch)` (eval mode unless `training`) on the model's
    device at the shapes and dtypes of `sample_batch` (numpy arrays) and
    write it, weights included, to `path` (".rfx" appended if missing).
    Returns the path.

    `constants`: columns baked into the program instead of being serving
    inputs (the export CLI passes zeroed label columns, so that requests
    need no labels); an output key that echoes one is dropped. A key in
    both `constants` and `sample_batch` raises ValueError."""
    return save_export(*trace_model(model, sample_batch, training, constants),
                       path)


def custom_op_nodes(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """The port's custom-op nodes in a program's graph: {"recflow::name":
    count}."""
    counts: Counter = Counter()
    for node in program.graph.nodes:
        name = getattr(node.target, "name", None)
        if node.op == "call_function" and callable(name):
            op = name()
            if op.startswith(OP_NAMESPACE + "::"):
                counts[op.split(".")[0]] += 1
    return dict(counts)


class ServingModel:
    """A reloaded export on one device: `.predict(batch)` with a batch dict
    of the exported shapes; on a card the program's CUDA graph (module
    docstring)."""

    def __init__(self, program: torch.export.ExportedProgram,
                 meta: Dict[str, Any], device: torch.device):
        self.program = program
        self.meta = meta
        self.batch_keys = meta["batch_keys"]
        self.device = device
        self._module = program.module()
        self._lock = threading.Lock()
        self.graph: Optional[StepGraph] = None
        if device.type == "cuda":
            self.graph = StepGraph(device, "exported program")
            zeros = {k: np.zeros(meta["shapes"][k], meta["dtypes"][k])
                     for k in self.batch_keys}
            with torch.no_grad():
                for _ in range(2):      # the eager call, then the capture
                    self.graph(self._run, zeros)

    def _run(self, inputs: Mapping[str, torch.Tensor]):
        """The program on a batch dict of device tensors."""
        return self._module(*(inputs[k] for k in self.batch_keys))

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"
             ) -> "ServingModel":
        """Load an export onto `device` (default "cuda"; raises without a
        card unless "cpu" is asked for), wherever it was exported. Raises
        ValueError for a file that is not the port's export (the JAX
        package's `.rfx`, a pickle, is refused unread)."""
        dev = resolve_device(device)
        if not path.endswith(".rfx"):
            path = path + ".rfx"
        if not zipfile.is_zipfile(path):
            with open(path, "rb") as f:
                head = f.read(2)
            kind = ("the JAX package's export (a pickle of StableHLO)"
                    if head[:1] == b"\x80" else "not an export of the port")
            raise ValueError(f"{path}: {kind}; the port loads only its own "
                             f"torch.export artifact (re-export the model "
                             f"with recommendflow_tpu_torch.cli.export)")
        extra = {META_FILE: ""}
        with open(path, "rb") as f:
            program = torch.export.load(f, extra_files=extra)
        meta = json.loads(extra[META_FILE] or "{}")
        if meta.get("magic") != MAGIC:
            raise ValueError(f"{path}: not an RFX export of the port")
        program = move_to_device_pass(program, dev)
        return cls(program, meta, dev)

    def predict(self, batch: Mapping[str, Any]) -> Dict[str, np.ndarray]:
        """Outputs of the program on `batch` (numpy arrays or nested lists of
        the exported shapes; cast to the exported dtypes), as numpy. Raises
        KeyError for a missing input, ValueError for a wrong shape or an
        embedding id outside its table (checked on the host, before the
        copy), TypeError for sparse ids that are not integers. Spans:
        `serve.predict`, `serve.check` (the inputs and their ids),
        `serve.cast`, `serve.fetch` (the outputs to the host)."""
        with span("serve.predict"):
            with span("serve.check"):
                missing = [k for k in self.batch_keys if k not in batch]
                if missing:
                    raise KeyError(f"export expects inputs {self.batch_keys}; "
                                   f"missing {missing}")
                arrays = {}
                for k in self.batch_keys:
                    arr = np.asarray(batch[k])
                    want = tuple(self.meta["shapes"][k])
                    if arr.shape != want:
                        raise ValueError(f"input '{k}': shape {arr.shape} != "
                                         f"exported {want}")
                    arrays[k] = arr
                try:
                    check_ids_in_range(self.meta["id_rows"], arrays)
                except IndexError as e:
                    raise ValueError(str(e)) from None
            with span("serve.cast"):
                host = {k: arrays[k].astype(self.meta["dtypes"][k], copy=False)
                        for k in self.batch_keys}
            # a graph has one set of static buffers: its outputs are read
            # back before the next call replays it
            guard = self._lock if self.graph is not None else nullcontext()
            with torch.no_grad(), guard:
                out = self._run(to_device(host, self.device)) \
                    if self.graph is None else self.graph(self._run, host)
                with span("serve.fetch"):
                    return _to_numpy(out)


def _to_numpy(out) -> Dict[str, np.ndarray]:
    """A program's outputs on the host (a copy: a replay's buffers are
    overwritten by the next)."""
    if isinstance(out, dict):
        return {k: v.cpu().numpy() for k, v in out.items()}
    return {"output": out.cpu().numpy()}
