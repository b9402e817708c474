"""The device mesh and its sharding rules (the counterpart of
`recommendflow_tpu/parallel/mesh.py`), over
`torch.distributed.device_mesh.DeviceMesh`.

One process per device: a `Mesh` names the axes of the world's ranks
(default one axis 'dp' over all of them) and gives each axis's process
group, which carries that axis's collectives. A partition spec `P(...)` is
the JAX PartitionSpec's counterpart as a tuple: `P("dp", None)` row-shards
a 2-D leaf over 'dp' (rank k of the axis holds rows [k*S, (k+1)*S)), `P()`
replicates it. Only the leading dimension is ever sharded.

`axis_name` arguments elsewhere in the port (the in-batch losses,
`auc_update`) name an axis of the current mesh: the one `make_mesh` built
last, or the one a `data_parallel` block names.
"""
from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class P(tuple):
    """A partition spec: one mesh axis name (or None) per leading
    dimension; `P()` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


class Mesh:
    """The world's ranks laid out on named axes.

    axis_names, shape ({axis: size}, as the JAX Mesh's), device (this
    rank's torch device), device_mesh (the DeviceMesh); group(axis) is the
    axis's process group and rank(axis) this rank's coordinate on it."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(
            self.axis_names, device_mesh.mesh.shape))

    def _check(self, axis: str) -> None:
        if axis not in self.shape:
            raise ValueError(f"mesh {self.shape} has no '{axis}' axis")

    def group(self, axis: str):
        self._check(axis)
        return self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        self._check(axis)
        return int(self.device_mesh.get_local_rank(axis))

    def size(self, axis: str) -> int:
        self._check(axis)
        return int(self.shape[axis])

    def group_of(self, axes: Sequence[str]):
        """The process group over `axes` (every rank whose coordinates on
        the other axes equal this rank's): the world's default group for
        all of them, an axis's group for one; "none" for no axis (nothing
        to reduce)."""
        axes = [a for a in self.axis_names if a in axes]
        if not axes:
            return "none"
        if len(axes) == len(self.axis_names):
            return None
        if len(axes) == 1:
            return self.group(axes[0])
        raise NotImplementedError(f"a group over {axes} of a mesh of "
                                  f"{len(self.axis_names)} axes")

    @property
    def world_size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


_CURRENT: Optional[Mesh] = None
_DATA_PARALLEL: Optional[Tuple[Mesh, str]] = None


def make_mesh(axis_names: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None,
              current: bool = True) -> Mesh:
    """A mesh over every rank of the process group (init_distributed
    first): shape defaults to [world, 1, ...]. The ranks' device type
    follows the group's backend (NCCL: cuda, gloo: cpu). The mesh becomes
    the current one unless `current` is off."""
    global _CURRENT
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.init_distributed() first (torchrun, or "
                           "an explicit rank and world size)")
    n = dist.get_world_size()
    if shape is None:
        shape = [n] + [1] * (len(axis_names) - 1)
    if int(np.prod(shape)) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} over axes "
                         f"{tuple(axis_names)} does not hold {n} ranks")
    cuda = dist.get_backend() == "nccl"
    device_type = "cuda" if cuda else "cpu"
    dm = init_device_mesh(device_type, tuple(int(s) for s in shape),
                          mesh_dim_names=tuple(axis_names))
    device = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    mesh = Mesh(dm, device)
    if current:
        _CURRENT = mesh
    return mesh


def current_mesh() -> Mesh:
    if _DATA_PARALLEL is not None:
        return _DATA_PARALLEL[0]
    if _CURRENT is None:
        raise RuntimeError("no mesh: build one with make_mesh()")
    return _CURRENT


def axis_group(axis_name: str):
    """(process group, this rank's coordinate, axis size) of an axis of the
    current mesh."""
    mesh = current_mesh()
    return mesh.group(axis_name), mesh.rank(axis_name), mesh.size(axis_name)


@contextlib.contextmanager
def data_parallel(mesh: Mesh, axis: str = "dp") -> Iterator[None]:
    """Within the block each rank holds its own rows of a global batch on
    `axis`: BatchNorm in training mode takes its statistics over the global
    batch and the models' losses see the global batch (train/trainer.py)."""
    global _DATA_PARALLEL
    mesh._check(axis)
    prev, _DATA_PARALLEL = _DATA_PARALLEL, (mesh, axis)
    try:
        yield
    finally:
        _DATA_PARALLEL = prev


def active_data_parallel() -> Optional[Tuple[Mesh, str]]:
    """(mesh, axis) inside a `data_parallel` block, else None."""
    return _DATA_PARALLEL


def is_table_param(name: str) -> bool:
    """The one 'is this an embedding-table parameter' predicate: a stacked
    table is 'table_dim{d}' (the port's parameter names, 'embedder.
    table_dim16') or keyed 'dim{d}' at the path tail (the accumulators,
    `init_tables`)."""
    tail = re.split(r"[./]", name)[-1]
    return "table_dim" in name or tail.startswith("dim")


def table_sharding_rules(params: Mapping[str, torch.Tensor], mesh: Mesh,
                         axis: str = "dp", min_rows: int = 8192
                         ) -> Dict[str, P]:
    """{name: spec}: a stacked table with at least `min_rows` STORED rows
    (8192 x 512 B = 4 MB) that the axis divides is row-sharded over `axis`;
    everything else is replicated."""
    n = mesh.size(axis)

    def spec(name, leaf):
        if is_table_param(name) and leaf.dim() == 2 \
                and leaf.shape[0] >= min_rows and leaf.shape[0] % n == 0:
            return P(axis, None)
        return P()
    return {name: spec(name, leaf) for name, leaf in params.items()}


def expert_sharding_rules(params: Mapping[str, torch.Tensor], mesh: Mesh,
                          axis: str = "ep") -> Dict[str, P]:
    """{name: spec}: every leaf under a module named 'experts' (a leading
    [E, ...] expert axis) that the axis divides is sharded over `axis`, so
    each rank holds E/|axis| experts; everything else is replicated. A
    mesh without the axis is refused (the default shape would leave it at
    size 1 and the sharding a silent no-op)."""
    if axis not in mesh.shape:
        raise ValueError(
            f"expert_sharding_rules needs a '{axis}' mesh axis but the mesh "
            f"has {mesh.axis_names} — build it with an EXPLICIT shape, e.g. "
            f"make_mesh(axis_names=('dp', '{axis}'), shape=(n // n_experts, "
            f"n_experts)) — the default shape puts every rank on the first "
            f"axis, leaving '{axis}' size 1 (expert sharding would be a "
            f"silent no-op)")
    n = mesh.size(axis)

    def spec(name, leaf):
        if "experts" in re.split(r"[./]", name) and leaf.dim() >= 1 \
                and leaf.shape[0] % n == 0:
            return P(axis, *([None] * (leaf.dim() - 1)))
        return P()
    return {name: spec(name, leaf) for name, leaf in params.items()}


def merge_rules(*rules: Mapping[str, P]) -> Dict[str, P]:
    """Combine spec dicts over the same names: the first non-replicated
    spec wins."""
    out: Dict[str, P] = {}
    for name in rules[0]:
        out[name] = next((r[name] for r in rules if r[name] != P()), P())
    return out


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's contiguous block of x's rows on `axis`."""
    n, r = mesh.size(axis), mesh.rank(axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    s = x.shape[0] // n
    return x[r * s:(r + 1) * s]


def shard_batch(mesh: Mesh, batch: Mapping, axis: str = "dp") -> Dict:
    """This rank's contiguous rows of a global batch (the JAX P('dp')
    layout): rank k of `axis` keeps rows [k*b, (k+1)*b), b = B / |axis|.
    Numpy arrays stay numpy; tensors stay where they are."""
    return {k: shard_rows(v, mesh, axis) for k, v in batch.items()}


def apply_shardings(tensors: Mapping[str, torch.Tensor], mesh: Mesh,
                    specs: Mapping[str, P]) -> Dict[str, torch.Tensor]:
    """Each tensor placed on this rank's device as its spec says: a row
    shard (a copy of this rank's block) or the whole tensor."""
    out = {}
    for name, t in tensors.items():
        spec = specs.get(name, P())
        if any(a is not None for a in spec[1:]):
            raise ValueError(f"{name}: only the leading dimension shards "
                             f"({spec})")
        t = t.to(mesh.device)
        out[name] = shard_rows(t, mesh, spec[0]).clone() \
            if spec and spec[0] is not None else t
    return out


def launch_mesh(device: str = "cuda", no_mesh: bool = False,
                shard_tables: bool = False):
    """The CLIs' mesh: (mesh or None, this process's device).

    Launched as one of several processes (torchrun's environment, or a
    group already joined) the process joins the group (its device
    `cuda:{LOCAL_RANK}`) and the mesh spans every rank; with `no_mesh` it
    trains on its own share of the data, as the JAX CLI does. A plain
    single process keeps the path without a group, unless `shard_tables`
    asks for a mesh: it then joins a group of one (gloo on the CPU, NCCL
    on a card)."""
    import os
    import tempfile
    from recommendflow_tpu_torch.device import resolve_device
    from recommendflow_tpu_torch.parallel.distributed import init_distributed
    if no_mesh and shard_tables:
        raise ValueError("--shard_tables row-shards tables over the mesh: "
                         "drop --no_mesh")
    launched = "WORLD_SIZE" in os.environ or (
        dist.is_available() and dist.is_initialized())
    if not (launched or shard_tables):
        return None, resolve_device(device)
    if launched:
        dev = init_distributed(device=device)
    else:
        init = os.path.join(tempfile.mkdtemp(prefix="recflow_pg_"), "init")
        dev = init_distributed(0, 1, "file://" + init, device=device)
    return (None if no_mesh else make_mesh()), dev
