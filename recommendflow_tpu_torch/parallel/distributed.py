"""Process-group initialization and the differentiable collectives (the
counterpart of `recommendflow_tpu/parallel/distributed.py`).

One process per device, launched by `torchrun` (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or given its rank and world size
explicitly. A CUDA device takes NCCL, the CPU takes gloo; each rank's
device is `cuda:{LOCAL_RANK}` unless "cpu" is asked for.

The collectives below are the ones the mesh paths differentiate through.
Their backward follows the sum of every rank's objective: the adjoint of
an all-gather sums each slice's gradient over the ranks (an all-reduce,
then this rank's slice), the adjoint of an all-reduce sum is an all-reduce
sum. A loss that every rank computes as the same global value therefore
gives each rank world-size times its share of the global gradient; the
trainer averages (train/trainer.py).
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.utils.logger import get_logger

log = get_logger("recflow.distributed")

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def init_distributed(rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     device: Union[str, torch.device, None] = None,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the process group and return this rank's device.

    Arguments default to torchrun's environment variables. A single process
    with none of them set (and no arguments) stays as it is: no group is
    made, and the device is `device` (default "cuda"). A call after the
    group exists changes nothing. A requested multi-process init that fails
    RAISES: a rank that fell back to a lone process would train on its own
    and race the others' writes to shared checkpoint roots.

    device: "cuda" (default: `cuda:{LOCAL_RANK}`, NCCL) or "cpu" (gloo)."""
    want = torch.device(device if device is not None else "cuda")
    if want.type == "cuda" and want.index is None:
        want = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(want)
    if dist.is_available() and dist.is_initialized():
        return dev
    env = all(k in os.environ for k in _ENV)
    if rank is None and world_size is None and init_method is None and not env:
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if rank is not None:
        kwargs["rank"] = int(rank)
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    dist.init_process_group(backend=backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)
    log.info("process group initialized: rank %d/%d, %s on %s",
             dist.get_rank(), dist.get_world_size(), backend, dev)
    return dev


def host_id() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def num_hosts() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


def all_gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `x` (equal shapes), in rank order; no gradient."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def all_gather_nograd(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` concatenated along dim 0, in rank order: gathered
    straight into the result, or as a list and a cat on gloo."""
    if dist.get_backend(group) == "gloo":
        return torch.cat(all_gather_list(x, group))
    x = x.contiguous()
    out = x.new_empty((x.shape[0] * dist.get_world_size(group),)
                      + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def all_reduce_nograd(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                      ) -> torch.Tensor:
    """An all-reduced copy of `x`."""
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=op, group=group)
    return y


def reduce_scatter_nograd(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks of `x` [W*b, ...], this rank's b rows
    in rank order: a reduce-scatter, or on gloo an all-reduce of `x` in
    place and a slice of it."""
    world = dist.get_world_size(group)
    n = x.shape[0] // world
    if dist.get_backend(group) == "gloo":
        dist.all_reduce(x, group=group)
        r = dist.get_rank(group)
        return x[r * n:(r + 1) * n]
    out = x.new_empty((n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.n = x.shape[0]
        return all_gather_nograd(x, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_nograd(g, ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.n:(r + 1) * ctx.n], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_nograd(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_nograd(g, ctx.group), None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` [n, ...] concatenated along dim 0 in rank order,
    differentiable: the backward sums each slice's gradient over the ranks
    (module docstring)."""
    return _AllGather.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's `x`, differentiable (backward: the sum of
    every rank's gradient)."""
    return _AllReduceSum.apply(x, group)
