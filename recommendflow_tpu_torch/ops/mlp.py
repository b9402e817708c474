"""MLP blocks and activations (the counterpart of `recommendflow_tpu/ops/mlp.py`).

Submodules carry the flax auto-names (`BatchNorm_0`, `Dense_0`, ...) so that
`interop.py` maps a flax variable tree onto the state dict one to one.
Training mode follows the module's `train()`/`eval()` state: BatchNorm
normalises with the batch statistics and updates its running ones, dropout
drops.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from recommendflow_tpu_torch.parallel.distributed import (all_gather,
                                                          all_reduce_sum)
from recommendflow_tpu_torch.parallel.mesh import active_data_parallel


def dice(x: torch.Tensor, axis: int = 0, alpha: float = 0.0,
         eps: float = 1e-9) -> torch.Tensor:
    """Dice activation (DIN): p·x + alpha·(1−p)·x with p = sigmoid of the
    batch-standardized input (biased variance, as jnp.var).

    Inside a `parallel.mesh.data_parallel` block the batch axis (axis 0)
    is standardized over the GLOBAL batch, as GSPMD computes jnp.mean and
    jnp.var over a dp-sharded batch: the mean is an all-reduced sum over
    the global count, the variance a second all-reduced sum of
    (x - mean)^2 (jnp.var's formula; differentiable collectives)."""
    dp = active_data_parallel()
    if dp is not None and axis % x.dim() == 0:
        mesh, name = dp
        group = mesh.group(name)
        count = x.shape[0] * mesh.size(name)
        mean = all_reduce_sum(x.sum(dim=0, keepdim=True), group) / count
        var = all_reduce_sum(((x - mean) ** 2).sum(dim=0, keepdim=True),
                             group) / count
    else:
        mean = x.mean(dim=axis, keepdim=True)
        var = x.var(dim=axis, keepdim=True, unbiased=False)
    p = torch.sigmoid((x - mean) / torch.sqrt(var + eps))
    return p * x + alpha * (1.0 - p) * x


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

_ACTIVATIONS = {
    "relu": F.relu, "selu": F.selu,
    # flax's nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "elu": F.elu,
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "tanh": torch.tanh, "sigmoid": torch.sigmoid, "silu": F.silu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01), "dice": dice,
    "linear": lambda x: x, "none": lambda x: x,
}


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def selu_in(dtype: torch.dtype) -> Callable:
    """flax's nn.selu in `dtype`: scale * where(x > 0, x, alpha * expm1(x)),
    every operation rounded to the dtype and both constants rounded to it
    first, as JAX rounds a Python constant to the array's dtype (F.selu
    keeps them exact: 3 bf16 ulps away on bf16 inputs)."""
    scale, alpha = (float(torch.tensor(c).to(dtype))
                    for c in (_SELU_SCALE, _SELU_ALPHA))
    return lambda x: scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def get_activation(name: Union[str, Callable]) -> Callable:
    if callable(name):
        return name
    if name.lower() not in _ACTIVATIONS:
        raise ValueError(f"unknown activation '{name}'; have {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name.lower()]


def _batch_moments(x: torch.Tensor):
    """(E[x], E[x^2]) over every axis but the last. Inside a
    `parallel.mesh.data_parallel` block, over the GLOBAL batch: each rank's
    sums are all-reduced (differentiably) and divided by the global count,
    as GSPMD computes flax's mean over a dp-sharded batch."""
    axes = tuple(range(x.dim() - 1))
    dp = active_data_parallel()
    if dp is None:
        return x.mean(dim=axes), (x * x).mean(dim=axes)
    mesh, axis = dp
    group = mesh.group(axis)
    sums = all_reduce_sum(torch.stack([x.sum(dim=axes),
                                       (x * x).sum(dim=axes)]), group)
    count = x.numel() // x.shape[-1] * mesh.size(axis)
    return sums[0] / count, sums[1] / count


class BatchNorm(nn.Module):
    """flax's `nn.BatchNorm` over the last axis: the statistics are taken
    over every other axis ([B, F], or [B, L, U] as Dice normalises, pad
    positions included as in flax).

    Training: normalise with the batch mean and the BIASED variance
    E[x^2] - E[x]^2 (clipped at 0; over the global batch inside a
    `parallel.mesh.data_parallel` block, `_batch_moments`), and move the
    running statistics as
    `momentum * running + (1 - momentum) * batch` (flax's momentum: 0.99
    keeps 99%). Eval: normalise with the running statistics. Both compute
    (x - mean) * (rsqrt(var + eps) * weight) + bias, as flax does. An
    input of another dtype (an MLP's compute_dtype) is normalised in f32
    and the output cast back to its dtype (flax's BatchNorm with `dtype`:
    f32 statistics). With
    use_scale / use_bias off (flax's flags) the module has no weight / bias,
    so its state dict holds only what the flax tree has.
    `nn.BatchNorm1d` cannot stand in: it moves the running variance with the
    unbiased batch variance. The state-dict names are BatchNorm1d's."""

    def __init__(self, features: int, eps: float = 1e-6,
                 momentum: float = 0.99, use_scale: bool = True,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features, device=device)) \
            if use_scale else None
        self.bias = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = x.dtype
        if out_dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        if self.training:
            mean, mean2 = _batch_moments(x)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - mean) * mul
        y = y + self.bias if self.bias is not None else y
        return y.to(out_dtype)


class Dice(nn.Module):
    """DIN's Dice with a learnable per-feature alpha (zero-initialised) and
    BatchNorm statistics (`BatchNorm_0`: no scale or bias, epsilon 1e-9,
    momentum 0.99; batch statistics in training, running ones in eval):
    p·x + alpha·(1−p)·x with p = sigmoid(BatchNorm(x)), over the last axis
    of x."""

    def __init__(self, features: int, epsilon: float = 1e-9, device=None):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(features, eps=epsilon, use_scale=False,
                                     use_bias=False, device=device)
        self.alpha = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = torch.sigmoid(self.BatchNorm_0(x))
        return p * x + self.alpha * (1.0 - p) * x


class MLP(nn.Module):
    """[norm -> dense -> activation -> dropout] x len(units).

    BatchNorm follows flax (see `BatchNorm`): epsilon 1e-6, momentum 0.99.
    compute_dtype (e.g. "bfloat16"): the input is cast to it, each Dense
    multiplies in it with its f32 parameters cast to it (flax's
    `nn.Dense(dtype=...)`: product, then bias, each rounded to the dtype),
    BatchNorm normalises in f32 and returns the dtype, the activations run
    in it (selu with its constants in the dtype, `selu_in`), and the output
    is cast back to f32. The parameters stay f32."""

    def __init__(self, in_features: int, units: Sequence[int],
                 dropout: float = 0.0, activation: str = "relu",
                 use_bn: bool = False, bn_epsilon: float = 1e-6,
                 final_activation: Optional[str] = None,
                 compute_dtype: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        self.compute_dtype = _DTYPES[str(compute_dtype)] if compute_dtype \
            else None
        self.units = list(units)
        self.use_bn = use_bn

        def act(name):
            if self.compute_dtype is not None and name == "selu":
                return selu_in(self.compute_dtype)
            return get_activation(name)
        self.act = act(activation)
        self.final_act = (act(final_activation)
                          if final_activation is not None else self.act)
        self.drop = nn.Dropout(dropout) if dropout > 0 else None
        width = in_features
        for i, out in enumerate(self.units):
            if use_bn:
                self.add_module(f"BatchNorm_{i}", BatchNorm(
                    width, eps=bn_epsilon, device=device))
            self.add_module(f"Dense_{i}", nn.Linear(width, out, device=device))
            width = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.units)
        dtype = self.compute_dtype
        if dtype is not None:
            x = x.to(dtype)
        for i in range(n):
            if self.use_bn:
                x = getattr(self, f"BatchNorm_{i}")(x)
            dense = getattr(self, f"Dense_{i}")
            if dtype is None:
                x = dense(x)
            else:
                x = F.linear(x, dense.weight.to(dtype)) + dense.bias.to(dtype)
            x = self.final_act(x) if i == n - 1 else self.act(x)
            if self.drop is not None:
                x = self.drop(x)
        return x.float() if dtype is not None else x


class ExpertsDense(nn.Module):
    """E Dense layers as one batched product: weight [E, in, out] (the flax
    `nn.vmap` kernel layout, not transposed), bias [E, out]. Takes [B, in]
    (every expert sees the same input) or [B, E, in] -> [B, E, out]."""

    def __init__(self, num_experts: int, in_features: int, out_features: int,
                 device=None):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(
            (num_experts, in_features, out_features), device=device))
        self.bias = nn.Parameter(torch.zeros((num_experts, out_features),
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eq = "bi,eio->beo" if x.dim() == 2 else "bei,eio->beo"
        return torch.einsum(eq, x, self.weight) + self.bias


class ExpertsMLP(nn.Module):
    """E parallel expert MLPs evaluated as one batched computation: every
    parameter carries a leading expert axis [E, ...] (the JAX package's
    `nn.vmap` of `MLP`, whose tree is `experts/Dense_i/{kernel, bias}`), so
    the experts run as single batched products, not a loop of E modules.
    Output: [B, E, units[-1]].

    Expert parallelism (`Trainer(shard_experts=True)`): when the parameters
    hold this rank's block of experts (`parallel.sharded_embedding.
    mark_row_shard` over an 'ep' axis), the rank runs its experts and the
    outputs are all-gathered over the axis into [B, E, units[-1]]
    (differentiably: each expert's gradient lands on its owner)."""

    def __init__(self, num_experts: int, in_features: int,
                 units: Sequence[int], dropout: float = 0.0,
                 activation: str = "relu", device=None):
        super().__init__()
        self.act = get_activation(activation)
        self.drop = nn.Dropout(dropout) if dropout > 0 else None
        self.experts = nn.Module()
        self.units = list(units)
        width = in_features
        for i, out in enumerate(self.units):
            self.experts.add_module(f"Dense_{i}", ExpertsDense(
                num_experts, width, out, device=device))
            width = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.units)):
            x = self.act(getattr(self.experts, f"Dense_{i}")(x))
            if self.drop is not None:
                x = self.drop(x)
        shard = getattr(self.experts.Dense_0.weight, "row_shard", None)
        if shard is not None:
            x = all_gather(x.transpose(0, 1).contiguous(),
                           shard.mesh.group(shard.axis)).transpose(0, 1)
        return x


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)
