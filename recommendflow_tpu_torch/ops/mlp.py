"""MLP blocks and activations (the counterpart of `recommendflow_tpu/ops/mlp.py`).

Submodules carry the flax auto-names (`BatchNorm_0`, `Dense_0`, ...) so that
`interop.py` maps a flax variable tree onto the state dict one to one.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn


def dice(x: torch.Tensor, axis: int = 0, alpha: float = 0.0,
         eps: float = 1e-9) -> torch.Tensor:
    """Dice activation (DIN): p·x + alpha·(1−p)·x with p = sigmoid of the
    batch-standardized input (biased variance, as jnp.var)."""
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, keepdim=True, unbiased=False)
    p = torch.sigmoid((x - mean) / torch.sqrt(var + eps))
    return p * x + alpha * (1.0 - p) * x


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


def get_activation(name: Union[str, Callable]) -> Callable:
    if callable(name):
        return name
    if name.lower() not in _ACTIVATIONS:
        raise ValueError(f"unknown activation '{name}'; have {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name.lower()]


class MLP(nn.Module):
    """[norm -> dense -> activation -> dropout] x len(units).

    BatchNorm uses the flax conventions: epsilon 1e-6 and momentum 0.99 in
    flax's sense, which is 0.01 in torch's. In eval mode it normalises with
    the running statistics, as flax's `use_running_average=True` does."""

    def __init__(self, in_features: int, units: Sequence[int],
                 dropout: float = 0.0, activation: str = "relu",
                 use_bn: bool = False, bn_epsilon: float = 1e-6,
                 final_activation: Optional[str] = None,
                 compute_dtype: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
        super().__init__()
        if compute_dtype:
            raise NotImplementedError(
                "compute_dtype is not supported yet (it is off in every "
                "shipped config)")
        self.units = list(units)
        self.use_bn = use_bn
        self.act = get_activation(activation)
        self.final_act = (get_activation(final_activation)
                          if final_activation is not None else self.act)
        self.drop = nn.Dropout(dropout) if dropout > 0 else None
        width = in_features
        for i, out in enumerate(self.units):
            if use_bn:
                self.add_module(f"BatchNorm_{i}", nn.BatchNorm1d(
                    width, eps=bn_epsilon, momentum=0.01, device=device))
            self.add_module(f"Dense_{i}", nn.Linear(width, out, device=device))
            width = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.units)
        for i in range(n):
            if self.use_bn:
                x = getattr(self, f"BatchNorm_{i}")(x)
            x = getattr(self, f"Dense_{i}")(x)
            x = self.final_act(x) if i == n - 1 else self.act(x)
            if self.drop is not None:
                x = self.drop(x)
        return x


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)
