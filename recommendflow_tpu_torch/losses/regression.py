"""Regression losses (the counterpart of
`recommendflow_tpu/losses/regression.py`)."""
from __future__ import annotations

import torch


def mean_relative_percentage_error(y_true, y_pred):
    return torch.mean(torch.abs((y_true - y_pred)
                                / torch.clamp(torch.abs(y_true), min=1e-7)))


def mean_squared_error(y_true, y_pred):
    return torch.mean((y_true - y_pred) ** 2)


def mean_absolute_error(y_true, y_pred):
    return torch.mean(torch.abs(y_true - y_pred))
