"""Sample-weighted loss variants (the counterpart of
`recommendflow_tpu/losses/weighted.py`). Each takes (y_true, query, doc) as
a Networks.loss does, and optional per-sample weights (uniform when None)."""
from __future__ import annotations

import torch


def _default_weights(weights, y_true):
    return torch.ones_like(y_true) if weights is None else weights


def weighted_mean_squared_error(y_true, query, doc, weights=None):
    weights = _default_weights(weights, y_true)
    pred = torch.sum(query * doc, dim=1)
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    return torch.sum(w * (y_true - pred) ** 2)


def weighted_binary_cross_entropy(y_true, query, doc, weights=None):
    weights = _default_weights(weights, y_true)
    eps = 1e-7
    pred = torch.clamp(torch.sum(query * doc, dim=1), eps, 1 - eps)
    w = weights / torch.clamp(torch.sum(weights), min=1e-12)
    return torch.sum(-w * (y_true * torch.log(pred)
                           + (1 - y_true) * torch.log(1 - pred)))


def weighted_cosent_loss(y_true, query, doc, weights=None,
                         scale: float = 20.0):
    """CoSENT with per-pair weights w_i*w_j scaling each pair's exp term
    (exp(diff)*w_ij == exp(diff + log w_ij))."""
    weights = _default_weights(weights, y_true)
    pred = torch.sum(query * doc, dim=1)
    order = y_true[:, None] < y_true[None, :]
    diff = (pred[:, None] - pred[None, :]) * scale
    logw = torch.log(torch.clamp(weights, min=1e-12))
    pair_logw = logw[:, None] + logw[None, :]
    logits = torch.where(order, diff + pair_logw,
                         torch.full_like(diff, -1e9)).reshape(-1)
    logits = torch.cat([torch.zeros((1,), dtype=pred.dtype,
                                    device=pred.device), logits])
    return torch.logsumexp(logits, dim=0)
