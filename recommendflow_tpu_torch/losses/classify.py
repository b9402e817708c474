"""Classification losses (the counterpart of
`recommendflow_tpu/losses/classify.py`), in logits space where the JAX
package is."""
from __future__ import annotations

import torch

MASK = -1e9
EPS = 1e-7


def multilabel_categorical_crossentropy(y_true, y_pred):
    """Multilabel CE over raw logits (kexue.fm/archives/7359). y_true in
    {0, 1}, same shape as y_pred; no sigmoid or softmax on y_pred: predict
    the classes where y_pred > 0."""
    y_pred = (1 - 2 * y_true) * y_pred
    pred_neg = torch.where(y_true > 0, torch.full_like(y_pred, MASK), y_pred)
    pred_pos = torch.where(y_true > 0, y_pred, torch.full_like(y_pred, MASK))
    zeros = torch.zeros_like(y_pred[..., :1])
    neg_loss = torch.logsumexp(torch.cat([pred_neg, zeros], dim=-1), dim=-1)
    pos_loss = torch.logsumexp(torch.cat([pred_pos, zeros], dim=-1), dim=-1)
    return neg_loss + pos_loss


def sparse_multilabel_categorical_crossentropy(y_true, y_pred,
                                               mask_zero: bool = False):
    """Sparse multilabel CE: y_true [..., num_positive] holds positive class
    ids, y_pred [..., num_classes] raw logits (mask_zero treats class 0 as a
    padding label)."""
    y_true = y_true.long()
    zeros = torch.zeros_like(y_pred[..., :1])
    y_pred = torch.cat([y_pred, zeros], dim=-1)
    if mask_zero:
        inf_col = zeros + 1e12
        y_pred = torch.cat([inf_col, y_pred[..., 1:]], dim=-1)
    y_pos_2 = torch.gather(y_pred, -1, y_true)
    y_pos_1 = torch.cat([y_pos_2, zeros], dim=-1)
    if mask_zero:
        y_pred = torch.cat([-inf_col, y_pred[..., 1:]], dim=-1)
        y_pos_2 = torch.gather(y_pred, -1, y_true)
    pos_loss = torch.logsumexp(-y_pos_1, dim=-1)
    all_loss = torch.logsumexp(y_pred, dim=-1)
    aux_loss = torch.logsumexp(y_pos_2, dim=-1) - all_loss
    aux_loss = torch.clamp(1 - torch.exp(aux_loss), EPS, 1.0)
    neg_loss = all_loss + torch.log(aux_loss)
    return pos_loss + neg_loss


def sparse_categorical_crossentropy(y_true, y_pred):
    """Standard sparse softmax CE over logits."""
    logp = torch.log_softmax(y_pred, dim=-1)
    picked = torch.gather(logp, -1, y_true[..., None].long())
    return -torch.mean(picked)


def binary_crossentropy(y_true, y_pred, from_logits: bool = False):
    if from_logits:
        return torch.mean(torch.clamp(y_pred, min=0) - y_pred * y_true +
                          torch.log1p(torch.exp(-torch.abs(y_pred))))
    p = torch.clamp(y_pred, EPS, 1 - EPS)
    return torch.mean(-(y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p)))


def categorical_crossentropy(y_true, y_pred, from_logits: bool = False):
    if from_logits:
        logp = torch.log_softmax(y_pred, dim=-1)
    else:
        logp = torch.log(torch.clamp(y_pred, EPS, 1.0))
    return torch.mean(-torch.sum(y_true * logp, dim=-1))


def categorical_hinge(y_true, y_pred):
    pos = torch.sum(y_true * y_pred, dim=-1)
    neg = torch.amax((1 - y_true) * y_pred - y_true * 1e12, dim=-1)
    return torch.mean(torch.clamp(neg - pos + 1.0, min=0.0))


def binary_focal_loss(y_true, y_score, gamma: float = 2.0, alpha: float = 0.25):
    """Binary focal loss on probabilities."""
    y_true = y_true.float()
    alpha_t = y_true * alpha + (1 - y_true) * (1 - alpha)
    p_t = y_true * y_score + (1 - y_true) * (1 - y_score) + EPS
    return torch.mean(-alpha_t * (1 - p_t) ** gamma * torch.log(p_t))


def categorical_focal_loss(gamma: float = 2.0, alpha: float = 1.0):
    """Multi-class focal loss factory."""
    def focal(y_true, y_pred):
        p = torch.clamp(y_pred, EPS, 1 - EPS)
        ce = -y_true * torch.log(p)
        weight = alpha * torch.abs(y_true - p) ** gamma
        return torch.sum(weight * ce, dim=-1)
    return focal


def categorical_ghm_loss(bins: int = 30, momentum: float = 0.75):
    """Gradient-harmonizing CE. The EMA bin-count state threads explicitly
    through the call:
        loss, new_state = ghm(y_true, y_pred, valid_mask, state)
    where state is the [bins] f32 EMA of per-bin gradient counts
    (`ghm.init_state()` gives the zeros to start from)."""
    # correctly rounded f32 edges, as numpy's f64 linspace cast to f32
    edges = torch.linspace(0.0, 1.0, bins + 1, dtype=torch.float64).float()

    def init_state(device=None):
        return torch.zeros((bins,), dtype=torch.float32, device=device)

    def ghm(y_true, y_pred, valid_mask, state):
        e = edges.to(y_pred.device)
        p = torch.clamp(y_pred, EPS, 1 - EPS)
        gradient = torch.abs(y_true - p)                         # [B, C]
        in_bin = ((gradient[None] >= e[:-1, None, None]) &
                  (gradient[None] < e[1:, None, None])).float()  # [bins, B, C]
        valid_mask = valid_mask.float()
        counts = torch.sum(in_bin * valid_mask[None, :, None], dim=(1, 2))
        new_state = momentum * state + (1 - momentum) * counts
        density = torch.einsum("kbc,k->bc", in_bin, new_state)
        density = density * valid_mask[:, None] + (1 - valid_mask[:, None])
        ce = -y_true * torch.log(p)
        loss = torch.sum(ce / torch.clamp(density, min=1.0), dim=-1)
        # padded rows contribute zero loss and gradient
        return loss * valid_mask, new_state

    ghm.init_state = init_state
    return ghm
