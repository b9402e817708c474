"""Matching / retrieval losses: the in-batch negative-sampling family (the
counterpart of `recommendflow_tpu/losses/match.py`).

Contract `loss(y_true, query, doc) -> scalar`: query/doc are L2-normalized
tower embeddings [B, D], y_true is [B]. The negatives of a query are the
other docs of its batch.

Data parallel: every in-batch loss takes `axis_name`, an axis of the
current mesh (parallel/mesh.py) over which each rank holds its own rows of
a global batch. The docs (and a logQ correction's log-probabilities) are
all-gathered over that axis's process group, so the negative pool is the
GLOBAL batch, and each rank's positives sit at rank * B + arange(B). The
value every rank returns is the global batch's loss (a mean over the axis
of the per-rank means, or a sum of sums). Gradients flow back through the
all-gather (parallel/distributed.py): each rank's gradient of its inputs is
the axis size times its share of the global loss's gradient.

Numerics: logsumexp-based forms throughout; masked entries take -1e9.
"""
from __future__ import annotations

import functools
import inspect
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from recommendflow_tpu_torch.parallel.distributed import (all_gather,
                                                          all_reduce_nograd,
                                                          all_reduce_sum)
from recommendflow_tpu_torch.parallel.mesh import axis_group

MASK = -1e9


def _gather_negatives(query, doc, axis_name: Optional[str]):
    """(doc_all [Bg, D], pos_idx [B]) for the global batch. Labels are not
    gathered: every loss weights by its own rows' y_true."""
    b = query.shape[0]
    pos = torch.arange(b, device=query.device)
    if axis_name is None:
        return doc, pos
    group, rank, _ = axis_group(axis_name)
    return all_gather(doc, group), rank * b + pos


def _mean_over_axis(value, axis_name: Optional[str]):
    """pmean: the mean of every rank's value."""
    if axis_name is None:
        return value
    group, _, n = axis_group(axis_name)
    return all_reduce_sum(value, group) / n


def _sum_over_axis(value, axis_name: Optional[str]):
    """psum: the sum of every rank's value."""
    if axis_name is None:
        return value
    return all_reduce_sum(value, axis_group(axis_name)[0])


def _pick(x, pos):
    """x[i, pos[i]] of a [B, Bg] matrix -> [B]."""
    return x.gather(1, pos[:, None])[:, 0]


def _lse(x):
    """logsumexp over all entries of a 1-D vector."""
    return torch.logsumexp(x, dim=0)


# ------------------------------------------------------------ pointwise
def mean_squared_error(y_true, query, doc):
    """MSE on dot(query, doc)."""
    pred = torch.sum(query * doc, dim=1)
    return torch.mean((y_true - pred) ** 2)


def binary_cross_entropy(y_true, query, doc, from_logits: bool = False):
    """BCE on dot(query, doc)."""
    pred = torch.sum(query * doc, dim=1)
    if from_logits:
        return torch.mean(torch.clamp(pred, min=0) - pred * y_true +
                          torch.log1p(torch.exp(-torch.abs(pred))))
    eps = 1e-7
    pred = torch.clamp(pred, eps, 1 - eps)
    return torch.mean(-(y_true * torch.log(pred)
                        + (1 - y_true) * torch.log(1 - pred)))


# --------------------------------------------------------------- CoSENT
def _cosent_logits(logits):
    """[0] ++ flattened pair logits, for the CoSENT logsumexp."""
    return torch.cat([logits.new_zeros(1), logits.reshape(-1)])


def cosent_loss_from_scores(y_true, y_pred, scale: float = 20.0):
    """CoSENT on precomputed cosine scores: log(1 + sum over pairs
    (i, j) with t_i < t_j of exp(s * (cos_i - cos_j)))."""
    order = y_true[:, None] < y_true[None, :]
    diff = (y_pred[:, None] - y_pred[None, :]) * scale
    return _lse(_cosent_logits(torch.where(order, diff, MASK)))


def cosent_loss(y_true, query, doc, scale: float = 20.0):
    """CoSENT on cos(query, doc)."""
    return cosent_loss_from_scores(y_true, torch.sum(query * doc, dim=1),
                                   scale)


def cosent_loss_v2(y_true, query, doc, scale: float = 20.0):
    """CoSENT dropping already-satisfied pairs (diff <= 0 masked)."""
    pred = torch.sum(query * doc, dim=1)
    order = y_true[:, None] < y_true[None, :]
    diff = (pred[:, None] - pred[None, :]) * scale
    return _lse(_cosent_logits(torch.where(order & (diff > 0), diff, MASK)))


def _masked_cosent_v2(aux_true, pred, member, scale):
    """cosent_v2 over the subset `member` (bool [B]) by pair masking."""
    pair_ok = member[:, None] & member[None, :]
    order = aux_true[:, None] < aux_true[None, :]
    diff = (pred[:, None] - pred[None, :]) * scale
    return _lse(_cosent_logits(
        torch.where(pair_ok & order & (diff > 0), diff, MASK)))


def aux_label_cosent_loss(y_true, aux_true, query, doc,
                          scale: float = 20.0, alpha: float = 0.5):
    """CoSENT on an auxiliary business label, over positives and negatives
    separately, then mixed."""
    pred = torch.sum(query * doc, dim=1)
    pos = _masked_cosent_v2(aux_true, pred, y_true == 1, scale)
    neg = _masked_cosent_v2(aux_true, pred, y_true == 0, scale)
    return (1 - alpha) * pos + alpha * neg


def pos_aux_label_cosent_loss(y_true, aux_true, query, doc,
                              scale: float = 20.0):
    """Aux-label CoSENT over positives only."""
    pred = torch.sum(query * doc, dim=1)
    return _masked_cosent_v2(aux_true, pred, y_true == 1, scale)


# ------------------------------------------- in-batch negative sampling
def batch_neg_sample_ce_loss(y_true, query, doc,
                             axis_name: Optional[str] = None):
    """Softmax CE of each query against the batch of docs, weighted by
    y_true (scores as logits)."""
    doc_all, pos = _gather_negatives(query, doc, axis_name)
    logp = torch.log_softmax(query @ doc_all.T, dim=-1)
    return _mean_over_axis(torch.mean(-_pick(logp, pos) * y_true), axis_name)


def _column_lse(logits, axis_name: Optional[str] = None):
    """logsumexp over the (global) query axis of [B, Bg] logits -> [Bg].
    Under data parallelism each rank holds its own B query rows: the
    doc->query denominator is assembled with an all-reduce max (the
    stabiliser, no gradient) and an all-reduce sum."""
    col_max = torch.amax(logits, dim=0)
    if axis_name is not None:
        col_max = all_reduce_nograd(col_max, axis_group(axis_name)[0],
                                    op=dist.ReduceOp.MAX)
    sums = torch.sum(torch.exp(logits - col_max[None, :]), dim=0)
    sums = _sum_over_axis(sums, axis_name)
    return col_max + torch.log(sums)


def _symmetric(logits, pos, y_true, axis_name: Optional[str] = None):
    lp_q = torch.log_softmax(logits, dim=-1)
    picked_q = _pick(lp_q, pos)
    picked_d = _pick(logits, pos) - _column_lse(logits, axis_name)[pos]
    return _mean_over_axis(torch.mean(-0.5 * (picked_q + picked_d) * y_true),
                           axis_name)


def batch_neg_sample_symmetrical_ce_loss(y_true, query, doc,
                                         axis_name: Optional[str] = None):
    """Symmetric (query->doc and doc->query) in-batch CE."""
    doc_all, pos = _gather_negatives(query, doc, axis_name)
    return _symmetric(query @ doc_all.T, pos, y_true, axis_name)


def _logq_correct(logits, logq, axis_name: Optional[str]):
    """Sampled-softmax bias correction: subtract each column's doc
    log-probability from its logits. logq [B] is this rank's docs'; under
    data parallelism it is all-gathered to the global column axis."""
    if logq is None:
        return logits
    if axis_name is not None:
        logq = all_gather(logq, axis_group(axis_name)[0])
    return logits - logq[None, :]


def batch_neg_sample_scaled_multi_class_ce_loss(y_true, query, doc,
                                                scale: float = 20.0,
                                                axis_name: Optional[str] = None,
                                                logq=None):
    """Que2Search scaled in-batch softmax: loss_i = -log softmax(s*cos)_ii,
    weighted by y_true; `logq` applies the sampling-bias correction."""
    doc_all, pos = _gather_negatives(query, doc, axis_name)
    logits = _logq_correct(scale * (query @ doc_all.T), logq, axis_name)
    logp = torch.log_softmax(logits, dim=-1)
    return _mean_over_axis(torch.mean(-_pick(logp, pos) * y_true), axis_name)


def batch_neg_sample_symmetrical_scaled_multi_class_ce_loss(
        y_true, query, doc, scale: float = 20.0,
        axis_name: Optional[str] = None, logq=None):
    """Symmetric Que2Search loss (the stated formula, scaled once)."""
    doc_all, pos = _gather_negatives(query, doc, axis_name)
    logits = _logq_correct(scale * (query @ doc_all.T), logq, axis_name)
    return _symmetric(logits, pos, y_true, axis_name)


def batch_neg_sample_margin_rank_loss(y_true, query, doc, margin: float = 0.1,
                                      axis_name: Optional[str] = None):
    """Margin ranking against every in-batch negative:
    sum_j max(0, -(cos_ii - cos_ij) + margin) * y_i, the positive column
    masked out."""
    doc_all, pos = _gather_negatives(query, doc, axis_name)
    scores = query @ doc_all.T
    pos_score = scores.gather(1, pos[:, None])
    viol = torch.clamp(-(pos_score - scores) + margin, min=0.0)
    viol = viol * (1.0 - F.one_hot(pos, scores.shape[1]).to(viol.dtype))
    return _sum_over_axis(torch.sum(viol * y_true[:, None]), axis_name)


def batch_hard_neg_sample_margin_rank_loss(y_true, query, doc,
                                           margin: float = 0.1,
                                           axis_name: Optional[str] = None):
    """Hardest-in-batch negative margin loss (Que2Search stage 2)."""
    doc_all, pos = _gather_negatives(query, doc, axis_name)
    scores = query @ doc_all.T
    pos_score = _pick(scores, pos)
    is_pos_col = F.one_hot(pos, scores.shape[1]).bool()
    hard_neg = torch.amax(torch.where(is_pos_col, MASK, scores), dim=-1)
    return _sum_over_axis(torch.sum(
        torch.clamp(-(pos_score - hard_neg) + margin, min=0.0) * y_true),
        axis_name)


def batch_softmax_probabilistic_combining_soft(batch_size: int,
                                               miu: float = 0.6):
    """Soft pseudo-positive probabilistic combining: off-diagonal cosines
    above 1/batch while the true positive is weak (< miu) count as extra
    positives."""
    xi = 1.0 / batch_size

    def loss_fn(y_true, query, doc, axis_name: Optional[str] = None):
        doc_all, pos = _gather_negatives(query, doc, axis_name)
        scores = query @ doc_all.T
        pos_score = _pick(scores, pos)
        is_pos_col = F.one_hot(pos, scores.shape[1]).bool()
        pseudo_ok = (~is_pos_col) & (scores >= xi) & (pos_score < miu)[:, None]
        num = torch.where(is_pos_col | pseudo_ok, scores, MASK)
        log_num = torch.logsumexp(num, dim=-1)
        log_den = torch.logsumexp(scores, dim=-1)
        return _mean_over_axis(torch.mean(-(log_num - log_den) * y_true),
                               axis_name)

    return loss_fn


# ------------------------------------------------------- zipped adapters
def unzip_embedding(y_pred):
    """Interleaved [q0; d0; q1; d1; ...] rows -> (query, doc), L2-normalized."""
    q, d = y_pred[0::2], y_pred[1::2]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True),
                        min=1e-12)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True),
                        min=1e-12)
    return q, d


def _zipped(core):
    def wrapped(y_true, y_pred, **kw):
        q, d = unzip_embedding(y_pred)
        return core(y_true, q, d, **kw)
    wrapped.__name__ = "zipped_" + core.__name__
    return wrapped


zipped_mean_squared_error = _zipped(mean_squared_error)
zipped_binary_cross_entropy = _zipped(binary_cross_entropy)
zipped_cosent_loss = _zipped(cosent_loss)
zipped_cosent_loss_v2 = _zipped(cosent_loss_v2)
zipped_batch_neg_sample_ce_loss = _zipped(batch_neg_sample_ce_loss)
zipped_batch_neg_sample_scaled_multi_class_ce_loss = _zipped(
    batch_neg_sample_scaled_multi_class_ce_loss)
zipped_batch_neg_sample_margin_rank_loss = _zipped(
    batch_neg_sample_margin_rank_loss)


def global_batch_loss(loss_fn: Callable, axis_name: str) -> Callable:
    """`loss_fn` as the global batch sees it, called by a rank that holds
    its own rows of that batch on `axis_name`: an in-batch loss (one with
    an `axis_name` parameter) takes its axis path; any other loss
    (pointwise, CoSENT, a zipped adapter) gets every tensor argument
    all-gathered, so that every rank computes the global batch's value."""
    if "axis_name" in inspect.signature(loss_fn).parameters:
        return functools.partial(loss_fn, axis_name=axis_name)

    def gathered(*args, **kwargs):
        group = axis_group(axis_name)[0]

        def g(x):
            return all_gather(x, group) \
                if isinstance(x, torch.Tensor) and x.dim() >= 1 else x
        return loss_fn(*map(g, args), **{k: g(v) for k, v in kwargs.items()})
    return gathered
