"""Matching / retrieval losses: the in-batch negative-sampling family (the
counterpart of `recommendflow_tpu/losses/match.py`).

Contract `loss(y_true, query, doc) -> scalar`: query/doc are L2-normalized
tower embeddings [B, D], y_true is [B]. The negatives of a query are the
other docs of its batch, on one card: an `axis_name` (the JAX package's
data-parallel gather of the global batch) raises NotImplementedError until
the parallel slice.

Numerics: logsumexp-based forms throughout; masked entries take -1e9.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

MASK = -1e9


def _gather_negatives(query, doc, axis_name: Optional[str]):
    """(doc_all [B, D], pos_idx [B]) for the batch on this card."""
    if axis_name is not None:
        raise NotImplementedError(
            "axis_name (in-batch negatives gathered across cards) arrives "
            "with the parallel slice (ROADMAP Queue 1: parallel)")
    return doc, torch.arange(query.shape[0], device=query.device)


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
    return torch.mean(-_pick(logp, pos) * y_true)


def _column_lse(logits):
    """logsumexp over the query axis of [B, Bg] logits -> [Bg]."""
    col_max = torch.amax(logits, dim=0)
    sums = torch.sum(torch.exp(logits - col_max[None, :]), dim=0)
    return col_max + torch.log(sums)


def _symmetric(logits, pos, y_true):
    lp_q = torch.log_softmax(logits, dim=-1)
    picked_q = _pick(lp_q, pos)
    picked_d = _pick(logits, pos) - _column_lse(logits)[pos]
    return torch.mean(-0.5 * (picked_q + picked_d) * y_true)


def batch_neg_sample_symmetrical_ce_loss(y_true, query, doc,
                                         axis_name: Optional[str] = None):
    """Symmetric (query->doc and doc->query) in-batch CE."""
    doc_all, pos = _gather_negatives(query, doc, axis_name)
    return _symmetric(query @ doc_all.T, pos, y_true)


def _logq_correct(logits, logq, axis_name: Optional[str]):
    """Sampled-softmax bias correction: subtract each column's doc
    log-probability (logq [B]) from its logits."""
    if logq is None:
        return logits
    if axis_name is not None:
        raise NotImplementedError("axis_name arrives with the parallel slice")
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
    return torch.mean(-_pick(logp, pos) * y_true)


def batch_neg_sample_symmetrical_scaled_multi_class_ce_loss(
        y_true, query, doc, scale: float = 20.0,
        axis_name: Optional[str] = None, logq=None):
    """Symmetric Que2Search loss (the stated formula, scaled once)."""
    doc_all, pos = _gather_negatives(query, doc, axis_name)
    logits = _logq_correct(scale * (query @ doc_all.T), logq, axis_name)
    return _symmetric(logits, pos, y_true)


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
    return torch.sum(viol * y_true[:, None])


def batch_hard_neg_sample_margin_rank_loss(y_true, query, doc,
                                           margin: float = 0.1,
                                           axis_name: Optional[str] = None):
    """Hardest-in-batch negative margin loss (Que2Search stage 2)."""
    doc_all, pos = _gather_negatives(query, doc, axis_name)
    scores = query @ doc_all.T
    pos_score = _pick(scores, pos)
    is_pos_col = F.one_hot(pos, scores.shape[1]).bool()
    hard_neg = torch.amax(torch.where(is_pos_col, MASK, scores), dim=-1)
    return torch.sum(torch.clamp(-(pos_score - hard_neg) + margin, min=0.0)
                     * y_true)


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
        return torch.mean(-(log_num - log_den) * y_true)

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
