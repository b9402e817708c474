"""SimBERT training objective on the TextEncoder: UniLM seq2seq plus
in-batch CLS similarity (the counterpart of
`recommendflow_tpu/encoder/simbert.py`).

A similar-sentence pair (t1, t2) is packed as [CLS] t1 [SEP] t2 [SEP] in
both orders (`encoder/generators.py:simbert_batches`); the model trains on
  1. a seq2seq LM loss: each segment-1 token is predicted from the
     UniLM-masked hidden state of the PREVIOUS position, with the logits
     tied to the token embedding table, and
  2. an in-batch similarity loss over the CLS vectors: rows 2i and 2i+1 are
     mutual positives, every other row of the batch a negative.

The LM head keeps the JAX package's maths: it scores every position against
the whole vocabulary, then masks. At BERT-Base width (vocab 21,128) and a
[128, 128] batch that is a [128, 127, 21128] f32 logit tensor, 1.37 GB, and
its log-softmax another as large, both held for the backward.

Training mode follows the model's `train()`/`eval()` state. Dropout draws
from the default generator of the model's device, which `seed=` sets before
the pass (the counterpart of JAX's `rngs`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def unilm_lm_loss(hidden: torch.Tensor, tok_embedding: torch.Tensor,
                  token_ids: torch.Tensor,
                  segment_ids: torch.Tensor) -> torch.Tensor:
    """Seq2seq LM loss under the UniLM mask.

    hidden: [B, L, D] from TextEncoder(..., seq2seq=True,
    return_sequence=True); tok_embedding: [V, D] (the logits are
    hidden @ E^T). Predicts token_ids[:, t] for every position t whose
    segment id is 1 and whose token is real (the target sentence, its final
    [SEP] included) from hidden[:, t-1]. Mean over the predicted tokens."""
    logits = torch.einsum("bld,vd->blv", hidden[:, :-1], tok_embedding)
    targets = token_ids[:, 1:].long()
    want = (segment_ids[:, 1:] == 1) & (targets > 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    w = want.to(nll.dtype)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def simbert_similarity_loss(cls_vecs: torch.Tensor,
                            scale: float = 30.0) -> torch.Tensor:
    """In-batch CLS similarity over [2B, D]: L2-normalised rows, scaled dot
    products, self-similarity at -1e9, softmax cross-entropy toward the
    partner row i ^ 1."""
    if cls_vecs.shape[0] % 2:
        raise ValueError("simbert similarity needs paired rows [2B, D] "
                         f"(2i <-> 2i+1), got {cls_vecs.shape[0]} rows")
    v = cls_vecs / torch.clamp(
        torch.linalg.norm(cls_vecs, dim=-1, keepdim=True), min=1e-12)
    sims = (v @ v.T) * scale
    n = sims.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=sims.device)
    sims = sims.masked_fill(eye, -1e9)
    partner = torch.arange(n, device=sims.device) ^ 1
    logp = torch.log_softmax(sims, dim=-1)
    return -torch.mean(torch.gather(logp, 1, partner[:, None]))


def simbert_loss(model, batch: Dict[str, torch.Tensor],
                 lm_weight: float = 1.0, sim_weight: float = 1.0,
                 seed: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The SimBERT objective of one `simbert_batches` batch ({'tok', 'seg'}
    [2B, L], on the model's device): (loss, {'lm_loss', 'sim_loss'}) from one
    UniLM-masked pass. The CLS vectors are hidden[:, 0] of that pass: under
    the UniLM mask every segment-0 position attends only segment-0 keys, so
    row 2i's CLS encodes exactly t1 and row 2i+1's exactly t2."""
    tok, seg = batch["tok"], batch["seg"]
    if seed is not None:
        from recommendflow_tpu_torch.train.trainer import device_generator
        device_generator(model.tok_emb.weight.device).manual_seed(int(seed))
    hidden = model(tok, seg, seq2seq=True, return_sequence=True)
    lm = unilm_lm_loss(hidden, model.tok_emb.weight, tok, seg)
    sim = simbert_similarity_loss(hidden[:, 0])
    loss = lm_weight * lm + sim_weight * sim
    return loss, {"lm_loss": lm, "sim_loss": sim}
