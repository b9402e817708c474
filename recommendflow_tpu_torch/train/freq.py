"""Streaming item-frequency estimation for the sampled-softmax bias
correction (the counterpart of `recommendflow_tpu/train/freq.py`).

In-batch negatives are sampled in proportion to item frequency, which biases
the softmax against popular items; the correction (Yi et al. 2019,
"Sampling-Bias-Corrected Neural Modeling for Large Corpus Item
Recommendations", Algorithm 1) subtracts log p(item) from every logit, with
p estimated online from the stream: for hash bucket h of an item seen at
global step t, keep an EMA of the step interval between consecutive
occurrences, p ~ 1 / interval. Pairs with the `logq=` parameter of the
scaled in-batch losses (losses/match.py).

The state is a dict of tensors on the model's device: int32 `last_step`
and f32 `interval` per bucket. `freq_update` writes it in place with fixed
shapes, so the host never waits for the card.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

FreqState = Dict[str, torch.Tensor]


def freq_init(num_buckets: int = 1 << 20,
              device: Union[str, torch.device] = "cpu") -> FreqState:
    """Per-bucket last-seen step (int32) and EMA'd step interval (f32, 0 =
    never seen)."""
    return {"last_step": torch.zeros(num_buckets, dtype=torch.int32,
                                     device=device),
            "interval": torch.zeros(num_buckets, dtype=torch.float32,
                                    device=device)}


def freq_update(state: FreqState, ids: torch.Tensor,
                step: Union[int, torch.Tensor],
                alpha: float = 0.05) -> FreqState:
    """One stream batch, in place: ids any shape of bucket ids in
    [0, num_buckets), step the current global step (an int or a 0-d int32
    tensor on the device).

    interval[h] <- (1 - a) * interval[h] + a * (step - last_step[h]) (the
    first sighting sets the raw delta); last_step[h] <- step. Duplicate ids
    in one batch collapse to one update: each computes the same values from
    the same old state and writes them. Returns state."""
    ids = ids.reshape(-1).long()
    step = torch.as_tensor(step, dtype=torch.int32,
                           device=state["last_step"].device)
    last = state["last_step"][ids]
    interval = state["interval"][ids]
    delta = torch.clamp(step - last, min=1).to(torch.float32)
    seen = (last > 0) | (interval > 0)
    new_interval = torch.where(seen, (1 - alpha) * interval + alpha * delta,
                               delta)
    state["last_step"].index_put_((ids,), step.expand(ids.shape))
    state["interval"].index_put_((ids,), new_interval)
    return state


def log_q(state: FreqState, ids: torch.Tensor,
          floor: float = 1e-6) -> torch.Tensor:
    """log of the estimated sampling probability per id, p = 1 / interval;
    an unseen id gets log(floor). The shape of ids."""
    interval = state["interval"][ids.reshape(-1).long()]
    p = torch.where(interval > 0, 1.0 / torch.clamp(interval, min=1.0),
                    torch.full_like(interval, floor))
    return torch.log(torch.clamp(p, min=floor)).reshape(ids.shape)
