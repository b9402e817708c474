"""Model inference over a dataset (the counterpart of
`recommendflow_tpu/train/trainer.py:Trainer.predict`). The trainer itself
arrives with the training slice.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Union

import numpy as np
import torch

from recommendflow_tpu_torch.data.pipeline import prefetch
from recommendflow_tpu_torch.device import resolve_device


def to_device(batch: Mapping[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A host numpy batch -> tensors on `device` (copied asynchronously from
    pinned memory when the device is a card)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def predict(model: torch.nn.Module, dataset: Iterable[Mapping[str, np.ndarray]],
            device: Union[str, torch.device] = "cuda") -> Dict[str, np.ndarray]:
    """Stacked model outputs over a dataset of host batches, as numpy.

    The model runs in eval mode under no_grad on `device` (default "cuda";
    raises without a card unless "cpu" is asked for). Host batches are
    prepared in a background thread (data.pipeline.prefetch) while the card
    runs; outputs stay on the device until the end, so the host does not
    wait on the card batch by batch."""
    dev = resolve_device(device)
    model.eval()
    chunks: Dict[str, List[torch.Tensor]] = {}
    with torch.no_grad():
        for batch in prefetch(iter(dataset)):
            out = model(to_device(batch, dev))
            for k, v in out.items():
                chunks.setdefault(k, []).append(v)
    return {k: torch.cat(v).cpu().numpy() for k, v in chunks.items()}
