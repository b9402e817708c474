"""Device resolution: the CUDA card unless the caller asks for the CPU.

An entry point that was meant for the card and silently ran on the CPU would
report CPU numbers under a device's name, so a missing card is an error here,
never a fallback.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE
                   ) -> torch.device:
    """'cuda' / 'cuda:1' / 'cpu' / torch.device -> torch.device.

    Raises RuntimeError for a CUDA device when no card (or no card of that
    index) is visible."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{dev}' requested but no CUDA device is visible; pass "
            f"device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{dev}' (cuda or cpu)")
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device '{dev}' requested but only "
                           f"{torch.cuda.device_count()} CUDA device(s) exist")
    return dev
