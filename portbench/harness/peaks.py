"""Published peaks of one NVIDIA H100 (NVIDIA's data sheet, dense rates
without sparsity, at the full power limit): bytes/s of HBM, FLOP/s in
float32 outside the tensor cores, FLOP/s in bf16. Chosen by the card's
name as `torch.cuda.get_device_name()` gives it."""
from __future__ import annotations

from typing import Dict

PEAKS = {"PCIe": {"bytes_per_s": 2.0e12, "f32_flops": 51.2e12, "bf16_flops": 756e12},
         "NVL": {"bytes_per_s": 3.9e12, "f32_flops": 60.0e12, "bf16_flops": 835e12},
         "SXM": {"bytes_per_s": 3.35e12, "f32_flops": 67.0e12, "bf16_flops": 989e12}}


def peaks_of(name: str) -> Dict[str, float]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]
