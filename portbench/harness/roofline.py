"""The share of a roofline: the least time the card could take for the
work (the larger of FLOPs over the peak rate and bytes over the memory's
peak bandwidth), over the time the kernels took."""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np


def share(flops: float, nbytes: float, seconds: float,
          peaks: Mapping[str, float], flops_key: str = "f32_flops") -> Optional[float]:
    """Percent of the roofline; None where no kernel time was read."""
    if seconds <= 0:
        return None
    least = max(flops / peaks[flops_key], nbytes / peaks["bytes_per_s"])
    return 100.0 * least / seconds


def distinct(ids: np.ndarray) -> int:
    return int(np.unique(ids).size)


def gather_bytes(layout, batch, itemsize: int) -> float:
    """Bytes that gathering one batch's embedding rows needs, per table:
    each distinct logical row (dim x itemsize) read once, every not-pad
    id's row written once, and the ids (int32) read. The same whatever
    the stored layout packs into a row."""
    total = 0.0
    for d, (gids, valid) in layout.group_ids(batch).items():
        row = d * itemsize
        total += 4 * gids.size + row * distinct(gids) \
            + row * int(np.count_nonzero(valid))
    return total
