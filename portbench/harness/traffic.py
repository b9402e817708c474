"""The one traffic generator: batches, request pools, the sample of
answers that is checked and the item catalogue, all drawn from the run's
seed and the parameters of a traffic file (`portbench/traffic/<mix>.json`).

`zipf_batch` is a frozen copy of the repository's
`data/synthetic.py:synthetic_batch`: the same draws in the same order
(sparse ids Zipf-distributed and folded into the feature's rows, dense
fields uniform, labels a fair coin), read from the benchmark's own
layout of the configuration instead of the program's schema.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from portbench.reference.common import seed_generator, splitmix64
from portbench.reference.layout import Layout

def substream(seed: int, *salt: int) -> int:
    """A 32-bit seed for one use of the run's seed (any whole number)."""
    z = int(seed) & ((1 << 64) - 1)
    for s in salt:
        z = splitmix64(z ^ (s * 0x9E3779B97F4A7C15 & ((1 << 64) - 1)))
    return z & 0xFFFFFFFF


def zipf_batch(layout: Layout, batch_size: int, seed: int,
               zipf: float = 0.0) -> Dict[str, np.ndarray]:
    """One batch in the program's batch layout: sparse ids [B, H, L] int32
    (Zipf(zipf) folded into the rows when zipf > 1, else uniform), dense
    fields [B, L] float32 uniform, labels [B] float32 0/1."""
    rng = np.random.RandomState(seed)
    batch = {}
    for f in layout.features:
        if f["kind"] == "sparse":
            shape = (batch_size, f["hashes"], f["max_len"])
            if zipf and zipf > 1.0:
                ids = (rng.zipf(zipf, size=shape) - 1) % f["rows"]
                batch[f["name"]] = ids.astype(np.int32)
            else:
                batch[f["name"]] = rng.randint(0, f["rows"], size=shape
                                               ).astype(np.int32)
        elif f["kind"] == "dense":
            batch[f["name"]] = rng.rand(batch_size, f["max_len"]).astype(np.float32)
        else:
            raise ValueError(f"feature kind {f['kind']!r} has no generator")
    for name in layout.labels:
        batch[name] = (rng.rand(batch_size) > 0.5).astype(np.float32)
    return batch


def batch_pool(layout: Layout, rows: int, count: int, seed: int,
               zipf: float) -> List[Dict[str, np.ndarray]]:
    """`count` batches of `rows` rows, each from its own substream."""
    return [zipf_batch(layout, rows, substream(seed, 1, i), zipf)
            for i in range(count)]


class Reservoir:
    """A sample of `k` answered requests, drawn from the seed, uniform over
    however many the window answers (Algorithm R): `offer` every answer as
    it comes, read `kept` ({request index: (pool index, answer)}) after the
    window."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = np.random.default_rng(substream(seed, 3))
        self.seen = 0
        self.slots: List = []

    def offer(self, index: int, item) -> None:
        if len(self.slots) < self.k:
            self.slots.append((index, item))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.slots[j] = (index, item)
        self.seen += 1

    @property
    def kept(self) -> Dict:
        return dict(self.slots)


def catalogue(n: int, dim: int, centres: int, noise: float, seed: int,
              device: torch.device) -> torch.Tensor:
    """[n, dim] float32 item vectors on `device`: a mixture of `centres`
    Gaussian centres N(0, 1) with N(0, noise^2) around each, made on the
    device in a few calls."""
    gen = seed_generator(seed, device, 3)
    c = torch.randn((centres, dim), generator=gen, device=device)
    cid = torch.randint(0, centres, (n,), generator=gen, device=device)
    return c[cid] + noise * torch.randn((n, dim), generator=gen, device=device)


def to_features_only(batch: Mapping[str, np.ndarray], labels: Sequence[str]
                     ) -> Dict[str, np.ndarray]:
    return {k: v for k, v in batch.items() if k not in labels}
