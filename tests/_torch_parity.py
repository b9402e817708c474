"""Shared helpers for the recommendflow_tpu_torch parity tests.

Both packages run in one CPU process: JAX is pinned to the CPU by
conftest.py, torch to one thread here (the tier-1 run uses several xdist
workers). Inputs are built with numpy from a seed and handed to both sides.
"""
import os

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DEMO_CONF = os.path.join(ROOT, "conf", "demo_recall.yaml")
BENCH_CONF = os.path.join(ROOT, "conf", "bench_recall.yaml")


def conf_pair(path=DEMO_CONF, networks=None):
    """The same YAML loaded by both packages, with optional Networks
    overrides applied to both."""
    from recommendflow_tpu.config import Configuration as JConf
    from recommendflow_tpu_torch.config import Configuration as TConf
    jc, tc = JConf(path), TConf(path)
    for k, v in (networks or {}).items():
        jc.networks[k] = v
        tc.networks[k] = v
    return jc, tc


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def to_jax(batch):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch.items()}


def bf16_bits(x) -> np.ndarray:
    """uint16 bit pattern of a bf16 array from either side."""
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)
