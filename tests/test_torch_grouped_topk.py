"""Kernel 2's plain version against the Pallas grouped_score_max in interpret
mode, at the shapes of test_grouped_topk_kernel.py: f32 and bf16 corpora, ip
and l2 (rtol 1e-5, atol 1e-4: the same f32 dot products summed in another
order; bf16 queries are rounded the same way on both sides)."""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_parity as tp  # noqa: F401  (pins torch threads)
from recommendflow_tpu.ops.pallas.grouped_topk import grouped_score_max as pallas
from recommendflow_tpu_torch.interop import to_tensor
from recommendflow_tpu_torch.ops.cuda.grouped_topk import (
    NEG, grouped_score_max, grouped_score_max_plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l2", [False, True])
def test_plain_matches_pallas_interpret(dtype, l2):
    rng = np.random.RandomState(0)
    G = 16
    n, d, q = 128 * G * 2, 128, 8          # two Pallas item blocks
    num_items = n - 300                    # partial boundary group masked
    qs = rng.randn(q, d).astype(np.float32)
    vec = rng.randn(n, d).astype(np.float32)
    if dtype == "bfloat16":
        vec = vec.astype(ml_dtypes.bfloat16)
    vf = np.asarray(vec).astype(np.float32)
    sqn = (vf ** 2).sum(-1).astype(np.float32) if l2 else None
    ref = np.asarray(pallas(jnp.asarray(qs), jnp.asarray(vec),
                            jnp.asarray(sqn) if l2 else None, group=G,
                            num_items=num_items, interpret=True)).T
    args = (torch.from_numpy(qs), to_tensor(vec),
            torch.from_numpy(sqn) if l2 else None)
    got = grouped_score_max_plain(*args, group=G, num_items=num_items)
    assert got.shape == (q, n // G) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(grouped_score_max(*args, group=G, num_items=num_items), got)
    # masked tail: groups wholly past num_items are NEG
    assert float(got[:, -1].max()) == pytest.approx(NEG)
