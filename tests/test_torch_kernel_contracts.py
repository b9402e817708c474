"""The identities the CUDA kernels' designs rely on, held on the CPU by the
kernels' plain versions, against the JAX package where it computes the same.

* flash_attention (kernel 6) may skip a key step whose keys are all masked,
  for a batch row that has a valid key: with the vanilla -1e9 fill such a
  key's weight exp(-1e9 - m) is +0 in f32 once a real score sets the max m,
  and adding +0 changes no sum. So `flash_attention_plain` with the wholly
  masked key blocks dropped equals it with them kept, and both equal the JAX
  vanilla SDPA; within 2e-6 absolute (f32 softmax sums of another length
  add in another order), and the masked weights are exactly +0.
* grouped_score_max's bf16 and uint8 forms (kernels 5-bf16 and 5u) run on
  bf16 tensor cores with f32 sums: bf16 queries times codes <= 255, or
  times bf16 values, are exact in f32 (8 + 8 significant bits), so the f32
  sum of the products equals the f64 sum of the same products within f32
  rounding: D roundings of at most 2^-24 of the running |sum| each, so
  |f32 - f64| <= D * 2^-24 * sum|products|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)

from recommendflow_tpu.ops import attention as jatt
from recommendflow_tpu_torch.ops.cuda import flash_attention as kfa
from recommendflow_tpu_torch.ops.cuda import grouped_topk as kgt

STEP = 64          # keys per online-softmax step of the kernel


def _masked_blocks_case(seed, lk, d, dtype):
    rng = np.random.RandomState(seed)
    b, h, lq = 4, 2, 9
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))
    mask = rng.rand(b, lk) > 0.3
    n_steps = -(-lk // STEP)
    # whole steps masked: the first in row 0, every other one in row 1, all
    # but the last in row 2; row 3 keeps its random holes
    mask[0, :STEP] = False
    for s in range(0, n_steps, 2):
        mask[1, s * STEP:(s + 1) * STEP] = False
    mask[2, :(n_steps - 1) * STEP] = False
    mask[:, -1] = True                     # every row has a valid key
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return (q, k, v, mask), t, torch.from_numpy(mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lk,d", [(200, 16), (256, 8), (129, 32), (330, 64)])
@pytest.mark.parametrize("seed", [0, 1])
def test_dropping_wholly_masked_key_steps_changes_nothing(seed, lk, d, dtype):
    (q, k, v, mask), (tq, tk, tv), tm = _masked_blocks_case(seed, lk, d, dtype)
    full = kfa.flash_attention_plain(tq, tk, tv, tm)
    for r in range(mask.shape[0]):
        keep = np.ones(lk, dtype=bool)
        for s in range(0, lk, STEP):
            if not mask[r, s:s + STEP].any():
                keep[s:s + STEP] = False
        assert keep.sum() < lk or r == 3
        dropped = kfa.flash_attention_plain(
            tq[r:r + 1], tk[r:r + 1, :, keep], tv[r:r + 1, :, keep],
            tm[r:r + 1, keep])
        np.testing.assert_allclose(dropped.float().numpy(),
                                   full[r:r + 1].float().numpy(), rtol=0,
                                   atol=2e-6 if dtype == torch.float32 else 0.0)
    if dtype == torch.float32:
        ref = jatt.scaled_dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask[:, None]))
        np.testing.assert_allclose(full.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("d", [8, 64, 128])
def test_masked_weights_are_exactly_zero_once_a_real_key_sets_the_max(d):
    rng = np.random.RandomState(d)
    q = torch.from_numpy(rng.randn(1, 1, 5, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 1, 70, d).astype(np.float32))
    s = (q @ k.transpose(-1, -2))[0, 0] / np.sqrt(d)
    mask = torch.from_numpy(rng.rand(70) > 0.5)
    mask[3] = True
    s = s.masked_fill(~mask, kfa.NEG_INF)
    m = s.max(dim=-1, keepdim=True).values
    w = torch.exp(s - m)
    assert bool((w[:, ~mask] == 0).all())
    assert not bool(torch.signbit(w[:, ~mask]).any())
    # the kernel's form: exp2 of scores pre-scaled by log2(e)
    w2 = torch.exp2(s * np.log2(np.e) - m * np.log2(np.e))
    assert bool((w2[:, ~mask] == 0).all())
    # a row with every key masked: all weights 1, the mean of v
    allm = torch.full((70,), kfa.NEG_INF)
    assert bool((torch.exp2((allm - allm.max()) * np.log2(np.e)) == 1).all())


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("corpus", ["uint8", "bfloat16"])
@pytest.mark.parametrize("d", [7, 40, 128, 129, 256])
def test_bf16_products_are_exact_and_f32_sums_within_rounding(corpus, d):
    rng = np.random.RandomState(d)
    q = _bf16(rng.randn(33, d).astype(np.float32) * 0.05)
    if corpus == "uint8":
        v = torch.from_numpy(rng.randint(0, 256, (320, d)).astype(np.uint8))
        v[0] = 255
    else:
        v = _bf16(rng.randn(320, d).astype(np.float32))
    prods32 = q.float()[:, None, :] * v.float()[None, :, :]
    prods64 = q.double()[:, None, :] * v.double()[None, :, :]
    assert torch.equal(prods32.double(), prods64)            # exact in f32
    # the plain version's f32 sums against the f64 sums of the same products
    m1 = kgt.grouped_score_max_plain(q.float(), v, None, group=16,
                                     num_items=320)
    ref = prods64.sum(-1).view(33, 20, 16).amax(-1)
    bound = d * 2.0 ** -24 * prods64.abs().sum(-1).view(33, 20, 16).amax(-1)
    assert bool(((m1.double() - ref).abs() <= bound).all())


@pytest.mark.parametrize("d", [16, 128])
def test_query_operand_is_the_bf16_rounding_for_tensor_core_forms(d):
    """The wrapper hands the bf16 and uint8 forms the queries as a bf16
    tensor; its values are the f32 operand the plain version multiplies."""
    rng = np.random.RandomState(d)
    q = torch.from_numpy(rng.randn(9, d).astype(np.float32))
    for corpus in (torch.zeros((4, d), dtype=torch.uint8),
                   torch.zeros((4, d), dtype=torch.bfloat16)):
        op = kgt._query_operand(q, corpus)
        assert op.dtype == torch.float32
        assert torch.equal(op.to(torch.bfloat16).float(), op)
        assert torch.equal(op, q.to(torch.bfloat16).float())
    assert torch.equal(kgt._query_operand(q, torch.zeros((4, d))), q)
