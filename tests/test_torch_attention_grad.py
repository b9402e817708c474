"""Kernel 6's gradient: `flash_attention_backward` (the vanilla maths'
gradient in plain torch) against `jax.vjp` of the JAX package's vanilla SDPA
(`recommendflow_tpu/ops/attention.py:scaled_dot_product_attention`, which
the JAX models train through) and against autograd through the port's
`flash_attention_plain`, on the CPU.

Tolerance rtol 1e-5, atol 1e-5: f32 products of a few dozen terms summed in
another order, values of ~1. A query row whose keys are all masked takes the
vanilla gradient: uniform weights over the Lk keys (dV = dO / Lk at every
key), and no gradient into q or k (the -1e9 fill is a constant).

`_FlashAttention` (the card path: the kernel's forward with this backward)
runs here with `launch_flash_attention` replaced by the plain forward, and
its dispatch is checked on meta tensors: with a gradient wanted the card
path goes through it, under no_grad it launches the kernel directly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)

from recommendflow_tpu.ops import attention as jatt
from recommendflow_tpu_torch.ops.cuda import flash_attention as kfa

RTOL, ATOL = 1e-5, 1e-5


def _inputs(b, h, lq, lk, d, seed, all_masked_row=True):
    rng = np.random.RandomState(seed)
    q, k, v, go = (rng.randn(b, h, n, d).astype(np.float32)
                   for n in (lq, lk, lk, lq))
    mask = rng.rand(b, lk) > 0.4
    mask[:, -1] = True
    if all_masked_row:
        mask[0] = False
    return q, k, v, go, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("rank", [3, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_backward_matches_jax_vjp_of_vanilla_sdpa(rank, masked):
    q, k, v, go, mask = _inputs(3, 2 if rank == 4 else 1, 11, 19, 8,
                                seed=rank + 2 * masked)
    if rank == 3:
        q, k, v, go = (x[:, 0] for x in (q, k, v, go))
    # the key mask as the JAX callers pass it: [B, Lk] at rank 3, [B, 1, Lk]
    # at rank 4
    jmask = None if not masked else jnp.asarray(mask if rank == 3
                                                else mask[:, None])
    _, vjp = jax.vjp(lambda a, b_, c: jatt.scaled_dot_product_attention(
        a, b_, c, jmask), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(go))
    q4, k4, v4, g4 = (x[:, None] if rank == 3 else x for x in (q, k, v, go))
    got = kfa.flash_attention_backward(
        *_t(q4, k4, v4), torch.from_numpy(mask) if masked else None,
        torch.from_numpy(np.ascontiguousarray(g4)))
    for name, g, w in zip("qkv", got, want):
        g = g[:, 0] if rank == 3 else g
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")
    if masked:     # row 0: every key masked
        dq, dk, dv = (x.numpy() for x in got)
        assert not dq[0].any() and not dk[0].any()
        np.testing.assert_allclose(
            dv[0], np.broadcast_to(g4[0].sum(1, keepdims=True) / mask.shape[1],
                                   dv[0].shape), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,h,lq,lk,d", [(4, 3, 9, 9, 8), (2, 4, 52, 52, 8),
                                         (3, 2, 7, 30, 16)])
def test_backward_matches_autograd_through_the_plain_version(b, h, lq, lk, d):
    q, k, v, go, mask = _inputs(b, h, lq, lk, d, seed=lq + d)
    for m in (None, torch.from_numpy(mask)):
        leaves = [x.requires_grad_() for x in _t(q, k, v)]
        kfa.flash_attention_plain(*leaves, m).backward(torch.from_numpy(go))
        got = kfa.flash_attention_backward(*_t(q, k, v), m,
                                           torch.from_numpy(go))
        for leaf, g in zip(leaves, got):
            np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(),
                                       rtol=RTOL, atol=ATOL)


def test_backward_keeps_each_input_dtype_and_takes_strided_grads():
    """bf16 inputs get bf16 gradients (computed in f32, rounded once); a
    non-contiguous output gradient (the kernel's output is a transposed
    view) gives the same result as its contiguous copy."""
    q, k, v, go, mask = _inputs(2, 3, 6, 10, 8, seed=1)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    gstrided = torch.from_numpy(np.ascontiguousarray(go.transpose(0, 2, 1, 3))
                                ).transpose(1, 2)
    assert not gstrided.is_contiguous()
    m = torch.from_numpy(mask)
    got = kfa.flash_attention_backward(tq, tk, tv, m, gstrided)
    ref = kfa.flash_attention_backward(tq.float(), tk.float(), tv.float(), m,
                                       gstrided.contiguous())
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, r.to(torch.bfloat16))


def test_function_path_carries_the_vanilla_gradient(monkeypatch):
    """`_FlashAttention` with the kernel launch replaced by the plain
    forward: the same output and the same q, k, v gradients as autograd
    through the plain version, for a masked call with an all-masked row."""
    monkeypatch.setattr(kfa, "launch_flash_attention", kfa.flash_attention_plain)
    q, k, v, go, mask = _inputs(3, 2, 13, 13, 8, seed=5)
    m = torch.from_numpy(mask)
    ours = [x.requires_grad_() for x in _t(q, k, v)]
    ref = [x.requires_grad_() for x in _t(q, k, v)]
    out = kfa._FlashAttention.apply(*ours, m)
    want = kfa.flash_attention_plain(*ref, m)
    assert torch.equal(out, want)
    out.backward(torch.from_numpy(go))
    want.backward(torch.from_numpy(go))
    for a, b in zip(ours, ref):
        assert a.grad is not None
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_card_dispatch_takes_the_function_only_when_a_gradient_is_wanted(
        monkeypatch):
    """Off the CPU (meta tensors here): with inputs that need a gradient,
    flash_attention goes through `_FlashAttention` and the gradient reaches
    q, k and v; under no_grad, or with no input needing one, the kernel
    launches directly and its output has no grad_fn."""
    launched = []

    def launch(q, k, v, mask=None):
        launched.append(tuple(q.shape))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    monkeypatch.setattr(kfa, "launch_flash_attention", launch)
    shape = (2, 4, 52, 8)
    q, k, v = (torch.empty(shape, device="meta", requires_grad=True)
               for _ in range(3))
    out = kfa.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.sum().backward()
    assert all(t.grad is not None and t.grad.shape == shape for t in (q, k, v))
    with torch.no_grad():
        assert kfa.flash_attention(q, k, v).grad_fn is None
    plain = [t.detach() for t in (q, k, v)]
    assert kfa.flash_attention(*plain).grad_fn is None
    assert launched == [shape] * 3
