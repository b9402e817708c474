"""The port's attention against the JAX package's, on the CPU.

`scaled_dot_product_attention` and `flash_attention_plain` (kernel 6's plain
version) against the JAX vanilla SDPA and the Pallas `flash_attention` in
interpret mode; `MultiHeadAttention` with weights carried from flax. Inputs
are made with numpy from a seed. Tolerance rtol 1e-4, atol 1e-5, as the JAX
package holds its Pallas kernel to its vanilla path
(tests/test_encoder_export.py): f32 sums and exps in another order.

A query row whose keys are all masked is where the two JAX functions part:
the vanilla path's -1e9 fill averages v over the Lk real keys, the Pallas
kernel pads Lk to its 128-key block and averages over the zero padding too
(200/256 of the vanilla value at Lk = 200, equal at Lk <= 128). The port
follows the vanilla path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)

from recommendflow_tpu.ops import attention as jatt
from recommendflow_tpu.ops.pallas.flash_attention import \
    flash_attention as pallas_flash
from recommendflow_tpu_torch.ops import attention as tatt
from recommendflow_tpu_torch.ops.cuda import flash_attention as kfa

RTOL, ATOL = 1e-4, 1e-5


def _qkv(shape_q, lk, seed=0, mask_p=0.3):
    rng = np.random.RandomState(seed)
    *lead, _, d = shape_q
    q = rng.randn(*shape_q).astype(np.float32)
    k = rng.randn(*lead, lk, d).astype(np.float32)
    v = rng.randn(*lead, lk, d).astype(np.float32)
    mask = rng.rand(shape_q[0], lk) > mask_p
    mask[:, 0] = True
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("rank", [3, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_matches_jax_vanilla(rank, masked):
    shape = (3, 13, 16) if rank == 3 else (2, 3, 13, 16)
    q, k, v, mask = _qkv(shape, lk=21, seed=rank)
    # the key mask as the callers pass it: [B, Lk] at rank 3, [B, 1, Lk] at 4
    kmask = None if not masked else (mask if rank == 3 else mask[:, None])
    ref = jatt.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if kmask is None else jnp.asarray(kmask))
    tq, tk, tv = _t(q, k, v)
    got = tatt.scaled_dot_product_attention(
        tq, tk, tv, None if kmask is None else torch.from_numpy(kmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # kernel 6's plain version computes the same function at rank 4
    q4, k4, v4 = (x if rank == 4 else x[:, None] for x in (q, k, v))
    plain = kfa.flash_attention_plain(
        *_t(q4, k4, v4), None if not masked else torch.from_numpy(mask))
    if rank == 3:
        plain = plain[:, 0]
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_sdpa_full_mask_matches_jax_vanilla():
    q, k, v, _ = _qkv((2, 3, 9, 8), lk=9, seed=5)
    full = np.tril(np.ones((9, 9), bool))[None, None].repeat(2, 0)
    ref = jatt.scaled_dot_product_attention(*map(jnp.asarray, (q, k, v, full)))
    got = tatt.scaled_dot_product_attention(*_t(q, k, v, full))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,lk,masked", [
    ((2, 2, 50, 32), 50, True), ((1, 3, 20, 8), 37, True),
    ((2, 2, 16, 16), 16, False)])
def test_plain_matches_pallas_interpret(shape, lk, masked):
    q, k, v, mask = _qkv(shape, lk=lk, seed=7)
    m = mask if masked else None
    ref = pallas_flash(*map(jnp.asarray, (q, k, v)),
                       None if m is None else jnp.asarray(m), interpret=True)
    got = kfa.flash_attention(*_t(q, k, v), None if m is None
                              else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lk,pallas_ratio", [(200, 200 / 256), (100, 1.0)])
def test_all_masked_row_follows_the_vanilla_path(lk, pallas_ratio):
    """Row 0 has every key masked: the port equals the vanilla path (the
    mean of v over the Lk keys); the Pallas kernel gives lk / lk_pad of it."""
    q, k, v, mask = _qkv((2, 1, 4, 8), lk=lk, seed=3)
    mask[0] = False
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    vanilla = np.asarray(jatt.scaled_dot_product_attention(
        *jargs, jnp.asarray(mask[:, None])))
    pallas = np.asarray(pallas_flash(*jargs, jnp.asarray(mask),
                                     interpret=True))
    ours = kfa.flash_attention(*_t(q, k, v), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(vanilla[0, 0],
                               np.broadcast_to(v[0, 0].mean(0), (4, 8)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, vanilla, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pallas[0], pallas_ratio * vanilla[0],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pallas[1], vanilla[1], rtol=RTOL, atol=ATOL)


def test_bf16_plain_rounds_once():
    """bf16 inputs: scores, softmax and P.V in f32, one rounding at the end."""
    q, k, v, mask = _qkv((1, 2, 5, 8), lk=7, seed=9)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, k, v))
    got = kfa.flash_attention(tq, tk, tv, torch.from_numpy(mask))
    ref = kfa.flash_attention_plain(tq.float(), tk.float(), tv.float(),
                                    torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.to(torch.bfloat16))


def test_helpers_match_jax():
    x = np.random.RandomState(0).randn(2, 5, 12).astype(np.float32)
    heads = tatt.split_heads(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(heads.numpy(),
                                  np.asarray(jatt.split_heads(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(tatt.merge_heads(heads).numpy(), x)
    np.testing.assert_allclose(
        tatt.sinusoidal_position_encoding(20, 12).numpy(),
        np.asarray(jatt.sinusoidal_position_encoding(20, 12)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mask_kind", ["none", "key", "full"])
def test_multi_head_attention_with_carried_weights(mask_kind):
    import jax
    from recommendflow_tpu_torch.interop import load_jax_variables
    rng = np.random.RandomState(11)
    x = rng.randn(3, 10, 24).astype(np.float32)
    y = rng.randn(3, 7, 24).astype(np.float32)
    mask = None
    if mask_kind == "key":
        mask = rng.rand(3, 7) > 0.3
        mask[:, 0] = True
    elif mask_kind == "full":
        mask = rng.rand(3, 10, 7) > 0.3
        mask[..., 0] = True
    jm = jatt.MultiHeadAttention(num_heads=4)
    jargs = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(y),
             None if mask is None else jnp.asarray(mask))
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), *jargs))
    ref = np.asarray(jm.apply(variables, *jargs))
    tm = tatt.MultiHeadAttention(24, 4)
    load_jax_variables(tm, variables)
    with torch.no_grad():
        got = tm(*_t(x, y, y), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_card_path_shapes_and_full_mask_refusal(monkeypatch):
    """Off the CPU (meta tensors here; no card needed) SDPA hands kernel 6
    [B, H, L, D] operands and a [B, Lk] key mask; a full mask (once refused
    there) takes the vanilla maths and never reaches kernel 6, as the JAX
    package computes it outside its kernel."""
    calls = []

    def record(q, k, v, mask):
        calls.append((tuple(q.shape), tuple(k.shape),
                      None if mask is None else tuple(mask.shape)))
        return torch.empty(q.shape, device=q.device)

    monkeypatch.setattr(tatt, "flash_attention", record)
    meta = dict(device="meta")
    q3, k3 = torch.empty(2, 5, 8, **meta), torch.empty(2, 6, 8, **meta)
    out = tatt.scaled_dot_product_attention(
        q3, k3, k3, torch.empty(2, 6, dtype=torch.bool, **meta))
    assert out.shape == (2, 5, 8)
    q4, k4 = torch.empty(2, 3, 5, 8, **meta), torch.empty(2, 3, 6, 8, **meta)
    tatt.scaled_dot_product_attention(
        q4, k4, k4, torch.empty(2, 1, 6, dtype=torch.bool, **meta))
    tatt.scaled_dot_product_attention(q4, k4, k4)
    assert calls == [((2, 1, 5, 8), (2, 1, 6, 8), (2, 6)),
                     ((2, 3, 5, 8), (2, 3, 6, 8), (2, 6)),
                     ((2, 3, 5, 8), (2, 3, 6, 8), None)]
    out = tatt.scaled_dot_product_attention(
        q4, k4, k4, torch.empty(2, 1, 5, 6, dtype=torch.bool, **meta))
    assert out.shape == (2, 3, 5, 8) and out.device.type == "meta"
    # the same from the module, with a [B, Lq, Lk] mask
    mha = tatt.MultiHeadAttention(8, 2, device="meta")
    out = mha(q3, q3, q3, torch.empty(2, 5, 5, dtype=torch.bool, **meta))
    assert out.shape == (2, 5, 8) and out.device.type == "meta"
    assert len(calls) == 3                  # kernel 6 never called again


def test_launch_refuses_what_the_kernel_does_not_take():
    meta = dict(device="meta")
    q = torch.empty(1, 2, 4, 8, **meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kfa.launch_flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kfa.launch_flash_attention(torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8),
                                   torch.zeros(1, 2, 4, 8))
