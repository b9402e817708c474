"""The port's TextEncoder against the JAX `TextEncoder.apply`, on the CPU.

vocab 64, 2 layers, dim 32, 4 heads, max_len 16; weights initialised by flax
and carried through `interop.load_jax_variables`; token and segment ids made
with numpy from a seed, with padding. Tolerance atol 2e-5: torch's LayerNorm
takes the variance as the mean of squared deviations, flax's as
E[x^2] - E[x]^2, and with the matmuls' f32 sums in another order the hidden
states of the two differ in their last bits after each of the five
LayerNorms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)

from recommendflow_tpu.ops.transformer import TextEncoder as JaxTextEncoder
from recommendflow_tpu_torch.interop import (flatten, jax_from_variables,
                                             load_jax_variables)
from recommendflow_tpu_torch.ops.transformer import TextEncoder

ATOL = 2e-5
SIZES = dict(vocab_size=64, num_layers=2, model_dim=32, num_heads=4,
             ffn_hidden=64, max_len=16)


def _inputs(batch=5, length=12, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, SIZES["vocab_size"], size=(batch, length)).astype(np.int32)
    ids[0, 7:] = 0
    ids[2, 3:] = 0
    seg = np.zeros_like(ids)
    seg[:, length // 2:] = 1
    seg[ids == 0] = 0
    return ids, seg


def _pair(**kw):
    """(jax module, its variables as numpy, the port module holding them)."""
    ids, seg = _inputs()
    jm = JaxTextEncoder(**SIZES, **kw)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(seg)))
    tm = TextEncoder(**SIZES, **kw, device="cpu")
    load_jax_variables(tm, variables)
    return jm, variables, tm


def _both(jm, variables, tm, ids, seg, **call):
    ref = np.asarray(jm.apply(variables, jnp.asarray(ids),
                              None if seg is None else jnp.asarray(seg), **call))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids),
                 None if seg is None else torch.from_numpy(seg), **call)
    return got.numpy(), ref


@pytest.mark.parametrize("pos_type", ["sinusoidal", "learned"])
@pytest.mark.parametrize("pooling", ["cls", "pos", "avg", "sum", "max"])
def test_pooling_matches_jax(pos_type, pooling):
    jm, v, tm = _pair(pooling=pooling, pos_type=pos_type, pool_pos=3)
    got, ref = _both(jm, v, tm, *_inputs())
    assert got.shape == (5, SIZES["model_dim"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("act", ["gelu", "gelu_exact"])
@pytest.mark.parametrize("out_layer", [-1, 0])
def test_activation_and_out_layer_match_jax(act, out_layer):
    jm, v, tm = _pair(ffn_activation=act, out_layer=out_layer,
                      ln_epsilon=1e-12, pos_type="learned")
    got, ref = _both(jm, v, tm, *_inputs(seed=1))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_return_sequence_and_no_segments_match_jax():
    jm, v, tm = _pair()
    ids, _ = _inputs(seed=2)
    got, ref = _both(jm, v, tm, ids, None, return_sequence=True)
    assert got.shape == (5, 12, SIZES["model_dim"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_variables_round_trip_through_the_state_dict():
    """The port's state dict maps back onto the flax tree it was loaded
    from, leaf for leaf and bit for bit."""
    _, v, tm = _pair(pos_type="learned")
    back, orig = flatten(jax_from_variables(tm.state_dict())), flatten(v)
    assert sorted(back) == sorted(orig)
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k], err_msg="/".join(k))


def test_max_len_and_seq2seq_refused():
    """Past max_len and an unknown pooling raise; seq2seq=True (the UniLM
    mask, once refused) gives flax's seq2seq hidden states and pooled
    vectors."""
    tm = TextEncoder(**SIZES, device="cpu")
    with pytest.raises(ValueError, match="exceeds the encoder's configured"):
        tm(torch.ones((2, SIZES["max_len"] + 1), dtype=torch.int32))
    jm, v, tp_ = _pair(pos_type="learned")
    ids, seg = _inputs(seed=3)
    for call in (dict(return_sequence=True), {}):
        got, ref = _both(jm, v, tp_, ids, seg, seq2seq=True, **call)
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    plain, _ = _both(jm, v, tp_, ids, seg, return_sequence=True)
    assert np.abs(plain - _both(jm, v, tp_, ids, seg, seq2seq=True,
                                return_sequence=True)[0]).max() > 1e-3
    with pytest.raises(ValueError, match="unknown pooling"):
        TextEncoder(**SIZES, pooling="first", device="cpu")


def test_dropout_only_in_training():
    tm = TextEncoder(**SIZES, dropout=0.5, device="cpu")
    ids = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        a, b = tm(ids), tm(ids)
        assert torch.equal(a, b)
        tm.train()
        assert not torch.equal(tm(ids), a)
