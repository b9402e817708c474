"""The port's matching losses against recommendflow_tpu/losses/match.py.

The same numpy inputs (L2-normalized query/doc [16, 32], labels with
zeros) go through each JAX loss and its port; values and the gradients with
respect to query and doc agree to rtol 1e-5, atol 1e-6 (the same f32 maths,
reduced in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)
from recommendflow_tpu.losses import match as jm
from recommendflow_tpu_torch.losses import match as tm

B, D = 16, 32


def _inputs(seed=0, all_pos=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, D).astype(np.float32)
    d = (q + 0.7 * rng.randn(B, D)).astype(np.float32)   # positives correlate
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    y = np.ones(B, np.float32) if all_pos else \
        (rng.rand(B) > 0.3).astype(np.float32)
    aux = rng.randint(0, 5, B).astype(np.float32)
    logq = np.log(rng.uniform(1e-4, 1e-2, B)).astype(np.float32)
    return q, d, y, aux, logq


# name -> (call on the JAX module, call on the port module); each call gets
# (module, y, q, d, aux, logq)
CASES = {
    "mean_squared_error": lambda m, y, q, d, a, l: m.mean_squared_error(y, q, d),
    "binary_cross_entropy": lambda m, y, q, d, a, l: m.binary_cross_entropy(y, q, d),
    "binary_cross_entropy_logits": lambda m, y, q, d, a, l:
        m.binary_cross_entropy(y, q, d, from_logits=True),
    "cosent_loss": lambda m, y, q, d, a, l: m.cosent_loss(y, q, d),
    "cosent_loss_v2": lambda m, y, q, d, a, l: m.cosent_loss_v2(y, q, d),
    "aux_label_cosent_loss": lambda m, y, q, d, a, l:
        m.aux_label_cosent_loss(y, a, q, d),
    "pos_aux_label_cosent_loss": lambda m, y, q, d, a, l:
        m.pos_aux_label_cosent_loss(y, a, q, d),
    "batch_neg_sample_ce_loss": lambda m, y, q, d, a, l:
        m.batch_neg_sample_ce_loss(y, q, d),
    "batch_neg_sample_symmetrical_ce_loss": lambda m, y, q, d, a, l:
        m.batch_neg_sample_symmetrical_ce_loss(y, q, d),
    "batch_neg_sample_scaled_multi_class_ce_loss": lambda m, y, q, d, a, l:
        m.batch_neg_sample_scaled_multi_class_ce_loss(y, q, d),
    "batch_neg_sample_scaled_multi_class_ce_loss_logq": lambda m, y, q, d, a, l:
        m.batch_neg_sample_scaled_multi_class_ce_loss(y, q, d, logq=l),
    "batch_neg_sample_symmetrical_scaled_multi_class_ce_loss":
        lambda m, y, q, d, a, l:
        m.batch_neg_sample_symmetrical_scaled_multi_class_ce_loss(y, q, d),
    "symmetrical_scaled_logq": lambda m, y, q, d, a, l:
        m.batch_neg_sample_symmetrical_scaled_multi_class_ce_loss(
            y, q, d, scale=10.0, logq=l),
    "batch_neg_sample_margin_rank_loss": lambda m, y, q, d, a, l:
        m.batch_neg_sample_margin_rank_loss(y, q, d),
    "batch_hard_neg_sample_margin_rank_loss": lambda m, y, q, d, a, l:
        m.batch_hard_neg_sample_margin_rank_loss(y, q, d, margin=0.3),
    "batch_softmax_probabilistic_combining_soft": lambda m, y, q, d, a, l:
        m.batch_softmax_probabilistic_combining_soft(B)(y, q, d),
}


def _jax(case, q, d, y, aux, logq):
    fn = lambda q_, d_: CASES[case](jm, jnp.asarray(y), q_, d_,  # noqa: E731
                                    jnp.asarray(aux), jnp.asarray(logq))
    v, (gq, gd) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(q),
                                                        jnp.asarray(d))
    return float(v), np.asarray(gq), np.asarray(gd)


def _torch(case, q, d, y, aux, logq):
    tq = torch.from_numpy(q).requires_grad_()
    td = torch.from_numpy(d).requires_grad_()
    v = CASES[case](tm, torch.from_numpy(y), tq, td, torch.from_numpy(aux),
                    torch.from_numpy(logq))
    v.backward()
    return float(v.detach()), tq.grad.numpy(), td.grad.numpy()


@pytest.mark.parametrize("all_pos", [False, True], ids=["mixed", "all_pos"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_value_and_gradients_match(case, all_pos):
    args = _inputs(seed=len(case), all_pos=all_pos)
    jv, jgq, jgd = _jax(case, *args)
    tv, tgq, tgd = _torch(case, *args)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tgq, jgq, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tgd, jgd, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["zipped_mean_squared_error",
                                  "zipped_cosent_loss",
                                  "zipped_batch_neg_sample_ce_loss",
                                  "zipped_batch_neg_sample_scaled_multi_class_ce_loss",
                                  "zipped_batch_neg_sample_margin_rank_loss"])
def test_zipped_losses_match(name):
    rng = np.random.RandomState(3)
    y_pred = rng.randn(2 * B, D).astype(np.float32)
    y = (rng.rand(B) > 0.3).astype(np.float32)
    jv = float(getattr(jm, name)(jnp.asarray(y), jnp.asarray(y_pred)))
    tv = float(getattr(tm, name)(torch.from_numpy(y), torch.from_numpy(y_pred)))
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)


def test_config_names_resolve_to_the_port_and_axis_name_raises():
    from recommendflow_tpu_torch.utils.str_parser import str2fn
    fn = str2fn("recommendflow_tpu.losses.match."
                "batch_neg_sample_scaled_multi_class_ce_loss")
    assert fn is tm.batch_neg_sample_scaled_multi_class_ce_loss
    assert str2fn("cosent_loss") is tm.cosent_loss
    q, d, y, _, _ = _inputs()
    # axis_name names an axis of the current mesh (tests/
    # test_torch_match_axis.py): without one it raises
    with pytest.raises(RuntimeError, match="no mesh"):
        tm.batch_neg_sample_ce_loss(torch.from_numpy(y), torch.from_numpy(q),
                                    torch.from_numpy(d), axis_name="dp")
