"""The classification, regression and sample-weighted losses
(losses/classify.py, regression.py, weighted.py) against the JAX package on
the same numpy inputs from a seed: within 1e-6 (relative 1e-6 where a loss
exceeds 1; f32 sums in another order). categorical_ghm_loss keeps its EMA
state explicit and is held over three calls, the state included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)

TOL = dict(rtol=1e-6, atol=1e-6)


def _both(fn_name, module, *args, **kw):
    import importlib
    jm = importlib.import_module(f"recommendflow_tpu.losses.{module}")
    tm = importlib.import_module(f"recommendflow_tpu_torch.losses.{module}")
    j = getattr(jm, fn_name)(*[jnp.asarray(a) for a in args], **kw)
    t = getattr(tm, fn_name)(*[torch.from_numpy(np.asarray(a)) for a in args],
                             **kw)
    return np.asarray(j), t.numpy()


def _inputs(seed=0, b=16, c=7):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, c) * 2).astype(np.float32)
    multi = (rng.rand(b, c) > 0.6).astype(np.float32)
    onehot = np.eye(c, dtype=np.float32)[rng.randint(0, c, b)]
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    y = (rng.rand(b) > 0.5).astype(np.float32)
    score = rng.rand(b).astype(np.float32)
    return rng, logits, multi, onehot, probs.astype(np.float32), y, score


CASES = ["multilabel_categorical_crossentropy",
         "sparse_multilabel_categorical_crossentropy",
         "sparse_multilabel_categorical_crossentropy_mask_zero",
         "sparse_categorical_crossentropy", "binary_crossentropy",
         "binary_crossentropy_from_logits", "categorical_crossentropy",
         "categorical_crossentropy_from_logits", "categorical_hinge",
         "binary_focal_loss", "categorical_focal_loss"]


@pytest.mark.parametrize("case", CASES)
def test_classify_loss_matches_jax(case):
    rng, logits, multi, onehot, probs, y, score = _inputs()
    labels = rng.randint(0, 7, 16).astype(np.int32)
    pos = rng.randint(1, 7, (16, 3)).astype(np.int32)
    pos[:, 2] = 0                                  # a padding label
    if case == "multilabel_categorical_crossentropy":
        j, t = _both(case, "classify", multi, logits)
    elif case.startswith("sparse_multilabel"):
        j, t = _both("sparse_multilabel_categorical_crossentropy", "classify",
                     pos, logits, mask_zero=case.endswith("mask_zero"))
    elif case == "sparse_categorical_crossentropy":
        j, t = _both(case, "classify", labels, logits)
    elif case.startswith("binary_crossentropy"):
        logit = logits[:, 0]
        from_logits = case.endswith("from_logits")
        p = logit if from_logits else 1 / (1 + np.exp(-logit))
        j, t = _both("binary_crossentropy", "classify", y, p.astype(np.float32),
                     from_logits=from_logits)
    elif case.startswith("categorical_crossentropy"):
        from_logits = case.endswith("from_logits")
        j, t = _both("categorical_crossentropy", "classify", onehot,
                     logits if from_logits else probs, from_logits=from_logits)
    elif case == "categorical_hinge":
        j, t = _both(case, "classify", onehot, logits)
    elif case == "binary_focal_loss":
        j, t = _both(case, "classify", y, score, gamma=2.0, alpha=0.3)
    else:
        from recommendflow_tpu.losses import classify as jc
        from recommendflow_tpu_torch.losses import classify as tc
        j = np.asarray(jc.categorical_focal_loss(1.5, 0.7)(
            jnp.asarray(onehot), jnp.asarray(probs)))
        t = tc.categorical_focal_loss(1.5, 0.7)(
            torch.from_numpy(onehot), torch.from_numpy(probs)).numpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, **TOL)


def test_ghm_state_over_three_calls_matches_jax():
    from recommendflow_tpu.losses import classify as jc
    from recommendflow_tpu_torch.losses import classify as tc
    jg, tg = jc.categorical_ghm_loss(bins=10), tc.categorical_ghm_loss(bins=10)
    js, ts = jg.init_state(), tg.init_state()
    for step in range(3):
        _, _, _, onehot, probs, _, _ = _inputs(seed=10 + step)
        valid = np.ones(16, np.float32)
        valid[-3:] = 0                             # padded rows
        jl, js = jg(jnp.asarray(onehot), jnp.asarray(probs), jnp.asarray(valid),
                    js)
        tl, ts = tg(torch.from_numpy(onehot), torch.from_numpy(probs),
                    torch.from_numpy(valid), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
        assert not tl[-3:].any()                   # no loss on padding
    assert float(ts.sum()) > 0


@pytest.mark.parametrize("fn_name", ["mean_relative_percentage_error",
                                     "mean_squared_error",
                                     "mean_absolute_error"])
def test_regression_loss_matches_jax(fn_name):
    rng = np.random.RandomState(3)
    y = rng.randn(32).astype(np.float32)
    y[0] = 0.0                                     # the relative error's floor
    pred = (y + rng.randn(32) * 0.3).astype(np.float32)
    j, t = _both(fn_name, "regression", y, pred)
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("fn_name", ["weighted_mean_squared_error",
                                     "weighted_binary_cross_entropy",
                                     "weighted_cosent_loss"])
@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_loss_matches_jax(fn_name, weighted):
    rng = np.random.RandomState(4)
    y = (rng.rand(24) > 0.5).astype(np.float32)
    q = rng.randn(24, 8).astype(np.float32)
    d = rng.randn(24, 8).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True) * 1.5
    d /= np.linalg.norm(d, axis=1, keepdims=True) * 1.5
    w = rng.uniform(0.2, 2.0, 24).astype(np.float32) if weighted else None
    kw = {} if w is None else {"weights": w}
    from recommendflow_tpu.losses import weighted as jw
    from recommendflow_tpu_torch.losses import weighted as tw
    j = getattr(jw, fn_name)(jnp.asarray(y), jnp.asarray(q), jnp.asarray(d),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    t = getattr(tw, fn_name)(torch.from_numpy(y), torch.from_numpy(q),
                             torch.from_numpy(d),
                             **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_config_names_resolve_to_the_port():
    """A config that names these losses by the JAX package's path or the
    reference's legacy module resolves to the port's functions."""
    from recommendflow_tpu_torch.losses import classify, regression, weighted
    from recommendflow_tpu_torch.utils.str_parser import str2fn
    assert str2fn("recommendflow_tpu.losses.classify.binary_focal_loss") is \
        classify.binary_focal_loss
    assert str2fn("backend.losses.classify_losses.categorical_hinge") is \
        classify.categorical_hinge
    assert str2fn("recommendflow_tpu.losses.regression.mean_absolute_error") \
        is regression.mean_absolute_error
    assert str2fn("recommendflow_tpu.losses.weighted.weighted_cosent_loss") \
        is weighted.weighted_cosent_loss
