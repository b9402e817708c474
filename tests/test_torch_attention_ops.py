"""The ops of the ranking-with-attention slice against the JAX package's, on
the CPU: `Dice` (and the rank-3 `BatchNorm` under it), `SelfAttention`,
`soft_attention_align`, `esim_enhance`, `ItemSimilarityGating`,
`LocationBasedAttention` and the ops' `TabTransformer`.

flax modules are initialised, their zero-initialised leaves (biases,
Dice's alpha) drawn away from 0 and, for Dice, running statistics set, then
carried into the port through interop.py. On the same numpy inputs:

  * outputs within atol 1e-5 (f32 products summed in another order, values
    of ~1);
  * the gradients of sum(out * cot) for a random cotangent, into every
    parameter and every float input, within rtol 1e-5 + atol 1e-5;
  * Dice in training mode: its running statistics after the step within
    1e-6 (flax's momentum 0.99 and biased variance, over B and L, pad
    positions included).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)

from recommendflow_tpu.ops import attention as jatt
from recommendflow_tpu.ops import mlp as jmlp
from recommendflow_tpu.ops import transformer as jtr
from recommendflow_tpu_torch import interop
from recommendflow_tpu_torch.ops import attention as tatt
from recommendflow_tpu_torch.ops import mlp as tmlp
from recommendflow_tpu_torch.ops import transformer as ttr

ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5


def _variables(module, *args, seed=0, **kw):
    """flax variables as numpy, biases / alpha / running stats drawn away
    from their init."""
    variables = jax.tree.map(np.asarray, module.init(
        jax.random.PRNGKey(seed), *args, **kw))
    rng = np.random.RandomState(seed + 100)
    flat = interop.flatten(variables)
    for p, v in flat.items():
        if p[-1] in ("bias", "alpha", "mean"):
            flat[p] = (0.3 * rng.randn(*v.shape)).astype(v.dtype)
        elif p[-1] == "var":
            flat[p] = rng.uniform(0.5, 2.0, v.shape).astype(v.dtype)
    return interop.unflatten(flat)


def _jax_vjp(fn, params, xs, cot):
    """fn(params, *xs) -> out; returns (out, param grads, input grads)."""
    out, vjp = jax.vjp(fn, params, *map(jnp.asarray, xs))
    grads = vjp(jnp.asarray(cot))
    return np.asarray(out), grads[0], grads[1:]


def _torch_vjp(call, module, xs, cot):
    txs = [torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()
           for x in xs]
    out = call(*txs)
    out.backward(torch.from_numpy(cot))
    grads = {} if module is None else {
        n: p.grad for n, p in module.named_parameters()}
    return out.detach().numpy(), grads, [t.grad for t in txs]


def _compare(jres, tres, what):
    (jo, jgp, jgx), (to, tgp, tgx) = jres, tres
    np.testing.assert_allclose(to, jo, rtol=0, atol=ATOL,
                               err_msg=f"{what}: output")
    if jgp is not None:
        want = interop.variables_from_jax(
            {"params": jax.tree.map(np.asarray, jgp)})
        assert sorted(want) == sorted(tgp), what
        for k, w in want.items():
            np.testing.assert_allclose(tgp[k].numpy(), w.numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{what}: d{k}")
    for i, (g, w) in enumerate(zip(tgx, jgx)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{what}: dx{i}")


@pytest.mark.parametrize("shape", [(6, 5, 8), (12, 8)])
@pytest.mark.parametrize("training", [True, False])
def test_dice_matches_flax(shape, training):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)
    jd = jmlp.Dice()
    variables = _variables(jd, jnp.asarray(x))
    assert sorted(interop.flatten(variables)) == [
        ("batch_stats", "BatchNorm_0", "mean"),
        ("batch_stats", "BatchNorm_0", "var"), ("params", "alpha")]

    def fn(params, x_):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if not training:
            return jd.apply(v, x_, training=False)
        return jd.apply(v, x_, training=True, mutable=["batch_stats"])[0]

    jres = _jax_vjp(fn, variables["params"], [x], cot)
    stats = jax.tree.map(np.asarray, jd.apply(
        variables, jnp.asarray(x), training=True,
        mutable=["batch_stats"])[1]["batch_stats"])
    td = interop.load_jax_variables(tmlp.Dice(shape[-1]), variables)
    assert sorted(td.state_dict()) == ["BatchNorm_0.running_mean",
                                       "BatchNorm_0.running_var", "alpha"]
    td.train(training)
    _compare(jres, _torch_vjp(td, td, [x], cot), "Dice")
    if training:
        np.testing.assert_allclose(td.BatchNorm_0.running_mean.numpy(),
                                   stats["BatchNorm_0"]["mean"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(td.BatchNorm_0.running_var.numpy(),
                                   stats["BatchNorm_0"]["var"], rtol=1e-6,
                                   atol=1e-6)
    back = interop.jax_from_variables(td.state_dict())
    assert sorted(interop.flatten(back)) == sorted(interop.flatten(variables))


@pytest.mark.parametrize("masked", [False, True])
def test_self_attention_matches_flax(masked):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 9, 16).astype(np.float32)
    cot = rng.randn(4, 16).astype(np.float32)
    mask = rng.rand(4, 9) > 0.3
    mask[:, 0] = True
    mask[1] = False                       # a row with every position masked
    m = mask if masked else None
    js = jatt.SelfAttention()
    variables = _variables(js, jnp.asarray(x),
                           None if m is None else jnp.asarray(m))
    jres = _jax_vjp(lambda p, x_: js.apply(
        {"params": p}, x_, None if m is None else jnp.asarray(m)),
        variables["params"], [x], cot)
    ts = interop.load_jax_variables(tatt.SelfAttention(16), variables)
    tm = None if m is None else torch.from_numpy(m)
    _compare(jres, _torch_vjp(lambda x_: ts(x_, tm), ts, [x], cot),
             "SelfAttention")


@pytest.mark.parametrize("masked", [False, True])
def test_soft_attention_align_and_esim_enhance_match_jax(masked):
    rng = np.random.RandomState(4)
    a = rng.randn(3, 7, 8).astype(np.float32)
    b = rng.randn(3, 5, 8).astype(np.float32)
    ma, mb = rng.rand(3, 7) > 0.3, rng.rand(3, 5) > 0.3
    ma[:, 0] = mb[:, 0] = True
    ma[2] = False                         # an all-pad side
    masks = (ma, mb) if masked else (None, None)
    cot_a = rng.randn(3, 7, 32).astype(np.float32)
    cot_b = rng.randn(3, 5, 32).astype(np.float32)
    cot = np.concatenate([cot_a.reshape(3, -1), cot_b.reshape(3, -1)], 1)

    def jfn(_, a_, b_):
        al_a, al_b = jatt.soft_attention_align(
            a_, b_, *(None if m is None else jnp.asarray(m) for m in masks))
        return jnp.concatenate(
            [jatt.esim_enhance(a_, al_a).reshape(3, -1),
             jatt.esim_enhance(b_, al_b).reshape(3, -1)], 1)

    def tfn(a_, b_):
        al_a, al_b = tatt.soft_attention_align(
            a_, b_, *(None if m is None else torch.from_numpy(m)
                      for m in masks))
        return torch.cat([tatt.esim_enhance(a_, al_a).reshape(3, -1),
                          tatt.esim_enhance(b_, al_b).reshape(3, -1)], 1)

    jo, _, jgx = _jax_vjp(jfn, {}, [a, b], cot)
    _compare((jo, None, jgx), _torch_vjp(tfn, None, [a, b], cot),
             "soft_attention_align + esim_enhance")
    # the enhancement alone is exact
    x, y = rng.randn(2, 4, 6).astype(np.float32)
    np.testing.assert_array_equal(
        tatt.esim_enhance(*map(torch.from_numpy, (x, y))).numpy(),
        np.asarray(jatt.esim_enhance(jnp.asarray(x), jnp.asarray(y))))


def test_item_similarity_gating_matches_flax():
    rng = np.random.RandomState(5)
    xs = [rng.randn(6, w).astype(np.float32) for w in (8, 8, 4)]
    cot = rng.randn(6, 1).astype(np.float32)
    jg = jatt.ItemSimilarityGating(dropout=0.0)
    variables = _variables(jg, *map(jnp.asarray, xs))
    jres = _jax_vjp(lambda p, *x_: jg.apply({"params": p}, *x_),
                    variables["params"], xs, cot)
    tg = interop.load_jax_variables(tatt.ItemSimilarityGating(20),
                                    variables)
    _compare(jres, _torch_vjp(tg, tg, xs, cot), "ItemSimilarityGating")


@pytest.mark.parametrize("values", [False, True])
def test_location_based_attention_matches_flax(values):
    rng = np.random.RandomState(6)
    x = rng.randn(4, 7, 8).astype(np.float32)
    vals = rng.randn(4, 7, 12).astype(np.float32)
    mask = rng.rand(4, 7) > 0.3
    mask[:, 0] = True
    mask[3] = False
    cot = rng.randn(4, 12 if values else 8).astype(np.float32)
    xs = [x, vals] if values else [x]
    jl = jatt.LocationBasedAttention()
    jm = jnp.asarray(mask)
    variables = _variables(jl, jnp.asarray(x), jm,
                           jnp.asarray(vals) if values else None)
    assert sorted(interop.flatten(variables)) == [
        ("params", "key", "kernel"), ("params", "out", "kernel"),
        ("params", "query")]
    jres = _jax_vjp(lambda p, *x_: jl.apply({"params": p}, x_[0], jm,
                                            x_[1] if values else None),
                    variables["params"], xs, cot)
    tl = interop.load_jax_variables(tatt.LocationBasedAttention(
        8, 12 if values else None), variables)
    tm = torch.from_numpy(mask)
    _compare(jres, _torch_vjp(lambda *x_: tl(
        x_[0], tm, x_[1] if values else None), tl, xs, cot), "LBA")
    back = interop.flatten(interop.jax_from_variables(tl.state_dict()))
    for k, v in interop.flatten(variables).items():
        assert back[k].tobytes() == v.tobytes(), k


def test_lba_query_draws_flax_lecun_normal():
    """The port's own init of the bare `query` [D, 1]: truncated normal of
    variance 1/D, as flax's lecun_normal (fan_in = D)."""
    torch.manual_seed(0)
    lba = tatt.LocationBasedAttention(4096)
    q = lba.query.detach()
    assert q.shape == (4096, 1)
    assert abs(float(q.std()) - (1 / 64)) < 0.05 / 64
    assert float(q.abs().max()) <= 2 / 64 / .87962566103423978


def test_tab_transformer_blocks_match_flax():
    rng = np.random.RandomState(7)
    x = rng.randn(5, 10, 16).astype(np.float32)
    cot = rng.randn(5, 160).astype(np.float32)
    jt = jtr.TabTransformer(num_blocks=2, num_heads=4, ffn_hidden=64,
                            dropout=0.0)
    variables = _variables(jt, jnp.asarray(x))
    jres = _jax_vjp(lambda p, x_: jt.apply({"params": p}, x_),
                    variables["params"], [x], cot)
    tt = interop.load_jax_variables(ttr.TabTransformer(16, 2, 4, 64, 0.0),
                                    variables)
    assert any(k.startswith("block1.mha.q") for k in tt.state_dict())
    _compare(jres, _torch_vjp(tt, tt, [x], cot), "TabTransformer")


def test_batchnorm_without_scale_or_bias_holds_only_statistics():
    bn = tmlp.BatchNorm(5, use_scale=False, use_bias=False)
    assert bn.weight is None and bn.bias is None
    assert sorted(bn.state_dict()) == ["running_mean", "running_var"]
    assert not list(bn.parameters())
    x = torch.randn(3, 4, 5)
    bn.train()(x)
    mean = x.reshape(-1, 5).mean(0)
    torch.testing.assert_close(bn.running_mean, 0.01 * mean, rtol=1e-6,
                               atol=1e-7)
