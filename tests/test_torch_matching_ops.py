"""The matching models' ops against the JAX package on the CPU: fusion
(AttentionFusion with its `stats` rules, channel_importance), both poolings,
every matching_matrix mode, MultiPerspective with masks and an all-padded
row, patch_embed and ImageEncoder (the ViT's attention reaches kernel 6's
plain version unmasked).

Inputs come from a numpy seed, weights from the flax init carried through
interop.py. Outputs are held within atol 1e-5 and gradients (of the sum of
the output times a fixed random cotangent, into every input and parameter)
within rtol 1e-4 + atol 1e-6 · max(1, the leaf's largest magnitude): the
same f32 maths summed in another order, whose noise scales with the
leaf. Selections (top-k values, max pools, argmax) are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop

ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def grad_close(got, want, err_msg="", scale=1.0):
    """rtol 1e-4 + atol scale · 1e-6 · max(1, max|want|)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL, atol=scale * GRAD_ATOL * max(
            1.0, float(np.abs(want).max(initial=0.0))), err_msg=err_msg)


def _grads_match(got, want):
    for g, w in zip(got, want):
        grad_close(g, w)


def _jax_vjp(fn, args, cot):
    """Gradients of sum(fn(*args) * cot) into every arg."""
    return jax.grad(lambda *a: jnp.sum(fn(*a) * cot),
                    argnums=tuple(range(len(args))))(*args)


def _torch_vjp(fn, args, cot):
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*leaves)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


# ------------------------------------------------------------------ fusion
def _fusion_pair(c=3, d=8, b=6, seed=0):
    from recommendflow_tpu.ops.fusion import AttentionFusion as JFusion
    from recommendflow_tpu_torch.ops.fusion import AttentionFusion
    rng = np.random.RandomState(seed)
    chans = [_rand(rng, b, d) for _ in range(c)]
    jm = JFusion(c)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), [jnp.asarray(x) for x in chans]))
    flat = interop.flatten(variables)
    flat[("params", "att", "bias")] = _rand(rng, c) * 0.1
    variables = interop.unflatten(flat)
    tm = AttentionFusion(c, d, device="cpu")
    interop.load_jax_variables(tm, variables)
    return jm, variables, tm, chans


def test_attention_fusion_matches_jax_with_gradients():
    jm, variables, tm, chans = _fusion_pair()
    assert sorted(variables) == ["params", "stats"]
    cot = _rand(np.random.RandomState(9), 6, 8)

    def jfn(w, b, *x):
        v = {"params": {"att": {"kernel": w, "bias": b}},
             "stats": variables["stats"]}
        return jm.apply(v, list(x), training=True)

    args = [variables["params"]["att"]["kernel"],
            variables["params"]["att"]["bias"], *chans]
    want = _jax_vjp(jfn, [jnp.asarray(a) for a in args], jnp.asarray(cot))
    tm.train()
    leaves = [torch.tensor(x, requires_grad=True) for x in chans]
    out = tm(leaves)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jfn(*args)), rtol=0, atol=ATOL)
    got = [tm.att.weight.grad.numpy().T, tm.att.bias.grad.numpy()] + \
        [t.grad.numpy() for t in leaves]
    _grads_match(got, want)


def test_fusion_stats_accumulate_only_when_collected():
    """flax adds the mean channel weights to `stats` only in an eval apply
    with `stats` mutable; the port only in eval mode inside
    collecting_stats. A plain eval, and training even when collected, leave
    them as they were."""
    from recommendflow_tpu.ops.fusion import channel_importance as jimportance
    from recommendflow_tpu_torch.ops.fusion import (channel_importance,
                                                    collecting_stats)
    jm, variables, tm, chans = _fusion_pair(seed=1)
    jx = [jnp.asarray(x) for x in chans]
    tx = [torch.from_numpy(x) for x in chans]
    # plain applies: no change on either side
    jm.apply(variables, jx)
    _, upd = jm.apply(variables, jx, training=True, mutable=["stats"])
    assert not np.asarray(upd["stats"]["infer_count"])
    with torch.no_grad():
        tm.eval()(tx)
        with collecting_stats(tm):
            tm.train()(tx)
    assert not tm.infer_weights.any() and float(tm.infer_count) == 0
    # two collected eval calls
    stats = variables["stats"]
    for _ in range(2):
        _, upd = jm.apply({**variables, "stats": stats}, jx, mutable=["stats"])
        stats = jax.tree_util.tree_map(np.asarray, upd["stats"])
    with torch.no_grad(), collecting_stats(tm):
        tm.eval()
        tm(tx)
        tm(tx)
    assert not tm.collect_stats
    np.testing.assert_allclose(tm.infer_weights.numpy(),
                               stats["infer_weights"], rtol=0, atol=1e-6)
    assert float(tm.infer_count) == float(stats["infer_count"]) == 2.0
    np.testing.assert_allclose(
        channel_importance(dict(tm.named_buffers())).numpy(),
        np.asarray(jimportance(stats)), rtol=0, atol=1e-6)
    # the statistics cross as the `stats` collection, both ways
    back = interop.jax_from_variables(tm.state_dict())
    assert sorted(back["stats"]) == ["infer_count", "infer_weights"]
    assert back["stats"]["infer_count"].shape == ()


def test_fusion_rejects_a_wrong_channel_count():
    from recommendflow_tpu_torch.ops.fusion import AttentionFusion
    with pytest.raises(ValueError, match="expected 3 channels"):
        AttentionFusion(3, 4, device="cpu")([torch.zeros(2, 4)] * 2)


# ----------------------------------------------------------------- pooling
@pytest.mark.parametrize("shape,k,axis", [((4, 9), 3, -1), ((3, 7, 5), 2, 1),
                                          ((5, 6, 4), 4, 0)])
def test_kmax_pooling_matches_top_k(shape, k, axis):
    from recommendflow_tpu.ops.pooling import kmax_pooling as jk
    from recommendflow_tpu_torch.ops.pooling import kmax_pooling
    rng = np.random.RandomState(2)
    x = _rand(rng, *shape)
    want = np.asarray(jk(jnp.asarray(x), k, axis))
    out_shape = want.shape
    cot = _rand(rng, *out_shape)
    got, g = _torch_vjp(lambda t: kmax_pooling(t, k, axis), [x], cot)
    np.testing.assert_array_equal(got, want)
    assert (np.diff(np.moveaxis(got, axis, -1), axis=-1) <= 0).all()
    _grads_match(g, _jax_vjp(lambda t: jk(t, k, axis), [jnp.asarray(x)],
                             jnp.asarray(cot)))


@pytest.mark.parametrize("shape,out_hw,shift", [
    ((2, 7, 9), (3, 4), 0.0), ((2, 8, 8), (4, 2), 0.0),
    ((2, 5, 11, 3), (2, 3), 0.0), ((2, 7, 5), (3, 2), -10.0)])
def test_dynamic_max_pooling_matches_jax(shape, out_hw, shift):
    """Ragged grids (edge-padded windows) and all-negative matrices, where
    zero padding would have won every spilled window."""
    from recommendflow_tpu.ops.pooling import dynamic_max_pooling as jdp
    from recommendflow_tpu_torch.ops.pooling import dynamic_max_pooling
    rng = np.random.RandomState(3)
    x = _rand(rng, *shape) + np.float32(shift)
    want = np.asarray(jdp(jnp.asarray(x), *out_hw))
    cot = _rand(rng, *want.shape)
    got, g = _torch_vjp(lambda t: dynamic_max_pooling(t, *out_hw), [x], cot)
    np.testing.assert_array_equal(got, want)
    if shift:
        assert (got < 0).all()
    _grads_match(g, _jax_vjp(lambda t: jdp(t, *out_hw), [jnp.asarray(x)],
                             jnp.asarray(cot)))


# ---------------------------------------------------------------- matching
@pytest.mark.parametrize("mode", ["dot", "mul", "plus", "minus", "concat"])
def test_matching_matrix_modes_match_jax(mode):
    from recommendflow_tpu.ops.matching import matching_matrix as jmm
    from recommendflow_tpu_torch.ops.matching import matching_matrix
    rng = np.random.RandomState(4)
    a, b = _rand(rng, 3, 5, 6), _rand(rng, 3, 7, 6)
    want = np.asarray(jmm(jnp.asarray(a), jnp.asarray(b), mode))
    cot = _rand(rng, *want.shape)
    got, g = _torch_vjp(lambda x, y: matching_matrix(x, y, mode), [a, b], cot)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _grads_match(g, _jax_vjp(lambda x, y: jmm(x, y, mode),
                             [jnp.asarray(a), jnp.asarray(b)],
                             jnp.asarray(cot)))


def test_matching_matrix_unknown_mode_raises():
    from recommendflow_tpu_torch.ops.matching import matching_matrix
    with pytest.raises(ValueError, match="unknown matching mode"):
        matching_matrix(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3), "cos")


@pytest.mark.parametrize("masked", [False, True])
def test_multi_perspective_matches_jax(masked):
    """With masks, row 0 of b is all padding: its max-pooling strategy is 0,
    not the -1e9 fill, and nothing is NaN; argmax takes the first maximum
    (row 1 of b repeats a position)."""
    from recommendflow_tpu.ops.matching import MultiPerspective as JMP
    from recommendflow_tpu_torch.ops.matching import MultiPerspective
    rng = np.random.RandomState(5)
    a, b = _rand(rng, 3, 5, 8), _rand(rng, 3, 6, 8)
    b[1, 4] = b[1, 2]
    mask_a = rng.rand(3, 5) > 0.3
    mask_b = rng.rand(3, 6) > 0.3
    mask_b[0] = False
    mask_b[1, 2:5] = True
    masks = (mask_a, mask_b) if masked else (None, None)
    jm = JMP(num_perspectives=4)
    jmask = [None if m is None else jnp.asarray(m) for m in masks]
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b), *jmask))
    assert variables["params"]["perspectives"].shape == (4, 4, 8)
    tm = MultiPerspective(8, num_perspectives=4, device="cpu")
    interop.load_jax_variables(tm, variables)
    cot = _rand(rng, 3, 5, 16)

    def jfn(w, x, y):
        return jm.apply({"params": {"perspectives": w}}, x, y, *jmask)

    args = [variables["params"]["perspectives"], a, b]
    want_out = np.asarray(jfn(*[jnp.asarray(t) for t in args]))
    leaves = [tm.perspectives] + [torch.tensor(t, requires_grad=True)
                                  for t in (a, b)]
    tmask = [None if m is None else torch.from_numpy(m) for m in masks]
    out = tm(leaves[1], leaves[2], *tmask)
    (out * torch.from_numpy(cot)).sum().backward()
    got = out.detach().numpy()
    assert got.shape == (3, 5, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want_out, rtol=0, atol=ATOL)
    if masked:
        assert not got[0, :, 4:8].any()           # max-pooling of row 0
        assert not got[~mask_a].any()
    _grads_match([tm.perspectives.grad.numpy(), leaves[1].grad.numpy(),
                  leaves[2].grad.numpy()],
                 _jax_vjp(jfn, [jnp.asarray(t) for t in args],
                          jnp.asarray(cot)))


def test_multi_perspective_init_is_lecun_normal():
    from recommendflow_tpu_torch.ops.matching import MultiPerspective
    torch.manual_seed(0)
    m = MultiPerspective(64, num_perspectives=16, device="cpu")
    w = m.perspectives.detach()
    # flax's fan-in of a [4, P, D] kernel is 4·P: variance 1 / 64
    assert abs(float(w.std()) - 0.125) < 0.01
    assert float(w.abs().max()) <= 2 * 0.125 / .87962566103423978 + 1e-6


# ------------------------------------------------------------------- image
def test_patch_embed_matches_jax():
    from recommendflow_tpu.ops.embedding import patch_embed as jpe
    from recommendflow_tpu_torch.ops.embedding import IMAGE_PATCH, patch_embed
    assert IMAGE_PATCH == 8
    rng = np.random.RandomState(6)
    proj, img = _rand(rng, 192, 24), rng.uniform(0, 255, (3, 32, 32, 3)).astype(
        np.float32)
    cot = _rand(rng, 3, 24)
    got, g = _torch_vjp(patch_embed, [proj, img], cot)
    want = np.asarray(jpe(jnp.asarray(proj), jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    _grads_match(g, _jax_vjp(jpe, [jnp.asarray(proj), jnp.asarray(img)],
                             jnp.asarray(cot)))


@pytest.mark.parametrize("pooling", ["cls", "avg"])
def test_image_encoder_matches_jax(pooling):
    """The ViT at the image slot's shape (32x32 pixels: 16 patches + [CLS],
    4 heads of 32), dropout 0, weights carried (cls and biases drawn away
    from their zero init): the output and the gradients of every
    parameter and of the pixels."""
    from recommendflow_tpu.ops.transformer import ImageEncoder as JImg
    from recommendflow_tpu_torch.ops.transformer import ImageEncoder
    rng = np.random.RandomState(7)
    img = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    jm = JImg(out_dim=24, dropout=0.0, pooling=pooling)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(img)))
    flat = interop.flatten(variables)
    for p, v in flat.items():
        if p[-1] in ("bias", "cls"):
            flat[p] = (0.1 * rng.randn(*v.shape)).astype(v.dtype)
    variables = interop.unflatten(flat)
    assert variables["params"]["pos_emb"].shape == (1, 17, 128)
    tm = ImageEncoder(32, out_dim=24, dropout=0.0, pooling=pooling,
                      device="cpu")
    interop.load_jax_variables(tm, variables)
    cot = _rand(rng, 4, 24)

    def jfn(params, x):
        return jm.apply({"params": params}, x, training=True)

    jout, vjp = jax.vjp(jfn, variables["params"], jnp.asarray(img))
    jg_params, jg_img = vjp(jnp.asarray(cot))
    x = torch.tensor(img, requires_grad=True)
    out = tm.train()(x)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)
    want = interop.variables_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jg_params)})
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        grad_close(got[k].numpy(), w.numpy(), err_msg=k)
    grad_close(x.grad.numpy(), jg_img)
    back = interop.flatten(interop.jax_from_variables(tm.state_dict()))
    for k, v in interop.flatten(variables).items():
        assert back[k].tobytes() == v.tobytes(), k


def test_image_encoder_pooling_is_checked():
    from recommendflow_tpu_torch.ops.transformer import ImageEncoder
    with pytest.raises(ValueError, match="unknown pooling"):
        ImageEncoder(32, pooling="max", device="cpu")
