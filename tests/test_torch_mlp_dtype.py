"""MLP(compute_dtype="bfloat16") and Dssm's Networks.compute_dtype against
flax.

Tolerance, derived: both sides round the same quantities to bf16 in the
same places (the input; each Dense's f32 kernel and bias, its product and
its bias add; BatchNorm's output, normalised in f32 from f32 statistics;
each activation operation, with selu's constants rounded to bf16 as JAX
rounds a Python constant), and each rounded quantity comes from the same
operands, so the outputs may differ only where a bf16 product's f32
accumulation ends on the other side of a rounding boundary: 1 bf16 ulp of a
layer's output, carried on through the next layers. Held: outputs within 2
bf16 ulps of their magnitude [0 measured on this CPU, forward, training and
eval], running statistics (f32) within rtol 1e-6. The parameter
gradients are sums over the batch's 64 rows of bf16 cotangents, which XLA
accumulates in bf16 (a rounding per add, each up to 2^-9 of the partial
sum: ~sqrt(64) * 2^-9 = 2^-6 of the sum typically, 64 * 2^-9 = 2^-3 at
worst) where torch accumulates in f32 and rounds once: held within 2^-4 of
each leaf's largest magnitude [0.016 measured, a BatchNorm bias].

Against the f32 model the bf16 one differs by its roundings: per layer at
most ~4 bf16 roundings (2^-9 relative each) of the layer's output, so for L
layers and an L2-normalised output a row moves by at most ~2 * L * 4 *
2^-9; Dssm at conf/bench_recall.yaml's widths has L = 3 (512, 256, 128):
0.047, held at 2^-4 (chip_smoke.py's train_options phase holds that on the
card at full width; 0.0057 measured here at the demo widths).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop

ULP_TOL = 2.0
GRAD_TOL = 2.0 ** -4
F32_ROW_TOL = 2.0 ** -4


def _pair(units, act, use_bn, seed=0):
    from recommendflow_tpu.ops.mlp import MLP as JMLP
    from recommendflow_tpu_torch.ops.mlp import MLP
    x = np.random.RandomState(seed).randn(64, 40).astype(np.float32) * 2
    jm = JMLP(units, 0.0, act, use_bn=use_bn, final_activation="linear",
              compute_dtype="bfloat16")
    variables = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                       jnp.asarray(x), training=False))
    tm = MLP(40, units, 0.0, act, use_bn=use_bn, final_activation="linear",
             compute_dtype="bfloat16", device="cpu")
    tm.load_state_dict(interop.variables_from_jax(variables))
    return jm, variables, tm, x


@pytest.mark.parametrize("act,use_bn", [("selu", True), ("relu", False),
                                        ("selu", False)])
def test_bf16_mlp_matches_flax(act, use_bn):
    jm, variables, tm, x = _pair([64, 32, 16], act, use_bn)
    for p in tm.parameters():
        assert p.dtype == torch.float32
    # eval
    jy = np.asarray(jm.apply(variables, jnp.asarray(x), training=False))
    ty = tm.eval()(torch.from_numpy(x))
    assert ty.dtype == torch.float32 and jy.dtype == np.float32
    assert tp.bf16_ulp_err(ty.detach().numpy(), jy) <= ULP_TOL
    # training: batch statistics, moved running statistics, gradients
    w = np.random.RandomState(1).randn(64, 16).astype(np.float32)

    def loss(params):
        y, upd = jm.apply({**variables, "params": params}, jnp.asarray(x),
                          training=True, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd)

    (_, (jy, jupd)), jg = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    ty = tm.train()(torch.from_numpy(x))
    (ty * torch.from_numpy(w)).sum().backward()
    assert tp.bf16_ulp_err(ty.detach().numpy(), np.asarray(jy)) <= ULP_TOL
    got = interop.jax_from_variables(tm.state_dict())
    for k, v in tp.flat_tree(jax.device_get(jupd)).items():
        np.testing.assert_allclose(tp.flat_tree(got)[k], v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    grads = tp.flat_tree(interop.jax_from_variables(
        {n: p.grad for n, p in tm.named_parameters()}))
    for k, v in tp.flat_tree({"params": jax.device_get(jg)}).items():
        scale = max(float(np.abs(v).max()), 1e-30)
        assert float(np.abs(grads[k] - v).max()) <= GRAD_TOL * scale, k


def test_compute_dtype_off_is_the_f32_mlp():
    from recommendflow_tpu_torch.ops.mlp import MLP
    torch.manual_seed(0)
    a = MLP(8, [4], activation="selu", use_bn=True, device="cpu")
    b = MLP(8, [4], activation="selu", use_bn=True, compute_dtype="float32",
            device="cpu")
    b.load_state_dict(a.state_dict())
    x = torch.randn(5, 8)
    np.testing.assert_allclose(b.eval()(x).detach(), a.eval()(x).detach(),
                               rtol=1e-6, atol=1e-7)


NETS = {"tower_units": [64, 32], "table_dtype": "bfloat16",
        "compute_dtype": "bfloat16"}


def test_bf16_dssm_matches_jax():
    """Dssm reads Networks.compute_dtype for both towers: its eval outputs
    (unit vectors, within ULP_TOL) and its training loss (rtol 1e-5: the
    loss in f32 from those vectors) against the JAX Dssm with the same
    weights (interop), and the f32 model within F32_ROW_TOL a row."""
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    from recommendflow_tpu.models.matching.dssm import Dssm as JDssm
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    jc, tc = tp.conf_pair(networks=NETS)
    batch = synthetic_batch(compile_schema(jc.features), 64, seed=4)
    jm = JDssm(jc, dropout=0.0)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                       tp.to_jax(batch), training=False))
    tm = Dssm(tc, dropout=0.0, device="cpu")
    interop.load_jax_variables(tm, variables)
    assert tm.user_tower.compute_dtype == torch.bfloat16
    jout = jm.apply(variables, tp.to_jax(batch), training=False)
    with torch.no_grad():
        tout = tm.eval()(tp.to_torch(batch))
    for k in ("user", "ad"):
        assert tp.bf16_ulp_err(tout[k].numpy(), np.asarray(jout[k])) <= ULP_TOL
    (jl, _), _ = jm.apply(variables, tp.to_jax(batch), training=True,
                          mutable=["batch_stats"])
    tl, _ = tm.train()(tp.to_torch(batch))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _, tc32 = tp.conf_pair(networks=dict(NETS, compute_dtype=None))
    f32 = Dssm(tc32, dropout=0.0, device="cpu")
    f32.load_state_dict(tm.state_dict())
    with torch.no_grad():
        ref = f32.eval()(tp.to_torch(batch))
    for k in ("user", "ad"):
        rows = (tout[k] - ref[k]).norm(dim=1)
        assert float(rows.max()) <= F32_ROW_TOL, k
        assert float(rows.max()) > 0            # bf16 did round
