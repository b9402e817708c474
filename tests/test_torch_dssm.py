"""Dssm inference with weights carried from the JAX package.

The flax model's variables (random tables, dense weights, and non-trivial
BatchNorm scale/bias and running statistics) go through interop into the
port's Dssm; on the same demo_recall batch the user/ad embeddings agree to
atol 2e-5 for f32 and bf16 tables (the same f32 matmuls and normalisation,
summed in another order; dropout is off in eval on both sides)."""
import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop

ATOL = 2e-5


def _perturb(variables, seed=0):
    """numpy copy of a flax tree with BatchNorm scale/bias/mean/var drawn
    away from their init values (var > 0)."""
    rng = np.random.RandomState(seed)
    flat = interop.flatten(jax.tree_util.tree_map(np.asarray, variables))
    for path, v in flat.items():
        leaf = path[-1]
        if path[-2].startswith("BatchNorm"):
            if leaf == "var":
                flat[path] = rng.uniform(0.5, 2.0, v.shape).astype(v.dtype)
            elif leaf == "scale":
                flat[path] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
            else:
                flat[path] = (0.3 * rng.randn(*v.shape)).astype(v.dtype)
    return interop.unflatten(flat)


def _pair(table_dtype):
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu_torch.models.base import build_network as tbuild
    nets = {"table_dtype": table_dtype, "tower_units": [64, 32]}
    jc, tc = tp.conf_pair(networks=nets)
    jmodel, _ = jbuild(jc.networks["class"], {"conf": jc})
    batch = synthetic_batch(compile_schema(jc.features), 24, seed=11)
    variables = jmodel.init(jax.random.PRNGKey(0), tp.to_jax(batch),
                            training=False)
    variables = _perturb(variables)
    tmodel, _ = tbuild(tc.networks["class"], {"conf": tc, "device": "cpu"})
    interop.load_jax_variables(tmodel, variables)
    return jmodel, tmodel, variables, batch


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_dssm_carried_weights_match(table_dtype):
    jmodel, tmodel, variables, batch = _pair(table_dtype)
    assert tmodel.embedder.table_dim16.dtype == (
        torch.bfloat16 if table_dtype == "bfloat16" else torch.float32)
    jout = jmodel.apply(variables, tp.to_jax(batch), training=False)
    with torch.no_grad():
        tout = tmodel(tp.to_torch(batch))
    assert sorted(jout) == sorted(tout) == ["ad", "label", "user"]
    for k in ("user", "ad"):
        assert tout[k].shape == (24, 128)
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(tout["label"].numpy(), np.asarray(jout["label"]))
    # the BatchNorm statistics did matter
    default = tmodel.user_tower.BatchNorm_0
    assert float((default.running_var - 1).abs().max()) > 0.1


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_interop_round_trip_is_bitwise(table_dtype, tmp_path):
    import ml_dtypes
    _, tmodel, variables, _ = _pair(table_dtype)
    back = interop.jax_from_variables(tmodel.state_dict(),
                                      bf16_dtype=ml_dtypes.bfloat16)
    a, b = interop.flatten(variables), interop.flatten(back)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    # the CLI checkpoint file: an npz of the flattened tree
    path = interop.save_variables_npz(str(tmp_path / "v"), back)
    loaded = interop.flatten(interop.load_variables_npz(path))
    assert sorted(loaded) == sorted(a)
    state = interop.variables_from_jax(interop.unflatten(loaded))
    for k, t in tmodel.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(state[k], t), k


def test_build_network_resolves_reference_names_without_the_jax_package():
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.models.matching.dssm import Dssm, TwoTower
    conf = Configuration(tp.DEMO_CONF)
    kw = {"conf": conf, "device": "cpu"}
    for name in ("recommendflow_tpu.models.matching.dssm.Dssm", "dssm",
                 "matching.dssm.Dssm", "models.matching.dssm.Dssm",
                 "recommendflow_tpu_torch.models.matching.dssm.Dssm"):
        model, restored = build_network(name, kw)
        assert type(model) is Dssm and restored is None
    assert type(build_network("two_tower", kw)[0]) is TwoTower
    from recommendflow_tpu_torch.models.matching.pdm import Pdm
    model, restored = build_network("recommendflow_tpu.models.matching.pdm.Pdm",
                                    kw)
    assert type(model) is Pdm and restored is None
    with pytest.raises(ImportError):
        build_network("no_such_model", kw)
