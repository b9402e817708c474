"""The ranking models with attention against the JAX package on the CPU:
Din on conf/demo_din.yaml, TabTransformer and Esim on conf/demo_ranking.yaml,
at the small widths of tests/test_models.py (f32 tables, dropout 0).

The flax model's variables (biases, Dice's alpha and running statistics
drawn away from their init) are carried into the port through interop.py.
On the same synthetic batch (Esim's with an all-pad query row and an
all-pad doc row):

  * every eval output is within atol 1e-5 (the same f32 products summed in
    another order; outputs of ~1);
  * the training loss and its parts are within atol 1e-5, and the
    gradients of the loss into every parameter (the tables' dense
    gradients included) within rtol 1e-4 + atol 1e-6 (sums over the batch
    in another order);
  * the carried weights go back to the flax tree bit for bit.

Three training steps from a carried JAX TrainState are in
test_torch_ranking_attention_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop

RANK_CONF = f"{tp.ROOT}/conf/demo_ranking.yaml"
DIN_CONF = f"{tp.ROOT}/conf/demo_din.yaml"
ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PKG = "recommendflow_tpu.models.ranking"
# name -> (config, class path, model kwargs at test widths, dropout 0)
MODELS = {
    "din": (DIN_CONF, f"{PKG}.din.Din", {"hidden_units": [64, 32]}),
    "tabtransformer": (RANK_CONF, f"{PKG}.tabtransformer.TabTransformer",
                       {"num_blocks": 2, "hidden_units": (32,)}),
    "esim": (RANK_CONF, f"{PKG}.esim.Esim",
             {"model_dim": 32, "mlp_units": (32,), "vocab_size": 200}),
}


def model_batch(name, table_dtype="float32", b=48, seed=3):
    """(JAX conf, port conf, a synthetic batch); Esim's has an all-pad query
    row and an all-pad doc row."""
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    jc, tc = tp.conf_pair(MODELS[name][0],
                          networks={"table_dtype": table_dtype})
    batch = synthetic_batch(compile_schema(jc.features), b, seed=seed)
    if name == "esim":
        batch["query_tokens"][0] = 0
        batch["title_tokens"][1] = 0
    return jc, tc, batch


def build_pair(name, jc, tc, batch, seed=0):
    """(flax model, its variables with the zero-initialised leaves drawn
    away from their init, the port's model carrying them)."""
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu_torch.models.base import build_network as tbuild
    _, path, kw = MODELS[name]
    kw = dict(kw, dropout=0.0)
    jmodel, _ = jbuild(path, {"conf": jc, **kw})
    variables = jmodel.init(jax.random.PRNGKey(seed), tp.to_jax(batch),
                            training=False)
    rng = np.random.RandomState(seed)
    flat = interop.flatten(jax.tree_util.tree_map(np.asarray, variables))
    for p, v in flat.items():
        if p[-1] in ("bias", "alpha", "mean"):
            flat[p] = (0.1 * rng.randn(*v.shape)).astype(v.dtype)
        elif p[-1] == "var":
            flat[p] = rng.uniform(0.5, 2.0, v.shape).astype(v.dtype)
    variables = interop.unflatten(flat)
    tmodel, _ = tbuild(path, {"conf": tc, "device": "cpu", **kw})
    interop.load_jax_variables(tmodel, variables)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_outputs_match_jax(name):
    jc, tc, batch = model_batch(name)
    jmodel, variables, tmodel = build_pair(name, jc, tc, batch)
    jout = jmodel.apply(variables, tp.to_jax(batch), training=False)
    with torch.no_grad():
        tout = tmodel.eval()(tp.to_torch(batch))
    assert sorted(tout) == sorted(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    score = tout["score"].numpy()
    assert score.shape == (48,) and ((score > 0) & (score < 1)).all()


@pytest.mark.parametrize("name", list(MODELS))
def test_training_loss_and_gradients_match_jax(name):
    jc, tc, batch = model_batch(name, seed=4)
    jmodel, variables, tmodel = build_pair(name, jc, tc, batch, seed=1)
    mutable = ["batch_stats"] if "batch_stats" in variables else False
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss_of(params):
        out = jmodel.apply({"params": params, **rest}, tp.to_jax(batch),
                           training=True, mutable=mutable)
        loss, aux = out[0] if mutable else out
        return loss, aux

    (jloss, jaux), jgrads = jax.value_and_grad(loss_of, has_aux=True)(
        variables["params"])
    tloss, taux = tmodel.train()(tp.to_torch(batch))
    tloss.backward()
    assert sorted(taux) == sorted(jaux)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=0,
                               atol=ATOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), rtol=0,
                                   atol=ATOL, err_msg=k)
    want = interop.variables_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        assert got[k] is not None, k
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    if name == "din":       # Dice's batch statistics took the same step
        _, upd = jmodel.apply(variables, tp.to_jax(batch), training=True,
                              mutable=["batch_stats"])
        stats = interop.variables_from_jax(
            {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                   upd["batch_stats"])})
        own = tmodel.state_dict()
        assert sorted(stats) == ["dice0.BatchNorm_0.running_mean",
                                 "dice0.BatchNorm_0.running_var",
                                 "dice1.BatchNorm_0.running_mean",
                                 "dice1.BatchNorm_0.running_var"]
        for k, v in stats.items():
            np.testing.assert_allclose(own[k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_interop_round_trip_is_bitwise(name):
    jc, tc, batch = model_batch(name, b=8)
    _, variables, tmodel = build_pair(name, jc, tc, batch)
    back = interop.jax_from_variables(tmodel.state_dict())
    a, b = interop.flatten(variables), interop.flatten(back)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    keys = {"/".join(k) for k in a}
    expect = {"din": ["params/dice0/alpha", "batch_stats/dice1/BatchNorm_0/var",
                      "params/att_out/kernel"],
              "tabtransformer": ["params/tab/block1/mha/q/kernel",
                                 "params/tab/block0/ln2/scale"],
              "esim": ["params/tok_emb/embedding", "params/input_enc/mha/k/bias",
                       "params/proj2/kernel", "params/compose/ffn/Dense_1/bias"]}
    assert set(expect[name]) <= keys


def test_esim_all_pad_rows_pool_to_zero():
    """A fully padded query (row 0) or doc (row 1) pools to 0, not to the
    -1e9 fill: the port's pooled features equal JAX's _masked_pools."""
    from recommendflow_tpu.models.ranking.esim import _masked_pools
    from recommendflow_tpu_torch.models.ranking.esim import masked_pools
    rng = np.random.RandomState(2)
    x = rng.randn(3, 6, 4).astype(np.float32)
    mask = rng.rand(3, 6) > 0.4
    mask[0] = False
    mask[1, 0] = True
    got = masked_pools(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = np.asarray(_masked_pools(jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[0].any()


def test_din_cand_proj_when_the_widths_differ(tmp_path):
    """A candidate pooled wider than a sequence position gets the
    `cand_proj` layer, as in JAX; eval outputs still match."""
    from recommendflow_tpu.config import Configuration as JConf
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    from recommendflow_tpu.models.ranking.din import Din as JDin
    from recommendflow_tpu_torch.config import Configuration as TConf
    from recommendflow_tpu_torch.models.ranking.din import Din
    text = open(DIN_CONF).read().replace(
        "clk_seq,str,user,hashing,20000,16,null,true",
        "clk_seq,str,user,lookup,20000,16,null,true")
    path = tmp_path / "din.yaml"
    path.write_text(text)
    jc, tc = JConf(str(path)), TConf(str(path))
    batch = synthetic_batch(compile_schema(jc.features), 16, seed=1)
    jm = JDin(conf=jc, hidden_units=[32], dropout=0.0)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), tp.to_jax(batch)))
    assert "cand_proj" in variables["params"]
    tm = Din(tc, hidden_units=[32], dropout=0.0, device="cpu")
    interop.load_jax_variables(tm, variables)
    with torch.no_grad():
        got = tm(tp.to_torch(batch))["logit"].numpy()
    want = np.asarray(jm.apply(variables, tp.to_jax(batch))["logit"])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_short_names_resolve_to_the_port():
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.models.ranking import (DIN, Din, Esim,
                                                        TabTransformer)
    assert DIN is Din
    for conf, names, cls in (
            (DIN_CONF, ("recommendflow_tpu.models.ranking.din.Din", "din",
                        "ranking.din.Din", "DIN"), Din),
            (RANK_CONF, ("recommendflow_tpu.models.ranking.tabtransformer."
                         "TabTransformer", "tabtransformer"), TabTransformer),
            (RANK_CONF, ("recommendflow_tpu.models.ranking.esim.Esim", "esim"),
             Esim)):
        _, tc = tp.conf_pair(conf)
        for name in names:
            model, restored = build_network(name, {"conf": tc, "device": "cpu"})
            assert type(model) is cls and restored is None, name
            assert model.row_injection and not model.training


def test_init_dense_skips_a_linear_without_bias():
    """init_dense_ draws every Linear's weight and zeroes the bias only
    where there is one (LocationBasedAttention's key and out have none)."""
    from torch import nn
    from recommendflow_tpu_torch.models.base import init_dense_
    from recommendflow_tpu_torch.ops.attention import LocationBasedAttention
    m = nn.Module()
    m.lba = LocationBasedAttention(64)
    m.lin = nn.Linear(64, 8)
    with torch.no_grad():
        m.lin.bias.fill_(1.0)
        m.lba.key.weight.zero_()
    init_dense_(m, torch.Generator().manual_seed(0))
    assert m.lba.key.bias is None and m.lba.out.bias is None
    assert float(m.lba.key.weight.detach().std()) > 0.05
    assert not m.lin.bias.any()


def test_esim_token_outside_the_vocab_raises_where_flax_fills_nan():
    """A token id past Esim's vocab: flax's Embed (jnp.take's fill mode)
    reads a NaN row and the score is NaN; the port's nn.Embedding raises (on
    the card it stops with a device-side assert). A recorded choice."""
    jc, tc, batch = model_batch("esim", b=4)
    jmodel, variables, tmodel = build_pair("esim", jc, tc, batch)
    batch["query_tokens"][2, 0] = 200            # the vocab is 200
    jout = jmodel.apply(variables, tp.to_jax(batch), training=False)
    assert np.isnan(np.asarray(jout["score"])[2])
    with pytest.raises(IndexError):
        with torch.no_grad():
            tmodel(tp.to_torch(batch))


def test_trainer_guard_restores_dice_statistics():
    """Trainer.init_state's row-injection guard runs a two-row training
    forward on Din: Dice's running statistics come back as they were."""
    from recommendflow_tpu_torch.train.trainer import Trainer
    jc, tc, batch = model_batch("din", b=8)
    _, _, tmodel = build_pair("din", jc, tc, batch)
    before = {k: v.clone() for k, v in tmodel.named_buffers()}
    trainer = Trainer(tmodel, table_update="split", device="cpu")
    trainer.init_state(batch)
    assert trainer._split_dims
    for k, v in tmodel.named_buffers():
        assert torch.equal(v, before[k]), k
