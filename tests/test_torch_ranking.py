"""The ranking, preranking and reranking models against the JAX package on
conf/demo_ranking.yaml at small widths (f32 tables, dropout 0).

The flax model's variables (dense kernels, and biases and cross-layer
offsets drawn away from their zero init) are carried into the port through
interop.py. On the same demo_ranking batch:

  * every eval output is within atol 1e-5 (the same f32 products, summed
    in another order: the outputs are probabilities and logits of ~1);
  * the training loss and its parts are within atol 1e-5;
  * the carried weights go back to the flax tree bit for bit.

The port's embed_batch also skips the config's token slots as the JAX one
does (query_tokens, title_tokens), with the same pooled features. Three
training steps from a carried JAX TrainState are in
test_torch_ranking_train.py.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop

RANK_CONF = f"{tp.ROOT}/conf/demo_ranking.yaml"
ATOL = 1e-5
PKG = "recommendflow_tpu.models"
# name -> (class path, model kwargs at test widths, dropout 0)
MODELS = {
    "dnn": (f"{PKG}.ranking.dnn.Dnn", {"hidden_units": [64, 32]}),
    "dcn": (f"{PKG}.ranking.dcn.Dcn", {"hidden_units": [64, 32],
                                       "cross_layers": 2}),
    "deepfm": (f"{PKG}.ranking.deepfm.DeepFm", {"hidden_units": [64, 32]}),
    "xdeepfm": (f"{PKG}.ranking.deepfm.XDeepFm", {"hidden_units": [64, 32],
                                                  "cin_layers": (16, 8)}),
    "cold": (f"{PKG}.preranking.cold.Cold", {"hidden_units": (64, 32)}),
    "mmoe": (f"{PKG}.ranking.mmoe.Mmoe", {"expert_units": (64, 32),
                                          "tower_units": (16,),
                                          "num_experts": 3}),
    "essm": (f"{PKG}.ranking.essm.Essm", {"tower_units": (64, 32)}),
    "escm2_dr": (f"{PKG}.reranking.escm2.Escm2",
                 {"tower_units": (64, 32), "counterfactual": "dr"}),
    "escm2_ips": (f"{PKG}.reranking.escm2.Escm2",
                  {"tower_units": (32,), "counterfactual": "ips"}),
}


def ranking_batch(table_dtype="float32", b=48, seed=3):
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    jc, tc = tp.conf_pair(RANK_CONF, networks={"table_dtype": table_dtype})
    return jc, tc, synthetic_batch(compile_schema(jc.features), b, seed=seed)


def build_pair(name, jc, tc, batch, seed=0):
    """(flax model, its variables with the zero-initialised leaves drawn
    away from 0, the port's model carrying them)."""
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu_torch.models.base import build_network as tbuild
    path, kw = MODELS[name]
    kw = dict(kw, dropout=0.0)
    jmodel, _ = jbuild(path, {"conf": jc, **kw})
    variables = jmodel.init(jax.random.PRNGKey(seed), tp.to_jax(batch),
                            training=False)
    rng = np.random.RandomState(seed)
    flat = interop.flatten(jax.tree_util.tree_map(np.asarray, variables))
    for p, v in flat.items():
        if p[-1] == "bias" or (p[-1][0] == "b" and p[-1][1:].isdigit()):
            flat[p] = (0.1 * rng.randn(*v.shape)).astype(v.dtype)
    variables = interop.unflatten(flat)
    tmodel, _ = tbuild(path, {"conf": tc, "device": "cpu", **kw})
    interop.load_jax_variables(tmodel, variables)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_outputs_match_jax(name):
    jc, tc, batch = ranking_batch()
    jmodel, variables, tmodel = build_pair(name, jc, tc, batch)
    jout = jmodel.apply(variables, tp.to_jax(batch), training=False)
    with torch.no_grad():
        tout = tmodel.eval()(tp.to_torch(batch))
    assert sorted(tout) == sorted(jout)
    assert "score" in tout and "label" in tout
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    score = tout["score"].numpy()
    assert score.shape == (48,) and ((score > 0) & (score < 1)).all()


@pytest.mark.parametrize("name", list(MODELS))
def test_training_loss_matches_jax(name):
    jc, tc, batch = ranking_batch(seed=4)
    jmodel, variables, tmodel = build_pair(name, jc, tc, batch, seed=1)
    jloss, jaux = jmodel.apply(variables, tp.to_jax(batch), training=True)
    with torch.no_grad():
        tloss, taux = tmodel.train()(tp.to_torch(batch))
    assert sorted(taux) == sorted(jaux)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=0, atol=ATOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=0,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_interop_round_trip_is_bitwise(name):
    jc, tc, batch = ranking_batch(b=8)
    _, variables, tmodel = build_pair(name, jc, tc, batch)
    back = interop.jax_from_variables(tmodel.state_dict())
    a, b = interop.flatten(variables), interop.flatten(back)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    if name == "mmoe":                     # the stacked [E, in, out] kernels
        kernel = a[("params", "ExpertsMLP_0", "experts", "Dense_0", "kernel")]
        assert kernel.shape[0] == 3 and kernel.ndim == 3
        assert torch.equal(tmodel.ExpertsMLP_0.experts.Dense_0.weight,
                           torch.from_numpy(np.array(kernel)))


def test_embed_batch_skips_token_slots_as_jax():
    """query_tokens and title_tokens are left to their text encoders: the
    same pooled features as the JAX embed_batch, bit for bit."""
    from recommendflow_tpu.ops.embedding import embed_batch as jembed
    from recommendflow_tpu_torch.ops.embedding import embed_batch as tembed
    jc, tc, batch = ranking_batch(b=16)
    jmodel, variables, tmodel = build_pair("dnn", jc, tc, batch)
    tables = tmodel.embedder.tables()
    jtables = {k: variables["params"]["embedder"][f"table_{k}"] for k in tables}
    jf = jembed(jtables, jmodel.schema, tp.to_jax(batch))
    with torch.no_grad():
        tf = tembed(tables, tmodel.schema, tp.to_torch(batch))
    assert {"query_tokens", "title_tokens"} <= set(batch)
    assert sorted(tf) == sorted(jf)
    assert not {"query_tokens", "title_tokens"} & set(tf)
    for k in jf:
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]), k)


def test_short_names_resolve_to_the_port():
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.models.preranking.cold import Cold
    from recommendflow_tpu_torch.models.ranking import (Dcn, DeepFm, Dnn,
                                                        Essm, Mmoe, XDeepFm)
    from recommendflow_tpu_torch.models.reranking.escm2 import Escm2
    _, tc, _ = ranking_batch(b=2)
    kw = {"conf": tc, "device": "cpu"}
    for name, cls in (("recommendflow_tpu.models.ranking.dcn.Dcn", Dcn),
                      ("dcn", Dcn), ("dnn", Dnn), ("ranking.dnn.Dnn", Dnn),
                      ("deepfm", DeepFm), ("xdeepfm", XDeepFm),
                      ("mmoe", Mmoe), ("essm", Essm), ("esmm", Essm),
                      ("cold", Cold), ("escm2", Escm2)):
        model, restored = build_network(name, kw)
        assert type(model) is cls and restored is None, name
        assert model.row_injection and not model.training
