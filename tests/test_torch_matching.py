"""The other matching models against the JAX package on the CPU:
SiameseEncoder (every merge mode), DssmEncoder and Que2Search (with and
without its aux head) on conf/demo_text_recall.yaml, Pdm and Mobius on
conf/demo_recall.yaml, and Dssm with an image slot (linear patch projection
and the ViT) on tests/test_image.py's layout, at small widths.

Dropout is 0 on both sides: the port's modules are set to p = 0, and flax's
Dropout is replaced by the identity for the test (the JAX models' text
encoders keep their own rate of 0.1 whatever the model's `dropout`). The
flax variables (biases drawn away from their zero init) are carried into the
port through interop.py. On the same synthetic batch, one of whose rows has
an all-padding text (every attention key masked):

  * every eval output is within atol 1e-5 (the same f32 products summed in
    another order; outputs of ~1);
  * the training loss and every aux metric are within atol 1e-5, and the
    gradients of the loss into every parameter within rtol 1e-4 + atol
    1e-6 · max(1, the leaf's largest magnitude);
  * the carried variables go back to the flax tree bit for bit.

The image cases' gradients are held within 50 times that atol: their
pixels are integers in [0, 100) (synthetic_batch), so the ad tower's first
BatchNorm centres inputs of ~1e2, and the f32 noise of its outputs, and so
of the next Dense layer's weight gradient, is that much larger (2.1e-5 of
the leaf's largest magnitude seen).

Three carried training steps per model are in test_torch_matching_train.py.
"""
import os

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop
from test_torch_matching_ops import grad_close

TEXT_CONF = f"{tp.ROOT}/conf/demo_text_recall.yaml"
ATOL = 1e-5
IMAGE_GRAD_SCALE = 50
PKG = "recommendflow_tpu.models.matching"
# small text encoders for the test (the demo's SiameseEncoder keys apply)
SMALL_TEXT = {"user_encoder": {"vocab_size": 256, "num_layers": 1,
                               "model_dim": 32},
              "ad_encoder": {"vocab_size": 256, "num_layers": 2,
                             "model_dim": 16, "pooling": "avg"}}
# the test_image.py layout (an 8x8-patch image slot of 32x32 pixels)
IMAGE_CONF = """
Features:
  feature_group:
    user_id: [user_id]
    item_id: [item_id]
    item_img: [item_img]
  feature_fields: [group, type, tower, deal, vocab, embedding_dim, pooling, working]
  features:
    user_id,str,user,hashing,2000,16,sum,true
    item_id,str,ad,hashing,2000,16,sum,true
    item_img,str,ad,image,null,24,null,true
    label,float,label,numeric,null,-1,null,true
Variables:
  seeds: [2022, 2023]
  max_len_map:
    item_img: 32
Networks:
  class: recommendflow_tpu.models.matching.dssm.Dssm
  loss: recommendflow_tpu.losses.match.batch_neg_sample_scaled_multi_class_ce_loss
  embedding_dim: 32
  tower_units: [32]
Task:
  task: test_image
Train:
  data: /tmp/unused
  epoch: 1
  batch_size: 16
"""


def _variant(tmp_dir, name, text):
    path = os.path.join(tmp_dir, f"{name}.yaml")
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write(text)
    return path


def conf_path(kind, tmp_dir):
    """A config file for a case: the shipped demos, or a variant written
    into tmp_dir (two texts a tower; a second label; the image layout)."""
    if kind == "text":
        return TEXT_CONF
    if kind == "recall":
        return tp.DEMO_CONF
    if kind == "image":
        return _variant(tmp_dir, "image", IMAGE_CONF)
    text = open(TEXT_CONF).read()
    if kind == "two_texts":
        text = text.replace(
            "    title_text,str,ad,bert_encode,$bert_vocab,-1,cls,true\n",
            "    query_text2,str,user,bert_encode,$bert_vocab,-1,cls,true\n"
            "    title_text,str,ad,bert_encode,$bert_vocab,-1,cls,true\n"
            "    title_text2,str,ad,bert_encode,$bert_vocab,-1,cls,true\n"
        ).replace("    title_text: 16\n", "    title_text: 16\n"
                  "    query_text2: 12\n    title_text2: 8\n")
    elif kind == "aux_label":
        text = text.replace(
            "    label,float,label,numeric,null,-1,null,true\n",
            "    label,float,label,numeric,null,-1,null,true\n"
            "    quality,float,label,numeric,null,-1,null,true\n")
    return _variant(tmp_dir, kind, text)


# the port's models that take no `dropout`
TEXT_ONLY = (".SiameseEncoder", ".DssmEncoder")
# case -> (config kind, class path, model kwargs, Networks overrides)
CASES = {
    "siamese": ("text", f"{PKG}.siamese_encoder.SiameseEncoder", {}, {}),
    "siamese-dense": ("two_texts", f"{PKG}.siamese_encoder.SiameseEncoder",
                      {}, {"embedding_pooling": "dense"}),
    "siamese-sum": ("two_texts", f"{PKG}.siamese_encoder.SiameseEncoder", {},
                    {"embedding_pooling": "sum", "text_pooling": "avg"}),
    "siamese-mean": ("two_texts", f"{PKG}.siamese_encoder.SiameseEncoder",
                     {}, {"embedding_pooling": "mean"}),
    "siamese-attention": ("two_texts",
                          f"{PKG}.siamese_encoder.SiameseEncoder", {},
                          {"embedding_pooling": "attention"}),
    "dssm_encoder": ("text", f"{PKG}.dssm_encoder.DssmEncoder", {},
                     SMALL_TEXT),
    "que2search": ("text", f"{PKG}.que2search.Que2Search",
                   {"text_layers": 1, "channel_dim": 32}, {}),
    "que2search-aux": ("aux_label", f"{PKG}.que2search.Que2Search",
                       {"text_layers": 1, "channel_dim": 32},
                       {"aux_weight": 0.5}),
    "pdm": ("recall", f"{PKG}.pdm.Pdm", {"tower_units": (64,)}, {}),
    "mobius": ("recall", f"{PKG}.mobius.Mobius", {"tower_units": (64,)}, {}),
    "dssm-image": ("image", f"{PKG}.dssm.Dssm", {}, {}),
    "dssm-vit": ("image", f"{PKG}.dssm.Dssm", {}, {"image_encoder": "vit"}),
}


@pytest.fixture(autouse=True)
def no_flax_dropout(monkeypatch):
    """flax's Dropout as the identity: the JAX text encoders drop at their
    own rate whatever the model's `dropout` is."""
    import flax.linen as nn
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)


def model_batch(name, tmp_dir, table_dtype="float32", b=24, seed=3,
                networks=None):
    """(JAX conf, port conf, a synthetic batch); the first row's texts are
    all padding. `networks` overrides the case's Networks keys."""
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    kind, _, _, nets = CASES[name]
    jc, tc = tp.conf_pair(conf_path(kind, tmp_dir), networks={
        "table_dtype": table_dtype, **nets, **(networks or {})})
    schema = compile_schema(jc.features)
    batch = synthetic_batch(schema, b, seed=seed)
    for n in schema.order:
        if schema.slots[n].kind in ("token", "bert"):
            batch[n][0] = 0
    return jc, tc, batch


def port_kw(path, kw):
    """`kw` without `dropout` for the port's text two-towers, which take
    none (their encoders drop at their own rate; JAX's field is dead)."""
    if path.endswith(TEXT_ONLY):
        return {k: v for k, v in kw.items() if k != "dropout"}
    return kw


def build_pair(name, jc, tc, batch, seed=0):
    """(flax model, its variables with biases drawn away from 0, the port's
    model carrying them, dropout 0)."""
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu_torch.models.base import build_network as tbuild
    _, path, kw, _ = CASES[name]
    kw = dict(kw, dropout=0.0)
    jmodel, _ = jbuild(path, {"conf": jc, **kw})
    variables = jax.jit(jmodel.init, static_argnames=("training",))(
        jax.random.PRNGKey(seed), tp.to_jax(batch), training=False)
    rng = np.random.RandomState(seed)
    flat = interop.flatten(jax.tree_util.tree_map(np.asarray, variables))
    for p, v in flat.items():
        if p[-1] in ("bias", "cls"):
            flat[p] = (0.1 * rng.randn(*v.shape)).astype(v.dtype)
    variables = interop.unflatten(flat)
    tmodel, _ = tbuild(path, {"conf": tc, "device": "cpu",
                              **port_kw(path, kw)})
    for m in tmodel.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    interop.load_jax_variables(tmodel, variables)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("name", list(CASES))
def test_eval_outputs_match_jax(name, tmp_path):
    jc, tc, batch = model_batch(name, str(tmp_path))
    jmodel, variables, tmodel = build_pair(name, jc, tc, batch)
    jout = jax.jit(jmodel.apply)(variables, tp.to_jax(batch))
    with torch.no_grad():
        tout = tmodel.eval()(tp.to_torch(batch))
    assert sorted(tout) == sorted(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    assert tout["user"].shape[0] == 24
    np.testing.assert_allclose(torch.linalg.vector_norm(tout["user"], dim=1),
                               1.0, atol=1e-5)
    if name == "mobius":
        assert tout["relevance"].shape == (24,)
    if name == "que2search-aux":
        assert "aux_score" in tout


@pytest.mark.parametrize("name", list(CASES))
def test_training_loss_and_gradients_match_jax(name, tmp_path):
    jc, tc, batch = model_batch(name, str(tmp_path), seed=4)
    jmodel, variables, tmodel = build_pair(name, jc, tc, batch, seed=1)
    mutable = ["batch_stats"] if "batch_stats" in variables else False
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss_of(params):
        out = jmodel.apply({"params": params, **rest}, tp.to_jax(batch),
                           training=True, mutable=mutable)
        return out[0] if mutable else out

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(variables["params"])
    tloss, taux = tmodel.train()(tp.to_torch(batch))
    tloss.backward()
    assert sorted(taux) == sorted(jaux)
    if name == "que2search-aux":
        assert "aux_loss" in taux
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=0,
                               atol=ATOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
    want = interop.variables_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert sorted(want) == sorted(got)
    scale = IMAGE_GRAD_SCALE if CASES[name][0] == "image" else 1.0
    for k, w in want.items():
        assert got[k] is not None, k
        grad_close(got[k].numpy(), w.numpy(), err_msg=k, scale=scale)


@pytest.mark.parametrize("name", list(CASES))
def test_interop_round_trip_is_bitwise(name, tmp_path):
    jc, tc, batch = model_batch(name, str(tmp_path), b=8)
    _, variables, tmodel = build_pair(name, jc, tc, batch)
    back = interop.jax_from_variables(tmodel.state_dict())
    a, b = interop.flatten(variables), interop.flatten(back)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k
    keys = {"/".join(k) for k in a}
    expect = {
        "siamese": ["params/encoder/tok_emb/embedding",
                    "params/encoder/block1/mha/q/kernel",
                    "params/user_proj/kernel"],
        "siamese-attention": ["params/user_fusion/att/kernel",
                              "stats/ad_fusion/infer_weights",
                              "stats/ad_fusion/infer_count"],
        "dssm_encoder": ["params/user_encoder/block0/ln2/scale",
                         "params/ad_encoder/block1/ffn/Dense_1/bias",
                         "params/ad_proj/kernel"],
        "que2search": ["params/text_encoder/seg_emb/embedding",
                       "params/ad_txt0/Dense_0/kernel",
                       "params/ad_ch0/Dense_0/bias", "params/user_out/kernel",
                       "stats/ad_fusion/infer_weights"],
        "que2search-aux": ["params/aux_head/kernel"],
        "pdm": ["params/attn_clk_item_ids/q/kernel",
                "params/attn_clk_cat_ids/v/bias",
                "params/user_tower/Dense_1/kernel",
                "params/embedder/table_dim16"],
        "mobius": ["params/user_rel/kernel", "params/ad_biz/bias",
                   "params/embedder/table_dim16"],
        "dssm-image": ["params/embedder/img_proj_item_img"],
        "dssm-vit": ["params/embedder/vit_item_img/cls",
                     "params/embedder/vit_item_img/pos_emb",
                     "params/embedder/vit_item_img/block1/mha/out/kernel",
                     "params/embedder/vit_item_img/head/bias"],
    }.get(name, [])
    assert set(expect) <= keys


def test_no_stray_image_error():
    """Neither the embedder nor the embed pass refuses an image slot now."""
    import inspect
    from recommendflow_tpu_torch.models import base
    from recommendflow_tpu_torch.ops import embedding
    for mod in (base, embedding):
        assert "does not have yet" not in inspect.getsource(mod)


def test_vit_stays_deterministic_in_training_mode(tmp_path):
    """The JAX embedder calls its ViT without `training`: the port's ViT
    stays in eval mode when the model trains, so its dropout never drops."""
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    _, tc, batch = model_batch("dssm-vit", str(tmp_path))
    model = Dssm(tc, device="cpu").train()
    vit = model.embedder.vit_item_img
    assert model.training and model.embedder.training and not vit.training
    assert vit.drop.p == 0.1
    x = tp.to_torch(batch)
    with torch.no_grad():
        a, b = vit(x["item_img"].float()), vit(x["item_img"].float())
    assert torch.equal(a, b)


def test_token_max_len_and_unpooled(tmp_path):
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.models.base import FeatureEmbedder as JEmb
    from recommendflow_tpu_torch.models.matching.pdm import Pdm
    from recommendflow_tpu_torch.models.matching.siamese_encoder import (
        SiameseEncoder)
    _, tc, _ = model_batch("siamese-dense", str(tmp_path))
    assert SiameseEncoder(tc, device="cpu").token_max_len() == 16
    jc, tc, batch = model_batch("pdm", str(tmp_path))
    model = Pdm(tc, device="cpu")
    assert model.token_max_len() == 64          # no token feature: default
    schema = model.schema
    je = JEmb(schema=compile_schema(jc.features))
    tables = {f"table_dim{d}": getattr(model.embedder, f"table_dim{d}"
                                       ).detach().numpy()
              for d in schema.groups}
    want = je.apply({"params": tables}, tp.to_jax(batch), "clk_item_ids",
                    method=JEmb.unpooled)
    got = model.embedder.unpooled(tp.to_torch(batch), "clk_item_ids")
    assert got.shape == (24, 2, 16, 16)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_trainer_evaluate_and_predict_leave_fusion_stats_unchanged(tmp_path):
    """As the JAX trainer discards its eval step's `stats` update."""
    from recommendflow_tpu_torch.ops.fusion import collecting_stats
    from recommendflow_tpu_torch.train.trainer import Trainer, predict
    jc, tc, batch = model_batch("que2search", str(tmp_path))
    _, _, tmodel = build_pair("que2search", jc, tc, batch)
    trainer = Trainer(tmodel, device="cpu")
    state = trainer.init_state(batch)
    logs = trainer.evaluate(state, [batch, batch])
    predict(tmodel, [batch], "cpu")
    assert np.isfinite(logs["val_loss"])
    assert not tmodel.ad_fusion.infer_weights.any()
    assert float(tmodel.ad_fusion.infer_count) == 0
    with collecting_stats(tmodel), torch.no_grad():
        tmodel.eval()(tp.to_torch(batch))
    assert float(tmodel.ad_fusion.infer_count) == 1
    np.testing.assert_allclose(float(tmodel.ad_fusion.infer_weights.sum()),
                               1.0, atol=1e-6)


def test_row_injection_flags_match_jax():
    """Mobius reads its tables in one embed pass (the split path takes it);
    Pdm (the unpooled gathers) and Que2Search (one pass per tower) do not."""
    from recommendflow_tpu.models.matching import (Mobius as JM, Pdm as JP,
                                                   Que2Search as JQ)
    from recommendflow_tpu_torch.models.matching import (Mobius, Pdm,
                                                         Que2Search)
    for j, t in ((JM, Mobius), (JP, Pdm), (JQ, Que2Search)):
        assert j.row_injection == t.row_injection
    assert Mobius.row_injection and not Pdm.row_injection


def test_build_network_resolves_every_name():
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.models import matching
    from recommendflow_tpu_torch.models.matching import (dssm_encoder,
                                                         siamese_encoder)
    assert siamese_encoder.BertModel is matching.SiameseEncoder
    assert dssm_encoder.BertModel is matching.DssmEncoder
    text = Configuration(TEXT_CONF)
    text.networks.update(SMALL_TEXT)
    recall = Configuration(tp.DEMO_CONF)
    for conf, cls, names in (
            (text, matching.SiameseEncoder, (
                f"{PKG}.siamese_encoder.SiameseEncoder",
                f"{PKG}.siamese_encoder.BertModel", "siamese_encoder",
                "matching.siamese_encoder.SiameseEncoder")),
            (text, matching.DssmEncoder, (
                f"{PKG}.dssm_encoder.DssmEncoder",
                f"{PKG}.dssm_encoder.BertModel", "dssm_encoder")),
            (text, matching.Que2Search, (f"{PKG}.que2search.Que2Search",
                                         "que2search", "Que2Search")),
            (recall, matching.Pdm, (f"{PKG}.pdm.Pdm", "pdm")),
            (recall, matching.Mobius, (f"{PKG}.mobius.Mobius", "mobius"))):
        for name in names:
            model, restored = build_network(name, {"conf": conf,
                                                   "device": "cpu"})
            assert type(model) is cls and restored is None, name
            assert not model.training


def test_models_refuse_a_tower_without_text():
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.models.matching import (DssmEncoder,
                                                         SiameseEncoder)
    conf = Configuration(tp.DEMO_CONF)
    for cls in (SiameseEncoder, DssmEncoder):
        with pytest.raises(ValueError, match="no token_id features"):
            cls(conf, device="cpu")
    text = Configuration(TEXT_CONF)
    text.networks["embedding_pooling"] = "concat"
    with pytest.raises(ValueError, match="embedding_pooling"):
        SiameseEncoder(text, device="cpu")


def test_all_padding_text_under_avg_pooling_at_zero_bias(tmp_path):
    """An all-padding text pooled by "avg" is the zero vector, and with the
    projection's bias at its zero init so is its projection: JAX's
    l2_normalize differentiates jnp.linalg.norm at 0 and its gradient is
    NaN; torch's vector_norm has gradient 0 there, so the port trains on. A
    recorded difference (the eval outputs agree: both give 0)."""
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu_torch.models.base import build_network as tbuild
    jc, tc, batch = model_batch("dssm_encoder", str(tmp_path))
    path = CASES["dssm_encoder"][1]
    jmodel, _ = jbuild(path, {"conf": jc, "dropout": 0.0})
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), tp.to_jax(batch)))
    assert not variables["params"]["ad_proj"]["bias"].any()
    grads = jax.jit(jax.grad(lambda p: jmodel.apply(
        {"params": p}, tp.to_jax(batch), training=True)[0]))(
            variables["params"])
    assert np.isnan(np.asarray(grads["ad_proj"]["kernel"])).any()
    tmodel, _ = tbuild(path, {"conf": tc, "device": "cpu"})
    for m in tmodel.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    interop.load_jax_variables(tmodel, variables)
    loss, _ = tmodel.train()(tp.to_torch(batch))
    loss.backward()
    assert all(bool(torch.isfinite(p.grad).all())
               for p in tmodel.parameters())
    with torch.no_grad():
        ad = tmodel.eval()(tp.to_torch(batch))["ad"]
    assert not ad[0].any() and torch.isfinite(ad).all()
