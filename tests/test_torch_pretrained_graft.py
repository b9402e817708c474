"""Networks.pretrained: the port's graft (encoder/pretrained.py:graft_params,
apply_pretrained, and Trainer.init_state, which applies it) against the JAX
package's apply_pretrained on a tiny random BERT checkpoint written by
write_bert_files (HF names, seed 0).

The grafted encoder's leaves must equal JAX's grafted params bit for bit
(both convert the same checkpoint; interop only transposes kernels). A
module name the model lacks raises KeyError, an encoder sized otherwise
ValueError naming the module (and copies nothing), as in JAX; the
positional table is clipped to the spec's max_len, else to the model's
longest token feature.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop

TEXT_CONF = f"{tp.ROOT}/conf/demo_text_recall.yaml"
TINY = dict(vocab_size=300, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=128, type_vocab_size=2,
            hidden_act="gelu", layer_norm_eps=1e-12, hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1, initializer_range=0.02)
PKG = "recommendflow_tpu.models.matching"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from recommendflow_tpu_torch.encoder.synthetic import write_bert_files
    cfg, bin_, _ = write_bert_files(str(tmp_path_factory.mktemp("bert")),
                                    TINY, seed=0)
    return {"config_path": cfg, "checkpoint_path": bin_}


def _models(cls, pretrained, networks=None, seed=0):
    """(JAX model, its init params, port model on the CPU) of the demo text
    config with Networks.pretrained set."""
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu_torch.models.base import build_network as tbuild
    jc, tc = tp.conf_pair(TEXT_CONF, networks={"pretrained": pretrained,
                                               **(networks or {})})
    batch = synthetic_batch(compile_schema(jc.features), 8, seed=1)
    jmodel, _ = jbuild(f"{PKG}.{cls}", {"conf": jc})
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                  tp.to_jax(batch))["params"]
    tmodel, _ = tbuild(f"{PKG}.{cls}", {"conf": tc, "device": "cpu",
                                        "seed": seed})
    return jmodel, params, tmodel, batch


def _subtree_bitwise(module, flax_subtree):
    """A port submodule's state against a flax params subtree, bitwise."""
    got = interop.flatten(interop.jax_from_variables(module.state_dict())
                          ["params"])
    want = interop.flatten(jax.tree_util.tree_map(np.asarray, flax_subtree))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def test_siamese_graft_is_bitwise_jax(ckpt):
    from recommendflow_tpu.encoder.pretrained import apply_pretrained as japply
    from recommendflow_tpu_torch.encoder.pretrained import apply_pretrained
    jmodel, params, tmodel, _ = _models("siamese_encoder.SiameseEncoder",
                                        {"encoder": ckpt})
    before = tmodel.user_proj.weight.detach().clone()
    assert tmodel.encoder.model_dim == 32 and tmodel.encoder.num_layers == 2
    grafted = japply(jmodel, params)
    assert apply_pretrained(tmodel) is tmodel
    _subtree_bitwise(tmodel.encoder, grafted["encoder"])
    # the positional table clipped to the longest token feature (16)
    assert tuple(tmodel.encoder.pos_emb.shape) == (16, 32)
    assert torch.equal(tmodel.user_proj.weight, before)


def test_trainer_init_state_grafts_before_the_optimizer(ckpt):
    from recommendflow_tpu.encoder.pretrained import apply_pretrained as japply
    from recommendflow_tpu_torch.train.trainer import Trainer
    jmodel, params, tmodel, batch = _models(
        "siamese_encoder.SiameseEncoder", {"encoder": ckpt})
    trainer = Trainer(tmodel, device="cpu")
    state = trainer.init_state(batch)
    _subtree_bitwise(tmodel.encoder, japply(jmodel, params)["encoder"])
    assert state.table_acc == {} and trainer._split_dims == {}
    adam = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert id(tmodel.encoder.tok_emb.weight) in adam
    assert len(adam) == len(list(tmodel.parameters()))
    tok0 = tmodel.encoder.tok_emb.weight.detach().clone()
    state, metrics = trainer.train_step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert tmodel.encoder.tok_emb.weight.grad.abs().sum() > 0
    assert not torch.equal(tok0, tmodel.encoder.tok_emb.weight)


def test_a_second_init_state_keeps_the_trained_encoder(ckpt):
    """The graft is the weights' initialisation: once the model has
    trained, a second init_state (a second fit(state=None), another
    trainer's profile) builds a new optimizer over the weights it holds
    and reads no checkpoint."""
    from recommendflow_tpu_torch.train.trainer import Trainer
    _, _, tmodel, batch = _models("siamese_encoder.SiameseEncoder",
                                  {"encoder": ckpt})
    trainer = Trainer(tmodel, device="cpu")
    state = trainer.init_state(batch)
    state, _ = trainer.train_step(state, batch)
    trained = {k: v.clone() for k, v in tmodel.state_dict().items()}
    for t in (trainer, Trainer(tmodel, device="cpu")):
        state = t.init_state(batch)
        assert state.step == 0
        for k, v in tmodel.state_dict().items():
            assert torch.equal(v, trained[k]), k


@pytest.mark.parametrize("which", [("user_encoder",),
                                   ("user_encoder", "ad_encoder")])
def test_dssm_encoder_grafts_each_named_encoder(ckpt, which):
    """Only the named encoders take the checkpoint; the other keeps its
    config's widths and its own weights."""
    from recommendflow_tpu.encoder.pretrained import apply_pretrained as japply
    from recommendflow_tpu_torch.encoder.pretrained import apply_pretrained
    spec = {n: dict(ckpt, max_len=24) for n in which}
    small = {"ad_encoder": {"vocab_size": 256, "num_layers": 1,
                            "model_dim": 16}}
    jmodel, params, tmodel, _ = _models("dssm_encoder.DssmEncoder", spec,
                                        small)
    ad0 = tmodel.ad_encoder.state_dict()
    ad0 = {k: v.clone() for k, v in ad0.items()}
    grafted = japply(jmodel, params)
    apply_pretrained(tmodel)
    for n in which:
        _subtree_bitwise(getattr(tmodel, n), grafted[n])
        assert tuple(getattr(tmodel, n).pos_emb.shape) == (24, 32)
    if "ad_encoder" not in which:
        assert tmodel.ad_encoder.model_dim == 16
        for k, v in tmodel.ad_encoder.state_dict().items():
            assert torch.equal(v, ad0[k]), k


def test_a_missing_module_raises_key_error_on_both_sides(ckpt):
    from recommendflow_tpu.encoder.pretrained import apply_pretrained as japply
    from recommendflow_tpu_torch.encoder.pretrained import apply_pretrained
    jmodel, params, tmodel, _ = _models("siamese_encoder.SiameseEncoder",
                                        {"encoder": ckpt})
    for m in (jmodel, tmodel):
        m.conf.networks["pretrained"] = {"text_tower": ckpt}
    with pytest.raises(KeyError, match="text_tower"):
        japply(jmodel, params)
    with pytest.raises(KeyError, match="text_tower"):
        apply_pretrained(tmodel)


def test_a_differently_sized_encoder_raises_value_error_and_copies_nothing(
        ckpt):
    """Built without the pretrained spec (the config's 64-wide encoder),
    then asked to graft the 32-wide checkpoint."""
    from recommendflow_tpu.encoder.pretrained import apply_pretrained as japply
    from recommendflow_tpu_torch.encoder.pretrained import apply_pretrained
    jmodel, params, tmodel, _ = _models("siamese_encoder.SiameseEncoder", {})
    for m in (jmodel, tmodel):
        m.conf.networks["pretrained"] = {"encoder": ckpt}
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    with pytest.raises(ValueError, match="'/encoder'"):
        japply(jmodel, params)
    with pytest.raises(ValueError, match="'/encoder'"):
        apply_pretrained(tmodel)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_graft_params_replaces_every_module_of_the_name():
    """graft_params finds the name at any depth, converts the flax tree
    through interop (kernels transposed) and keeps the model's dtype."""
    from recommendflow_tpu_torch.encoder.pretrained import graft_params
    from torch import nn
    model = nn.Module()
    model.a = nn.Module()
    model.a.enc = nn.Linear(3, 2)
    model.b = nn.Module()
    model.b.enc = nn.Linear(3, 2)
    rng = np.random.RandomState(0)
    tree = {"kernel": rng.randn(3, 2).astype(np.float64),
            "bias": rng.randn(2).astype(np.float32)}
    graft_params(model, "enc", tree)
    for lin in (model.a.enc, model.b.enc):
        assert lin.weight.dtype == torch.float32
        np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                      tree["kernel"].T.astype(np.float32))
        np.testing.assert_array_equal(lin.bias.detach().numpy(), tree["bias"])
    with pytest.raises(KeyError):
        graft_params(model, "dec", tree)
    with pytest.raises(ValueError, match="'/a/enc'"):
        graft_params(model, "enc", {"kernel": tree["kernel"]})


def test_no_pretrained_section_is_a_no_op():
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.encoder.pretrained import apply_pretrained
    from recommendflow_tpu_torch.models.matching import SiameseEncoder
    model = SiameseEncoder(Configuration(TEXT_CONF), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    apply_pretrained(model)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
