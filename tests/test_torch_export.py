"""The port's model export (`recommendflow_tpu_torch/export/`) on the CPU.

  * Against the JAX package: the same numpy batch from a seed, the flax
    variables carried into the port by `interop.load_jax_variables`, label
    columns baked in as zeroed constants on both sides; the JAX package's
    `export_model` -> `ServingModel.predict` and the port's agree within
    atol 1e-5 (the ranking parity tolerance: the same f32 products summed in
    another order) for Dssm on demo_recall, Dcn, TabTransformer and Esim
    (key masks) on demo_ranking and Din on demo_din, at the parity tests'
    widths.
  * Against the port's eager model: bitwise (the program runs the same ops
    and the same custom ops), and the graph holds the kernels' custom-op
    nodes.
  * The JAX package's contracts (tests/test_encoder_export.py): a wrong
    shape is a ValueError, a missing input a KeyError, constants that
    overlap the batch a ValueError, labels baked as constants.
  * The port's additions: a JAX `.rfx` (a pickle) is refused unread; an
    embedding id outside its table is refused on the host (ValueError); the
    load raises without a card unless the CPU is asked for.
  * The custom ops pass `torch.library.opcheck` on the CPU.
"""
import numpy as np
import pytest
import torch

import _torch_parity as tp
import test_torch_dssm as dssm_t
import test_torch_ranking as rank_t
import test_torch_ranking_attention as attn_t
from recommendflow_tpu_torch.export import (ServingModel, custom_op_nodes,
                                            export_model)

ATOL = 1e-5
MODELS = ("dssm", "dcn", "tabtransformer", "esim", "din")
# the port's custom-op nodes each exported program holds
OP_NODES = {"dssm": {"recflow::gather_rows": 2},
            "dcn": {"recflow::gather_rows": 1},
            "tabtransformer": {"recflow::gather_rows": 1,
                               "recflow::flash_attention": 2},
            "esim": {"recflow::gather_rows": 1,
                     "recflow::flash_attention": 4},
            "din": {"recflow::gather_rows": 2}}


def _pair(name):
    """(flax model, its variables, the port's model carrying them, a batch
    of numpy arrays, the label keys)."""
    if name == "dssm":
        jmodel, tmodel, variables, batch = dssm_t._pair("float32")
    elif name == "dcn":
        jc, tc, batch = rank_t.ranking_batch()
        jmodel, variables, tmodel = rank_t.build_pair(name, jc, tc, batch)
    else:
        jc, tc, batch = attn_t.model_batch(name)
        jmodel, variables, tmodel = attn_t.build_pair(name, jc, tc, batch)
    labels = [k for k in tmodel.schema.label_names if k in batch]
    return jmodel, variables, tmodel, batch, labels


def _split(batch, labels):
    """(serving inputs, zeroed label constants)."""
    return ({k: v for k, v in batch.items() if k not in labels},
            {k: np.zeros_like(batch[k]) for k in labels})


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """name -> (the pair, the port's export reloaded on the CPU), built
    once per model."""
    made = {}

    def get(name):
        if name not in made:
            jmodel, variables, tmodel, batch, labels = _pair(name)
            serve, consts = _split(batch, labels)
            path = export_model(tmodel, serve, str(
                tmp_path_factory.mktemp(name) / "model"), constants=consts)
            made[name] = ((jmodel, variables, tmodel, batch, labels),
                          ServingModel.load(path, device="cpu"))
        return made[name]
    return get


@pytest.mark.parametrize("name", MODELS)
def test_export_matches_the_jax_export(name, exported, tmp_path):
    from recommendflow_tpu.export import ServingModel as JServing
    from recommendflow_tpu.export import export_model as jexport
    (jmodel, variables, _, batch, labels), serving = exported(name)
    serve, consts = _split(batch, labels)
    jpath = jexport(jmodel, variables, serve, str(tmp_path / "jax"),
                    constants=consts)
    want = {k: np.asarray(v) for k, v in
            JServing.load(jpath).predict(serve).items()}
    got = serving.predict(serve)
    assert sorted(got) == sorted(want)
    assert not set(got) & set(labels)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_export_equals_the_eager_model(name, exported):
    (_, _, tmodel, batch, labels), serving = exported(name)
    serve, consts = _split(batch, labels)
    with torch.no_grad():
        want = tmodel.eval()(tp.to_torch({**serve, **consts}))
    got = serving.predict(serve)
    assert sorted(got) == sorted(k for k in want if k not in labels)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k].numpy(), err_msg=k)
    assert custom_op_nodes(serving.program) == OP_NODES[name]
    assert serving.batch_keys == sorted(serve)
    assert serving.meta["id_rows"] == {
        s.name: s.num_rows for s in tmodel.schema.sparse_slots()}


def test_bad_shape_and_missing_input(exported):
    (_, _, _, batch, labels), serving = exported("dcn")
    serve, _ = _split(batch, labels)
    bad = dict(serve, user_id=serve["user_id"][:4])
    with pytest.raises(ValueError, match="shape"):
        serving.predict(bad)
    with pytest.raises(KeyError, match="missing"):
        serving.predict({k: v for k, v in serve.items() if k != "item_id"})
    # extra keys are ignored, and nested lists of the right shape are cast
    out = serving.predict({**{k: v.tolist() for k, v in serve.items()},
                           "click": batch["click"]})
    np.testing.assert_array_equal(out["score"], serving.predict(serve)["score"])


def test_overlapping_constants_raise(tmp_path):
    _, _, tmodel, batch, labels = _pair("dcn")
    with pytest.raises(ValueError, match="also appear in sample_batch"):
        export_model(tmodel, batch, str(tmp_path / "m"),
                     constants={labels[0]: np.zeros_like(batch[labels[0]])})


def test_labels_are_baked_as_constants(exported):
    """A serving request carries no labels (the counterpart of
    test_encoder_export.py:test_export_bakes_label_constants): the label
    columns are not inputs, and their echoes are not outputs."""
    (_, _, _, batch, labels), serving = exported("dssm")
    assert labels == ["label"]
    assert not set(serving.batch_keys) & set(labels)
    out = serving.predict(_split(batch, labels)[0])
    assert sorted(out) == ["ad", "user"]


def test_a_jax_export_is_refused_unread(tmp_path, monkeypatch):
    import pickle
    from recommendflow_tpu.export import export_model as jexport
    jmodel, variables, _, batch, labels = _pair("dssm")
    serve, consts = _split(batch, labels)
    jpath = jexport(jmodel, variables, serve, str(tmp_path / "jax"),
                    constants=consts)
    monkeypatch.setattr(pickle, "load", lambda *a, **k: pytest.fail(
        "the JAX export was unpickled"))
    with pytest.raises(ValueError, match="JAX package's export"):
        ServingModel.load(jpath, device="cpu")
    other = tmp_path / "other.rfx"
    other.write_bytes(b"not an export")
    with pytest.raises(ValueError, match="not an export of the port"):
        ServingModel.load(str(other), device="cpu")


@pytest.mark.parametrize("bad", ["past_its_table", "negative",
                                 "past_the_stacked_table"])
def test_an_id_outside_its_table_is_refused_on_the_host(bad, exported,
                                                        monkeypatch):
    """An id past its own table but inside the stacked one would read the
    next table's row; one past the stacked table would stop the kernel's
    device-side assert on a card. Each is refused before the program runs
    (a ValueError, which /predict answers with 400), and before the cast to
    the exported int32: 2^40 (as a JSON request's int64) would wrap to 0."""
    (_, _, tmodel, batch, labels), serving = exported("dcn")
    serve, _ = _split(batch, labels)
    slot = tmodel.schema.sparse_slots()[0]
    ids = serve[slot.name].astype(np.int64)
    ids.reshape(-1)[5] = {"past_its_table": slot.num_rows, "negative": -1,
                          "past_the_stacked_table": 1 << 40}[bad]
    monkeypatch.setattr(serving, "_module", lambda *a: pytest.fail(
        "the program ran on a bad id"))
    with pytest.raises(ValueError, match=f"'{slot.name}'"):
        serving.predict(dict(serve, **{slot.name: ids}))


def test_load_raises_without_a_card(exported, monkeypatch, tmp_path):
    (_, _, tmodel, batch, labels), _ = exported("dcn")
    serve, consts = _split(batch, labels)
    path = export_model(tmodel, serve, str(tmp_path / "m"), constants=consts)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingModel.load(path)


def _split_heads_inputs(mask):
    """q, k, v as the strided split_heads views of [B, L, H*D] (the model
    path's layout), and a key mask with an all-masked row."""
    from recommendflow_tpu_torch.ops.attention import split_heads
    rng = np.random.RandomState(0)
    q, k, v = (split_heads(torch.from_numpy(
        rng.randn(3, 7, 4 * 8).astype(np.float32)), 4) for _ in range(3))
    m = torch.from_numpy(rng.rand(3, 7) > 0.3)
    m[1] = False
    return (q, k, v, m if mask else None)


@pytest.mark.parametrize("case", ["gather_rows", "flash_attention",
                                  "flash_attention_masked"])
def test_custom_ops_pass_opcheck(case):
    """The ops' schemas, fake impls (shapes and strides) and their tracing
    under AOT dispatch, on the CPU."""
    if case == "gather_rows":
        rng = np.random.RandomState(1)
        args = (torch.from_numpy(rng.randn(50, 16).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 50, 33).astype(np.int32)))
        op = torch.ops.recflow.gather_rows.default
    else:
        args = _split_heads_inputs(case.endswith("masked"))
        op = torch.ops.recflow.flash_attention.default
    torch.library.opcheck(op, args)
    out = op(*args)
    if case != "gather_rows":       # the kernel's layout: [B, Lq, H, D] rows
        assert out.transpose(1, 2).is_contiguous()


def test_exported_graph_of_a_traced_block(tmp_path):
    """custom_op_nodes counts the port's op nodes of any program: a
    MultiHeadAttention block exported on its own holds one attention node
    and no gather."""
    from recommendflow_tpu_torch.ops.attention import MultiHeadAttention
    mha = MultiHeadAttention(16, 2, device="cpu").eval()
    x = torch.randn(2, 5, 16)
    with torch.no_grad():
        program = torch.export.export(mha, (x, x, x))
    assert custom_op_nodes(program) == {"recflow::flash_attention": 1}
    with torch.no_grad():
        np.testing.assert_array_equal(program.module()(x, x, x).numpy(),
                                      mha(x, x, x).numpy())
