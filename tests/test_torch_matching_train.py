"""Training the other matching models: the port's Trainer against the JAX
trainer, three carried steps per case at test_torch_matching.py's widths
(dropout 0 on both sides, as there): SiameseEncoder (one text a tower, and
two with the attention merge), DssmEncoder, Que2Search and Pdm on the dense
table path (their table reads are not one embed pass), Mobius on the split
path with each strategy, and Dssm with an image slot, linear and ViT.

Both start from the same carried TrainState (the JAX state after one step,
AttentionFusion's `stats` included), take the same three batches of 64 and
are compared step by step (loss) and at the end (tables, Adagrad
accumulators, dense parameters, `stats`, Adam moments and count, step) with
tests/test_torch_train.py's f32 tolerances: losses rtol 1e-5, every float
leaf atol 1e-5; rows no batch touched are bit-equal. Models without a table
(SiameseEncoder, DssmEncoder) train every parameter, the token embeddings
included, with Adam, as optax does in JAX.

One kind of element is held otherwise: one whose gradient in some step was
below 1e-6 but not 0 (test_torch_matching.py's gradient tolerance), where
the two sides' gradients are summation noise relative to each other (a ReLU
unit alive on one row by 1e-8, 5.0e-9 here against 6.1e-9 in JAX) and
Adam, which divides a gradient by its own magnitude, turns that noise into
a step of up to lr·(1-β1)/√(1-β2): such an element is held within three
such steps. An attention key bias (`.../mha/k/bias`, Pdm's `attn_*/k/bias`)
always is one: its exact gradient is 0 (softmax ignores a shift of a
query's whole row), and its gradient must stay below 1e-6 (as in
test_torch_ranking_attention_train.py).

The image cases build Dssm with use_bn=False: behind the ad tower's
BatchNorm, the ViT head's bias and its last LayerNorm's bias have an exact
gradient of 0 (a per-feature shift that the batch mean removes), whose Adam
noise then moves the running mean, and pixels of ~1e2 put f32 noise of
2.4e-5 into the running variance. test_torch_train.py holds Dssm's
BatchNorm path; the DssmEncoder case pools its ad texts by [CLS]: with
"avg", the all-padding row pools to 0 and, with the projection's bias at
its zero init, JAX's gradient is NaN (test_torch_matching.py pins that).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop
from test_torch_matching import (CASES, model_batch,  # noqa: F401
                                  no_flax_dropout, port_kw)
from test_torch_train import _tolerances

LR = 1e-3
ADAM_STEP = LR * (1 - 0.9) / np.sqrt(1 - 0.999)
NOISE_GRAD = 1e-6
# per case: model kwargs and Networks overrides beyond test_torch_matching's
TRAIN_KW = {"dssm-image": {"use_bn": False}, "dssm-vit": {"use_bn": False}}
TRAIN_NETS = {"dssm_encoder": {"ad_encoder": {
    "vocab_size": 256, "num_layers": 2, "model_dim": 16, "pooling": "cls"}}}
# (case, JAX table_update, split strategy)
RUNS = [("siamese", "auto", None), ("siamese-attention", "auto", None),
        ("dssm_encoder", "auto", None), ("que2search", "dense", None),
        ("pdm", "dense", None), ("mobius", "split", "sparse_set"),
        ("mobius", "split", "dense"), ("dssm-image", "split", "dense"),
        ("dssm-vit", "split", "sparse_set")]


def _state_tree(jstate):
    """tp.jax_state_tree plus the model's `stats` collection."""
    tree = tp.jax_state_tree(jstate)
    extra = jstate.extra_vars or {}
    if "stats" in extra:
        tree["stats"] = tp._nested(extra["stats"])
    return tree


def _is_key_bias(name):
    return name.endswith("mha.k.bias") or (
        name.startswith("attn_") and name.endswith(".k.bias"))


def _noisy_elements(model, noisy):
    """Mark, per dense parameter, the elements whose gradient this step was
    below NOISE_GRAD but not 0."""
    for n, p in model.named_parameters():
        if p.grad is not None and "table_dim" not in n:
            g = p.grad.abs()
            mark = (g < NOISE_GRAD) & (g > 0)
            noisy[n] = noisy[n] | mark if n in noisy else mark


def _run(name, mode, strategy, tmp_dir):
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu.train.trainer import Trainer as JTrainer
    from recommendflow_tpu_torch.models.base import build_network as tbuild
    from recommendflow_tpu_torch.train.trainer import Trainer
    worlds = [model_batch(name, tmp_dir, b=64, seed=60 + i,
                          networks=TRAIN_NETS.get(name)) for i in range(4)]
    jc, tc = worlds[0][:2]
    batches = [b for _, _, b in worlds]
    _, path, kw, _ = CASES[name]
    kw = dict(kw, dropout=0.0, **TRAIN_KW.get(name, {}))
    jmodel, _ = jbuild(path, {"conf": jc, **kw})
    jt = JTrainer(jmodel, learning_rate=LR, table_update=mode, seed=0)
    js = jt.init_state(jt._put(batches[0]))
    if mode == "split":
        jt._split_dims = {d: strategy for d in jt._split_dims}
    js, _ = jt.train_step(js, batches[0])          # a non-trivial state
    tmodel, _ = tbuild(path, {"conf": tc, "device": "cpu",
                              **port_kw(path, kw)})
    for m in tmodel.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    tt = Trainer(tmodel, learning_rate=LR, table_update=mode,
                 split_strategy=strategy or "auto", device="cpu")
    ts = tt.init_state(batches[0])
    interop.load_train_state(ts, _state_tree(js))
    jl, tl, k_bias_grads, noisy = [], [], [], {}
    for b in batches[1:]:
        js, jm = jt.train_step(js, b)
        ts, tm = tt.train_step(ts, b)
        k_bias_grads.extend(float(p.grad.abs().max()) for n, p in
                            tmodel.named_parameters() if _is_key_bias(n))
        _noisy_elements(tmodel, noisy)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    noisy = tp.flat_tree(interop.jax_from_variables(noisy))
    return (batches, jl, tl, tp.flat_tree(_state_tree(js)),
            tp.flat_tree(interop.train_state_tree(ts, ml_dtypes.bfloat16)),
            tt, k_bias_grads, noisy)


@pytest.mark.parametrize("name,mode,strategy", RUNS,
                         ids=[f"{n}-{s or m}" for n, m, s in RUNS])
def test_three_steps_match_jax(name, mode, strategy, tmp_path):
    from recommendflow_tpu_torch.ops.embedding import touched_stored_rows
    batches, jl, tl, jfin, tfin, tt, k_bias_grads, noisy = _run(
        name, mode, strategy, str(tmp_path))
    if mode == "split":
        assert set(tt._split_dims.values()) == {strategy}
    else:
        assert tt._split_dims == {}
    loss_rtol, table_atol, atol = _tolerances("float32", strategy)
    assert all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    assert sorted(jfin) == sorted(tfin)
    tables = {f"dim{d}": getattr(tt.model.embedder, f"table_dim{d}")
              for d in tt.model.schema.groups} \
        if hasattr(tt.model, "embedder") else {}
    touched = {k: set() for k in tables}
    for b in batches[1:]:
        for k, rows in touched_stored_rows(tt.model.schema, tables,
                                           tp.to_torch(b)).items():
            touched[k].update(rows.tolist())
    for k, a in jfin.items():
        b = tfin[k]
        if not isinstance(a, np.ndarray):
            assert a == b, k                       # step, Adam count
        elif "table_dim" in k:
            rows = np.ones(a.shape[0], bool)
            rows[sorted(touched[k.split("table_")[-1]])] = False
            np.testing.assert_array_equal(b[rows], a[rows], k)
            np.testing.assert_allclose(b, a, rtol=0, atol=table_atol,
                                       err_msg=k)
        else:
            tol = np.full(a.shape, atol)
            if k in noisy:
                tol[noisy[k]] = 3 * ADAM_STEP
            assert (np.abs(b.astype(np.float64) - a) <= tol).all(), (
                k, float(np.abs(b.astype(np.float64) - a).max()))
    assert max(k_bias_grads, default=0.0) < NOISE_GRAD
    if name in ("que2search", "siamese-attention"):
        assert any(k.startswith("stats/") for k in tfin)
    if name in ("siamese", "dssm_encoder"):
        assert tt.model.schema.groups and not tables and \
            not interop.flatten(tfin.get("table_acc", {}))
        tok = [k for k in tfin if k.startswith("opt/mu/") and
               k.endswith("tok_emb/embedding")]
        assert tok and all(np.abs(tfin[k]).max() > 0 for k in tok)
