"""The sampled-softmax logQ correction (Networks.logq_feature) against the
JAX package.

  * train/freq.py's freq_init, freq_update and log_q against the JAX
    functions on id streams with duplicates (ids drawn from fewer buckets
    than the batch): the state bit for bit after every update, log q
    within 1 f32 ulp (log in another library).
  * Dssm on conf/demo_recall.yaml with logq_feature item_id (1024 buckets,
    dropout 0, batches of 64): three carried steps against the JAX Trainer
    with tests/test_torch_train.py's f32 tolerances (losses rtol 1e-5,
    float leaves atol 1e-5) and the freq collection bit for bit; the
    stream advances one step a training forward and not in evaluate or
    predict; the state crosses interop both ways and a checkpoint round
    trip bit for bit.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop

NETS = {"tower_units": [64, 32], "table_dtype": "float32",
        "logq_feature": "item_id", "logq_buckets": 1024}


def test_freq_functions_match_jax():
    from recommendflow_tpu.train import freq as jfreq
    from recommendflow_tpu_torch.train import freq
    rng = np.random.RandomState(3)
    js = jfreq.freq_init(64)
    ts = freq.freq_init(64)
    for k in ("last_step", "interval"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    for step in range(1, 9):
        ids = rng.randint(0, 64, size=40).astype(np.int32)   # duplicates
        assert len(set(ids.tolist())) < len(ids)
        js = jfreq.freq_update(js, jnp.asarray(ids), step, alpha=0.1)
        freq.freq_update(ts, torch.from_numpy(ids),
                         torch.tensor(step, dtype=torch.int32), alpha=0.1)
        for k in ("last_step", "interval"):
            assert ts[k].dtype == {"last_step": torch.int32,
                                   "interval": torch.float32}[k]
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), k)
        q = rng.randint(0, 64, size=(5, 3)).astype(np.int32)
        want = np.asarray(jfreq.log_q(js, jnp.asarray(q)))
        got = freq.log_q(ts, torch.from_numpy(q)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)
    assert (ts["interval"] > 0).sum() > 30


def _world(n=4):
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    jc, tc = tp.conf_pair(networks=NETS)
    batches = [synthetic_batch(compile_schema(jc.features), 64, seed=90 + i)
               for i in range(n)]
    return jc, tc, batches


def _freq_tree(jstate):
    return tp._nested(jstate.extra_vars["freq"])


def test_logq_dssm_three_steps_match_jax():
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu.train.trainer import Trainer as JTrainer
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import Trainer
    jc, tc, batches = _world()
    jm, _ = jbuild(jc.networks["class"], {"conf": jc, "dropout": 0.0})
    jt = JTrainer(jm, learning_rate=1e-3, seed=0)
    js = jt.init_state(jt._put(batches[0]))
    js, _ = jt.train_step(js, batches[0])
    tm, _ = build_network(tc.networks["class"],
                          {"conf": tc, "dropout": 0.0, "device": "cpu"})
    tt = Trainer(tm, learning_rate=1e-3, device="cpu")
    ts = tt.init_state(batches[0])
    assert int(tm.freq.step) == 0            # init_state's check restored it
    interop.load_train_state(ts, tp.jax_state_tree(js))
    assert int(tm.freq.step) == 1
    jl, tl = [], []
    for b in batches[1:]:
        js, jm_ = jt.train_step(js, b)
        ts, tm_ = tt.train_step(ts, b)
        jl.append(float(jm_["loss"]))
        tl.append(float(tm_["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jfin = tp.flat_tree(tp.jax_state_tree(js))
    tfin = tp.flat_tree(interop.train_state_tree(ts, ml_dtypes.bfloat16))
    assert sorted(jfin) == sorted(tfin)
    for k, a in jfin.items():
        if not isinstance(a, np.ndarray):
            assert a == tfin[k], k
        elif k.startswith("freq/"):
            np.testing.assert_array_equal(tfin[k], a, k)
        else:
            np.testing.assert_allclose(tfin[k], a, rtol=0, atol=1e-5,
                                       err_msg=k)
    assert int(tfin["freq/step"]) == 4 and (tfin["freq/state/interval"] > 0
                                            ).sum() > 10


def test_the_stream_advances_in_training_only(tmp_path):
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    from recommendflow_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                          save_checkpoint)
    from recommendflow_tpu_torch.train.trainer import Trainer, predict
    _, tc, batches = _world()
    model = Dssm(tc, dropout=0.0, device="cpu")
    t = Trainer(model, device="cpu")
    state = t.init_state(batches[0])
    for i, b in enumerate(batches[:2]):
        before = model.freq.interval.clone()
        state, m = t.train_step(state, b)
        assert int(model.freq.step) == i + 1 and np.isfinite(float(m["loss"]))
        ids = torch.from_numpy(b["item_id"]).reshape(64, -1)[:, 0] % 1024
        assert torch.all(model.freq.last_step[ids.long()] == i + 1)
        assert not torch.equal(before, model.freq.interval) or i == 0
    frozen = {k: v.clone() for k, v in model.freq.state_dict().items()}
    t.evaluate(state, batches[2:])
    predict(model, batches[2:], "cpu")
    for k, v in model.freq.state_dict().items():
        assert torch.equal(v, frozen[k]), k
    # interop both ways, bit for bit
    tree = interop.jax_from_variables(model.state_dict())
    assert sorted(tree["freq"]) == ["state", "step"] and \
        sorted(tree["freq"]["state"]) == ["interval", "last_step"]
    other = Dssm(tc, dropout=0.0, device="cpu")
    interop.load_jax_variables(other, tree)
    for k, v in model.freq.state_dict().items():
        assert torch.equal(other.freq.state_dict()[k], v), k
    # a checkpoint round trip, then the same next step
    path = save_checkpoint(str(tmp_path / "c.pt"), state)
    t2 = Trainer(other, device="cpu")
    state2 = restore_checkpoint(path, t2.init_state(batches[0]))
    state, m = t.train_step(state, batches[3])
    state2, m2 = t2.train_step(state2, batches[3])
    assert float(m["loss"]) == float(m2["loss"])
    for k, v in model.freq.state_dict().items():
        assert torch.equal(other.freq.state_dict()[k], v), k


def test_no_logq_feature_no_state():
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    _, tc = tp.conf_pair(networks={"tower_units": [16]})
    model = Dssm(tc, device="cpu")
    assert not hasattr(model, "freq") and model.logq_correction({}) is None
