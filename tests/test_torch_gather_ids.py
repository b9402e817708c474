"""Where the port checks embedding ids, and what gather_rows' launch plan
covers.

  * The host checks every sparse slot's ids against its own table
    (`data/schema.py:check_batch_ids`) before a batch is copied to the card,
    in the prefetch thread of `Trainer.fit`, `Trainer.evaluate` and
    `predict`: it passes every synthetic batch of the demo configs, and
    raises IndexError, naming the feature and the id, for an id past its
    table or a negative one, on those paths too.
  * The JAX package does not check: its take fills a row past the stacked
    table with NaN and wraps a negative id, and an id past its own table
    reads the next table's row. The port raises there (a recorded choice,
    ROADMAP Queue 3).
  * The embed pass on CPU tensors raises IndexError for an id outside its
    stacked table (gather_rows checks on the CPU whatever `check_ids` says;
    on a card the kernel's device-side assert stops it, a `cuda` test).
  * gather_rows' launch plan (`_word_bytes`: the copy word, hence the words
    per row) for any row of 1-512 elements of a 1-, 2- or 4-byte type and
    any base pointer offset: by the kernel's own index math, the words it
    writes cover every output byte exactly once, each from the right byte
    of the right row.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import _torch_parity as tp

RANK_CONF = f"{tp.ROOT}/conf/demo_ranking.yaml"
CONFS = {"demo_recall": tp.DEMO_CONF, "demo_ranking": RANK_CONF}


def _model(name):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.models.base import build_network
    conf = Configuration(CONFS[name])
    model, _ = build_network(conf.networks["class"],
                             {"conf": conf, "device": "cpu", "seed": 0})
    return model


def _schema(name):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.schema import compile_schema
    return compile_schema(Configuration(CONFS[name]).features)


def _spoil(batch, schema, bad):
    """A copy of the batch whose first sparse slot carries one id outside
    its table: its row count ("over") or -1 ("negative")."""
    slot = schema.sparse_slots()[0]
    out = {k: np.array(v, copy=True) for k, v in batch.items()}
    out[slot.name].reshape(-1)[3] = slot.num_rows if bad == "over" else -1
    return out, slot


@pytest.mark.parametrize("zipf", [0.0, 1.2])
@pytest.mark.parametrize("conf", sorted(CONFS))
def test_host_check_passes_every_synthetic_batch(conf, zipf):
    from recommendflow_tpu_torch.data.schema import check_batch_ids
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    schema = _schema(conf)
    for seed in range(8):
        batch = synthetic_batch(schema, 256, seed=seed, zipf=zipf)
        assert check_batch_ids(schema, batch) is batch


@pytest.mark.parametrize("bad", ["over", "negative"])
@pytest.mark.parametrize("conf", sorted(CONFS))
def test_host_check_raises_naming_the_slot_and_id(conf, bad):
    from recommendflow_tpu_torch.data.schema import check_batch_ids
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    schema = _schema(conf)
    batch, slot = _spoil(synthetic_batch(schema, 64, seed=1), schema, bad)
    bad_id = slot.num_rows if bad == "over" else -1
    with pytest.raises(IndexError, match=f"'{slot.name}': id {bad_id} "):
        check_batch_ids(schema, batch)
    # the largest id in range passes
    batch[slot.name].reshape(-1)[3] = slot.num_rows - 1
    check_batch_ids(schema, batch)


def test_host_check_takes_int64_ids_and_refuses_floats():
    from recommendflow_tpu_torch.data.schema import check_batch_ids
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    schema = _schema("demo_ranking")
    batch = synthetic_batch(schema, 16, seed=2)
    wide = {k: v.astype(np.int64) if v.dtype == np.int32 else v
            for k, v in batch.items()}
    check_batch_ids(schema, wide)
    wide, slot = _spoil(wide, schema, "negative")
    with pytest.raises(IndexError, match=f"'{slot.name}': id -1 "):
        check_batch_ids(schema, wide)
    batch[slot.name] = batch[slot.name].astype(np.float32)
    with pytest.raises(TypeError):
        check_batch_ids(schema, batch)


@pytest.mark.parametrize("path", ["fit", "predict", "evaluate"])
@pytest.mark.parametrize("bad", ["over", "negative"])
@pytest.mark.parametrize("conf", sorted(CONFS))
def test_fit_predict_evaluate_raise_on_a_bad_id(conf, bad, path):
    """The check runs in the prefetch thread; its IndexError reaches the
    caller (the spoiled batch is the second, drawn by that thread)."""
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.train.trainer import Trainer, predict
    model = _model(conf)
    batches = [synthetic_batch(model.schema, 32, seed=10 + i)
               for i in range(3)]
    batches[1], slot = _spoil(batches[1], model.schema, bad)
    trainer = Trainer(model, device="cpu")
    with pytest.raises(IndexError, match=slot.name):
        if path == "fit":
            trainer.fit(batches, verbose=False)
        elif path == "predict":
            predict(model, batches, "cpu")
        else:
            trainer.evaluate(trainer.init_state(batches[0]), batches)


def test_train_step_checks_a_host_batch():
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.train.trainer import Trainer
    model = _model("demo_ranking")
    batch = synthetic_batch(model.schema, 32, seed=3)
    trainer = Trainer(model, device="cpu")
    state = trainer.init_state(batch)
    spoiled, slot = _spoil(batch, model.schema, "over")
    with pytest.raises(IndexError, match=slot.name):
        trainer.train_step(state, spoiled)
    with pytest.raises(IndexError, match=slot.name):
        trainer.train_step(state, tp.to_torch(spoiled))   # CPU tensors too
    state, m = trainer.train_step(state, batch)
    assert np.isfinite(float(m["loss"]))


def test_jax_take_fills_or_wraps_where_the_port_raises():
    """The JAX gather (take_rows, jnp.take's default mode) fills an id past
    the table with NaN and wraps -1 to the last row; the port's gather_rows
    raises for both. At the batch level an id past its own table reads the
    next table's row in the JAX embed pass, silently; the port's host check
    raises."""
    import jax.numpy as jnp
    from recommendflow_tpu.data.schema import compile_schema as jschema
    from recommendflow_tpu.ops.embedding import embed_batch as jembed
    from recommendflow_tpu.ops.embedding import take_rows as jtake
    from recommendflow_tpu_torch.data.schema import check_batch_ids
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.ops.cuda.embedding_bag import gather_rows
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = np.asarray(jtake(jnp.asarray(table),
                           jnp.asarray([4, -1, 2], jnp.int32)))
    assert np.isnan(got[0]).all()
    np.testing.assert_array_equal(got[1], table[3])
    np.testing.assert_array_equal(got[2], table[2])
    for bad in (4, -1):
        with pytest.raises(IndexError):
            gather_rows(torch.from_numpy(table),
                        torch.tensor([2, bad], dtype=torch.int32))

    jc, _ = tp.conf_pair(RANK_CONF)
    js = jschema(jc.features)
    schema = _schema("demo_ranking")
    batch, slot = _spoil(synthetic_batch(schema, 16, seed=5), schema, "over")
    assert js.groups[slot.dim].offset_of(slot.name, 0) + slot.num_rows < \
        js.groups[slot.dim].total_rows          # not the group's last table
    rng = np.random.default_rng(0)
    params = {f"dim{d}": jnp.asarray(rng.standard_normal(
        (g.total_rows, d)).astype(np.float32)) for d, g in js.groups.items()}
    out = jembed(params, js, tp.to_jax(batch))
    assert np.isfinite(np.asarray(out[slot.name])).all()
    with pytest.raises(IndexError, match=slot.name):
        check_batch_ids(schema, batch)


@pytest.mark.parametrize("bad", [1 << 30, -(1 << 30)])
def test_embed_pass_on_cpu_tensors_raises_at_a_bad_id(bad):
    """A batch of tensors passed to the model directly (no host batch
    check): the embed pass's gather raises for an id outside the stacked
    table."""
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    model = _model("demo_ranking")
    batch = synthetic_batch(model.schema, 16, seed=4)
    batch[model.schema.sparse_slots()[0].name].reshape(-1)[3] = bad
    with torch.no_grad(), pytest.raises(IndexError, match="gather_rows"):
        model.embedder(tp.to_torch(batch))


# ----------------------------------------------------- the launch plan
def _kernel_words(words_per_row, n, threads=96):
    """(output word, id index, word of its row) of every word the kernel
    writes, by the index math of csrc/embedding_bag.cu's grid-stride loop
    (word i: row i // words_per_row) over a grid of `threads`."""
    tid, step = np.meshgrid(np.arange(threads),
                            np.arange(-(-n * words_per_row // threads)),
                            indexing="ij")
    i = tid + step * threads
    i = i[i < n * words_per_row]
    return i, i // words_per_row, i % words_per_row


@settings(max_examples=300, deadline=None, database=None)
@given(elt=st.sampled_from([1, 2, 4]), width=st.integers(1, 512),
       table_off=st.integers(0, 15), out_off=st.integers(0, 15),
       n=st.integers(0, 200))
def test_gather_plan_covers_every_output_byte_once(elt, width, table_off,
                                                   out_off, n):
    from recommendflow_tpu_torch.ops.cuda.embedding_bag import _word_bytes
    row_bytes = elt * width
    # allocations are 256-byte aligned; a view starts whole elements in
    table_ptr, out_ptr = 1 << 20 | table_off * elt, 1 << 21 | out_off * elt
    unit = _word_bytes(row_bytes, table_ptr, out_ptr)
    assert unit in (16, 8, 4, 2, 1)
    assert row_bytes % unit == 0
    assert table_ptr % unit == 0 and out_ptr % unit == 0
    # the largest such word: twice it would not fit
    assert unit == 16 or row_bytes % (2 * unit) or table_ptr % (2 * unit) \
        or out_ptr % (2 * unit)
    words = row_bytes // unit
    out_word, idx, word = _kernel_words(words, n)
    count = np.bincount(out_word, minlength=n * words)
    assert count.shape == (n * words,) and (count == 1).all()
    # the word at output word o is word o % words of the row ids[o // words]
    np.testing.assert_array_equal(idx, out_word // words)
    np.testing.assert_array_equal(word, out_word % words)
