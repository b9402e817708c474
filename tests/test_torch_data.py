"""The port's copied host layer keeps the JAX package's contracts bit for bit:
the record writer, the synthetic generators, the compiled schema and the
batches the pipeline decodes (exact integers and floats, no tolerance)."""
import os

import numpy as np
import pytest

import _torch_parity as tp


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    from recommendflow_tpu.data.synthetic import generate_records as jgen
    from recommendflow_tpu_torch.data.synthetic import generate_records as tgen
    jc, tc = tp.conf_pair()
    base = tmp_path_factory.mktemp("recs")
    jpaths = jgen(jc, str(base / "jax"), num_rows=600, num_files=2, seed=3)
    tpaths = tgen(tc, str(base / "torch"), num_rows=600, num_files=2, seed=3)
    return jc, tc, jpaths, tpaths


def test_record_files_are_byte_identical(records):
    _, _, jpaths, tpaths = records
    assert [os.path.basename(p) for p in jpaths] == \
        [os.path.basename(p) for p in tpaths]
    for a, b in zip(jpaths, tpaths):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_compiled_schema_matches(records):
    from recommendflow_tpu.data.schema import compile_schema as jcompile
    from recommendflow_tpu_torch.data.schema import compile_schema as tcompile
    jc, tc, _, _ = records
    js, ts = jcompile(jc.features), tcompile(tc.features)
    assert js.order == ts.order and js.label_names == ts.label_names
    for name in js.order:
        a, b = js.slots[name], ts.slots[name]
        assert (a.kind, a.num_hashes, a.num_rows, a.dim, a.max_len, a.seeds,
                a.pooling.value, a.tower.value) == \
               (b.kind, b.num_hashes, b.num_rows, b.dim, b.max_len, b.seeds,
                b.pooling.value, b.tower.value)
    assert {d: (g.offsets, g.total_rows) for d, g in js.groups.items()} == \
           {d: (g.offsets, g.total_rows) for d, g in ts.groups.items()}


@pytest.mark.parametrize("batch_size,drop", [(128, True), (250, False)])
def test_pipeline_batches_equal(records, batch_size, drop):
    from recommendflow_tpu.data.pipeline import make_dataset as jmake
    from recommendflow_tpu_torch.data.pipeline import make_dataset as tmake
    jc, tc, jpaths, _ = records
    pattern = os.path.join(os.path.dirname(jpaths[0]), "*.rfb")
    jds, _ = jmake(jc, pattern, batch_size, shuffle=False, drop_remainder=drop)
    tds, _ = tmake(tc, pattern, batch_size, shuffle=False, drop_remainder=drop)
    jb, tb = list(jds), list(tds)
    assert len(jb) == len(tb) > 1
    for a, b in zip(jb, tb):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("conf_path", [tp.DEMO_CONF, tp.BENCH_CONF])
def test_synthetic_batch_equal(conf_path):
    from recommendflow_tpu.data.schema import compile_schema as jcompile
    from recommendflow_tpu.data.synthetic import synthetic_batch as jsyn
    from recommendflow_tpu_torch.data.schema import compile_schema as tcompile
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch as tsyn
    jc, tc = tp.conf_pair(conf_path)
    a = jsyn(jcompile(jc.features), 16, seed=5)
    b = tsyn(tcompile(tc.features), 16, seed=5)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_hashing_and_metrics_copies_agree():
    from recommendflow_tpu.data.hashing import hash_bucket_array as jh
    from recommendflow_tpu.train.metrics import (average_precision as jap,
                                                 recall_at_precision as jrp,
                                                 roc_auc as jauc)
    from recommendflow_tpu_torch.data.hashing import hash_bucket_array as th
    from recommendflow_tpu_torch.train.metrics import (average_precision as tap,
                                                       recall_at_precision as trp,
                                                       roc_auc as tauc)
    vals = [f"u{i}" for i in range(200)] + ["", "ünïcode", "x" * 70]
    np.testing.assert_array_equal(jh(vals, 2022, 1000), th(vals, 2022, 1000))
    rng = np.random.RandomState(0)
    y = (rng.rand(300) > 0.6).astype(np.float32)
    s = np.round(rng.rand(300), 2)          # ties included
    assert jauc(y, s) == tauc(y, s)
    assert jap(y, s) == tap(y, s)
    assert jrp(y, s, 0.5) == trp(y, s, 0.5)


def test_bert_encode_features_equal(tmp_path, monkeypatch):
    """conf/demo_text_recall.yaml: the bert_encode features' token and
    segment ids from the port's pipeline (its own tokenizer, through
    data/schema.py:get_tokenizer) equal the JAX pipeline's."""
    from recommendflow_tpu.data.pipeline import make_dataset as jmake
    from recommendflow_tpu.data.schema import get_tokenizer as jtok
    from recommendflow_tpu.data.synthetic import generate_records as jgen
    from recommendflow_tpu_torch.data.pipeline import make_dataset as tmake
    from recommendflow_tpu_torch.data.schema import get_tokenizer as ttok
    from recommendflow_tpu_torch.encoder.tokenizer import Tokenizer
    monkeypatch.chdir(tp.ROOT)          # the config's vocab path is relative
    conf_path = os.path.join("conf", "demo_text_recall.yaml")
    jc, tc = tp.conf_pair(conf_path)
    paths = jgen(jc, str(tmp_path / "recs"), num_rows=300, num_files=1, seed=4)
    pattern = os.path.join(os.path.dirname(paths[0]), "*.rfb")
    jds, _ = jmake(jc, pattern, 128, shuffle=False, drop_remainder=False)
    tds, _ = tmake(tc, pattern, 128, shuffle=False, drop_remainder=False)
    jb, tb = list(jds), list(tds)
    assert len(jb) == len(tb) == 3
    keys = ("query_text", "query_text:seg", "title_text", "title_text:seg")
    for a, b in zip(jb, tb):
        for k in keys:
            assert a[k].dtype == b[k].dtype == np.int32, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (b["query_text"][:, 0] == ttok("conf/demo_vocab.txt").cls_id).all()
    assert isinstance(ttok("conf/demo_vocab.txt"), Tokenizer)
    assert ttok("conf/demo_vocab.txt").vocab == jtok("conf/demo_vocab.txt").vocab
