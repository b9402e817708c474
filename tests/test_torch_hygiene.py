"""recommendflow_tpu_torch stands alone and never runs silently on the CPU.

* No module of the port, and not chip_smoke.py, imports jax, flax, optax,
  orbax or the JAX package (checked on the source with ast, so lazy imports
  inside functions count too).
* An entry point asked for the default device raises on a machine without a
  card; a kernel wrapper handed a non-CPU tensor launches its kernel or
  raises, and never reaches the plain version.
* The CPU rehearsal of chip_smoke.py (tests/test_torch_chip_smoke.py)
  expects every phase the script has, but the build and the timings, which
  need the card.
"""
import ast
import glob
import os

import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)

ROOT = tp.ROOT
FORBIDDEN = ("jax", "flax", "optax", "orbax", "recommendflow_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "recommendflow_tpu_torch")
    build = os.path.join(pkg, "build") + os.sep     # generated, not source
    files = sorted(f for f in glob.glob(os.path.join(pkg, "**", "*.py"),
                                        recursive=True)
                   if not f.startswith(build))
    return files + [os.path.join(ROOT, "chip_smoke.py"),
                    os.path.join(ROOT, "examples", "cascade_demo_torch.py")]


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_sources()
    assert len(files) > 30
    rel = {os.path.relpath(f, ROOT) for f in files}
    for module in ("losses/match.py", "train/optimizers.py",
                   "train/trainer.py", "train/callbacks.py",
                   "train/checkpoint.py", "cli/train.py",
                   "ops/cuda/table_update.py", "ops/cuda/sparse_apply.py",
                   "encoder/tokenizer.py", "encoder/text_encoder.py",
                   "encoder/pretrained.py", "ops/attention.py",
                   "ops/transformer.py", "ops/cuda/flash_attention.py",
                   "retrieval/whitening.py", "serving/server.py",
                   "serving/client.py", "cli/encode.py", "cli/serve.py",
                   "retrieval/sq.py", "retrieval/ivf.py", "retrieval/pq.py",
                   "retrieval/factory.py", "retrieval/searcher.py",
                   "retrieval/encoder_search.py", "ops/fusion.py",
                   "ops/pooling.py", "ops/matching.py",
                   "models/matching/siamese_encoder.py",
                   "models/matching/dssm_encoder.py",
                   "models/matching/que2search.py", "models/matching/pdm.py",
                   "models/matching/mobius.py", "export/exporter.py",
                   "cli/export.py", "train/freq.py", "train/graphs.py",
                   "ops/cuda/launches.py", "encoder/simbert.py",
                   "encoder/generators.py", "retrieval/host_tier.py",
                   "parallel/distributed.py", "parallel/mesh.py",
                   "parallel/sharded_embedding.py", "retrieval/sharded.py",
                   "version.py", "config/json_config.py",
                   "cli/make_records.py", "cli/show_records.py",
                   "utils/dataprep.py", "utils/hdfs.py", "utils/trace.py"):
        assert os.path.join("recommendflow_tpu_torch", module) in rel, module
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []


def test_hygiene_check_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("def f():\n    from recommendflow_tpu.ops import embedding\n"
                 "    import jax.numpy as jnp\n"
                 "    import recommendflow_tpu_torch.ops\n")
    assert [m for m in _imported_modules(str(p)) if _forbidden(m)] == \
        ["recommendflow_tpu.ops", "jax.numpy"]


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    _no_card(monkeypatch)
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.device import resolve_device
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
    from recommendflow_tpu_torch.train.trainer import predict
    from recommendflow_tpu_torch.cli import predict as pred_cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    conf = Configuration(tp.DEMO_CONF)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Dssm(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlatSearcher(8)
    model = Dssm(conf, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict(model, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pred_cli.main([tp.DEMO_CONF, "--data", str(tmp_path / "*.rfb"),
                       "--out", str(tmp_path / "o.npz")])
    demo = _cascade_demo()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(data_dir=str(tmp_path / "cascade"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.cli([])
    assert not os.path.exists(str(tmp_path / "cascade"))
    assert resolve_device("cpu") == torch.device("cpu")


def _cascade_demo():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "cascade_demo_torch",
        os.path.join(ROOT, "examples", "cascade_demo_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_matching_models_raise_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.models import matching
    text = Configuration(os.path.join(ROOT, "conf", "demo_text_recall.yaml"))
    text.networks.update(user_encoder={"vocab_size": 256, "num_layers": 1,
                                       "model_dim": 16},
                         ad_encoder={"vocab_size": 256, "num_layers": 1,
                                     "model_dim": 16})
    recall = Configuration(tp.DEMO_CONF)
    for cls, conf in ((matching.SiameseEncoder, text),
                      (matching.DssmEncoder, text),
                      (matching.Que2Search, text), (matching.Pdm, recall),
                      (matching.Mobius, recall)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(conf)
        assert not cls(conf, device="cpu").training


def test_trainer_and_train_cli_raise_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    from recommendflow_tpu_torch.train.trainer import Trainer
    model = Dssm(Configuration(tp.DEMO_CONF), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model)
    assert Trainer(model, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("kernel", ["scatter_add_rows",
                                    "rowwise_adagrad_update",
                                    "sparse_adagrad_apply"])
def test_table_kernels_never_take_the_plain_version_off_the_cpu(monkeypatch,
                                                                kernel):
    """A meta tensor (this machine has no CUDA) goes down the launch path,
    whose checks refuse it; the plain version is never called, and a CPU
    call of the wrapper counts no launch."""
    from recommendflow_tpu_torch.ops.cuda import (embedding_bag, sparse_apply,
                                                  table_update)
    module = {"scatter_add_rows": embedding_bag,
              "rowwise_adagrad_update": table_update,
              "sparse_adagrad_apply": sparse_apply}[kernel]

    def boom(*a, **k):
        raise AssertionError("plain version reached with a non-CPU tensor")

    monkeypatch.setattr(module, f"{kernel}_plain", boom)

    def args(device):
        p = torch.zeros((8, 16), device=device)
        acc = torch.ones((8, 1), device=device)
        ids = torch.tensor([1, 5], dtype=torch.int32, device=device)
        g = torch.ones((2, 16), device=device)
        if kernel == "scatter_add_rows":
            return (ids, g, p), {}
        if kernel == "rowwise_adagrad_update":
            return (p, acc, torch.ones_like(p)), {"lr": 0.1}
        return (p, acc, ids, g), {"lr": 0.1}

    wrapper = getattr(module, kernel)
    a, kw = args("meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(*a, **kw)
    monkeypatch.undo()
    before = wrapper.launches
    a, kw = args("cpu")
    wrapper(*a, **kw)
    assert wrapper.launches == before
    assert float(a[2 if kernel == "scatter_add_rows" else 0].abs().sum()) > 0


def test_touched_row_update_never_takes_the_plain_version_off_the_cpu(
        monkeypatch):
    """train/optimizers.py:sparse_rowwise_adagrad_update on meta tensors
    (this machine has no CUDA) goes down gather_rows' launch path, which
    refuses them; neither kernel's plain version is called."""
    from recommendflow_tpu_torch.ops.cuda import embedding_bag, sparse_apply
    from recommendflow_tpu_torch.train.optimizers import (
        sparse_rowwise_adagrad_update)

    def boom(*a, **k):
        raise AssertionError("plain version reached with a non-CPU tensor")

    monkeypatch.setattr(embedding_bag, "gather_rows_plain", boom)
    monkeypatch.setattr(sparse_apply, "sparse_adagrad_apply_plain", boom)
    p = torch.zeros((8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        sparse_rowwise_adagrad_update(
            p, torch.ones((8, 1), device="meta"), torch.ones_like(p),
            torch.tensor([1, 1, 5], dtype=torch.int32, device="meta"),
            lr=0.1)


@pytest.mark.parametrize("kernel", ["gather_rows", "grouped_score_max"])
def test_non_cpu_tensor_never_reaches_the_plain_version(monkeypatch, kernel):
    """A tensor off the CPU (meta here: this machine has no CUDA) goes down
    the launch path, whose checks refuse it; the plain version is never
    called."""
    from recommendflow_tpu_torch.ops.cuda import embedding_bag, grouped_topk

    def boom(*a, **k):
        raise AssertionError("plain version reached with a non-CPU tensor")

    if kernel == "gather_rows":
        monkeypatch.setattr(embedding_bag, "gather_rows_plain", boom)
        table = torch.empty((8, 4), device="meta")
        ids = torch.empty((3,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            embedding_bag.gather_rows(table, ids)
        before = embedding_bag.gather_rows.launches
        # the CPU path is the plain version and does not count a launch
        monkeypatch.undo()
        out = embedding_bag.gather_rows(torch.arange(8.).view(4, 2),
                                        torch.tensor([3, 0], dtype=torch.int32))
        assert out.tolist() == [[6., 7.], [0., 1.]]
        assert embedding_bag.gather_rows.launches == before
    else:
        monkeypatch.setattr(grouped_topk, "grouped_score_max_plain", boom)
        q = torch.empty((2, 8), device="meta")
        v = torch.empty((32, 8), device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            grouped_topk.grouped_score_max(q, v, None, group=16, num_items=30)
        before = grouped_topk.grouped_score_max.launches
        monkeypatch.undo()
        rng = np.random.RandomState(0)
        m1 = grouped_topk.grouped_score_max(
            torch.from_numpy(rng.randn(2, 8).astype(np.float32)),
            torch.from_numpy(rng.randn(32, 8).astype(np.float32)), None,
            group=16, num_items=30)
        assert m1.shape == (2, 2)
        assert grouped_topk.grouped_score_max.launches == before


def test_retrieval_entry_points_raise_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    from recommendflow_tpu_torch.retrieval import (EncoderSearcher,
                                                   IvfPqSearcher, IvfSearcher,
                                                   PqSearcher, SqSearcher,
                                                   index_factory)
    vecs = np.random.RandomState(0).randn(50, 8).astype(np.float32)
    for make in (lambda: SqSearcher(8), lambda: IvfSearcher(8),
                 lambda: PqSearcher(8), lambda: IvfPqSearcher(8),
                 lambda: index_factory(8, "SQ8"),
                 lambda: EncoderSearcher(items=vecs, index_param="SQ8").train()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    s = EncoderSearcher(items=vecs, index_param="SQ8", device="cpu").train()
    assert str(s.index.device) == "cpu"


def test_uint8_scan_never_takes_the_plain_version_off_the_cpu(monkeypatch):
    from recommendflow_tpu_torch.ops.cuda import grouped_topk

    def boom(*a, **k):
        raise AssertionError("plain version reached with a non-CPU tensor")

    monkeypatch.setattr(grouped_topk, "grouped_score_max_plain", boom)
    q = torch.empty((2, 8), device="meta")
    codes = torch.empty((32, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        grouped_topk.grouped_score_max(q, codes, None, group=16, num_items=30)
    monkeypatch.undo()
    before = dict(grouped_topk.grouped_score_max.launches_by_dtype)
    m1 = grouped_topk.grouped_score_max(
        torch.ones((2, 8)), torch.full((32, 8), 3, dtype=torch.uint8), None,
        group=16, num_items=30)
    assert m1.tolist() == [[24.0, 24.0], [24.0, 24.0]]
    assert grouped_topk.grouped_score_max.launches_by_dtype == before


def test_encoder_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    _no_card(monkeypatch)
    from recommendflow_tpu_torch.cli import encode as encode_cli
    from recommendflow_tpu_torch.cli import serve as serve_cli
    from recommendflow_tpu_torch.encoder import (TextEncoderService, Tokenizer,
                                                 build_demo_vocab)
    from recommendflow_tpu_torch.ops.transformer import TextEncoder
    vocab = build_demo_vocab(["hello"])
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(sorted(vocab, key=vocab.get)))
    (tmp_path / "in.txt").write_text("hello\n")
    small = dict(max_len=8, model_dim=16, num_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TextEncoderService(Tokenizer(vocab), **small)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TextEncoder(len(vocab), **small)
    flags = ["--vocab", str(path), "--max_len", "8", "--model_dim", "16",
             "--num_layers", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_cli.main(flags + ["--input", str(tmp_path / "in.txt"),
                                 "--out", str(tmp_path / "o.npz")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.build(flags + ["--port", "0", "--host", "127.0.0.1"])
    assert TextEncoderService(Tokenizer(vocab), device="cpu",
                              **small).device == torch.device("cpu")
    encode_cli.main(flags + ["--input", str(tmp_path / "in.txt"),
                             "--out", str(tmp_path / "o.npz"),
                             "--device", "cpu"])
    backend, httpd = serve_cli.build(flags + ["--port", "0", "--host",
                                              "127.0.0.1", "--device", "cpu"])
    httpd.server_close()
    backend.close()


def test_flash_attention_never_takes_the_plain_version_off_the_cpu(
        monkeypatch):
    from recommendflow_tpu_torch.ops.cuda import flash_attention as kfa

    def boom(*a, **k):
        raise AssertionError("plain version reached with a non-CPU tensor")

    monkeypatch.setattr(kfa, "flash_attention_plain", boom)
    q = torch.empty((2, 3, 5, 8), device="meta")
    mask = torch.empty((2, 5), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kfa.flash_attention(q, q, q, mask)
    before = kfa.flash_attention.launches
    monkeypatch.undo()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 3, 5, 8).astype(np.float32))
    assert kfa.flash_attention(x, x, x).shape == (2, 3, 5, 8)
    assert kfa.flash_attention.launches == before


def _module_constant(path, name):
    tree = ast.parse(open(path).read(), filename=path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(f"{name} not found in {path}")


def test_chip_smoke_rehearsal_covers_every_phase():
    phases = _module_constant(os.path.join(ROOT, "chip_smoke.py"), "PHASES")
    rehearsed = _module_constant(
        os.path.join(ROOT, "tests", "test_torch_chip_smoke.py"), "REHEARSED")
    assert {"flash_attention", "encode", "serve", "cli"} <= set(phases)
    assert sorted(rehearsed) == sorted(set(phases) - {"build", "times"})
