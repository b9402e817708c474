"""recommendflow_tpu_torch stands alone and never runs silently on the CPU.

* No module of the port, and not chip_smoke.py, imports jax, flax, optax,
  orbax or the JAX package (checked on the source with ast, so lazy imports
  inside functions count too).
* An entry point asked for the default device raises on a machine without a
  card; a kernel wrapper handed a non-CPU tensor launches its kernel or
  raises, and never reaches the plain version.
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
    return files + [os.path.join(ROOT, "chip_smoke.py")]


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
    assert resolve_device("cpu") == torch.device("cpu")


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
