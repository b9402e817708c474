"""Import hygiene of every module under portbench/: no JAX, no JAX package
(module names compared whole: the port's name starts with the JAX
package's), nothing of the program in the reference, and no fixed path
under /tmp or /dev/shm."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "recommendflow_tpu"}
PORT = "recommendflow_tpu_torch"
# built, so that this file holds no such constant itself
FIXED_ROOTS = ("/" + "tmp", "/" + "dev/shm")


def modules():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_module_hygiene(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = list(imported(tree))
    tops = {n.split(".")[0] for n in names}
    assert not tops & FORBIDDEN, f"{path} imports {sorted(tops & FORBIDDEN)}"
    if os.sep + "reference" + os.sep in path:
        assert PORT not in tops, f"{path}: the reference imports the program"
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not node.value.startswith(FIXED_ROOTS), \
                f"{path}: fixed path {node.value!r}"


def test_top_level_names_compare_whole():
    """recommendflow_tpu_torch passes, recommendflow_tpu does not."""
    tree = ast.parse("import recommendflow_tpu_torch.train\n"
                     "from recommendflow_tpu_torch import x\n")
    assert not {n.split(".")[0] for n in imported(tree)} & FORBIDDEN
    tree = ast.parse("from recommendflow_tpu.models import x\n")
    assert {n.split(".")[0] for n in imported(tree)} & FORBIDDEN
