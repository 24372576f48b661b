"""Nothing of the benchmark imports JAX or the JAX package (top-level module
names compared whole: the program's name begins with the JAX package's),
and the reference imports nothing of the program."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "eigentrajectory_tpu"}
PROGRAM = "eigentrajectory_tpu_torch"


def _files(sub=""):
    for base, _, names in os.walk(os.path.join(HERE, sub)):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def _imports(path):
    """Top-level names of every module `path` imports, at any depth, and of
    every string handed to importlib."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_files()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not (_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_files("reference")), ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in _imports(path)
    with open(path) as f:
        assert PROGRAM not in f.read()


def test_the_guard_compares_whole_names():
    from etbench.run import FORBIDDEN as RUN_FORBIDDEN

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "eigentrajectory_tpu_torch".split(".")[0] not in FORBIDDEN
