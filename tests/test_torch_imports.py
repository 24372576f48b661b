"""The port and chip_smoke.py import nothing of JAX, flax, optax, msgpack or
the JAX package (whose name the port's name begins with): a static check of
every source, and a run that imports each module of the training path in a
fresh interpreter and looks at what got loaded."""
import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|optax|msgpack|eigentrajectory_tpu)(\.|$)")


def _port_sources():
    root = os.path.join(REPO, "eigentrajectory_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(root):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_port_imports_no_jax():
    paths = _port_sources()
    assert len(paths) > 10 and os.path.exists(paths[0])
    line_re = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|msgpack|eigentrajectory_tpu)\b(?!_torch)",
                         re.M)
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert not line_re.search(src), path
        for node in ast.walk(ast.parse(src)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert not _FORBIDDEN.match(name), (path, name)


@pytest.mark.parametrize("module", [
    "eigentrajectory_tpu_torch.trainval",
    "eigentrajectory_tpu_torch.train.trainer",
    "eigentrajectory_tpu_torch.interop",
    "eigentrajectory_tpu_torch.etspace.anchor",
    "eigentrajectory_tpu_torch.etspace.descriptor",
    "eigentrajectory_tpu_torch.etspace.facade",
    "eigentrajectory_tpu_torch.utils.profiling",
    "eigentrajectory_tpu_torch.models.pecnet",
    "eigentrajectory_tpu_torch.models.lbebm",
    "eigentrajectory_tpu_torch.models.agentformer",
    "eigentrajectory_tpu_torch.models.dmrgcn",
    "eigentrajectory_tpu_torch.models.graphtern",
    "eigentrajectory_tpu_torch.models.gpgraphstgcnn",
    "eigentrajectory_tpu_torch.models.gpgraphsgcn",
    "eigentrajectory_tpu_torch.models.implicit",
    "eigentrajectory_tpu_torch.ops.group",
    "eigentrajectory_tpu_torch.models.common",
    "eigentrajectory_tpu_torch.inference",
    "eigentrajectory_tpu_torch.data.batching",
    "eigentrajectory_tpu_torch.parallel",
    "eigentrajectory_tpu_torch.parallel.mesh",
    "eigentrajectory_tpu_torch.parallel.dryrun",
    "eigentrajectory_tpu_torch.data.native_loader",
    "eigentrajectory_tpu_torch.data.dataset",
    "eigentrajectory_tpu_torch.metrics",
    "eigentrajectory_tpu_torch.utils.misc",
    "eigentrajectory_tpu_torch.analysis.curves",
    "eigentrajectory_tpu_torch.analysis.descriptor_evaluation",
    "eigentrajectory_tpu_torch.analysis.visualization",
])
def test_training_modules_load_nothing_of_jax(module):
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'eigentrajectory_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]", out


def test_port_imports_no_plotting_library():
    """The card's machine has neither matplotlib nor sklearn: importing the
    trainer, the predictor, the descriptor evaluation and the plots module
    loads neither (the plots import them inside the functions that draw)."""
    code = ("import sys, eigentrajectory_tpu_torch.analysis.visualization, "
            "eigentrajectory_tpu_torch.analysis.descriptor_evaluation, "
            "eigentrajectory_tpu_torch.train, eigentrajectory_tpu_torch.inference\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'sklearn')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]", out
