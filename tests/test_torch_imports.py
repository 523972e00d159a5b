"""The port stands alone: no module of super_tpu_torch, and not
chip_smoke.py or the multi-process tests' worker
(tests/torch_parallel_worker.py), imports JAX (or flax, optax, orbax), the JAX package
``super_tpu``, or the root CLIs and bench (run_super, run_semantic_super,
bench); nor tensorboard or matplotlib, which the card machine lacks.
Each file is parsed, not imported, so an import inside a function counts
too."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "super_tpu",
             "run_super", "run_semantic_super", "bench", "tensorboard",
             "matplotlib")
# Forbidden at any depth of a dotted name (torch.utils.tensorboard too).
FORBIDDEN_ANYWHERE = ("tensorboard", "matplotlib")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tests", "torch_parallel_worker.py")]
    for root, _, files in os.walk(os.path.join(REPO, "super_tpu_torch")):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def forbidden_imports(source: str):
    """(line, module), in line order, of every import whose top-level
    package is one of FORBIDDEN (``super_tpu_torch`` is not
    ``super_tpu``) or any of whose parts is one of FORBIDDEN_ANYWHERE."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in FORBIDDEN
                or set(n.split(".")) & set(FORBIDDEN_ANYWHERE)]
    return sorted(bad)


def test_guard_sees_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom super_tpu.core import lm\n"
           "def f():\n    import run_super\n"
           "from super_tpu_torch import bench\nimport super_tpu_torch.bench\n"
           "import matplotlib.cm as cm\n"
           "from torch.utils.tensorboard import SummaryWriter\n"
           "from tensorboard.backend import event_processing\n")
    assert forbidden_imports(src) == [(1, "jax.numpy"), (2, "super_tpu.core"),
                                      (4, "run_super"), (7, "matplotlib.cm"),
                                      (8, "torch.utils.tensorboard"),
                                      (9, "tensorboard.backend")]


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports(path):
    with open(os.path.join(REPO, path)) as f:
        assert forbidden_imports(f.read()) == [], path
