"""The port stands alone: no module of super_tpu_torch, and not
chip_smoke.py, imports JAX (or flax, optax, orbax), the JAX package
``super_tpu``, or the root CLIs and bench (run_super, run_semantic_super,
bench).  Each file is parsed, not imported, so an import inside a function
counts too."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "super_tpu",
             "run_super", "run_semantic_super", "bench")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "super_tpu_torch")):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def forbidden_imports(source: str):
    """(line, module) of every import whose top-level package is one of
    FORBIDDEN (``super_tpu_torch`` is not ``super_tpu``)."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in FORBIDDEN]
    return bad


def test_guard_sees_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom super_tpu.core import lm\n"
           "def f():\n    import run_super\n"
           "from super_tpu_torch import bench\nimport super_tpu_torch.bench\n")
    assert forbidden_imports(src) == [(1, "jax.numpy"), (2, "super_tpu.core"),
                                      (4, "run_super")]


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports(path):
    with open(os.path.join(REPO, path)) as f:
        assert forbidden_imports(f.read()) == [], path
