"""The check that no JAX reaches a run: no loaded module whose top-level
name (the part before the first dot, compared whole) is ``jax``,
``jaxlib``, ``flax`` or ``super_tpu``, the JAX package.  The port,
``super_tpu_torch``, passes."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "super_tpu"})


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & FORBIDDEN)
