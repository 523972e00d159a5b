"""Maps over the port's states: (nested) NamedTuples of tensors, with None
leaves left alone (the JAX package's ``jax.tree.map`` on them)."""

from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *parts)
                            for parts in zip(tree, *rest)))
    if tree is None:
        return None
    return fn(tree, *rest)


def stack(trees):
    """Trees of one structure stacked leaf by leaf on a new leading axis:
    the (B, ...) batch of B streams."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def unstack(tree):
    """A (B, ...) batch as B trees of views ``x[b]``."""
    return [tree_map(lambda x, b=b: x[b], tree)
            for b in range(batch_size(tree))]


def leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def batch_size(tree) -> int:
    """The leading axis that every leaf of a stacked batch shares."""
    sizes = {x.shape[0] if x.ndim else None for x in leaves(tree)}
    if len(sizes) != 1 or None in sizes:
        raise ValueError(f"not a stacked batch: leading sizes {sizes}")
    return sizes.pop()
