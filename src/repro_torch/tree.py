"""Nested dict / list parameter trees: leaves in the JAX package's order.

``jax.tree`` flattens a dict in sorted key order and a list in index
order; the port's optimizers, gradient lists and checkpoints walk trees the
same way, so a leaf's position and its ``::``-joined key agree with the
reference's (a list index is written ``#i``, as ``jax.tree_util`` names a
sequence entry).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree, prefix: tuple = ()) -> List[Tuple[tuple, Any]]:
    """[(path, leaf)] in JAX's order; empty dicts and lists and ``None``
    contribute no leaf."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten(v, prefix + (i,))]
    if tree is None:
        return []
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def key_of(path: tuple, sep: str = "::") -> str:
    """A path as the reference's checkpoint key: names as they are, list
    indices as ``#i``."""
    return sep.join(f"#{p}" if isinstance(p, int) else str(p) for p in path)


def map_tree(fn: Callable, tree):
    """``fn`` applied to every leaf; dicts and lists keep their shape."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)
