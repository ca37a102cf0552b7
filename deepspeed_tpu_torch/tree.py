"""Parameter trees: nested dicts whose non-dict values are the leaves
(the JAX package's param layout, without ``jax.tree``)."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable[[Any], Any], tree):
    """The same dict structure with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> List[Any]:
    """Every leaf, in the dicts' insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]
