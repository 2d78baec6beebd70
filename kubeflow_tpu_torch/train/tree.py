"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Leaves are visited in sorted-key order, the order ``jax.tree.leaves``
gives a dict, so a sum over leaves adds them up in the same order as the
JAX package does."""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """``{"a/b/c": leaf}`` for every leaf, in sorted-key order."""
    if isinstance(tree, dict):
        out: dict[str, Any] = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat: dict[str, Any]) -> dict:
    """The inverse of ``flatten``."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def map_tree(fn: Callable, tree: Any) -> Any:
    """``fn`` over every leaf of ``tree``; same keys."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)
