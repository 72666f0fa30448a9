"""Nested dicts, lists and tuples of tensors, the port's parameter and
optimizer-state trees.

The JAX package's ``jax.tree`` functions, reduced to what the port uses:
a node is a dict, a list or a tuple (a NamedTuple such as ``AdamWState``
keeps its type); anything else is a leaf.
"""
from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _rebuild(node, children):
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree``; each tree of ``rest`` is walked only
    as deep as ``tree``, so where ``tree`` has a leaf ``fn`` receives
    whatever ``rest`` holds there (a subtree such as a ``QuantState``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in a fixed order: dict insertion order, then list order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> list:
    """Each leaf's path, in ``tree_leaves`` order: ``.key`` for a dict
    entry, ``[i]`` for a list or tuple element (``.blocks[0].attn.wq``)."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in tree_paths(v, f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in tree_paths(v, f"{prefix}[{i}]")]
    return [prefix]


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the structure holds")
    return out
