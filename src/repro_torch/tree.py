"""Nested dicts, lists and tuples of tensors, the port's parameter and
optimizer-state trees.

The JAX package's ``jax.tree`` functions, reduced to what the port uses:
a node is a dict, a list or a tuple (a NamedTuple such as ``AdamWState``
keeps its type) or a dataclass instance such as a ``KVCache``, walked
field by field, whose scalar fields (``KVCache.window``) are kept as they
are and are no leaves; anything else is a leaf.
"""
from __future__ import annotations

import dataclasses

_SCALAR = (int, float, str, bool, type(None))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _rebuild(node, children):
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _fields(x) -> list:
    """A dataclass node's non-scalar field names, in declaration order."""
    return [f.name for f in dataclasses.fields(x) if not isinstance(getattr(x, f.name), _SCALAR)]


def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree``; each tree of ``rest`` is walked only
    as deep as ``tree``, so where ``tree`` has a leaf ``fn`` receives
    whatever ``rest`` holds there (a subtree such as a ``QuantState``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)])
    if _is_dataclass(tree):
        return dataclasses.replace(tree, **{
            n: tree_map(fn, getattr(tree, n), *(getattr(r, n) for r in rest))
            for n in _fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in a fixed order: dict insertion order, then list order, then
    a dataclass's field order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    if _is_dataclass(tree):
        return [leaf for n in _fields(tree) for leaf in tree_leaves(getattr(tree, n))]
    return [tree]


def tree_paths(tree, prefix: str = "") -> list:
    """Each leaf's path, in ``tree_leaves`` order: ``.key`` for a dict
    entry, a NamedTuple's or a dataclass's field, ``[i]`` for a list or
    tuple element (``.blocks[0].attn.wq``, ``.mu.head.w.q``)."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in tree_paths(v, f"{prefix}.{k}")]
    if _is_namedtuple(tree):
        return [n for k, v in zip(tree._fields, tree) for n in tree_paths(v, f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in tree_paths(v, f"{prefix}[{i}]")]
    if _is_dataclass(tree):
        return [p for n in _fields(tree) for p in tree_paths(getattr(tree, n), f"{prefix}.{n}")]
    return [prefix]


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the structure holds")
    return out
