"""Nested dict/list/tuple trees: the small part of ``jax.tree_util`` that
the port's model code needs.

Dicts, lists and tuples are nodes; ``None`` is an empty node (kept as
``None``); everything else is a leaf. Dict keys are visited in sorted order,
as ``jax.tree_util`` visits them, and path strings have ``keystr``'s form,
e.g. ``['blocks']['cycle']['p0']['mixer']['wq']``.
"""
from __future__ import annotations


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` applied leaf-wise over ``tree`` and the same-shaped ``rest``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, x, *(r[i] for r in rest), is_leaf=is_leaf)
            for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, is_leaf=None, _path: str = ""):
    """``fn(path, leaf)`` over ``tree``; ``path`` is a keystr-style string."""
    if is_leaf is not None and is_leaf(tree):
        return fn(_path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], is_leaf, f"{_path}[{k!r}]")
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, x, is_leaf, f"{_path}[{i}]")
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn(_path, tree)


def tree_leaves(tree, is_leaf=None) -> list:
    """Leaves in ``jax.tree_util.tree_leaves`` order (dict keys sorted)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    if tree is None:
        return []
    return [tree]
