"""Nested dicts, lists and tuples of tensors (the port's parameter and
train-state trees): map over leaves, and list leaves with their paths."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over every leaf of ``tree``,
    keeping the structure; the other trees have the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path=()):
    """[(path, leaf)] in order, ``path`` a tuple of dict keys and list
    indices."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in tree_leaves_with_path(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten_like(tree, leaves):
    """``tree``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
