"""Parameter trees: nested dicts / lists / tuples of tensors, the port's
counterpart of JAX pytrees. Leaves are visited in the first tree's
order (dict insertion order); the other trees are indexed by its keys, so
a dict built in another key order (JAX rebuilds dicts in sorted order)
still pairs leaf by leaf."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *other_leaves)`` over ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *other_leaves)`` over ``tree``'s structure, path
    the tuple of keys / indices (as str) down to the leaf; the other
    trees are indexed by its keys, so a tuple standing at a leaf of
    ``tree`` (a spec) is one leaf there."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)
