"""Nested parameter and cache trees: dicts, lists and tuples of tensors.

The port keeps the JAX package's trees as they are (dicts of leaves,
lists of blocks, pattern leaves stacked over periods), so the JAX
package's ``jax.tree.map`` and ``jax.tree.leaves`` have these two
counterparts here.  Dicts are walked in sorted key order, as JAX does.
"""

from __future__ import annotations

__all__ = ["tree_map", "tree_leaves_with_path"]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``,
    which must have its structure; returns a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest, strict=True))
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path=()):
    """``[(path, leaf), ...]``: a path is the tuple of dict keys and list
    indices from the root to the leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in tree_leaves_with_path(t, path + (i,))]
    return [(path, tree)]
