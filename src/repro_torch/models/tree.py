"""Nested parameter and cache trees: dicts, lists and tuples of tensors.

The port keeps the JAX package's trees as they are (dicts of leaves,
lists of blocks, pattern leaves stacked over periods), so the JAX
package's ``jax.tree.map``, ``jax.tree.leaves`` and ``jax.tree.unflatten``
have these counterparts here.  Leaves are listed with dicts walked in sorted
key order, as JAX flattens, so a checkpoint's ``leaf_%05d.npy`` files are
numbered alike in both packages.
"""

from __future__ import annotations

__all__ = ["tree_map", "tree_leaves", "tree_leaves_with_path", "tree_unflatten"]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``,
    which must have its structure; returns a tree of that structure.
    ``is_leaf(node)`` true stops the walk at ``node`` (as in ``jax.tree.map``,
    e.g. for trees whose leaves are tuples)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs, is_leaf=is_leaf)
                          for xs in zip(tree, *rest, strict=True))
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path=()):
    """``[(path, leaf), ...]``: a path is the tuple of dict keys and list
    indices from the root to the leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in tree_leaves_with_path(t, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves``, given in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out
