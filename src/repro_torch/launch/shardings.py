"""Parameter / optimizer-state / cache / batch logical-axis assignment.

Walks the port's parameter, optimizer and cache trees (dicts and lists of
tensors, :mod:`repro_torch.models.tree`) and assigns each leaf a tuple of
logical axis names, resolved to a :class:`~repro_torch.distributed.
sharding.NamedSharding` through :class:`~repro_torch.distributed.sharding.
ShardingRules`; :func:`~repro_torch.distributed.sharding.device_put` then
places a tree on them.  Rules are keyed on ``(parent, leaf_name)`` path
suffixes; leaves stacked over the pattern's periods carry one extra
leading (period) axis, which is never sharded.

The port of ``repro.launch.shardings``: :data:`_RULES` is a copy, and
:func:`param_logical_axes`, :func:`opt_state_logical_axes`,
:func:`batch_logical_axes` and :func:`tree_shardings` assign what the JAX
package's assign.  The cache differs because the trees differ: the JAX
runtime stacks batch-1 caches over a leading slot axis, the port's
runtime keeps one request per batch row (``length`` a vector).  The JAX
package never shards its slot axis and drops ``batch`` from the batch-1
dim (1 does not divide a mesh axis), so :func:`cache_logical_axes` leaves
the port's row axis unsharded and shards what the JAX package shards:
KV rows over ``kv_seq``, SSM channels over ``ff`` and heads over
``heads``.
"""

from __future__ import annotations

from repro_torch.distributed.sharding import NamedSharding, P, ShardingRules
from repro_torch.models.tree import tree_map

__all__ = [
    "param_logical_axes", "cache_logical_axes", "batch_logical_axes",
    "tree_shardings", "opt_state_logical_axes",
]

# (parent, name) → logical axes of the *unstacked* leaf
_RULES: dict[tuple[str, str], tuple] = {
    ("", "embed"): ("vocab", "d_model"),
    ("", "lm_head"): ("d_model", "vocab"),
    ("", "final_norm"): (None,),
    ("frontend", "proj"): (None, None),
    ("attn", "wq"): (None, "heads"),
    ("attn", "wk"): (None, "kv_heads"),
    ("attn", "wv"): (None, "kv_heads"),
    ("attn", "wo"): ("heads", None),
    ("mlp", "wi"): (None, "ff"),
    ("mlp", "wg"): (None, "ff"),
    ("mlp", "wo"): ("ff", None),
    ("moe", "router"): (None, None),
    ("moe", "wi"): ("expert", None, "expert_ff"),
    ("moe", "wg"): ("expert", None, "expert_ff"),
    ("moe", "wo"): ("expert", "expert_ff", None),
    ("shared", "wi"): (None, None, "ff"),
    ("shared", "wg"): (None, None, "ff"),
    ("shared", "wo"): (None, "ff", None),
    ("mamba", "in_proj"): (None, "ff"),
    ("mamba", "conv_w"): (None, "ff"),
    ("mamba", "conv_b"): ("ff",),
    ("mamba", "A_log"): ("heads",),
    ("mamba", "D"): ("heads",),
    ("mamba", "dt_bias"): ("heads",),
    ("mamba", "norm"): ("ff",),
    ("mamba", "out_proj"): ("ff", None),
}


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a dict/list tree; a path holds dict keys and
    list indices, as :func:`repro_torch.models.tree.tree_leaves_with_path`."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _names(path) -> list[str]:
    """The dict keys of a path (list indices dropped)."""
    return [str(k) for k in path if not isinstance(k, int)]


def _lookup(path, leaf) -> tuple:
    names = _names(path)
    name = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    base = _RULES.get((parent, name))
    if base is None:
        base = _RULES.get(("", name))
    if base is None:
        if name.startswith("norm"):
            base = (None,) * leaf.ndim
        else:
            raise KeyError(f"no sharding rule for param path {names}")
    # stacking over the pattern's periods adds exactly one leading axis
    while len(base) < leaf.ndim:
        base = (None,) + base
    if len(base) != leaf.ndim:
        raise ValueError(f"rule {base} for {names} does not fit shape {tuple(leaf.shape)}")
    return base


def param_logical_axes(params):
    """Tree of logical-axis tuples matching the params tree."""
    return _map_with_path(_lookup, params)


def opt_state_logical_axes(params, *, zero1: bool = True):
    """AdamW state: moments mirror the params; step is replicated.

    With ``zero1=True`` each moment leaf additionally shards its first
    unsharded dim over the ``zero1`` logical axis (→ data): optimizer
    state is partitioned (ZeRO-1), and the update runs on the moments'
    blocks (:func:`repro_torch.training.optimizer.adamw_update`).
    """
    p_axes = param_logical_axes(params)
    if zero1:

        def z(axes):
            axes = tuple(axes)
            # never zero1 the leading period axis (rank > base rank): its
            # trip count rarely divides the mesh, and claiming `data` there
            # starves the real weight dims
            start = 1 if len(axes) >= 3 else 0
            for i in range(start, len(axes)):
                if axes[i] is None:
                    return axes[:i] + ("zero1",) + axes[i + 1:]
            return axes

        m_axes = tree_map(z, p_axes, is_leaf=_is_axes)
    else:
        m_axes = p_axes
    return {"mu": m_axes, "nu": m_axes, "step": ()}


def cache_logical_axes(cache):
    """Decode-cache tree: KV rows, SSM state, length counters.  The row
    (request) axis is never sharded; see the module docstring."""

    def assign(path, leaf):
        names = _names(path)
        name = names[-1] if names else ""
        if name == "length":
            return (None,) * leaf.ndim
        if name in ("k", "v"):
            base = (None, "kv_seq", "kv_heads", None)
        elif name in ("k_scale", "v_scale"):
            base = (None, "kv_seq", "kv_heads")
        elif name == "conv":
            base = (None, None, "ff")
        elif name == "state":
            base = (None, "heads", None, None)
        else:
            raise KeyError(f"no cache rule for {names}")
        while len(base) < leaf.ndim:
            base = (None,) + base
        return base

    return _map_with_path(assign, cache)


def batch_logical_axes(batch):
    """Input batch: tokens/labels (B, S); features (B, S, D)."""
    return _map_with_path(lambda path, leaf: ("batch",) + (None,) * (leaf.ndim - 1), batch)


def tree_shardings(rules: ShardingRules, axes_tree, spec_tree=None):
    """Logical-axes tree → :class:`NamedSharding` tree.

    With ``spec_tree`` (a matching tree of tensors, meta tensors, or
    anything with a ``shape``) the resolution is size-aware: a mesh axis
    that does not divide the dimension is dropped, innermost first.  E.g.
    qwen2's 60 experts don't divide a 16-way axis → the expert stack is
    replicated.
    """
    axis_sizes = dict(zip(rules.mesh.mesh_dim_names, rules.mesh.shape))

    def resolve(axes, spec=None):
        pspec = rules.physical(tuple(axes))
        if spec is None:
            return NamedSharding(rules.mesh, pspec)
        parts = list(pspec) + [None] * (len(spec.shape) - len(pspec))
        fixed = []
        for dim, entry in zip(spec.shape, parts):
            if entry is None:
                fixed.append(None)
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            while names:
                prod = 1
                for nm in names:
                    prod *= axis_sizes[nm]
                if dim % prod == 0:
                    break
                names = names[:-1]  # drop the innermost axis and retry
            fixed.append(tuple(names) if len(names) > 1 else (names[0] if names else None))
        return NamedSharding(rules.mesh, P(*fixed))

    if spec_tree is None:
        return tree_map(resolve, axes_tree, is_leaf=_is_axes)
    return tree_map(resolve, axes_tree, spec_tree, is_leaf=_is_axes)
