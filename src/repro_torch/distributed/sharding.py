"""Partition specs, logical-axis sharding rules, and their DTensor placements.

A :class:`PartitionSpec` (``P``) is a tuple of entries aligned to a
tensor's modes: ``None`` (replicated), a mesh-axis name, or a tuple of
names (the mode is split over several mesh axes, outer axis major).  A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` name its axes.  :func:`placements` turns a spec into
the DTensor placements of the same sharding: an entry naming axis ``a``
on tensor dim ``i`` becomes ``Shard(i)`` on mesh dim ``a``.

Models annotate tensors with *logical* axis names via :func:`logical`;
a :class:`ShardingRules` context maps those names onto physical mesh axes.
Outside any context the annotations are no-ops, so the same model code runs
single-device (smoke tests) and on a mesh.

Default production rules (mesh axes ``pod``/``data``/``model``):

==============  =======================  =================================
logical axis    physical                 used for
==============  =======================  =================================
batch           ("pod", "data")          DP: global batch
seq_sharded     "model"                  SP: residual-stream sequence axis
vocab           "model"                  TP: embedding/LM-head vocab
heads           "model"                  TP: attention q-heads
kv_heads        "model"                  TP: kv heads (replicated if < TP)
ff              "model"                  TP: dense FFN hidden
expert          "data"                   EP: MoE expert axis
expert_ff       "model"                  TP inside each expert
d_model         None                     replicated
stage           "pod"                    PP stage axis (pipeline configs)
==============  =======================  =================================
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

__all__ = [
    "PartitionSpec",
    "P",
    "ShardingRules",
    "use_rules",
    "current_rules",
    "logical",
    "named_sharding",
    "specs_equal",
    "placements",
    "spec_of",
    "group_index",
    "local_block",
    "NamedSharding",
    "device_put",
    "own_block",
    "reduce_partial",
    "rank_grid",
    "DEFAULT_RULES",
]


class PartitionSpec(tuple):
    """Per-mode sharding entries: ``None``, a mesh-axis name, or a tuple of
    names.  Immutable; ``P("x", None)`` shards mode 0 over axis ``x``."""

    def __new__(cls, *entries):
        return super().__new__(
            cls, tuple(tuple(e) if isinstance(e, list) else e for e in entries))

    def __reduce__(self):
        return (PartitionSpec, tuple(self))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def specs_equal(a: P | None, b: P | None) -> bool:
    """``PartitionSpec`` equality modulo trailing ``None`` entries.

    jax trims trailing ``None``s when it materializes a sharding, so the
    spec read back from an array (``x.sharding.spec``) may be shorter than
    the one requested: ``P("y", None)`` comes back as ``P("y")``, and the
    two do **not** compare equal with ``==``.  Every comparison of
    partition specs in this repo must go through this helper — comparing
    with ``==`` (or asserting against both spellings per call site) is
    exactly the bug class this centralizes away.  ``None`` compares as
    the fully-replicated spec ``P()``.
    """
    ta = tuple(a) if a is not None else ()
    tb = tuple(b) if b is not None else ()
    n = max(len(ta), len(tb))
    ta += (None,) * (n - len(ta))
    tb += (None,) * (n - len(tb))
    return ta == tb

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq_sharded": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "expert": "model",      # EP: expert axis (GShard grouped dispatch)
    "expert_ff": "data",    # second-axis sharding of expert FFN weights
    "d_model": None,
    "stage": "pod",
    "kv_seq": "model",          # decode: KV-cache sequence axis (SP)
    "zero1": ("pod", "data"),   # ZeRO-1 optimizer-state partitioning
}

_state = threading.local()


def _group(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: P | None, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim an entry of tensor dim ``i`` names, ``Replicate()`` elsewhere.

    DTensor splits a dim sharded over several mesh dims in mesh-dim order
    (the first mesh dim outermost), so a tuple entry must list its axes in
    that order to mean what the spec means (outer axis major); another
    order raises ``NotImplementedError``.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec or ()):
        g = _group(entry)
        dims = [names.index(a) if a in names else -1 for a in g]
        if -1 in dims:
            raise ValueError(f"PartitionSpec {spec} names mesh axes not in mesh {names}")
        if dims != sorted(dims):
            raise NotImplementedError(
                f"PartitionSpec entry {entry!r} lists mesh axes out of mesh order "
                f"{names}: DTensor orders a dim's shards by mesh dim")
        for d in dims:
            if out[d] != Replicate():
                raise ValueError(f"mesh axis {names[d]!r} shards two dims in {spec}")
            out[d] = Shard(i)
    return tuple(out)


def spec_of(x) -> P:
    """The ``PartitionSpec`` of a DTensor's placements, trailing ``None``
    entries trimmed."""
    from torch.distributed.tensor import Replicate, Shard

    entries: list[tuple] = [()] * x.ndim
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(p, Shard):
            entries[p.dim] += (name,)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} has no PartitionSpec (only Shard/Replicate)")
    while entries and not entries[-1]:
        entries.pop()
    return P(*[None if not g else g[0] if len(g) == 1 else g for g in entries])


def rank_grid(mesh):
    """The mesh's ranks as a numpy array of its shape.  Read with every
    dispatch mode off: the grid is bookkeeping on the host, which a step
    traced on fake tensors (or under a cost counter) must neither fake
    nor count."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return mesh.mesh.numpy().copy()


def group_index(group: tuple[str, ...], mesh) -> int:
    """This rank's linear shard index over an axis group (outer axis
    major), from its mesh coordinate."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = 0
    for ax in group:
        d = names.index(ax)
        idx = idx * mesh.shape[d] + coord[d]
    return idx


def local_block(x, spec: P | None, mesh):
    """This rank's block of a tensor ``x`` that holds the global value, as
    a view (``narrow`` per sharded dim — no copy)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for i, entry in enumerate(spec or ()):
        g = _group(entry)
        n = math.prod(sizes[a] for a in g)
        if n > 1:
            if x.shape[i] % n:
                raise ValueError(
                    f"dim {i} (size {x.shape[i]}) is not divisible by its sharding "
                    f"{entry} ({n} shards)")
            step = x.shape[i] // n
            x = x.narrow(i, group_index(g, mesh) * step, step)
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a ``PartitionSpec`` over its named axes: the counterpart
    of ``jax.sharding.NamedSharding``; :attr:`placements` are its DTensor
    placements."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def device_put(tree, shardings):
    """``tree`` placed on ``shardings`` (a matching tree of
    :class:`NamedSharding`), as ``jax.device_put(tree, shardings)``.

    A plain leaf holds the global value on every rank and becomes a
    DTensor over this rank's block, a view of it (nothing is allocated or
    sent); a DTensor leaf is redistributed if its placements differ."""
    from repro_torch.distributed.contract import as_dtensor  # deferred: it imports this
    from repro_torch.models.tree import tree_map

    return tree_map(lambda x, s: as_dtensor(x, s.spec, s.mesh), tree, shardings)


def own_block(x):
    """A DTensor ``x`` with this rank's block copied into a storage of its
    own (:func:`device_put` gives views of the global tensor's, which keep
    it alive)."""
    import torch
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local().clone(memory_format=torch.contiguous_format),
                              x.device_mesh, x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def reduce_partial(x):
    """A DTensor with every ``Partial`` placement reduced to ``Replicate``
    (a sum or mean over a sharded dim leaves one pending); anything else
    as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


class ShardingRules:
    """Maps logical axis names to mesh axes for one mesh."""

    def __init__(self, mesh, rules: dict | None = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    def physical(self, logical_axes: tuple) -> P:
        names = []
        used: set = set()
        axis_sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

        def resolve(ax):
            if ax is None:
                return None
            phys = self.rules.get(ax, None)
            if phys is None:
                return None
            # drop axes not present in this mesh, or already used by an
            # earlier dim (a PartitionSpec may not repeat a mesh axis)
            if isinstance(phys, str):
                phys = (phys,)
            keep = tuple(p for p in phys if p in axis_sizes and p not in used)
            used.update(keep)
            if not keep:
                return None
            return keep if len(keep) > 1 else keep[0]

        for ax in logical_axes:
            names.append(resolve(ax))
        return P(*names)

    def sharding(self, logical_axes: tuple) -> tuple:
        """The DTensor placements of these logical axes on the mesh."""
        return placements(self.physical(logical_axes), self.mesh)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def current_rules() -> ShardingRules | None:
    return getattr(_state, "rules", None)


def logical(x, *logical_axes):
    """Annotate ``x`` with logical axes; no-op outside a rules context.

    Inside one, a DTensor is redistributed to the rules' placements; a
    plain tensor (one rank's whole value) is returned as it is."""
    rules = current_rules()
    if rules is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"{len(logical_axes)} axes for rank-{x.ndim} tensor")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(rules.mesh, rules.sharding(tuple(logical_axes)))


def named_sharding(logical_axes: tuple) -> tuple | None:
    """The DTensor placements for logical axes under the current rules, or None."""
    rules = current_rules()
    if rules is None:
        return None
    return rules.sharding(tuple(logical_axes))
