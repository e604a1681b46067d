"""Shard-aware contraction execution over a ``DeviceMesh``.

The paper's STRIDEDBATCHEDGEMM primitive evaluates one pairwise
contraction without copies *on one device*.  This module scales the same
primitive across a ``torch.distributed.device_mesh.DeviceMesh``: every
rank runs the port's planner/kernel stack
(:func:`repro_torch.core.contract.contract`) on its local blocks, and
explicit collectives are inserted **only where the contracted mode is
sharded** — the distributed mirror of the paper's "no copies unless the
layout forces one".

Sharding model
--------------

Operand shardings are given as per-operand ``PartitionSpec``s
(:mod:`repro_torch.distributed.sharding`) aligned to the operand's mode
string (``P("x", None)`` for modes ``"mk"`` shards ``m`` over mesh axis
``x``).  From these a **global mode→axis map** is resolved with two
invariants (violations raise ``ValueError``):

* a mode sharded in both operands must be sharded identically;
* one mesh axis shards at most one mode (so no tensor anywhere in a
  contraction path can need the same axis twice).

Execution of ``C = A · B`` then follows from the mode classes:

=================  ==========================================================
mode class          treatment
=================  ==========================================================
batch / free        stays sharded; no communication — every shard's block of
                    C depends only on its blocks of A and B
contracted,         each shard holds matching ``k``-slices; local GEMM gives
both operands       a *partial* C block → ``all_reduce`` over the mode's
                    axes, or ``reduce_scatter`` when the caller's
                    ``out_spec`` shards an output mode over those axes
contracted,         the replicated operand is **sliced locally** to the
one operand         matching ``k``-block (a ``narrow`` view — zero bytes
                    moved), then as above
=================  ==========================================================

A caller-requested ``out_spec`` that disagrees with the natural output
sharding is honored with ``all_gather`` (mode sharded → replicated) and
local slicing (replicated → sharded).

Operands are DTensors on the mesh (redistributed to the planned
placements when they differ) or plain tensors that hold the global value
on every rank (each rank takes its block as a view).  The result is a
DTensor with the plan's ``out_spec`` placements.  Collectives run through
``torch.distributed`` on the mesh's per-axis groups; a group of several
axes is built once per mesh with ``new_group``.  A collective over a
group of one rank is the identity and is not issued.  The mesh's device
type must be the operands': nothing moves a tensor to make a call work.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.notation import ContractionSpec, parse_spec
from repro_torch.distributed.sharding import (
    PartitionSpec as P,
    group_index,
    local_block,
    placements,
    rank_grid,
    specs_equal,
)

__all__ = [
    "resolve_mode_axes",
    "local_dims",
    "ShardedPlan",
    "plan_sharded",
    "sharded_contract",
    "as_dtensor",
]

AxisGroup = tuple[str, ...]


def _as_group(entry) -> AxisGroup:
    """Normalize a PartitionSpec entry to a tuple of mesh-axis names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _entry(group: AxisGroup):
    """Inverse of :func:`_as_group` — the PartitionSpec-style entry."""
    if not group:
        return None
    return group[0] if len(group) == 1 else tuple(group)


def _mode_partition(modes: str, pspec) -> dict[str, AxisGroup]:
    """Align one operand's PartitionSpec to its mode string."""
    entries = tuple(pspec) if pspec is not None else ()
    if len(entries) > len(modes):
        raise ValueError(
            f"PartitionSpec {pspec} has {len(entries)} entries for "
            f"rank-{len(modes)} operand {modes!r}"
        )
    out: dict[str, AxisGroup] = {}
    for m, e in zip(modes, entries):
        g = _as_group(e)
        if g:
            out[m] = g
    return out


def resolve_mode_axes(mode_strings, pspecs, *, mesh: DeviceMesh) -> dict:
    """Global mode → mesh-axis entry map from per-operand PartitionSpecs.

    ``mode_strings`` and ``pspecs`` run parallel (``pspecs`` may be
    ``None`` for all-replicated, and individual entries may be ``None``).
    Values are PartitionSpec-style entries (axis name, or tuple of names
    for a multi-axis sharding).  Raises on: unknown mesh axes, a mode
    sharded differently in two operands, or one mesh axis sharding two
    different modes.
    """
    axis_names = set(mesh.mesh_dim_names)
    if pspecs is None:
        pspecs = (None,) * len(mode_strings)
    if len(pspecs) != len(mode_strings):
        raise ValueError(
            f"{len(mode_strings)} operands but {len(pspecs)} PartitionSpecs"
        )
    mode_axes: dict[str, AxisGroup] = {}
    owner: dict[str, str] = {}  # mesh axis -> mode
    for modes, pspec in zip(mode_strings, pspecs):
        for m, g in _mode_partition(modes, pspec).items():
            bad = set(g) - axis_names
            if bad:
                raise ValueError(
                    f"PartitionSpec for {modes!r} names mesh axes {sorted(bad)} "
                    f"not in mesh {tuple(mesh.mesh_dim_names)}"
                )
            if m in mode_axes and mode_axes[m] != g:
                raise ValueError(
                    f"mode {m!r} sharded over {mode_axes[m]} in one operand "
                    f"but {g} in another; shard a shared mode identically"
                )
            for ax in g:
                if owner.setdefault(ax, m) != m:
                    raise ValueError(
                        f"mesh axis {ax!r} shards both mode {owner[ax]!r} and "
                        f"{m!r}; one axis may shard at most one mode"
                    )
            mode_axes[m] = g
    return {m: _entry(g) for m, g in mode_axes.items()}


def _axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def local_dims(dims: dict, mode_axes: dict, mesh: DeviceMesh) -> dict:
    """Per-shard dims: sharded modes divide by their axis sizes (validated)."""
    sizes = _axis_sizes(mesh)
    out = dict(dims)
    for m, entry in mode_axes.items():
        if m not in dims:
            continue
        f = math.prod(sizes[a] for a in _as_group(entry))
        if f > 1 and dims[m] % f:
            raise ValueError(
                f"mode {m!r} (size {dims[m]}) is not divisible by its "
                f"sharding {entry} (total {f} shards)"
            )
        out[m] = dims[m] // max(f, 1)
    return out


# --------------------------------------------------------------------------
# Planning
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """Everything needed to lower one pairwise contraction over a mesh."""

    spec: ContractionSpec
    mesh: DeviceMesh
    mode_axes: dict                      # global mode -> PartitionSpec entry
    a_spec: P                            # each operand's placements, aligned to modes
    b_spec: P
    out_spec: P                          # the result's placements (final)
    out_axes: dict                       # output mode -> entry (final)
    #: per-operand local slice-ins: (axis position, axis group, mode)
    slice_a: tuple = ()
    slice_b: tuple = ()
    #: reduce_scatter: (output-mode position, axis group) — reduce axes whose
    #: result lands sharded along that output mode
    scatters: tuple = ()
    #: plain all-reduce axes (contracted-mode axes not consumed by scatters)
    psum_axes: tuple = ()
    #: all_gather: (output-mode position, axis group)
    gathers: tuple = ()
    #: output-mode slice-ins applied after reduction: (position, axis group)
    slice_out: tuple = ()

    @property
    def has_communication(self) -> bool:
        return bool(self.scatters or self.psum_axes or self.gathers)

    def describe(self) -> str:
        parts = [f"{self.spec.spec_str()} @ mesh{dict(_axis_sizes(self.mesh))}"]
        if self.mode_axes:
            parts.append(
                "shard{" + ",".join(
                    f"{m}:{e}" for m, e in sorted(self.mode_axes.items())
                ) + "}"
            )
        for s in self.slice_a:
            parts.append(f"slice A[{s[2]}]@{s[1]}")
        for s in self.slice_b:
            parts.append(f"slice B[{s[2]}]@{s[1]}")
        for pos, g in self.scatters:
            parts.append(f"reduce_scatter {self.spec.c_modes[pos]}@{g}")
        if self.psum_axes:
            parts.append(f"psum{self.psum_axes}")
        for pos, g in self.gathers:
            parts.append(f"all_gather {self.spec.c_modes[pos]}@{g}")
        for pos, g in self.slice_out:
            parts.append(f"slice C[{self.spec.c_modes[pos]}]@{g}")
        if not self.has_communication:
            parts.append("no collectives")
        return " ".join(parts)


def plan_sharded(
    spec: str | ContractionSpec,
    dims: dict,
    *,
    mesh: DeviceMesh,
    in_specs,
    out_spec: P | None = None,
) -> ShardedPlan:
    """Plan the sharded lowering of one pairwise contraction.

    ``in_specs`` is a pair of ``PartitionSpec`` (or ``None``) aligned to
    the operands' mode strings; ``out_spec`` optionally requests an
    output sharding (default: the *natural* one — batch/free modes keep
    their input sharding, contracted-mode axes are reduced away).
    """
    cs = parse_spec(spec) if isinstance(spec, str) else spec
    if in_specs is None:
        in_specs = (None, None)
    a_pspec, b_pspec = in_specs
    mode_axes = resolve_mode_axes(
        (cs.a_modes, cs.b_modes), (a_pspec, b_pspec), mesh=mesh
    )
    local_dims(dims, mode_axes, mesh)  # divisibility check, with mode names

    a_shard = _mode_partition(cs.a_modes, a_pspec)
    b_shard = _mode_partition(cs.b_modes, b_pspec)

    # local slice-ins: operand carries a globally-sharded mode replicated —
    # each shard takes its matching block, no bytes moved
    def slices(modes: str, shard: dict) -> tuple:
        out = []
        for i, m in enumerate(modes):
            if m in mode_axes and m not in shard:
                out.append((i, _as_group(mode_axes[m]), m))
        return tuple(out)

    # reduction axes: every axis sharding a contracted mode
    reduce_axes: list[str] = []
    for m in cs.contracted:
        for ax in _as_group(mode_axes.get(m)):
            reduce_axes.append(ax)

    natural = {m: _as_group(mode_axes[m]) for m in cs.c_modes if m in mode_axes}
    if out_spec is None:
        target = dict(natural)
    else:
        entries = tuple(out_spec)
        if len(entries) > len(cs.c_modes):
            raise ValueError(
                f"out_spec {out_spec} has {len(entries)} entries for "
                f"rank-{len(cs.c_modes)} output {cs.c_modes!r}"
            )
        target = {
            m: _as_group(e)
            for m, e in zip(cs.c_modes, entries)
            if _as_group(e)
        }
        sizes = _axis_sizes(mesh)
        used: dict[str, str] = {}
        for m, g in target.items():
            f = math.prod(sizes[a] for a in g)
            bad = set(g) - set(mesh.mesh_dim_names)
            if bad:
                raise ValueError(f"out_spec names unknown mesh axes {sorted(bad)}")
            if f > 1 and dims[m] % f:
                raise ValueError(
                    f"out_spec shards mode {m!r} (size {dims[m]}) over {g} "
                    f"({f} shards): not divisible"
                )
            for ax in g:
                if used.setdefault(ax, m) != m:
                    raise ValueError(
                        f"out_spec uses mesh axis {ax!r} for two output modes"
                    )

    scatters, gathers, slice_out = [], [], []
    scattered: set[str] = set()
    for pos, m in enumerate(cs.c_modes):
        ng, tg = natural.get(m, ()), target.get(m, ())
        if tg == ng:
            continue
        if ng:
            gathers.append((pos, ng))
        if tg:
            if not ng and all(ax in reduce_axes for ax in tg):
                # the classic reduce-scatter: partial sums land sharded
                scatters.append((pos, tg))
                scattered.update(tg)
            else:
                slice_out.append((pos, tg))
    psum_axes = tuple(dict.fromkeys(a for a in reduce_axes if a not in scattered))

    final = {m: target.get(m, ()) for m in cs.c_modes}
    return ShardedPlan(
        spec=cs,
        mesh=mesh,
        mode_axes=mode_axes,
        a_spec=P(*[_entry(a_shard.get(m, ())) for m in cs.a_modes]),
        b_spec=P(*[_entry(b_shard.get(m, ())) for m in cs.b_modes]),
        out_spec=P(*[_entry(final[m]) for m in cs.c_modes]),
        out_axes={m: _entry(g) for m, g in final.items() if g},
        slice_a=slices(cs.a_modes, a_shard),
        slice_b=slices(cs.b_modes, b_shard),
        scatters=tuple(scatters),
        psum_axes=psum_axes,
        gathers=tuple(gathers),
        slice_out=tuple(slice_out),
    )


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------

#: (id of the mesh, axis group) -> (the mesh, this rank's process group over
#: the group); the mesh is held so that its id is not reused while the entry
#: lives, and a mesh of a new world of the same shape gets groups of its own
_GROUPS: dict = {}


def _process_group(mesh: DeviceMesh, group: AxisGroup):
    """The process group over ``group``'s mesh axes that holds this rank,
    its ranks in shard-index order (outer axis major).  One axis is the
    mesh's own group; several get groups of their own, built once per mesh
    by every rank (``new_group`` is collective over the world)."""
    if len(group) == 1:
        return mesh.get_group(group[0])
    key = (id(mesh), group)
    pg = _GROUPS.get(key, (None, None))[1]
    if pg is None:
        names = tuple(mesh.mesh_dim_names)
        dims = [names.index(a) for a in group]
        if dims != sorted(dims):
            raise NotImplementedError(
                f"axis group {group} lists mesh axes out of mesh order {names}")
        rest = [d for d in range(len(names)) if d not in dims]
        rows = rank_grid(mesh).transpose(rest + dims).reshape(-1, math.prod(
            mesh.shape[d] for d in dims))
        me = dist.get_rank()
        for row in rows.tolist():
            new = dist.new_group(ranks=row)
            if me in row:
                pg = new
        _GROUPS[key] = mesh, pg
    if dist.get_group_rank(pg, dist.get_rank()) != group_index(group, mesh):
        raise RuntimeError(f"process group over {group} does not order its ranks "
                           f"outer axis major")
    return pg


def _nshards(mesh: DeviceMesh, group: AxisGroup) -> int:
    sizes = _axis_sizes(mesh)
    return math.prod(sizes[a] for a in group)


def _all_reduce_(x, pg, op=dist.ReduceOp.SUM):
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=pg)
    return x


def _reduce_scatter_(src, n: int, pg):
    """Sum ``src`` (blocks stacked on dim 0) over ``pg``; this rank's block."""
    if src.shape[0] % n:
        raise ValueError(f"reduce-scatter of a dim of size {src.shape[0]} over {n} "
                         f"shards: not divisible")
    src = src.contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    if out.numel() * n != src.numel():
        raise ValueError("reduce-scatter buffers do not match")
    with warnings.catch_warnings():
        # newer torch renames it; the old name exists in every version used
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=pg)
    return out


def _all_gather_(src, n: int, pg):
    """``pg``'s blocks of ``src`` concatenated on dim 0."""
    src = src.contiguous()
    out = src.new_empty((src.shape[0] * n, *src.shape[1:]))
    if out.numel() != src.numel() * n:
        raise ValueError("all-gather buffers do not match")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src, group=pg)
    return out


# Under autograd each collective carries its dual.  The gradient that
# reaches it is the complete gradient of this rank's output block: the
# result's ``DTensor.from_local`` redistributes an incoming gradient to
# the forward placements (Shard or Replicate, never Partial).  So a
# psum's inputs each get that gradient whole (identity), a
# reduce-scatter's input gets every rank's block gradient (all-gather),
# and an all-gather's input its own block of the replicated gradient.
class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        return _all_reduce_(x.clone(), pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, n, pg):
        ctx.n, ctx.pg = n, pg
        return _reduce_scatter_(src, n, pg)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_(g, ctx.n, ctx.pg), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, n, pg):
        ctx.n, ctx.rank = n, dist.get_group_rank(pg, dist.get_rank())
        return _all_gather_(src, n, pg)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, 0)[ctx.rank], None, None


def _differentiable(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _all_reduce(x, mesh: DeviceMesh, group: AxisGroup, op=dist.ReduceOp.SUM):
    """``x`` reduced by ``op`` over ``group``'s ranks; only a sum carries a
    gradient."""
    if _nshards(mesh, group) == 1:
        return x
    group = tuple(sorted(group, key=tuple(mesh.mesh_dim_names).index))  # a sum has no order
    pg = _process_group(mesh, group)
    if _differentiable(x):
        if op != dist.ReduceOp.SUM:
            raise ValueError(f"an all-reduce by {op} carries no gradient: detach its input")
        return _AllReduce.apply(x, pg)
    return _all_reduce_(x, pg, op)


def _reduce_scatter(x, pos: int, mesh: DeviceMesh, group: AxisGroup):
    """Sum over ``group`` and keep this rank's block of dim ``pos``."""
    n = _nshards(mesh, group)
    if n == 1:
        return x
    src, pg = x.movedim(pos, 0), _process_group(mesh, group)
    if _differentiable(x):
        out = _ReduceScatter.apply(src, n, pg)
    else:
        out = _reduce_scatter_(src, n, pg)
    return out.movedim(0, pos)


def _all_gather(x, pos: int, mesh: DeviceMesh, group: AxisGroup):
    """Concatenate ``group``'s blocks along dim ``pos``."""
    n = _nshards(mesh, group)
    if n == 1:
        return x
    src, pg = x.movedim(pos, 0), _process_group(mesh, group)
    if _differentiable(x):
        out = _AllGather.apply(src, n, pg)
    else:
        out = _all_gather_(src, n, pg)
    return out.movedim(0, pos)


def _slice_local(x, axis: int, mesh: DeviceMesh, group: AxisGroup):
    """This rank's block of ``x`` along ``axis`` over ``group`` (a view)."""
    return local_block(x, P(*([None] * axis), _entry(group)), mesh)


def as_dtensor(x, spec: P | None, mesh: DeviceMesh):
    """``x`` on ``mesh`` with ``spec``'s placements: a DTensor is
    redistributed if its placements differ, a plain tensor (the global
    value on every rank) gives each rank its block as a view."""
    from torch.distributed.tensor import DTensor

    want = placements(spec, mesh)
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            raise ValueError("a DTensor operand lies on another mesh")
        return x if tuple(x.placements) == want else x.redistribute(mesh, want)
    return DTensor.from_local(local_block(x, spec, mesh), mesh, want, run_check=False,
                              shape=x.shape, stride=x.stride())


def _local_operand(x, spec: P, mesh: DeviceMesh, used: set):
    """This rank's block of an operand with placements ``spec`` (a view of
    a plain tensor; no DTensor is built for one).

    A DTensor hands its gradient back with this rank's local gradient
    declared ``Partial`` on every mesh axis the plan uses (``used``) that
    does not shard the operand: along such an axis the local product sees
    one block of another tensor (or a slice of this one), so each rank's
    gradient is one term of the sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if isinstance(x, DTensor):
        x = as_dtensor(x, spec, mesh)
        grads = tuple(
            Partial() if p == Replicate() and name in used else p
            for name, p in zip(mesh.mesh_dim_names, x.placements))
        return x.to_local(grad_placements=grads)
    return local_block(x, spec, mesh)


def _used_axes(plan: ShardedPlan) -> set:
    """The mesh axes that split any mode of the plan, or the result."""
    entries = list(plan.mode_axes.values()) + list(plan.out_spec)
    return {a for e in entries for a in _as_group(e)}


def sharded_contract(
    spec: str | ContractionSpec,
    A,
    B,
    *,
    mesh: DeviceMesh,
    in_specs,
    out_spec: P | None = None,
    strategy: str = "auto",
    backend: str = "torch",
    tiles: dict | None = None,
    out_dtype=None,
    return_plan: bool = False,
):
    """Evaluate ``C = A · B`` across ``mesh``, kernels local per shard.

    ``A`` and ``B`` are DTensors on ``mesh`` or plain tensors holding the
    global value on every rank (see the module docstring).  Every rank
    executes :func:`repro_torch.core.contract.contract` on its local
    blocks with the given ``strategy``/``backend``/``tiles`` (on a CUDA
    tensor, ``backend="kernel"`` launches ``native_gemm`` once per block
    product), then the collectives from :func:`plan_sharded` stitch the
    result: a DTensor with ``plan.out_spec``'s placements.

    With ``return_plan=True`` returns ``(C, plan)`` — the n-ary front-end
    uses the plan's ``out_axes`` to thread intermediate shardings.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.core.contract import contract, infer_dims  # deferred: no cycle

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh, got {type(mesh).__name__}")
    cs = parse_spec(spec) if isinstance(spec, str) else spec
    if strategy == "tuned":
        raise ValueError(
            "strategy='tuned' is single-device (the cache holds per-device "
            "measurements); pick an analytic strategy for sharded execution"
        )
    for x in (A, B):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"operands must be tensors, got {type(x).__name__}")
        if x.device.type != mesh.device_type:
            raise ValueError(f"operand on {x.device.type} but the mesh is on "
                             f"{mesh.device_type}: nothing is moved to match")
    dims = infer_dims(cs, A, B)
    plan = plan_sharded(cs, dims, mesh=mesh, in_specs=in_specs, out_spec=out_spec)
    if out_spec is not None and not specs_equal(plan.out_spec, out_spec):
        # specs_equal, not ==: the planned spec and the caller's spelling
        # of the same sharding may differ in trailing Nones
        raise AssertionError(
            f"planned out_spec {plan.out_spec} does not honor requested "
            f"{out_spec}"
        )

    used = _used_axes(plan)
    a = _local_operand(A, plan.a_spec, mesh, used)
    b = _local_operand(B, plan.b_spec, mesh, used)
    for axis, group, _ in plan.slice_a:
        a = _slice_local(a, axis, mesh, group)
    for axis, group, _ in plan.slice_b:
        b = _slice_local(b, axis, mesh, group)
    out = contract(plan.spec, a, b, strategy=strategy, backend=backend, tiles=tiles,
                   out_dtype=out_dtype)
    for pos, group in plan.scatters:
        out = _reduce_scatter(out, pos, mesh, group)
    if plan.psum_axes:
        out = _all_reduce(out, mesh, plan.psum_axes)
    for pos, group in plan.gathers:
        out = _all_gather(out, pos, mesh, group)
    for pos, group in plan.slice_out:
        out = _slice_local(out, pos, mesh, group)

    shape = torch.Size(dims[m] for m in cs.c_modes)
    if not _dense(out):
        out = out.contiguous()  # a narrowed block: its strides are not its own
    # the global layout follows the block's (a permuted block stays
    # permuted), so a reshape of the result copies where the block needs it
    out = DTensor.from_local(out, mesh, placements(plan.out_spec, mesh), run_check=False)
    if out.shape != shape:
        raise RuntimeError(f"sharded result has shape {tuple(out.shape)}, the plan "
                           f"{tuple(shape)}")
    return (out, plan) if return_plan else out


def _dense(x) -> bool:
    """Whether ``x`` covers its storage span with no gap: its strides are
    those of a contiguous tensor with its dims permuted."""
    expect = 1
    for size, stride in sorted(zip(x.shape, x.stride()), key=lambda t: t[1]):
        if size == 1:
            continue
        if stride != expect:
            return False
        expect *= size
    return True
