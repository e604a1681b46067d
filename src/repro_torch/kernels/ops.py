"""Kernel-backend execution of planner output, and the native entry point.

``execute_plan(plan, A, B)`` is the ``"kernel"`` backend of
:func:`repro_torch.core.contract.contract`: it assigns mode→role for the
kernel (:func:`plan_roles`), fuses the plan's flattened mode groups as
views, and launches :func:`~repro_torch.kernels.sb_gemm.native_gemm`
once.  Nested batch modes (paper Listing 2's outer loops, lifted with
``jax.vmap`` in the JAX package) are just more C modes of that one launch:
the kernel decodes them from its block index.  Exceptional plans name a
walk of ``EXT_BATCH_TILE`` batch indices per block (the extended
transpose, see ``ext_gemm.py``), which the card's kernel takes from the
layout.

``execute_native(spec, A, B)`` is the layout-oblivious entry (the
``"native"`` strategy): no plan, no roles, no layout precondition.  Plans
with no role assignment (degenerate layouts, unfused multi-mode
contractions) and plans whose flattening is not a view of the given
operands route there, so the kernel backend never permutes or copies an
operand.

``grouped_matmul(As, Bs)`` is the variable-batch entry: ragged per-group
GEMMs in one launch of :func:`~repro_torch.kernels.grouped_gemm.grouped_gemm`.
"""

from __future__ import annotations

import torch

from repro_torch.core.notation import CaseKind, ContractionSpec, parse_spec
from repro_torch.core.planner import Plan
from repro_torch.kernels.addressing import DEFAULT_TILES
from repro_torch.kernels.grouped_gemm import (
    GROUPED_DEFAULT_TILES, grouped_gemm, pack_groups, packed_geometry)
from repro_torch.kernels.sb_gemm import native_gemm
from repro_torch.obs import trace as _trace

__all__ = [
    "execute_plan", "execute_native", "sb_contract", "plan_roles",
    "grouped_matmul", "EXT_BATCH_TILE",
]

#: brick depth for the extended-transpose configuration (paper §III-E):
#: how many indices of the stride-1-batched mode one block walks.
EXT_BATCH_TILE = 8


def plan_roles(plan: Plan) -> dict | None:
    """Mode→role (u/v/k/b) assignment for the kernel core of ``plan``.

    Returns ``None`` when the plan has no role-based sb_gemm lowering —
    degenerate layouts and multi-mode contractions whose k-modes could not
    be fused into one view; :func:`execute_plan` routes those through the
    layout-oblivious :func:`execute_native` instead.
    """
    fs = plan.fspec
    kgroup = fs.contracted
    if "degenerate" in plan.notes or len(kgroup) != 1:
        return None
    roles = {kgroup: "k"}
    if plan.gemm_modes is not None:
        u, v, _ = plan.gemm_modes
        if u:
            roles[u] = "u"
        roles[v] = "v"
    else:  # pure GEMM: assign from the (≤2-mode) output
        cm = fs.c_modes
        roles[cm[-1]] = "v"
        if len(cm) == 2:
            roles[cm[0]] = "u"
    if plan.sb_batch:
        roles[plan.sb_batch] = "b"
    return roles


def sb_contract(spec_a: str, spec_b: str, spec_c: str, A, B, *, roles: dict,
                tiles: dict | None = None, out_dtype=None):
    """One kernel launch for a core contraction under a role table.

    The JAX package's interface: the ``u`` role names the tile's row mode
    and the ``b`` role's mode is walked ``tiles["b"]`` indices per block.
    Both are checked as they are there (``u`` a C mode other than the
    minor-most and the walked one, ``b`` a C mode other than the
    minor-most, the walk a positive int), but on the card the kernel's
    route, tile and launch come from the operands' layout alone
    (:func:`~repro_torch.kernels.sb_gemm.native_plan`), so neither is
    passed on.  No padding: the kernel masks ragged edges.
    """
    tiles = {**DEFAULT_TILES, **(tiles or {})}
    by_role = {r: m for m, r in roles.items()}
    u, walk_mode, others = by_role.get("u"), by_role.get("b"), spec_c[:-1]
    if u is not None and (u not in others or u == walk_mode):
        raise ValueError(f"u={u!r} must be a C mode other than the minor-most "
                         f"and the walked one")
    if walk_mode is not None and walk_mode not in others:
        raise ValueError(f"walk_mode={walk_mode!r} is not a batch mode of C")
    walk = tiles["b"]
    if not isinstance(walk, int) or isinstance(walk, bool) or walk < 1:
        raise ValueError(f"tile b={walk!r} must be a positive int")
    return native_gemm(A, B, a_modes=spec_a, b_modes=spec_b, c_modes=spec_c,
                       out_dtype=out_dtype)


class _NativeContraction(torch.autograd.Function):
    """The native kernel with the einsum-transpose backward: the spec's
    validity rules (free modes must reach the output) make ``(c,b)->a``
    and ``(c,a)->b`` legal specs, so both cotangents run the kernel too."""

    @staticmethod
    def forward(ctx, cs, out_dtype, A, B):
        ctx.cs = cs
        ctx.save_for_backward(A, B)
        return _execute_native_impl(cs, A, B, out_dtype)

    @staticmethod
    def backward(ctx, g):
        A, B = ctx.saved_tensors
        cs = ctx.cs
        dA = dB = None
        if ctx.needs_input_grad[2]:
            dA = execute_native(ContractionSpec(cs.c_modes, cs.b_modes, cs.a_modes),
                                g, B, out_dtype=A.dtype)
        if ctx.needs_input_grad[3]:
            dB = execute_native(ContractionSpec(cs.c_modes, cs.a_modes, cs.b_modes),
                                g, A, out_dtype=B.dtype)
        return None, None, dA, dB


def execute_native(spec: str | ContractionSpec, A, B, *, out_dtype=None):
    """Layout-oblivious single-kernel contraction (the ``"native"`` strategy).

    Launches :func:`~repro_torch.kernels.sb_gemm.native_gemm` on the
    operands exactly as given — any mode ordering, any strides, no
    permute, no copy.  Scalar edges (an empty output or a rank-0 operand)
    have no tile; they take the direct library contraction, as in the JAX
    package.  Differentiable through :class:`_NativeContraction`.
    """
    cs = parse_spec(spec) if isinstance(spec, str) else spec
    out_dtype = out_dtype or torch.promote_types(A.dtype, B.dtype)
    if not _trace.enabled():
        return _NativeContraction.apply(cs, out_dtype, A, B)
    with _trace.span("execute_native", "kernels") as sp:
        sp.set(spec=cs.spec_str())
        return _NativeContraction.apply(cs, out_dtype, A, B)


def _execute_native_impl(cs: ContractionSpec, A, B, out_dtype):
    if not cs.c_modes or not cs.a_modes or not cs.b_modes:
        from repro_torch.core.contract import _direct  # deferred: contract imports us

        return _direct(cs, A, B).to(out_dtype)
    return native_gemm(A, B, a_modes=cs.a_modes, b_modes=cs.b_modes,
                       c_modes=cs.c_modes, out_dtype=out_dtype)


def grouped_matmul(As, Bs, *, tiles: dict | None = None, out_dtype=None,
                   trans_a=False, trans_b=False):
    """Variable-batch GEMM: one kernel launch over ragged groups.

    ``As[g] (m_g, k_g) @ Bs[g] (k_g, n_g)`` for every group in a single
    :func:`~repro_torch.kernels.grouped_gemm.grouped_gemm` call — each
    group padded only to its tile multiples, never to the largest group
    (the serving runtime's ragged decode/prefill batches and a mixture of
    experts' routed tokens are exactly this shape class).  Returns the
    list of ``(m_g, n_g)`` results, views of one packed output.

    ``trans_a``/``trans_b`` (scalar or per-group sequence) flag operands
    stored in transposed layout — ``As[g] (k_g, m_g)`` / ``Bs[g]
    (n_g, k_g)`` — which the kernel consumes in place via its descriptor
    table.  Zero-size groups (``m``/``n``/``k`` of 0) are legal: ``k == 0``
    yields exact zeros.

    ``tiles`` overrides ``u``/``v``/``k`` of
    :data:`~repro_torch.kernels.grouped_gemm.GROUPED_DEFAULT_TILES`, the
    packing tiles: each must be a positive multiple of 8.  bf16 groups
    run on the tensor cores (route ``"wgmma"``) when every padded depth
    is a multiple of 64, as under the default ``k = 128``; see
    :func:`~repro_torch.kernels.grouped_gemm.grouped_route`.
    """
    if not _trace.enabled():
        return _grouped_matmul_impl(As, Bs, tiles=tiles, out_dtype=out_dtype,
                                    trans_a=trans_a, trans_b=trans_b)
    with _trace.span("grouped_matmul", "kernels") as sp:
        sp.set(n_groups=len(As), tiles=tiles)
        return _grouped_matmul_impl(As, Bs, tiles=tiles, out_dtype=out_dtype,
                                    trans_a=trans_a, trans_b=trans_b)


def _grouped_matmul_impl(As, Bs, *, tiles, out_dtype, trans_a, trans_b):
    eff = {**GROUPED_DEFAULT_TILES, **(tiles or {})}
    bad = set(eff) - {"u", "v", "k"}
    if bad:
        raise ValueError(
            f"unknown grouped tile roles {sorted(bad)}; valid: ('u','v','k')")
    for role, t in eff.items():
        if not isinstance(t, int) or isinstance(t, bool) or t < 1 or t % 8:
            raise ValueError(
                f"grouped tile {role}={t!r} must be a positive multiple of 8 "
                f"(each group's block then starts on a 16-byte boundary, for "
                f"the kernel's 16-byte loads of float32/bfloat16 rows)")
    A_flat, B_flat, descs, problems = pack_groups(
        As, Bs, eff, trans_a=trans_a, trans_b=trans_b)
    _, out_rows, out_cols = packed_geometry(problems, eff)
    out = grouped_gemm(A_flat, B_flat, descs, out_cols=out_cols, out_rows=out_rows,
                       out_dtype=out_dtype)
    # group g's rows, then its padding rows, in one split; columns past
    # n_g are cut only where the group is narrower than the buffer
    mp = descs[:, 0].tolist()
    sizes = [s for p, m in zip(problems, mp) for s in (p.m, m - p.m)]
    blocks = out.split([*sizes, out_rows - sum(mp)])
    return [b if p.n == out_cols else b[:, :p.n] for b, p in zip(blocks[::2], problems)]


def _fused_view(x, modes: str, groups, fdims: dict):
    """``x`` with the plan's flattened mode ``groups`` fused, as a view —
    or ``None`` when its strides cannot express that without a copy."""
    shape, stride, pos = [], [], 0
    while pos < len(modes):
        g = next((g for g in groups if modes.startswith(g, pos)), modes[pos])
        live = [(d, s) for d, s in zip(x.shape[pos:pos + len(g)],
                                       x.stride()[pos:pos + len(g)]) if d != 1]
        if any(s0 != s1 * d1 for (_, s0), (d1, s1) in zip(live, live[1:])):
            return None
        shape.append(fdims[g[0]])
        stride.append(live[-1][1] if live else 0)
        pos += len(g)
    return x.as_strided(shape, stride)


def execute_plan(plan: Plan, A, B, *, out_dtype=None, tiles: dict | None = None):
    """Kernel-backend execution of a planner :class:`Plan`.  ``tiles``
    may set ``b``, the brick depth a block walks along the plan's batch
    mode (default :data:`EXT_BATCH_TILE` for exceptional plans, else 1)."""
    if not _trace.enabled():
        return _execute_plan_impl(plan, A, B, out_dtype=out_dtype, tiles=tiles)
    with _trace.span("execute_plan", "kernels") as sp:
        sp.set(spec=plan.spec.spec_str(), kind=plan.kind,
               nested=plan.nested or None,
               has_roles=plan_roles(plan) is not None)
        return _execute_plan_impl(plan, A, B, out_dtype=out_dtype, tiles=tiles)


def _execute_plan_impl(plan: Plan, A, B, *, out_dtype, tiles):
    fs, fd = plan.fspec, plan.fdims
    out_dtype = out_dtype or torch.promote_types(A.dtype, B.dtype)
    roles = plan_roles(plan)
    a = b = None
    if roles is not None:
        a = _fused_view(A, plan.spec.a_modes, plan.flatten_groups, fd)
        b = _fused_view(B, plan.spec.b_modes, plan.flatten_groups, fd)
    if a is None or b is None:
        # no role-based core (degenerate layout, unfused multi-mode k), or
        # a flattening the operands' strides cannot express as a view: the
        # native kernel needs neither — every mode keeps its own stride
        return execute_native(plan.spec, A, B, out_dtype=out_dtype)
    if torch.is_grad_enabled() and (A.requires_grad or B.requires_grad):
        # the role-based core is forward-only, as in the JAX package: on the
        # card its launch fills a fresh tensor that carries no gradient
        raise NotImplementedError(
            f"no gradient through the kernel backend's role-based core "
            f"({plan.spec.spec_str()}, a {plan.kind} plan); differentiate "
            f"the kernel path with strategy='native'")
    walk = (tiles or {}).get("b", EXT_BATCH_TILE if plan.kind == CaseKind.EXCEPTIONAL
                             else 1)
    out = sb_contract(fs.a_modes, fs.b_modes, fs.c_modes, a, b, roles=roles,
                      tiles={"b": walk}, out_dtype=out_dtype)
    return out.view(tuple(plan.dims[m] for m in plan.spec.c_modes))
