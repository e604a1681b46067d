"""N-ary einsum front-end with contraction-path planning.

:func:`xeinsum` generalises :func:`repro_torch.core.contract.contract` from one
pairwise contraction to an arbitrary multi-tensor expression::

    xeinsum("mnk,kr,ms->nrs", T, W, U)

The paper's STRIDEDBATCHEDGEMM primitive evaluates *one* pairwise
contraction without copies; its headline applications compose *many*
(Tucker reconstruction is four operands, MTTKRP is three).  Which pairwise
order the composition uses dominates multi-contraction wall-time — Peise
et al. 2014 ("On the Performance Prediction of BLAS-based Tensor
Contractions") and Di Napoli et al. 2014 ("Towards an Efficient Use of the
BLAS Library for Multilinear Tensor Contractions") both measure order-of-
magnitude gaps between orderings of the same expression.  The front-end
therefore does three things:

1. **parse** the n-ary spec into per-operand mode strings (the mode
   algebra of :mod:`repro_torch.core.notation`, extended to N operands);
2. **plan** a *contraction path* — a binary tree of pairwise
   contractions — with one of three optimizers:

   * ``"naive"``   — left-to-right fold, the order a caller hand-writing
     pairwise :func:`contract` calls would use (the ``fig10`` baseline);
   * ``"greedy"``  — repeatedly contract the pair with the smallest
     intermediate (ties: fewest flops); O(n³), any operand count;
   * ``"optimal"`` — exact dynamic program over operand subsets
     minimising total flops; exponential, capped at
     ``OPTIMAL_MAX_OPERANDS`` operands;
   * ``"auto"``    — ``"optimal"`` for ≤ ``AUTO_OPTIMAL_LIMIT`` operands
     (every expression in this repo), else ``"greedy"``;
   * ``"tuned"``   — the analytic candidates re-ranked with *measured*
     step costs from the autotuner cache (:mod:`repro_torch.tuning`),
     falling back to an analytic price for steps without entries;

3. **lower** each pairwise step through the existing
   :func:`repro_torch.core.planner.make_plan` /
   :func:`~repro_torch.core.contract.contract` machinery, so every step
   receives the paper's treatment — flattening, strided-batched GEMM, or
   the extended-transpose kernel — on the library or kernel backend.

Intermediate mode order is chosen *batch-modes-first* (shared kept modes
in left-operand order, then the left operand's kept free modes, then the
right's).  That is the natural batched-GEMM output order —
intermediates are produced transpose-free — and it keeps every
intermediate sb_gemm-legal: a batch mode is never the minor-most axis
(the row-major no-last-mode rule of :mod:`repro_torch.core.notation`).

Path choice is integer arithmetic and matches the JAX package's exactly.
Differences from ``torch.einsum``: no ellipsis broadcasting and no traces
(repeated modes within one operand); modes that appear in a single
operand and not in the output are summed out before planning.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
from typing import Literal

import torch

from repro_torch.core.contract import Backend, Strategy, contract, infer_dims
from repro_torch.core.notation import _VALID_MODES, CaseKind, ContractionSpec
from repro_torch.core.planner import (
    COMM_FLOPS_PER_BYTE,
    contraction_flops,
    make_plan,
    modes_size,
    sharded_step_cost,
)

__all__ = [
    "OPTIMAL_MAX_OPERANDS",
    "AUTO_OPTIMAL_LIMIT",
    "PathStep",
    "ContractionPath",
    "parse_nary",
    "contraction_path",
    "xeinsum",
]

#: default cap for ``optimize="optimal"`` — the subset DP enumerates 3^n
#: partitions (3^10 ≈ 59k, still instant; beyond that use "greedy" or
#: "auto").  Override per-process with the ``REPRO_OPTIMAL_MAX_OPERANDS``
#: environment variable (benchmarking larger networks).
OPTIMAL_MAX_OPERANDS = 10

#: ``optimize="auto"`` runs the exact DP up to this many operands.
AUTO_OPTIMAL_LIMIT = 5

Optimize = Literal["auto", "greedy", "optimal", "naive"]


def _optimal_cap() -> int:
    """Effective operand cap for the exact DP (env-overridable per call)."""
    return int(os.environ.get("REPRO_OPTIMAL_MAX_OPERANDS", OPTIMAL_MAX_OPERANDS))


# --------------------------------------------------------------------------
# Parsing
# --------------------------------------------------------------------------

def parse_nary(spec: str) -> tuple[tuple[str, ...], str]:
    """Parse an n-ary einsum spec into ``(input_mode_strings, output_modes)``.

    The output may be implicit (``"ab,bc"``), in which case it follows the
    einsum convention: every mode appearing exactly once, alphabetically.
    Repeated modes within one operand (traces) and ellipses are rejected.
    """
    s = spec.replace(" ", "")
    if "." in s:
        raise NotImplementedError("ellipsis broadcasting is not supported")
    if "->" in s:
        lhs, out = s.split("->")
        if "->" in out:
            raise ValueError(f"multiple '->' in spec {spec!r}")
    else:
        lhs, out = s, None
    inputs = tuple(lhs.split(","))
    counts = collections.Counter()
    for t in inputs:
        if len(set(t)) != len(t):
            raise ValueError(f"repeated mode in operand {t!r} (traces unsupported)")
        bad = set(t) - _VALID_MODES
        if bad:
            raise ValueError(f"invalid mode chars in {t!r}: {sorted(bad)}")
        counts.update(t)
    if out is None:
        out = "".join(sorted(m for m in counts if counts[m] == 1))
    else:
        if len(set(out)) != len(out):
            raise ValueError(f"repeated mode in output {out!r}")
        missing = set(out) - set(counts)
        if missing:
            raise ValueError(f"output modes {sorted(missing)} not found in any input")
    return inputs, out


def _infer_dims(inputs: tuple[str, ...], shapes) -> dict:
    dims: dict = {}
    for modes, shape in zip(inputs, shapes):
        if len(shape) != len(modes):
            raise ValueError(f"rank mismatch: shape {tuple(shape)} vs modes {modes!r}")
        for m, d in zip(modes, shape):
            if dims.setdefault(m, d) != d:
                raise ValueError(f"inconsistent size for mode {m!r}: {dims[m]} vs {d}")
    return dims


def _sum_only_axes(inputs: tuple[str, ...], output: str) -> list[tuple[int, ...]]:
    """Per-operand axes carrying modes that appear once overall and not in
    the output — these are plain sums, reduced before any path planning."""
    counts = collections.Counter(m for t in inputs for m in t)
    return [
        tuple(i for i, m in enumerate(t) if counts[m] == 1 and m not in output)
        for t in inputs
    ]


# --------------------------------------------------------------------------
# Path representation
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PathStep:
    """One pairwise contraction, in SSA form: ids ``0..n-1`` are the input
    operands (after sum-only reduction); each step's result gets the next id."""

    lhs: int
    rhs: int
    out: int
    spec: ContractionSpec          # pairwise spec lowered through make_plan
    flops: int                     # optimizer objective: cost-model flops
                                   # (plus the flop-equivalent communication
                                   # term when planned against a mesh)
    size: int                      # element count of this step's result
    kind: str = ""                 # planner classification (CaseKind.*)
    comm_bytes: int = 0            # estimated collective bytes/device (mesh)


@dataclasses.dataclass(frozen=True)
class ContractionPath:
    """A planned evaluation order for an n-ary contraction."""

    spec: str                      # the spec as requested
    inputs: tuple[str, ...]        # operand modes after sum-only reduction
    output: str
    dims: dict
    steps: tuple[PathStep, ...]
    optimize: str                  # which optimizer produced it

    @property
    def total_flops(self) -> int:
        return sum(s.flops for s in self.steps)

    @property
    def total_comm_bytes(self) -> int:
        """Estimated collective bytes/device (0 for single-device paths)."""
        return sum(s.comm_bytes for s in self.steps)

    @property
    def largest_intermediate(self) -> int:
        """Elements of the biggest non-final intermediate (0 if none)."""
        inner = [s.size for s in self.steps[:-1]]
        return max(inner, default=0)

    def describe(self) -> str:
        lines = [
            f"{self.spec} [{self.optimize}] "
            f"flops={self.total_flops} largest_intermediate={self.largest_intermediate}"
        ]
        for n, s in enumerate(self.steps, 1):
            lines.append(
                f"  step {n}: #{s.lhs}·#{s.rhs} -> #{s.out}  "
                f"{s.spec.spec_str()}  [{s.kind}] flops={s.flops} size={s.size}"
            )
        return "\n".join(lines)


def _pair_modes(ma: str, mb: str, keep: set) -> str:
    """Result mode order for contracting two operands: shared kept modes
    (batch) first in A's order, then A's kept free modes, then B's — the
    natural batched-GEMM output, transpose-free and sb_gemm-legal."""
    b_set = set(mb)
    a_set = set(ma)
    batch = "".join(m for m in ma if m in b_set and m in keep)
    a_free = "".join(m for m in ma if m not in b_set and m in keep)
    b_free = "".join(m for m in mb if m not in a_set and m in keep)
    return batch + a_free + b_free


#: layout-quality tie-break, the paper's evaluation hierarchy (heuristic 1:
#: a flattened GEMM beats everything; §III-E: exceptional cases cost extra
#: data staging).  Used to order equal-flop paths — common in symmetric
#: TTM chains, where every pairwise order has the same flop count but only
#: some keep each step sb_gemm-friendly.
_KIND_PENALTY = {
    CaseKind.FLAT_GEMM: 0,
    CaseKind.SB_GEMM: 1,
    CaseKind.NESTED: 2,
    CaseKind.EXCEPTIONAL: 4,
}


def _classify(cs: ContractionSpec, dims: dict) -> tuple[str, int]:
    """(planner kind, layout penalty) for one pairwise step."""
    if not cs.c_modes or not cs.a_modes or not cs.b_modes:
        return "direct", 0  # scalar in/out: a dot/outer, no matrix layout
    plan = make_plan(cs, dims)
    penalty = _KIND_PENALTY[plan.kind]
    if "degenerate" in plan.notes:
        penalty += 2
    return plan.kind, penalty


def _step_cost(cs: ContractionSpec, dims: dict, shard) -> tuple[int, int]:
    """(optimizer objective, comm bytes) for one pairwise step.

    ``shard`` is ``None`` (single-device — the objective is exactly
    :func:`contraction_flops`) or ``(mode_axes, axis_sizes)`` from a mesh:
    then flops are per-shard and collective bytes fold in at
    :data:`~repro_torch.core.planner.COMM_FLOPS_PER_BYTE` flop-equivalents,
    so path optimization ranks sharded paths by modeled wall-clock, not by
    single-device flops (a path that keeps contracted modes unsharded can
    beat a nominally cheaper one that all-reduces every step).
    """
    if shard is None:
        return contraction_flops(cs, dims), 0
    mode_axes, axis_sizes = shard
    flops_local, comm = sharded_step_cost(cs, dims, mode_axes, axis_sizes)
    return flops_local + int(COMM_FLOPS_PER_BYTE * comm), comm


def _make_step(ids, modes, ia, ib, res, dims, next_id, shard=None) -> PathStep:
    cs = ContractionSpec(modes[ia], modes[ib], res)
    kind, _ = _classify(cs, dims)
    cost, comm = _step_cost(cs, dims, shard)
    return PathStep(
        lhs=ids[ia], rhs=ids[ib], out=next_id, spec=cs,
        flops=cost, size=modes_size(res, dims),
        kind=kind, comm_bytes=comm,
    )


# --------------------------------------------------------------------------
# Optimizers
# --------------------------------------------------------------------------

def _keep_for(modes: list[str], output: str, skip: tuple[int, int]) -> set:
    keep = set(output)
    for n, t in enumerate(modes):
        if n not in skip:
            keep |= set(t)
    return keep


def _naive_path(inputs, output, dims, shard=None) -> tuple[PathStep, ...]:
    """Left-to-right fold — the hand-written pairwise baseline."""
    ids = list(range(len(inputs)))
    modes = list(inputs)
    next_id = len(inputs)
    steps = []
    while len(modes) > 1:
        keep = _keep_for(modes, output, (0, 1))
        res = output if len(modes) == 2 else _pair_modes(modes[0], modes[1], keep)
        steps.append(_make_step(ids, modes, 0, 1, res, dims, next_id, shard))
        ids[:2], modes[:2] = [next_id], [res]
        next_id += 1
    return tuple(steps)


def _greedy_path(inputs, output, dims, shard=None) -> tuple[PathStep, ...]:
    """Smallest-intermediate-first (ties: fewest flops, then operand order).

    Pairs sharing at least one mode are preferred over outer products."""
    ids = list(range(len(inputs)))
    modes = list(inputs)
    next_id = len(inputs)
    steps = []
    while len(modes) > 1:
        best = None
        for i in range(len(modes)):
            for j in range(i + 1, len(modes)):
                keep = _keep_for(modes, output, (i, j))
                res = output if len(modes) == 2 else _pair_modes(modes[i], modes[j], keep)
                cs = ContractionSpec(modes[i], modes[j], res)
                key = (
                    not (set(modes[i]) & set(modes[j])),
                    modes_size(res, dims),
                    _step_cost(cs, dims, shard)[0],
                    _classify(cs, dims)[1],
                    i, j,
                )
                if best is None or key < best[0]:
                    best = (key, i, j, res)
        _, i, j, res = best
        steps.append(_make_step(ids, modes, i, j, res, dims, next_id, shard))
        for idx in (j, i):  # j first: preserve i's position
            del ids[idx], modes[idx]
        ids.append(next_id)
        modes.append(res)
        next_id += 1
    return tuple(steps)


def _optimal_path(inputs, output, dims, shard=None) -> tuple[PathStep, ...]:
    """Exact subset dynamic program (Held–Karp over operand bitmasks).

    ``best[mask]`` holds the cheapest way to contract the operand subset
    ``mask`` down to one tensor.  A subset's result modes are path-
    independent — a mode survives iff it appears outside the subset or in
    the output — so the DP is well-formed.  Minimises total flops (plus
    the communication term under a mesh, which is also subset-local: the
    global mode→axis map makes every step's sharding path-independent),
    with the summed layout penalty (flatten ≺ sb_gemm ≺ nested ≺
    exceptional) and the largest intermediate as tie-breaks.
    """
    n = len(inputs)
    cap = _optimal_cap()
    if n > cap:
        raise ValueError(
            f"optimize='optimal' supports ≤ {cap} operands (got {n}); use "
            f"optimize='greedy' or optimize='auto', or raise the cap via the "
            f"REPRO_OPTIMAL_MAX_OPERANDS environment variable"
        )
    full = (1 << n) - 1
    # (total_flops, layout_penalty, peak_intermediate, result_modes,
    #  (left_mask, right_mask))
    best: dict[int, tuple[int, int, int, str, tuple | None]] = {
        1 << i: (0, 0, 0, inputs[i], None) for i in range(n)
    }
    outside_keep = {}
    for mask in range(1, full + 1):
        keep = set(output)
        for i in range(n):
            if not mask & (1 << i):
                keep |= set(inputs[i])
        outside_keep[mask] = keep

    for mask in sorted(range(1, full + 1), key=lambda m: m.bit_count()):
        if mask.bit_count() < 2:
            continue
        lo = mask & -mask  # canonical: the left part contains the lowest bit
        sub = (mask - 1) & mask
        choice = None
        while sub:
            if sub & lo and sub != mask:
                rest = mask ^ sub
                if sub in best and rest in best:
                    fl_l, pn_l, pk_l, ml, _ = best[sub]
                    fl_r, pn_r, pk_r, mr, _ = best[rest]
                    res = output if mask == full else _pair_modes(
                        ml, mr, outside_keep[mask]
                    )
                    cs = ContractionSpec(ml, mr, res)
                    tot = fl_l + fl_r + _step_cost(cs, dims, shard)[0]
                    pen = pn_l + pn_r + _classify(cs, dims)[1]
                    peak = max(pk_l, pk_r, modes_size(res, dims))
                    if choice is None or (tot, pen, peak) < choice[:3]:
                        choice = (tot, pen, peak, res, (sub, rest))
            sub = (sub - 1) & mask
        best[mask] = choice

    steps: list[PathStep] = []
    counter = [n]

    def emit(mask: int) -> int:
        if mask.bit_count() == 1:
            return mask.bit_length() - 1
        _, _, _, res, (lmask, rmask) = best[mask]
        la, lb = emit(lmask), emit(rmask)
        cs = ContractionSpec(best[lmask][3], best[rmask][3], res)
        cost, comm = _step_cost(cs, dims, shard)
        step = PathStep(
            lhs=la, rhs=lb, out=counter[0], spec=cs,
            flops=cost, size=modes_size(res, dims),
            kind=_classify(cs, dims)[0], comm_bytes=comm,
        )
        counter[0] += 1
        steps.append(step)
        return step.out

    emit(full)
    return tuple(steps)


def check_optimize(optimize) -> None:
    """Raise for an unknown optimizer name."""
    if optimize not in ("auto", "greedy", "optimal", "naive", "tuned"):
        raise ValueError(f"unknown optimize mode {optimize!r}")


def _candidate_paths(spec, inputs, output, dims) -> list[ContractionPath]:
    """The analytic candidate set tuned re-ranking chooses from: auto's
    path plus the greedy and naive alternatives where they differ."""
    candidates = [_plan_path(spec, inputs, output, dims, "auto")]
    for method in ("greedy", "naive"):
        p = _plan_path(spec, inputs, output, dims, method)
        if all(p.steps != q.steps for q in candidates):
            candidates.append(p)
    return candidates


def _tuned_path(spec, inputs, output, dims, dtype) -> ContractionPath:
    """Re-rank candidate paths with *measured* step costs.

    Takes the analytic optimizers' paths (:func:`_candidate_paths`) and
    prices each with :func:`repro_torch.tuning.dispatch.path_cost` — the
    autotuner cache's measured best µs per step where an entry exists, an
    analytic price otherwise — then picks the cheapest.  The
    compiled-program pipeline exposes the same re-ranking as
    :class:`repro_torch.core.passes.TunedRerankPass`.
    """
    from repro_torch.tuning.dispatch import get_dispatcher, path_cost

    disp = get_dispatcher()
    candidates = _candidate_paths(spec, inputs, output, dims)
    chosen = min(candidates, key=lambda p: path_cost(p.steps, dims, dtype, disp))
    return dataclasses.replace(chosen, optimize="tuned")


def _plan_path(spec, inputs, output, dims, optimize, *, dtype=None, shard=None
               ) -> ContractionPath:
    if len(inputs) < 2:
        return ContractionPath(spec, inputs, output, dims, (), str(optimize))
    check_optimize(optimize)
    if optimize == "tuned":
        if shard is not None:
            raise ValueError(
                "optimize='tuned' re-ranks with single-device measurements; "
                "use 'auto'/'greedy'/'optimal'/'naive' with mesh="
            )
        return _tuned_path(spec, inputs, output, dims, dtype or torch.float32)
    method = optimize
    if optimize == "auto":
        method = "optimal" if len(inputs) <= AUTO_OPTIMAL_LIMIT else "greedy"
    if method == "naive" or len(inputs) == 2:
        steps = _naive_path(inputs, output, dims, shard)
    elif method == "greedy":
        steps = _greedy_path(inputs, output, dims, shard)
    else:
        steps = _optimal_path(inputs, output, dims, shard)
    return ContractionPath(spec, inputs, output, dims, steps, method)


def _shard_ctx(inputs, in_specs, mesh):
    """(global mode→axis map, axis sizes) for comm-aware path costing."""
    from repro_torch.distributed.contract import resolve_mode_axes  # no cycle

    mode_axes = resolve_mode_axes(inputs, in_specs, mesh=mesh)
    axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return mode_axes, axis_sizes


def _drop_reduced_pspecs(in_specs, inputs_before, reduce_axes):
    """Align per-operand PartitionSpecs past the sum-only reduction.

    A sharded sum-only mode would need a post-sum psum; rather than model
    that corner we reject it — shard modes that participate in the
    contraction.
    """
    from repro_torch.distributed.sharding import PartitionSpec as P

    if in_specs is None:
        return None
    if len(in_specs) != len(inputs_before):
        raise ValueError(
            f"spec has {len(inputs_before)} operands, got {len(in_specs)} "
            f"in_specs"
        )
    out = []
    for pspec, modes, axes in zip(in_specs, inputs_before, reduce_axes):
        entries = list(tuple(pspec) if pspec is not None else ())
        entries += [None] * (len(modes) - len(entries))
        for i in axes:
            if entries[i] is not None:
                raise NotImplementedError(
                    f"mode {modes[i]!r} is summed out before planning but "
                    f"sharded over {entries[i]!r}; replicate sum-only modes"
                )
        out.append(P(*[e for i, e in enumerate(entries) if i not in axes]))
    return tuple(out)


def contraction_path(
    spec: str, *operands, optimize: Optimize = "auto", mesh=None, in_specs=None
) -> ContractionPath:
    """Plan (without executing) the pairwise-contraction path for ``spec``.

    ``operands`` may be tensors or bare shape tuples — only shapes are
    used (plus dtypes, when present, for ``optimize="tuned"`` cache
    lookups).  Modes appearing in a single operand and not in the output are
    summed out up front and do not appear in the returned path's steps.

    With ``mesh`` (a ``DeviceMesh``) and per-operand ``in_specs`` the path
    is costed shard-aware: per-step flops divide across the shards and a
    communication term (collective bytes × flop-equivalents) is added
    where a sharded contracted mode forces an all-reduce — so the
    optimizer ranks sharded paths by modeled wall-clock.
    """
    if mesh is None and in_specs is not None:
        raise ValueError("in_specs requires mesh=")
    inputs, output = parse_nary(spec)
    shapes = [tuple(getattr(op, "shape", op)) for op in operands]
    if len(shapes) != len(inputs):
        raise ValueError(f"spec has {len(inputs)} operands, got {len(shapes)}")
    reduce_axes = _sum_only_axes(inputs, output)
    in_specs = _drop_reduced_pspecs(in_specs, inputs, reduce_axes)
    inputs = tuple(
        "".join(m for i, m in enumerate(t) if i not in axes)
        for t, axes in zip(inputs, reduce_axes)
    )
    shapes = [
        tuple(d for i, d in enumerate(s) if i not in axes)
        for s, axes in zip(shapes, reduce_axes)
    ]
    dims = _infer_dims(inputs, shapes)
    dts = [op.dtype for op in operands if isinstance(op, torch.Tensor)]
    dtype = functools.reduce(torch.promote_types, dts) if dts else torch.float32
    shard = _shard_ctx(inputs, in_specs, mesh) if mesh is not None else None
    return _plan_path(spec, inputs, output, dims, optimize, dtype=dtype, shard=shard)


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------

def _pairwise(cs: ContractionSpec, a, b, strategy, backend):
    """Lower one path step through :func:`contract`, softening the strategy
    for steps the pairwise planner cannot express:

    * scalar results / scalar operands → ``"direct"`` (no matrix core);
    * ``"flatten"`` on a step that admits no flattened GEMM → ``"auto"``
      (n-ary semantics: flatten *where possible*, unlike strict pairwise
      :func:`contract` which raises).
    """
    return contract(cs, a, b, strategy=_soften_step(cs, a, b, strategy),
                    backend=backend)


def _soften_step(cs, a, b, strategy):
    """The effective strategy for one path step — shared by the
    single-device and sharded lowerings so they can never diverge."""
    if not cs.c_modes or a.ndim == 0 or b.ndim == 0:
        return "direct"
    if strategy == "flatten":
        if make_plan(cs, infer_dims(cs, a, b)).kind != CaseKind.FLAT_GEMM:
            return "auto"
    return strategy


def _pairwise_sharded(cs: ContractionSpec, a, b, a_pspec, b_pspec, step_out_spec,
                      strategy, backend, mesh):
    """Sharded mirror of :func:`_pairwise` — one path step over the mesh,
    with the placements the shard placement pass planned for it."""
    from repro_torch.distributed.contract import sharded_contract  # no cycle

    return sharded_contract(
        cs, a, b, mesh=mesh, in_specs=(a_pspec, b_pspec),
        out_spec=step_out_spec, strategy=_soften_step(cs, a, b, strategy),
        backend=backend,
    )


def xeinsum(
    spec: str,
    *operands,
    optimize: Optimize | ContractionPath = "auto",
    strategy: Strategy | Literal["kernel"] = "auto",
    backend: Backend = "torch",
    out_dtype=None,
    mesh=None,
    in_specs=None,
    out_spec=None,
):
    """N-ary einsum through the paper's contraction engine.

    Parses ``spec``, plans a contraction path (see module docstring), and
    evaluates each pairwise step via :func:`repro_torch.core.contract.contract`.

    Args:
      spec: einsum string, e.g. ``"mnk,kr,ms->nrs"`` (output may be
        implicit; no ellipses, no traces).
      operands: one tensor per spec operand, all on one device.
      optimize: ``"auto"`` | ``"greedy"`` | ``"optimal"`` | ``"naive"`` |
        ``"tuned"`` (re-rank candidate paths with measured step costs from
        the autotuner cache where entries exist), or a precomputed
        :class:`ContractionPath` from :func:`contraction_path` (must match
        this spec's shapes).
      strategy: per-step evaluation strategy — any
        :func:`~repro_torch.core.contract.contract` strategy (including
        ``"tuned"``: each step dispatches through the autotuner), or
        ``"kernel"`` as shorthand for ``strategy="auto",
        backend="kernel"`` (the hand-written kernel on every step).
      backend: ``"torch"`` or ``"kernel"``.
      out_dtype: result dtype (default: promoted operand dtype).
      mesh: a ``DeviceMesh`` — execute every path step sharded
        (:mod:`repro_torch.distributed.contract`): path optimization gains
        the communication cost term, each pairwise step runs the local
        kernels per shard, and intermediate shardings propagate naturally
        (collectives only where a sharded contracted mode forces a
        reduction).  Operands are DTensors on the mesh or plain tensors
        holding the global value on every rank; the result is a DTensor.
      in_specs: with ``mesh``, one ``PartitionSpec`` (or ``None``) per
        operand, aligned to its spec modes.
      out_spec: with ``mesh``, the requested output sharding (default
        natural).

    Returns:
      The contracted tensor, with modes ordered as the spec's output.

    A thin wrapper over :func:`repro_torch.core.program.compile_program`:
    the spec is compiled into a single-expression program cached by
    canonical signature, so repeated calls at the same shapes skip
    parsing and path planning.
    """
    from repro_torch.core.program import compile_program  # deferred: higher layer

    if not operands:
        raise ValueError("xeinsum needs at least one operand")
    for x in operands:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"xeinsum takes tensors, got {type(x).__name__}")
    out_dtype = out_dtype or functools.reduce(
        torch.promote_types, [x.dtype for x in operands])
    if strategy == "kernel":
        strategy, backend = "auto", "kernel"
    if mesh is None and (in_specs is not None or out_spec is not None):
        raise ValueError("in_specs/out_spec require mesh=")

    inputs, _ = parse_nary(spec)
    if len(operands) != len(inputs):
        raise ValueError(f"spec has {len(inputs)} operands, got {len(operands)}")

    # single-operand expressions have no contract step to carry out_spec:
    # the result is placed on the mesh afterwards
    single_out_spec = None
    if len(operands) == 1 and mesh is not None:
        single_out_spec, out_spec = out_spec, None

    prog = compile_program(
        spec, *operands, optimize=optimize, strategy=strategy,
        backend=backend, out_dtype=out_dtype, mesh=mesh, in_specs=in_specs,
        out_specs=(out_spec,) if out_spec is not None else None,
    )
    result = prog(*operands)
    if len(operands) == 1 and mesh is not None:
        from repro_torch.distributed.contract import as_dtensor  # no cycle

        result = as_dtensor(result, single_out_spec, mesh)
    return result
