"""Public contraction API — executes planner output on library GEMMs or
the hand-written kernel.

``contract(spec, A, B, strategy=..., backend=...)`` is the port's single
entry point for pairwise tensor contractions.  Strategies:

* ``"auto"``      — paper heuristics: flatten when possible, else the
                    strided-batched plan (Algorithm 2).
* ``"flatten"``   — require a flattened single-GEMM evaluation.
* ``"batched"``   — forbid flattening; use the strided-batched plan
                    (what the paper benchmarks as STRIDEDBATCHEDGEMM).
* ``"direct"``    — one library contraction with every shared mode as a
                    batch dim, plus a lazy (view) output permute if needed.
* ``"conventional"`` — the matricization baseline (BTAS / Tensor Toolbox):
                    explicit permutes materialised with ``.contiguous()``
                    into ``C_IJ = A_IK B_KJ`` form, one flat GEMM, and a
                    materialised permute back.
* ``"native"``    — the layout-oblivious kernel
                    (:func:`repro_torch.kernels.ops.execute_native`): any
                    mode ordering, any strides, one launch, no copy.
                    Implies the kernel backend (``backend`` is ignored).
* ``"tuned"``     — empirical dispatch through the autotuner
                    (:mod:`repro_torch.tuning.dispatch`): run the measured
                    winner when the persistent cache has one, measure on
                    miss per the dispatcher's policy, fall back to the
                    analytic ``"auto"`` plan otherwise.

Backends: ``"torch"`` (library GEMMs — ``torch.tensordot``/``matmul``
under ``torch.vmap`` — the port's baseline, in place of the JAX package's
``"xla"``) or ``"kernel"`` (the hand-written StridedBatchedGEMM kernel, in
place of ``"pallas"``).  With ``backend="kernel"`` and a planning
strategy, ``tiles={"b": int}`` sets the brick depth a block walks along
the plan's batch mode (validated by
:func:`repro_torch.tuning.candidates.validate_tiles`; the kernel fixes
its other tiles from the layout).  Every path computes on its operands'
device and never moves them.

With tracing on, each call records a ``contract`` span carrying the
roofline record (:func:`repro_torch.obs.roofline.contraction_record`);
on the card the span also times its body on the device, so its
``roofline_fraction`` divides the bound by device time.
"""

from __future__ import annotations

import contextlib
from typing import Literal, get_args

import torch

from repro_torch.core.notation import CaseKind, ContractionSpec, parse_spec
from repro_torch.core.planner import Plan, make_plan
from repro_torch.obs import trace as _trace

__all__ = [
    "contract",
    "infer_dims",
    "record_contractions",
    "conventional_transpose_count",
    "count_copy_ops",
    "COPY_OPS",
]

Strategy = Literal[
    "auto", "flatten", "batched", "direct", "conventional", "native", "tuned"
]
Backend = Literal["torch", "kernel"]
#: runtime mirror of ``Strategy`` — anything else raises ValueError.
STRATEGIES = get_args(Strategy)
BACKENDS = get_args(Backend)

#: profiler event names :func:`count_copy_ops` counts as data movement.
COPY_OPS = ("aten::copy_", "aten::clone", "aten::contiguous")


# --------------------------------------------------------------------------
# Working-set recording
# --------------------------------------------------------------------------

_ACTIVE_RECORDERS: list[list] = []


@contextlib.contextmanager
def record_contractions():
    """Record every ``contract`` call in this context as
    ``(spec_str, dims, dtype_str)`` tuples — the contraction working set.

    Yields the list the records accumulate into.
    """
    rec: list[tuple] = []
    _ACTIVE_RECORDERS.append(rec)
    try:
        yield rec
    finally:
        # remove by identity: equal (e.g. both-empty) nested recorders must
        # not evict each other
        for i, r in enumerate(_ACTIVE_RECORDERS):
            if r is rec:
                del _ACTIVE_RECORDERS[i]
                break


def dtype_name(dtype) -> str:
    """``torch.float32`` → ``"float32"`` (the JAX package's dtype names)."""
    return str(dtype).removeprefix("torch.")


def infer_dims(spec: ContractionSpec, A, B) -> dict:
    """Map every mode of ``spec`` to its size from the operand shapes.

    Raises ``ValueError`` on rank mismatch between an operand and its mode
    string, or when a mode appears with two different sizes.
    """
    if A.ndim != len(spec.a_modes) or B.ndim != len(spec.b_modes):
        raise ValueError(
            f"rank mismatch: A{tuple(A.shape)} vs '{spec.a_modes}', "
            f"B{tuple(B.shape)} vs '{spec.b_modes}'"
        )
    dims: dict = {}
    for modes, x in ((spec.a_modes, A), (spec.b_modes, B)):
        for m, d in zip(modes, x.shape):
            if dims.setdefault(m, int(d)) != int(d):
                raise ValueError(f"inconsistent size for mode {m!r}: {dims[m]} vs {d}")
    return dims


def contract(
    spec: str | ContractionSpec,
    A,
    B,
    *,
    strategy: Strategy = "auto",
    backend: Backend = "torch",
    force_batch: str | None = None,
    tiles: dict | None = None,
    out_dtype=None,
    mesh=None,
    in_specs=None,
    out_spec=None,
):
    """Evaluate one pairwise contraction ``C = A · B``.

    Args:
      spec: row-major einsum spec, e.g. ``"mk,pkn->pmn"``, or a parsed
        :class:`~repro_torch.core.notation.ContractionSpec`.  Exactly two
        operands; no traces, no ellipses; every free mode must appear in
        the output.
      A, B: tensors on one device, ranks matching the spec.
      strategy: one of the strategies in the module docstring.
        ``"flatten"`` raises ``ValueError`` if the spec admits no
        flattened single-GEMM evaluation; ``"native"`` always runs the
        kernel; ``"tuned"`` dispatches through the autotuner.
      backend: ``"torch"`` or ``"kernel"``.  Ignored by ``"direct"``,
        ``"conventional"``, ``"native"`` and ``"tuned"`` (the winner
        carries its own).
      force_batch: pin the strided-batch mode (Fig. 5/6 benchmarks).
      tiles: per-call tile override (``{"b": depth}``), validated; only
        legal with ``backend="kernel"`` and a planning strategy
        (``"auto"``/``"flatten"``/``"batched"``).
      out_dtype: result dtype; defaults to the promoted operand dtype.
        Library GEMMs and the kernel both accumulate float32 and bfloat16
        operands in float32.
      mesh: a ``torch.distributed.device_mesh.DeviceMesh`` — execute
        *sharded*: every rank runs this contraction's plan on its local
        blocks, with collectives only where the contracted mode is
        sharded (see :mod:`repro_torch.distributed.contract`); the result
        is a DTensor.  ``A``/``B`` are DTensors on the mesh or plain
        tensors holding the global value on every rank.
      in_specs: with ``mesh``, a pair of ``PartitionSpec`` (or ``None``)
        aligned to the operand mode strings.
      out_spec: with ``mesh``, the requested output sharding (default:
        the natural one — batch/free modes keep their input sharding).

    Returns:
      The contracted tensor with modes ordered as ``spec``'s output.
    """
    if not _trace.enabled():
        return _contract_impl(
            spec, A, B, strategy=strategy, backend=backend,
            force_batch=force_batch, tiles=tiles, out_dtype=out_dtype,
            mesh=mesh, in_specs=in_specs, out_spec=out_spec,
        )
    with _trace.span("contract", "core") as sp:
        _annotate_contraction(sp, spec, A, B, strategy, backend, tiles, mesh)
        return _contract_impl(
            spec, A, B, strategy=strategy, backend=backend,
            force_batch=force_batch, tiles=tiles, out_dtype=out_dtype,
            mesh=mesh, in_specs=in_specs, out_spec=out_spec,
        )


def _annotate_contraction(sp, spec, A, B, strategy, backend, tiles, mesh):
    """Attach the roofline-attribution attributes to a ``contract`` span,
    and time its body on the device when the operands lie on the card.

    Best-effort: malformed calls annotate only what they were given and
    let the implementation raise its usual error (the span then records
    with an ``error`` attribute)."""
    sp.set(strategy=strategy, backend=backend, sharded=mesh is not None,
           spec=spec if isinstance(spec, str) else spec.spec_str())
    try:
        cs = parse_spec(spec) if isinstance(spec, str) else spec
        dims = infer_dims(cs, A, B)
        dtype = torch.promote_types(A.dtype, B.dtype)
    except (ValueError, NotImplementedError, AttributeError):
        return
    from repro_torch.obs.roofline import contraction_record

    sp.set(dims=dict(dims), **contraction_record(cs, dims, dtype, A.device))
    if tiles:
        sp.set(tiles=dict(tiles))
    if A.device.type == "cuda":
        sp.time_device(A.device)


def _contract_impl(spec, A, B, *, strategy, backend, force_batch, tiles,
                   out_dtype, mesh, in_specs, out_spec):
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown strategy {strategy!r}; expected one of {STRATEGIES}")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    cs = parse_spec(spec) if isinstance(spec, str) else spec
    dims = infer_dims(cs, A, B)
    out_dtype = out_dtype or torch.promote_types(A.dtype, B.dtype)

    if _ACTIVE_RECORDERS:
        rec_dtype = dtype_name(torch.promote_types(A.dtype, B.dtype))
        for rec in _ACTIVE_RECORDERS:
            rec.append((cs.spec_str(), dict(dims), rec_dtype))

    if mesh is not None:
        from repro_torch.distributed.contract import sharded_contract  # no cycle

        return sharded_contract(
            cs, A, B, mesh=mesh, in_specs=in_specs, out_spec=out_spec,
            strategy=strategy, backend=backend, tiles=tiles, out_dtype=out_dtype,
        )
    if in_specs is not None or out_spec is not None:
        raise ValueError("in_specs/out_spec require mesh=")
    if A.device != B.device:
        raise ValueError(f"operands on different devices: {A.device} vs {B.device}")

    if strategy == "tuned":
        if tiles is not None:
            raise ValueError(
                "tiles= cannot be combined with strategy='tuned' "
                "(the tuner owns tile selection)"
            )
        from repro_torch.tuning.dispatch import get_dispatcher  # deferred: no cycle

        return get_dispatcher().contract(cs, A, B, out_dtype=out_dtype)

    if tiles is not None:
        if strategy not in ("auto", "flatten", "batched"):
            raise ValueError(f"tiles= is meaningless for strategy={strategy!r}")
        if backend != "kernel":
            raise ValueError("tiles= requires backend='kernel'")
        from repro_torch.tuning.candidates import validate_tiles  # deferred: no cycle

        validate_tiles(tiles)

    if strategy == "native":
        from repro_torch.kernels import ops  # deferred: ops imports this layer

        return ops.execute_native(cs, A, B, out_dtype=out_dtype)
    if strategy == "direct":
        return _direct(cs, A, B).to(out_dtype)
    if strategy == "conventional":
        out, _ = _conventional(cs, A, B, dims)
        return out.to(out_dtype)

    allow_flatten = strategy in ("auto", "flatten")
    plan = make_plan(cs, dims, allow_flatten=allow_flatten, force_batch=force_batch)
    if strategy == "flatten" and plan.kind != CaseKind.FLAT_GEMM:
        raise ValueError(f"{cs.spec_str()} admits no flattened single-GEMM evaluation")

    if backend == "kernel":
        from repro_torch.kernels import ops

        return ops.execute_plan(plan, A, B, out_dtype=out_dtype, tiles=tiles)
    return _execute_torch(plan, A, B).to(out_dtype)


# --------------------------------------------------------------------------
# Library-GEMM execution
# --------------------------------------------------------------------------

def _promote(A, B):
    dt = torch.promote_types(A.dtype, B.dtype)
    return A.to(dt), B.to(dt)


def _reshape_to_fspec(x, modes: str, fmodes: str, fdims: dict):
    """Fuse flattened mode groups (a view for packed operands)."""
    if modes == fmodes:
        return x
    return x.reshape(tuple(fdims[m] for m in fmodes))


def _dot(a, a_modes: str, b, b_modes: str, out_modes: str, kmodes: str):
    """One ``tensordot`` contracting ``kmodes``; the output is put in
    ``out_modes`` order by choosing the operand order, else by a view
    permute."""
    a_free = "".join(m for m in a_modes if m not in kmodes)
    b_free = "".join(m for m in b_modes if m not in kmodes)
    a_k = [a_modes.index(m) for m in kmodes]
    b_k = [b_modes.index(m) for m in kmodes]
    if out_modes == b_free + a_free:
        return torch.tensordot(b, a, dims=(b_k, a_k) if kmodes else 0)
    out = torch.tensordot(a, b, dims=(a_k, b_k) if kmodes else 0)
    natural = a_free + b_free
    if out_modes != natural:
        out = out.permute([natural.index(m) for m in out_modes])
    return out


def _execute_torch(plan: Plan, A, B):
    A, B = _promote(A, B)
    if "degenerate" in plan.notes:
        # no matrix view of C exists (its minor mode is a shared batch
        # mode): no BLAS-style evaluation applies — use the direct path.
        return _direct(plan.spec, A, B)
    fs, fd = plan.fspec, plan.fdims
    A = _reshape_to_fspec(A, plan.spec.a_modes, fs.a_modes, fd)
    B = _reshape_to_fspec(B, plan.spec.b_modes, fs.b_modes, fd)

    if plan.kind == CaseKind.FLAT_GEMM and not plan.batch_modes:
        out = _dot(A, fs.a_modes, B, fs.b_modes, fs.c_modes, fs.contracted)
    else:
        out = _nested_batched(fs, plan.batch_modes, A, B)
    return out.reshape(tuple(plan.dims[m] for m in plan.spec.c_modes))


def _nested_batched(fs: ContractionSpec, batch_modes: str, A, B):
    """Nested ``torch.vmap`` (outermost-first) around a 2D ``tensordot``
    core — the rendering of looped sb_gemm: each vmap batches one mode in
    place (``in_dims``/``out_dims`` at the mode's native position)."""

    def build(a_modes: str, b_modes: str, c_modes: str, todo: str):
        if not todo:
            k = "".join(m for m in a_modes if m in b_modes and m not in c_modes)
            return lambda a, b: _dot(a, a_modes, b, b_modes, c_modes, k)
        beta, rest = todo[0], todo[1:]
        inner = build(
            a_modes.replace(beta, ""), b_modes.replace(beta, ""),
            c_modes.replace(beta, ""), rest,
        )
        in_a = a_modes.index(beta) if beta in a_modes else None
        in_b = b_modes.index(beta) if beta in b_modes else None
        return torch.vmap(inner, in_dims=(in_a, in_b), out_dims=c_modes.index(beta))

    return build(fs.a_modes, fs.b_modes, fs.c_modes, batch_modes)(A, B)


def _direct(cs: ContractionSpec, A, B):
    """One library contraction (``torch.einsum``, i.e. a batched GEMM)
    with the shared modes as batch dims, then a view permute."""
    A, B = _promote(A, B)
    shared = cs.batch
    k = set(cs.contracted) | set(shared)
    a_free = "".join(m for m in cs.a_modes if m not in k)
    b_free = "".join(m for m in cs.b_modes if m not in k)
    natural = shared + a_free + b_free
    out = torch.einsum(f"{cs.a_modes},{cs.b_modes}->{natural}", A, B)
    if natural != cs.c_modes:
        out = out.permute([natural.index(m) for m in cs.c_modes])
    return out


# --------------------------------------------------------------------------
# Conventional (matricization) baseline
# --------------------------------------------------------------------------

def _conventional(cs: ContractionSpec, A, B, dims: dict):
    """Explicit-copy matricization: permute to ``C_IJ = A_IK B_KJ``, flat
    GEMM, permute back.  Shared batch modes ride along as a leading batch
    group ``T`` on both matricized operands.  Every permute is
    materialised (``.contiguous()``) — the cost the baseline pays.
    Returns (result, n_materialized_transposes)."""
    A, B = _promote(A, B)
    k = cs.contracted
    T = "".join(m for m in cs.c_modes if m in cs.batch)
    I = "".join(m for m in cs.c_modes if m in cs.a_modes and m not in T)
    J = "".join(m for m in cs.c_modes if m in cs.b_modes and m not in T)
    n_trans = 0

    def permute(x, modes: str, target: str):
        nonlocal n_trans
        if modes == target:
            return x
        n_trans += 1
        return x.permute([modes.index(m) for m in target]).contiguous()

    a2 = permute(A, cs.a_modes, T + I + k).reshape(
        _prod(dims, T), _prod(dims, I), _prod(dims, k)
    )
    b2 = permute(B, cs.b_modes, T + k + J).reshape(
        _prod(dims, T), _prod(dims, k), _prod(dims, J)
    )
    c2 = torch.matmul(a2, b2)
    c = c2.reshape(tuple(dims[m] for m in T + I + J))
    out = permute(c, T + I + J, cs.c_modes)
    return out, n_trans


def _prod(dims: dict, modes: str) -> int:
    p = 1
    for m in modes:
        p *= dims[m]
    return p


def conventional_transpose_count(spec: str | ContractionSpec) -> int:
    """How many materialized permutes the conventional approach performs:
    A into ``I×K`` form, B into ``K×J`` form, and the result back into the
    requested output order (paper Fig. 1's motivation)."""
    cs = parse_spec(spec) if isinstance(spec, str) else spec
    k = cs.contracted
    T = "".join(m for m in cs.c_modes if m in cs.batch)
    I = "".join(m for m in cs.c_modes if m in cs.a_modes and m not in T)
    J = "".join(m for m in cs.c_modes if m in cs.b_modes and m not in T)
    n = 0
    n += cs.a_modes != T + I + k
    n += cs.b_modes != T + k + J
    n += cs.c_modes != T + I + J
    return int(n)


# --------------------------------------------------------------------------
# Copy counting (the port's counterpart of the JAX package's count_hlo_ops)
# --------------------------------------------------------------------------

def count_copy_ops(fn, *args) -> dict:
    """Run ``fn(*args)`` once under ``torch.profiler`` and count the
    :data:`COPY_OPS` events it dispatched (``aten::copy_``,
    ``aten::clone``, ``aten::contiguous``), by name.

    Engine-planned contractions on the kernel backend must count zero;
    the conventional baseline counts at least one event per materialised
    transpose (:func:`conventional_transpose_count`).
    """
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    counts = dict.fromkeys(COPY_OPS, 0)
    for ev in prof.events():
        if ev.name in counts:
            counts[ev.name] += 1
    return counts
