"""Contraction-program IR: whole einsum expressions as compiled objects.

The stack below this module evaluates *one* pairwise step without
copy/transpose overhead; an application is rarely one step.  Tucker's
HOOI body is three multi-operand expressions sharing a TTM stage, and
eager :func:`repro_torch.core.einsum.xeinsum` would re-parse and re-plan
each of them on every call.  This module compiles whole expressions:

    parse  →  passes  →  execute (many times)

* **IR** — a :class:`ContractionProgram` is a DAG of
  :class:`ContractionStep` nodes over *named buffers*: the program inputs
  plus named intermediates.  Freshly built programs hold one ``einsum``
  node per expression; the pass pipeline rewrites them into ``contract``
  / ``reduce`` / ``transpose`` nodes (see :mod:`repro_torch.core.passes`).
* **Passes** — path optimization, layout tie-break annotation, CSE of
  repeated subexpressions, and intermediate-liveness analysis run in
  order, each a pure ``program -> program`` rewrite.
* **Execution** — the planned steps run eagerly through
  :func:`repro_torch.core.contract.contract` (the paper's planner and
  kernels); there is no tracing compiler, so no ``jit``.  Liveness
  annotations drop each intermediate after its last use, which frees its
  device memory mid-program.
* **Cache** — compiled programs are cached process-wide by canonical
  signature (structure + shapes + dtypes + options), so the Nth call of a
  recurring working set (a HOOI iteration) skips parsing and planning.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Mapping, Sequence

import torch

from repro_torch.core import einsum as _einsum
from repro_torch.core.contract import dtype_name
from repro_torch.core.notation import ContractionSpec, parse_spec
from repro_torch.obs import trace as _trace

__all__ = [
    "ProgramInput",
    "ContractionStep",
    "ContractionProgram",
    "CompiledProgram",
    "ProgramOptions",
    "build_program",
    "compile_program",
    "program_signature",
    "program_cache_stats",
    "clear_program_cache",
    "propagate_shapes",
]


# --------------------------------------------------------------------------
# IR
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProgramInput:
    """One program operand: a named buffer with a fixed shape and dtype."""

    name: str
    shape: tuple[int, ...]
    dtype: str                    # canonical dtype name ("float32", ...)


@dataclasses.dataclass(frozen=True)
class ContractionStep:
    """One node of the program DAG, in SSA form over named buffers.

    ``op`` is one of:

    * ``"einsum"``    — an unplanned n-ary expression (only in freshly
      built programs; the path-optimization pass expands it);
    * ``"contract"``  — one pairwise contraction, lowered through
      :func:`repro_torch.core.contract.contract`;
    * ``"reduce"``    — sum over ``axes`` (sum-only modes, reduced before
      planning);
    * ``"transpose"`` — permute by ``axes`` (single-operand expressions;
      an identity permutation is a no-op).
    """

    op: str
    out: str
    args: tuple[str, ...]
    spec: str = ""                # n-ary spec (einsum) / pairwise spec (contract)
    axes: tuple[int, ...] = ()    # reduce: summed axes; transpose: permutation
    strategy: str = ""            # per-step strategy override ("" = program's)
    # ---- pass annotations ----
    kind: str = ""                # planner CaseKind (layout tie-break pass)
    penalty: int = -1             # layout penalty (flat ≺ sb ≺ nested ≺ exc)
    flops: int = 0                # cost-model flops (path optimization)
    last_uses: tuple[str, ...] = ()   # buffers dead after this step (liveness)

    def key(self) -> tuple:
        """Structural identity — what makes two steps compute the same
        value the same way (cost annotations are not included)."""
        return (self.op, self.out, self.args, self.spec, self.axes,
                self.strategy)

    def describe(self) -> str:
        bits = [f"%{self.out} = {self.op}"]
        if self.spec:
            bits.append(self.spec)
        if self.op in ("reduce", "transpose"):
            bits.append(f"axes={self.axes}")
        bits.append("(" + ", ".join(self.args) + ")")
        if self.strategy:
            bits.append(f"strategy={self.strategy}")
        if self.kind:
            bits.append(f"[{self.kind}]")
        if self.flops:
            bits.append(f"flops={self.flops}")
        if self.last_uses:
            bits.append(f"frees={list(self.last_uses)}")
        return " ".join(bits)


@dataclasses.dataclass(frozen=True)
class ContractionProgram:
    """A DAG of :class:`ContractionStep` nodes with named intermediates."""

    inputs: tuple[ProgramInput, ...]
    steps: tuple[ContractionStep, ...]
    outputs: tuple[str, ...]

    @property
    def input_names(self) -> tuple[str, ...]:
        return tuple(i.name for i in self.inputs)

    @property
    def total_flops(self) -> int:
        return sum(s.flops for s in self.steps)

    def describe(self) -> str:
        lines = [
            "program("
            + ", ".join(f"{i.name}:{i.dtype}{list(i.shape)}" for i in self.inputs)
            + ") -> (" + ", ".join(self.outputs) + ")"
        ]
        lines += ["  " + s.describe() for s in self.steps]
        return "\n".join(lines)

    def validate(self) -> None:
        """Raise ``ValueError`` on name clashes, references to unknown
        buffers (the SSA/topological-order invariant) or unknown outputs."""
        known = set()
        for i in self.inputs:
            if i.name in known:
                raise ValueError(f"duplicate input name {i.name!r}")
            known.add(i.name)
        for s in self.steps:
            for a in s.args:
                if a not in known:
                    raise ValueError(
                        f"step {s.out!r} references unknown buffer {a!r} "
                        f"(steps must be in topological order)"
                    )
            if s.out in known:
                raise ValueError(f"duplicate buffer name {s.out!r}")
            known.add(s.out)
        for o in self.outputs:
            if o not in known:
                raise ValueError(f"output {o!r} is not a program buffer")


def _aval_of(x) -> tuple[tuple[int, ...], str]:
    """(shape, dtype name) of a tensor (a ``meta`` tensor describes a
    shape-only input) or of a bare shape tuple (float32)."""
    if isinstance(x, torch.Tensor):
        return tuple(int(d) for d in x.shape), dtype_name(x.dtype)
    return tuple(int(d) for d in x), "float32"


def build_program(
    inputs: Mapping[str, Any],
    exprs: Sequence,
    outputs: Sequence[str] | None = None,
) -> ContractionProgram:
    """Build an (unplanned) program from named inputs and expressions.

    Args:
      inputs: ordered ``name -> tensor`` (a ``device="meta"`` tensor for a
        shape-only input) or bare shape tuple.  The order fixes the
        compiled callable's positional signature.
      exprs: ``(name, spec, args)`` or ``(name, spec, args, opts)``
        tuples — ``spec`` an n-ary einsum string, ``args`` the names of
        inputs or *earlier* expression results, ``opts`` currently
        ``{"strategy": ...}`` to override the program strategy for this
        expression's steps.
      outputs: result buffer names (default: the last expression only).

    Shapes and dtypes are propagated and validated eagerly, so a rank or
    size mismatch raises here, not at execution.
    """
    ins = tuple(
        ProgramInput(name, *_aval_of(v)) for name, v in dict(inputs).items()
    )
    steps = []
    for expr in exprs:
        if len(expr) == 3:
            (name, spec, args), opts = expr, {}
        elif len(expr) == 4:
            name, spec, args, opts = expr
        else:
            raise ValueError(f"expr must be (name, spec, args[, opts]): {expr!r}")
        unknown = set(opts) - {"strategy"}
        if unknown:
            raise ValueError(f"unknown expr options {sorted(unknown)}")
        in_modes, _ = _einsum.parse_nary(spec)
        if len(in_modes) != len(args):
            raise ValueError(
                f"expr {name!r}: spec has {len(in_modes)} operands, got "
                f"{len(args)} args"
            )
        steps.append(ContractionStep(
            op="einsum", out=name, args=tuple(args), spec=spec,
            strategy=opts.get("strategy", ""),
        ))
    if outputs is None:
        if not steps:
            raise ValueError("a program needs at least one expression")
        outputs = (steps[-1].out,)
    prog = ContractionProgram(inputs=ins, steps=tuple(steps),
                              outputs=tuple(outputs))
    prog.validate()
    propagate_shapes(prog)  # eager shape/dtype validation
    return prog


# --------------------------------------------------------------------------
# Shape / dtype propagation
# --------------------------------------------------------------------------

def propagate_shapes(prog: ContractionProgram) -> tuple[dict, dict]:
    """``(shapes, dtypes)`` for every buffer, validated step by step."""
    shapes: dict[str, tuple[int, ...]] = {i.name: i.shape for i in prog.inputs}
    dtypes: dict[str, Any] = {i.name: getattr(torch, i.dtype) for i in prog.inputs}
    for s in prog.steps:
        arg_shapes = [shapes[a] for a in s.args]
        if s.op == "einsum":
            in_modes, out_modes = _einsum.parse_nary(s.spec)
            dims = _einsum._infer_dims(in_modes, arg_shapes)
            shapes[s.out] = tuple(dims[m] for m in out_modes)
        elif s.op == "contract":
            cs = parse_spec(s.spec)
            dims = step_dims(cs, *arg_shapes)
            shapes[s.out] = tuple(dims[m] for m in cs.c_modes)
        elif s.op == "reduce":
            shapes[s.out] = tuple(
                d for i, d in enumerate(arg_shapes[0]) if i not in s.axes
            )
        elif s.op == "transpose":
            shapes[s.out] = tuple(arg_shapes[0][i] for i in s.axes)
        else:
            raise ValueError(f"unknown step op {s.op!r}")
        dtypes[s.out] = functools.reduce(
            torch.promote_types, [dtypes[a] for a in s.args])
    return shapes, dtypes


def step_dims(cs: ContractionSpec, a_shape, b_shape) -> dict:
    """Mode→size map of one pairwise step from its operand shapes."""
    dims: dict = {}
    for modes, shape in ((cs.a_modes, a_shape), (cs.b_modes, b_shape)):
        if len(modes) != len(shape):
            raise ValueError(
                f"rank mismatch: shape {tuple(shape)} vs modes {modes!r}"
            )
        for m, d in zip(modes, shape):
            if dims.setdefault(m, int(d)) != int(d):
                raise ValueError(
                    f"inconsistent size for mode {m!r}: {dims[m]} vs {d}"
                )
    return dims


# --------------------------------------------------------------------------
# Options + canonical signature
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProgramOptions:
    """Everything besides the IR that shapes planning and execution."""

    optimize: Any = "auto"               # path optimizer (or ("path",) tag)
    strategy: str = "auto"
    backend: str = "torch"
    out_dtype: Any = None                # per-output dtype (single value)
    donate: tuple[str, ...] = ()

    def signature(self) -> tuple:
        return (
            self.optimize if isinstance(self.optimize, (str, tuple))
            else str(self.optimize),
            self.strategy, self.backend,
            dtype_name(self.out_dtype) if self.out_dtype is not None else None,
            self.donate,
        )


def program_signature(prog: ContractionProgram, opts: ProgramOptions) -> tuple:
    """Canonical cache key: program structure + operand avals + options."""
    return (
        tuple((i.name, i.shape, i.dtype) for i in prog.inputs),
        tuple(s.key() for s in prog.steps),
        prog.outputs,
        opts.signature(),
    )


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------

def _run_step(step: ContractionStep, args, opts: ProgramOptions):
    if step.op == "contract":
        return _einsum._pairwise(
            parse_spec(step.spec), args[0], args[1],
            step.strategy or opts.strategy, opts.backend,
        )
    if step.op == "reduce":
        return torch.sum(args[0], dim=step.axes)
    if step.op == "transpose":
        if step.axes == tuple(range(len(step.axes))):
            return args[0]
        return args[0].permute(step.axes)
    raise RuntimeError(
        f"cannot execute unexpanded {step.op!r} node — run the pass "
        f"pipeline (compile_program) first"
    )


def _execute(prog: ContractionProgram, opts: ProgramOptions, tensors):
    """The step interpreter.  Liveness annotations drop dead buffers as
    soon as their last consumer has run, freeing their device memory."""
    env = dict(zip((i.name for i in prog.inputs), tensors))
    for step in prog.steps:
        env[step.out] = _run_step(step, [env[a] for a in step.args], opts)
        for dead in step.last_uses:
            env.pop(dead, None)
    out_dtype = opts.out_dtype
    return tuple(
        env[o].to(out_dtype) if out_dtype is not None else env[o]
        for o in prog.outputs
    )


class CompiledProgram:
    """A planned, cache-resident contraction program.

    Call it with positional tensors in program-input order; single-output
    programs return the tensor, multi-output programs a tuple.
    """

    def __init__(self, prog: ContractionProgram, opts: ProgramOptions,
                 signature: tuple):
        self.program = prog
        self.options = opts
        self.signature = signature

    def __call__(self, *operands):
        prog = self.program
        if len(operands) != len(prog.inputs):
            raise ValueError(
                f"program takes {len(prog.inputs)} operands "
                f"({', '.join(prog.input_names)}), got {len(operands)}"
            )
        for inp, x in zip(prog.inputs, operands):
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"operand {inp.name!r}: expected a tensor, "
                                f"got {type(x).__name__}")
            if tuple(x.shape) != inp.shape:
                raise ValueError(
                    f"operand {inp.name!r}: compiled for shape {inp.shape}, "
                    f"got {tuple(x.shape)} — compile_program again for new "
                    f"shapes"
                )
        outs = _execute(prog, self.options, operands)
        return outs[0] if len(prog.outputs) == 1 else outs

    @property
    def total_flops(self) -> int:
        return self.program.total_flops

    def describe(self) -> str:
        return self.program.describe()


# --------------------------------------------------------------------------
# Program cache
# --------------------------------------------------------------------------

_LOCK = threading.Lock()
_PROGRAMS: dict[tuple, CompiledProgram] = {}
_STATS = {"hits": 0, "misses": 0}


def program_cache_stats() -> dict:
    with _LOCK:
        return {"programs": len(_PROGRAMS), **_STATS}


def clear_program_cache() -> None:
    with _LOCK:
        _PROGRAMS.clear()
        _STATS["hits"] = _STATS["misses"] = 0


# --------------------------------------------------------------------------
# compile_program
# --------------------------------------------------------------------------

def _steps_from_path(path, arg_names: tuple[str, ...], out: str,
                     strategy: str = "") -> list[ContractionStep]:
    """Pre-planned :class:`~repro_torch.core.einsum.ContractionPath` →
    contract steps (SSA ids become named buffers)."""
    names = {i: n for i, n in enumerate(arg_names)}
    steps = []
    for n, s in enumerate(path.steps):
        name = out if n == len(path.steps) - 1 else f"%{out}.{n}"
        names[s.out] = name
        steps.append(ContractionStep(
            op="contract", out=name, args=(names[s.lhs], names[s.rhs]),
            spec=s.spec.spec_str(), strategy=strategy,
            kind=s.kind, flops=s.flops,
        ))
    return steps


def _single_expr_program(spec: str, operands, optimize) -> ContractionProgram:
    """Build the one-expression program behind ``compile_program(spec, ...)``
    / :func:`repro_torch.core.einsum.xeinsum`."""
    in_modes, output = _einsum.parse_nary(spec)
    if len(operands) != len(in_modes):
        raise ValueError(
            f"spec has {len(in_modes)} operands, got {len(operands)}"
        )
    names = tuple(f"%{i}" for i in range(len(operands)))
    inputs = dict(zip(names, operands))
    if isinstance(optimize, _einsum.ContractionPath):
        # precomputed path: emit contract steps directly (plus the sum-only
        # reductions the path planner assumes already happened)
        reduce_axes = _einsum._sum_only_axes(in_modes, output)
        arg_names, steps = [], []
        for n, (t, axes) in enumerate(zip(in_modes, reduce_axes)):
            if axes:
                steps.append(ContractionStep(
                    op="reduce", out=f"%{n}r", args=(names[n],), axes=axes,
                ))
                arg_names.append(f"%{n}r")
            else:
                arg_names.append(names[n])
        reduced = tuple(
            "".join(m for i, m in enumerate(t) if i not in axes)
            for t, axes in zip(in_modes, reduce_axes)
        )
        if optimize.inputs != reduced or optimize.output != output:
            raise ValueError(
                f"precomputed path is for {optimize.inputs}->{optimize.output}, "
                f"not {reduced}->{output}"
            )
        if len(arg_names) == 1:
            modes = reduced[0]
            steps.append(ContractionStep(
                op="transpose", out="out", args=(arg_names[0],),
                axes=tuple(modes.index(m) for m in output),
            ))
        else:
            steps.extend(_steps_from_path(optimize, tuple(arg_names), "out"))
        prog = ContractionProgram(
            inputs=tuple(ProgramInput(n, *_aval_of(v))
                         for n, v in inputs.items()),
            steps=tuple(steps), outputs=("out",),
        )
        prog.validate()
        propagate_shapes(prog)
        return prog
    return build_program(inputs, [("out", spec, names)])


def compile_program(
    program: ContractionProgram | str,
    *operands,
    optimize="auto",
    strategy: str = "auto",
    backend: str = "torch",
    out_dtype=None,
    donate: Sequence[str] = (),
    pipeline=None,
    use_cache: bool = True,
) -> CompiledProgram:
    """Plan a contraction program into a cached, callable program.

    Args:
      program: a :class:`ContractionProgram` from :func:`build_program`
        (``operands`` must then be empty — shapes come from the IR), or an
        n-ary einsum spec string with one operand (tensor or shape) per
        spec operand — the single-expression form
        :func:`repro_torch.core.einsum.xeinsum` wraps.
      optimize: path optimizer per expression (``"auto"`` | ``"greedy"``
        | ``"optimal"`` | ``"naive"``), or — spec form only — a
        precomputed :class:`~repro_torch.core.einsum.ContractionPath`.
      strategy/backend/out_dtype: per-step execution knobs, exactly as
        :func:`repro_torch.core.contract.contract`.
      donate: names of program inputs the caller gives up.  Validated by
        the liveness pass (a donated input must be consumed and must not
        be returned) and otherwise without effect: eager execution
        already frees every intermediate after its last use, and an input
        stays alive as long as the caller holds it.
      pipeline: override the default pass pipeline
        (:data:`repro_torch.core.passes.DEFAULT_PIPELINE`).  Custom
        pipelines bypass the program cache — pass identity is not part
        of the canonical signature.
      use_cache: set False to force a fresh plan.

    Returns:
      A :class:`CompiledProgram`; repeated calls with the same canonical
      signature return the same object.
    """
    if isinstance(program, str):
        prog = _single_expr_program(program, operands, optimize)
        if isinstance(optimize, _einsum.ContractionPath):
            optimize = ("path",)  # steps already carry the plan
    else:
        if operands:
            raise ValueError(
                "operands are only accepted with a spec string; a "
                "ContractionProgram carries its own input avals"
            )
        prog = program
        prog.validate()

    if not isinstance(optimize, tuple):
        _einsum.check_optimize(optimize)
    if strategy == "tuned" or any(s.strategy == "tuned" for s in prog.steps):
        raise NotImplementedError(
            "strategy='tuned' needs the autotuner, which is not ported yet: "
            "ROADMAP queue 1, item 9")

    opts = ProgramOptions(optimize=optimize, strategy=strategy,
                          backend=backend, out_dtype=out_dtype,
                          donate=tuple(donate))
    if pipeline is not None:
        use_cache = False  # pass identity is not in the canonical signature

    sig = program_signature(prog, opts)
    if use_cache:
        with _LOCK:
            hit = _PROGRAMS.get(sig)
            if hit is not None:
                _STATS["hits"] += 1
                return hit
    with _LOCK:
        _STATS["misses"] += 1

    from repro_torch.core import passes as _passes  # deferred: passes import us

    with _trace.span("program_compile", "program") as sp:
        if sp:
            sp.set(steps=len(prog.steps))
        planned = _passes.run_pipeline(prog, opts, pipeline)
        compiled = CompiledProgram(planned, opts, sig)
        if use_cache:
            with _LOCK:
                compiled = _PROGRAMS.setdefault(sig, compiled)
    return compiled
