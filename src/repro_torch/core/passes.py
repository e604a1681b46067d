"""The contraction-program pass pipeline.

A freshly built :class:`~repro_torch.core.program.ContractionProgram`
holds one ``einsum`` node per expression.  Planning runs an ordered
sequence of passes, each a pure ``program -> program`` rewrite over the
typed IR:

1. :class:`PathOptimizationPass` — expand each n-ary node into pairwise
   ``contract`` steps (plus ``reduce`` for sum-only modes and
   ``transpose`` for single-operand expressions) using the path
   optimizers of :mod:`repro_torch.core.einsum`.
2. :class:`LayoutTieBreakPass`   — annotate every contract step with its
   planner classification and layout penalty (flatten ≺ sb_gemm ≺ nested
   ≺ exceptional) — the paper's evaluation hierarchy.
3. :class:`CSEPass`              — hash-cons identical steps so repeated
   subexpressions (a shared TTM stage, a duplicated gram) compute once.
4. :class:`LivenessPass`         — last-use analysis: annotate each step
   with the buffers that die after it (the executor frees them) and
   validate buffer-donation requests.

The JAX package's tuned re-rank and shard placement passes wait for the
``tuning/`` and ``distributed/`` ports (ROADMAP queue 1, items 9 and 12).
Passes hold no state between runs; anything cross-pass travels in the
:class:`PassContext`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import einsum as _einsum
from repro_torch.core.notation import parse_spec
from repro_torch.core.program import (
    ContractionProgram,
    ContractionStep,
    ProgramOptions,
    _steps_from_path,
    propagate_shapes,
    step_dims,
)

__all__ = [
    "PassContext",
    "PathOptimizationPass",
    "LayoutTieBreakPass",
    "CSEPass",
    "LivenessPass",
    "DEFAULT_PIPELINE",
    "run_pipeline",
]


@dataclasses.dataclass
class PassContext:
    """Options plus cross-pass scratch space for one pipeline run."""

    options: ProgramOptions
    artifacts: dict = dataclasses.field(default_factory=dict)
    log: list = dataclasses.field(default_factory=list)

    def note(self, pass_name: str, msg: str) -> None:
        self.log.append(f"{pass_name}: {msg}")


class PathOptimizationPass:
    """Expand ``einsum`` nodes into planned pairwise steps.

    Per expression: sum-only modes (appearing once overall and not in the
    expression's output) reduce first; single-operand expressions become a
    ``transpose``; everything else is path-planned by the configured
    optimizer (``naive``/``greedy``/``optimal``/``auto``) with the layout
    tie-break.
    """

    name = "path-optimization"

    def run(self, prog: ContractionProgram, ctx: PassContext) -> ContractionProgram:
        shapes, _ = propagate_shapes(prog)
        new_steps: list[ContractionStep] = []
        for step in prog.steps:
            if step.op != "einsum":
                new_steps.append(step)
                continue
            new_steps.extend(self._expand(step, shapes, ctx))
        return dataclasses.replace(prog, steps=tuple(new_steps))

    def _expand(self, step, shapes, ctx):
        in_modes, output = _einsum.parse_nary(step.spec)
        reduce_axes = _einsum._sum_only_axes(in_modes, output)

        steps: list[ContractionStep] = []
        arg_names: list[str] = []
        for n, (arg, axes) in enumerate(zip(step.args, reduce_axes)):
            if axes:
                name = f"%{step.out}.r{n}"
                steps.append(ContractionStep(
                    op="reduce", out=name, args=(arg,), axes=axes,
                ))
                arg_names.append(name)
            else:
                arg_names.append(arg)
        reduced = tuple(
            "".join(m for i, m in enumerate(t) if i not in axes)
            for t, axes in zip(in_modes, reduce_axes)
        )
        red_shapes = [
            tuple(d for i, d in enumerate(shapes[a]) if i not in axes)
            for a, axes in zip(step.args, reduce_axes)
        ]

        if len(arg_names) == 1:
            perm = tuple(reduced[0].index(m) for m in output)
            steps.append(ContractionStep(
                op="transpose", out=step.out, args=(arg_names[0],), axes=perm,
            ))
            return steps

        dims = _einsum._infer_dims(reduced, red_shapes)
        path = _einsum._plan_path(step.spec, reduced, output, dims,
                                  ctx.options.optimize)
        steps.extend(
            _steps_from_path(path, tuple(arg_names), step.out, step.strategy)
        )
        ctx.note(self.name, f"{step.out}: {len(path.steps)} steps "
                            f"[{path.optimize}] flops={path.total_flops}")
        return steps


class LayoutTieBreakPass:
    """Annotate contract steps with planner kind + layout penalty (flatten
    ≺ sb_gemm ≺ nested ≺ exceptional, +2 for degenerate plans) — the
    signal the path optimizers already use to order equal-flop paths, as
    a first-class IR annotation."""

    name = "layout-tie-break"

    def run(self, prog: ContractionProgram, ctx: PassContext) -> ContractionProgram:
        shapes, _ = propagate_shapes(prog)
        new_steps = []
        for s in prog.steps:
            if s.op != "contract":
                new_steps.append(s)
                continue
            cs = parse_spec(s.spec)
            dims = step_dims(cs, shapes[s.args[0]], shapes[s.args[1]])
            kind, penalty = _einsum._classify(cs, dims)
            new_steps.append(dataclasses.replace(s, kind=kind, penalty=penalty))
        return dataclasses.replace(prog, steps=tuple(new_steps))


class CSEPass:
    """Hash-cons identical steps: same op, same (resolved) arguments, same
    spec/axes/strategy compute the same value — later duplicates are
    dropped and their consumers rewired to the first occurrence.  Only
    *structural* duplicates merge; the pass does not exploit
    commutativity (``A·B`` vs ``B·A``)."""

    name = "cse"

    def run(self, prog: ContractionProgram, ctx: PassContext) -> ContractionProgram:
        rename: dict[str, str] = {}
        seen: dict[tuple, str] = {}
        new_steps = []
        for s in prog.steps:
            args = tuple(rename.get(a, a) for a in s.args)
            key = (s.op, args, s.spec, s.axes, s.strategy)
            prior = seen.get(key)
            if prior is not None:
                rename[s.out] = prior
                ctx.note(self.name, f"{s.out} := {prior}")
                continue
            seen[key] = s.out
            new_steps.append(dataclasses.replace(s, args=args))
        outputs = tuple(rename.get(o, o) for o in prog.outputs)
        return dataclasses.replace(prog, steps=tuple(new_steps),
                                   outputs=outputs)


class LivenessPass:
    """Annotate each step with the buffers whose last use it is; the
    executor drops them as it goes, freeing device memory mid-program.
    Also validates ``donate=`` requests: a donated input must be consumed
    by the program and must not be a program output."""

    name = "liveness"

    def run(self, prog: ContractionProgram, ctx: PassContext) -> ContractionProgram:
        last: dict[str, int] = {}
        for idx, s in enumerate(prog.steps):
            for a in s.args:
                last[a] = idx
        outputs = set(prog.outputs)
        for name in ctx.options.donate:
            if name not in prog.input_names:
                raise ValueError(f"donate={name!r} is not a program input")
            if name in outputs:
                raise ValueError(
                    f"cannot donate {name!r}: it is a program output"
                )
            if name not in last:
                raise ValueError(
                    f"cannot donate {name!r}: the program never consumes it"
                )
        by_step: dict[int, list[str]] = {}
        for name, idx in last.items():
            if name not in outputs:
                by_step.setdefault(idx, []).append(name)
        new_steps = tuple(
            dataclasses.replace(s, last_uses=tuple(sorted(by_step.get(i, ()))))
            for i, s in enumerate(prog.steps)
        )
        return dataclasses.replace(prog, steps=new_steps)


DEFAULT_PIPELINE = (
    PathOptimizationPass(),
    LayoutTieBreakPass(),
    CSEPass(),
    LivenessPass(),
)


def run_pipeline(prog: ContractionProgram, opts: ProgramOptions,
                 pipeline=None) -> ContractionProgram:
    """Run ``pipeline`` (default :data:`DEFAULT_PIPELINE`) over ``prog``."""
    ctx = PassContext(options=opts)
    for p in (pipeline if pipeline is not None else DEFAULT_PIPELINE):
        prog = p.run(prog, ctx)
    prog.validate()
    return prog
