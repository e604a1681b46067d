"""The contraction-program pass pipeline.

A freshly built :class:`~repro_torch.core.program.ContractionProgram`
holds one ``einsum`` node per expression.  Planning runs an ordered
sequence of passes, each a pure ``program -> program`` rewrite over the
typed IR:

1. :class:`PathOptimizationPass` — expand each n-ary node into pairwise
   ``contract`` steps (plus ``reduce`` for sum-only modes and
   ``transpose`` for single-operand expressions) using the path
   optimizers of :mod:`repro_torch.core.einsum`; comm-aware under a mesh.
2. :class:`LayoutTieBreakPass`   — annotate every contract step with its
   planner classification and layout penalty (flatten ≺ sb_gemm ≺ nested
   ≺ exceptional) — the paper's evaluation hierarchy.
3. :class:`TunedRerankPass`      — for ``optimize="tuned"``, re-rank the
   analytic candidate paths with measured step costs
   (:func:`repro_torch.tuning.dispatch.path_cost`) and splice in the
   winner.
4. :class:`ShardPlacementPass`   — under a mesh, thread ``PartitionSpec``
   annotations through the DAG
   (:func:`repro_torch.distributed.contract.plan_sharded` per step;
   natural propagation, caller-requested output reshardings on program
   outputs).
5. :class:`CSEPass`              — hash-cons identical steps so repeated
   subexpressions (a shared TTM stage, a duplicated gram) compute once.
6. :class:`LivenessPass`         — last-use analysis: annotate each step
   with the buffers that die after it (the executor frees them) and
   validate buffer-donation requests.
Passes hold no state between runs; anything cross-pass travels in the
:class:`PassContext`.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any

import torch

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
    "TunedRerankPass",
    "ShardPlacementPass",
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
    tie-break and — under a mesh — the communication cost term.  For
    ``optimize="tuned"`` the analytic candidates are planned here and
    stashed for :class:`TunedRerankPass`.
    """

    name = "path-optimization"

    def run(self, prog: ContractionProgram, ctx: PassContext) -> ContractionProgram:
        shapes, dtypes = propagate_shapes(prog)
        pspecs = dict(zip(prog.input_names, ctx.options.in_specs))
        new_steps: list[ContractionStep] = []
        for step in prog.steps:
            if step.op != "einsum":
                new_steps.append(step)
                continue
            new_steps.extend(self._expand(step, shapes, dtypes, pspecs, ctx))
        return dataclasses.replace(prog, steps=tuple(new_steps))

    def _expand(self, step, shapes, dtypes, pspecs, ctx):
        opts = ctx.options
        in_modes, output = _einsum.parse_nary(step.spec)
        reduce_axes = _einsum._sum_only_axes(in_modes, output)

        steps: list[ContractionStep] = []
        arg_names: list[str] = []
        arg_pspecs: list = []
        for n, (arg, axes) in enumerate(zip(step.args, reduce_axes)):
            pspec = pspecs.get(arg)
            if axes:
                # shared with the eager front-end: rejects sharded sum-only
                # modes and aligns the spec past the reduction
                (pspec,) = _einsum._drop_reduced_pspecs(
                    (pspec,), (in_modes[n],), (axes,)
                )
                name = f"%{step.out}.r{n}"
                steps.append(ContractionStep(
                    op="reduce", out=name, args=(arg,), axes=axes,
                ))
                arg_names.append(name)
            else:
                arg_names.append(arg)
            arg_pspecs.append(pspec)
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
        dtype = functools.reduce(torch.promote_types,
                                 [dtypes[a] for a in step.args])
        shard = None
        if opts.mesh is not None:
            # mode→axis map for comm-aware costing.  Args produced by
            # earlier expressions have no caller spec; they enter the map
            # as replicated — exact for single-expression programs, an
            # under-estimate of available sharding for chained ones.
            from repro_torch.distributed.contract import resolve_mode_axes

            mode_axes = resolve_mode_axes(reduced, tuple(arg_pspecs),
                                          mesh=opts.mesh)
            axis_sizes = dict(zip(opts.mesh.mesh_dim_names, opts.mesh.shape))
            shard = (mode_axes, axis_sizes)

        if opts.optimize == "tuned":
            candidates = _einsum._candidate_paths(step.spec, reduced, output, dims)
            path = candidates[0]  # auto's choice until the re-rank pass
            ctx.artifacts.setdefault("tuned_candidates", {})[step.out] = (
                candidates, dims, dtype, tuple(arg_names), step.strategy,
            )
        else:
            path = _einsum._plan_path(step.spec, reduced, output, dims,
                                      opts.optimize, dtype=dtype, shard=shard)
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


class TunedRerankPass:
    """Re-rank each expression's candidate paths with measured step costs.

    No-op unless ``optimize="tuned"``.  Pricing is
    :func:`repro_torch.tuning.dispatch.path_cost` — the autotuner cache's
    measured µs per step where an entry exists, an analytic price
    otherwise.  The program signature folds in the tuning-cache
    fingerprint, so warming the cache re-plans tuned programs rather than
    pinning a stale path.
    """

    name = "tuned-rerank"

    def run(self, prog: ContractionProgram, ctx: PassContext) -> ContractionProgram:
        stash = ctx.artifacts.get("tuned_candidates")
        if not stash:
            return prog
        from repro_torch.tuning.dispatch import get_dispatcher, path_cost

        disp = get_dispatcher()
        steps = list(prog.steps)
        for out, (cands, dims, dtype, args, strategy) in stash.items():
            chosen = min(
                cands, key=lambda p: path_cost(p.steps, dims, dtype, disp)
            )
            if chosen is not cands[0]:
                ctx.note(self.name, f"{out}: measured costs prefer the "
                                    f"{chosen.optimize!r} path")
            owned = re.compile(rf"^(%{re.escape(out)}\.\d+|{re.escape(out)})$")
            first = next(
                i for i, s in enumerate(steps) if owned.match(s.out)
            )
            steps = [s for s in steps if not owned.match(s.out)]
            steps[first:first] = _steps_from_path(chosen, args, out, strategy)
        return dataclasses.replace(prog, steps=tuple(steps))


class ShardPlacementPass:
    """Thread ``PartitionSpec`` annotations through the DAG (mesh only).

    Program inputs carry the caller's ``in_specs``; every contract step is
    planned with :func:`repro_torch.distributed.contract.plan_sharded` and
    annotated with its aligned input specs and resulting output spec
    (natural propagation — collectives only where a sharded contracted
    mode forces them).  Caller-requested output reshardings apply to the
    steps producing program outputs.
    """

    name = "shard-placement"

    def run(self, prog: ContractionProgram, ctx: PassContext) -> ContractionProgram:
        opts = ctx.options
        if opts.mesh is None:
            return prog
        from repro_torch.distributed.contract import plan_sharded
        from repro_torch.distributed.sharding import P, specs_equal

        requested = dict(zip(prog.outputs, opts.out_specs))
        shapes, _ = propagate_shapes(prog)
        pspecs: dict[str, Any] = dict(zip(prog.input_names, opts.in_specs))
        new_steps = []
        for s in prog.steps:
            if s.op == "reduce":
                pspec = pspecs.get(s.args[0])
                if pspec is not None:
                    entries = list(tuple(pspec))
                    entries += [None] * (len(shapes[s.args[0]]) - len(entries))
                    for i in s.axes:
                        # einsum-derived reduces were validated at path
                        # expansion; this guards pre-planned paths, where a
                        # sharded sum-only axis would need a post-sum psum
                        if entries[i] is not None:
                            raise NotImplementedError(
                                f"axis {i} of {s.args[0]!r} is summed out "
                                f"before planning but sharded over "
                                f"{entries[i]!r}; replicate sum-only modes"
                            )
                    pspec = P(*[e for i, e in enumerate(entries)
                                if i not in s.axes])
                pspecs[s.out] = pspec
            elif s.op == "transpose":
                pspec = pspecs.get(s.args[0])
                if pspec is not None:
                    entries = list(tuple(pspec))
                    entries += [None] * (len(s.axes) - len(entries))
                    pspec = P(*[entries[i] for i in s.axes])
                pspecs[s.out] = pspec
                if requested.get(s.out) is not None:
                    raise NotImplementedError(
                        "out_specs on a transpose-only output is not "
                        "supported; reshard the result DTensor"
                    )
            elif s.op == "contract":
                cs = parse_spec(s.spec)
                dims = step_dims(cs, shapes[s.args[0]], shapes[s.args[1]])
                pa, pb = pspecs.get(s.args[0]), pspecs.get(s.args[1])
                req = requested.get(s.out)
                plan = plan_sharded(
                    cs, dims, mesh=opts.mesh, in_specs=(pa, pb), out_spec=req
                )
                if req is not None and not specs_equal(plan.out_spec, req):
                    raise AssertionError(
                        f"shard placement for {s.out!r} produced "
                        f"{plan.out_spec}, caller requested {req}"
                    )
                s = dataclasses.replace(
                    s, in_pspecs=(pa, pb), out_pspec=plan.out_spec,
                    comm_bytes=s.comm_bytes,
                )
                pspecs[s.out] = plan.out_spec
            new_steps.append(s)
        return dataclasses.replace(prog, steps=tuple(new_steps))


class CSEPass:
    """Hash-cons identical steps: same op, same (resolved) arguments, same
    spec/axes/strategy/sharding compute the same value — later duplicates are
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
            key = (s.op, args, s.spec, s.axes, s.strategy,
                   s.in_pspecs, s.out_pspec)
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
    TunedRerankPass(),
    ShardPlacementPass(),
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
