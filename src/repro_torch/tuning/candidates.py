"""Legal execution candidates for one pairwise contraction.

The paper's Figs. 5–8 show that the fastest evaluation mode — flattened
GEMM, StridedBatchedGEMM over one batch mode or another, or the
exceptional (extended-transpose) kernel — depends on the shape, and no
static rule picks the winner everywhere.  The autotuner therefore treats
plan selection as an empirical search: this module enumerates the finite
set of *legal* ways to run a :class:`~repro_torch.core.notation.ContractionSpec`
at given dims, and :mod:`repro_torch.tuning.measure` times them.

The candidates are what the port actually runs:

* ``torch`` — library GEMMs: exactly the JAX package's ``xla`` set
  (``auto``, ``batched`` where it plans differently, ``direct``);
* ``kernel`` — the hand-written ``native_gemm``: ``auto``/``batched`` for
  each distinct plan :func:`~repro_torch.kernels.ops.plan_roles` lowers,
  at each brick depth of :data:`EXT_BRICK_GRID` on exceptional plans (the
  ``b`` tile: how many indices of the batch mode one block walks), and
  ``native`` once.

``native_gemm`` picks its route and tile from the operands' layout
(:func:`~repro_torch.kernels.sb_gemm.native_plan`), so the JAX package's
``u``/``v``/``k`` tile grid, its VMEM budget and its VMEM estimators have
no counterpart: the only tile left to choose is ``b``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.notation import CaseKind, ContractionSpec, parse_spec
from repro_torch.core.planner import Plan, make_plan
from repro_torch.kernels.ops import EXT_BATCH_TILE, plan_roles

__all__ = [
    "BACKENDS",
    "Candidate",
    "EXT_BRICK_GRID",
    "default_backends",
    "enumerate_candidates",
    "enumerate_grouped_candidates",
    "split_key",
    "validate_tiles",
]

#: the port's candidate backends: library GEMMs and the hand-written kernel
BACKENDS = ("torch", "kernel")

#: brick depths tried for exceptional plans (the extended-transpose 3D
#: tile of the stride-1-batched operand, paper §III-E): one, since the
#: card's kernel takes its tile from the layout and more depths would be
#: identical launches
EXT_BRICK_GRID = (EXT_BATCH_TILE,)

_ROLE_NAMES = ("u", "v", "k", "b")


def split_key(key: str, foreign: tuple[str, ...] = ()) -> tuple:
    """``"backend:strategy[r=t,...]"`` → ``(backend, strategy, tiles)``;
    ``backend`` must be one of :data:`BACKENDS` or ``foreign``.  Raises
    ``ValueError`` for anything else."""
    tiles: tuple[tuple[str, int], ...] = ()
    if "[" in key:
        key, _, body = key.partition("[")
        body = body.rstrip("]")
        tiles = tuple(
            (r, int(t)) for r, t in (item.split("=") for item in body.split(","))
        )
    backend, _, strategy = key.partition(":")
    if not strategy or backend not in BACKENDS + tuple(foreign):
        raise ValueError(f"malformed candidate key {key!r}")
    return backend, strategy, tiles


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One executable configuration: how to run a contraction.

    ``tiles`` is a sorted item tuple (hashable; empty for the ``torch``
    backend) of role→tile overrides: only ``b`` exists here.
    """

    strategy: str                               # auto | batched | direct | native
    backend: str                                # torch | kernel
    tiles: tuple[tuple[str, int], ...] = ()

    @property
    def tiles_dict(self) -> dict:
        return dict(self.tiles)

    def key(self) -> str:
        """Stable string form used as the cache's result key."""
        base = f"{self.backend}:{self.strategy}"
        if self.tiles:
            body = ",".join(f"{r}={t}" for r, t in self.tiles)
            base += f"[{body}]"
        return base

    @classmethod
    def from_key(cls, key: str) -> "Candidate":
        backend, strategy, tiles = split_key(key)
        return cls(strategy=strategy, backend=backend, tiles=tiles)


def validate_tiles(tiles: dict) -> None:
    """Validate a user/tuner tile override; raises ``ValueError``.

    Keys must be kernel roles (``u``/``v``/``k``/``b``) and values
    positive ints.  Only ``b`` — the brick depth a block walks along the
    plan's batch mode — can be chosen: ``native_gemm`` fixes its ``u``,
    ``v`` and ``k`` tiles from the layout, so overriding one raises.
    """
    bad = set(tiles) - set(_ROLE_NAMES)
    if bad:
        raise ValueError(
            f"unknown tile roles {sorted(bad)}; valid roles are {_ROLE_NAMES}"
        )
    for role, t in tiles.items():
        if not isinstance(t, int) or isinstance(t, bool) or t < 1:
            raise ValueError(f"tile {role}={t!r} must be a positive int")
    fixed = sorted(set(tiles) & {"u", "v", "k"})
    if fixed:
        raise ValueError(
            f"tiles {fixed} cannot be overridden: native_gemm fixes its u/v/k "
            f"tiles from the layout (its route, repro_torch.kernels.sb_gemm."
            f"native_plan, and that route's launch pick them per shape); only "
            f"the brick depth b can be chosen"
        )


def enumerate_grouped_candidates(problems) -> list[Candidate]:
    """Execution candidates for one grouped-GEMM call over ``problems``.

    ``problems`` is the per-group shape list (only its non-emptiness
    matters).  The grouped kernel's tiles are fixed per route
    (:data:`~repro_torch.kernels.grouped_gemm.KERNEL_TILES`), so there is
    one kernel candidate, ``Candidate("grouped", "kernel")``, beside the
    per-group ``torch.matmul`` loop, ``Candidate("grouped", "torch")``.
    """
    if not problems:
        raise ValueError("need at least one group")
    return [Candidate("grouped", "torch"), Candidate("grouped", "kernel")]


def default_backends() -> tuple[str, ...]:
    """Backends worth measuring on this host: both on a card, ``torch``
    alone on the CPU, where the kernel backend is the kernel's plain
    version and never worth a measurement.  Pass ``backends=`` explicitly
    to override (tests do)."""
    import torch

    return BACKENDS if torch.cuda.is_available() else ("torch",)


def _plans_differ(p: Plan, q: Plan) -> bool:
    return (p.kind, p.flatten_groups, p.sb_batch, p.nested) != (
        q.kind, q.flatten_groups, q.sb_batch, q.nested
    )


def enumerate_candidates(
    spec: str | ContractionSpec,
    dims: dict,
    *,
    backends: tuple[str, ...] | None = None,
) -> list[Candidate]:
    """All legal execution candidates for ``spec`` at ``dims``.

    ``torch`` candidates: ``"auto"`` (Algorithm 2 with flattening),
    ``"batched"`` (only when it plans differently from auto), and
    ``"direct"``.  ``kernel`` candidates: each distinct plan with a role
    lowering (at each :data:`EXT_BRICK_GRID` depth where it is
    exceptional), plus ``"native"``, which is legal for every non-scalar
    spec.  Unlike the JAX package's, the set takes no dtype: no candidate
    has a memory budget to fit.
    """
    cs = parse_spec(spec) if isinstance(spec, str) else spec
    if backends is None:
        backends = default_backends()

    if not cs.c_modes or not cs.a_modes or not cs.b_modes:
        # scalar input/output: no matrix core exists — direct is the only
        # evaluation (and the planner would reject the spec).
        return [Candidate("direct", "torch")]

    plan_auto = make_plan(cs, dims)
    plan_noflat = make_plan(cs, dims, allow_flatten=False)
    differ = _plans_differ(plan_auto, plan_noflat)

    out = [Candidate("auto", "torch")]
    if differ:
        out.append(Candidate("batched", "torch"))
    out.append(Candidate("direct", "torch"))

    if "kernel" in backends:
        strat_plans = [("auto", plan_auto)]
        if differ:
            strat_plans.append(("batched", plan_noflat))
        for strategy, plan in strat_plans:
            if plan_roles(plan) is None:
                continue  # no role lowering: execute_plan would run native
            if plan.kind == CaseKind.EXCEPTIONAL:
                out += [Candidate(strategy, "kernel", (("b", b),))
                        for b in EXT_BRICK_GRID]
            else:
                out.append(Candidate(strategy, "kernel"))
        out.append(Candidate("native", "kernel"))
    return out
