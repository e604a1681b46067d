"""Contraction planner — the paper's Algorithm 2 in row-major form.

Given a pairwise contraction spec and mode dimensions, produce a
:class:`Plan` describing how to evaluate it *without data movement*:

1. **Flatten** maximal adjacent mode groups (paper heuristic 1: a single
   large GEMM beats everything).
2. If what remains is matrix × matrix → ``FLAT_GEMM``.
3. Otherwise pick the GEMM modes (the minor-most output mode plus one free
   mode of the other operand) and classify every remaining output mode as a
   batch mode.  The largest-dimension batch mode runs inside
   StridedBatchedGEMM; the rest are nested loops (paper Listing 2).
4. If the no-last-mode rule cannot be satisfied (row-major mirror of the
   paper's no-first-mode rule) the case is **exceptional** and is routed to
   the extended-transpose kernel (paper §III-E).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.notation import (
    CaseKind,
    ContractionSpec,
    flattenable_groups,
    parse_spec,
)

__all__ = [
    "Plan",
    "make_plan",
    "modes_size",
    "contraction_flops",
]


@dataclasses.dataclass(frozen=True)
class Plan:
    spec: ContractionSpec                 # original (row-major) spec
    fspec: ContractionSpec                # spec after flattening (renamed modes)
    kind: str                             # CaseKind.*
    flatten_groups: tuple[str, ...]       # groups fused, e.g. ("np",)
    dims: dict                            # mode -> size (original modes)
    fdims: dict                           # mode -> size (flattened modes)
    #: GEMM core modes: (u, v, k) — v is C's minor-most mode, u the other
    #: free GEMM mode, k the (fused) contracted mode.  None for pure GEMM
    #: specs where the core is the whole problem.
    gemm_modes: tuple[str, str, str] | None
    #: mode batched inside the strided-batched kernel ('' if none)
    sb_batch: str
    #: outer nested batch modes, outermost first ('' if none)
    nested: str
    notes: str = ""
    #: copy/permute decision of the chosen executor path ('' = no data
    #: movement anywhere).  Exceptional plans always set this, so a test
    #: failure's plan repr shows whether a pre-permute was inserted —
    #: previously the plan printed identically either way.
    copies: str = ""

    @property
    def batch_modes(self) -> str:
        return self.nested + self.sb_batch

    def describe(self) -> str:
        parts = [f"{self.spec.spec_str()} [{self.kind}]"]
        if self.flatten_groups:
            parts.append(f"flatten={','.join('(' + g + ')' for g in self.flatten_groups)}")
        if self.sb_batch:
            parts.append(f"sb_batch=[{self.sb_batch}]")
        if self.nested:
            parts.append(f"nested={self.nested}")
        if self.notes:
            parts.append(self.notes)
        if self.copies:
            parts.append(f"copies={self.copies}")
        return " ".join(parts)


# --------------------------------------------------------------------------
# Cost model (used by the n-ary path optimizer and the fig10 benchmark)
# --------------------------------------------------------------------------

def modes_size(modes: str, dims: dict) -> int:
    """Element count of a tensor with the given mode string (1 for scalars)."""
    size = 1
    for m in modes:
        size *= dims[m]
    return size


def contraction_flops(spec: str | ContractionSpec, dims: dict) -> int:
    """Flop estimate for one pairwise contraction: ``2·∏ dims`` over every
    distinct mode the contraction touches (one multiply + one add per term
    of the inner sum — the standard einsum cost model).

    This is the quantity the n-ary path optimizer minimises; it is also what
    the paper's arithmetic-intensity analysis (§II-B) uses as the numerator.
    """
    cs = parse_spec(spec) if isinstance(spec, str) else spec
    return 2 * modes_size("".join(dict.fromkeys(cs.a_modes + cs.b_modes)), dims)


def _apply_flattening(spec: ContractionSpec, groups: list[str], dims: dict):
    """Rename each flattened group to its leading mode, fusing dims."""
    fdims = dict(dims)

    def rename(modes: str) -> str:
        out = modes
        for g in groups:
            if g in out:
                out = out.replace(g, g[0])
        return out

    for g in groups:
        size = 1
        for m in g:
            size *= dims[m]
            fdims.pop(m, None)
        fdims[g[0]] = size
    fspec = ContractionSpec(rename(spec.a_modes), rename(spec.b_modes), rename(spec.c_modes))
    return fspec, fdims


def _view_is_matrix(operand_modes: str, view: set[str]) -> tuple[bool, bool]:
    """Return (valid_matrix, gemv_degrade) for a per-batch view of an operand.

    ``view`` holds the modes kept un-batched.  The view is a legal strided
    matrix iff the operand's minor-most (last) mode is in the view — the
    row-major no-last-mode rule.  If the view has <2 modes the per-batch
    kernel degrades to GEMV/DOT.
    """
    kept = [m for m in operand_modes if m in view]
    if len(kept) < 2:
        return True, True  # vector view — GEMV territory
    valid = operand_modes[-1] in view
    return valid, False


def make_plan(
    spec: str | ContractionSpec,
    dims: dict,
    *,
    allow_flatten: bool = True,
    force_batch: str | None = None,
    mesh=None,
    in_specs=None,
) -> Plan:
    """Plan a pairwise contraction.  ``dims`` maps every mode to its size.

    ``force_batch`` pins the sb_gemm batch mode (used by the Fig. 5/6
    benchmarks that compare batching the last vs. the middle output mode).

    ``mesh``/``in_specs`` (sharded planning) are not ported yet and raise
    ``NotImplementedError`` (ROADMAP queue 1, item 12).
    """
    if mesh is not None or in_specs is not None:
        raise NotImplementedError(
            "sharded planning (mesh=/in_specs=) is not ported yet: "
            "ROADMAP queue 1, item 12")
    cs = parse_spec(spec) if isinstance(spec, str) else spec
    cs.validate()
    missing = (set(cs.a_modes) | set(cs.b_modes)) - set(dims)
    if missing:
        raise ValueError(f"dims missing for modes {sorted(missing)}")
    return _plan_local(cs, dims, allow_flatten=allow_flatten, force_batch=force_batch)


def _plan_local(
    cs: ContractionSpec,
    dims: dict,
    *,
    allow_flatten: bool,
    force_batch: str | None,
) -> Plan:
    groups = flattenable_groups(cs) if allow_flatten else []
    fspec, fdims = _apply_flattening(cs, groups, dims)

    # ---- pure GEMM after flattening? -----------------------------------
    if len(fspec.a_modes) <= 2 and len(fspec.b_modes) <= 2 and not fspec.batch:
        kind = CaseKind.FLAT_GEMM
        return Plan(
            spec=cs, fspec=fspec, kind=kind, flatten_groups=tuple(groups),
            dims=dict(dims), fdims=fdims, gemm_modes=None, sb_batch="",
            nested="", notes="matrix-matrix core",
        )

    # ---- choose GEMM modes (u, v, k) -----------------------------------
    if not fspec.c_modes:
        raise ValueError("full contraction to scalar should be handled as DOT")
    v = fspec.c_modes[-1]  # C's minor-most mode must be a GEMM mode
    contracted = fspec.contracted
    kgroup = contracted  # multiple contracted modes stay grouped for XLA;
    # Pallas backends require len(kgroup) == 1 (checked by the executor).

    shared = set(fspec.batch)  # modes in A, B and C — always batch modes
    if v in shared:
        # C's minor axis is a shared batch mode: no matrix view of C
        # exists, whatever the other modes do — always the degenerate
        # (direct dot_general) route
        return _exceptional_plan(
            cs, fspec, groups, dims, fdims,
            reason="minor output mode is shared batch", degenerate=True,
        )

    v_in_a = v in fspec.a_modes
    owner_modes = fspec.a_modes if v_in_a else fspec.b_modes
    other_modes = fspec.b_modes if v_in_a else fspec.a_modes
    other_free = [m for m in other_modes if m in set(fspec.c_modes) and m not in shared]

    best: tuple | None = None
    for u in other_free or [""]:
        view_owner = set(kgroup) | {v}
        view_other = set(kgroup) | ({u} if u else set())
        ok_o, gemv_o = _view_is_matrix(owner_modes, view_owner)
        ok_t, gemv_t = _view_is_matrix(other_modes, view_other)
        if not (ok_o and ok_t):
            continue
        batch = [m for m in fspec.c_modes[:-1] if m not in {u, v}]
        if force_batch is not None and force_batch not in batch:
            continue
        # every batch mode must leave C a valid matrix view: v is minor ✓;
        # batch modes of an operand must not be its last mode (checked via
        # the views above since batched modes are simply "not in view").
        gemv = gemv_o or gemv_t
        score = (gemv, -(fdims.get(u, 1)))
        if best is None or score < best[0]:
            best = (score, u, batch, gemv)

    if best is None:
        return _exceptional_plan(cs, fspec, groups, dims, fdims, reason="no-last-mode rule unsatisfiable")

    _, u, batch, gemv = best
    if gemv and len(fspec.a_modes) >= 3 or gemv and len(fspec.b_modes) >= 3:
        # Batching collapsed an operand to vectors while a 3rd-order operand
        # remains: paper calls this the BATCHEDGEMV degradation → exceptional.
        return _exceptional_plan(cs, fspec, groups, dims, fdims, reason="degrades to BatchedGEMV")

    # Order batch modes: sb batch = largest dim (paper heuristic 2), with a
    # tie-break preferring later C axes (paper §IV-B2); the rest nest
    # outermost-first in C order.
    if batch:
        if force_batch is not None:
            sb = force_batch
        else:
            sb = max(batch, key=lambda m: (fdims[m], fspec.c_modes.index(m)))
        nested = "".join(m for m in fspec.c_modes if m in batch and m != sb)
    else:
        sb, nested = "", ""

    kind = CaseKind.SB_GEMM if sb else CaseKind.FLAT_GEMM
    if nested:
        kind = CaseKind.NESTED
    return Plan(
        spec=cs, fspec=fspec, kind=kind, flatten_groups=tuple(groups),
        dims=dict(dims), fdims=fdims, gemm_modes=(u, v, kgroup), sb_batch=sb,
        nested=nested, notes="",
    )


def _direct_copies(cs: ContractionSpec) -> str:
    """Copy decision of the XLA direct executor for ``cs``.

    ``_direct`` emits one ``dot_general`` whose output mode order is
    ``batch + a_free + b_free``; when that differs from the requested
    output a (lazy) permute is appended.  Degenerate exceptional plans
    execute through ``_direct`` on the XLA backend, so their plan repr
    must say which of the two happened (the Pallas backend lowers the
    same plan through the native-layout kernel — never a copy).
    """
    shared = cs.batch
    k = set(cs.contracted) | set(shared)
    a_free = "".join(m for m in cs.a_modes if m not in k)
    b_free = "".join(m for m in cs.b_modes if m not in k)
    natural = shared + a_free + b_free
    if natural == cs.c_modes:
        return "none"
    return f"xla:permute[{natural}->{cs.c_modes}] pallas:none"


def _exceptional_plan(
    cs, fspec, groups, dims, fdims, *, reason: str, degenerate: bool = False
) -> Plan:
    """Exceptional case: batching is forced into an operand's stride-1 mode.

    Mirror of paper §III-E.  The output's minor-most mode ``v`` stays a GEMM
    mode (so C tiles are written as regular matrices), and the batch runs
    over the *owner operand's own minor-most mode* β — which makes that
    operand's per-batch view strided in both matrix dims.  The extended
    kernel resolves this with a 3D VMEM brick of the offending operand
    (the paper's "3D tiling of B into cache").

    ``degenerate=True`` forces the no-matrix-view route regardless of β —
    used when C's minor mode is a shared batch mode, where no GEMM-mode
    assignment is coherent (found by the differential fuzzer: an
    in-output β used to slip past the β-based degeneracy test and build
    a nested plan that never batches the shared mode).
    """
    v = fspec.c_modes[-1]
    kgroup = fspec.contracted
    owner_modes = fspec.a_modes if v in fspec.a_modes else fspec.b_modes
    other_modes = fspec.b_modes if v in fspec.a_modes else fspec.a_modes
    beta = owner_modes[-1]  # the stride-1 mode that must carry the batch
    if degenerate or beta not in fspec.c_modes or beta == v:
        # Doubly-degenerate layout (e.g. C's minor mode is a shared batch
        # mode).  The XLA executor still evaluates it; Pallas falls back.
        u = next((m for m in fspec.c_modes[:-1]), "")
        nested = "".join(m for m in fspec.c_modes[:-1] if m != u)
        return Plan(
            spec=cs, fspec=fspec, kind=CaseKind.EXCEPTIONAL,
            flatten_groups=tuple(groups), dims=dict(dims), fdims=fdims,
            gemm_modes=(u, v, kgroup), sb_batch="", nested=nested + (u and ""),
            notes=f"exceptional(degenerate): {reason}",
            copies=_direct_copies(cs),
        )
    # u: a free GEMM mode from the other operand (must keep that operand's
    # view a legal matrix), preferring the largest dimension.  Shared batch
    # modes are not candidates — they appear in *both* operands, so using
    # one as a GEMM mode leaves it unbatched on the owner side (the
    # differential fuzzer caught exactly that); they nest as vmaps below.
    u_cands = []
    for m in other_modes:
        if m in set(fspec.c_modes) and m not in {v, beta} and m not in fspec.batch:
            ok, _ = _view_is_matrix(other_modes, set(kgroup) | {m})
            if ok:
                u_cands.append(m)
    u = max(u_cands, key=lambda m: fdims[m]) if u_cands else ""
    nested = "".join(m for m in fspec.c_modes if m not in {u, v, beta})
    return Plan(
        spec=cs, fspec=fspec, kind=CaseKind.EXCEPTIONAL,
        flatten_groups=tuple(groups), dims=dict(dims), fdims=fdims,
        gemm_modes=(u, v, kgroup), sb_batch=beta, nested=nested,
        notes=f"exceptional: {reason}; 3d-tiled operand carries [{beta}]",
        copies="none",
    )
