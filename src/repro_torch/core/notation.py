"""Mode algebra and layout rules for tensor-contraction planning.

Terminology follows the paper (Shi et al., 2016), transposed to PyTorch's
row-major world:

* a *mode* is a named tensor axis (one lowercase letter);
* the *minor-most* axis of a row-major array is its **last** axis (stride 1).
  The paper stores tensors column-major, where the stride-1 mode is the
  *first*; every layout rule below is the row-major mirror of the paper's
  (reverse the mode string to move between conventions);
* a *contracted* mode appears in both inputs and not in the output;
* a *batch* mode (paper: ``[i]``) appears in both an input and the output
  and is held fixed per GEMM of a batch;
* a *flattening* (paper: ``(ij)``) fuses adjacent modes into one logical
  mode; legal in packed row-major storage exactly when the modes are
  adjacent and ordered identically in every tensor where they appear.

The *no-last-mode rule* (paper: no-first-mode rule): the batch mode of a
StridedBatchedGEMM operand may not be that operand's minor-most axis —
batching there leaves matrices strided in both dims, which no BLAS/MXU tile
loader accepts.  Contractions that force this are *exceptional* and take the
extended-transpose kernel instead.
"""

from __future__ import annotations

import dataclasses
import string
from typing import Sequence

__all__ = [
    "ContractionSpec",
    "parse_spec",
    "to_row_major",
    "to_col_major",
    "flattenable_groups",
    "eligible_batch_modes",
    "CaseKind",
]

_VALID_MODES = set(string.ascii_letters)


@dataclasses.dataclass(frozen=True)
class ContractionSpec:
    """A single pairwise contraction ``C = A · B`` in einsum notation.

    Mode strings are row-major: last character is the minor-most axis.
    """

    a_modes: str
    b_modes: str
    c_modes: str

    # ------------------------------------------------------------------ sets
    @property
    def contracted(self) -> str:
        """Contracted modes, in A's order (paper: K = A ∩ B, minus output)."""
        shared = set(self.a_modes) & set(self.b_modes)
        return "".join(m for m in self.a_modes if m in shared and m not in set(self.c_modes))

    @property
    def batch(self) -> str:
        """Modes present in A, B *and* C (vmap-style batch candidates)."""
        return "".join(
            m for m in self.a_modes if m in set(self.b_modes) and m in set(self.c_modes)
        )

    @property
    def a_free(self) -> str:
        """A's free modes (in A but not B) — the GEMM's M-side candidates."""
        return "".join(m for m in self.a_modes if m not in set(self.b_modes))

    @property
    def b_free(self) -> str:
        """B's free modes (in B but not A) — the GEMM's N-side candidates."""
        return "".join(m for m in self.b_modes if m not in set(self.a_modes))

    @property
    def is_single_mode(self) -> bool:
        """True for the paper's Table II regime: exactly one contracted
        mode and no shared batch modes."""
        return len(self.contracted) == 1 and not self.batch

    def validate(self) -> None:
        """Raise ``ValueError`` for traces, invalid mode characters,
        output modes no input produces, or free modes missing from the
        output (pairwise contractions cannot sum a free mode away)."""
        for name, modes in (("A", self.a_modes), ("B", self.b_modes), ("C", self.c_modes)):
            if len(set(modes)) != len(modes):
                raise ValueError(f"repeated mode in {name}: {modes!r} (traces unsupported)")
            bad = set(modes) - _VALID_MODES
            if bad:
                raise ValueError(f"invalid mode chars in {name}: {sorted(bad)}")
        free = (set(self.a_modes) | set(self.b_modes)) - (
            set(self.a_modes) & set(self.b_modes) - set(self.c_modes)
        )
        if set(self.c_modes) - free:
            raise ValueError(
                f"output modes {set(self.c_modes) - free} not produced by inputs"
            )
        missing = (set(self.a_free) | set(self.b_free)) - set(self.c_modes)
        if missing:
            raise ValueError(f"free modes {sorted(missing)} missing from output")

    # ----------------------------------------------------------------- misc
    def spec_str(self) -> str:
        return f"{self.a_modes},{self.b_modes}->{self.c_modes}"

    def reversed(self) -> "ContractionSpec":
        """Mirror between row-major and column-major conventions."""
        return ContractionSpec(self.a_modes[::-1], self.b_modes[::-1], self.c_modes[::-1])


def parse_spec(spec: str) -> ContractionSpec:
    """Parse ``"mk,knp->mnp"`` into a validated :class:`ContractionSpec`.

    Exactly two comma-separated operands and an explicit ``->`` output are
    required (n-ary and implicit-output specs belong to
    :func:`repro_torch.core.einsum.parse_nary`).  Raises ``ValueError`` for
    malformed specs, traces (a mode repeated within one operand), output
    modes no input produces, or free modes missing from the output.
    """
    try:
        inputs, out = spec.replace(" ", "").split("->")
        a, b = inputs.split(",")
    except ValueError as e:
        raise ValueError(f"spec must look like 'ab,bc->ac', got {spec!r}") from e
    cs = ContractionSpec(a, b, out)
    cs.validate()
    return cs


def to_row_major(paper_spec: str) -> str:
    """Convert a paper-notation (column-major) spec to row-major.

    The paper stores tensors column-major (stride-1 mode first); JAX is
    row-major (stride-1 mode last).  Reversing every mode string maps one
    convention's memory layout onto the other, so a Table II case keeps
    its classification (flattenable / sb-batchable / exceptional) across
    the conversion.
    """
    return parse_spec(paper_spec).reversed().spec_str()


def to_col_major(row_spec: str) -> str:
    """Inverse of :func:`to_row_major` (the mirror is an involution)."""
    return to_row_major(row_spec)


# --------------------------------------------------------------------------
# Layout rules
# --------------------------------------------------------------------------

def flattenable_groups(spec: ContractionSpec) -> list[str]:
    """Maximal groups of ≥2 modes that can be fused into one logical mode.

    Row-major packed storage: modes may fuse iff they are *adjacent and in
    identical order* in every tensor in which any of them appears (paper
    rule 2: ``ld<j> = ld<i>·dim<i>``, plus rule 3: the same flattening must
    appear on both sides).  Contracted modes may fuse with contracted modes,
    free modes with free modes of the same tensor.
    """
    groups: list[str] = []
    # candidate seeds: consecutive pairs in C (free flattening) or in the
    # contracted string as it appears in A (contraction flattening).
    for tensor_modes, domain in ((spec.c_modes, "free"), (spec.contracted, "contracted")):
        i = 0
        while i < len(tensor_modes) - 1:
            j = i + 1
            while j < len(tensor_modes) and _adjacent_everywhere(
                spec, tensor_modes[i : j + 1]
            ):
                j += 1
            if j - i >= 2:
                groups.append(tensor_modes[i:j])
                i = j
            else:
                i += 1
    return groups


def _adjacent_everywhere(spec: ContractionSpec, group: str) -> bool:
    """True iff *group* appears as a contiguous, same-order substring in
    every tensor that mentions any of its modes."""
    gset = set(group)
    for modes in (spec.a_modes, spec.b_modes, spec.c_modes):
        if gset & set(modes):
            if not gset <= set(modes):
                return False  # split across tensors → cannot fuse
            if group not in modes:
                return False
    return True


@dataclasses.dataclass(frozen=True)
class BatchModeInfo:
    mode: str
    #: positions (tensor, axis) — for the planner's locality heuristics
    a_axis: int | None
    b_axis: int | None
    c_axis: int
    #: True if sb_gemm may batch this mode (no-last-mode rule holds for
    #: every operand of order ≥ 3 that contains it; order-2 operands with
    #: the mode become *broadcast* (loa=0) or vector batches)
    sb_legal: bool
    #: True if batching here degrades the per-batch kernel to a GEMV
    #: (one of the remaining operand views is a vector)
    gemv_degrade: bool


def eligible_batch_modes(
    spec: ContractionSpec, dims: dict[str, int] | None = None
) -> list[BatchModeInfo]:
    """Enumerate modes that could serve as the sb_gemm batch loop.

    A mode is a batch candidate if it is *free* (appears in exactly one
    input and the output) or a *shared batch* mode (in both inputs and the
    output).  Legality per the no-last-mode rule is computed against each
    tensor that carries the mode; the output tensor C must also not be
    batched in its minor-most axis (paper rule 1 applied to C's layout).
    Candidates are sorted by the paper's heuristic: legal first, then
    larger dimension first (ties: later C axis first — §IV-B2 found
    batching the last output mode fastest for small tensors).
    """
    out: list[BatchModeInfo] = []
    for mode in spec.c_modes:
        a_ax = spec.a_modes.index(mode) if mode in spec.a_modes else None
        b_ax = spec.b_modes.index(mode) if mode in spec.b_modes else None
        c_ax = spec.c_modes.index(mode)
        legal = True
        gemv = False
        for modes, ax in ((spec.a_modes, a_ax), (spec.b_modes, b_ax)):
            if ax is None:
                continue
            if len(modes) >= 3 and ax == len(modes) - 1:
                legal = False  # no-last-mode rule on an order-≥3 operand
            if len(modes) == 2:
                gemv = True  # batching strips the matrix down to a vector
        if len(spec.c_modes) >= 3 and c_ax == len(spec.c_modes) - 1:
            legal = False  # C would be strided in both matrix dims
        out.append(BatchModeInfo(mode, a_ax, b_ax, c_ax, legal, gemv))

    def key(info: BatchModeInfo):
        dim = (dims or {}).get(info.mode, 0)
        return (not info.sb_legal, info.gemv_degrade, -dim, -info.c_axis)

    return sorted(out, key=key)


class CaseKind:
    """Classification labels for Table II (and the general planner)."""

    FLAT_GEMM = "flat_gemm"          # single flattened GEMM
    SB_GEMM = "sb_gemm"              # single StridedBatchedGEMM
    EXCEPTIONAL = "exceptional"      # needs the extended-transpose kernel
    NESTED = "nested"                # outer loop over extra batch modes
