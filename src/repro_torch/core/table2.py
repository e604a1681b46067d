"""Table II of the paper: all 36 single-mode contractions C_mnp = A·B
between a second-order A and third-order B, in paper (column-major)
notation, with the paper's classification.

* ``FLAT`` cases (8):  1.1 1.5 2.1 2.5 5.1 5.5 6.1 6.5 — single flattened GEMM.
* ``EXC`` cases (8):   3.4 3.6 4.4 4.6 5.4 5.6 6.4 6.6 — exceptional
  (extended-transpose kernel).
* all 28 non-exceptional cases admit a single StridedBatchedGEMM.

``row_major()`` converts a case to the JAX-layout-equivalent spec by
reversing every mode string (column-major stride-1-first ↔ row-major
stride-1-last).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.notation import parse_spec, to_row_major

__all__ = ["Case", "CASES", "FLAT_CASES", "EXCEPTIONAL_CASES", "case"]

# A forms indexed 1..6 and B mode orders indexed 1..6, as laid out in the
# paper's Table II.
_A_FORMS = {1: "mk", 2: "km", 3: "nk", 4: "kn", 5: "pk", 6: "kp"}


def _b_forms(a_form: str) -> list[str]:
    free = [m for m in "mnp" if m not in a_form]  # the two C modes not in A
    x, y = free
    return [f"k{x}{y}", f"k{y}{x}", f"{x}k{y}", f"{y}k{x}", f"{x}{y}k", f"{y}{x}k"]


FLAT_CASES = {"1.1", "1.5", "2.1", "2.5", "5.1", "5.5", "6.1", "6.5"}
EXCEPTIONAL_CASES = {"3.4", "3.6", "4.4", "4.6", "5.4", "5.6", "6.4", "6.6"}


@dataclasses.dataclass(frozen=True)
class Case:
    label: str            # e.g. "1.3"
    paper_spec: str       # column-major, e.g. "mk,nkp->mnp"
    flattenable: bool
    exceptional: bool

    def row_major(self) -> str:
        """The layout-equivalent spec for row-major JAX arrays."""
        return to_row_major(self.paper_spec)

    @property
    def sb_ok(self) -> bool:
        return not self.exceptional


def _build() -> dict[str, Case]:
    out: dict[str, Case] = {}
    for i, a_form in _A_FORMS.items():
        for j, b_form in enumerate(_b_forms(a_form), start=1):
            label = f"{i}.{j}"
            spec = f"{a_form},{b_form}->mnp"
            parse_spec(spec)  # sanity
            out[label] = Case(
                label=label,
                paper_spec=spec,
                flattenable=label in FLAT_CASES,
                exceptional=label in EXCEPTIONAL_CASES,
            )
    return out


CASES: dict[str, Case] = _build()


def case(label: str) -> Case:
    return CASES[label]
