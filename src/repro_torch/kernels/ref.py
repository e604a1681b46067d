"""Plain float32 oracle for the port's kernel tests.

Every kernel of the port is checked against this reference on the CPU
(through the kernels' plain versions) and, in ``chip_smoke.py``, on the
card.  It is for tests only: no library path calls it.
"""

from __future__ import annotations

import torch

__all__ = ["ref_contract"]


def ref_contract(spec: str, A, B, out_dtype=None):
    """Oracle for any pairwise contraction: ``torch.einsum`` in float32.

    Inputs are upcast first (exact for float32 and bfloat16), and the
    result is cast to ``out_dtype`` (default: the promoted operand dtype).
    """
    out = torch.einsum(spec, A.float(), B.float())
    return out.to(out_dtype or torch.promote_types(A.dtype, B.dtype))
