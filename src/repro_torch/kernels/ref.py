"""Plain float32 oracle for the port's kernel tests.

Every kernel of the port is checked against this reference on the CPU
(through the kernels' plain versions) and, in ``chip_smoke.py``, on the
card.  It is for tests only: no library path calls it.
"""

from __future__ import annotations

import torch

__all__ = ["ref_contract", "ref_sb_gemm", "ref_ext_gemm", "ref_grouped_gemm"]


def ref_contract(spec: str, A, B, out_dtype=None):
    """Oracle for any pairwise contraction: ``torch.einsum`` in float32.

    Inputs are upcast first (exact for float32 and bfloat16), and the
    result is cast to ``out_dtype`` (default: the promoted operand dtype).
    """
    out = torch.einsum(spec, A.float(), B.float())
    return out.to(out_dtype or torch.promote_types(A.dtype, B.dtype))


def ref_sb_gemm(A, B, *, spec: str, out_dtype=None):
    """Oracle for the StridedBatchedGEMM kernel (same einsum semantics —
    the kernel's whole point is computing this without data movement)."""
    return ref_contract(spec, A, B, out_dtype)


def ref_ext_gemm(A, B, *, spec: str, out_dtype=None):
    """Oracle for the extended-transpose (exceptional-case) kernel."""
    return ref_contract(spec, A, B, out_dtype)


def ref_grouped_gemm(As, Bs, *, trans_a=False, trans_b=False, out_dtype=None):
    """Oracle for the grouped kernel: per-group f32 einsum, any layout.

    ``trans_a``/``trans_b`` follow the descriptor-table convention of
    :func:`repro_torch.kernels.grouped_gemm.pack_groups`: a flagged operand
    is *stored* transposed (``A (k, m)`` / ``B (n, k)``) and contracted as
    its logical orientation.  Scalars broadcast over groups.  Zero-size
    groups yield the exact empty/zero result (``k == 0`` → zeros).
    """
    def flags(flag, n):
        return [bool(flag)] * n if isinstance(flag, (bool, int)) else [
            bool(f) for f in flag]

    ta, tb = flags(trans_a, len(As)), flags(trans_b, len(Bs))
    out = []
    for g, (A, B) in enumerate(zip(As, Bs)):
        spec = ("ka" if ta[g] else "ak") + "," + ("bk" if tb[g] else "kb") \
            + "->ab"
        out.append(ref_contract(spec, A, B, out_dtype))
    return out
