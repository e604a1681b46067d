"""Extended-transpose configuration — the paper's exceptional-case primitive.

Eight of the 36 Table II contractions force the batch walk onto an
operand's stride-1 mode ("no-first-mode rule" violations, §III-E).  The
paper's fix is an extended ``op`` parameter whose implementation "performs
a 3D tiling of B into cache".  On Hopper the native kernel
(:func:`repro_torch.kernels.sb_gemm.native_gemm`) already reads any
operand through its strides, and on the card its tile comes from the
operands' layout alone: float32 and mixed operands take the ``fbatched``
route, bf16 ones ``batched`` where a tensor map reads them and
``gathered`` where none does, each picking its tile and walk from the
strides (``native_plan``).  ``batch_tile``, the number of consecutive
indices of the planner-chosen batch mode β one block walks in the JAX
package, is kept and checked (a positive int), and shapes no launch.

Like its JAX counterpart this is the paper-named entry point kept for the
§III-E benchmarks and the tests that pin it; ``contract(...,
strategy="native")`` reaches the same kernel for any spec.
"""

from __future__ import annotations

from repro_torch.core.notation import CaseKind
from repro_torch.core.planner import make_plan
from repro_torch.kernels.ops import EXT_BATCH_TILE, sb_contract

__all__ = ["ext_gemm", "EXT_BATCH_TILE"]


def ext_gemm(spec: str, A, B, *, batch_tile: int = EXT_BATCH_TILE,
             out_dtype=None):
    """Evaluate an exceptional-case contraction in one kernel launch.

    ``spec`` must plan as exceptional (e.g. the row-major mirrors of
    Table II cases 3.4/3.6/4.4/4.6/5.4/5.6/6.4/6.6); other specs raise.
    """
    dims = {}
    a_modes, rest = spec.replace(" ", "").split(",")
    b_modes, c_modes = rest.split("->")
    for modes, x in ((a_modes, A), (b_modes, B)):
        for m, d in zip(modes, x.shape):
            dims[m] = d
    plan = make_plan(spec, dims, allow_flatten=False)
    if plan.kind != CaseKind.EXCEPTIONAL:
        raise ValueError(f"{spec} is not exceptional (planned as {plan.kind})")
    u, v, k = plan.gemm_modes
    roles = {k: "k", v: "v", plan.sb_batch: "b"}
    if u:
        roles[u] = "u"
    if plan.nested:
        raise NotImplementedError("nest ext_gemm via ops.execute_plan")
    return sb_contract(
        plan.fspec.a_modes, plan.fspec.b_modes, plan.fspec.c_modes, A, B,
        roles=roles, tiles={"b": batch_tile}, out_dtype=out_dtype,
    )
