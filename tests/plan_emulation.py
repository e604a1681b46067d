"""The launch plans of ``native_gemm``'s ``wgmma`` and ``batched`` routes,
evaluated on the CPU through their own addressing: what the kernel reads
and where it writes, without the card."""

import torch


def _offsets(modes, tensors):
    """The offsets in ``tensors`` tensors of every index of ``modes``
    (extent, then one stride per tensor), the first mode fastest, as the
    kernel decodes them."""
    offsets = [(0,) * tensors]
    for ext, *strides in modes:
        offsets = [tuple(o + i * s for o, s in zip(off, strides)) for i in range(ext)
                   for off in offsets]
    return offsets


def emulate(plan, A, B, c_shape):
    """C of a ``wgmma`` or ``batched`` plan of A and B, in float64: at
    every grid index, X's (M, K) and W's (K, N) as ``as_strided`` views at
    the grid offsets (and at each outer contracted index's), one matmul per
    split and outer index, summed in the kernel's order, stored to C's rows
    at the grid offset.  Every value a bf16 product of small integers sums
    exactly, so on such operands this equals ``native_gemm_ref`` bit for
    bit wherever the plan addresses the right elements."""
    X, W = (A, B) if plan["x_is_a"] else (B, A)
    C = torch.full(c_shape, float("nan"), dtype=torch.float64)
    M, N, K = plan["M"], plan["N"], plan["K"]
    outer = _offsets(plan["outer"], 2)
    for xg, wg, cg in _offsets(plan["grid"], 3):
        acc = torch.zeros(M, N, dtype=torch.float64)
        for s in range(plan["n_split"]):
            ks = slice(s * plan["kc"], (s + 1) * plan["kc"])
            part = torch.zeros(M, N, dtype=torch.float64)
            for xo, wo in outer:
                x = torch.as_strided(X, (M, K), (plan["xm"], plan["xk"]),
                                     X.storage_offset() + xg + xo)
                w = torch.as_strided(W, (K, N), (plan["wk"], plan["wn"]),
                                     W.storage_offset() + wg + wo)
                part += x[:, ks].double() @ w[ks].double()
            acc += part
        torch.as_strided(C, (M, N), (plan["ldc"], 1), cg).copy_(acc)
    return C
