"""The launch plans of ``native_gemm``'s ``wgmma``, ``batched``,
``gathered`` and ``fbatched`` routes, evaluated on the CPU through their
own addressing: what the kernel reads and where it writes, without the
card."""

import torch

from repro_torch.kernels.sb_gemm import FBATCHED_BK, SUM_CHUNK


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
    """C of a ``wgmma``, ``batched``, ``gathered`` or ``fbatched`` plan of
    A and B, in float64 (``fbatched``: see :func:`emulate_fbatched`,
    ``gathered``: :func:`emulate_gathered`).  ``wgmma`` and ``batched``: at
    every grid index, X's (M, K) and W's (K, N) as ``as_strided`` views at
    the grid offsets (and at each outer contracted index's), one matmul per
    split and outer index, summed in the kernel's order, stored to C's rows
    at the grid offset.  Every value a bf16 product of small integers sums
    exactly, so on such operands this equals ``native_gemm_ref`` bit for
    bit wherever the plan addresses the right elements."""
    if plan["kind"] == "fbatched":
        return emulate_fbatched(plan, A, B, c_shape)
    if plan["kind"] == "gathered":
        return emulate_gathered(plan, A, B, c_shape)
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


def fbatched_sum_order(plan):
    """How an ``fbatched`` plan adds up each output, as ``fb_kernel`` and
    ``fb_reduce`` do: a leaf ``(a, b)`` is one FMA walk from 0 over the
    stages ``a .. b - 1`` of the flattened contraction, ``("+", x, y)``
    the float32 sum ``x + y``.  A chunked walk adds each chunk's walk to a
    running sum at the chunk's end and the rest after the last; the
    reduction adds the splits' sums in split order.  0 (a walk of no stage,
    a sum's start) is left out: no walk or sum of walks from 0 is -0, so
    adding 0 moves no bit.  Two plans whose orders are equal give an
    output the same bits on any data."""
    def add(x, y):
        return y if x == 0 else x if y == 0 else ("+", x, y)

    chunk = SUM_CHUNK // FBATCHED_BK
    total = 0
    for s in range(plan["n_split"]):
        t0 = s * plan["spc"]
        t1 = min(t0 + plan["spc"], plan["steps"])
        if plan["chunked"]:
            run, a = 0, t0
            for b in range(t0 + chunk, t1 + 1, chunk):
                run, a = add(run, (a, b)), b
            part = add(run, (a, t1) if a < t1 else 0)
        else:
            part = (t0, t1) if t0 < t1 else 0
        total = add(total, part)
    return total


def emulate_fbatched(plan, A, B, c_shape):
    """C of an ``fbatched`` plan, in float64, summed in the kernel's order
    (:func:`fbatched_sum_order`): at every grid index (offsets from X, W
    or both), each walk of ``FBATCHED_BK``-deep stages along k at each
    outer index (outer index slowest, its first mode fastest), X's (M, K)
    and W's (K, N) read as ``as_strided`` views at the grid and outer
    offsets, and C's (M, N) stored at the grid offset with C's strides of
    m and n."""
    X, W = (A, B) if plan["x_is_a"] else (B, A)
    C = torch.full(c_shape, float("nan"), dtype=torch.float64)
    M, N, K = plan["M"], plan["N"], plan["K"]
    per_k = -(-K // FBATCHED_BK)
    outer = _offsets(plan["outer"], 2)
    order = fbatched_sum_order(plan)
    for xg, wg, cg in _offsets(plan["grid"], 3):
        def walk(a, b):
            part = torch.zeros(M, N, dtype=torch.float64)
            for t in range(a, b):
                o, stage = divmod(t, per_k)
                xo, wo = outer[o]
                ks = slice(stage * FBATCHED_BK, min((stage + 1) * FBATCHED_BK, K))
                x = torch.as_strided(X, (M, K), (plan["xm"], plan["xk"]),
                                     X.storage_offset() + xg + xo)
                w = torch.as_strided(W, (K, N), (plan["wk"], plan["wn"]),
                                     W.storage_offset() + wg + wo)
                part += x[:, ks].double() @ w[ks].double()
            return part

        def value(node):
            if node == 0:
                return torch.zeros(M, N, dtype=torch.float64)
            return value(node[1]) + value(node[2]) if node[0] == "+" else walk(*node)

        torch.as_strided(C, (M, N), (plan["cm"], plan["cn"]), cg).copy_(value(order))
    return C


def emulate_gathered(plan, A, B, c_shape):
    """C of a ``gathered`` plan, in float64: at every grid index (offsets
    from X, W or both, the first grid mode fastest, as the kernel decodes
    the block index), the sum over every outer index (the first outer mode
    fastest) of X's (M, K) times W's (K, N), each an ``as_strided`` view at
    the grid and outer offsets, stored to C's (M, N) at the grid offset
    with C's strides of m and n.  The kernel's stages walk the same
    elements, NM_BK of k at a time, with wgmma's sums, so on small-integer
    operands this equals ``native_gemm_ref`` bit for bit wherever the
    plan addresses the right elements."""
    X, W = (A, B) if plan["x_is_a"] else (B, A)
    C = torch.full(c_shape, float("nan"), dtype=torch.float64)
    M, N, K = plan["M"], plan["N"], plan["K"]
    outer = _offsets(plan["outer"], 2)
    for xg, wg, cg in _offsets(plan["grid"], 3):
        acc = torch.zeros(M, N, dtype=torch.float64)
        for xo, wo in outer:
            x = torch.as_strided(X, (M, K), (plan["xm"], plan["xk"]),
                                 X.storage_offset() + xg + xo)
            w = torch.as_strided(W, (K, N), (plan["wk"], plan["wn"]),
                                 W.storage_offset() + wg + wo)
            acc += x.double() @ w.double()
        torch.as_strided(C, (M, N), (plan["cm"], plan["cn"]), cg).copy_(acc)
    return C
