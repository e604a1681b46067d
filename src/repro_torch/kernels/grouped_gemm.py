"""Grouped (variable-batch) GEMM on Hopper: one launch over ragged groups.

The paper's STRIDEDBATCHEDGEMM walks ``P`` identically shaped problems at a
fixed stride; serving traffic is ragged (each request or expert brings its
own ``(m, n, k)``).  This module is the variable-batch extension, ported
from the JAX package's ``repro.kernels.grouped_gemm``: operands are packed
row-major into flat 2D buffers (each group padded only to its own tile
multiples) and an int32 descriptor row per group carries its padded
``(m, n, k)``, the row offsets of its A/B/C blocks and its operand layout
flags:

    desc[g] = (m_p, n_p, k_p, a_row_off, b_row_off, c_row_off,
               trans_a, trans_b)

A group whose A arrives stored ``(k, m)`` (or B stored ``(n, k)``) is read
in place: the kernel picks the transposed tile fetch per group.  Groups may
be empty: ``k == 0`` emits exact zeros, ``m == 0`` / ``n == 0`` has no
tiles.

:func:`grouped_gemm` launches the CUDA kernel in ``csrc/grouped_gemm.cu``,
the port of the TPU kernel ``grouped_gemm_pallas``, on one of two routes
that :func:`grouped_route` picks from dtype, pointers, strides and the
descriptor rows: ``"wgmma"`` (bf16 on the tensor cores, operands through a
TMA ring) or ``"fma"`` (f32 FMA, everything else).  The TPU grid is sized
by the largest group and predicates most blocks off; here the wrapper
builds each group's count of output tiles from the host-side descriptor
rows, and the kernel launches exactly one block per tile of some group.
:func:`grouped_gemm_packed_ref` is its plain PyTorch version (one f32
matmul per descriptor row); the wrapper takes it only for tensors on the
CPU, and a CUDA tensor launches the kernel or raises.
``grouped_gemm.launches`` counts launches, ``grouped_gemm.launches_by_route``
the launches of each route.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = [
    "GROUPED_DEFAULT_TILES",
    "DESC_FIELDS",
    "KERNEL_TILES",
    "FMA_DEPTH",
    "ROUTES",
    "WGMMA_DEPTH",
    "GroupProblem",
    "pack_groups",
    "packed_geometry",
    "grouped_gemm",
    "grouped_gemm_packed_ref",
    "grouped_gemm_ref",
    "fma_info",
    "grouped_route",
    "wgmma_info",
]

#: role → packing tile.  ``u`` stays at 8 so ragged groups pad by at most 7
#: rows; every tile is a multiple of 8 so that each group's block starts on
#: a 16-byte boundary of its rows (see :func:`grouped_gemm`).
GROUPED_DEFAULT_TILES = {"u": 8, "v": 128, "k": 128}

#: descriptor row layout (int32): padded dims, packed row offsets, and
#: per-group operand layout flags (1 = stored transposed).
DESC_FIELDS = ("m_p", "n_p", "k_p", "a_off", "b_off", "c_off",
               "trans_a", "trans_b")

ROUTES = ("wgmma", "fma")

#: each route's output tile (rows, columns); mirrors GW_TM/GW_TN and
#: GG_TU/GG_TV in ``csrc/grouped_gemm.cu``.  It need not equal the packing
#: tiles: the kernels mask to each group's ``m_p``/``n_p``.
KERNEL_TILES = {"wgmma": (128, 256), "fma": (64, 128)}

#: the wgmma route's depth per stage (GW_BK): every group with output tiles
#: must have ``k_p`` a multiple of it
WGMMA_DEPTH = 64

#: the fma route's depth per stage (GG_BK); its two stages of f32 slabs,
#: ``FMA_DEPTH`` rows of ``rows + 4`` and of ``columns + 4`` floats each,
#: are the kernel's static shared memory
FMA_DEPTH = 16

#: every extent and row width the kernel reads in 16-byte vectors of
#: float32 (4) or bfloat16 (8) must be a multiple of this
VECTOR_ELEMS = 8

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class GroupProblem:
    """Static shape record of one group: ``(m, k) @ (k, n)``.

    Zero-size dims are legal — an empty group (drained request slot,
    zero-length KV segment) packs to zero rows and launches no tile
    (``k == 0`` still emits exact zeros for its C block).
    """

    __slots__ = ("m", "n", "k")

    def __init__(self, m: int, n: int, k: int):
        if min(m, n, k) < 0:
            raise ValueError(f"group dims must be non-negative: {(m, n, k)}")
        self.m, self.n, self.k = int(m), int(n), int(k)

    def __repr__(self):
        return f"GroupProblem(m={self.m}, n={self.n}, k={self.k})"


def _norm_flags(flag, n: int, name: str) -> list[bool]:
    """Broadcast a scalar trans flag, or validate a per-group list."""
    if isinstance(flag, (bool, int)):
        return [bool(flag)] * n
    flags = [bool(f) for f in flag]
    if len(flags) != n:
        raise ValueError(f"{name} needs one flag per group: got {len(flags)} "
                         f"for {n} groups")
    return flags


def pack_groups(As, Bs, tiles: dict | None = None, *, trans_a=False,
                trans_b=False):
    """Pack per-group operands into flat buffers + a descriptor table.

    ``As[g]`` is ``(m_g, k_g)`` — or ``(k_g, m_g)`` where ``trans_a``
    flags group ``g``; ``Bs[g]`` is ``(k_g, n_g)`` — or ``(n_g, k_g)``
    under ``trans_b``.  The flags (scalar or per-group sequence) record
    each operand's *storage* layout; nothing is permuted here.  Each group
    is zero-padded to its tile multiples (exact for a contraction) and
    appended row-wise.

    The flat buffers are made on the operands' own device: a CUDA operand
    never passes through host memory.  Each buffer takes a number of
    device launches that does not grow with the number of groups: for each
    stored width the groups share, one row scatter (``index_copy_``) of
    their rows, taken as one view where they are consecutive row blocks of
    one tensor and else joined by one ``torch.cat``; only the bytes no
    group writes are zeroed.  Where an operand list already *is* its
    packed buffer — consecutive row blocks of one tensor, each at its
    padded extent and the packed width, as ``list(W)`` of a contiguous
    ``(E, k, n)`` expert weight tensor is under the default tiles — the
    buffer is a view of that storage and nothing is copied: it then
    aliases the inputs (``grouped_matmul`` only reads it).  The descriptor
    table is built on the host, from shapes, and stays there;
    :func:`grouped_gemm` copies it to the device with its tile list in one
    transfer.

    Returns ``(A_flat, B_flat, descs, problems)``: ``descs`` is the
    ``(G, 8)`` int32 CPU tensor of :data:`DESC_FIELDS`, ``problems`` the
    unpadded :class:`GroupProblem` list (needed to slice results back out).
    The table and the buffers equal the JAX package's.
    """
    tiles = {**GROUPED_DEFAULT_TILES, **(tiles or {})}
    if len(As) != len(Bs) or not As:
        raise ValueError("need one A and one B per group (at least one group)")
    G = len(As)
    ta = np.array(_norm_flags(trans_a, G, "trans_a"))
    tb = np.array(_norm_flags(trans_b, G, "trans_b"))
    device = As[0].device
    # each tensor's attributes are read once and the per-group geometry is
    # numpy over all groups: this runs on every call, for tens of groups
    a_shapes, b_shapes = [A.shape for A in As], [B.shape for B in Bs]
    for g, (sa, sb) in enumerate(zip(a_shapes, b_shapes)):
        if len(sa) != 2 or len(sb) != 2:
            raise ValueError(
                f"group operands must be 2D matrices: {tuple(sa)} @ {tuple(sb)}")
    if len({X.device for X in (*As, *Bs)}) > 1:
        g = next(g for g, (A, B) in enumerate(zip(As, Bs))
                 if A.device != device or B.device != device)
        raise ValueError(f"group {g}: operands on {As[g].device}/{Bs[g].device}, "
                         f"group 0 on {device}")
    # (numpy reads a list of torch.Size slowly; a flat list of ints fast)
    sa = np.array([d for s in a_shapes for d in s], dtype=np.int64).reshape(G, 2)
    sb = np.array([d for s in b_shapes for d in s], dtype=np.int64).reshape(G, 2)
    m, k_a = np.where(ta, sa[:, 1], sa[:, 0]), np.where(ta, sa[:, 0], sa[:, 1])
    k_b, n = np.where(tb, sb[:, 1], sb[:, 0]), np.where(tb, sb[:, 0], sb[:, 1])
    bad = np.flatnonzero(k_a != k_b)
    if len(bad):
        g = bad[0]
        raise ValueError(
            f"group {g}: contracted dims disagree: A gives k={k_a[g]}, "
            f"B gives k={k_b[g]} (trans_a={bool(ta[g])}, trans_b={bool(tb[g])})")
    problems = [GroupProblem(*p) for p in zip(m.tolist(), n.tolist(), k_a.tolist())]
    mp, np_, kp = (-(-d // tiles[r]) * tiles[r] for d, r in ((m, "u"), (n, "v"), (k_a, "k")))
    # stored-layout row/col extents per group (what actually packs)
    a_rows, a_cols = np.where(ta, kp, mp), np.where(ta, mp, kp)
    b_rows, b_cols = np.where(tb, np_, kp), np.where(tb, kp, np_)
    a_off, b_off, c_off = (np.cumsum(x) - x for x in (a_rows, b_rows, mp))
    # the JAX package pads each buffer to at least one tile per dim (its
    # kernel traces both fetch shapes); kept so the shapes stay equal
    a_min = max(tiles["u"], tiles["k"])
    b_min = max(tiles["k"], tiles["v"])
    a_wide, b_wide = max(int(a_cols.max()), a_min), max(int(b_cols.max()), b_min)
    a_tall, b_tall = max(int(a_rows.sum()), a_min), max(int(b_rows.sum()), b_min)
    descs = torch.from_numpy(np.stack(
        [mp, np_, kp, a_off, b_off, c_off, ta, tb], axis=1).astype(np.int32))

    A_flat = _pack_operand(As, sa, a_rows, a_off, a_tall, a_wide)
    B_flat = _pack_operand(Bs, sb, b_rows, b_off, b_tall, b_wide)
    return A_flat, B_flat, descs, problems


def _to_device(host, device):
    """``host`` (a CPU tensor) on ``device``: on a card, one copy from
    pinned memory that queues on the stream instead of waiting for it (a
    copy from pageable memory would first wait for all work queued before
    it); the pinned allocator keeps the block until the copy ends."""
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def _row_blocks(Xs, shapes):
    """``Xs`` (2D; ``shapes`` their ``(G, 2)`` shapes as an array) as one
    ``(sum of rows, width)`` view when they are consecutive row blocks of
    one tensor: one width and dtype, unit stride along rows, one row
    stride, each block starting where the one before it ends, the first
    and last in one storage (so every block between lies in it too).  Else
    ``None``.  Blocks of no rows are skipped.  Plain lists, not numpy:
    this runs on every call over tens of groups, where numpy's per-call
    cost outweighs its loops."""
    live = [(X, r, c) for X, (r, c) in zip(Xs, shapes.tolist()) if r]
    if not live:
        return None
    first, width = live[0][0], live[0][2]
    if len(live) == 1:
        return first
    dtype, step = first.dtype, first.element_size()
    stride = next((X.stride(0) for X, r, _ in live if r > 1), first.stride(0))
    ptr = first.data_ptr()
    for X, r, c in live:
        s0, s1 = X.stride()
        if (c != width or X.dtype != dtype or (width > 1 and s1 != 1)
                or (r > 1 and s0 != stride) or X.data_ptr() != ptr):
            return None
        ptr += r * stride * step
    if first.untyped_storage().data_ptr() != live[-1][0].untyped_storage().data_ptr():
        return None
    return first.as_strided((sum(r for _, r, _ in live), width), (stride, 1))


def _pack_operand(Xs, shapes, blocks, offs, tall, wide):
    """The ``(tall, wide)`` flat buffer holding ``Xs[g]`` (as stored, of
    ``shapes[g]``) at rows ``offs[g]..`` and columns ``0..``, zero
    elsewhere; ``blocks[g]`` is group ``g``'s padded height.  A view of the
    inputs where they already are that buffer (see :func:`pack_groups`)."""
    dtype, device = Xs[0].dtype, Xs[0].device
    if (tall == blocks.sum() and (shapes[:, 0] == blocks).all()
            and ((shapes[:, 1] == wide) | (blocks == 0)).all()):
        view = _row_blocks(Xs, shapes)
        if view is not None and view.dtype == dtype and (tall <= 1 or view.stride(0) == wide):
            return view
    flat = torch.empty((tall, wide), dtype=dtype, device=device)
    # the rows each stored width writes, then the rows no group writes
    # (padding rows, groups that store no columns, the tail): one host-made
    # index, one transfer, sliced
    live = (shapes[:, 0] > 0) & (shapes[:, 1] > 0)
    widths = np.unique(shapes[live, 1])
    by_width = [np.flatnonzero(live & (shapes[:, 1] == w)) for w in widths]
    order = np.concatenate(by_width) if by_width else np.zeros(0, dtype=np.int64)
    n_rows = shapes[order, 0]
    data = np.arange(int(n_rows.sum()), dtype=np.int64) + np.repeat(
        offs[order] - (np.cumsum(n_rows) - n_rows), n_rows)
    written = np.zeros(tall, dtype=bool)
    written[data] = True
    pad_rows = np.flatnonzero(~written)
    index = _to_device(torch.from_numpy(np.concatenate([data, pad_rows])), device)
    start = 0
    for width, gs in zip(widths.tolist(), by_width):
        count = int(shapes[gs, 0].sum())
        rows = index[start:start + count]
        start += count
        src = _row_blocks([Xs[g] for g in gs], shapes[gs])
        if src is None:
            src = torch.cat([Xs[g] for g in gs])
        (flat if width == wide else flat[:, :width]).index_copy_(0, rows, src.to(dtype))
        if width < wide:
            flat[:, width:].index_fill_(0, rows, 0)
    if len(pad_rows):
        flat.index_fill_(0, index[start:], 0)
    return flat


def packed_geometry(problems, tiles: dict | None = None):
    """``(grid_dims, out_rows, out_cols)`` of the packed launch over
    ``problems`` (as :func:`pack_groups` returns them): the largest
    group's block counts in units of ``tiles``, the packed C height (the
    groups' padded rows, at least one ``u`` tile) and width."""
    tiles = {**GROUPED_DEFAULT_TILES, **(tiles or {})}
    dims = np.array([(p.m, p.n, p.k) for p in problems], dtype=np.int64).reshape(-1, 3)
    blocks = -(-dims // np.array([tiles["u"], tiles["v"], tiles["k"]]))
    grid = tuple(max(1, int(b)) for b in blocks.max(axis=0, initial=0))
    out_rows = max(tiles["u"], int(blocks[:, 0].sum()) * tiles["u"])
    return grid, out_rows, grid[1] * tiles["v"]


def _host_table(descs) -> np.ndarray:
    """The descriptor table as a ``(G, 8)`` int64 host array (a CUDA table
    is read back, which synchronises; :func:`pack_groups` keeps its table
    on the host)."""
    if descs.ndim != 2 or descs.shape[1] != len(DESC_FIELDS):
        raise ValueError(f"descs must be (G, {len(DESC_FIELDS)}), got "
                         f"{tuple(descs.shape)}")
    if descs.dtype.is_floating_point or descs.dtype == torch.bool:
        raise TypeError(f"descs must be an integer table, got {descs.dtype}")
    return descs.cpu().numpy().astype(np.int64)


def grouped_gemm_packed_ref(A_flat, B_flat, descs, *, out_cols: int,
                            out_rows: int | None = None, out_dtype=None):
    """Plain PyTorch version of :func:`grouped_gemm`: one float32 matmul
    per descriptor row, written into a zero ``(out_rows, out_cols)``
    buffer and cast to ``out_dtype`` (default: the promoted operand
    dtype).  Cells outside every group's ``m_p × n_p`` block are zero."""
    out_dtype = out_dtype or torch.promote_types(A_flat.dtype, B_flat.dtype)
    if out_rows is None:
        out_rows = int(A_flat.shape[0])
    out = torch.zeros((out_rows, out_cols), dtype=torch.float32,
                      device=A_flat.device)
    for m, n, k, ao, bo, co, ta, tb in _host_table(descs).tolist():
        if not (m and n):
            continue
        a = A_flat[ao:ao + k, :m].T if ta else A_flat[ao:ao + m, :k]
        b = B_flat[bo:bo + n, :k].T if tb else B_flat[bo:bo + k, :n]
        out[co:co + m, :n] = a.float() @ b.float()   # k == 0 gives zeros
    return out.to(out_dtype)


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = _build.load("grouped_gemm")
        lib.gg_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.gg_launch.restype = ctypes.c_int
        lib.gg_launch_wgmma.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.gg_launch_wgmma.restype = ctypes.c_int
        lib.gg_wgmma_info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.gg_wgmma_info.restype = ctypes.c_int
        lib.gg_fma_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)]
        lib.gg_fma_info.restype = ctypes.c_int
        lib.gg_error_string.argtypes = [ctypes.c_int]
        lib.gg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_rows(name: str, X) -> None:
    if X.ndim != 2:
        raise ValueError(f"{name} must be 2D, got shape {tuple(X.shape)}")
    if X.shape[1] > 1 and X.stride(1) != 1:
        raise ValueError(f"{name} must have unit stride along its rows, got "
                         f"strides {X.stride()}")
    if X.stride(0) % VECTOR_ELEMS:
        raise ValueError(f"{name}'s row stride {X.stride(0)} is not a multiple "
                         f"of {VECTOR_ELEMS} (16-byte row loads)")


def grouped_route(A_flat, B_flat, rows) -> str:
    """The route :func:`grouped_gemm` launches for these buffers and
    descriptor rows (a ``(G, 8)`` table, or its rows as lists).

    ``"wgmma"`` when a TMA tensor map can describe both buffers and no
    64-deep slab of the wgmma kernel runs past a group's ``k_p``: both
    bf16 (the output may be bf16 or float32), non-empty, 16-byte aligned,
    unit stride along rows, row strides multiples of 8 elements that do
    not overlap rows, and every group with output tiles (``m_p``, ``n_p``
    > 0) having ``k_p`` a multiple of :data:`WGMMA_DEPTH` (``k_p == 0``
    qualifies).  Otherwise ``"fma"``: float32, mixed operand types, and
    packing tiles that leave a ragged ``k_p``.  Decided from dtype,
    pointers, strides and descriptors alone, never from a failure."""
    if A_flat.dtype != torch.bfloat16 or B_flat.dtype != torch.bfloat16:
        return "fma"
    for X in (A_flat, B_flat):
        if X.ndim != 2 or X.numel() == 0 or X.data_ptr() % 16:
            return "fma"
        if X.shape[1] > 1 and X.stride(1) != 1:
            return "fma"
        if X.shape[0] > 1 and (X.stride(0) % VECTOR_ELEMS or X.stride(0) < X.shape[1]):
            return "fma"
    d = _host_table(rows) if isinstance(rows, torch.Tensor) else np.asarray(rows).reshape(-1, 8)
    if ((d[:, 0] > 0) & (d[:, 1] > 0) & (d[:, 2] % WGMMA_DEPTH != 0)).any():
        return "fma"
    return "wgmma"


def wgmma_info() -> dict:
    """Registers and spilled (local) bytes per thread, and dynamic shared
    bytes per block, of the built wgmma kernel for each output dtype.
    Needs the card (it loads the library)."""
    lib = _library()
    info = {}
    for dtype, code in _TYPE_CODES.items():
        out = (ctypes.c_int * 3)()
        rc = lib.gg_wgmma_info(code, out)
        if rc != 0:
            raise RuntimeError(f"gg_wgmma_info: {lib.gg_error_string(rc).decode()}")
        info[dtype] = {"registers": out[0], "spill_bytes": out[1], "smem_bytes": out[2]}
    return info


def fma_info() -> dict:
    """Registers and spilled (local) bytes per thread, and static shared
    bytes per block, of the built fma kernel for each (A, B, C) dtype
    triple.  Needs the card (it loads the library)."""
    lib = _library()
    info = {}
    for ta, ca in _TYPE_CODES.items():
        for tb, cb in _TYPE_CODES.items():
            for tc, cc in _TYPE_CODES.items():
                out = (ctypes.c_int * 3)()
                rc = lib.gg_fma_info(ca, cb, cc, out)
                if rc != 0:
                    raise RuntimeError(f"gg_fma_info: {lib.gg_error_string(rc).decode()}")
                info[ta, tb, tc] = {"registers": out[0], "spill_bytes": out[1],
                                    "smem_bytes": out[2]}
    return info


def grouped_gemm(A_flat, B_flat, descs, *, out_cols: int,
                 out_rows: int | None = None, out_dtype=None):
    """Single-launch grouped GEMM over packed operands.

    The contract of the JAX package's ``grouped_gemm_pallas``: group ``g``
    of ``descs`` (the ``(G, 8)`` table of :data:`DESC_FIELDS`) occupies
    rows ``c_off .. c_off+m_p``, columns ``0 .. n_p`` of the
    ``(out_rows, out_cols)`` result (``out_rows`` defaults to
    ``A_flat.shape[0]``, correct only when no group stores A transposed).
    Cells outside every group's block are left unspecified on the card
    (zero in the plain version), as on the TPU.

    The JAX package's ``grid_dims`` and ``tiles`` sized the TPU grid; the
    kernel launches one block per output tile of each group, so neither
    exists here.  The launch takes the route :func:`grouped_route` picks.

    Requirements of the kernels' 16-byte row loads, checked on every
    device: unit stride along rows, row strides and every ``m_p``, ``n_p``
    and ``k_p`` a multiple of 8 (what :func:`pack_groups` gives with tiles
    that are multiples of 8), float32 or bfloat16 operands and output.
    """
    if A_flat.device != B_flat.device:
        raise ValueError(f"operands on different devices: {A_flat.device} vs "
                         f"{B_flat.device}")
    if A_flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_gemm runs on CUDA (or CPU) tensors, got "
                         f"{A_flat.device}")
    out_dtype = out_dtype or torch.promote_types(A_flat.dtype, B_flat.dtype)
    for name, dt in (("A_flat", A_flat.dtype), ("B_flat", B_flat.dtype),
                     ("out", out_dtype)):
        if dt not in _TYPE_CODES:
            raise TypeError(f"grouped_gemm takes float32/bfloat16, got {name} {dt}")
    _check_rows("A_flat", A_flat)
    _check_rows("B_flat", B_flat)
    if out_rows is None:
        out_rows = int(A_flat.shape[0])
    d = _host_table(descs)
    m, n, k, ao, bo, co, ta, tb = d.T
    bad = np.flatnonzero((d[:, :6] < 0).any(axis=1) | (d[:, 6:] > 1).any(axis=1)
                         | (d[:, 6:] < 0).any(axis=1))
    if len(bad):
        raise ValueError(f"group {bad[0]}: bad descriptor {tuple(d[bad[0]].tolist())}")
    bad = np.flatnonzero((d[:, :3] % VECTOR_ELEMS).any(axis=1))
    if len(bad):
        raise ValueError(f"group {bad[0]}: padded dims {tuple(d[bad[0], :3].tolist())} must "
                         f"be multiples of {VECTOR_ELEMS} (16-byte row loads)")
    a_r, a_c = np.where(ta, k, m), np.where(ta, m, k)
    b_r, b_c = np.where(tb, n, k), np.where(tb, k, n)
    bad = np.flatnonzero((m > 0) & (n > 0) & (
        (ao + a_r > A_flat.shape[0]) | (a_c > A_flat.shape[1]) | (bo + b_r > B_flat.shape[0])
        | (b_c > B_flat.shape[1]) | (co + m > out_rows) | (n > out_cols)))
    if len(bad):
        raise ValueError(f"group {bad[0]}: descriptor {tuple(d[bad[0]].tolist())} "
                         f"reaches past A {tuple(A_flat.shape)}, B "
                         f"{tuple(B_flat.shape)} or C {(out_rows, out_cols)}")
    route = grouped_route(A_flat, B_flat, d)
    tu, tv = KERNEL_TILES[route]
    prefix = np.concatenate([[0], np.cumsum(-(-m // tu) * -(-n // tv))])
    if prefix[-1] >= 2**31:
        raise ValueError(f"{prefix[-1]} output tiles exceed one launch")

    if A_flat.device.type == "cpu":
        return grouped_gemm_packed_ref(A_flat, B_flat, descs, out_cols=out_cols,
                                       out_rows=out_rows, out_dtype=out_dtype)
    if A_flat.data_ptr() % 16 or B_flat.data_ptr() % 16:
        raise ValueError("grouped_gemm needs A_flat and B_flat to start on a "
                         "16-byte boundary (16-byte row loads)")
    out = torch.empty((out_rows, out_cols), dtype=out_dtype, device=A_flat.device)
    if prefix[-1] == 0:
        return out
    # the descriptor rows and the tile prefix, in one host-to-device copy
    table = _to_device(torch.from_numpy(
        np.concatenate([d.ravel(), prefix]).astype(np.int32)), A_flat.device)
    lib = _library()
    with torch.cuda.device(A_flat.device):
        stream = torch.cuda.current_stream(A_flat.device).cuda_stream
        if route == "wgmma":
            rc = lib.gg_launch_wgmma(
                A_flat.data_ptr(), B_flat.data_ptr(), out.data_ptr(), table.data_ptr(),
                len(d), int(prefix[-1]), *A_flat.shape, A_flat.stride(0), *B_flat.shape,
                B_flat.stride(0), out.stride(0), _TYPE_CODES[out_dtype], stream)
        else:
            rc = lib.gg_launch(
                A_flat.data_ptr(), B_flat.data_ptr(), out.data_ptr(), table.data_ptr(),
                len(d), int(prefix[-1]), A_flat.stride(0), B_flat.stride(0), out.stride(0),
                _TYPE_CODES[A_flat.dtype], _TYPE_CODES[B_flat.dtype],
                _TYPE_CODES[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"grouped_gemm launch failed on the {route} route: "
                           f"{lib.gg_error_string(rc).decode()}")
    grouped_gemm.launches += 1
    grouped_gemm.launches_by_route[route] += 1
    return out


grouped_gemm.launches = 0
grouped_gemm.launches_by_route = dict.fromkeys(ROUTES, 0)


def grouped_gemm_ref(As, Bs, *, trans_a=False, trans_b=False):
    """Reference: one matmul per group (the unfused baseline), float32
    accumulation, cast to the promoted operand dtype."""
    ta = _norm_flags(trans_a, len(As), "trans_a")
    tb = _norm_flags(trans_b, len(Bs), "trans_b")
    out = []
    for g, (A, B) in enumerate(zip(As, Bs)):
        a = A.T if ta[g] else A
        b = B.T if tb[g] else B
        out.append((a.float() @ b.float()).to(torch.promote_types(A.dtype, B.dtype)))
    return out
