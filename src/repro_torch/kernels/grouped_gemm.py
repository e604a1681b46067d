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
the port of the TPU kernel ``grouped_gemm_pallas``.  The TPU grid is sized
by the largest group and predicates most blocks off; here the wrapper
builds each group's count of output tiles from the host-side descriptor
rows, and the kernel launches exactly one block per tile of some group.
:func:`grouped_gemm_packed_ref` is its plain PyTorch version (one f32
matmul per descriptor row); the wrapper takes it only for tensors on the
CPU, and a CUDA tensor launches the kernel or raises.
``grouped_gemm.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from repro_torch.kernels import _build

__all__ = [
    "GROUPED_DEFAULT_TILES",
    "DESC_FIELDS",
    "KERNEL_TILE",
    "GroupProblem",
    "pack_groups",
    "packed_geometry",
    "grouped_gemm",
    "grouped_gemm_packed_ref",
    "grouped_gemm_ref",
]

#: role → packing tile.  ``u`` stays at 8 so ragged groups pad by at most 7
#: rows; every tile is a multiple of 8 so that each group's block starts on
#: a 16-byte boundary of its rows (see :func:`grouped_gemm`).
GROUPED_DEFAULT_TILES = {"u": 8, "v": 128, "k": 128}

#: descriptor row layout (int32): padded dims, packed row offsets, and
#: per-group operand layout flags (1 = stored transposed).
DESC_FIELDS = ("m_p", "n_p", "k_p", "a_off", "b_off", "c_off",
               "trans_a", "trans_b")

#: the CUDA kernel's own output tile (rows, columns); mirrors GG_TU/GG_TV
#: in ``csrc/grouped_gemm.cu``.  It need not equal the packing tiles: the
#: kernel masks to each group's ``m_p``/``n_p``/``k_p``.
KERNEL_TILE = (64, 128)

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


def _pad_up(d: int, tile: int) -> int:
    return -(-d // tile) * tile


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

    The flat buffers are made on the operands' own device (one
    ``torch.zeros`` each, then one slice copy per group): a CUDA operand
    never passes through host memory.  The descriptor table is built on
    the host, from shapes, and stays there; :func:`grouped_gemm` copies it
    to the device with its tile list in one transfer.

    Returns ``(A_flat, B_flat, descs, problems)``: ``descs`` is the
    ``(G, 8)`` int32 CPU tensor of :data:`DESC_FIELDS`, ``problems`` the
    unpadded :class:`GroupProblem` list (needed to slice results back out).
    The table and the buffers' shapes equal the JAX package's.
    """
    tiles = {**GROUPED_DEFAULT_TILES, **(tiles or {})}
    if len(As) != len(Bs) or not As:
        raise ValueError("need one A and one B per group (at least one group)")
    ta = _norm_flags(trans_a, len(As), "trans_a")
    tb = _norm_flags(trans_b, len(Bs), "trans_b")
    device = As[0].device
    problems = []
    for g, (A, B) in enumerate(zip(As, Bs)):
        if A.ndim != 2 or B.ndim != 2:
            raise ValueError(
                f"group operands must be 2D matrices: {tuple(A.shape)} @ "
                f"{tuple(B.shape)}")
        if A.device != device or B.device != device:
            raise ValueError(f"group {g}: operands on {A.device}/{B.device}, "
                             f"group 0 on {device}")
        m, k_a = (A.shape[1], A.shape[0]) if ta[g] else A.shape
        k_b, n = (B.shape[1], B.shape[0]) if tb[g] else B.shape
        if k_a != k_b:
            raise ValueError(
                f"group {g}: contracted dims disagree: A gives k={k_a}, "
                f"B gives k={k_b} (trans_a={ta[g]}, trans_b={tb[g]})")
        problems.append(GroupProblem(m, n, k_a))
    G = len(problems)
    mp = [_pad_up(p.m, tiles["u"]) for p in problems]
    np_ = [_pad_up(p.n, tiles["v"]) for p in problems]
    kp = [_pad_up(p.k, tiles["k"]) for p in problems]
    # stored-layout row/col extents per group (what actually packs)
    a_rows = [kp[g] if ta[g] else mp[g] for g in range(G)]
    a_cols = [mp[g] if ta[g] else kp[g] for g in range(G)]
    b_rows = [np_[g] if tb[g] else kp[g] for g in range(G)]
    b_cols = [kp[g] if tb[g] else np_[g] for g in range(G)]
    a_off = [0, *itertools.accumulate(a_rows)][:G]
    b_off = [0, *itertools.accumulate(b_rows)][:G]
    c_off = [0, *itertools.accumulate(mp)][:G]
    # the JAX package pads each buffer to at least one tile per dim (its
    # kernel traces both fetch shapes); kept so the shapes stay equal
    a_min = max(tiles["u"], tiles["k"])
    b_min = max(tiles["k"], tiles["v"])
    a_wide, b_wide = max(max(a_cols), a_min), max(max(b_cols), b_min)
    a_tall, b_tall = max(sum(a_rows), a_min), max(sum(b_rows), b_min)
    descs = torch.tensor(
        [[mp[g], np_[g], kp[g], a_off[g], b_off[g], c_off[g], int(ta[g]),
          int(tb[g])] for g in range(G)], dtype=torch.int32)

    A_flat = torch.zeros((a_tall, a_wide), dtype=As[0].dtype, device=device)
    B_flat = torch.zeros((b_tall, b_wide), dtype=Bs[0].dtype, device=device)
    for g, (A, B) in enumerate(zip(As, Bs)):
        if A.numel():
            A_flat[a_off[g]:a_off[g] + A.shape[0], :A.shape[1]].copy_(A)
        if B.numel():
            B_flat[b_off[g]:b_off[g] + B.shape[0], :B.shape[1]].copy_(B)
    return A_flat, B_flat, descs, problems


def packed_geometry(problems, tiles: dict | None = None):
    """``(grid_dims, out_rows, out_cols)`` of the packed launch over
    ``problems`` (as :func:`pack_groups` returns them): the largest
    group's block counts in units of ``tiles``, the packed C height (the
    groups' padded rows, at least one ``u`` tile) and width."""
    tiles = {**GROUPED_DEFAULT_TILES, **(tiles or {})}
    grid = tuple(max(1, max(-(-getattr(p, d) // tiles[r]) for p in problems))
                 for d, r in (("m", "u"), ("n", "v"), ("k", "k")))
    out_rows = max(tiles["u"], sum(_pad_up(p.m, tiles["u"]) for p in problems))
    return grid, out_rows, grid[1] * tiles["v"]


def _host_rows(descs) -> list[list[int]]:
    """The descriptor rows as Python ints (a CUDA table is read back,
    which synchronises; :func:`pack_groups` keeps its table on the host)."""
    if descs.ndim != 2 or descs.shape[1] != len(DESC_FIELDS):
        raise ValueError(f"descs must be (G, {len(DESC_FIELDS)}), got "
                         f"{tuple(descs.shape)}")
    if descs.dtype.is_floating_point or descs.dtype == torch.bool:
        raise TypeError(f"descs must be an integer table, got {descs.dtype}")
    return descs.cpu().tolist()


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
    for m, n, k, ao, bo, co, ta, tb in _host_rows(descs):
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


def grouped_gemm(A_flat, B_flat, descs, *, grid_dims: tuple[int, int, int],
                 tiles: dict | None = None, out_cols: int,
                 out_rows: int | None = None, out_dtype=None):
    """Single-launch grouped GEMM over packed operands.

    The contract of the JAX package's ``grouped_gemm_pallas``: group ``g``
    of ``descs`` (the ``(G, 8)`` table of :data:`DESC_FIELDS`) occupies
    rows ``c_off .. c_off+m_p``, columns ``0 .. n_p`` of the
    ``(out_rows, out_cols)`` result (``out_rows`` defaults to
    ``A_flat.shape[0]``, correct only when no group stores A transposed).
    Cells outside every group's block are left unspecified on the card
    (zero in the plain version), as on the TPU.

    ``grid_dims = (u_blocks_max, v_blocks_max, k_blocks_max)`` in units of
    ``tiles`` sized the TPU grid; here it is checked to cover every group
    (a group it does not cover raises) and otherwise unused, since the
    kernel launches one block per output tile of each group.

    Requirements of the kernel's 16-byte row loads, checked on every
    device: unit stride along rows, row strides and every ``m_p``, ``n_p``
    and ``k_p`` a multiple of 8 (what :func:`pack_groups` gives with tiles
    that are multiples of 8), float32 or bfloat16 operands and output.
    """
    tiles = {**GROUPED_DEFAULT_TILES, **(tiles or {})}
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
    rows = _host_rows(descs)
    tu, tv = KERNEL_TILE
    prefix = [0]
    for g, (m, n, k, ao, bo, co, ta, tb) in enumerate(rows):
        if min(m, n, k, ao, bo, co) < 0 or ta not in (0, 1) or tb not in (0, 1):
            raise ValueError(f"group {g}: bad descriptor {(m, n, k, ao, bo, co, ta, tb)}")
        if m % VECTOR_ELEMS or n % VECTOR_ELEMS or k % VECTOR_ELEMS:
            raise ValueError(f"group {g}: padded dims {(m, n, k)} must be "
                             f"multiples of {VECTOR_ELEMS} (16-byte row loads)")
        if (-(-m // tiles["u"]) > max(grid_dims[0], 1)
                or -(-n // tiles["v"]) > max(grid_dims[1], 1)
                or -(-k // tiles["k"]) > max(grid_dims[2], 1)):
            raise ValueError(f"group {g}: {(m, n, k)} exceeds grid_dims "
                             f"{tuple(grid_dims)} of tiles {tiles}")
        a_r, a_c = (k, m) if ta else (m, k)
        b_r, b_c = (n, k) if tb else (k, n)
        if m and n and (ao + a_r > A_flat.shape[0] or a_c > A_flat.shape[1]
                        or bo + b_r > B_flat.shape[0] or b_c > B_flat.shape[1]
                        or co + m > out_rows or n > out_cols):
            raise ValueError(f"group {g}: descriptor {(m, n, k, ao, bo, co, ta, tb)} "
                             f"reaches past A {tuple(A_flat.shape)}, B "
                             f"{tuple(B_flat.shape)} or C {(out_rows, out_cols)}")
        prefix.append(prefix[-1] + (-(-m // tu)) * (-(-n // tv)))
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
    # from pinned memory: it queues on the stream instead of waiting for
    # it, and the pinned allocator keeps the block until the copy ends
    table = torch.tensor([v for r in rows for v in r] + prefix, dtype=torch.int32)
    table = table.pin_memory().to(A_flat.device, non_blocking=True)
    lib = _library()
    with torch.cuda.device(A_flat.device):
        stream = torch.cuda.current_stream(A_flat.device).cuda_stream
        rc = lib.gg_launch(
            A_flat.data_ptr(), B_flat.data_ptr(), out.data_ptr(), table.data_ptr(),
            len(rows), prefix[-1], A_flat.stride(0), B_flat.stride(0), out.stride(0),
            _TYPE_CODES[A_flat.dtype], _TYPE_CODES[B_flat.dtype],
            _TYPE_CODES[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"grouped_gemm launch failed: {lib.gg_error_string(rc).decode()}")
    grouped_gemm.launches += 1
    return out


grouped_gemm.launches = 0


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
