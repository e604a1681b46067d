"""StridedBatchedGEMM on Hopper: the native-layout contraction kernel.

:func:`native_gemm` evaluates one pairwise contraction
``C[c_modes] = Σ A[a_modes]·B[b_modes]`` in a single launch of the CUDA
kernel in ``csrc/sb_gemm.cu``, the port of the TPU kernel
``native_gemm_pallas`` (``src/repro/kernels/sb_gemm.py``).  The operands
are read in place through their own strides (``tensor.stride()``):
transposed, sliced and stride-0 views cost no permute and no copy, which
is the paper's claim (Listing 1's ``lda``/``loa`` walk) carried to every
mode.  There is no padding either: the kernel masks ragged edges.

The kernel's geometry, from the wrapper's point of view: C's minor-most
mode ``v`` and one other C mode ``u`` (by default the largest, as
:func:`~repro_torch.kernels.addressing.native_mode_tiles` picks it) span
a block's output tile; every other C mode is decoded from the block
index; the contracted modes are one flattened in-block loop.  At most
:data:`MAX_MODES` such modes fit one launch.

:func:`native_gemm_ref` is the plain PyTorch version (an f32 einsum).  The
wrapper takes it only for tensors on the CPU; a CUDA tensor launches the
kernel or raises.  ``native_gemm.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.contract import infer_dims
from repro_torch.core.notation import ContractionSpec
from repro_torch.kernels import _build
from repro_torch.kernels.addressing import row_major_strides

__all__ = ["MAX_MODES", "native_gemm", "native_gemm_ref"]

#: mode slots one launch takes (u, v, other C modes, contracted modes)
MAX_MODES = 8

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_I64x8 = ctypes.c_int64 * MAX_MODES


class _Desc(ctypes.Structure):
    """Mirror of ``NgDesc`` in ``csrc/sb_gemm.cu``."""

    _fields_ = [
        ("ext", _I64x8), ("sa", _I64x8), ("sb", _I64x8), ("sc", _I64x8),
        ("n_rest", ctypes.c_int32), ("n_k", ctypes.c_int32),
        ("walk", ctypes.c_int32),
    ]


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = _build.load("sb_gemm")
        lib.ng_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(_Desc), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.ng_launch.restype = ctypes.c_int
        lib.ng_error_string.argtypes = [ctypes.c_int]
        lib.ng_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def native_gemm_ref(A, B, *, a_modes: str, b_modes: str, c_modes: str,
                    out_dtype=None):
    """Plain PyTorch version of :func:`native_gemm`: an einsum over the
    operands upcast to float32 (f32 accumulation), cast to ``out_dtype``
    (default: the promoted operand dtype)."""
    out_dtype = out_dtype or torch.promote_types(A.dtype, B.dtype)
    out = torch.einsum(f"{a_modes},{b_modes}->{c_modes}", A.float(), B.float())
    return out.to(out_dtype)


def native_gemm(A, B, *, a_modes: str, b_modes: str, c_modes: str,
                out_dtype=None, u: str | None = None, walk: int = 1,
                walk_mode: str | None = None):
    """Single-launch contraction of ``A`` and ``B`` in their native layouts.

    Args:
      A, B: float32 or bfloat16 tensors on one CUDA device (or both on the
        CPU, which runs :func:`native_gemm_ref`), ranks matching
        ``a_modes``/``b_modes``; any strides.
      c_modes: the output's modes, row-major; non-empty.  Operand modes
        absent from it are contracted.
      out_dtype: float32 or bfloat16 (default: the promoted operand dtype).
      u: the C mode that spans the tile's rows (default: the largest C
        mode other than the minor-most).
      walk, walk_mode: one block walks ``walk`` consecutive indices of the
        C mode ``walk_mode`` (the paper's extended-transpose brick depth).

    Returns a new contiguous tensor with modes ``c_modes``.
    """
    if A.device != B.device:
        raise ValueError(f"operands on different devices: {A.device} vs {B.device}")
    if not (a_modes and b_modes and c_modes):
        raise ValueError("native_gemm needs non-scalar operands and output")
    out_dtype = out_dtype or torch.promote_types(A.dtype, B.dtype)
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"native_gemm runs on CUDA (or CPU) tensors, got {A.device}")
    for name, dt in (("A", A.dtype), ("B", B.dtype), ("out", out_dtype)):
        if dt not in _TYPE_CODES:
            raise TypeError(f"native_gemm takes float32/bfloat16, got {name} {dt}")
    dims = infer_dims(ContractionSpec(a_modes, b_modes, c_modes), A, B)
    # every mode once per tensor; an operand mode missing from C must be
    # contracted, i.e. appear in the other operand too
    a, b, c = set(a_modes), set(b_modes), set(c_modes)
    if (len(a) != len(a_modes) or len(b) != len(b_modes) or len(c) != len(c_modes)
            or c - a - b or (a ^ b) - c):
        raise ValueError(f"native_gemm cannot evaluate {a_modes},{b_modes}->{c_modes}")

    v = c_modes[-1]
    others = c_modes[:-1]
    if u is None:
        # a plan with no u role (matrix-vector cores) still walks its batch
        # mode: the tile's rows go to the largest remaining C mode, if any
        u = max((m for m in others if m != walk_mode), key=lambda m: dims[m],
                default=None)
    if u is not None and (u not in others or u == walk_mode):
        raise ValueError(f"u={u!r} must be a C mode other than the minor-most "
                         f"and the walked one")
    rest = [m for m in reversed(others) if m != u]
    if walk_mode is not None:
        if walk_mode not in rest:
            raise ValueError(f"walk_mode={walk_mode!r} is not a batch mode of C")
        rest.remove(walk_mode)
        rest.insert(0, walk_mode)
    elif walk != 1:
        raise ValueError("walk > 1 needs walk_mode")
    contracted = [m for m in a_modes if m in b_modes and m not in c_modes]
    # flattened K walks its last mode fastest: give that place to the mode
    # with the smallest stride in the larger operand
    big, big_modes = (A, a_modes) if A.numel() >= B.numel() else (B, b_modes)
    contracted.sort(key=lambda m: -big.stride(big_modes.index(m)))
    slots = [u, v, *rest, *contracted]
    if len(slots) > MAX_MODES:
        raise ValueError(
            f"{a_modes},{b_modes}->{c_modes} needs {len(slots)} mode slots; "
            f"native_gemm takes at most {MAX_MODES}")

    def strides(shape_strides, modes):
        # extent-1 modes (and an absent u) get stride 0: the kernel then
        # stages nothing along them
        return [shape_strides[modes.index(m)] if m is not None and m in modes
                and dims[m] > 1 else 0 for m in slots]

    c_shape = [dims[m] for m in c_modes]
    sa, sb = strides(A.stride(), a_modes), strides(B.stride(), b_modes)
    sc = strides(row_major_strides(c_shape), c_modes)
    # the kernel's fast path wants A varying along u only and B along v
    # only; the product commutes, so swap operands that arrive the other way
    swap = bool((sa[1] or sb[0]) and not (sb[1] or sa[0]))
    if swap:
        sa, sb = sb, sa
    desc = _Desc(
        _I64x8(*[1 if m is None else dims[m] for m in slots]),
        _I64x8(*sa), _I64x8(*sb), _I64x8(*sc),
        len(rest), len(contracted), int(walk))

    if A.device.type == "cpu":
        # the launch geometry above is built on every device; the CPU has
        # no kernel and takes the plain version
        return native_gemm_ref(A, B, a_modes=a_modes, b_modes=b_modes,
                               c_modes=c_modes, out_dtype=out_dtype)
    out = torch.empty(c_shape, dtype=out_dtype, device=A.device)
    if out.numel() == 0:
        return out
    X, Y = (B, A) if swap else (A, B)
    lib = _library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.ng_launch(X.data_ptr(), Y.data_ptr(), out.data_ptr(),
                           ctypes.byref(desc), _TYPE_CODES[X.dtype],
                           _TYPE_CODES[Y.dtype],
                           _TYPE_CODES[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"native_gemm launch failed: {lib.ng_error_string(rc).decode()}")
    native_gemm.launches += 1
    return out


native_gemm.launches = 0
