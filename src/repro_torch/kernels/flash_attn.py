"""Flash attention on Hopper: forward attention with an online softmax.

:func:`flash_attention` launches the CUDA kernel in ``csrc/flash_attn.cu``,
the port of the JAX package's TPU kernel ``flash_attention``
(``src/repro/kernels/flash_attn.py``).  Scores live only as a tile in
shared memory and the softmax state (``m``, ``l``, the f32 accumulator)
stays in registers across the key loop, so the ``(S, T)`` score matrix is
never written to device memory.  Forward only, as in the JAX package.

:func:`flash_attention_ref` is the plain PyTorch version: dense float32
scores with the same mask value and ``l`` clamp.  The wrapper takes it
only for tensors on the CPU; a CUDA tensor launches the kernel or raises.
``flash_attention.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["MAX_HEAD_DIM", "ROUTES", "flash_attention", "flash_attention_ref", "flash_route",
           "fma_tiles", "wgmma_tiles"]

_NEG_INF = -2.0**30

#: the largest head dimension the kernels take
MAX_HEAD_DIM = 256

ROUTES = ("wgmma", "fma")

#: query rows per block and K/V ring stages of the wgmma route
#: (``FW_BQ``, ``FW_STAGES`` in ``csrc/flash_attn.cu``)
_WGMMA_BQ, _WGMMA_STAGES = 128, 2

#: keys per tile and threads per block of the fma route (``FA_BK``,
#: ``FA_THREADS`` in ``csrc/flash_attn.cu``)
_FMA_BK, _FMA_THREADS = 64, 256

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class _Args(ctypes.Structure):
    """Mirror of ``FaArgs`` in ``csrc/flash_attn.cu``."""

    _fields_ = [
        ("sq_bh", ctypes.c_int64), ("sq_s", ctypes.c_int64),
        ("sk_bh", ctypes.c_int64), ("sk_t", ctypes.c_int64),
        ("sv_bh", ctypes.c_int64), ("sv_t", ctypes.c_int64),
        ("S", ctypes.c_int32), ("T", ctypes.c_int32), ("D", ctypes.c_int32),
        ("scale", ctypes.c_float), ("causal", ctypes.c_int32),
    ]


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attn")
        lib.fa_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.fa_launch.restype = ctypes.c_int
        lib.fa_launch_wgmma.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p,
        ]
        lib.fa_launch_wgmma.restype = ctypes.c_int
        lib.fa_wgmma_info.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.fa_wgmma_info.restype = ctypes.c_int
        lib.fa_fma_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.fa_fma_info.restype = ctypes.c_int
        lib.fa_error_string.argtypes = [ctypes.c_int]
        lib.fa_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _padded_head_dim(D: int) -> int:
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside 1..{MAX_HEAD_DIM}")
    return next(p for p in (64, 128, 256) if D <= p)


def fma_tiles(D: int) -> dict:
    """The fma route's tiling at head dim ``D`` (``FaTile`` in
    ``csrc/flash_attn.cu``): the padded head dim ``dp`` (64, 128 or 256),
    query rows ``bq`` and keys ``bk`` per block, each thread's ``rows`` ×
    4 keys of S and ``rows`` × ``cols`` of O, and the dynamic shared
    memory of one block in bytes: f32 Q transposed (``dp × bq``), K
    (``bk`` rows of ``dp + 4``), V (``bk × dp``) and P transposed (``bk``
    rows of ``bq + 4``)."""
    dp = _padded_head_dim(D)
    bq = 128 if dp <= 128 else 64
    smem = 4 * (dp * bq + _FMA_BK * (dp + 4) + _FMA_BK * dp + _FMA_BK * (bq + 4))
    return {"dp": dp, "bq": bq, "bk": _FMA_BK, "threads": _FMA_THREADS,
            "rows": bq // 16, "cols": dp // 16, "smem_bytes": smem}


def wgmma_tiles(D: int) -> dict:
    """The wgmma route's tiling at head dim ``D`` (``FwTile`` in
    ``csrc/flash_attn.cu``): the padded head dim ``dp`` (64, 128 or 256),
    keys per tile ``bk``, ring ``stages``, and the dynamic shared memory of
    one block in bytes (Q tile, K and V per stage, mbarriers, and 1024
    bytes of alignment slack)."""
    dp = _padded_head_dim(D)
    bk = 64 if dp == 256 else 128
    smem = (1024 + _WGMMA_BQ * dp * 2 + _WGMMA_STAGES * 2 * bk * dp * 2
            + 8 * (1 + 2 * _WGMMA_STAGES))
    return {"dp": dp, "bk": bk, "stages": _WGMMA_STAGES, "smem_bytes": smem}


def wgmma_info(D: int) -> dict:
    """Registers and spilled (local) bytes per thread, and dynamic shared
    bytes per block, of the built wgmma kernel for head dim ``D``.  Needs
    the card (it loads the library)."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    rc = lib.fa_wgmma_info(D, out)
    if rc != 0:
        raise RuntimeError(f"fa_wgmma_info: {lib.fa_error_string(rc).decode()}")
    return {"registers": out[0], "spill_bytes": out[1], "smem_bytes": out[2]}


def fma_info(D: int, dtype=torch.float32) -> dict:
    """Registers and spilled (local) bytes per thread, and dynamic shared
    bytes per block, of the built fma kernel for head dim ``D`` and
    ``dtype``.  Needs the card (it loads the library)."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    rc = lib.fa_fma_info(D, _TYPE_CODES[dtype], out)
    if rc != 0:
        raise RuntimeError(f"fa_fma_info: {lib.fa_error_string(rc).decode()}")
    return {"registers": out[0], "spill_bytes": out[1], "smem_bytes": out[2]}


def flash_route(q, k, v) -> str:
    """``"wgmma"`` when the operands are bf16 and a TMA tensor map can
    describe each: base pointer 16-byte aligned, row and head strides
    multiples of 8 elements (16 bytes), a head stride of 0 allowed, and a
    dimension of extent 1 taking any stride.  Otherwise ``"fma"``.  Decided
    from dtype, shape, strides and pointers alone, never from a failure."""
    if q.dtype != torch.bfloat16:
        return "fma"
    for x in (q, k, v):
        if x.data_ptr() % 16:
            return "fma"
        if x.shape[1] > 1 and x.stride(1) % 8:
            return "fma"
        if x.shape[0] > 1 and x.stride(0) % 8:
            return "fma"
    return "wgmma"


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain PyTorch version of :func:`flash_attention`: dense float32
    scores ``q·kᵀ·D^-0.5``, masked to ``-2**30`` where ``i < j`` under
    ``causal`` (top-left aligned), softmax with the row sum clamped to
    ``>= 1e-30``, ``p`` rounded to ``v``'s dtype before ``P·V``, output in
    ``q``'s dtype."""
    D = q.shape[-1]
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) * D**-0.5
    if causal:
        S, T = s.shape[-2:]
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = torch.where(mask, s, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bst,btd->bsd", p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (BH, S, D); k, v: (BH, T, D) → (BH, S, D) in ``q.dtype``.

    Softmax attention with scale ``D**-0.5``; under ``causal`` query ``i``
    sees keys ``j <= i`` (no offset when ``T != S``, as in the JAX
    package).  q, k and v share one dtype (float32 or bfloat16), lie on
    one device, and are read through their strides with unit stride along
    D, so a K/V broadcast over BH (stride 0) costs no copy.  D is at most
    :data:`MAX_HEAD_DIM`.

    GQA callers fold (batch, kv_head, q_per_kv) into BH and pass the kv
    head's K/V for each q head.

    The JAX package's ``blocks`` (TPU tiles) has no counterpart: each
    route's tiles are fixed (:func:`wgmma_tiles`, :func:`fma_tiles`).
    """
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"flash_attention takes rank-3 q, k, v; got ranks "
                         f"{q.ndim}, {k.ndim}, {v.ndim}")
    BH, S, D = q.shape
    T = k.shape[1]
    if k.shape != (BH, T, D) or v.shape != (BH, T, D):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA (or CPU) tensors, got {q.device}")
    if q.dtype not in _TYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes q, k, v of one dtype, float32 "
                        f"or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} exceeds {MAX_HEAD_DIM}")
    if min(S, T, D) < 1:
        raise ValueError(f"empty attention: S={S}, T={T}, D={D}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if D > 1 and x.stride(2) != 1:
            raise ValueError(f"{name} needs unit stride along D, got strides "
                             f"{x.stride()}")
    if BH > 65535:
        raise ValueError(f"BH={BH} exceeds one launch's 65535 blocks along y")

    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    route = flash_route(q, k, v)
    out = torch.empty((BH, S, D), dtype=q.dtype, device=q.device)
    args = _Args(q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), S, T, D, D**-0.5, int(causal))
    lib = _library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "wgmma":
            rc = lib.fa_launch_wgmma(*ptrs, ctypes.byref(args), BH, stream)
        else:
            rc = lib.fa_launch(*ptrs, ctypes.byref(args), BH, _TYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed on the {route} route: "
                           f"{lib.fa_error_string(rc).decode()}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
