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

__all__ = ["DEFAULT_BLOCKS", "MAX_HEAD_DIM", "flash_attention", "flash_attention_ref"]

DEFAULT_BLOCKS = {"q": 128, "k": 128}
_NEG_INF = -2.0**30

#: the largest head dimension the kernel takes
MAX_HEAD_DIM = 256

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
        lib.fa_error_string.argtypes = [ctypes.c_int]
        lib.fa_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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


def flash_attention(q, k, v, *, causal: bool = True, blocks: dict | None = None):
    """q: (BH, S, D); k, v: (BH, T, D) → (BH, S, D) in ``q.dtype``.

    Softmax attention with scale ``D**-0.5``; under ``causal`` query ``i``
    sees keys ``j <= i`` (no offset when ``T != S``, as in the JAX
    package).  q, k and v share one dtype (float32 or bfloat16), lie on
    one device, and are read through their strides with unit stride along
    D, so a K/V broadcast over BH (stride 0) costs no copy.  D is at most
    :data:`MAX_HEAD_DIM`.

    GQA callers fold (batch, kv_head, q_per_kv) into BH and pass the kv
    head's K/V for each q head.

    ``blocks`` is merged over :data:`DEFAULT_BLOCKS` as in the JAX
    package, where it sets the TPU kernel's tiles.  The CUDA kernel's tile
    is fixed (64 queries × 64 keys), so ``blocks`` only names the summation
    order of the reference it is compared with; the stated tolerances
    (2e-5 float32, 2e-2 bfloat16) cover that difference.
    """
    blocks = {**DEFAULT_BLOCKS, **(blocks or {})}
    for role, b in blocks.items():
        if role not in DEFAULT_BLOCKS or not isinstance(b, int) or b < 1:
            raise ValueError(f"blocks {blocks}: roles are 'q' and 'k', sizes "
                             f"positive ints")
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
    out = torch.empty((BH, S, D), dtype=q.dtype, device=q.device)
    args = _Args(q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), S, T, D, D**-0.5, int(causal))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           ctypes.byref(args), BH, _TYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention launch failed: {lib.fa_error_string(rc).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
