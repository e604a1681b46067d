"""StridedBatchedGEMM on Hopper: the native-layout contraction kernel.

:func:`native_gemm` evaluates one pairwise contraction
``C[c_modes] = Σ A[a_modes]·B[b_modes]`` in a single launch of the CUDA
kernel in ``csrc/sb_gemm.cu``, the port of the TPU kernel
``native_gemm_pallas`` (``src/repro/kernels/sb_gemm.py``).  The operands
are read in place through their own strides (``tensor.stride()``):
transposed, sliced and stride-0 views cost no permute and no copy, which
is the paper's claim (Listing 1's ``lda``/``loa`` walk) carried to every
mode.  There is no padding either: the kernel masks ragged edges.

The generic route's geometry, from the wrapper's point of view: C's
minor-most mode ``v`` and one other C mode ``u`` (by default the largest, as
:func:`~repro_torch.kernels.addressing.native_mode_tiles` picks it) span
a block's output tile; every other C mode is decoded from the block
index; the contracted modes are one flattened in-block loop.  At most
:data:`MAX_MODES` such modes fit one launch.

Four routes, picked by :func:`native_route` from dtypes, extents and
strides alone (the ``u``/``walk`` options only shape the generic tile):

- ``"stream"``: float32 with one big side and a narrow other side.  Read
  kind, ``C[m, r] = Σ_k X[m, k]·W[k, r]`` with ``r`` at most
  :data:`NARROW` wide and at least :data:`STREAM_MIN_ROWS` rows ``m``, X
  read through a TMA ring (its ``m`` or ``k`` stride-1); write kind,
  ``C[m, p] = Σ_k X[m, k]·W[p, k]`` with ``k`` at most :data:`NARROW`
  deep and ``p`` C's minor-most mode.
- ``"splitk"``: float32 read kind with fewer rows: the contraction is
  split across blocks (:func:`splitk_plan`) and the partial sums reduced
  in a fixed order, so every launch gives the same bits.
- ``"wgmma"``: bfloat16 weight-streaming products ``C[m, n] = Σ_k
  X[m, k]·W[k, n]``, both operands read by TMA, on the tensor cores;
  the contraction is split where the output tiles are too few to fill
  the card (:func:`wgmma_plan`), again reduced in a fixed order.
- ``"generic"``: everything else (batch modes, several contracted modes,
  mixed bf16 x f32 operands, layouts TMA cannot read, wide float32
  outputs on both sides).

:func:`native_gemm_ref` is the plain PyTorch version (an f32 einsum).  The
wrapper takes it only for tensors on the CPU; a CUDA tensor launches the
kernel or raises.  ``native_gemm.launches`` counts launches, and
``native_gemm.launches_by_route`` counts them by route.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.core.contract import infer_dims
from repro_torch.core.notation import ContractionSpec
from repro_torch.kernels import _build
from repro_torch.kernels.addressing import row_major_strides

__all__ = ["MAX_MODES", "NARROW", "ROUTES", "STREAM_MIN_ROWS", "native_gemm",
           "native_gemm_ref", "native_plan", "native_route", "route_info", "splitk_plan",
           "wgmma_plan"]

#: mode slots one launch takes (u, v, other C modes, contracted modes)
MAX_MODES = 8

ROUTES = ("stream", "splitk", "wgmma", "generic")

#: widest narrow mode the stream and splitk routes hold in registers: the
#: read kind's ``r``, the write kind's ``k`` (``NR_NARROW``)
NARROW = 16
#: an H100 SXM's SMs; the split plan aims at :data:`SPLITK_BLOCKS_PER_SM`
#: blocks on each
H100_SMS = 132
#: rows per stream tile and k per ring stage (``NS_TILE``, ``NS_BK``)
STREAM_ROWS, STREAM_BK = 512, 32
#: a read-kind problem with fewer rows than one stream tile per SM is split
STREAM_MIN_ROWS = H100_SMS * STREAM_ROWS
#: the stream read kind keeps all of W (k padded to a stage) in shared
#: memory beside its 192 KB ring (``NS_W_BYTES_MAX``)
STREAM_W_BYTES = 32 * 1024
#: rows per splitk block and X loads in flight per thread (``NK_TU``, ``NK_UNROLL``)
SPLITK_ROWS, SPLITK_UNROLL = 128, 16
SPLITK_BLOCKS_PER_SM = 8
#: the wgmma route's output tile (rows x columns) and depth per ring stage
#: (``NM_TM``, ``NM_BN``, ``NM_BK``); a split of the contraction spans at
#: least :data:`WGMMA_MIN_SPLIT_STAGES` stages (``NM_STAGES``, one ring)
WGMMA_TM, WGMMA_BN, WGMMA_BK = 64, 128, 64
WGMMA_MIN_SPLIT_STAGES = 4

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the launch descriptors, packed as the C structs of ``csrc/sb_gemm.cu``
#: lay them out (little-endian, 8-byte aligned): ``NgDesc`` (generic: ext,
#: sa, sb, sc over the slots; n_rest, n_k, walk), ``NrDesc`` (stream read
#: kind and splitk: m_ext, m_xs, m_cs; M, K, xk, wk, R, wr, cr; n_m, kc,
#: n_split, rp), ``NwDesc`` (stream write kind: M, P, K, xm, xk, wp, wk,
#: cm) and ``NmDesc`` (wgmma: M, N, K, xm, xk, wn, wk, ldc; kc, n_split).
#: Every call packs one, and ``struct`` does it several times faster than a
#: ctypes structure with array fields.
_NG_DESC = struct.Struct(f"<{4 * MAX_MODES}q3i4x")
_NR_DESC = struct.Struct("<16q4i")
_NW_DESC = struct.Struct("<8q")
_NM_DESC = struct.Struct("<8q2i")

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = _build.load("sb_gemm")
        ptr, desc, i32 = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
        lib.ng_launch.argtypes = [ptr, ptr, ptr, desc, i32, i32, i32, ptr]
        lib.ns_launch_read.argtypes = [ptr, ptr, ptr, desc, i32, ptr]
        lib.ns_launch_write.argtypes = [ptr, ptr, ptr, desc, i32, ptr]
        lib.nk_launch.argtypes = [ptr, ptr, ptr, ptr, desc, i32, ptr]
        lib.nm_launch.argtypes = [ptr, ptr, ptr, ptr, desc, i32, ptr]
        lib.nr_info.argtypes = [i32, i32, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.ng_launch, lib.ns_launch_read, lib.ns_launch_write, lib.nk_launch,
                   lib.nm_launch, lib.nr_info):
            fn.restype = ctypes.c_int
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def splitk_plan(M: int, K: int, R: int) -> dict:
    """The splitk route's launch for ``M`` rows, contraction depth ``K`` and
    narrow width ``R``: ``rp`` (R padded to 4, the registers per row),
    ``tiles`` (blocks of :data:`SPLITK_ROWS` rows), ``n_split`` splits of
    ``kc`` contracted indices each (a multiple of :data:`SPLITK_UNROLL`),
    chosen so that ``tiles * n_split`` reaches about
    :data:`SPLITK_BLOCKS_PER_SM` blocks per SM, and ``workspace``, the f32
    partial sums the wrapper allocates (``n_split * R * M``, or 0 for one
    split, which writes C directly)."""
    rp = _cdiv(R, 4) * 4
    tiles = _cdiv(M, SPLITK_ROWS)
    n_split = max(1, min(_cdiv(SPLITK_BLOCKS_PER_SM * H100_SMS, tiles),
                         _cdiv(K, SPLITK_UNROLL)))
    kc = _cdiv(_cdiv(K, n_split), SPLITK_UNROLL) * SPLITK_UNROLL
    n_split = _cdiv(K, kc)
    return {"rp": rp, "tiles": tiles, "n_split": n_split, "kc": kc,
            "workspace": n_split * R * M if n_split > 1 else 0}


def wgmma_plan(M: int, N: int, K: int) -> dict:
    """The wgmma route's launch for ``M`` rows, ``N`` columns and depth
    ``K``: ``tiles`` (output tiles of :data:`WGMMA_TM` x :data:`WGMMA_BN`),
    ``n_split`` splits of ``kc`` contracted indices each, and
    ``workspace``, the f32 partial sums the wrapper allocates (``n_split *
    M * N``, or 0 for one split, which writes C directly).  ``kc`` is a
    multiple of :data:`WGMMA_BK`, so only the last split's last stage runs
    past K (where the tensor maps read zeros), never into the next
    split's.  The column tiles times ``n_split`` come nearest to one block
    per SM, with every split at least :data:`WGMMA_MIN_SPLIT_STAGES`
    stages deep: a decode product's few wide tiles would leave most SMs
    idle, and each SM's share of the weight is what bounds the launch.
    The split depends on N and K only, never on M: a row of C is summed
    in the same order whatever other rows share the launch, so a batched
    decode step or a prefill chunk gives each row the bits it gets alone."""
    n_tiles = _cdiv(N, WGMMA_BN)
    stages = _cdiv(K, WGMMA_BK)
    want = (2 * H100_SMS + n_tiles) // (2 * n_tiles)  # H100_SMS / n_tiles, rounded
    n_split = max(1, min(want, stages // WGMMA_MIN_SPLIT_STAGES))
    kc = _cdiv(stages, n_split) * WGMMA_BK
    n_split = _cdiv(K, kc)
    return {"tiles": _cdiv(M, WGMMA_TM) * n_tiles, "n_split": n_split, "kc": kc,
            "workspace": n_split * M * N if n_split > 1 else 0}


def _tma_readable(X, xm: int, xk: int, M: int, K: int) -> bool:
    """A 2-D tensor map can read X (M, K): one stride 1, the other a
    positive multiple of 16 bytes, a 16-byte aligned start, coordinates
    that fit int32."""
    other = xm if xk == 1 else xk if xm == 1 else 0
    return (other > 0 and other % 4 == 0 and other < 2**38 and M < 2**31 and K < 2**31
            and X.data_ptr() % 16 == 0)


def _read_plan(X, x_modes, xs, r, ws, k, dims, sc, x_is_a):
    # X's C modes innermost first (by X stride); neighbours that are one
    # mode in both X and C fuse
    fused = _fuse(sorted(([dims[m], xs[m], sc[m]] for m in x_modes), key=lambda t: t[1]))
    M, K = 1, dims[k]
    for e, _, _ in fused:
        M *= e
    # a W with no C mode of extent > 1 (a matrix-vector product) has R = 1
    R, wr, cr = (dims[r], ws[r], sc[r]) if r else (1, 0, 0)
    plan = {"kind": "read", "x_is_a": x_is_a, "m": [tuple(f) for f in fused], "M": M,
            "K": K, "xk": xs[k], "wk": ws[k], "R": R, "wr": wr, "cr": cr,
            "rp": _cdiv(R, 4) * 4}
    if M >= STREAM_MIN_ROWS:
        if (len(fused) == 1 and _tma_readable(X, fused[0][1], xs[k], M, K)
                and _cdiv(K, STREAM_BK) * STREAM_BK * plan["rp"] * 4 <= STREAM_W_BYTES):
            return "stream", plan
        return "generic", None
    if len(fused) > 3:
        return "generic", None
    plan.update(splitk_plan(M, K, R))
    return "splitk", plan


def _bf16_map_ok(s0: int, s1: int, e0: int, e1: int) -> bool:
    """A 2-D bf16 tensor map can read an (e0, e1) operand of element
    strides (s0, s1): one mode stride-1, the other's stride a multiple of
    8 elements (16 bytes) that steps past the stride-1 mode's extent."""
    if s1 == 1:
        return s0 % 8 == 0 and s0 >= e1
    return s0 == 1 and s1 % 8 == 0 and s1 >= e0


def _fuse(ms):
    """``[extent, X stride, C stride]`` triples, sorted by X stride, with
    neighbours that are one mode in both X and C fused."""
    fused = [list(ms[0])] if ms else []
    for e, x, c in ms[1:]:
        f = fused[-1]
        if x == f[0] * f[1] and c == f[0] * f[2]:
            f[0] *= e
        else:
            fused.append([e, x, c])
    return fused


def _wgmma_plan(A, B, a_live, b_live, k, c_live, dims, sa, sb, sc):
    n = c_live[-1]
    if b_live == [n]:
        x_is_a, X, W, x_c, xs, ws = True, A, B, a_live, sa, sb
    elif a_live == [n]:
        x_is_a, X, W, x_c, xs, ws = False, B, A, b_live, sb, sa
    else:
        return "generic", None
    fused = _fuse(sorted(([dims[m], xs[m], sc[m]] for m in x_c), key=lambda t: t[1]))
    if len(fused) > 1:
        return "generic", None
    M, K, N = (fused[0][0] if fused else 1), dims[k], dims[n]
    xk, wk, wn = xs[k], ws[k], ws[n]
    if M == 1:
        # a single row is never stepped along: give the map a legal stride
        xm, ldc = (_cdiv(K, 8) * 8 if xk == 1 else 1), N
    else:
        _, xm, ldc = fused[0]
    if not (_bf16_map_ok(xm, xk, M, K) and _bf16_map_ok(wk, wn, K, N)
            and max(M, N, K) < 2**31 and X.data_ptr() % 16 == 0 and W.data_ptr() % 16 == 0):
        return "generic", None
    return "wgmma", {"kind": "wgmma", "x_is_a": x_is_a, "M": M, "N": N, "K": K, "xm": xm,
                     "xk": xk, "wn": wn, "wk": wk, "ldc": ldc, **wgmma_plan(M, N, K)}


def native_plan(A, B, *, a_modes: str, b_modes: str, c_modes: str, dims=None):
    """The route of :func:`native_gemm` and its launch plan: ``(route,
    plan)``, ``plan`` None on the generic route.  Reads only dtypes,
    extents, strides and the start's alignment, so it runs on CPU and
    meta tensors too.

    Every route but ``"generic"`` needs exactly one contracted mode ``k``
    of extent > 1 that is no C mode (extent-1 modes are ignored
    everywhere), so no batch mode.  Float32 operands:

    - read kind: one operand W has, besides ``k``, at most one mode ``r``
      (a C mode at most :data:`NARROW` wide; none: a matrix-vector
      product); the other, X, carries the remaining C modes ``m`` (the
      smaller W is taken where both fit).
      ``"stream"`` with at least :data:`STREAM_MIN_ROWS` rows, ``m`` one
      mode after fusing, X readable by a 2-D tensor map and W within
      :data:`STREAM_W_BYTES`; else ``"generic"``.  Fewer rows, ``m`` up to
      three modes: ``"splitk"`` (:func:`splitk_plan`).
    - write kind: ``k`` at most :data:`NARROW` deep, C two modes ``(m,
      p)``, W carrying ``p`` and ``k``, X ``m`` and ``k``: ``"stream"``.

    Bfloat16 operands (both; any output type) take ``"wgmma"``
    (:func:`wgmma_plan`) when ``n``, the minor-most C mode of extent > 1,
    is carried by one operand W together with ``k`` and nothing else, and
    the other operand X carries every other C mode, fusing into one row
    mode ``m`` (none: M = 1); and when each operand is readable by a 2-D
    tensor map: one of its two modes stride-1, the other's stride a
    multiple of 16 bytes that steps past the first's extent (an extent-1
    mode's stride is replaced by a legal one), and a 16-byte aligned
    start.  Mixed bf16 x f32 operands, and everything else, take
    ``"generic"``.
    """
    if A.dtype != B.dtype or A.dtype not in (torch.float32, torch.bfloat16):
        return "generic", None
    if dims is None:
        dims = infer_dims(ContractionSpec(a_modes, b_modes, c_modes), A, B)
    if 0 in dims.values():
        return "generic", None
    shared = [m for m in a_modes if m in b_modes and dims[m] > 1]
    if len(shared) != 1 or shared[0] in c_modes:
        return "generic", None
    k = shared[0]
    sa, sb = dict(zip(a_modes, A.stride())), dict(zip(b_modes, B.stride()))
    sc = dict(zip(c_modes, row_major_strides([dims[m] for m in c_modes])))
    a_c = [m for m in a_modes if m != k and dims[m] > 1]
    b_c = [m for m in b_modes if m != k and dims[m] > 1]
    c_live = [m for m in c_modes if dims[m] > 1]
    if A.dtype == torch.bfloat16:
        if not c_live:
            return "generic", None
        return _wgmma_plan(A, B, a_c, b_c, k, c_live, dims, sa, sb, sc)
    read = [(w.numel(), x_is_a) for x_is_a, w, w_c, x_c in ((True, B, b_c, a_c),
                                                           (False, A, a_c, b_c))
            if x_c and (not w_c or len(w_c) == 1 and dims[w_c[0]] <= NARROW)]
    if read:
        x_is_a = min(read)[1]
        X, x_c, xs, w_c, ws = (A, a_c, sa, b_c, sb) if x_is_a else (B, b_c, sb, a_c, sa)
        return _read_plan(X, x_c, xs, w_c[0] if w_c else None, ws, k, dims, sc, x_is_a)
    if dims[k] <= NARROW and len(c_live) == 2:
        m, p = c_live
        for x_is_a, x_c, xs, w_c, ws in ((True, a_c, sa, b_c, sb), (False, b_c, sb, a_c, sa)):
            if x_c == [m] and w_c == [p]:
                return "stream", {"kind": "write", "x_is_a": x_is_a, "M": dims[m],
                                  "P": dims[p], "K": dims[k], "xm": xs[m], "xk": xs[k],
                                  "wp": ws[p], "wk": ws[k], "cm": sc[m]}
    return "generic", None


def native_route(A, B, *, a_modes: str, b_modes: str, c_modes: str) -> str:
    """The route :func:`native_gemm` launches for these operands (one of
    :data:`ROUTES`); see :func:`native_plan`."""
    return native_plan(A, B, a_modes=a_modes, b_modes=b_modes, c_modes=c_modes)[0]


def _read_desc(plan) -> bytes:
    m = plan["m"] + [(1, 0, 0)] * (3 - len(plan["m"]))
    return _NR_DESC.pack(
        *(e for e, _, _ in m), *(x for _, x, _ in m), *(c for _, _, c in m), plan["M"],
        plan["K"], plan["xk"], plan["wk"], plan["R"], plan["wr"], plan["cr"], len(plan["m"]),
        plan.get("kc", 0), plan.get("n_split", 1), plan["rp"])


def route_info(K: int = 512, rp: int = 12) -> dict:
    """Registers and spilled (local) bytes per thread, and shared bytes
    per block, of the kernels of the stream, splitk and wgmma routes: the
    float32-output stream and splitk kernels (the stream read kernels at
    depth ``K``, the read kinds at padded width ``rp``), and the
    bfloat16-output wgmma kernel for each operand layout, with its
    split reduction.  Needs the card (it loads the library)."""
    lib = _library()
    kinds = {"stream read, m stride-1": 0, "stream read, k stride-1": 1,
             "stream write": 2, "splitk": 3, "splitk reduce": 4,
             "wgmma, X K-major, W N-major": 5, "wgmma, X K-major, W K-major": 6,
             "wgmma, X M-major, W N-major": 7, "wgmma, X M-major, W K-major": 8,
             "wgmma split reduce": 9}
    info = {}
    for name, kind in kinds.items():
        out = (ctypes.c_int * 3)()
        rc = lib.nr_info(kind, rp, K, out)
        if rc != 0:
            raise RuntimeError(f"nr_info: {lib.ng_error_string(rc).decode()}")
        info[name] = {"registers": out[0], "spill_bytes": out[1], "smem_bytes": out[2]}
    return info


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
      u: the C mode that spans the generic route's tile rows (default:
        the largest C mode other than the minor-most).
      walk, walk_mode: on the generic route, one block walks ``walk``
        consecutive indices of the C mode ``walk_mode`` (the paper's
        extended-transpose brick depth).  Both are checked on every route
        and shape only the generic tile.

    Launches the route :func:`native_route` picks.  Returns a new
    contiguous tensor with modes ``c_modes``.
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
    if 2 + len(rest) + len(contracted) > MAX_MODES:
        raise ValueError(
            f"{a_modes},{b_modes}->{c_modes} needs {2 + len(rest) + len(contracted)} "
            f"mode slots; native_gemm takes at most {MAX_MODES}")

    route, plan = native_plan(A, B, a_modes=a_modes, b_modes=b_modes, c_modes=c_modes,
                              dims=dims)
    c_shape = [dims[m] for m in c_modes]
    if route == "generic":
        # flattened K walks its last mode fastest: give that place to the
        # mode with the smallest stride in the larger operand
        big, big_modes = (A, a_modes) if A.numel() >= B.numel() else (B, b_modes)
        contracted.sort(key=lambda m: -big.stride(big_modes.index(m)))
        slots = [u, v, *rest, *contracted]

        def strides(shape_strides, modes):
            # extent-1 modes (and an absent u) get stride 0: the kernel then
            # stages nothing along them
            return [shape_strides[modes.index(m)] if m is not None and m in modes
                    and dims[m] > 1 else 0 for m in slots]

        sa, sb = strides(A.stride(), a_modes), strides(B.stride(), b_modes)
        sc = strides(row_major_strides(c_shape), c_modes)
        # the kernel's fast path wants A varying along u only and B along v
        # only; the product commutes, so swap operands that arrive the other
        # way
        swap = bool((sa[1] or sb[0]) and not (sb[1] or sa[0]))
        if swap:
            sa, sb = sb, sa
        pad = [0] * (MAX_MODES - len(slots))
        desc = _NG_DESC.pack(
            *[1 if m is None else dims[m] for m in slots], *pad, *sa, *pad, *sb, *pad, *sc,
            *pad, len(rest), len(contracted), int(walk))
        X, Y = (B, A) if swap else (A, B)
    elif route == "wgmma":
        desc = _NM_DESC.pack(*(plan[f] for f in ("M", "N", "K", "xm", "xk", "wn", "wk", "ldc",
                                                 "kc", "n_split")))
        X, Y = (A, B) if plan["x_is_a"] else (B, A)
    else:
        desc = _read_desc(plan) if plan["kind"] == "read" else _NW_DESC.pack(
            *(plan[f] for f in ("M", "P", "K", "xm", "xk", "wp", "wk", "cm")))
        X, Y = (A, B) if plan["x_is_a"] else (B, A)

    if A.device.type == "cpu":
        # the route and launch geometry above are built on every device;
        # the CPU has no kernel and takes the plain version
        return native_gemm_ref(A, B, a_modes=a_modes, b_modes=b_modes,
                               c_modes=c_modes, out_dtype=out_dtype)
    out = torch.empty(c_shape, dtype=out_dtype, device=A.device)
    if out.numel() == 0:
        return out
    lib = _library()
    tc = _TYPE_CODES[out_dtype]
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        if route == "generic":
            rc = lib.ng_launch(X.data_ptr(), Y.data_ptr(), out.data_ptr(), desc,
                               _TYPE_CODES[X.dtype], _TYPE_CODES[Y.dtype], tc, stream)
        elif route in ("splitk", "wgmma"):
            ws = (torch.empty(plan["workspace"], dtype=torch.float32, device=A.device)
                  if plan["workspace"] else None)
            launch = lib.nk_launch if route == "splitk" else lib.nm_launch
            rc = launch(X.data_ptr(), Y.data_ptr(), out.data_ptr(),
                        None if ws is None else ws.data_ptr(), desc, tc, stream)
        elif plan["kind"] == "read":
            rc = lib.ns_launch_read(X.data_ptr(), Y.data_ptr(), out.data_ptr(),
                                    desc, tc, stream)
        else:
            rc = lib.ns_launch_write(X.data_ptr(), Y.data_ptr(), out.data_ptr(),
                                     desc, tc, stream)
    if rc != 0:
        raise RuntimeError(f"native_gemm launch failed on the {route} route: "
                           f"{lib.ng_error_string(rc).decode()}")
    native_gemm.launches += 1
    native_gemm.launches_by_route[route] += 1
    return out


native_gemm.launches = 0
native_gemm.launches_by_route = dict.fromkeys(ROUTES, 0)
