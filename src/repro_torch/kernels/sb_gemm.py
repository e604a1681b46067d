"""StridedBatchedGEMM on Hopper: the native-layout contraction kernel.

:func:`native_gemm` evaluates one pairwise contraction
``C[c_modes] = Σ A[a_modes]·B[b_modes]`` in a single launch of the CUDA
kernel in ``csrc/sb_gemm.cu``, the port of the TPU kernel
``native_gemm_pallas`` (``src/repro/kernels/sb_gemm.py``).  The operands
are read in place through their own strides (``tensor.stride()``):
transposed, sliced and stride-0 views cost no permute and no copy, which
is the paper's claim (Listing 1's ``lda``/``loa`` walk) carried to every
mode.  There is no padding either: the kernel masks ragged edges.

Six routes, picked by :func:`native_route` from dtypes, extents and
strides alone.  Contracted modes that are one mode in both operands
(neighbours in the same order, the outer one's stride the inner one's
extent times its stride) are first fused into one, so a weight gradient
``bsf,bse->ef`` is a GEMM of depth b·s:

- ``"stream"``: float32 with one big side and a narrow other side.  Read
  kind, ``C[m, r] = Σ_k X[m, k]·W[k, r]`` with ``r`` at most
  :data:`NARROW` wide and at least :data:`STREAM_MIN_ROWS` rows ``m``, X
  read through a TMA ring (its ``m`` or ``k`` stride-1); write kind,
  ``C[m, p] = Σ_k X[m, k]·W[p, k]`` with ``k`` at most :data:`NARROW`
  deep and ``p`` C's minor-most mode.
- ``"splitk"``: float32 read kind with fewer rows: the contraction is
  split across blocks (:func:`splitk_plan`) and the partial sums reduced
  in a fixed order, so every launch gives the same bits.
- ``"wgmma"``: bfloat16 products ``C[m, n] = Σ_k X[m, k]·W[k, n]``
  (weight streaming, the weight gradients), both operands read by TMA,
  on the tensor cores; the contraction is split where the output tiles
  are too few to fill the card (:func:`wgmma_plan`), again reduced in a
  fixed order.
- ``"batched"``: the same kernel for bfloat16 products with batch modes
  (the attention scores and P·V, the expert products), C modes of X that
  do not fuse into one row mode, or contracted modes that do not fuse
  into one: ``C[g.., m, n] = Σ_{o.., k} X[g.., o.., m, k]·W[g.., o.., k,
  n]`` with up to :data:`WGMMA_MAX_EXTRA` grid modes ``g`` and outer
  contracted modes ``o`` in all, each a box-1 dimension of the tensor map
  of each operand that carries it; never split.
- ``"gathered"``: every other bfloat16 product with a contracted mode
  and an own C mode: the fbatched form below (grid modes from either
  operand, up to :data:`MAX_MODES` grid and outer modes, any strides) on
  the same tensor-core consumer, its stages gathered through the
  operands' strides by a producer warpgroup instead of TMA (bf16 rows no
  tensor map can step, Table II's layouts in bf16); never split.
- ``"fbatched"``: every other product, float32, mixed bf16 x float32 or
  degenerate bf16 (an outer product, no own C mode, a zero extent): the
  same form, ``C[g.., m, n] = Σ_{o.., k} X[g.., o.., m, k]·W[g.., o..,
  k, n]``, with grid modes carried by X, by W or by both (stride 0 in the
  operand that lacks one), outer contracted modes walked in the kernel,
  any strides, on the FMA units in float32 (no TF32; a bf16 operand is
  widened on its way to shared memory).  The Table II cases, the paper's
  Figs. 1-8, HOOI's Gram ``mnp,mqp->nq``.  The contraction is split where
  the output tiles are too few to fill the card (:func:`fbatched_plan`),
  one :data:`SUM_CHUNK` of indices a split, reduced in split order: the
  chunk sums a single block adds in the same order, so the split moves
  no bit.

:func:`native_gemm` checks a call and hands it to the registered operator
``repro_torch::native_gemm`` (:data:`NATIVE_GEMM_OP`), whose CUDA kernel
launches the route's kernel or raises, whose CPU kernel runs
:func:`native_gemm_ref`, the plain PyTorch version (an f32 einsum), and
whose fake kernel gives C's shape alone, so a step on the kernel backend
traces under ``FakeTensorMode`` (:mod:`repro_torch.launch.dryrun`).
``native_gemm.launches`` counts launches, and
``native_gemm.launches_by_route`` counts them by route; only the CUDA
kernel counts.
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.contract import infer_dims
from repro_torch.core.notation import ContractionSpec
from repro_torch.kernels import _build
from repro_torch.kernels.addressing import row_major_strides
from repro_torch.utils import ROUTERS

__all__ = ["MAX_MODES", "NARROW", "NATIVE_GEMM_OP", "ROUTES", "STREAM_MIN_ROWS", "SUM_CHUNK",
           "WGMMA_MAX_EXTRA", "fbatched_plan", "native_gemm", "native_gemm_ref", "native_plan",
           "native_route", "route_info", "splitk_plan", "wgmma_plan"]

#: most grid and outer contracted modes of one fbatched or gathered launch
#: (``SB_MAX_MODES``)
MAX_MODES = 8

ROUTES = ("stream", "splitk", "wgmma", "batched", "gathered", "fbatched")

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
#: the wgmma and batched routes' output tile (rows x columns; rows
#: :data:`WGMMA_TM` up to that many, else :data:`WGMMA_TM_WIDE`) and depth
#: per ring stage (``NM_TM``, ``NM_TM_WIDE``, ``NM_BN``, ``NM_BK``); a split
#: of the contraction spans at least :data:`WGMMA_MIN_SPLIT_STAGES` stages
#: (``NM_STAGES``, one ring)
WGMMA_TM, WGMMA_TM_WIDE, WGMMA_BN, WGMMA_BK = 64, 128, 128, 64
WGMMA_MIN_SPLIT_STAGES = 4
#: most grid and outer contracted modes of one launch (``NM_MAX_EXTRA``): a
#: tensor map has at most 5 dimensions, two of them the operand's matrix
WGMMA_MAX_EXTRA = 3
#: the fbatched route's output tile (rows x columns, or x
#: :data:`FBATCHED_TN_NARROW` columns where N is at most that wide, or
#: :data:`FBATCHED_TM_SMALL` x :data:`FBATCHED_TN_NARROW` for a small
#: product), depth per ring stage, ring depth and threads (``FB_TM``,
#: ``FB_TN``, ``FB_TN_NARROW``, ``FB_TM_SMALL``, ``FB_BK``, ``FB_STAGES``,
#: ``FB_THREADS``)
FBATCHED_TM, FBATCHED_TN, FBATCHED_TN_NARROW, FBATCHED_BK = 128, 128, 64, 32
FBATCHED_TM_SMALL = 64
FBATCHED_STAGES, FBATCHED_THREADS = 4, 256
#: contracted indices per partial sum (``SB_SUM_CHUNK``): a float32
#: contraction deeper than this sums each chunk apart and adds the chunk
#: sums in order, and a split spans one chunk
SUM_CHUNK = 4096
#: a product with fewer output tiles than this many per SM is split
#: (``FB_SPLIT_PER_SM``), one chunk a split, where its partial sums (a
#: float32 plane of C a chunk) take at most this many bytes
FBATCHED_BLOCKS_PER_SM = 2
FBATCHED_SPLIT_MAX_BYTES = 1 << 28
#: the gathered route's ring depth and producer threads (``GA_STAGES``,
#: ``GA_PRODUCERS``); its tile and stage depth are the wgmma route's
GATHERED_STAGES, GATHERED_PRODUCERS = 4, 128
#: the narrowest stride-1 mode the gathered route takes as a tile mode
#: where k is not stride-1 (:func:`_unit_mode`): a quarter of a 64-row tile
GATHERED_MIN_UNIT = 16

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the launch descriptors, packed as the C structs of ``csrc/sb_gemm.cu``
#: lay them out (little-endian, 8-byte aligned): ``NrDesc`` (stream read
#: kind and splitk: m_ext, m_xs, m_cs; M, K, xk, wk, R, wr, cr; n_m, kc,
#: n_split, rp), ``NwDesc`` (stream write kind: M, P, K, xm, xk, wp, wk,
#: cm), ``NmDesc`` (wgmma and batched: M, N, K; the extra modes' extents,
#: grid modes first; X's strides of m, k and the extra modes, W's of n, k
#: and the extra modes, C's of m and the grid modes; n_grid, n_extra, kc,
#: n_split) and ``FbDesc`` (fbatched and gathered: M, N, K; X's strides of
#: m and k, W's of n and k, C's of m and n; the extra modes' extents and
#: X, W and C strides, grid modes first; G, steps, spc; n_grid, n_extra,
#: n_split, flags).
#: Every call packs one, and ``struct`` does it several times faster than a
#: ctypes structure with array fields.
_NR_DESC = struct.Struct("<16q4i")
_NW_DESC = struct.Struct("<8q")
_NM_DESC = struct.Struct(f"<{3 + 3 + 5 + 5 + 4}q4i")
_FB_DESC = struct.Struct(f"<{9 + 4 * MAX_MODES + 3}q4i")
#: the fbatched descriptor's flag bits (``FB_F_*``); the gathered route
#: reads the two layout bits and whether X's and W's stages load 16 bytes
#: at a time (``GA_F_WIDE_X``, ``GA_F_WIDE_W``)
(_FB_CHUNKED, _FB_VEC_X, _FB_VEC_W, _FB_VEC_C, _FB_X_KMAJOR, _FB_W_KMAJOR, _FB_NARROW_N,
 _FB_SMALL, _FB_X_BF16, _FB_W_BF16) = (1 << i for i in range(10))
_FB_RAW_X, _FB_RAW_W = 1 << 14, 1 << 15
_GA_WIDE_X, _GA_WIDE_W = 1 << 10, 1 << 11

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = _build.load("sb_gemm")
        ptr, desc, i32 = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
        lib.ns_launch_read.argtypes = [ptr, ptr, ptr, desc, i32, ptr]
        lib.ns_launch_write.argtypes = [ptr, ptr, ptr, desc, i32, ptr]
        lib.nk_launch.argtypes = [ptr, ptr, ptr, ptr, desc, i32, ptr]
        lib.nm_launch.argtypes = [ptr, ptr, ptr, ptr, desc, i32, ptr]
        lib.fb_launch.argtypes = [ptr, ptr, ptr, ptr, desc, i32, ptr]
        lib.ga_launch.argtypes = [ptr, ptr, ptr, desc, i32, ptr]
        lib.nr_info.argtypes = [i32, i32, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.ns_launch_read, lib.ns_launch_write, lib.nk_launch, lib.nm_launch,
                   lib.fb_launch, lib.ga_launch, lib.nr_info):
            fn.restype = ctypes.c_int
        lib.sb_error_string.argtypes = [ctypes.c_int]
        lib.sb_error_string.restype = ctypes.c_char_p
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


def wgmma_plan(M: int, N: int, K: int, G: int = 1, split: bool = True) -> dict:
    """The launch of the wgmma and batched routes for ``G`` grid indices
    of ``M`` rows, ``N`` columns and depth ``K``: ``tiles`` (output tiles
    of :data:`WGMMA_TM` rows, or :data:`WGMMA_TM_WIDE` above that many, x
    :data:`WGMMA_BN` columns, at every grid index), ``n_split`` splits of
    ``kc`` contracted indices each (a multiple of :data:`WGMMA_BK`, so
    only the last split's last stage runs past K) and ``workspace``, the
    f32 partial sums the wrapper allocates (``n_split * M * N``, or 0 for
    one split, which writes C directly).

    Only a ``split`` product is split (X K-major with no grid or outer
    contracted mode: weight streaming, whose few column tiles would leave
    most SMs idle, and each SM's share of the weight is what bounds the
    launch): to about one block per SM, with every split at least
    :data:`WGMMA_MIN_SPLIT_STAGES` stages deep.  The split depends on N
    and K only, so a row of C is summed in the same order whatever other
    rows share the launch: a batched decode step or a prefill chunk gives
    each row the bits it gets alone.  The products that are never split
    (a weight gradient, whose X is M-major; a batched product, whose grid
    grows with the batch of slots or requests) keep that too."""
    tm = WGMMA_TM if M <= WGMMA_TM else WGMMA_TM_WIDE
    n_tiles = _cdiv(N, WGMMA_BN)
    stages = _cdiv(K, WGMMA_BK)
    want = (2 * H100_SMS + n_tiles) // (2 * n_tiles) if split else 1  # H100_SMS / n_tiles
    n_split = max(1, min(want, stages // WGMMA_MIN_SPLIT_STAGES))
    kc = _cdiv(stages, n_split) * WGMMA_BK
    n_split = _cdiv(K, kc)
    return {"tiles": G * _cdiv(M, tm) * n_tiles, "n_split": n_split, "kc": kc,
            "workspace": n_split * M * N if n_split > 1 else 0}


def fbatched_plan(M: int, N: int, K: int, G: int = 1, O: int = 1) -> dict:
    """The fbatched route's launch for ``G`` grid indices of ``M`` rows and
    ``N`` columns, contracted over ``O`` outer indices of depth ``K``:
    ``tm`` and ``tn`` (the tile's rows and columns), ``tiles`` (output
    tiles at every grid index), ``steps`` (ring stages of
    :data:`FBATCHED_BK` along k, at each
    outer index: the in-kernel walk, outer index slowest), ``n_split``
    splits of ``spc`` stages each and ``workspace``, the f32 partial sums
    the wrapper allocates (``n_split * G * M * N``, or 0 for one split,
    which writes C directly); ``chunked``: a block's walk spans more than
    one :data:`SUM_CHUNK`, so it keeps a second accumulator.

    A product of at most :data:`FBATCHED_TM_SMALL` rows, or too small to
    give half the SMs a 128-row tile and too shallow to split (one chunk
    or less), takes :data:`FBATCHED_TM_SMALL`-row tiles instead: no more
    than half of each tile idle (Table II's ragged p = 47 rows), or four
    times the blocks for the same latency-bound work (Table II at n =
    64; at n = 128, Fig. 3's 128 tiles ran faster on 128 rows).

    A product with fewer than :data:`FBATCHED_BLOCKS_PER_SM` tiles per SM
    and more than one chunk (``SUM_CHUNK / FBATCHED_BK`` stages) is split
    one chunk a split, where the partial sums fit
    :data:`FBATCHED_SPLIT_MAX_BYTES`: the reduction then adds the chunk
    sums in order, ``((0 + c0) + c1) + ...``, as one block's chunked walk
    adds them, so a split moves no bit.  Whether a product splits depends
    on its rows and grid (a decode slot in a larger bucket, a prompt's
    chunk against the whole prompt); what each output sums, and in which
    order, does not: a row's bits never depend on what shares its
    launch."""
    tm, tn = FBATCHED_TM, FBATCHED_TN if N > FBATCHED_TN_NARROW else FBATCHED_TN_NARROW
    steps = O * _cdiv(K, FBATCHED_BK)
    chunk = SUM_CHUNK // FBATCHED_BK
    if M <= FBATCHED_TM_SMALL or 2 * G * _cdiv(M, tm) * _cdiv(N, tn) < H100_SMS and steps <= chunk:
        tm, tn = FBATCHED_TM_SMALL, FBATCHED_TN_NARROW
    tiles = G * _cdiv(M, tm) * _cdiv(N, tn)
    target = FBATCHED_BLOCKS_PER_SM * H100_SMS
    n_split, spc = 1, steps
    chunks = _cdiv(steps, chunk)
    if (0 < tiles < target and 1 < chunks < 2**16
            and 4 * chunks * G * M * N <= FBATCHED_SPLIT_MAX_BYTES):
        n_split, spc = chunks, chunk
    return {"tm": tm, "tn": tn, "tiles": tiles, "steps": steps, "n_split": n_split, "spc": spc,
            "chunked": min(spc, steps) > chunk,
            "workspace": n_split * G * M * N if n_split > 1 else 0}


def _tma_readable(X, xm: int, xk: int, M: int, K: int) -> bool:
    """A 2-D tensor map can read X (M, K): one stride 1, the other a
    positive multiple of 16 bytes, a 16-byte aligned start, coordinates
    that fit int32."""
    other = xm if xk == 1 else xk if xm == 1 else 0
    return (other > 0 and other % 4 == 0 and other < 2**38 and M < 2**31 and K < 2**31
            and _address(X) % 16 == 0)


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
        return None, None
    if len(fused) > 3:
        return None, None
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


def _row_stride(M: int, xk: int, K: int, fused) -> int:
    """X's stride along its row mode; a single row is never stepped along,
    so its map gets a legal stride."""
    if M == 1:
        return _cdiv(K, 8) * 8 if xk == 1 else 1
    return fused[1]


def _map_stride_ok(s: int) -> bool:
    """A tensor map can step a bf16 mode of this element stride past its
    matrix modes: positive, a multiple of 16 bytes, within TMA's range."""
    return 0 < s < 2**39 and s % 8 == 0


def _tc_plan(A, B, a_c, b_c, k, batch, outer, c_live, dims, sa, sb, sc):
    """The wgmma or batched plan of bf16 A and B, or ``(None, None)``
    where a tensor map cannot read them; ``outer`` the contracted modes
    that do not fuse with ``k``, as ``(extent, A stride, B stride)``."""
    n = c_live[-1]
    if n in batch:
        return None, None
    if n in b_c:
        x_is_a, X, W, x_c, w_c, xs, ws = True, A, B, a_c, b_c, sa, sb
    else:
        x_is_a, X, W, x_c, w_c, xs, ws = False, B, A, b_c, a_c, sb, sa
    if [m for m in w_c if m not in batch] != [n]:
        return None, None
    # X's own C modes fuse where they can; the widest is the row mode m,
    # the rest are grid modes beside the batch modes
    own = [m for m in x_c if m not in batch]
    fused = _fuse(sorted(([dims[m], xs[m], sc[m]] for m in own), key=lambda t: t[1]))
    row = max(fused, key=lambda f: f[0]) if fused else None
    M, K, N = (row[0] if row else 1), dims[k], dims[n]
    xk, wk, wn = xs[k], ws[k], ws[n]
    xm = _row_stride(M, xk, K, row)
    ldc = row[2] if row else N
    # (extent, X stride, W stride, C stride), innermost in C first; W
    # carries the batch modes, not X's own
    grid = sorted([(dims[b], xs[b], ws[b], sc[b]) for b in batch]
                  + [(f[0], f[1], 0, f[2]) for f in fused if f is not row], key=lambda g: g[3])
    in_w = [g[2] != 0 for g in grid]
    outer = [(e, a, b) if x_is_a else (e, b, a) for e, a, b in outer]
    G = 1
    for g in grid:
        G *= g[0]
    if not (len(grid) + len(outer) <= WGMMA_MAX_EXTRA
            and _bf16_map_ok(xm, xk, M, K) and _bf16_map_ok(wk, wn, K, N)
            and all(_map_stride_ok(g[1]) for g in grid)
            and sum(in_w) == len(batch)
            and all(_map_stride_ok(g[2]) for g, w in zip(grid, in_w) if w)
            and all(_map_stride_ok(x) and _map_stride_ok(w) for _, x, w in outer)
            and max(M, N, K, G) < 2**31 and _address(X) % 16 == 0
            and _address(W) % 16 == 0):
        return None, None
    plan = wgmma_plan(M, N, K, G, split=not grid and not outer and xk == 1)
    if plan["tiles"] >= 2**31:
        return None, None
    route = "batched" if grid or outer else "wgmma"
    return route, {"kind": route, "x_is_a": x_is_a, "M": M, "N": N, "K": K, "xm": xm,
                   "xk": xk, "wn": wn, "wk": wk, "ldc": ldc, "grid": grid, "outer": outer,
                   "G": G, **plan}


def _row_mode(fused, k_stride: int):
    """X's row mode among its own fused C modes ``[extent, stride, C
    stride]``: the stride-1 one, so that its slabs load 16 bytes at a
    time, where k is not stride-1 and that mode is at least ``min(widest,
    FBATCHED_TM)`` wide; else the widest (ties: the smaller C stride);
    None without a mode."""
    if not fused:
        return None
    widest = max(fused, key=lambda f: (f[0], -f[2]))
    unit = next((f for f in fused if f[1] == 1), None)
    if k_stride != 1 and unit is not None and unit[0] >= min(widest[0], FBATCHED_TM):
        return unit
    return widest


def _column_mode(fused):
    """W's column mode: the own fused C mode innermost in C, so that C's
    rows store whole sectors; None without a mode.  In the exceptional
    Table II cases W carries C's minor-most mode and a second C mode that
    is stride-1 in W; on an H100 they ran faster with this column than
    with W's stride-1 mode, whose C stores went a word at a time."""
    return min(fused, key=lambda f: f[2]) if fused else None


def _k_major(sk: int, smn: int) -> bool:
    """A slab is laid out k-major (k the stored minor dimension) where k's
    stride is the smaller nonzero one of the two."""
    def key(s):
        return abs(s) if s else float("inf")
    return key(sk) < key(smn)


def _unit_mode(fused, k_stride: int):
    """The gathered route's tile mode of an operand with k not stride-1:
    its own fused C mode ``[extent, stride, C stride]`` that is stride-1,
    where it is at least :data:`GATHERED_MIN_UNIT` wide, so that its
    stages load neighbouring elements; else None."""
    unit = next((f for f in fused if f[1] == 1), None)
    return unit if k_stride != 1 and unit is not None and unit[0] >= GATHERED_MIN_UNIT else None


def _strided_form(A, B, a_c, b_c, k, batch, outer, c_live, dims, sa, sb, sc, zero_k,
                  gather=False):
    """The form ``C[g.., m, n] = Σ_{o.., k} X[g.., o.., m, k]·W[g.., o..,
    k, n]`` of the fbatched and gathered routes: ``(plan, X, W)``, the
    plan's ``M``, ``N``, ``K``, the tile modes' strides, ``grid``,
    ``outer``, ``G`` and ``O``; ``k`` None where no mode is contracted
    (then K is 1 at stride 0), ``zero_k`` where a contracted mode has
    extent 0 (then K is 0 and C is zeros); ``outer`` the contracted modes
    that do not fuse with ``k``, as ``(extent, A stride, B stride)``.
    ``gather``: the tile modes are each operand's stride-1 own mode where
    k is not stride-1 (:func:`_unit_mode`), else as fbatched picks them.
    Raises where the grid and outer modes are more than :data:`MAX_MODES`."""
    own_a = [m for m in a_c if m not in batch]
    own_b = [m for m in b_c if m not in batch]
    # W carries C's innermost mode that only one operand carries
    n = next((m for m in reversed(c_live) if m in own_a or m in own_b), None)
    x_is_a = n not in own_a
    X, W, x_own, w_own, xs, ws = ((A, B, own_a, own_b, sa, sb) if x_is_a
                                  else (B, A, own_b, own_a, sb, sa))
    K, xk, wk = (dims[k], xs[k], ws[k]) if k else (1, 0, 0)
    if zero_k:
        K = 0
    fx = _fuse(sorted(([dims[m], xs[m], sc[m]] for m in x_own), key=lambda t: t[1]))
    fw = _fuse(sorted(([dims[m], ws[m], sc[m]] for m in w_own), key=lambda t: t[1]))
    row = (_unit_mode(fx, xk) if gather else None) or _row_mode(fx, xk)
    col = (_unit_mode(fw, wk) if gather else None) or _column_mode(fw)
    M, xm, cm = row or (1, 0, 0)
    N, wn, cn = col or (1, 0, 0)
    # (extent, X stride, W stride, C stride), innermost in C first; neighbours
    # that are one mode in X, W and C fuse
    grid = sorted([(dims[b], xs[b], ws[b], sc[b]) for b in batch]
                  + [(f[0], f[1], 0, f[2]) for f in fx if f is not row]
                  + [(f[0], 0, f[1], f[2]) for f in fw if f is not col], key=lambda g: g[3])
    fused = []
    for g in grid:
        f = fused[-1] if fused else None
        if f and all(g[i] == f[0] * f[i] for i in (1, 2, 3)):
            fused[-1] = (f[0] * g[0], *f[1:])
        else:
            fused.append(g)
    grid = fused
    outer = [(e, a, b) if x_is_a else (e, b, a) for e, a, b in outer]
    G = O = 1
    for g in grid:
        G *= g[0]
    for o in outer:
        O *= o[0]
    if len(grid) + len(outer) > MAX_MODES:
        raise ValueError(f"the product needs {len(grid) + len(outer)} grid and outer mode "
                         f"slots; native_gemm takes at most {MAX_MODES} grid and outer modes")
    return {"x_is_a": x_is_a, "M": M, "N": N, "K": K, "xm": xm, "xk": xk, "wn": wn, "wk": wk,
            "cm": cm, "cn": cn, "grid": grid, "outer": outer, "G": G, "O": O}, X, W


def _fb_plan(A, B, a_c, b_c, k, batch, outer, c_live, dims, sa, sb, sc, zero_k=False):
    """The fbatched plan of A and B, each float32 or bfloat16 (see
    :func:`_strided_form`)."""
    form, X, W = _strided_form(A, B, a_c, b_c, k, batch, outer, c_live, dims, sa, sb, sc,
                               zero_k)
    M, N, K, xm, xk, wn, wk, cm, grid = (form[f] for f in ("M", "N", "K", "xm", "xk", "wn",
                                                           "wk", "cm", "grid"))
    outer = form["outer"]
    plan = fbatched_plan(M, N, K, form["G"], form["O"])
    if plan["tiles"] >= 2**31 or plan["steps"] >= 2**31:
        raise ValueError(f"fbatched takes fewer than 2^31 tiles and 2^31 stages, not "
                         f"{plan['tiles']} and {plan['steps']}")
    x_km, w_km = _k_major(xk, xm), _k_major(wk, wn)

    def vec(T, km, s_mn, s_k, extra):
        # 16-byte loads along the slab's stored minor dimension
        minor, other = (s_k, s_mn) if km else (s_mn, s_k)
        per = 16 // T.element_size()
        return (minor == 1 and all(s % per == 0 for s in (other, *extra))
                and _address(T) % 16 == 0)

    flags = ((_FB_CHUNKED if plan["chunked"] else 0)
             | (_FB_VEC_X if vec(X, x_km, xm, xk, [g[1] for g in grid] + [o[1] for o in outer])
                else 0)
             | (_FB_VEC_W if vec(W, w_km, wn, wk, [g[2] for g in grid] + [o[2] for o in outer])
                else 0)
             | (_FB_VEC_C if form["cn"] == 1
                and all(s % 4 == 0 for s in (cm, *(g[3] for g in grid))) else 0)
             | (_FB_X_KMAJOR if x_km else 0) | (_FB_W_KMAJOR if w_km else 0)
             | (_FB_NARROW_N if plan["tn"] == FBATCHED_TN_NARROW else 0)
             | (_FB_SMALL if plan["tm"] == FBATCHED_TM_SMALL else 0)
             | (_FB_X_BF16 if X.dtype == torch.bfloat16 else 0)
             | (_FB_W_BF16 if W.dtype == torch.bfloat16 else 0))
    # a bf16 operand that loads 16 bytes at a time takes the raw ring (one
    # operand at most, X first); any other is widened through registers
    if flags & _FB_X_BF16 and flags & _FB_VEC_X:
        flags |= _FB_RAW_X
    elif flags & _FB_W_BF16 and flags & _FB_VEC_W:
        flags |= _FB_RAW_W
    return "fbatched", {"kind": "fbatched", **form, "flags": flags, **plan}


def _gather_plan(A, B, a_c, b_c, k, batch, outer, c_live, dims, sa, sb, sc):
    """The gathered plan of bf16 A and B (the form of :func:`_strided_form`
    on the wgmma route's tiles, never split), or ``(None, None)`` for a
    product with no own C mode (M = N = 1), which fbatched takes."""
    form, X, W = _strided_form(A, B, a_c, b_c, k, batch, outer, c_live, dims, sa, sb, sc,
                               False, gather=True)
    M, N, K, G, O = (form[f] for f in "MNKGO")
    if M == 1 and N == 1:
        return None, None
    plan = wgmma_plan(M, N, K, G, split=False)
    steps = O * _cdiv(K, WGMMA_BK)
    if plan["tiles"] >= 2**31 or steps >= 2**31 or max(M, N, K) >= 2**31:
        return None, None
    xm, xk, wn, wk, grid, outer = (form[f] for f in ("xm", "xk", "wn", "wk", "grid", "outer"))
    # each stage is stored along its operand's smaller stride; where that
    # is 1 the producer loads it 16 bytes at a time, at any alignment
    x_km, w_km = _k_major(xk, xm), _k_major(wk, wn)
    flags = ((_FB_X_KMAJOR if x_km else 0) | (_FB_W_KMAJOR if w_km else 0)
             | (_GA_WIDE_X if (xk if x_km else xm) == 1 else 0)
             | (_GA_WIDE_W if (wk if w_km else wn) == 1 else 0))
    return "gathered", {"kind": "gathered", **form, "flags": flags, "tiles": plan["tiles"],
                        "steps": steps, "spc": steps, "n_split": 1}


def native_plan(A, B, *, a_modes: str, b_modes: str, c_modes: str, dims=None):
    """The route of :func:`native_gemm` and its launch plan: ``(route,
    plan)``.  Reads only dtypes, extents, strides and the start's
    alignment, so it runs on CPU, meta and fake tensors too (a fake
    tensor's start is its storage offset over an aligned base).

    Extent-1 modes are ignored everywhere.  The contracted modes are fused
    first: two that are neighbours in the same order in A and in B (the
    outer one's stride the inner one's extent times its stride, in both)
    are one mode.  The widest fused mode is ``k`` (the plan's ``k_modes``
    names its modes, innermost first); every route but ``"fbatched"``
    needs a ``k``, every route but ``"batched"``, ``"gathered"`` and
    ``"fbatched"`` no other contracted mode and no batch mode (one in A, B
    and C).  Float32 operands:

    - read kind: one operand W has, besides ``k``, at most one mode ``r``
      (a C mode at most :data:`NARROW` wide; none: a matrix-vector
      product); the other, X, carries the remaining C modes ``m`` (the
      smaller W is taken where both fit).
      ``"stream"`` with at least :data:`STREAM_MIN_ROWS` rows, ``m`` one
      mode after fusing, X readable by a 2-D tensor map and W within
      :data:`STREAM_W_BYTES`; else ``"fbatched"``.  Fewer rows, ``m`` up
      to three modes: ``"splitk"`` (:func:`splitk_plan`).
    - write kind: ``k`` at most :data:`NARROW` deep, C two modes ``(m,
      p)``, W carrying ``p`` and ``k``, X ``m`` and ``k``: ``"stream"``.
    - everything else: ``"fbatched"``.  W is the operand that carries C's
      innermost mode carried by one operand alone (none: W is B), X the
      other.  Each operand's own C modes fuse where they can; one is its
      tile mode (the row mode ``m`` of X: the stride-1 one where k is not
      stride-1 and it is wide enough, else the widest, :func:`_row_mode`;
      the column mode ``n`` of W: the innermost in C, :func:`_column_mode`),
      the rest are grid modes carried by that
      operand alone; batch modes are grid modes of both; grid modes that
      are one mode in X, W and C fuse (the plan's ``grid``, as ``(extent,
      X stride, W stride, C stride)``, 0 where an operand lacks the mode);
      the contracted modes but ``k`` are outer modes (``outer``, as
      ``(extent, X stride, W stride)``).  Any strides; the launch plan is
      :func:`fbatched_plan`'s, and ``flags`` say which slabs load 16
      bytes at a time, how each is laid out and which operand is bf16.

    Bfloat16 operands (both; any output type) with a ``k`` and a live C
    mode take ``"wgmma"`` or ``"batched"`` where tensor maps read them:
    ``n``, the minor-most C mode, is no batch mode and is carried by one
    operand W together with ``k``, batch modes and the other contracted
    modes and nothing else; the other operand X carries every other C
    mode.  X's own C modes fuse where they can: the widest is the row mode
    ``m`` (none: M = 1), the rest join the batch modes as grid modes (the
    plan's ``grid``, as ``(extent, X stride, W stride, C stride)``, W's 0
    where it lacks the mode); the contracted modes but ``k`` are outer
    modes (``outer``, as ``(extent, X stride, W stride)``).  Each
    operand's ``(m, k)`` or ``(k, n)`` must be readable by a tensor map:
    one of the two modes stride-1, the other's stride a multiple of 16
    bytes that steps past the first's extent (an extent-1 mode's stride is
    replaced by a legal one), a 16-byte aligned start; every grid and
    outer mode's stride is a positive multiple of 16 bytes where the
    operand carries it, and there are at most :data:`WGMMA_MAX_EXTRA` such
    modes.  With neither grid nor outer modes the product takes
    ``"wgmma"``, else ``"batched"`` (one kernel, :func:`wgmma_plan`).
    Every other such product with an own C mode takes ``"gathered"``: the
    fbatched form (:func:`_strided_form`) on the wgmma tiles, never split;
    ``flags`` say how each operand's stage is laid out in shared memory
    and whether its stored minor mode is stride-1 (16-byte loads).  Mixed bf16 x f32
    operands and the bf16 products left (no ``k``, no live or no own C
    mode, a zero extent) take ``"fbatched"``.
    """
    if dims is None:
        dims = infer_dims(ContractionSpec(a_modes, b_modes, c_modes), A, B)
    f32 = A.dtype == B.dtype == torch.float32
    bf16 = A.dtype == B.dtype == torch.bfloat16
    sa, sb = dict(zip(a_modes, A.stride())), dict(zip(b_modes, B.stride()))
    shared = [m for m in a_modes if m in b_modes and dims[m] > 1]
    contracted = [m for m in shared if m not in c_modes]
    batch = [m for m in shared if m in c_modes]
    # the contracted modes fused, innermost first by A's stride: [extent,
    # A stride, B stride, names]; k is the widest, named after its
    # innermost mode, with the fused extent and that mode's strides
    groups = []
    for m in sorted(contracted, key=lambda m: (sa[m], sb[m])):
        g = groups[-1] if groups else None
        if g and sa[m] == g[0] * g[1] and sb[m] == g[0] * g[2]:
            g[0] *= dims[m]
            g[3] += m
        else:
            groups.append([dims[m], sa[m], sb[m], m])
    inner = max(groups, key=lambda g: g[0]) if groups else [1, 0, 0, ""]
    k = inner[3][:1] or None
    outer = [tuple(g[:3]) for g in groups if g is not inner]
    if k:
        dims = {**dims, k: inner[0]}
        sa, sb = {**sa, k: inner[1]}, {**sb, k: inner[2]}
    sc = dict(zip(c_modes, row_major_strides([dims[m] for m in c_modes])))
    a_c = [m for m in a_modes if m not in contracted and dims[m] > 1]
    b_c = [m for m in b_modes if m not in contracted and dims[m] > 1]
    c_live = [m for m in c_modes if dims[m] > 1]
    args = (A, B, a_c, b_c, k, batch, outer, c_live, dims, sa, sb, sc)
    route = None
    if 0 not in dims.values():
        if bf16 and k and c_live:
            route, plan = _tc_plan(*args)
            if route is None:
                route, plan = _gather_plan(*args)
        elif f32 and groups and len(groups) == 1 and not batch:
            route, plan = _float_plan(*args[:4], k, c_live, dims, sa, sb, sc)
    if route is None:
        # a contracted mode of extent 0 sums nothing: C is zeros
        zero_k = any(dims[m] == 0 for m in a_modes if m in b_modes and m not in c_modes)
        route, plan = _fb_plan(*args, zero_k)
    return route, {**plan, "k_modes": inner[3]}


def _float_plan(A, B, a_c, b_c, k, c_live, dims, sa, sb, sc):
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
    return None, None


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


def _tc_desc(plan) -> bytes:
    extra = ([g[:3] for g in plan["grid"]] + [(e, x, w) for e, x, w in plan["outer"]]
             + [(1, 0, 0)] * (WGMMA_MAX_EXTRA - len(plan["grid"]) - len(plan["outer"])))
    cs = [g[3] for g in plan["grid"]] + [0] * (WGMMA_MAX_EXTRA - len(plan["grid"]))
    return _NM_DESC.pack(
        plan["M"], plan["N"], plan["K"], *(e[0] for e in extra), plan["xm"], plan["xk"],
        *(e[1] for e in extra), plan["wn"], plan["wk"], *(e[2] for e in extra), plan["ldc"],
        *cs, len(plan["grid"]), len(plan["grid"]) + len(plan["outer"]), plan["kc"],
        plan["n_split"])


def _fb_desc(plan) -> bytes:
    pad = [(1, 0, 0, 0)] * (MAX_MODES - len(plan["grid"]) - len(plan["outer"]))
    extra = plan["grid"] + [(e, x, w, 0) for e, x, w in plan["outer"]] + pad
    return _FB_DESC.pack(
        plan["M"], plan["N"], plan["K"], plan["xm"], plan["xk"], plan["wn"], plan["wk"],
        plan["cm"], plan["cn"], *(e[0] for e in extra), *(e[1] for e in extra),
        *(e[2] for e in extra), *(e[3] for e in extra), plan["G"], plan["steps"], plan["spc"],
        len(plan["grid"]), len(plan["grid"]) + len(plan["outer"]), plan["n_split"],
        plan["flags"])


def route_info(K: int = 512, rp: int = 12) -> dict:
    """Registers and spilled (local) bytes per thread, and shared bytes
    per block, of the kernels of the stream, splitk, wgmma, batched,
    fbatched and gathered routes: the float32-output stream and splitk kernels (the
    stream read kernels at depth ``K``, the read kinds at padded width
    ``rp``), the bfloat16-output kernel of the wgmma and batched routes at
    each tile height and operand layout, with its split reduction, and the
    float32-output fbatched kernel at each tile and slab layout (at its
    largest shared memory), with its split reduction, the same with a bf16
    operand ("widening"), and the bfloat16-output gathered kernel at each
    tile height and stage layout.
    Needs the card (it loads the library)."""
    lib = _library()
    kinds = {"stream read, m stride-1": 0, "stream read, k stride-1": 1,
             "stream write": 2, "splitk": 3, "splitk reduce": 4,
             **{f"wgmma {tm} rows, X {x}-major, W {w}-major": first + 2 * i + j
                for tm, first in ((WGMMA_TM, 5), (WGMMA_TM_WIDE, 10))
                for i, x in enumerate("KM") for j, w in enumerate("NK")},
             "wgmma split reduce": 9,
             **{f"fbatched {tm}x{tn}, X {x}-major, W {w}-major": first + 2 * i + j
                for tm, tn, first in ((FBATCHED_TM, FBATCHED_TN, 14),
                                      (FBATCHED_TM, FBATCHED_TN_NARROW, 18),
                                      (FBATCHED_TM_SMALL, FBATCHED_TN_NARROW, 23))
                for i, x in enumerate("mk") for j, w in enumerate("nk")},
             "fbatched split reduce": 22,
             **{f"gathered {tm} rows, X {x}-major, W {w}-major": first + 2 * i + j
                for tm, first in ((WGMMA_TM, 27), (WGMMA_TM_WIDE, 31))
                for i, x in enumerate("KM") for j, w in enumerate("NK")},
             **{f"widening {tm}x{tn}, X {x}-major, W {w}-major": first + 2 * i + j
                for tm, tn, first in ((FBATCHED_TM, FBATCHED_TN, 35),
                                      (FBATCHED_TM, FBATCHED_TN_NARROW, 39),
                                      (FBATCHED_TM_SMALL, FBATCHED_TN_NARROW, 43))
                for i, x in enumerate("mk") for j, w in enumerate("nk")}}
    info = {}
    for name, kind in kinds.items():
        out = (ctypes.c_int * 3)()
        rc = lib.nr_info(kind, rp, K, out)
        if rc != 0:
            raise RuntimeError(f"nr_info: {lib.sb_error_string(rc).decode()}")
        info[name] = {"registers": out[0], "spill_bytes": out[1], "smem_bytes": out[2]}
    return info


def native_gemm(A, B, *, a_modes: str, b_modes: str, c_modes: str, out_dtype=None):
    """Single-launch contraction of ``A`` and ``B`` in their native layouts.

    Args:
      A, B: float32 or bfloat16 tensors on one CUDA device (or both on the
        CPU, which runs :func:`native_gemm_ref`), ranks matching
        ``a_modes``/``b_modes``; any strides.
      c_modes: the output's modes, row-major; non-empty.  Operand modes
        absent from it are contracted.
      out_dtype: float32 or bfloat16 (default: the promoted operand dtype).

    Checks the call, then calls the registered operator
    ``torch.ops.repro_torch.native_gemm`` (see :data:`NATIVE_GEMM_OP`),
    which launches the route :func:`native_route` picks; its tile and
    launch come from the operands' layout alone.  Returns a new contiguous
    tensor with modes ``c_modes``.  Forward only: the output carries no
    gradient (:func:`repro_torch.kernels.ops.execute_native` differentiates
    it).
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
    # every mode once per tensor; an operand mode missing from C must be
    # contracted, i.e. appear in the other operand too
    a, b, c = set(a_modes), set(b_modes), set(c_modes)
    if (len(a) != len(a_modes) or len(b) != len(b_modes) or len(c) != len(c_modes)
            or c - a - b or (a ^ b) - c):
        raise ValueError(f"native_gemm cannot evaluate {a_modes},{b_modes}->{c_modes}")
    return NATIVE_GEMM_OP(A, B, a_modes, b_modes, c_modes, out_dtype)


native_gemm.launches = 0
native_gemm.launches_by_route = dict.fromkeys(ROUTES, 0)


def _address(T) -> int:
    """``T``'s start address, for the alignment checks: a fake tensor has
    no memory, so its storage offset in bytes over a base that is 256-byte
    aligned, as the caching allocator's blocks are (a meta tensor's
    ``data_ptr()`` is the same)."""
    if isinstance(T, FakeTensor):
        return T.storage_offset() * T.element_size()
    return T.data_ptr()


def _launch(A, B, a_modes: str, b_modes: str, c_modes: str):
    """``(route, plan, desc, c_shape)`` of a call: the extents checked
    (:func:`~repro_torch.core.contract.infer_dims`), the route and launch
    plan (:func:`native_plan`), the packed descriptor and C's shape.  Built
    on every device, so a call on the CPU or on fake tensors fails where
    the card's would."""
    dims = infer_dims(ContractionSpec(a_modes, b_modes, c_modes), A, B)
    route, plan = native_plan(A, B, a_modes=a_modes, b_modes=b_modes, c_modes=c_modes,
                              dims=dims)
    if route in ("wgmma", "batched"):
        desc = _tc_desc(plan)
    elif route in ("fbatched", "gathered"):
        desc = _fb_desc(plan)
    else:
        desc = _read_desc(plan) if plan["kind"] == "read" else _NW_DESC.pack(
            *(plan[f] for f in ("M", "P", "K", "xm", "xk", "wp", "wk", "cm")))
    return route, plan, desc, [dims[m] for m in c_modes]


def _native_gemm_cpu(A, B, a_modes, b_modes, c_modes, out_dtype):
    """The operator's CPU kernel: no kernel to launch, so the plain
    version, contiguous as the card's C is (a backward pass's next product
    then sees the card's strides and takes the card's route); outside
    autograd, as the card's launch is."""
    _launch(A, B, a_modes, b_modes, c_modes)
    with torch.no_grad():
        return native_gemm_ref(A, B, a_modes=a_modes, b_modes=b_modes, c_modes=c_modes,
                               out_dtype=out_dtype).contiguous()


def _native_gemm_cuda(A, B, a_modes, b_modes, c_modes, out_dtype):
    """The operator's CUDA kernel: one launch of the route's kernel, or a
    raise; the only place that counts launches."""
    route, plan, desc, c_shape = _launch(A, B, a_modes, b_modes, c_modes)
    X, Y = (A, B) if plan["x_is_a"] else (B, A)
    out = torch.empty(c_shape, dtype=out_dtype, device=A.device)
    if out.numel() == 0:
        return out
    lib = _library()
    tc = _TYPE_CODES[out_dtype]
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        if route == "gathered":
            rc = lib.ga_launch(X.data_ptr(), Y.data_ptr(), out.data_ptr(), desc, tc, stream)
        elif route in ("splitk", "wgmma", "batched", "fbatched"):
            # the split's partial sums: allocated here, so a dry run's
            # counter never sees them
            ws = (torch.empty(plan["workspace"], dtype=torch.float32, device=A.device)
                  if plan["workspace"] else None)
            launch = {"splitk": lib.nk_launch, "fbatched": lib.fb_launch}.get(route,
                                                                              lib.nm_launch)
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
                           f"{lib.sb_error_string(rc).decode()}")
    native_gemm.launches += 1
    native_gemm.launches_by_route[route] += 1
    return out


def _native_gemm_fake(A, B, a_modes, b_modes, c_modes, out_dtype):
    """The operator's fake kernel (fake and meta tensors): C's shape, type
    and device, contiguous; plans as the card would, launches and counts
    nothing."""
    c_shape = _launch(A, B, a_modes, b_modes, c_modes)[3]
    return A.new_empty(c_shape, dtype=out_dtype)


def _flops(a_shape, b_shape, a_modes, b_modes, c_modes, out_dtype, *, out_shape=None,
           **kwargs) -> int:
    """Two flops per element of the product's iteration space (every
    distinct mode's extent multiplied), as ``torch.utils.flop_counter``
    counts ``mm`` and ``bmm``."""
    dims = {**dict(zip(a_modes, a_shape)), **dict(zip(b_modes, b_shape))}
    return 2 * math.prod(dims.values())


def _route_of(A, B, a_modes, b_modes, c_modes, out_dtype) -> str:
    return native_plan(A, B, a_modes=a_modes, b_modes=b_modes, c_modes=c_modes)[0]


#: ``repro_torch::native_gemm(Tensor A, Tensor B, str a_modes, str b_modes,
#: str c_modes, ScalarType out_dtype) -> Tensor``, defined at import: a CPU
#: kernel (the plain version), a CUDA kernel (the launch), a fake kernel
#: (shapes only, so ``FakeTensorMode`` traces the kernel backend) and a
#: flop formula (``torch.utils.flop_counter``, hence
#: :class:`repro_torch.utils.CostCounter`, counts it as a product, and
#: counts its calls by route).  Its ``Autograd`` key falls through: the
#: operator is forward only, on every device.  No DTensor strategy: the mesh
#: route hands it local blocks.  A ``torch.library.Library`` with a kernel
#: per dispatch key, not ``torch.library.custom_op``, whose Python
#: autograd and schema handling cost several times the host time a call.
_OPS = torch.library.Library("repro_torch", "DEF")
_OPS.define("native_gemm(Tensor A, Tensor B, str a_modes, str b_modes, str c_modes, "
            "ScalarType out_dtype) -> Tensor")
_OPS.impl("native_gemm", _native_gemm_cpu, "CPU")
_OPS.impl("native_gemm", _native_gemm_cuda, "CUDA")
_OPS.impl("native_gemm", torch.library.fallthrough_kernel, "Autograd")
torch.library.register_fake("repro_torch::native_gemm", _native_gemm_fake, lib=_OPS)
register_flop_formula(torch.ops.repro_torch.native_gemm)(_flops)
NATIVE_GEMM_OP = torch.ops.repro_torch.native_gemm.default
ROUTERS[NATIVE_GEMM_OP] = _route_of
