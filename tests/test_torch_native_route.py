"""Route choice and launch plans of the port's native contraction kernel.

``native_route`` picks ``stream``, ``splitk``, ``wgmma``, ``batched``,
``gathered`` or ``fbatched`` from dtypes, extents and strides alone, after fusing the
contracted modes that are one mode in both operands, so it is tested here on CPU and
meta tensors: the ten launch shapes of HOOI at 512³ with ranks 10 (meta
tensors carry their exact shapes and strides without memory), the same
contractions at a small size, the bf16 products of an internlm2-20b serve
at full width, every Table II case, and the split plans.  Each stream,
splitk and wgmma plan is also evaluated on the CPU by gathering through
its own strides, and held against the JAX package's reference
contraction: a plan that addresses X, W or C wrongly fails here, before
the card.  The CUDA kernels themselves are held against the plain version
by ``chip_smoke.py``, by the ``gpu``-marked test of
``tests/test_torch_kernels.py`` and by the ``gpu``-marked wgmma test
below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.table2 import CASES
from repro.kernels.ref import ref_contract as jref_contract
from repro_torch.kernels.sb_gemm import (
    H100_SMS, NARROW, SPLITK_BLOCKS_PER_SM, SPLITK_ROWS, SPLITK_UNROLL, STREAM_MIN_ROWS,
    WGMMA_BK, WGMMA_BN, WGMMA_MIN_SPLIT_STAGES, WGMMA_TM, WGMMA_TM_WIDE, native_gemm,
    native_gemm_ref, native_plan, native_route, splitk_plan, wgmma_plan)

from plan_emulation import emulate

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=2e-5)


def _meta(*shape):
    return torch.empty(*shape, device="meta")


#: HOOI at 512³, ranks (10, 10, 10): every launch shape of one HOOI, with
#: the strides the main path gives it (the big operand row-major, each
#: factor a transposed view of a (10, 512) tensor), its launches per HOOI
#: and the route it must take
N, R = 512, 10
HOOI_SHAPES = [
    ("ij,mi->jm", (R, R * R), 1, "stream"),
    ("jk,nj->kn", (R, N * R), 1, "stream"),
    ("km,pk->mp", (R, N * N), 1, "stream"),
    ("mn,mi->in", (N, N * R), 10, "splitk"),
    ("mn,mi->ni", (N, N * N), 11, "stream"),
    ("mnk,nj->mjk", (N, N, R), 10, "splitk"),
    ("mp,pk->mk", (N * N, N), 10, "stream"),
    ("np,nj->pj", (N, N * R), 1, "splitk"),
    ("npi,nj->ijp", (N, N, R), 10, "splitk"),
    ("pi,pk->ik", (N, R * R), 1, "splitk"),
]


def _modes(spec):
    a, rest = spec.split(",")
    b, c = rest.split("->")
    return dict(a_modes=a, b_modes=b, c_modes=c)


def _factor(n, r, device="meta"):
    """An (n, r) factor stored as its (r, n) transpose, as HOOI holds it."""
    return torch.empty(r, n, device=device).t()


@pytest.mark.parametrize("spec,a_shape,per_hooi,route", HOOI_SHAPES,
                         ids=[s for s, *_ in HOOI_SHAPES])
def test_hooi_launch_shape_takes_its_route(spec, a_shape, per_hooi, route):
    A = _meta(*a_shape)
    assert native_route(A, _factor(N, R), **_modes(spec)) == route


def test_hooi_launches_per_hooi_add_up():
    """The table above is the whole HOOI: 56 launches (``chip_smoke.py``
    phase 5 counts them on the card)."""
    assert sum(n for _, _, n, _ in HOOI_SHAPES) == 56


#: the same contractions at a small size: edge 48, rank 10.  The rows of the
#: three stream shapes stay at STREAM_MIN_ROWS or above by keeping their big
#: mode long: the route depends on the extents.
SMALL = 48
SMALL_SHAPES = [
    ("ij,mi->jm", (R, R * R), "stream"),
    ("jk,nj->kn", (R, SMALL * R), "stream"),
    ("km,pk->mp", (R, STREAM_MIN_ROWS), "stream"),
    ("mn,mi->in", (SMALL, SMALL * R), "splitk"),
    ("mn,mi->ni", (SMALL, STREAM_MIN_ROWS), "stream"),
    ("mnk,nj->mjk", (SMALL, SMALL, R), "splitk"),
    ("mp,pk->mk", (STREAM_MIN_ROWS, SMALL), "stream"),
    ("np,nj->pj", (SMALL, SMALL * R), "splitk"),
    ("npi,nj->ijp", (SMALL, SMALL, R), "splitk"),
    ("pi,pk->ik", (SMALL, R * R), "splitk"),
]


@pytest.mark.parametrize("spec,a_shape,route", SMALL_SHAPES, ids=[s for s, *_ in SMALL_SHAPES])
def test_small_hooi_shape_takes_its_route(spec, a_shape, route):
    A = torch.zeros(a_shape)
    assert native_route(A, _factor(SMALL, R, "cpu"), **_modes(spec)) == route


def test_small_hooi_stream_shapes_split_below_the_row_threshold():
    """One row fewer than a stream tile per SM: the read kind splits."""
    for spec, shape in (("mn,mi->ni", (SMALL, STREAM_MIN_ROWS - 1)),
                        ("mp,pk->mk", (STREAM_MIN_ROWS - 1, SMALL))):
        assert native_route(torch.zeros(shape), _factor(SMALL, R, "cpu"),
                            **_modes(spec)) == "splitk"


@pytest.mark.parametrize("label", sorted(CASES))
def test_table2_case_is_generic(label):
    """At chip_smoke.py's ragged dims no mode is narrow: every Table II
    case takes the fbatched route in float32 and the gathered route in
    bfloat16 (no tensor map steps 47- or 383-element rows; the first
    slice's generic route took these before)."""
    dims = {"m": 383, "n": 257, "p": 47, "k": 321}
    modes = _modes(CASES[label].row_major())
    for dt, route in ((torch.float32, "fbatched"), (torch.bfloat16, "gathered")):
        A = torch.empty([dims[m] for m in modes["a_modes"]], device="meta", dtype=dt)
        B = torch.empty([dims[m] for m in modes["b_modes"]], device="meta", dtype=dt)
        assert native_route(A, B, **modes) == route


@pytest.mark.parametrize("spec,shapes,why", [
    ("mn,mi->ni", ((N, 4096), (N, R)), "bf16"),
    ("bmk,bkn->bmn", ((4, 9, 20), (4, 20, 3)), "batch mode"),
    # k and q are neighbours in A but in the other order in B: no fusing
    ("mkq,qki->mi", ((40, 6, 7), (7, 6, 3)), "two contracted modes"),
    ("mn,mi->ni", ((N, 4096), (N, NARROW + 1)), "no narrow mode"),
    ("km,pk->mp", ((NARROW + 1, 4096), (64, NARROW + 1)), "contraction too deep to write"),
    ("am,an->mn", ((1, 50), (1, 60)), "outer product (extent-1 contraction)"),
])
def test_other_layouts_are_generic(spec, shapes, why):
    """Float32 layouts that neither stream nor splitk take go to fbatched;
    the bf16 one, whose factor's rows no tensor map can step, takes the
    gathered route (the generic route's, before it was retired)."""
    A, B = (torch.zeros(s) for s in shapes)
    route = "fbatched"
    if why == "bf16":
        A, B, route = A.bfloat16(), B.bfloat16(), "gathered"
    assert native_route(A, B, **_modes(spec)) == route, why


def test_stream_needs_a_tensor_map():
    """A big read-kind operand with neither mode stride-1, or a row stride
    no multiple of 16 bytes, cannot be read by TMA: fbatched."""
    f = torch.zeros(32, 8)
    kw = dict(a_modes="mk", b_modes="ki", c_modes="mi")
    # rows 34 floats apart (136 bytes) against 36 (144 bytes)
    assert native_route(torch.zeros(STREAM_MIN_ROWS, 34)[:, :32], f, **kw) == "fbatched"
    assert native_route(torch.zeros(STREAM_MIN_ROWS, 36)[:, :32], f, **kw) == "stream"
    # every other column: no mode stride-1
    assert native_route(torch.zeros(STREAM_MIN_ROWS, 64)[:, ::2], f, **kw) == "fbatched"
    # a start 4 bytes past a 16-byte boundary
    assert native_route(torch.zeros(STREAM_MIN_ROWS * 36 + 1)[1:].view(-1, 36)[:, :32], f,
                        **kw) == "fbatched"


def test_stream_keeps_w_within_its_shared_memory():
    """W sits beside the 192 KB ring: k padded to 32 times r padded to 4,
    at most 32 KB.  Depth 512 fits every width up to 16, depth 544 at
    width 16 does not: fbatched."""
    for k, r, route in ((512, 16, "stream"), (544, 16, "fbatched"), (2048, 4, "stream"),
                        (2049, 4, "fbatched")):
        A = _meta(k, STREAM_MIN_ROWS)
        assert native_route(A, _meta(k, r), a_modes="mn", b_modes="mi",
                            c_modes="ni") == route, (k, r)


def test_route_constants_mirror_the_cuda_source():
    """The plan's tile sizes are the kernels' own #defines."""
    import re

    from repro_torch.kernels import _build, sb_gemm

    src = (_build.CSRC / "sb_gemm.cu").read_text()
    define = {m[1]: m[2] for m in re.finditer(r"#define (\w+) (.+?)(?:\s+//.*)?$", src,
                                              re.MULTILINE)}
    assert int(define["NS_TU"]) * int(define["NS_RPT"]) == sb_gemm.STREAM_ROWS
    assert int(define["NS_BK"]) == sb_gemm.STREAM_BK
    assert define["NS_W_BYTES_MAX"] == "(32 * 1024)" and sb_gemm.STREAM_W_BYTES == 32 * 1024
    assert int(define["NR_NARROW"]) == NARROW
    assert int(define["NK_TU"]) == SPLITK_ROWS
    assert int(define["NK_UNROLL"]) == SPLITK_UNROLL


def test_splitk_plan_of_the_narrow_hooi_shapes():
    """M = 5120 rows (a 512 x 10 slab), K = 512, R = 10: 40 row tiles, 16
    splits of 32 (multiples of the 16 loads in flight), 640 blocks on 132
    SMs, and a workspace of 16 x 10 x 5120 f32 partial sums."""
    p = splitk_plan(N * R, N, R)
    assert p == {"rp": 12, "tiles": 40, "n_split": 16, "kc": 32,
                 "workspace": 16 * R * N * R}
    # x1 shape pi,pk->ik: one tile of 100 rows, K split to one unroll each
    assert splitk_plan(R * R, N, R) == {"rp": 12, "tiles": 1, "n_split": 32, "kc": 16,
                                        "workspace": 32 * R * R * R}


@pytest.mark.parametrize("M,K,R_", [(1, 1, 1), (5120, 512, 10), (100, 512, 16), (33791, 4096, 3),
                                    (7, 100000, 4), (128, 15, 16)])
def test_splitk_plan_covers_k_and_fills_the_card(M, K, R_):
    p = splitk_plan(M, K, R_)
    assert p["kc"] % SPLITK_UNROLL == 0
    assert (p["n_split"] - 1) * p["kc"] < K <= p["n_split"] * p["kc"]
    assert p["tiles"] == -(-M // SPLITK_ROWS)
    assert p["rp"] % 4 == 0 and R_ <= p["rp"] < R_ + 4
    assert p["workspace"] == (p["n_split"] * R_ * M if p["n_split"] > 1 else 0)
    target = SPLITK_BLOCKS_PER_SM * H100_SMS
    # enough blocks, unless K runs out of unrolled steps first
    assert p["tiles"] * p["n_split"] >= min(target, p["tiles"] * -(-K // SPLITK_UNROLL)) * 0.5


def _flat(x):
    """The storage under ``x`` from its first element on, as a flat view."""
    base = torch.empty(0, dtype=x.dtype)
    n = x.untyped_storage().nbytes() // x.element_size() - x.storage_offset()
    return base.set_(x.untyped_storage(), x.storage_offset(), (n,), (1,))


def _run_plan(plan, A, B, c_shape):
    """Evaluate a plan by gathering through its strides alone, as the
    kernel addresses memory (rows decoded innermost first; the wgmma,
    batched, gathered and fbatched plans through ``plan_emulation``)."""
    if plan["kind"] in ("wgmma", "batched", "gathered", "fbatched"):
        return emulate(plan, A, B, c_shape)
    X, W = (A, B) if plan["x_is_a"] else (B, A)
    xf, wf = _flat(X).double(), _flat(W).double()
    C = torch.full(c_shape, float("nan"), dtype=torch.float64)
    cf = C.view(-1)
    K = torch.arange(plan["K"])
    if plan["kind"] == "write":
        m, p = torch.arange(plan["M"]), torch.arange(plan["P"])
        x = xf[m[:, None] * plan["xm"] + K[None] * plan["xk"]]          # (M, K)
        w = wf[p[:, None] * plan["wp"] + K[None] * plan["wk"]]          # (P, K)
        cf[m[:, None] * plan["cm"] + p[None]] = x @ w.T
        return C
    rows = torch.arange(plan["M"])
    xo, co, rem = torch.zeros_like(rows), torch.zeros_like(rows), rows.clone()
    for ext, xs, cs in plan["m"]:
        xo, co, rem = xo + rem % ext * xs, co + rem % ext * cs, rem // ext
    r = torch.arange(plan["R"])
    x = xf[xo[:, None] + K[None] * plan["xk"]]                          # (M, K)
    w = wf[K[:, None] * plan["wk"] + r[None] * plan["wr"]]              # (K, R)
    cf[co[:, None] + r[None] * plan["cr"]] = x @ w
    return C


def _check_plan(spec, A, B, route):
    modes = _modes(spec)
    got_route, plan = native_plan(A, B, **modes)
    assert got_route == route
    dims = dict(zip(modes["a_modes"], A.shape)) | dict(zip(modes["b_modes"], B.shape))
    got = _run_plan(plan, A, B, [dims[m] for m in modes["c_modes"]])
    want = jref_contract(spec, jnp.asarray(A.contiguous().numpy()),
                         jnp.asarray(B.contiguous().numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("spec,a_shape,route", SMALL_SHAPES, ids=[s for s, *_ in SMALL_SHAPES])
def test_plan_addresses_the_small_hooi_contraction(spec, a_shape, route):
    rng = np.random.default_rng(20)
    A = torch.from_numpy(rng.standard_normal(a_shape).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((R, SMALL)).astype(np.float32)).t()
    _check_plan(spec, A, B, route)


@pytest.mark.parametrize("spec,shapes,view,route", [
    # ragged narrow widths R = 1, 10, 16 and K not a multiple of a stage
    ("mk,ki->im", ((300, 77), (77, 1)), None, "splitk"),
    ("mk,ki->mi", ((300, 77), (77, 16)), None, "splitk"),
    ("km,ik->mi", ((515, 257), (10, 515)), None, "splitk"),
    # X broadcast along a C mode (stride 0), W transposed
    ("bmk,ki->bim", ((3, 1, 50), (50, 7)), "expand_m", "splitk"),
    # three C modes of X, none fusing in C
    ("abk,kr->rba", ((5, 6, 40), (40, 9)), "perm", "splitk"),
    # write kind: ragged P and K = 1 .. 16
    ("km,pk->mp", ((16, 300), (130, 16)), None, "stream"),
    ("km,kp->mp", ((3, 70), (3, 30)), None, "stream"),
])
def test_plan_addresses_ragged_and_strided_operands(spec, shapes, view, route):
    rng = np.random.default_rng(21)
    A, B = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes)
    if view == "expand_m":
        A = A.expand(3, 40, 50)
    elif view == "perm":
        A = A.permute(1, 0, 2).contiguous().permute(1, 0, 2)
    _check_plan(spec, A, B, route)


def test_cpu_tensors_take_the_plain_version_and_count_no_route():
    rng = np.random.default_rng(22)
    for spec, a_shape, route in SMALL_SHAPES:
        if route != "splitk":
            continue
        A = torch.from_numpy(rng.standard_normal(a_shape).astype(np.float32))
        B = torch.from_numpy(rng.standard_normal((R, SMALL)).astype(np.float32)).t()
        before = native_gemm.launches, dict(native_gemm.launches_by_route)
        got = native_gemm(A, B, **_modes(spec))
        assert torch.equal(got, native_gemm_ref(A, B, **_modes(spec)))
        assert (native_gemm.launches, native_gemm.launches_by_route) == before


# ------------------------------------------------------------------ wgmma
BF16 = torch.bfloat16


def _bf(*shape, stride=None, device="meta"):
    t = torch.empty(*shape, dtype=BF16, device=device)
    return t if stride is None else t.as_strided(shape, stride)


#: the bf16 products of an internlm2-20b serve at full width (d_model 6144,
#: 48 query heads over 8 KV heads of 128, d_ff 16384, vocab 92544): the
#: eight launch shapes with the largest launches x bound per serve, the
#: decode row of one request as a stride-0 view, then wk/wv and wo
SERVE_SHAPES = [
    ("be,ef->bf", (4, 6144), None, (6144, 16384)),
    ("be,ef->bf", (64, 6144), None, (6144, 16384)),
    ("be,ef->bf", (2, 6144), None, (6144, 16384)),
    ("be,ef->bf", (1, 6144), (0, 1), (6144, 16384)),
    ("be,ev->bv", (1, 6144), (0, 1), (6144, 92544)),
    ("be,ev->bv", (4, 6144), None, (6144, 92544)),
    ("bf,fe->be", (4, 16384), None, (16384, 6144)),
    ("bf,fe->be", (64, 16384), None, (16384, 6144)),
    ("be,ef->bf", (4, 6144), None, (6144, 1024)),
    ("bh,he->be", (64, 6144), None, (6144, 6144)),
]


@pytest.mark.parametrize("spec,a_shape,a_stride,b_shape", SERVE_SHAPES,
                         ids=[f"{s}-A{a}{'s0' if st else ''}-B{b}" for s, a, st, b in SERVE_SHAPES])
def test_serving_shape_takes_wgmma(spec, a_shape, a_stride, b_shape):
    A, B = _bf(*a_shape, stride=a_stride), _bf(*b_shape)
    route, plan = native_plan(A, B, **_modes(spec))
    assert route == "wgmma"
    assert plan["x_is_a"] and plan["xk"] == 1 and plan["wn"] == 1     # X K-major, W N-major
    assert (plan["M"], plan["K"], plan["N"]) == (a_shape[0], *b_shape)
    assert plan["ldc"] == b_shape[1] and plan["xm"] % 8 == 0 and plan["xm"] >= plan["K"]


@pytest.mark.parametrize("why", ["batch mode", "mixed bf16 x f32", "misaligned start",
                                 "row stride 1030 bytes", "two contracted modes",
                                 "W carries a second C mode", "no mode stride-1"])
def test_bf16_layouts_that_stay_generic(why):
    """bf16 layouts no tensor map reads, which the retired generic route
    took: the gathered route takes them, mixed operands fbatched."""
    kw = _modes("be,ef->bf")
    A, B = _bf(4, 6144), _bf(6144, 1024)
    if why == "batch mode":             # ... as C's minor-most mode: no W carries it alone
        A, B, kw = _bf(8, 4, 128), _bf(8, 128, 64), _modes("gbd,gdt->btg")
    elif why == "mixed bf16 x f32":
        B = torch.empty(6144, 1024, device="meta")
    elif why == "misaligned start":      # 8 bytes past a 16-byte boundary
        A = torch.zeros(4 * 6144 + 4, dtype=BF16)[4:].view(4, 6144)
        B = torch.zeros(6144, 1024, dtype=BF16)
    elif why == "row stride 1030 bytes":  # W rows 515 elements apart
        B = _bf(6144, 512, stride=(515, 1))
    elif why == "two contracted modes":  # ... that do not fuse (h, d in A; d, h in B), and
        # the outer one, h, 200 bytes apart in A: no tensor map can step it
        A, B, kw = _bf(4, 48, 100), _bf(100, 48, 1024), _modes("bhd,dhe->be")
    elif why == "W carries a second C mode":
        A, B, kw = _bf(6144), _bf(6144, 4, 1024), _modes("e,etf->tf")
    elif why == "no mode stride-1":
        A = _bf(4, 6144, stride=(12288, 2))
    want = "fbatched" if why == "mixed bf16 x f32" else "gathered"
    assert native_route(A, B, **kw) == want, why


def test_wgmma_plan_of_the_serving_shapes():
    """Tiles of 64 x 128; the contraction is split where the tiles are
    fewer than the 132 SMs: wq/wo (N = 6144, 48 tiles) 3 ways, wk/wv (N =
    1024, 8 tiles) 16 ways, w_down (N = 6144, K = 16384) 3 ways; gate/up
    (128 tiles) and the LM head (723) not at all."""
    assert wgmma_plan(4, 6144, 6144) == {"tiles": 48, "n_split": 3, "kc": 2048,
                                         "workspace": 3 * 4 * 6144}
    assert wgmma_plan(4, 1024, 6144) == {"tiles": 8, "n_split": 16, "kc": 384,
                                         "workspace": 16 * 4 * 1024}
    assert wgmma_plan(64, 6144, 16384) == {"tiles": 48, "n_split": 3, "kc": 5504,
                                           "workspace": 3 * 64 * 6144}
    assert wgmma_plan(64, 16384, 6144) == {"tiles": 128, "n_split": 1, "kc": 6144,
                                           "workspace": 0}
    assert wgmma_plan(1, 92544, 6144) == {"tiles": 723, "n_split": 1, "kc": 6144,
                                          "workspace": 0}


@pytest.mark.parametrize("M,N,K", [(1, 1032, 6144), (200, 1032, 6144), (65, 1032, 328),
                                   (1, 1032, 1000), (4, 6144, 6144), (4, 1024, 6144),
                                   (1, 2, 2), (64, 16384, 6144), (3, 130, 100000),
                                   (4096, 4096, 4096)])
def test_wgmma_plan_covers_k_and_fills_the_card(M, N, K):
    p = wgmma_plan(M, N, K)
    assert p["kc"] % WGMMA_BK == 0
    assert (p["n_split"] - 1) * p["kc"] < K <= p["n_split"] * p["kc"]
    tm = WGMMA_TM if M <= WGMMA_TM else WGMMA_TM_WIDE
    assert p["tiles"] == -(-M // tm) * -(-N // WGMMA_BN)
    assert p["workspace"] == (p["n_split"] * M * N if p["n_split"] > 1 else 0)
    stages = -(-K // WGMMA_BK)
    if p["n_split"] > 1:    # every split at least one ring deep
        assert p["kc"] >= WGMMA_MIN_SPLIT_STAGES * WGMMA_BK
    n_tiles = -(-N // WGMMA_BN)
    if n_tiles >= H100_SMS:
        assert p["n_split"] == 1
    else:                   # near one block per SM, unless K runs out of stages first
        blocks = n_tiles * p["n_split"]
        assert blocks <= 1.5 * H100_SMS
        assert blocks >= min(H100_SMS, n_tiles * (stages // WGMMA_MIN_SPLIT_STAGES)) / 2


@pytest.mark.parametrize("N,K", [(6144, 6144), (1024, 6144), (6144, 16384), (1032, 1000)])
def test_wgmma_split_does_not_depend_on_the_rows(N, K):
    """A row of C sums in the same order at any M: a decode row alone, in
    a bucket of 4, or in a 64- or 223-row prefill gets the same bits."""
    plans = [wgmma_plan(M, N, K) for M in (1, 2, 4, 63, 64, 65, 223, 4096)]
    assert len({(p["n_split"], p["kc"]) for p in plans}) == 1


def test_wgmma_constants_mirror_the_cuda_source():
    """The wgmma plan's tile, depth and ring are the kernel's own #defines."""
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / "sb_gemm.cu").read_text()
    define = {m[1]: m[2] for m in re.finditer(r"#define (\w+) (.+?)(?:\s+//.*)?$", src,
                                              re.MULTILINE)}
    assert int(define["NM_TM"]) == WGMMA_TM
    assert int(define["NM_BN"]) == WGMMA_BN
    assert int(define["NM_BK"]) == WGMMA_BK
    assert int(define["NM_STAGES"]) == WGMMA_MIN_SPLIT_STAGES


def _check_bf16_plan(spec, A, B, want_route="wgmma"):
    """The wgmma (or batched, or gathered) plan of bf16 A and B, evaluated
    through its strides, against the JAX package's reference on the same
    (exact) f32 values."""
    modes = _modes(spec)
    route, plan = native_plan(A, B, **modes)
    assert route == want_route
    dims = dict(zip(modes["a_modes"], A.shape)) | dict(zip(modes["b_modes"], B.shape))
    got = _run_plan(plan, A, B, [dims[m] for m in modes["c_modes"]])
    want = jref_contract(spec, jnp.asarray(A.float().numpy()), jnp.asarray(B.float().numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    return plan


@pytest.mark.parametrize("spec,shapes,view", [
    # X K-major, W N-major, ragged N; and W K-major
    ("be,ef->bf", ((5, 72), (72, 136)), None),
    ("be,fe->bf", ((5, 72), (130, 72)), None),
    # X M-major (rows of 16 elements), W either way
    ("eb,ef->bf", ((72, 16), (72, 136)), None),
    ("eb,fe->bf", ((72, 16), (130, 72)), None),
    # one decode row as a stride-0 view, K not a multiple of 8
    ("be,ef->bf", ((1, 77), (77, 24)), "stride0"),
    # two row modes that fuse (batch, sequence), and W as a column slice
    ("bse,ef->bsf", ((2, 3, 40), (40, 48)), "w_slice"),
    # C's minor-most mode carried by A: W is A, X is B
    ("be,ef->fb", ((24, 40), (40, 16)), None),
    # a deep contraction that the plan splits
    ("be,ef->bf", ((3, 4096), (4096, 16)), None),
])
def test_wgmma_plan_addresses_strided_operands(spec, shapes, view):
    rng = np.random.default_rng(23)
    A, B = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF16)
            for s in shapes)
    if view == "stride0":
        A = A.as_strided(A.shape, (0, 1))
    elif view == "w_slice":
        B = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32)).to(BF16)[:, 8:56]
    plan = _check_bf16_plan(spec, A, B)
    if shapes[0] == (3, 4096):
        assert plan["n_split"] > 1


@pytest.mark.parametrize("label", sorted(CASES))
def test_table2_case_in_bf16_at_aligned_dims(label):
    """At dims whose rows are 16-byte multiples, a Table II case takes
    wgmma exactly where C's minor-most mode sits with k alone in one
    operand and the other operand's C modes fuse into one row mode; its
    plan then addresses the case right."""
    dims = {"m": 24, "n": 16, "p": 8, "k": 40}
    modes = _modes(CASES[label].row_major())
    rng = np.random.default_rng(24)
    A, B = (torch.from_numpy(rng.standard_normal([dims[m] for m in modes[f"{t}_modes"]])
                             .astype(np.float32)).to(BF16) for t in "ab")
    n = modes["c_modes"][-1]
    w_modes = modes["a_modes"] if n in modes["a_modes"] else modes["b_modes"]
    x_modes = modes["b_modes"] if w_modes is modes["a_modes"] else modes["a_modes"]
    x_c = [m for m in x_modes if m != "k"]
    # X's C modes fuse when they are neighbours, in the same order, in X and
    # C; where they do not, the wider is the row mode and the other a grid
    # mode of the batched route, which needs the row mode or k stride-1
    # (every other stride here is a multiple of 16 bytes)
    fuses = len(x_c) == 1 or all("".join(x_c) in t for t in (x_modes, modes["c_modes"]))
    row = max(x_c, key=dims.get)
    expect = ("gathered" if sorted(w_modes) != sorted("k" + n)
              else "wgmma" if fuses else "batched" if x_modes[-1] in (row, "k")
              else "gathered")
    assert native_route(A, B, **modes) == expect
    _check_bf16_plan(CASES[label].row_major(), A, B, expect)


@pytest.mark.parametrize("spec,shapes,route", [
    ("mkq,kqi->mi", ((40, 6, 7), (6, 7, 3)), "splitk"),          # float32: k and q fuse
    ("bsv,bse->ve", ((2, 24, 40), (2, 24, 16)), "wgmma"),         # bf16: b and s fuse
    ("bse,bsf->fe", ((2, 24, 16), (2, 24, 5000)), "wgmma"),       # ... 5000 rows
    ("bhd,dhe->be", ((4, 6, 16), (16, 6, 24)), "batched"),        # d, h do not fuse: h outer
    ("xce,xef->xcf", ((3, 21, 32), (3, 32, 24)), "batched"),      # a batch mode
    ("bgrst,btgd->bsgrd", ((2, 3, 2, 24, 40), (2, 40, 3, 16)), "batched"),  # 3 grid modes
])
def test_plan_addresses_fused_and_batched_products(spec, shapes, route):
    """A fused contraction is read through its innermost mode's strides at
    the fused extent; a batched plan at each grid index's offsets, and at
    each index of an outer contracted mode."""
    rng = np.random.default_rng(27)
    A, B = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes)
    if route == "splitk":
        _check_plan(spec, A, B, route)
        assert native_plan(A, B, **_modes(spec))[1]["k_modes"] == "qk"
    else:
        plan = _check_bf16_plan(spec, A.to(BF16), B.to(BF16), route)
        assert plan["k_modes"] == ("sb" if route == "wgmma" else "t" if "t" in spec
                                   else "d" if "h" in spec else "e")


def test_cpu_bf16_takes_the_plain_version_and_counts_no_route():
    rng = np.random.default_rng(25)
    A = torch.from_numpy(rng.standard_normal((4, 72)).astype(np.float32)).to(BF16)
    B = torch.from_numpy(rng.standard_normal((72, 136)).astype(np.float32)).to(BF16)
    kw = _modes("be,ef->bf")
    assert native_route(A, B, **kw) == "wgmma"
    before = native_gemm.launches, dict(native_gemm.launches_by_route)
    for out_dtype in (None, torch.float32):
        got = native_gemm(A, B, out_dtype=out_dtype, **kw)
        assert torch.equal(got, native_gemm_ref(A, B, out_dtype=out_dtype, **kw))
    assert (native_gemm.launches, native_gemm.launches_by_route) == before


#: the wgmma route on the card: rows 1 (a stride-0 decode row), 2, 4, 63,
#: 64, 65, 200; depths 6144 (split) and 328 (a ragged last stage); N = 1032
#: (a ragged last tile); W N-major and K-major, X M-major; bf16 and f32
#: output; integer-valued cases exact
WGMMA_GPU_CASES = (
    [("be,ef->bf", M, K, "bf16", False) for M in ("1s", 2, 4, 63, 64, 65, 200)
     for K in (6144, 328)]
    + [("be,fe->bf", M, K, "bf16", False) for M in ("1s", 65, 200) for K in (6144, 328)]
    + [("eb,ef->bf", 200, 6144, "bf16", False), ("eb,fe->bf", 64, 328, "bf16", False),
       ("be,ef->bf", 4, 6144, "f32", False), ("be,fe->bf", 65, 328, "f32", False),
       ("be,ef->bf", 1000, 1000, "bf16", False),
       ("be,ef->bf", 2, 6144, "bf16", True), ("be,fe->bf", 200, 6144, "f32", True),
       ("eb,ef->bf", 64, 328, "bf16", True)])


@pytest.mark.gpu
@pytest.mark.parametrize("spec,M,K,out,ints", WGMMA_GPU_CASES,
                         ids=[f"{s}-M{M}-K{K}-{o}{'-ints' if i else ''}"
                              for s, M, K, o, i in WGMMA_GPU_CASES])
def test_wgmma_route_matches_plain_version_on_the_card(spec, M, K, out, ints):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    N = 1032
    gen = torch.Generator(device="cuda").manual_seed(26)
    m = 1 if M == "1s" else M
    modes = _modes(spec)

    def draw(*shape):
        if ints:
            return torch.randint(-3, 4, shape, generator=gen, device="cuda").to(BF16)
        return torch.randn(*shape, generator=gen, device="cuda").to(BF16)

    A = draw(K, m) if modes["a_modes"] == "eb" else draw(m, K)
    B = draw(N, K) if modes["b_modes"] == "fe" else draw(K, N)
    if M == "1s":
        A = A.as_strided(A.shape, (0, 1))
    out_dtype = torch.float32 if out == "f32" else BF16
    assert native_route(A, B, **modes) == "wgmma"
    before = native_gemm.launches_by_route["wgmma"]
    got = native_gemm(A, B, out_dtype=out_dtype, **modes)
    again = native_gemm(A, B, out_dtype=out_dtype, **modes)
    torch.cuda.synchronize()
    assert native_gemm.launches_by_route["wgmma"] == before + 2
    assert torch.equal(got, again)
    want = native_gemm_ref(A, B, out_dtype=out_dtype, **modes)
    assert got.dtype == want.dtype and got.shape == want.shape
    if ints:
        assert torch.equal(got, want)
    else:
        tol = 2e-2 if out_dtype == BF16 else 2e-5
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * scale
