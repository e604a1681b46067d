"""Route choice and launch plans of the port's native contraction kernel.

``native_route`` picks ``stream``, ``splitk`` or ``generic`` from dtypes,
extents and strides alone, so it is tested here on CPU and meta tensors:
the ten launch shapes of HOOI at 512³ with ranks 10 (meta tensors carry
their exact shapes and strides without memory), the same contractions at a
small size, every Table II case, and the split plan.  Each stream and
splitk plan is also evaluated on the CPU by gathering through its own
strides, and held against the JAX package's reference contraction: a plan
that addresses X, W or C wrongly fails here, before the card.  The CUDA
kernels themselves are held against the plain version by ``chip_smoke.py``
and by the ``gpu``-marked test of ``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.table2 import CASES
from repro.kernels.ref import ref_contract as jref_contract
from repro_torch.kernels.sb_gemm import (
    H100_SMS, NARROW, SPLITK_BLOCKS_PER_SM, SPLITK_ROWS, SPLITK_UNROLL, STREAM_MIN_ROWS,
    native_gemm, native_gemm_ref, native_plan, native_route, splitk_plan)

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
    case stays on the generic route, in float32 and bfloat16."""
    dims = {"m": 383, "n": 257, "p": 47, "k": 321}
    modes = _modes(CASES[label].row_major())
    for dt in (torch.float32, torch.bfloat16):
        A = torch.empty([dims[m] for m in modes["a_modes"]], device="meta", dtype=dt)
        B = torch.empty([dims[m] for m in modes["b_modes"]], device="meta", dtype=dt)
        assert native_route(A, B, **modes) == "generic"


@pytest.mark.parametrize("spec,shapes,why", [
    ("mn,mi->ni", ((N, 4096), (N, R)), "bf16"),
    ("bmk,bkn->bmn", ((4, 9, 20), (4, 20, 3)), "batch mode"),
    ("mkq,kqi->mi", ((40, 6, 7), (6, 7, 3)), "two contracted modes"),
    ("mn,mi->ni", ((N, 4096), (N, NARROW + 1)), "no narrow mode"),
    ("km,pk->mp", ((NARROW + 1, 4096), (64, NARROW + 1)), "contraction too deep to write"),
    ("am,an->mn", ((1, 50), (1, 60)), "outer product (extent-1 contraction)"),
])
def test_other_layouts_are_generic(spec, shapes, why):
    A, B = (torch.zeros(s) for s in shapes)
    if why == "bf16":
        A, B = A.bfloat16(), B.bfloat16()
    assert native_route(A, B, **_modes(spec)) == "generic", why


def test_stream_needs_a_tensor_map():
    """A big read-kind operand with neither mode stride-1, or a row stride
    no multiple of 16 bytes, cannot be read by TMA: generic."""
    f = torch.zeros(32, 8)
    kw = dict(a_modes="mk", b_modes="ki", c_modes="mi")
    # rows 34 floats apart (136 bytes) against 36 (144 bytes)
    assert native_route(torch.zeros(STREAM_MIN_ROWS, 34)[:, :32], f, **kw) == "generic"
    assert native_route(torch.zeros(STREAM_MIN_ROWS, 36)[:, :32], f, **kw) == "stream"
    # every other column: no mode stride-1
    assert native_route(torch.zeros(STREAM_MIN_ROWS, 64)[:, ::2], f, **kw) == "generic"
    # a start 4 bytes past a 16-byte boundary
    assert native_route(torch.zeros(STREAM_MIN_ROWS * 36 + 1)[1:].view(-1, 36)[:, :32], f,
                        **kw) == "generic"


def test_stream_keeps_w_within_its_shared_memory():
    """W sits beside the 192 KB ring: k padded to 32 times r padded to 4,
    at most 32 KB.  Depth 512 fits every width up to 16, depth 544 at
    width 16 does not: generic."""
    for k, r, route in ((512, 16, "stream"), (544, 16, "generic"), (2048, 4, "stream"),
                        (2049, 4, "generic")):
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
    """Evaluate a stream or splitk plan by gathering through its strides
    alone, as the kernel addresses memory (rows decoded innermost first)."""
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
