"""The routes that took over from ``native_gemm``'s retired ``generic``
route: ``gathered`` (bf16 products no tensor map reads, on the tensor-core
kernel behind a producer that gathers each stage through the operands'
strides) and ``fbatched`` with a bf16 operand (mixed bf16 x float32, and
the degenerate bf16 products: outer products, no own C mode, zero
extents), whose kernel widens the bf16 slab on its way to shared memory.

Their plans are tested here on CPU and meta tensors: the route of all 36
Table II cases in bf16 at ``chip_smoke.py``'s ragged extents and at n =
15 (no stride a multiple of 16 bytes), of the layouts ``chip_smoke.py``
forces and of a product past the three grid and outer modes a tensor map
holds; each plan evaluated through its own addressing
(``plan_emulation.emulate``) on integer-valued operands, where every order
sums exactly, against ``native_gemm_ref`` bit for bit; the producer's load
widths; the port's ``contract`` against the JAX package's on the same
numpy inputs; and the kernels' constants against the CUDA source.  The
``gpu``-marked tests hold the kernels themselves to the plain version on
the card, twice bit-identical, and a gathered product's rows across
launches of 1, 64 and 1000 rows.  JAX is imported inside the parity test
only, so the card's machine, which has no JAX, collects this file.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.core.contract import contract
from repro_torch.core.table2 import CASES
from repro_torch.kernels import _build
from repro_torch.kernels.sb_gemm import (
    GATHERED_MIN_UNIT, GATHERED_PRODUCERS, GATHERED_STAGES, MAX_MODES, ROUTES, WGMMA_MAX_EXTRA,
    native_gemm, native_gemm_ref, native_plan, native_route)

from plan_emulation import emulate

torch.set_num_threads(1)

BF16 = torch.bfloat16
#: chip_smoke.py's ragged extents (``RAGGED_DIMS``)
RAGGED_DIMS = {"m": 383, "n": 257, "p": 47, "k": 321}
LABELS = sorted(CASES)
#: bf16 keeps ~3 digits: the tolerance of every bf16 comparison
BF16_TOL = 2e-2


def _modes(spec):
    a, rest = spec.split(",")
    b, c = rest.split("->")
    return dict(a_modes=a, b_modes=b, c_modes=c)


def _shapes(spec, dims):
    m = _modes(spec)
    return [dims[x] for x in m["a_modes"]], [dims[x] for x in m["b_modes"]]


def _ints(rng, *shape, dtype=BF16):
    return torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32)).to(dtype)


def _exact(spec, A, B, route="gathered"):
    """The plan of A and B takes ``route`` and, evaluated through its
    addressing, equals the plain version bit for bit; returns the plan."""
    modes = _modes(spec)
    got_route, plan = native_plan(A, B, **modes)
    assert got_route == route, (spec, got_route)
    want = native_gemm_ref(A, B, **modes, out_dtype=torch.float32)
    got = emulate(plan, A, B, list(want.shape))
    assert torch.equal(got.float(), want), spec
    return plan


def test_generic_is_retired():
    assert "generic" not in ROUTES
    assert set(native_gemm.launches_by_route) == set(ROUTES)


@pytest.mark.parametrize("size", ["ragged", 15, 255])
def test_bf16_table2_cases_take_gathered_on_meta(size):
    """No tensor map reads a bf16 Table II case at odd extents: every one
    takes the gathered route, whose plan has an own C mode."""
    dims = RAGGED_DIMS if size == "ragged" else dict.fromkeys("mnpk", size)
    for label in LABELS:
        spec = CASES[label].row_major()
        sa, sb = _shapes(spec, dims)
        A, B = (torch.empty(s, device="meta", dtype=BF16) for s in (sa, sb))
        route, plan = native_plan(A, B, **_modes(spec))
        assert route == "gathered", label
        assert plan["n_split"] == 1 and max(plan["M"], plan["N"]) > 1, label


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("size", ["ragged", 15])
def test_bf16_table2_plan_is_exact(label, size):
    dims = RAGGED_DIMS if size == "ragged" else dict.fromkeys("mnpk", size)
    spec = CASES[label].row_major()
    rng = np.random.default_rng(40)
    sa, sb = _shapes(spec, dims)
    plan = _exact(spec, _ints(rng, *sa), _ints(rng, *sb))
    if size == "ragged":
        # every operand's stage is loaded along a stride-1 mode: X's k or
        # row, W's k or column (at n = 15 a stride-1 own mode is narrower
        # than GATHERED_MIN_UNIT, and a grid mode)
        assert 1 in (plan["xk"], plan["xm"]) and 1 in (plan["wk"], plan["wn"]), label


@pytest.mark.parametrize("why", [
    "weight rows 1030 bytes apart", "expert rows 500 bytes apart", "five grid and outer modes",
    "start 2 bytes off", "rows 132 bytes apart", "W carries a second C mode",
    "batch mode minor-most in C", "broadcast grid mode", "no mode stride-1", "decode row"])
def test_gathered_plan_addresses_strided_products(why):
    rng = np.random.default_rng(41)
    if why == "weight rows 1030 bytes apart":     # chip_smoke.py's weight
        spec, A, B = "be,ef->bf", _ints(rng, 4, 640), _ints(rng, 640, 515)[:, :512]
    elif why == "expert rows 500 bytes apart":    # chip_smoke.py's experts
        spec, A, B = "xce,xef->xcf", _ints(rng, 3, 341, 250), _ints(rng, 3, 250, 200)
    elif why == "five grid and outer modes":      # 4 batch modes in opposite orders
        # in A and B, and q beside k in the other order in B: none fuse
        spec, A, B = ("abcdmqk,dcbakqn->abcdmn", _ints(rng, 2, 2, 2, 2, 20, 3, 18),
                      _ints(rng, 2, 2, 2, 2, 18, 3, 24))
    elif why == "start 2 bytes off":
        spec, A, B = "mk,kn->mn", _ints(rng, 40 * 64 + 1)[1:].view(40, 64), _ints(rng, 64, 72)
    elif why == "rows 132 bytes apart":
        spec, A, B = "mk,kn->mn", _ints(rng, 40, 66), _ints(rng, 66, 152)
    elif why == "W carries a second C mode":     # t and f in opposite orders in W and C
        spec, A, B = "e,etf->ft", _ints(rng, 96), _ints(rng, 96, 4, 104)
    elif why == "batch mode minor-most in C":
        spec, A, B = "gbd,gdt->btg", _ints(rng, 8, 4, 128), _ints(rng, 8, 128, 64)
    elif why == "broadcast grid mode":            # W's expert stride 0
        spec, A, B = ("xce,xef->xcf", _ints(rng, 3, 40, 64),
                      _ints(rng, 1, 64, 48).expand(3, 64, 48))
    elif why == "no mode stride-1":
        spec, A, B = "be,ef->bf", _ints(rng, 4, 200)[:, ::2], _ints(rng, 100, 64)
    else:                                          # one row: M = 1
        spec, A, B = "be,ef->bf", _ints(rng, 1, 200), _ints(rng, 200, 515)[:, :512]
    plan = _exact(spec, A, B)
    if why == "five grid and outer modes":
        assert len(plan["grid"]) + len(plan["outer"]) == 5 > WGMMA_MAX_EXTRA
    if why == "W carries a second C mode":
        assert any(g[1] == 0 and g[2] != 0 for g in plan["grid"])


@pytest.mark.parametrize("why,wide_x,wide_w", [
    ("weight rows 1030 bytes apart", True, True), ("expert rows 500 bytes apart", True, True),
    ("start 2 bytes off", True, True), ("rows 132 bytes apart", True, True),
    ("no mode stride-1", False, True)])
def test_gathered_load_widths(why, wide_x, wide_w):
    """Whether the producer loads X's and W's stages 16 bytes at a time
    (flags bits 10 and 11): wherever the stage's stored minor mode is
    stride-1, whatever the other strides and the start's alignment; one
    element at a time where it is strided."""
    shapes = {"weight rows 1030 bytes apart": ("be,ef->bf", (4, 640), (640, 515), (None, 512)),
              "expert rows 500 bytes apart": ("xce,xef->xcf", (3, 341, 250), (3, 250, 200), None),
              "start 2 bytes off": ("mk,kn->mn", None, (64, 72), None),
              "rows 132 bytes apart": ("mk,kn->mn", (40, 66), (66, 152), None),
              "no mode stride-1": ("be,ef->bf", (4, 200), (100, 64), None)}
    spec, sa, sb, cut = shapes[why]
    A = (torch.zeros(40 * 64 + 1, dtype=BF16)[1:].view(40, 64) if sa is None
         else torch.zeros(sa, dtype=BF16))
    if why == "no mode stride-1":
        A = A[:, ::2]
    B = torch.zeros(sb, dtype=BF16)
    if cut:
        B = B[:, :cut[1]]
    route, plan = native_plan(A, B, **_modes(spec))
    assert route == "gathered"
    assert (bool(plan["flags"] & 1 << 10), bool(plan["flags"] & 1 << 11)) == (wide_x, wide_w), why


def test_gathered_takes_a_stride_one_tile_mode():
    """Where k is not stride-1 in an operand, its stride-1 own mode at
    least GATHERED_MIN_UNIT wide is its tile mode, so its stages load
    neighbouring elements; a narrower one is a grid mode."""
    A = torch.empty(321, 383, device="meta", dtype=BF16)           # km: k outer, m stride-1
    B = torch.empty(257, 321, 47, device="meta", dtype=BF16)       # nkp: p stride-1
    _, plan = native_plan(A, B, a_modes="km", b_modes="nkp", c_modes="pnm")
    assert plan["M"] == 47 and plan["xm"] == 1                     # X = B, row p
    narrow = torch.empty(257, 321, GATHERED_MIN_UNIT - 1, device="meta", dtype=BF16)
    _, plan = native_plan(A, narrow, a_modes="km", b_modes="nkp", c_modes="pnm")
    assert plan["M"] == 257 and plan["xm"] != 1


def test_past_the_descriptor_raises():
    """More grid and outer modes than a launch holds raise a ValueError
    that names the limit; no route takes the product."""
    g = "abcdefghi"
    A = torch.empty(*[2] * 9, 3, 5, device="meta", dtype=BF16)
    B = torch.empty(*[2] * 9, 5, 4, device="meta", dtype=BF16)
    with pytest.raises(ValueError, match=f"at most {MAX_MODES} grid and outer modes"):
        native_plan(A, B, a_modes=g + "mk", b_modes=g[::-1] + "kn", c_modes=g + "mn")


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("which", ["A bf16", "B bf16"])
def test_mixed_table2_plan_is_exact(label, which):
    """Mixed bf16 x float32 operands take fbatched, with the bf16
    operand's flag set, and its plan addresses them right."""
    dims = {"m": 37, "n": 29, "p": 11, "k": 45}
    spec = CASES[label].row_major()
    rng = np.random.default_rng(42)
    sa, sb = _shapes(spec, dims)
    a_dt, b_dt = (BF16, torch.float32) if which == "A bf16" else (torch.float32, BF16)
    A, B = _ints(rng, *sa, dtype=a_dt), _ints(rng, *sb, dtype=b_dt)
    plan = _exact(spec, A, B, route="fbatched")
    x_bf16 = (A if plan["x_is_a"] else B).dtype == BF16
    assert plan["flags"] >> 8 & 3 == (1 if x_bf16 else 2), label


@pytest.mark.parametrize("why", [
    "outer product", "extent-1 contraction", "no own C mode", "batch modes only",
    "chunked split walk", "16-byte loads", "f32 X, bf16 W"])
def test_degenerate_and_mixed_plans_are_exact(why):
    rng = np.random.default_rng(43)
    if why == "outer product":
        spec, A, B = "ab,cd->dacb", _ints(rng, 20, 19), _ints(rng, 18, 17)
    elif why == "extent-1 contraction":
        spec, A, B = "am,an->mn", _ints(rng, 1, 50), _ints(rng, 1, 60)
    elif why == "no own C mode":
        spec, A, B = "bk,bk->b", _ints(rng, 300, 21), _ints(rng, 300, 21)
    elif why == "batch modes only":
        spec, A, B = "bgk,bgk->gb", _ints(rng, 30, 7, 21), _ints(rng, 30, 7, 21)
    elif why == "chunked split walk":   # 9000 deep: 3 chunks, one a split
        spec, A, B = ("mk,kn->mn", _ints(rng, 40, 9000),
                      _ints(rng, 9000, 20, dtype=torch.float32))
    elif why == "16-byte loads":
        spec, A, B = ("mk,kn->mn", _ints(rng, 40, 64),
                      _ints(rng, 64, 72, dtype=torch.float32))
    else:
        spec, A, B = ("mk,kn->mn", _ints(rng, 40, 66, dtype=torch.float32),
                      _ints(rng, 66, 52))
    plan = _exact(spec, A, B, route="fbatched")
    if why == "chunked split walk":
        assert plan["n_split"] == 3 and plan["flags"] & 1 == 0
    if why == "16-byte loads":
        assert plan["flags"] & 2           # X's slabs 8 bf16 at a time


def test_zero_extents_give_zeros():
    """A bf16 product with a contracted mode of extent 0 sums nothing (the
    plan walks no stage), and one with an empty C launches nothing."""
    A, B = torch.zeros(30, 0, dtype=BF16), torch.zeros(0, 20, dtype=BF16)
    route, plan = native_plan(A, B, a_modes="mk", b_modes="kn", c_modes="mn")
    assert route == "fbatched" and plan["K"] == 0 and plan["steps"] == 0
    assert torch.equal(emulate(plan, A, B, [30, 20]).float(), torch.zeros(30, 20))
    assert native_route(torch.zeros(0, 5, dtype=BF16), torch.zeros(5, 8, dtype=BF16),
                        a_modes="mk", b_modes="kn", c_modes="mn") == "fbatched"
    got = native_gemm(torch.zeros(0, 5, dtype=BF16), torch.zeros(5, 8, dtype=BF16),
                      a_modes="mk", b_modes="kn", c_modes="mn")
    assert got.shape == (0, 8)


@pytest.mark.parametrize("strategy", ["native", "auto", "batched"])
@pytest.mark.parametrize("kind", ["ragged bf16", "mixed"])
def test_contract_matches_the_jax_package(strategy, kind):
    """The same numpy inputs through the JAX package's ``contract`` (JAX
    on the CPU, its Pallas kernels in interpret mode as its own tests run
    them) and the port's ``contract(..., backend="kernel")``, every Table
    II case at odd extents, within bf16's tolerance."""
    import jax.numpy as jnp

    from repro.core.contract import contract as jcontract

    rng = np.random.default_rng(44)
    dims = {"m": 19, "n": 13, "p": 7, "k": 23}
    for label in LABELS:
        spec = CASES[label].row_major()
        sa, sb = _shapes(spec, dims)
        An, Bn = (rng.standard_normal(s).astype(np.float32) for s in (sa, sb))
        if kind == "ragged bf16":
            A, B = torch.from_numpy(An).to(BF16), torch.from_numpy(Bn).to(BF16)
            jA, jB = jnp.asarray(An).astype(jnp.bfloat16), jnp.asarray(Bn).astype(jnp.bfloat16)
        else:
            A, B = torch.from_numpy(An).to(BF16), torch.from_numpy(Bn)
            jA, jB = jnp.asarray(An).astype(jnp.bfloat16), jnp.asarray(Bn)
        got = contract(spec, A, B, strategy=strategy, backend="kernel").float().numpy()
        want = np.asarray(jcontract(spec, jA, jB, strategy=strategy, backend="pallas"),
                          dtype=np.float32)
        np.testing.assert_allclose(got, want, rtol=BF16_TOL,
                                   atol=BF16_TOL * max(1.0, np.abs(want).max()),
                                   err_msg=f"{label} {spec}")


def test_gathered_constants_mirror_the_cuda_source():
    """The gathered route's ring, producers and flag fields are the
    kernel's own #defines; fbatched's bf16 flags are its next two bits."""
    src = (_build.CSRC / "sb_gemm.cu").read_text()
    define = {m[1]: m[2] for m in re.finditer(r"#define (\w+) (.+?)(?:\s+//.*)?$", src,
                                              re.MULTILINE)}
    assert int(define["GA_STAGES"]) == GATHERED_STAGES
    assert int(define["GA_PRODUCERS"]) == GATHERED_PRODUCERS
    assert (int(define["GA_F_WIDE_X"]), int(define["GA_F_WIDE_W"])) == (1 << 10, 1 << 11)
    assert (int(define["FB_F_X_BF16"]), int(define["FB_F_W_BF16"])) == (256, 512)
    for name in ("ng_kernel", "ng_outer_kernel", "NgDesc", "ng_launch"):
        assert name not in src


# -------------------------------------------------------------------- the card
#: the card's cases: the bf16 Table II cases at ragged extents (every other
#: one), chip_smoke.py's two layouts, a five-mode product, mixed Table II
#: cases either way, and the degenerate bf16 products
GPU_CASES = ([f"bf16 {l}" for l in LABELS[::2]] + [f"mixed {l}" for l in LABELS[1::5]]
             + [f"mixed-b {l}" for l in LABELS[2::7]]
             + ["weight", "experts", "five modes", "outer product", "no own C mode",
                "chunked split"])


def _gpu_operands(case, ints):
    gen = torch.Generator(device="cuda").manual_seed(45)

    def rn(*shape, dtype=BF16):
        t = (torch.randint(-3, 4, shape, generator=gen, device="cuda").float() if ints
             else torch.randn(*shape, generator=gen, device="cuda"))
        return t.to(dtype)

    kind, _, label = case.partition(" ")
    if label in CASES:
        spec = CASES[label].row_major()
        sa, sb = _shapes(spec, RAGGED_DIMS)
        b_dt = torch.float32 if kind == "mixed" else BF16
        a_dt = torch.float32 if kind == "mixed-b" else BF16
        return spec, rn(*sa, dtype=a_dt), rn(*sb, dtype=b_dt)
    return {"weight": lambda: ("be,ef->bf", rn(4, 6144), rn(6144, 515)[:, :512]),
            "experts": lambda: ("xce,xef->xcf", rn(3, 341, 250), rn(3, 250, 200)),
            "five modes": lambda: ("abcdmqk,dcbakqn->abcdmn", rn(2, 2, 2, 2, 70, 3, 66),
                                   rn(2, 2, 2, 2, 66, 3, 150)),
            "outer product": lambda: ("m,n->mn", rn(300), rn(200)),
            "no own C mode": lambda: ("bk,bk->b", rn(40, 300), rn(40, 300)),
            "chunked split": lambda: ("mk,kn->mn", rn(300, 9000),
                                      rn(9000, 20, dtype=torch.float32))}[case]()


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES)
def test_former_generic_products_match_plain_version_on_the_card(case):
    """Each product the generic route took runs its new kernel, twice
    bit-identical, within bf16's tolerance of the plain version on normal
    operands, and bit for bit on integer-valued ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    for ints in (False, True):
        spec, A, B = _gpu_operands(case, ints)
        modes = _modes(spec)
        route = native_route(A, B, **modes)
        assert route == ("gathered" if A.dtype == B.dtype == BF16 and "product" not in case
                         and "own" not in case else "fbatched"), (case, route)
        kw = dict(out_dtype=torch.float32)
        before = native_gemm.launches_by_route[route]
        got, again = native_gemm(A, B, **modes, **kw), native_gemm(A, B, **modes, **kw)
        torch.cuda.synchronize()
        assert native_gemm.launches_by_route[route] == before + 2
        assert torch.equal(got, again), case
        want = native_gemm_ref(A, B, **modes, **kw)
        if ints:
            assert torch.equal(got, want), case
        else:
            scale = max(1.0, want.abs().max().item())
            assert (got - want).abs().max().item() <= BF16_TOL * scale, case


@pytest.mark.gpu
def test_gathered_rows_keep_their_bits_in_any_launch_on_the_card():
    """Rows of ``be,ef->bf`` with W's rows 1030 bytes apart (gathered) in
    launches of 1, 64 and 1000 rows (64- and 128-row tiles): bit-identical,
    and within bf16's tolerance of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    gen = torch.Generator(device="cuda").manual_seed(46)
    X = torch.randn(1000, 6144, generator=gen, device="cuda").to(BF16)
    W = torch.randn(6144, 515, generator=gen, device="cuda").to(BF16)[:, :512]
    modes = _modes("be,ef->bf")
    got = {}
    for M in (1, 64, 1000):
        assert native_route(X[:M], W, **modes) == "gathered"
        got[M] = native_gemm(X[:M], W, **modes)
    assert torch.equal(got[64], got[1000][:64])
    assert torch.equal(got[1], got[1000][:1])
    want = native_gemm_ref(X[:64], W, **modes)
    scale = max(1.0, want.float().abs().max().item())
    assert (got[64].float() - want.float()).abs().max().item() <= BF16_TOL * scale
