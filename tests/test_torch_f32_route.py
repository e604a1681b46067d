"""The float32 route ``fbatched`` of the port's native contraction kernel.

Every float32 product that takes neither ``stream`` nor ``splitk`` takes
``fbatched``: ``C[g.., m, n] = Σ_{o.., k} X[g.., o.., m, k]·W[g.., o.., k,
n]`` with grid modes from either operand, outer contracted modes walked in
the kernel and any strides.  Its plan is tested here on CPU and meta
tensors: the route of all 36 Table II cases, of HOOI's Gram and of the
compiled program's ``bik,kn->bin``; each plan evaluated through its own
addressing and summation order (``plan_emulation.emulate_fbatched``) on
integer-valued operands, where every order sums exactly, against
``native_gemm_ref`` bit for bit; the port's ``contract`` against the JAX
package's on the same numpy inputs; the split's dependence on the product
alone, and a row's order of sums in launches of any size; and the
kernel's constants against the CUDA source.  The ``gpu``-marked tests
hold the kernel itself to the plain version on the card, and a row's
bits across launches of 64, 1000 and 2048 rows.  JAX is imported inside the parity test only, so the card's machine,
which has no JAX, collects this file.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.core.contract import contract
from repro_torch.core.table2 import CASES
from repro_torch.kernels import _build
from repro_torch.kernels.sb_gemm import (
    FBATCHED_BK, FBATCHED_BLOCKS_PER_SM, FBATCHED_SPLIT_MAX_BYTES, FBATCHED_STAGES,
    FBATCHED_THREADS, FBATCHED_TM, FBATCHED_TM_SMALL, FBATCHED_TN, FBATCHED_TN_NARROW, H100_SMS,
    MAX_MODES, SUM_CHUNK, fbatched_plan, native_gemm, native_gemm_ref, native_plan, native_route)

from plan_emulation import emulate, fbatched_sum_order

torch.set_num_threads(1)

#: chip_smoke.py's ragged extents (``RAGGED_DIMS``): no mode narrow, none a
#: multiple of a tile or a stage
RAGGED_DIMS = {"m": 383, "n": 257, "p": 47, "k": 321}
TOL = 2e-5
LABELS = sorted(CASES)


def _modes(spec):
    a, rest = spec.split(",")
    b, c = rest.split("->")
    return dict(a_modes=a, b_modes=b, c_modes=c)


def _ints(rng, *shape):
    return torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))


def _shapes(spec, dims):
    m = _modes(spec)
    return [dims[x] for x in m["a_modes"]], [dims[x] for x in m["b_modes"]]


def _exact(spec, A, B, **override):
    """The fbatched plan of A and B (with ``override``'s launch fields),
    evaluated through its addressing, equals the plain version bit for
    bit; returns the plan."""
    modes = _modes(spec)
    route, plan = native_plan(A, B, **modes)
    assert route == "fbatched", (spec, route)
    plan = {**plan, **override}
    want = native_gemm_ref(A, B, **modes)
    got = emulate(plan, A, B, list(want.shape))
    assert torch.equal(got.float(), want), spec
    return plan


@pytest.mark.parametrize("size", ["ragged", 64, 256])
def test_table2_cases_take_fbatched_on_meta(size):
    dims = RAGGED_DIMS if size == "ragged" else dict.fromkeys("mnpk", size)
    for label in LABELS:
        spec = CASES[label].row_major()
        sa, sb = _shapes(spec, dims)
        A, B = torch.empty(sa, device="meta"), torch.empty(sb, device="meta")
        assert native_route(A, B, **_modes(spec)) == "fbatched", label


def test_gram_and_program_step_take_fbatched_on_meta():
    """HOOI's Gram at 512³ (two contracted modes that do not fuse: one
    outer) splits 64 ways, one chunk a split; one step of phase 14's
    program does not."""
    G = torch.empty(512, 512, 512, device="meta")
    route, plan = native_plan(G, G, a_modes="mnp", b_modes="mqp", c_modes="nq")
    assert route == "fbatched"
    assert (plan["M"], plan["N"], plan["K"], plan["O"]) == (512, 512, 512, 512)
    assert plan["n_split"] == 64 and plan["spc"] == 128 and not plan["chunked"]
    A, B = torch.empty(16, 2048, 1024, device="meta"), torch.empty(1024, 2048, device="meta")
    route, plan = native_plan(A, B, a_modes="bik", b_modes="kn", c_modes="bin")
    assert route == "fbatched"
    assert (plan["M"], plan["N"], plan["K"], plan["n_split"]) == (32768, 2048, 1024, 1)


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("size", ["ragged", 64])
def test_table2_plan_is_exact(label, size):
    dims = RAGGED_DIMS if size == "ragged" else dict.fromkeys("mnpk", size)
    spec = CASES[label].row_major()
    rng = np.random.default_rng(30)
    sa, sb = _shapes(spec, dims)
    _exact(spec, _ints(rng, *sa), _ints(rng, *sb))


@pytest.mark.parametrize("why", [
    "gram split", "gram chunked walk", "grid mode only W carries", "stride-0 view",
    "start 4 bytes off", "every other column", "two contracted modes", "outer product",
    "batch modes only", "batch mode minor-most in C", "bf16 output"])
def test_plan_addresses_strided_and_split_products(why):
    rng = np.random.default_rng(31)
    kw = {}   # launch fields forced onto the plan
    if why == "gram split":                   # 640 stages, 5 chunks: 5 splits
        spec, A, B = "mnp,mqp->nq", _ints(rng, 300, 40, 64), _ints(rng, 300, 40, 64)
    elif why == "gram chunked walk":          # the same walk unsplit, chunked, as
        # the plan runs a product of 264 tiles or more
        spec, A, B = "mnp,mqp->nq", _ints(rng, 300, 40, 64), _ints(rng, 300, 40, 64)
        kw = dict(n_split=1, spc=640, chunked=True, workspace=0)
    elif why == "grid mode only W carries":   # Table II 3.1: W carries p and m
        spec, A, B = "kn,pmk->pnm", _ints(rng, 45, 30), _ints(rng, 20, 19, 45)
    elif why == "stride-0 view":
        spec, A, B = "mk,pkn->pnm", _ints(rng, 1, 45).expand(30, 45), _ints(rng, 20, 45, 19)
    elif why == "start 4 bytes off":
        spec, A, B = ("mk,kn->mn", _ints(rng, 40 * 68 + 1)[1:].view(40, 68)[:, :66],
                      _ints(rng, 66, 52))
    elif why == "every other column":
        spec, A, B = "mk,kn->mn", _ints(rng, 40, 140)[:, ::2], _ints(rng, 70, 50)
    elif why == "two contracted modes":       # k, q neighbours in A, the other order in B
        spec, A, B = "mkq,qki->mi", _ints(rng, 40, 6, 7), _ints(rng, 7, 6, 30)
    elif why == "outer product":
        spec, A, B = "ab,cd->dacb", _ints(rng, 20, 19), _ints(rng, 18, 17)
    elif why == "batch modes only":
        spec, A, B = "bk,bk->b", _ints(rng, 300, 21), _ints(rng, 300, 21)
    elif why == "batch mode minor-most in C":
        spec, A, B = "gbd,gdt->btg", _ints(rng, 24, 20, 33), _ints(rng, 24, 33, 19)
    else:
        spec, A, B = "mk,kn->mn", _ints(rng, 40, 66), _ints(rng, 66, 52)
    plan = _exact(spec, A, B, **kw)
    if why.startswith("gram"):
        assert plan["outer"] and plan["steps"] == 640
        assert plan["chunked"] == (why == "gram chunked walk") == (plan["n_split"] == 1)
    if why == "grid mode only W carries":
        assert any(g[1] == 0 and g[2] != 0 for g in plan["grid"])
    if why == "bf16 output":   # the CPU takes the plain version in the requested type
        got = native_gemm(A, B, **_modes(spec), out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, native_gemm_ref(A, B, **_modes(spec), out_dtype=torch.bfloat16))


def test_zero_depth_gives_zeros():
    """A contracted mode of extent 0 sums nothing: the plan walks no stage
    and the kernel stores zeros."""
    A, B = torch.zeros(30, 0), torch.zeros(0, 20)
    route, plan = native_plan(A, B, a_modes="mk", b_modes="kn", c_modes="mn")
    assert route == "fbatched" and plan["K"] == 0 and plan["steps"] == 0
    assert torch.equal(emulate(plan, A, B, [30, 20]).float(), torch.zeros(30, 20))


def test_float_plan_matches_the_jax_reference():
    """On normal random operands the plan's sums agree with the JAX
    package's reference contraction within f32's ``TOL``: Table II at
    small ragged extents and a split Gram."""
    import jax.numpy as jnp

    from repro.kernels.ref import ref_contract as jref_contract

    rng = np.random.default_rng(32)
    dims = {"m": 37, "n": 21, "p": 19, "k": 45}
    specs = [(CASES[l].row_major(), *_shapes(CASES[l].row_major(), dims)) for l in LABELS]
    specs.append(("mnp,mqp->nq", [300, 40, 64], [300, 40, 64]))
    for spec, sa, sb in specs:
        An, Bn = (rng.standard_normal(s).astype(np.float32) for s in (sa, sb))
        A, B = torch.from_numpy(An), torch.from_numpy(Bn)
        route, plan = native_plan(A, B, **_modes(spec))
        assert route == "fbatched", spec
        got = emulate(plan, A, B, list(native_gemm_ref(A, B, **_modes(spec)).shape))
        want = np.asarray(jref_contract(spec, jnp.asarray(An), jnp.asarray(Bn)))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("strategy", ["native", "auto", "batched"])
def test_contract_matches_the_jax_package(strategy):
    """The same numpy inputs through the JAX package's ``contract`` (JAX on
    the CPU) and the port's, every Table II case and the Gram, within
    f32's ``TOL``."""
    import jax.numpy as jnp

    from repro.core.contract import contract as jcontract

    rng = np.random.default_rng(33)
    dims = {"m": 24, "n": 20, "p": 18, "k": 28}
    specs = [(CASES[l].row_major(), *_shapes(CASES[l].row_major(), dims)) for l in LABELS]
    specs.append(("mnp,mqp->nq", [24, 20, 18], [24, 22, 18]))
    for spec, sa, sb in specs:
        An, Bn = (rng.standard_normal(s).astype(np.float32) for s in (sa, sb))
        got = contract(spec, torch.from_numpy(An), torch.from_numpy(Bn), strategy=strategy,
                       backend="kernel")
        want = np.asarray(jcontract(spec, jnp.asarray(An), jnp.asarray(Bn), strategy=strategy))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("M,N,K,G,O", [(512, 512, 512, 1, 512), (40, 40, 300, 1, 64),
                                       (1, 1, 4096, 1, 1), (1, 1, 4097, 1, 1),
                                       (128, 64, 1 << 16, 3, 1), (65536, 256, 256, 1, 1),
                                       (100, 100, 33, 7, 1000), (1, 2, 0, 1, 1),
                                       (64, 64, 64, 64, 1), (4096, 64, 64, 1, 1),
                                       (64, 4096, 64, 1, 1), (512, 512, 512, 1, 1),
                                       (128, 128, 128, 128, 1), (47, 98431, 321, 1, 1),
                                       (1024, 1024, 1 << 20, 1, 1)])
def test_split_covers_the_walk_in_whole_chunks(M, N, K, G, O):
    """The split's stages, and the tile: 128-row unless the product has
    at most 64 rows, or is too small to give half the SMs one and too
    shallow to split (Table II at n = 64), then 64 x 64."""
    p = fbatched_plan(M, N, K, G, O)
    chunk = SUM_CHUNK // FBATCHED_BK
    assert p["steps"] == O * -(-K // FBATCHED_BK)
    tn = FBATCHED_TN if N > FBATCHED_TN_NARROW else FBATCHED_TN_NARROW
    small = M <= FBATCHED_TM_SMALL or (2 * G * -(-M // FBATCHED_TM) * -(-N // tn) < H100_SMS
                                        and p["steps"] <= chunk)
    assert (p["tm"], p["tn"]) == ((FBATCHED_TM_SMALL, FBATCHED_TN_NARROW) if small
                                  else (FBATCHED_TM, tn))
    assert p["tiles"] == G * -(-M // p["tm"]) * -(-N // p["tn"])
    if p["n_split"] > 1:   # one chunk a split
        assert p["spc"] == chunk and p["n_split"] == -(-p["steps"] // chunk)
        assert p["workspace"] == p["n_split"] * G * M * N
        assert 4 * p["workspace"] <= FBATCHED_SPLIT_MAX_BYTES
    else:
        assert p["workspace"] == 0 and p["spc"] == p["steps"]
    target = FBATCHED_BLOCKS_PER_SM * H100_SMS
    if p["tiles"] >= target or p["steps"] <= chunk:
        assert p["n_split"] == 1
    elif 4 * -(-p["steps"] // chunk) * G * M * N <= FBATCHED_SPLIT_MAX_BYTES:
        assert p["n_split"] > 1
    assert p["chunked"] == (min(p["spc"], p["steps"]) > chunk)


def test_the_split_depends_on_the_product_alone():
    """A product's split, walk and tile come from its extents: the same
    Gram in any operand layout, as a view of a larger tensor, or with a
    broadcast operand plans the same launch, so its bits do not depend
    on how the operands were laid out or what else shares the launch."""
    def launch(A, B, spec):
        _, p = native_plan(A, B, **_modes(spec))
        return p["n_split"], p["spc"], p["steps"], p["tm"], p["tn"], p["tiles"]

    base = torch.empty(64, 40, 300, device="meta")
    A = torch.empty(300, 40, 64, device="meta")
    want = launch(A, A, "mnp,mqp->nq")
    assert want[0] > 1
    assert launch(base.permute(2, 1, 0), A, "mnp,mqp->nq") == want
    assert launch(torch.empty(300, 48, 64, device="meta")[:, 4:44], A, "mnp,mqp->nq") == want
    assert launch(torch.empty(1, 40, 64, device="meta").expand(300, 40, 64), A,
                  "mnp,mqp->nq") == want
    assert launch(A, A, "nmp,mqp->nq".replace("nmp", "mnp")) == want
    # the product alone: every split plan is fbatched_plan of (M, N, K, G, O)
    _, p = native_plan(A, A, **_modes("mnp,mqp->nq"))
    assert launch(A, A, "mnp,mqp->nq") == tuple(
        fbatched_plan(p["M"], p["N"], p["K"], p["G"], p["O"])[k]
        for k in ("n_split", "spc", "steps", "tm", "tn", "tiles"))


@pytest.mark.parametrize("N,K,O,rows", [(4096, 16384, 1, (1, 64, 1000, 2048, 40000)),
                                         (512, 512, 512, (64, 512, 4096)),
                                         (64, 1 << 16, 3, (1, 100, 5000, 40000))])
def test_a_row_s_sums_do_not_depend_on_what_shares_its_launch(N, K, O, rows):
    """A product's rows are added up in one order at every row count:
    split (one chunk a split, the chunk sums added in order) or unsplit
    (a chunked walk adding the same chunk sums in the same order), so a
    row's bits are the same in a launch of 64 rows, of 1000 and of 2048
    (a decode slot in buckets of different sizes, a prompt's chunk against
    the whole prompt)."""
    plans = [fbatched_plan(M, N, K, 1, O) for M in rows]
    assert any(p["n_split"] > 1 for p in plans) and any(p["n_split"] == 1 for p in plans)
    want = fbatched_sum_order(plans[0])
    assert want != 0 and all(fbatched_sum_order(p) == want for p in plans)


def test_a_product_past_the_descriptor_raises():
    """More grid and outer modes than the descriptor holds raise a
    ValueError that names the limit; no route takes the product."""
    g = "abcdefghi"   # nine batch modes, in opposite orders in A and B: none fuse
    A = torch.empty(*[2] * 9, 3, 5, device="meta")
    B = torch.empty(*[2] * 9, 5, 4, device="meta")
    with pytest.raises(ValueError, match=f"at most {MAX_MODES} grid and outer modes"):
        native_plan(A, B, a_modes=g + "mk", b_modes=g[::-1] + "kn", c_modes=g + "mn")


def test_fbatched_constants_mirror_the_cuda_source():
    """The plan's tile, depth, ring, threads, chunk and split target are
    the kernel's own #defines, and its descriptor holds MAX_MODES extra
    modes."""
    src = (_build.CSRC / "sb_gemm.cu").read_text()
    define = {m[1]: m[2] for m in re.finditer(r"#define (\w+) (.+?)(?:\s+//.*)?$", src,
                                              re.MULTILINE)}
    assert int(define["FB_TM"]) == FBATCHED_TM
    assert int(define["FB_TN"]) == FBATCHED_TN
    assert int(define["FB_TN_NARROW"]) == FBATCHED_TN_NARROW
    assert int(define["FB_TM_SMALL"]) == FBATCHED_TM_SMALL
    assert int(define["FB_BK"]) == FBATCHED_BK
    assert int(define["FB_STAGES"]) == FBATCHED_STAGES
    assert int(define["FB_THREADS"]) == FBATCHED_THREADS
    assert int(define["FB_SPLIT_PER_SM"]) == FBATCHED_BLOCKS_PER_SM
    assert int(define["SB_SUM_CHUNK"]) == SUM_CHUNK
    assert define["FB_MAX_EXTRA"] == "SB_MAX_MODES" and int(define["SB_MAX_MODES"]) == MAX_MODES


#: the card's cases: the Table II cases at chip_smoke.py's ragged extents
#: and at 64, the Gram at a split size, views and bf16 output
GPU_CASES = ([(l, "ragged") for l in LABELS[::5]] + [(l, 64) for l in LABELS[1::7]]
             + [("gram", None), ("stride0", None), ("offset", None), ("bf16", None)])


@pytest.mark.gpu
@pytest.mark.parametrize("case,size", GPU_CASES, ids=[f"{c}-{s}" for c, s in GPU_CASES])
def test_fbatched_matches_plain_version_on_the_card(case, size):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    gen = torch.Generator(device="cuda").manual_seed(34)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    kw = {}
    if case in CASES:
        dims = RAGGED_DIMS if size == "ragged" else dict.fromkeys("mnpk", size)
        spec = CASES[case].row_major()
        sa, sb = _shapes(spec, dims)
        A, B = rn(*sa), rn(*sb)
    elif case == "gram":
        spec, A, B = "mnp,mqp->nq", rn(300, 40, 256), rn(300, 40, 256)
    elif case == "stride0":
        spec, A, B = "mk,pkn->pnm", rn(1, 45).expand(30, 45), rn(20, 45, 19)
    elif case == "offset":
        spec, A, B = "mk,kn->mn", rn(40 * 68 + 1)[1:].view(40, 68)[:, :66], rn(66, 52)
    else:
        spec, A, B = "mk,kn->mn", rn(200, 66), rn(66, 152)
        kw = dict(out_dtype=torch.bfloat16)
    modes = _modes(spec)
    assert native_route(A, B, **modes) == "fbatched"
    before = native_gemm.launches_by_route["fbatched"]
    got, again = native_gemm(A, B, **modes, **kw), native_gemm(A, B, **modes, **kw)
    torch.cuda.synchronize()
    assert native_gemm.launches_by_route["fbatched"] == before + 2
    assert torch.equal(got, again)
    want = native_gemm_ref(A, B, **modes, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 2e-2 if got.dtype == torch.bfloat16 else TOL
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.gpu
def test_fbatched_rows_keep_their_bits_in_any_launch_on_the_card():
    """Rows 0-63 of ``mk,kn->mn`` at K = 16384 (4 chunks), N = 4096, in
    launches of 64 rows (split 4 ways), 1000 rows (split 4 ways) and 2048
    rows (unsplit, chunked): bit-identical, and within ``TOL`` of the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    gen = torch.Generator(device="cuda").manual_seed(35)
    A = torch.randn(2048, 16384, generator=gen, device="cuda")
    B = torch.randn(16384, 4096, generator=gen, device="cuda")
    modes = _modes("mk,kn->mn")
    splits = [native_plan(A[:M], B, **modes)[1]["n_split"] for M in (64, 1000, 2048)]
    assert splits == [4, 4, 1]
    got = {M: native_gemm(A[:M], B, **modes) for M in (64, 1000, 2048)}
    assert torch.equal(got[1000], got[2048][:1000])
    assert torch.equal(got[64], got[2048][:64])
    want = native_gemm_ref(A[:64], B, **modes)
    scale = max(1.0, want.abs().max().item())
    assert (got[64] - want).abs().max().item() <= TOL * scale
