"""The port's kernel layer (``kernels/ops.py``, ``ext_gemm``, ``sb_gemm``)
against the JAX package's, on the same numpy inputs.

On the CPU the port's wrapper builds the kernel's whole launch geometry and
then takes the plain version; the JAX package runs its Pallas kernel in
interpret mode.  The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py`` and by the ``gpu``-marked test below."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.notation import parse_spec as jparse_spec
from repro.core.planner import make_plan as jmake_plan
from repro.core.table2 import CASES
from repro.kernels import ops as jops
from repro.kernels.ext_gemm import ext_gemm as jext_gemm
from repro.kernels.ref import ref_contract as jref_contract
from repro_torch.core.contract import contract
from repro_torch.core.notation import parse_spec
from repro_torch.core.planner import make_plan
from repro_torch.kernels import ops
from repro_torch.kernels.ext_gemm import ext_gemm
from repro_torch.kernels.ref import ref_contract
from repro_torch.kernels.sb_gemm import (
    MAX_MODES, STREAM_MIN_ROWS, native_gemm, native_gemm_ref, native_route)

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    """The JAX side compiles many programs here; drop them when the module
    ends, so later timing-sensitive tests in the same worker run as alone."""
    yield
    jax.clear_caches()

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _operands(rng, spec, dims):
    cs = parse_spec(spec)
    return (rng.standard_normal([dims[m] for m in cs.a_modes]).astype(np.float32),
            rng.standard_normal([dims[m] for m in cs.b_modes]).astype(np.float32))


NATIVE_SPECS = [
    ("pk,mkn->nmp", {"p": 9, "k": 13, "m": 7, "n": 5}),        # exceptional layout
    ("bmk,bkn->bnm", {"b": 3, "m": 10, "k": 6, "n": 11}),       # shared batch, output permuted
    ("abcd,dce->bae", {"a": 3, "b": 4, "c": 5, "d": 2, "e": 6}),  # two contracted modes
    ("mq,qn->qnm", {"m": 5, "q": 4, "n": 3}),                   # batch-minor output
    ("ab,cd->dacb", {"a": 2, "b": 3, "c": 4, "d": 5}),          # outer product
    ("k,k->", {"k": 9}),                                        # scalar edge
] + [(CASES[l].row_major(), {"m": 17, "n": 12, "p": 3, "k": 21}) for l in sorted(CASES)[::5]]


@pytest.mark.parametrize("spec,dims", NATIVE_SPECS, ids=[s for s, _ in NATIVE_SPECS])
def test_execute_native_matches_jax(spec, dims):
    An, Bn = _operands(np.random.default_rng(10), spec, dims)
    want = jops.execute_native(spec, jnp.asarray(An), jnp.asarray(Bn))
    got = ops.execute_native(spec, torch.from_numpy(An), torch.from_numpy(Bn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


NESTED_SPECS = [
    ("cab,eda->becd", {"a": 3, "b": 4, "c": 6, "d": 5, "e": 7}),
    ("cbda,acbe->bced", {"a": 3, "b": 2, "c": 4, "d": 5, "e": 6}),
    ("ecadb,facb->bdcfe", {"a": 4, "b": 5, "c": 3, "d": 2, "e": 6, "f": 4}),
    ("ba,bdac->bcd", {"a": 6, "b": 3, "c": 9, "d": 5}),
    ("mnk,nj->mjk", {"m": 9, "n": 11, "k": 4, "j": 5}),   # HOOI's Y-update
    ("npi,nj->ijp", {"n": 11, "p": 7, "i": 4, "j": 5}),   # HOOI's core path, exceptional
]


@pytest.mark.parametrize("spec,dims", NESTED_SPECS, ids=[s for s, _ in NESTED_SPECS])
def test_execute_plan_matches_jax(spec, dims):
    An, Bn = _operands(np.random.default_rng(11), spec, dims)
    for allow_flatten in (True, False):
        jplan = jmake_plan(jparse_spec(spec), dims, allow_flatten=allow_flatten)
        plan = make_plan(parse_spec(spec), dims, allow_flatten=allow_flatten)
        want = jops.execute_plan(jplan, jnp.asarray(An), jnp.asarray(Bn))
        got = ops.execute_plan(plan, torch.from_numpy(An), torch.from_numpy(Bn))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_nested_modes_are_one_launch():
    """The JAX package lifts nested batch modes with ``jax.vmap``; the port
    makes them extra C modes of one kernel launch."""
    spec, dims = NESTED_SPECS[1]
    plan = make_plan(parse_spec(spec), dims)
    assert plan.nested
    calls = []
    real = ops.native_gemm

    def counting(*args, **kw):
        calls.append(kw["c_modes"])
        return real(*args, **kw)

    An, Bn = _operands(np.random.default_rng(12), spec, dims)
    try:
        ops.native_gemm = counting
        ops.execute_plan(plan, torch.from_numpy(An), torch.from_numpy(Bn))
    finally:
        ops.native_gemm = real
    assert len(calls) == 1 and set(plan.nested) <= set(calls[0])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("label", sorted(l for l, c in CASES.items() if c.exceptional))
def test_ext_gemm_matches_jax(label, dtype):
    rm = CASES[label].row_major()
    An, Bn = _operands(np.random.default_rng(2), rm, {"m": 34, "n": 18, "p": 5, "k": 40})
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jext_gemm(rm, jnp.asarray(An, jdt), jnp.asarray(Bn, jdt), out_dtype=jnp.float32)
    got = ext_gemm(rm, torch.from_numpy(An).to(tdt), torch.from_numpy(Bn).to(tdt),
                   out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(F32 if dtype == "f32" else BF16))


GRAD_SPECS = [
    ("pk,mkn->nmp", (5, 7), (4, 7, 3)),   # exceptional layout
    ("mk,kn->mn", (6, 4), (4, 5)),        # plain GEMM
    ("k,k->", (9,), (9,)),                # scalar output (direct route)
    ("bmk,bkn->bnm", (2, 3, 4), (2, 4, 5)),
    ("mq,qn->qnm", (3, 4), (4, 5)),       # batch-minor output
]


@pytest.mark.parametrize("spec,sa,sb", GRAD_SPECS, ids=[s for s, *_ in GRAD_SPECS])
def test_native_grad_matches_jax(spec, sa, sb):
    rng = np.random.default_rng(6)
    An = rng.standard_normal(sa).astype(np.float32)
    Bn = rng.standard_normal(sb).astype(np.float32)
    from repro.core.contract import contract as jcontract

    ja, jb = jax.grad(
        lambda a, b: jnp.sum(jcontract(spec, a, b, strategy="native") ** 2),
        (0, 1))(jnp.asarray(An), jnp.asarray(Bn))
    A = torch.from_numpy(An).requires_grad_()
    B = torch.from_numpy(Bn).requires_grad_()
    (contract(spec, A, B, strategy="native") ** 2).sum().backward()
    np.testing.assert_allclose(A.grad.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(B.grad.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-4)


def test_native_second_order_grad_matches_jax():
    """The backward is itself the native contraction, so it differentiates."""
    from repro.core.contract import contract as jcontract

    rng = np.random.default_rng(7)
    An = rng.standard_normal((5, 7)).astype(np.float32)
    Bn = rng.standard_normal((4, 7, 3)).astype(np.float32)
    spec = "pk,mkn->nmp"
    f = lambda a: jnp.sum(jcontract(spec, a, jnp.asarray(Bn), strategy="native") ** 2)
    want = jax.grad(lambda a: jnp.sum(jax.grad(f)(a) ** 2))(jnp.asarray(An))
    A, B = torch.from_numpy(An).requires_grad_(), torch.from_numpy(Bn)
    (g,) = torch.autograd.grad((contract(spec, A, B, strategy="native") ** 2).sum(), A,
                               create_graph=True)
    (gg,) = torch.autograd.grad((g ** 2).sum(), A)
    np.testing.assert_allclose(gg.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("label", sorted(CASES)[::3])
def test_plain_native_gemm_matches_ref_contract(label):
    rm = CASES[label].row_major()
    cs = parse_spec(rm)
    An, Bn = _operands(np.random.default_rng(3), rm, {"m": 8, "n": 6, "p": 3, "k": 5})
    for dt in (torch.float32, torch.bfloat16):
        A, B = torch.from_numpy(An).to(dt), torch.from_numpy(Bn).to(dt)
        got = native_gemm_ref(A, B, a_modes=cs.a_modes, b_modes=cs.b_modes,
                              c_modes=cs.c_modes, out_dtype=torch.float32)
        assert torch.equal(got, ref_contract(rm, A, B, out_dtype=torch.float32))
    want = jref_contract(rm, jnp.asarray(An), jnp.asarray(Bn))
    got = ref_contract(rm, torch.from_numpy(An), torch.from_numpy(Bn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_wrapper_validates_the_launch_on_the_cpu():
    """Everything the kernel would be told is checked before the CPU takes
    the plain version, so the CPU tests reach the launch geometry."""
    x = torch.ones(2, 3)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        native_gemm(x.double(), x.double(), a_modes="mk", b_modes="nk", c_modes="mn")
    with pytest.raises(ValueError, match="inconsistent size"):
        native_gemm(x, torch.ones(4, 4), a_modes="mk", b_modes="kn", c_modes="mn")
    sq = torch.ones(2, 2)
    for a_modes, b_modes, c_modes in (("mk", "nk", "m"), ("mm", "nm", "n"), ("mk", "nk", "mq")):
        with pytest.raises(ValueError, match="cannot evaluate"):
            native_gemm(sq, sq, a_modes=a_modes, b_modes=b_modes, c_modes=c_modes)
    # the role table's walk is checked where it is given (the card's kernel
    # takes its tile from the layout)
    with pytest.raises(ValueError, match="walk_mode"):
        ops.sb_contract("mk", "nk", "mn", x, x, roles={"k": "k", "m": "u", "n": "b"})
    with pytest.raises(ValueError, match="positive int"):
        ops.sb_contract("mk", "nk", "mn", x, x, roles={"k": "k", "m": "b", "n": "v"},
                    tiles={"b": 0})
    # more grid modes than a launch holds: C's modes in the opposite order,
    # so none fuse
    modes = "abcdefghij"[:MAX_MODES + 2]
    big = torch.ones([2] * len(modes) + [3])
    with pytest.raises(ValueError, match="mode slots"):
        native_gemm(big, torch.ones(3, 4), a_modes=modes + "k", b_modes="kx",
                    c_modes=modes[::-1] + "x")
    assert native_gemm.launches == 0


def test_cpu_tensor_takes_the_plain_version():
    A, B = torch.randn(4, 5), torch.randn(5, 3)
    before = native_gemm.launches
    got = native_gemm(A, B, a_modes="mk", b_modes="kn", c_modes="mn")
    assert torch.equal(got, native_gemm_ref(A, B, a_modes="mk", b_modes="kn", c_modes="mn"))
    assert native_gemm.launches == before


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    """Every Table II case (the fbatched route), then a case of each other
    float32 route at ragged extents, each launching the route
    ``native_route`` gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    dims = {"m": 383, "n": 257, "p": 47, "k": 321}
    cases = []
    for label in sorted(CASES):
        rm = CASES[label].row_major()
        An, Bn = _operands(np.random.default_rng(4), rm, dims)
        cases.append((rm, torch.from_numpy(An).cuda(), torch.from_numpy(Bn).cuda(), "fbatched"))
    rng = np.random.default_rng(5)
    rows = STREAM_MIN_ROWS + 36
    for spec, sa, sb, route in (("mn,mi->ni", (77, rows), (77, 10), "stream"),
                                ("km,pk->mp", (16, rows), (130, 16), "stream"),
                                ("npi,nj->ijp", (300, 37, 10), (300, 1), "splitk"),
                                ("mnk,nj->mjk", (77, 300, 7), (300, 16), "splitk")):
        A, B = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
                for s in (sa, sb))
        cases.append((spec, A, B, route))
    for spec, A, B, route in cases:
        cs = parse_spec(spec)
        modes = dict(a_modes=cs.a_modes, b_modes=cs.b_modes, c_modes=cs.c_modes)
        before = native_gemm.launches_by_route[route]
        if route == "fbatched":
            got = contract(spec, A, B, strategy="native")
        else:
            assert native_route(A, B, **modes) == route
            got = native_gemm(A, B, **modes)
        assert native_gemm.launches_by_route[route] > before, (spec, route)
        torch.testing.assert_close(got, native_gemm_ref(A, B, **modes), **F32)
