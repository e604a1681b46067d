"""The port's n-ary front end (``core/einsum.py``) and contraction programs
(``core/program.py`` + ``core/passes.py``) against the JAX package's: the
same paths (integer arithmetic, so exactly), the same pass results, and the
same values within float32 tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import einsum as jeinsum
from repro.core import passes as jpasses
from repro.core import program as jprogram
from repro_torch.core import einsum as teinsum
from repro_torch.core import passes as tpasses
from repro_torch.core import program as tprogram

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    """The JAX side compiles many programs here; drop them when the module
    ends, so later timing-sensitive tests in the same worker run as alone."""
    yield
    jax.clear_caches()

# the dims and chains of tests/test_einsum.py
DIMS = {"m": 5, "n": 7, "p": 3, "q": 4, "k": 4, "r": 6,
        "a": 5, "b": 3, "c": 6, "d": 2, "e": 4, "f": 3,
        "i": 3, "j": 4, "l": 5, "s": 5, "t": 6}
CHAINS = [
    "ijk,mi,nj,pk->mnp", "mnp,mi,nj,pk->ijk", "r,mr,nr,pr->mnp",
    "mnp,nr,pr->mr", "mnp,mr,pr->nr", "ab,bc,cd->ad", "ab,bc,cd,de,ef->af",
    "bij,bjk,bkl->bil", "bsd,btd,bte->bse", "ab,bc->c", "ab,cd->abcd",
    "ab,ab->", "a,ab,b->", "mnk,kr,ms->nrs",
]
SHAPED = [
    ("ijk,mi,nj,pk->mnp", [(4, 5, 6), (30, 4), (31, 5), (32, 6)]),
    ("mnp,nr,pr->mr", [(20, 21, 22), (21, 4), (22, 4)]),
    ("ab,bc,cd,de->ae", [(50, 2), (2, 50), (50, 2), (2, 50)]),
    ("bsd,btd,bte->bse", [(2, 40, 6), (2, 41, 6), (2, 41, 7)]),
    ("ab,bc,cd->ad", [(64, 2), (2, 64), (64, 2)]),
    ("ijk,mi,nj,pk->mnp", [(10, 10, 10), (96, 10), (96, 10), (96, 10)]),
    ("aq,ab->b", [(3, 9), (3, 4)]),
    (",".join(chr(97 + i) + chr(98 + i) for i in range(6)) + "->ag", [(3, 3)] * 6),
]


def _shapes(spec):
    return [tuple(DIMS[m] for m in t) for t in spec.split("->")[0].split(",")]


def _path_fields(p):
    return (p.optimize, p.inputs, p.output, p.total_flops, p.largest_intermediate,
            [(s.lhs, s.rhs, s.out, s.spec.spec_str(), s.flops, s.kind) for s in p.steps],
            p.describe())


@pytest.mark.parametrize("optimize", ["naive", "greedy", "optimal", "auto"])
def test_contraction_path_identical_to_jax(optimize):
    cases = [(spec, _shapes(spec)) for spec in CHAINS] + SHAPED
    for spec, shapes in cases:
        j = jeinsum.contraction_path(spec, *shapes, optimize=optimize)
        t = teinsum.contraction_path(spec, *shapes, optimize=optimize)
        assert _path_fields(t) == _path_fields(j), (spec, optimize)


def test_parse_nary_identical_to_jax():
    for spec in CHAINS + ["ab,bc", "ab,ab", "abc->cab"]:
        assert teinsum.parse_nary(spec) == jeinsum.parse_nary(spec)
    for bad in ["aab,bc->ac", "ab,bc->ad", "ab,bc->aa", "ab...,bc->ac"]:
        with pytest.raises((ValueError, NotImplementedError)):
            teinsum.parse_nary(bad)


def _ops(spec, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in _shapes(spec)]


@pytest.mark.parametrize("strategy,backend", [("auto", "torch"), ("auto", "kernel"),
                                              ("batched", "kernel"), ("conventional", "torch"),
                                              ("native", "kernel")])
def test_xeinsum_matches_jax(strategy, backend):
    jbackend = {"torch": "xla", "kernel": "pallas"}[backend]
    # the JAX kernel runs interpreted: the kernel rows take the
    # decomposition chains, the library rows every chain
    specs = CHAINS[:6] if backend == "kernel" else CHAINS + ["abc->cab", "ab->b", "abc->b"]
    for spec in specs:
        ops = _ops(spec)
        want = jeinsum.xeinsum(spec, *map(jnp.asarray, ops), strategy=strategy,
                               backend=jbackend)
        got = teinsum.xeinsum(spec, *map(torch.from_numpy, ops), strategy=strategy,
                              backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{spec} {strategy}/{backend}")


def test_xeinsum_kernel_shorthand_and_precomputed_path():
    ops = [torch.from_numpy(x) for x in _ops("ab,bc,cd->ad")]
    path = teinsum.contraction_path("ab,bc,cd->ad", *ops, optimize="optimal")
    ref = torch.einsum("ab,bc,cd->ad", *ops)
    for kw in ({"strategy": "kernel"}, {"optimize": path}):
        torch.testing.assert_close(teinsum.xeinsum("ab,bc,cd->ad", *ops, **kw), ref,
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        teinsum.xeinsum("ab,bc,ce->ae", *[torch.from_numpy(x) for x in _ops("ab,bc,ce->ae")],
                        optimize=path)
    with pytest.raises(ValueError, match="optimize"):
        teinsum.xeinsum("ab,bc->ac", *ops[:2], optimize="optimla")


def _programs(exprs, arrays, outputs):
    j = jprogram.build_program({k: jnp.asarray(v) for k, v in arrays.items()}, exprs,
                               outputs=outputs)
    t = tprogram.build_program({k: torch.from_numpy(v) for k, v in arrays.items()}, exprs,
                               outputs=outputs)
    return j, t


def _steps(prog):
    return [(s.op, s.out, s.args, s.spec, s.axes, s.strategy, s.kind, s.penalty,
             s.flops, s.last_uses) for s in prog.steps]


def _run(passes, prog, pkg):
    ctx = pkg.PassContext(options=(jprogram if pkg is jpasses else tprogram).ProgramOptions())
    for p in passes:
        prog = p.run(prog, ctx)
    return prog


def test_cse_and_liveness_results_equal_jax():
    rng = np.random.default_rng(0)
    arrays = {"T": rng.standard_normal((5, 6, 7)).astype(np.float32),
              "W": rng.standard_normal((7, 3)).astype(np.float32)}
    exprs = [("a1", "mnk,kr->mnr", ("T", "W")),
             ("a2", "mnk,kr->mnr", ("T", "W")),
             ("a3", "mnk,kr->mnr", ("T", "W"), {"strategy": "direct"}),
             ("g", "mnr,qnr->mq", ("a1", "a2")),
             ("h", "mnr,qnr->mq", ("a3", "a1"))]
    j, t = _programs(exprs, arrays, ("g", "h"))
    for names in (("PathOptimizationPass", "CSEPass"),
                  ("PathOptimizationPass", "LayoutTieBreakPass", "CSEPass", "LivenessPass")):
        jp = _run([getattr(jpasses, n)() for n in names], j, jpasses)
        tp = _run([getattr(tpasses, n)() for n in names], t, tpasses)
        assert _steps(tp) == _steps(jp) and tp.outputs == jp.outputs, names
    assert len([s for s in tp.steps if s.op == "contract"]) == 4   # a2 merged into a1


def test_hooi_programs_plan_like_jax():
    """The three HOOI programs, shape-only ``t1`` input included, plan into
    the same steps with the same last uses in both packages."""
    rng = np.random.default_rng(1)
    T = rng.standard_normal((12, 11, 10)).astype(np.float32)
    A, B, C = (rng.standard_normal((d, 4)).astype(np.float32) for d in (12, 11, 10))
    progs = [
        ({"T": T, "C": C, "B": B},
         [("t1", "mnp,pk->mnk", ("T", "C")), ("y1", "mnk,nj->mjk", ("t1", "B")),
          ("g1", "mjk,qjk->mq", ("y1", "y1"), {"strategy": "direct"})], ("g1", "t1")),
        ({"T": T, "A": A, "B": B},
         [("y3", "mnp,mi,nj->ijp", ("T", "A", "B")),
          ("g3", "ijp,ijq->pq", ("y3", "y3"), {"strategy": "direct"})], None),
    ]
    for arrays, exprs, outputs in progs:
        kw = {} if outputs is None else {"outputs": outputs}
        jp = jprogram.compile_program(jprogram.build_program(
            {k: jnp.asarray(v) for k, v in arrays.items()}, exprs, **kw), use_cache=False)
        tp = tprogram.compile_program(tprogram.build_program(
            {k: torch.from_numpy(v) for k, v in arrays.items()}, exprs, **kw),
            use_cache=False)
        assert _steps(tp.program) == _steps(jp.program)
        want = jp(*[jnp.asarray(arrays[n]) for n in jp.program.input_names])
        got = tp(*[torch.from_numpy(arrays[n]) for n in tp.program.input_names])
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            # Gram entries cancel: float32 error scales with the largest entry
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * abs(w).max())
    meta = torch.empty((12, 11, 4), device="meta")
    p2 = tprogram.build_program({"t1": meta, "A": torch.from_numpy(A)},
                                [("y2", "mnk,mi->ink", ("t1", "A"))])
    assert p2.inputs[0].shape == (12, 11, 4) and p2.inputs[0].dtype == "float32"


def test_program_cache_and_donation():
    tprogram.clear_program_cache()
    A, B = torch.randn(4, 5), torch.randn(5, 6)
    p1 = tprogram.compile_program("ab,bc->ac", A, B)
    assert tprogram.compile_program("ab,bc->ac", A, B) is p1
    assert tprogram.program_cache_stats()["hits"] == 1
    assert tprogram.compile_program("ab,bc->ac", torch.randn(7, 5), B) is not p1
    with pytest.raises(ValueError, match="not a program input"):
        tprogram.compile_program("ab,bc->ac", A, B, donate=("nope",))
    donated = tprogram.compile_program("ab,bc->ac", A, B, donate=("%0",))
    torch.testing.assert_close(donated(A, B), A @ B)
    with pytest.raises(ValueError, match="compiled for shape"):
        p1(A, torch.randn(5, 7))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tprogram.compile_program("ab,bc->ac", A, B, strategy="tuned")
    tprogram.clear_program_cache()
