"""The port's CP-ALS (``core/cp.py``) against the JAX package's on the same
numpy tensor, its MTTKRP programs' plans and launches at the sizes
``chip_smoke.py`` phase 29 runs (on meta tensors), and rehearsals of
phases 29 and 10 on the CPU."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_rehearsal
from repro.core.cp import cp_als as jcp_als
from repro.core.notation import parse_spec as jparse_spec
from repro.core.planner import make_plan as jmake_plan
from repro.core.program import compile_program as jcompile_program
from repro_torch.core.contract import COPY_OPS
from repro_torch.core.cp import cp_als
from repro_torch.core.notation import parse_spec
from repro_torch.core.planner import make_plan
from repro_torch.core.program import compile_program, propagate_shapes, step_dims
from repro_torch.interop import from_numpy
from repro_torch.kernels import ops, sb_gemm

torch.set_num_threads(1)

#: small cases: at 24x20x16 rank 3 modes 2 and 3 take tensor-times-matrix
#: first (then the exceptional batched GEMV), at 16^3 rank 5 every mode
#: forms the Khatri-Rao factor first
SMALL = (((24, 20, 16), 3), ((16, 16, 16), 5))
#: the three MTTKRPs of ``cp_als``, each with the factors it takes
MTTKRPS = (("mnp,nr,pr->mr", "BC"), ("mnp,mr,pr->nr", "AC"), ("mnp,mr,nr->pr", "AB"))


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()


def _cs():
    return chip_rehearsal.chip_smoke()


def _recoverable(shape, rank, seed=0):
    """Phase 29's tensor, made on the CPU: (numpy array, noise share)."""
    T, share = _cs().recoverable_cp(shape, rank, seed, device="cpu")
    return T.numpy(), share


def _aligned(f, jf):
    """``f``'s columns with the signs of ``jf``'s (each column's sign follows
    the eigenvectors of the init)."""
    return f * np.sign((f * jf).sum(0))


@pytest.mark.parametrize("shape,rank", SMALL)
@pytest.mark.parametrize("strategy", ["auto", "batched", "conventional"])
@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_cp_als_on_the_recoverable_tensor_matches_jax(shape, rank, strategy, backend):
    T, share = _recoverable(shape, rank)
    jbackend = {"torch": "xla", "kernel": "pallas"}[backend]
    want = jcp_als(jnp.asarray(T), rank, n_iter=25, strategy=strategy, backend=jbackend)
    got = cp_als(from_numpy(T, device="cpu"), rank, n_iter=25, strategy=strategy,
                 backend=backend)
    assert abs(float(got.rel_error) - float(want.rel_error)) < 1e-5
    # the noise floor: ALS reaches it from the HOSVD init
    assert float(got.rel_error) <= share * 1.001
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), rtol=1e-4)
    for f, jf in zip(got.factors, want.factors):
        f, jf = f.numpy(), np.asarray(jf)
        np.testing.assert_allclose(_aligned(f, jf), jf, atol=1e-4)


def test_cp_als_takes_the_jax_packages_seed_keyword():
    """The JAX package's ``cp_als`` takes ``seed`` and does not use it (the
    init is HOSVD); the port's takes it too and gives the same answer."""
    T, _ = _recoverable(*SMALL[0])
    rank = SMALL[0][1]
    want = jcp_als(jnp.asarray(T), rank, n_iter=5, seed=7)
    got = cp_als(from_numpy(T, device="cpu"), rank, n_iter=5, seed=7)
    unseeded = cp_als(from_numpy(T, device="cpu"), rank, n_iter=5)
    assert abs(float(got.rel_error) - float(want.rel_error)) < 1e-5
    assert float(got.rel_error) == float(unseeded.rel_error)


@pytest.mark.parametrize("factors,stalls", [("gaussian", True), ("orthonormal", False)])
def test_gaussian_factors_stall_above_the_noise_floor_in_both_packages(factors, stalls):
    """At 128^3 rank 10 with 10% noise, ALS from the HOSVD init stops far
    above the noise floor on Gaussian factors, in both packages, where
    they part by ~1e-5; on orthonormal factors with distinct weights
    (phase 29's tensor) both reach it.  So phase 29 runs the latter."""
    shape, rank = (128, 128, 128), 10
    if factors == "gaussian":
        rng = np.random.default_rng(0)
        L = np.einsum("mr,nr,pr->mnp", *(rng.standard_normal((d, rank)) for d in shape))
        N = rng.standard_normal(shape)
        N *= 0.1 * np.linalg.norm(L) / np.linalg.norm(N)
        T = (L + N).astype(np.float32)
        share = float(np.linalg.norm(N) / np.linalg.norm(L + N))
    else:
        T, share = _recoverable(shape, rank)
    want = float(jcp_als(jnp.asarray(T), rank, n_iter=25).rel_error)
    got = float(cp_als(from_numpy(T, device="cpu"), rank, n_iter=25).rel_error)
    for rel in (want, got):
        if stalls:
            assert rel > 3 * share
        else:
            assert rel <= share * 1.001
    assert abs(got - want) < (1e-4 if stalls else 1e-5)


def _meta_operands(shape, rank):
    m, n, p = shape
    dims = {"A": (m, rank), "B": (n, rank), "C": (p, rank)}
    return torch.empty(shape, device="meta"), dims


@pytest.mark.parametrize("shape,rank", _cs().CP_CASES)
def test_mttkrp_plans_at_full_size_match_jax(shape, rank):
    """Each MTTKRP program of phase 29's cases, compiled on meta tensors,
    plans as the JAX package's does (path, step kinds and each pairwise
    plan field by field): at 512^3 the Khatri-Rao factor first; at
    1024x512x256 tensor-times-matrix first for modes 2 and 3, then an
    exceptional step (the batched GEMV, its batch mode stride 1)."""
    T, dims = _meta_operands(shape, rank)
    kinds = []
    for spec, names in MTTKRPS:
        shapes = [shape, dims[names[0]], dims[names[1]]]
        got = compile_program(spec, T, *(torch.empty(dims[n], device="meta") for n in names),
                              strategy="auto", backend="kernel")
        want = jcompile_program(spec, *(jax.ShapeDtypeStruct(s, "float32") for s in shapes),
                                strategy="auto", backend="pallas")
        assert got.describe() == want.describe()
        buffers, _ = propagate_shapes(got.program)
        steps = [s for s in got.program.steps if s.op == "contract"]
        kinds.append(tuple(s.kind for s in steps))
        for s in steps:
            cs = parse_spec(s.spec)
            dims_of = step_dims(cs, *(buffers[a] for a in s.args))
            t, j = make_plan(cs, dims_of), jmake_plan(jparse_spec(s.spec), dims_of)
            assert t.describe() == j.describe()
            assert (t.kind, t.flatten_groups, t.fdims, t.gemm_modes, t.sb_batch) == (
                j.kind, j.flatten_groups, j.fdims, j.gemm_modes, j.sb_batch)
    kr_first = ("sb_gemm", "flat_gemm")
    if shape[0] == shape[1] == shape[2]:
        assert kinds == [kr_first] * 3
    else:
        assert kinds == [kr_first] + [("flat_gemm", "exceptional")] * 2


#: ``native_route`` of every launch of one iteration at phase 29's cases:
#: (a_modes, b_modes, c_modes) -> route, in launch order
FULL_SIZE_ROUTES = {
    ((512, 512, 512), 10): [
        ("nr", "pr", "rnp", "fbatched"), ("mn", "rn", "mr", "splitk"),
        ("mr", "pr", "rmp", "fbatched"), ("mnp", "rmp", "nr", "fbatched"),
        ("mr", "nr", "rmn", "fbatched"), ("mp", "rm", "pr", "splitk")],
    ((512, 512, 512), 64): [
        ("nr", "pr", "rnp", "fbatched"), ("mn", "rn", "mr", "fbatched"),
        ("mr", "pr", "rmp", "fbatched"), ("mnp", "rmp", "nr", "fbatched"),
        ("mr", "nr", "rmn", "fbatched"), ("mp", "rm", "pr", "fbatched")],
    ((1024, 512, 256), 16): [
        ("nr", "pr", "rnp", "fbatched"), ("mn", "rn", "mr", "splitk"),
        ("mn", "mr", "nr", "fbatched"), ("npr", "pr", "nr", "fbatched"),
        ("mn", "mr", "nr", "fbatched"), ("npr", "nr", "pr", "fbatched")],
}


def _routes_recorded(monkeypatch):
    """Every ``native_gemm`` launch through ``kernels.ops`` as (a, b, c,
    route); a meta launch returns an empty output of the right shape."""
    seen = []
    real = ops.native_gemm

    def recording(A, B, **kw):
        a, b, c = kw["a_modes"], kw["b_modes"], kw["c_modes"]
        seen.append((a, b, c, sb_gemm.native_route(A, B, a_modes=a, b_modes=b, c_modes=c)))
        if A.device.type != "meta":
            return real(A, B, **kw)
        d = dict(zip(a, A.shape)) | dict(zip(b, B.shape))
        return torch.empty([d[m] for m in c], device="meta")

    monkeypatch.setattr(ops, "native_gemm", recording)
    return seen


@pytest.mark.parametrize("shape,rank", _cs().CP_CASES)
def test_mttkrp_launches_at_full_size_take_their_routes(monkeypatch, shape, rank):
    """One iteration's three MTTKRPs at phase 29's cases, run on meta
    tensors: 6 ``native_gemm`` launches, each on the route recorded in
    ``FULL_SIZE_ROUTES`` (a launch's view strides decide it, so a plan
    fault shows here without a card)."""
    seen = _routes_recorded(monkeypatch)
    T, dims = _meta_operands(shape, rank)
    F = {n: torch.empty(d, device="meta") for n, d in dims.items()}
    for spec, names in MTTKRPS:
        compile_program(spec, T, F[names[0]], F[names[1]], strategy="auto",
                        backend="kernel")(T, F[names[0]], F[names[1]])
    assert len(seen) == _cs().CP_LAUNCHES_PER_ITER
    assert seen == FULL_SIZE_ROUTES[(shape, rank)]


@pytest.mark.parametrize("shape,rank,n_iter,want", [
    ((64, 64, 64), 10, 5, {"fbatched": 20, "splitk": 10}),
    ((256, 128, 64), 16, 5, {"fbatched": 15, "splitk": 15}),
])
def test_kernel_cp_als_launches_six_an_iteration(monkeypatch, shape, rank, n_iter, want):
    """The kernel backend's ``cp_als`` on CPU tensors: 2 launches an MTTKRP,
    6 an iteration, by route as ``native_route`` gives them; the init's
    Grams (``direct``), the solves and the reconstruction launch none; the
    torch backend launches none."""
    T, _ = _recoverable(shape, rank)
    T = from_numpy(T, device="cpu")
    seen = _routes_recorded(monkeypatch)
    res = cp_als(T, rank, n_iter=n_iter, strategy="auto", backend="kernel")
    assert len(seen) == 6 * n_iter
    assert dict(Counter(r for *_, r in seen)) == want
    seen.clear()
    ref = cp_als(T, rank, n_iter=n_iter, strategy="auto", backend="torch")
    assert seen == []
    assert abs(float(res.rel_error) - float(ref.rel_error)) < 1e-6


def _copies_outside_native_gemm(fn, *args) -> dict:
    """``count_copy_ops`` for the CPU: the copies ``fn`` makes outside a
    ``native_gemm`` call (on the CPU its plain version lays C out
    contiguous; the card's kernel writes C in place), by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    events = prof.events()
    inside = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == "repro_torch::native_gemm"]
    counts = dict.fromkeys(COPY_OPS, 0)
    for e in events:
        if e.name in counts and not any(s <= e.time_range.start and e.time_range.end <= t
                                        for s, t in inside):
            counts[e.name] += 1
    return counts


def _tracing_stubbed(monkeypatch):
    """A ``contract`` span's roofline bound on the CPU, which has none: a
    small fixed one, so its fraction of host time is positive and small."""
    import repro_torch.obs.roofline as roofline

    real = roofline.contraction_record
    monkeypatch.setattr(roofline, "contraction_record",
                        lambda *a, **k: {**real(*a, **k), "roofline_bound_us": 1e-3})


def test_phase_29_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.cp_path`` at two small cases, card-only calls stubbed
    and copies inside ``native_gemm``'s plain version not counted: checks
    (a)-(e) pass at each case, with 6 launches an iteration on the routes
    ``native_route`` gives (both orders: the Khatri-Rao factor first at
    64^3, tensor-times-matrix then the batched GEMV at 48x32x24), and the
    tuned run hits its pretuned cache."""
    import repro_torch.core.contract as contract_mod

    cs = _cs()
    counters, profiled = chip_rehearsal.card_stubbed(monkeypatch, cs)
    monkeypatch.setattr(contract_mod, "count_copy_ops", _copies_outside_native_gemm)
    _tracing_stubbed(monkeypatch)
    rec = cs.cp_path(torch.device("cpu"), 0, counters,
                     cases=(((64, 64, 64), 10), ((48, 32, 24), 4)), n_iter=3)
    assert rec["launches"] == 2 * 3 * 6
    assert rec["launches_by_route"]["fbatched"] + rec["launches_by_route"]["splitk"] == 36
    cases = rec["cases"]
    assert set(cases) == {"64x64x64 rank 10", "48x32x24 rank 4"}
    for c in cases.values():
        assert c["launches"] == 18 and c["rel"]["kernel"] <= c["noise_share"] * 1.001
        assert c["lambda_rel_diff"] <= 1e-4 and c["factor_diff"] <= 1e-3
        assert c["tuned"]["launches"] == sum(c["tuned"]["launches_by_route"].values())
        assert set(c["ms"]) == {"kernel", "torch", "conventional"}
    assert len(profiled) == 2


def test_phase_10_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.tuned_path`` on a HOOI (phase 10), which phase 29 shares:
    pretune into a fresh cache, a ``cached`` run with every lookup a hit and
    nothing measured, launches by route what the winners imply, and one
    traced iteration's spans in (0, 1.05]."""
    from repro_torch.core.contract import record_contractions

    cs = _cs()
    counters, _ = chip_rehearsal.card_stubbed(monkeypatch, cs)
    _tracing_stubbed(monkeypatch)
    T, noise = cs.low_rank_plus_noise(24, cs.RANKS, 0, device="cpu")
    dec = cs.hooi_run(T)
    with record_contractions() as rec:
        dec.run(1, "kernel")
    counted, routes, _, summary = cs.main_path(dec, noise, 2, counters)
    assert counted["native_gemm"] == sum(routes.values()) > 0
    tuned = cs.tuned_path(dec, rec, noise, 2, counters, summary)
    assert tuned["launches"] == sum(tuned["launches_by_route"].values())
    assert abs(tuned["rel_error"] - summary["rel"]["kernel"]) <= cs.TUNED_REL_TOL
