"""The port's autotuner (``repro_torch.tuning``) against the JAX package's
(``repro.tuning``), on the same numpy inputs.

- Cache: ``canonical_key`` equals the JAX package's but for the platform
  component; a file the JAX package wrote loads here with every entry
  intact and keeps them through the port's saves.
- Candidates: the ``torch`` list is the JAX package's ``xla`` list; every
  ``kernel`` candidate passes ``validate_tiles`` and computes the JAX
  result (f32, 2e-5).
- With the same µs in each package's cache (under its own platform),
  ``contract(strategy="tuned")``, ``xeinsum(optimize="tuned")`` and the
  cost model give the same winners, paths, results and predictions.
- HOOI under ``strategy="tuned"`` matches the JAX package's ``rel_error``.
- Drift is detected, re-measured and retrained under an injected
  measurement function and clock: no real timing decides anything here.
- A kernel candidate that raises makes the tuner raise.
- On the card (``gpu``-marked): a tuned contract at a ragged shape
  launches the winner's route."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.tuning.dispatch as dispatch_mod
from layoutfuzz import gen_layout_case
from repro.core.contract import contract as jcontract
from repro.core.einsum import contraction_path as jcontraction_path
from repro.core.einsum import xeinsum as jxeinsum
from repro.core.notation import parse_spec as jparse_spec
from repro.core.table2 import CASES
from repro.core.tucker import hooi as jhooi
from repro.tuning import cache as jcache_mod
from repro.tuning import candidates as jcandidates
from repro.tuning import dispatch as jdispatch
from repro.tuning import federate as jfederate
from repro.tuning import model as jmodel
from repro_torch.core.contract import contract
from repro_torch.core.einsum import contraction_path, xeinsum
from repro_torch.core.notation import parse_spec
from repro_torch.core.program import compile_program
from repro_torch.core.tucker import hooi
from repro_torch.kernels import ops
from repro_torch.obs import trace
from repro_torch.tuning import (
    Candidate, Dispatcher, TuningCache, canonical_key, enumerate_candidates,
    set_dispatcher, validate_tiles)
from repro_torch.tuning import federate, model
from repro_torch.tuning.cache import platform_of
from repro_torch.tuning.candidates import enumerate_grouped_candidates
from repro_torch.tuning.drift import DriftDetector
from repro_torch.tuning.measure import Measurement

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

DIMS = {"m": 6, "n": 10, "p": 3, "k": 5}
BOTH = ("torch", "kernel")
F32 = dict(rtol=2e-5, atol=2e-5)
PLATFORM = "torch-cpu"
JAX_NAME = {"torch": "xla", "kernel": "pallas"}


@pytest.fixture(autouse=True)
def _fresh_dispatchers():
    set_dispatcher(None)
    jdispatch.set_dispatcher(None)
    trace.set_tracer(None)
    yield
    set_dispatcher(None)
    jdispatch.set_dispatcher(None)
    trace.set_tracer(None)


def _jax_key(ckey: str) -> str:
    backend, _, rest = ckey.partition(":")
    return f"{JAX_NAME[backend]}:{rest}"


def _operands(spec, dims, seed=0):
    cs = parse_spec(spec)
    rng = np.random.default_rng(seed)
    return [rng.standard_normal([dims[m] for m in modes]).astype(np.float32)
            for modes in (cs.a_modes, cs.b_modes)]


def _specs():
    out = [(CASES[label].row_major(), DIMS) for label in sorted(CASES)]
    out += [(cs.spec_str(), dims) for cs, dims, *_ in map(gen_layout_case, range(0, 100, 5))]
    return out


# -------------------------------------------------------------------- cache
def test_canonical_key_equals_jax_but_for_the_platform():
    for spec, dims in _specs():
        for dt in ("float32", "bfloat16"):
            mine = canonical_key(spec, dims, getattr(torch, dt))
            theirs = jcache_mod.canonical_key(spec, dims, jnp.dtype(dt), "cpu")
            assert mine.rsplit("|", 1) == [theirs.rsplit("|", 1)[0], PLATFORM], spec
            assert canonical_key(parse_spec(spec), dims, dt) == mine


def test_platform_strings_never_collide_with_jax_backends():
    assert platform_of("cpu") == PLATFORM
    for jax_platform in ("cpu", "gpu", "cuda", "tpu"):
        assert not PLATFORM == jax_platform


def test_cache_file_round_trips_between_the_packages(tmp_path):
    """A JAX-written file loads in the port with every entry intact; the
    port's save keeps them beside its own, and the JAX package then still
    reads all of its entries (it drops the port's, whose backends it does
    not know: sharing a file works from the JAX package to the port)."""
    path = tmp_path / "tuning.json"
    jc = jcache_mod.TuningCache(path)
    jentries = {}
    for i, (spec, dims) in enumerate(_specs()[:12]):
        key = jcache_mod.canonical_key(spec, dims, jnp.float32, "cpu")
        entry = {"best": "xla:auto", "results": {"xla:auto": 10.0 + i, "xla:direct": 30.0}}
        if i % 3 == 0:
            entry["results"]["pallas:native"] = 5.0 + i
            entry["best"] = "pallas:native"
            entry["transposes"] = {"pallas:native": 0}
        if i % 4 == 1:
            entry.update(predicted=True, confidence=0.8)
        jc.put(key, entry)
        jentries[key] = entry
    mine = TuningCache(path)
    assert mine.entries == jentries
    d = Dispatcher(mine, policy="cached", backends=("torch",))
    spec, dims = _specs()[0]
    assert d.lookup(spec, dims, torch.float32, PLATFORM) is None      # JAX's stay JAX's
    key = canonical_key(spec, dims, torch.float32)
    mine.put(key, {"best": "kernel:native", "results": {"torch:auto": 9.0,
                                                        "kernel:native": 4.0}})
    assert TuningCache(path).entries == {**jentries, key: mine.entries[key]}
    with pytest.warns(UserWarning, match="dropped 1 malformed"):
        back = jcache_mod.TuningCache(path)
    assert back.entries == jentries


def test_cache_drops_malformed_and_foreign_junk(tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"schema": 1, "entries": {
        "a|1|float32|torch-cpu": {"best": "torch:auto", "results": {"torch:auto": 1.0}},
        "b|1|float32|torch-cpu": {"best": "gpu:auto", "results": {"gpu:auto": 1.0}},
        "c|1|float32|torch-cpu": {"best": "torch:auto", "results": {}},
    }}))
    with pytest.warns(UserWarning, match="dropped 2"):
        c = TuningCache(path)
    assert list(c.entries) == ["a|1|float32|torch-cpu"]


# --------------------------------------------------------------- candidates
def test_torch_candidates_are_the_jax_xla_candidates():
    for spec, dims in _specs():
        mine = [c.key() for c in enumerate_candidates(spec, dims, backends=("torch",))]
        theirs = [c.key() for c in jcandidates.enumerate_candidates(
            spec, dims, backends=("xla",))]
        assert [_jax_key(k) for k in mine] == theirs, spec
        kernels = [c for c in enumerate_candidates(spec, dims, backends=BOTH)
                   if c.backend == "kernel"]
        assert [c for c in enumerate_candidates(spec, dims, backends=BOTH)
                if c.backend == "torch"] == [Candidate.from_key(k) for k in mine]
        assert kernels[-1] == Candidate("native", "kernel")


def test_kernel_candidates_validate_and_compute_the_jax_result():
    for spec, dims in _specs():
        An, Bn = _operands(spec, dims)
        want = np.asarray(jcontract(spec, jnp.asarray(An), jnp.asarray(Bn)))
        A, B = torch.from_numpy(An), torch.from_numpy(Bn)
        for c in enumerate_candidates(spec, dims, backends=BOTH):
            assert Candidate.from_key(c.key()) == c
            validate_tiles(c.tiles_dict)
            got = contract(spec, A, B, strategy=c.strategy, backend=c.backend,
                           tiles=c.tiles_dict or None)
            np.testing.assert_allclose(got.numpy(), want, **F32, err_msg=f"{spec} {c.key()}")


def test_exceptional_plans_get_the_brick_depths():
    exc = [CASES[label].row_major() for label in sorted(CASES) if CASES[label].exceptional]
    keys = [c.key() for c in enumerate_candidates(exc[0], DIMS, backends=BOTH)]
    assert {"kernel:auto[b=4]", "kernel:auto[b=8]", "kernel:auto[b=16]"} <= set(keys)
    assert "kernel:native" in keys


@pytest.mark.parametrize("tiles,msg", [
    ({"u": 64}, "cannot be overridden"), ({"k": 128, "b": 4}, "cannot be overridden"),
    ({"x": 4}, "unknown tile roles"), ({"b": 0}, "positive int"),
    ({"b": True}, "positive int"),
])
def test_validate_tiles_rejects(tiles, msg):
    with pytest.raises(ValueError, match=msg):
        validate_tiles(tiles)


def test_contract_tiles_rules():
    A, B = (torch.from_numpy(x) for x in _operands("mk,pkn->pmn", {"m": 4, "k": 3,
                                                                      "p": 5, "n": 6}))
    want = torch.einsum("mk,pkn->pmn", A, B)
    for b in (1, 2, 16):
        got = contract("mk,pkn->pmn", A, B, strategy="batched", backend="kernel",
                       tiles={"b": b})
        torch.testing.assert_close(got, want, **F32)
    for kw, msg in ((dict(strategy="tuned"), "cannot be combined"),
                    (dict(strategy="direct"), "meaningless"),
                    (dict(strategy="native"), "meaningless"),
                    (dict(strategy="auto"), "requires backend='kernel'"),
                    (dict(strategy="auto", backend="kernel", tiles={"v": 8}), "cannot be")):
        kw.setdefault("tiles", {"b": 4})
        with pytest.raises(ValueError, match=msg):
            contract("mk,pkn->pmn", A, B, **kw)


def test_grouped_candidates():
    assert [c.key() for c in enumerate_grouped_candidates([(3, 4, 5)])] == [
        "torch:grouped", "kernel:grouped"]
    with pytest.raises(ValueError):
        enumerate_grouped_candidates([])


# --------------------------------------- the same µs in both caches → same answers
def _write_both(cache, jc, spec, dims, us_of, dtype="float32", backends=BOTH):
    """One entry per package for ``spec`` at ``dims``: the µs ``us_of``
    gives each port candidate that the JAX package also has; returns the
    two winners."""
    jkeys = {c.key() for c in jcandidates.enumerate_candidates(
        spec, dims, backends=tuple(JAX_NAME[b] for b in backends))}
    mine = {c.key(): us_of(c) for c in enumerate_candidates(spec, dims, backends=backends)
            if _jax_key(c.key()) in jkeys}
    theirs = {_jax_key(k): v for k, v in mine.items()}
    best, jbest = federate.pick_best(mine), jfederate.pick_best(theirs)
    cache.put(canonical_key(spec, dims, dtype), {"best": best, "results": mine})
    jc.put(jcache_mod.canonical_key(spec, dims, jnp.dtype(dtype), "cpu"),
           {"best": jbest, "results": theirs})
    return best, jbest


def test_tuned_contract_matches_jax_on_every_table2_case():
    rng = np.random.default_rng(7)
    disp = Dispatcher(None, policy="cached", backends=BOTH)
    jdisp = jdispatch.Dispatcher(None, policy="cached", backends=("xla", "pallas"))
    set_dispatcher(disp)
    jdispatch.set_dispatcher(jdisp)
    winners = set()
    for label in sorted(CASES):
        spec = CASES[label].row_major()
        best, jbest = _write_both(disp.cache, jdisp.cache, spec, DIMS,
                                  lambda c: float(rng.uniform(1, 100)))
        assert _jax_key(best) == jbest, label
        winners.add(best.partition("[")[0])
        An, Bn = _operands(spec, DIMS, seed=len(winners))
        got = contract(spec, torch.from_numpy(An), torch.from_numpy(Bn), strategy="tuned")
        want = jcontract(spec, jnp.asarray(An), jnp.asarray(Bn), strategy="tuned")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32, err_msg=label)
    assert disp.stats["hits"] == len(CASES) and disp.stats["measurements"] == 0
    assert {"torch:auto", "kernel:native"} <= winners


def test_xeinsum_tuned_chooses_the_jax_path():
    spec, shapes = "ab,bc,cd,de->ae", [(4, 30), (30, 2), (2, 40), (40, 3)]
    dims = {"a": 4, "b": 30, "c": 2, "d": 40, "e": 3}
    disp = Dispatcher(None, policy="cached", backends=("torch",))
    jdisp = jdispatch.Dispatcher(None, policy="cached", backends=("xla",))
    set_dispatcher(disp)
    jdispatch.set_dispatcher(jdisp)
    auto = [s.spec.spec_str() for s in contraction_path(spec, *shapes).steps]
    naive = [s.spec.spec_str() for s in contraction_path(spec, *shapes, optimize="naive").steps]
    assert auto != naive
    # every step of every candidate path measured; the naive path cheapest
    for label in ("auto", "greedy", "naive"):
        for s in contraction_path(spec, *shapes, optimize=label).steps:
            us = 1.0 if label == "naive" else 50.0
            if disp.step_us(s.spec, dims, torch.float32, PLATFORM) is None:
                _write_both(disp.cache, jdisp.cache, s.spec.spec_str(), dims,
                            lambda c, us=us: us, backends=("torch",))
    mine = contraction_path(spec, *shapes, optimize="tuned")
    theirs = jcontraction_path(spec, *shapes, optimize="tuned")
    assert [s.spec.spec_str() for s in mine.steps] == \
        [s.spec.spec_str() for s in theirs.steps] == naive
    ops_np = [np.random.default_rng(i).standard_normal(s).astype(np.float32)
              for i, s in enumerate(shapes)]
    got = xeinsum(spec, *map(torch.from_numpy, ops_np), optimize="tuned")
    want = jxeinsum(spec, *map(jnp.asarray, ops_np), optimize="tuned")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_tuned_program_folds_the_fingerprint_and_looks_up_per_call():
    disp = Dispatcher(None, policy="cached", backends=("torch",))
    set_dispatcher(disp)
    A, B, C = torch.randn(4, 5), torch.randn(5, 6), torch.randn(6, 3)
    p1 = compile_program("ab,bc,cd->ad", A, B, C, optimize="tuned", strategy="tuned")
    assert compile_program("ab,bc,cd->ad", A, B, C, optimize="tuned",
                           strategy="tuned") is p1
    assert p1.signature[-1][0] == "tuning"
    for _ in range(3):
        torch.testing.assert_close(p1(A, B, C), A @ B @ C, **F32)
    assert disp.stats["misses"] == 6 and disp.stats["hits"] == 0
    # entries for p1's steps, cheaper than any analytic price of another path
    d = {"a": 4, "b": 5, "c": 6, "d": 3}
    for s in p1.program.steps:
        disp.cache.put(canonical_key(s.spec, d, torch.float32),
                       {"best": "torch:direct", "results": {"torch:direct": 1e-6}})
    p2 = compile_program("ab,bc,cd->ad", A, B, C, optimize="tuned", strategy="tuned")
    assert p2 is not p1
    disp.reset_counters()
    p2(A, B, C)
    p2(A, B, C)
    assert disp.stats["hits"] == 4 and disp.stats["misses"] == 0


def test_cost_model_predicts_like_jax():
    """Same measured µs for the library candidates of a set of shapes in
    both caches: both packages' models predict the same µs, confidence and
    winner, to 1e-9, on shapes neither measured."""
    cache, jc = TuningCache(None), jcache_mod.TuningCache(None)
    rng = np.random.default_rng(3)
    train = [(CASES[label].row_major(), {m: int(rng.integers(4, 40)) for m in "mnpk"})
             for label in sorted(CASES) for _ in range(2)]
    for spec, dims in train:
        flops = 2 * np.prod(list(dims.values()))
        _write_both(cache, jc, spec, dims,
                    lambda c: float(flops * rng.uniform(0.5, 2.0) / 1e3 + 1.0),
                    backends=("torch",))
    m = model.CostModel.from_cache(cache, platform=PLATFORM)
    jm = jmodel.CostModel.from_cache(jc, platform="cpu")
    assert sorted(m.families) == ["torch:auto", "torch:batched", "torch:direct"]
    assert sorted(_jax_key(f) for f in m.families) == sorted(jm.families)
    assert model.N_FEATURES == jmodel.N_FEATURES
    for spec, dims in _specs():
        p = m.predict(spec, dims, torch.float32, backends=("torch",))
        jp = jm.predict(spec, dims, jnp.float32, backends=("xla",))
        assert _jax_key(p.candidate.key()) == jp.candidate.key(), spec
        assert p.us == pytest.approx(jp.us, rel=1e-9)
        assert p.confidence == pytest.approx(jp.confidence, rel=1e-9)
        assert {_jax_key(k): v for k, v in p.per_candidate.items()} == \
            pytest.approx(jp.per_candidate, rel=1e-9)
    assert model.model_for(cache) is model.model_for(cache)


def test_kernel_features_carry_the_route_and_walk():
    exc = next(CASES[label].row_major() for label in sorted(CASES)
               if CASES[label].exceptional)
    cs = parse_spec(exc)
    x = model.featurize(cs, DIMS, torch.float32, Candidate("auto", "kernel", (("b", 16),)))
    assert len(x) == model.N_FEATURES
    routes = x[19:22]
    assert routes.sum() == 1.0 and x[22] == 4.0          # one route; log2(16)
    t = model.featurize(cs, DIMS, torch.float32, Candidate("auto", "torch"))
    assert (t[19:24] == 0).all()
    # at the HOOI shapes the route is the card's: t1 = T·C streams T
    big = {"m": 512, "n": 512, "p": 512, "k": 10}
    assert model.kernel_route(parse_spec("mnp,pk->mnk"), big, torch.float32,
                              Candidate("auto", "kernel")) == ("stream", 1)


def test_kernel_features_flag_each_route_but_generic():
    """The kernel features are an indicator per ``native_gemm`` route
    (``stream``, ``splitk``, ``wgmma``, at x[19:22]) with ``generic`` the
    all-zero baseline, and log2 of the walk at x[22]: four features, the
    JAX package's four tile log2s, so ``N_FEATURES`` stays its 25."""
    assert model.N_FEATURES == jmodel.N_FEATURES == 25
    cases = [("mk,kn->mn", {"m": 4, "k": 64, "n": 128}, torch.bfloat16, "wgmma", 2),
             ("mk,kn->mn", {"m": 40, "k": 64, "n": 128}, torch.float32, "generic", None),
             ("mnp,pk->mnk", {"m": 512, "n": 512, "p": 512, "k": 10}, torch.float32,
              "stream", 0),
             ("kn,mkp->pnm", DIMS, torch.float32, "splitk", 1)]
    for spec, dims, dtype, route, flag in cases:
        cs = parse_spec(spec)
        cand = Candidate("auto", "kernel")
        got, walk = model.kernel_route(cs, dims, dtype, cand)
        assert got == route, spec
        x = model.featurize(cs, dims, dtype, cand)
        want = np.zeros(3)
        if flag is not None:
            want[flag] = 1.0
        assert (x[19:22] == want).all(), (spec, route, x[19:22])
        assert x[22] == np.log2(walk)


# ---------------------------------------------------------------- HOOI
def test_tuned_hooi_matches_jax():
    rng = np.random.default_rng(0)
    shape, ranks = (14, 12, 10), (3, 4, 2)
    G = rng.standard_normal(ranks)
    fac = [np.linalg.qr(rng.standard_normal((d, r)))[0] for d, r in zip(shape, ranks)]
    T = (np.einsum("ijk,mi,nj,pk->mnp", G, *fac)
         + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    disp = Dispatcher(None, backends=BOTH, iters=1, warmup=1)
    set_dispatcher(disp)
    jdispatch.set_dispatcher(jdispatch.Dispatcher(None, backends=("xla",), iters=1, warmup=1))
    got = hooi(torch.from_numpy(T), ranks, n_iter=3, strategy="tuned")
    want = jhooi(jnp.asarray(T), ranks, n_iter=3, strategy="tuned")
    assert abs(float(got.rel_error) - float(want.rel_error)) < 1e-5
    assert disp.stats["measurements"] > 0 and disp.stats["hits"] > 0
    measured = disp.stats["measurements"]
    disp.policy = "cached"
    again = hooi(torch.from_numpy(T), ranks, n_iter=3, strategy="tuned")
    assert disp.stats["measurements"] == measured
    assert abs(float(again.rel_error) - float(got.rel_error)) < 1e-6


# ------------------------------------------------------------------- drift
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-5
        return self.t


def test_drift_flags_remeasures_and_retrains(monkeypatch):
    """One entry's µs is corrupted 20x low; served under a clock that gives
    every key the same live time, that key alone stands out: it is
    flagged, evicted, re-measured (by the injected measurement) and the
    model is refit.  No real timing decides anything."""
    calls = []

    def fake_measure(cands, spec, A, B, **kw):
        calls.append(spec.spec_str())
        return {c.key(): Measurement(us=10.0, iters=1, warmup=1) for c in cands}

    monkeypatch.setattr(dispatch_mod, "measure_candidates", fake_measure)
    disp = Dispatcher(None, backends=("torch",))
    work = []
    for s, n in (("ab,bc->ac", 6), ("ab,bc->ac", 7), ("mk,kn->mn", 8), ("abc,cd->abd", 3)):
        cs = parse_spec(s)
        dims = {m: n for m in cs.a_modes + cs.b_modes}
        A, B = (torch.from_numpy(x) for x in _operands(s, dims))
        work.append((cs, A, B, dims))
        disp.contract(cs, A, B)
    assert len(calls) == 4 and all(e["best"] == "torch:auto"
                                   for e in disp.cache.entries.values())
    cs0, _, _, dims0 = work[0]
    key0 = canonical_key(cs0, dims0, torch.float32)
    entry = disp.cache.get(key0)
    entry["results"] = {k: v / 20 for k, v in entry["results"].items()}
    disp.cache.put(key0, entry)
    model_before = disp.model()

    t = trace.enable_tracing(trace.Tracer(clock=_Clock()))
    for _ in range(4):
        for cs, A, B, _ in work:
            disp.contract(cs, A, B)
    served = list(t.events())
    det = DriftDetector(disp, ratio=3.0, retrain_gate=0.2)
    report = det.run(served)
    trace.disable_tracing()

    assert report.drifted == report.evicted == report.remeasured == [key0]
    assert report.normalized and len(report.keys) == 4
    assert calls[-1] == cs0.spec_str() and len(calls) == 5
    fresh = disp.cache.get(key0)["results"]
    assert all(v == 10.0 for v in fresh.values())
    assert report.retrained and disp.model() is not model_before
    assert det.stats()["drifted"] == 1
    names = [e["name"] for e in t.events()]
    assert names.count("tuning_drift") == 1 and names.count("tuning_retrain") == 1


def test_drift_reads_device_time_where_a_span_has_it():
    disp = Dispatcher(None, policy="cached", backends=("torch",))
    det = DriftDetector(disp)
    ev = {"ph": "X", "name": "contract", "dur": 500.0,
          "args": {"spec": "ab,bc->ac", "dims": {"a": 2, "b": 3, "c": 4},
                   "dtype": "float32", "device_us": 7.0}}
    assert det.observe([ev, dict(ev, args={**ev["args"], "device_us": 9.0})]) == {
        canonical_key("ab,bc->ac", {"a": 2, "b": 3, "c": 4}, "float32"): [7.0, 9.0]}


# ---------------------------------------------------- no fallback, CLIs, federation
def test_a_kernel_candidate_that_raises_makes_the_tuner_raise(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("native_gemm launch failed")

    monkeypatch.setattr(ops, "native_gemm", broken)
    A, B = (torch.from_numpy(x) for x in _operands("mk,kn->mn", {"m": 5, "k": 4, "n": 3}))
    disp = Dispatcher(None, backends=BOTH, iters=1, warmup=1)
    with pytest.raises(RuntimeError, match="launch failed"):
        disp.tune("mk,kn->mn", A, B)
    assert len(disp.cache) == 0
    set_dispatcher(disp)
    with pytest.raises(RuntimeError, match="launch failed"):
        contract("mk,kn->mn", A, B, strategy="tuned")
    # without the kernel backend nothing launches it, and the library wins
    disp.backends = ("torch",)
    torch.testing.assert_close(contract("mk,kn->mn", A, B, strategy="tuned"), A @ B, **F32)


def test_federation_merges_like_jax(tmp_path, capsys):
    """The port's merge of JAX-format entries is the JAX package's, and a
    federated file keeps both packages' entries under their platforms."""
    rng = np.random.default_rng(5)

    def entry():
        res = {k: float(rng.uniform(1, 9)) for k in ("xla:auto", "xla:direct",
                                                      "pallas:native") if rng.random() < 0.8}
        res = res or {"xla:auto": 2.0}
        return {"best": min(res, key=res.get), "results": res}

    a = {f"k{i}|1|float32|cpu": entry() for i in range(8)}
    b = {f"k{i}|1|float32|cpu": entry() for i in range(4, 12)}
    for conflict in ("min", "max", "mean"):
        assert federate.merge_entries(a, b, conflict=conflict) == \
            jfederate.merge_entries(a, b, conflict=conflict)
    jpath, ppath, out = tmp_path / "jax.json", tmp_path / "port.json", tmp_path / "fleet.json"
    jc = jcache_mod.TuningCache(jpath)
    for k, e in a.items():
        jc.put(k, e)
    pc = TuningCache(ppath)
    pk = canonical_key("ab,bc->ac", {"a": 2, "b": 3, "c": 4}, torch.float32)
    pc.put(pk, {"best": "torch:auto", "results": {"torch:auto": 3.0, "kernel:native": 2.9}})
    federate.main(["merge", str(jpath), str(ppath), "-o", str(out)])
    federate.main(["stats", str(out)])
    text = capsys.readouterr().out
    assert f"platform {PLATFORM}: 1 entries" in text and "platform cpu: 8 entries" in text
    merged = TuningCache(out)
    assert merged.get(pk)["best"] == "torch:auto"            # within the tie margin
    assert {k: merged.get(k) for k in a} == a


def test_dispatch_demo_on_the_cpu(tmp_path, capsys):
    dispatch_mod.main(["--demo", "--device", "cpu", "--size", "6",
                       "--cache", str(tmp_path / "demo.json")])
    out = capsys.readouterr().out
    assert f"platform={PLATFORM}" in out
    assert "'measurements': 0" in out.splitlines()[-1]


def test_isolation_test_covers_the_new_modules():
    from test_torch_isolation import MODULES

    for name in ("repro_torch.obs.roofline", "repro_torch.obs.health",
                 "repro_torch.obs.export", "repro_torch.tuning.dispatch",
                 "repro_torch.tuning.model", "repro_torch.tuning.drift",
                 "repro_torch.tuning.federate", "repro_torch.tuning"):
        assert name in MODULES


# --------------------------------------------------------------------- card
@pytest.mark.gpu
def test_tuned_contract_launches_the_winners_route():
    """At a ragged shape, each kernel candidate made the winner in turn:
    the tuned contract launches ``native_gemm`` once, on the route
    ``model.kernel_route`` gives, and matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    from repro_torch.kernels.sb_gemm import native_gemm, native_gemm_ref

    dev = torch.device("cuda")
    for spec, dims in (("mnp,pk->mnk", {"m": 383, "n": 257, "p": 47, "k": 10}),
                       (next(CASES[label].row_major() for label in sorted(CASES)
                             if CASES[label].exceptional),
                        {"m": 383, "n": 257, "p": 47, "k": 321})):
        cs = parse_spec(spec)
        A, B = (torch.from_numpy(x).to(dev) for x in _operands(spec, dims, seed=9))
        disp = Dispatcher(None, backends=BOTH, iters=2, warmup=1)
        set_dispatcher(disp)
        entry = disp.tune(cs, A, B)
        key = canonical_key(cs, dims, torch.float32, platform_of(dev))
        want = native_gemm_ref(A, B, a_modes=cs.a_modes, b_modes=cs.b_modes,
                               c_modes=cs.c_modes)
        disp.policy = "cached"
        for ckey in entry["results"]:
            cand = Candidate.from_key(ckey)
            if cand.backend != "kernel":
                continue
            disp.cache.put(key, {**entry, "best": ckey})
            route, _ = model.kernel_route(cs, dims, torch.float32, cand)
            before = dict(native_gemm.launches_by_route)
            got = contract(spec, A, B, strategy="tuned")
            torch.cuda.synchronize()
            ran = {r: n - before[r] for r, n in native_gemm.launches_by_route.items()}
            assert ran == {r: int(r == route) for r in ran}, (spec, ckey)
            torch.testing.assert_close(got, want, **F32)
