"""The port's serving runtime (``repro_torch.runtime``, ``repro_torch.serving``,
``repro_torch.launch.serve``): the counterparts of ``tests/test_runtime.py``
and ``tests/test_serving.py`` that need no page pool, and the runtime held
against the JAX package's on the same weights.

- Lattice, scheduler, metrics: the JAX package's unit tests, on the port.
- The bucketed runtime gives the legacy engine's greedy tokens (padded
  bucket included), builds nothing after warm-up, evicts, caps, rejects,
  samples reproducibly, serves jamba, and gives the JAX runtime's greedy
  tokens on the same weights.
- The batched bucket decode equals a loop of per-slot ``decode_step``
  calls, qwen2-moe included at a bucket above the expert capacity.
- Chunked prefill is held to the port's own invariant (tokens equal,
  logits within tolerance); the reference's bit-exact version of that
  test is red (ROADMAP queue 3)."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro.runtime.engine import ServingRuntime as JServingRuntime
from repro.runtime.scheduler import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.tree import tree_map
from repro_torch.runtime.buckets import (
    BucketLattice, BucketTable, chunk_schedule, pow2_buckets, tuning_key_component,
)
from repro_torch.runtime.engine import (
    ServingRuntime, _write_slot, slot_cache, supports_chunked_prefill,
)
from repro_torch.runtime.metrics import ServingMetrics
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.serving.engine import ServeEngine

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()


# ----------------------------------------------------------------- buckets
class TestBuckets:
    def test_pow2_buckets(self):
        assert pow2_buckets(1) == (1,)
        assert pow2_buckets(4) == (1, 2, 4)
        assert pow2_buckets(6) == (1, 2, 4, 6)        # cap included
        with pytest.raises(ValueError):
            pow2_buckets(0)

    def test_chunk_schedule_covers_exactly(self):
        chunks = pow2_buckets(8)
        for n in range(1, 40):
            sched = chunk_schedule(n, chunks)
            assert sum(sched) == n
            assert all(c in chunks for c in sched)
            assert sched == sorted(sched, reverse=True)   # largest-first

    def test_lattice_modes(self):
        lat = BucketLattice(4, max_chunk=8)
        assert lat.decode_bucket(3) == 4
        assert lat.decode_bucket(1) == 1
        assert lat.next_chunk(13) == 8
        with pytest.raises(ValueError):
            lat.decode_bucket(5)
        legacy = BucketLattice(4, max_chunk=8, chunked=False, bucketed_decode=False)
        assert legacy.slot_buckets == (4,)
        assert legacy.next_chunk(13) == 13             # exact single shot

    def test_bucket_table_builds_once(self):
        table = BucketTable()
        builds = []
        key = table.key("decode", 2, None)
        for _ in range(3):
            table.get(key, lambda: builds.append(1) or "entry")
        assert builds == [1]
        assert table.compiles == 1 and table.hits == 2
        assert table.stats()["bucket_hit_rate"] == pytest.approx(2 / 3)

    def test_tuning_fingerprint_reads_the_ports_dispatcher(self):
        from repro_torch.tuning import Dispatcher, set_dispatcher

        assert tuning_key_component("auto") is None
        set_dispatcher(Dispatcher(None, policy="cached"))
        try:
            fp = tuning_key_component("tuned")
        finally:
            set_dispatcher(None)
        assert fp is not None and fp[0] == "cached" and len(fp) == 2


# --------------------------------------------------------------- scheduler
class TestScheduler:
    def _sched(self, slots=2, chunk=4):
        return Scheduler(slots, BucketLattice(slots, max_chunk=chunk))

    def _req(self, rid, plen=5, max_new=3):
        return Request(rid=rid, prompt=np.arange(plen, dtype=np.int32),
                       max_new_tokens=max_new)

    def test_fifo_admission_and_chunk_plan(self):
        s = self._sched()
        for rid in range(3):
            s.submit(self._req(rid, plen=5))
        plan = s.schedule()
        assert [st.rid for st in plan.admitted] == [0, 1]
        assert [(st.rid, c) for st, c in plan.prefills] == [(0, 4), (1, 4)]
        assert s.decode_batch() == [] and len(s.queue) == 1

    def test_eviction_frees_slot_for_queue(self):
        s = self._sched()
        states = [s.submit(self._req(rid)) for rid in range(3)]
        s.schedule()
        s.evict(1)
        assert states[1].request.status == "evicted"
        assert not states[1].request.done
        plan = s.schedule()                            # rid 2 takes the slot
        assert [st.rid for st in plan.admitted] == [2]
        assert s.n_free == 0

    def test_evict_queued_request_cancels_it(self):
        s = self._sched()
        states = [s.submit(self._req(rid)) for rid in range(3)]
        s.schedule()
        assert s.evict(2) is states[2]
        assert states[2].request.status == "evicted" and not states[2].request.done
        assert len(s.queue) == 0 and s.n_active == 2
        with pytest.raises(KeyError, match="neither active nor queued"):
            s.evict(42)

    def test_finish_releases_slot(self):
        s = self._sched(slots=1)
        st = s.submit(self._req(0))
        s.schedule()
        s.finish(st)
        assert st.request.done and st.request.status == "done"
        assert s.n_free == 1 and not s.has_work()

    def test_per_request_generators_are_independent_reproducible_streams(self):
        s = self._sched()
        a, b = s.submit(self._req(0)), s.submit(self._req(1))
        draws = [torch.rand(4, generator=g) for g in (a.next_key(), a.next_key(), b.next_key())]
        assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
        again = self._sched().submit(self._req(0))
        assert torch.equal(torch.rand(4, generator=again.next_key()), draws[0])


# ----------------------------------------------------------------- metrics
class TestMetrics:
    def test_latency_percentiles_with_fake_clock(self):
        t = [0.0]
        m = ServingMetrics(slots=4, clock=lambda: t[0])
        m.start()
        for rid, dt in enumerate([1.0, 2.0, 4.0]):
            t[0] = float(rid)
            m.on_submit(rid)
            t[0] += 0.5
            m.on_first_token(rid)
            t[0] = rid + dt
            m.on_finish(rid)
        t[0] = 10.0
        m.stop()
        snap = m.snapshot()
        assert snap["requests_done"] == 3
        assert snap["p50_latency_s"] == pytest.approx(2.0)
        assert snap["p50_ttft_s"] == pytest.approx(0.5)
        assert snap["throughput_tok_s"] == pytest.approx(0.3)

    def test_utilization_counters(self):
        m = ServingMetrics(slots=4, clock=lambda: 0.0)
        m.on_decode(3, 4)
        m.on_decode(1, 1)
        m.on_tick(3)
        m.on_tick(1)
        snap = m.snapshot()
        assert snap["decode_efficiency"] == pytest.approx(4 / 5)
        assert snap["slot_occupancy"] == pytest.approx(0.5)


# ---------------------------------------------------- runtime (with model)
def jax_params(jcfg, seed=0):
    return jtransformer.init_params(jax.random.PRNGKey(seed), jcfg)


@pytest.fixture(scope="module")
def served():
    """minicpm-2b smoke at one period: the JAX package's weights, carried
    over."""
    jcfg = jget_config("minicpm-2b", smoke=True, n_periods=1)
    cfg = get_config("minicpm-2b", smoke=True, n_periods=1)
    jp = jax_params(jcfg)
    return cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu"), jcfg, jp


def ragged_requests(cfg, lens, max_new=4, cls=Request):
    return [cls(rid=i, prompt=np.random.default_rng(i).integers(
        0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=max_new)
        for i, n in enumerate(lens)]


def test_runtime_token_identical_to_legacy_engine(served):
    cfg, params, *_ = served
    lens = [3, 11, 7, 19, 2, 13]
    old = ServeEngine(cfg, params, slots=2, max_len=64, precompile=False)
    ref = old.serve(ragged_requests(cfg, lens))
    rt = ServingRuntime(cfg, params, slots=2, max_len=64, prefill_chunk=8, precompile=False)
    got = rt.serve(ragged_requests(cfg, lens))
    for a, b in zip(ref, got):
        assert b.done and b.output == a.output, (a.rid, a.output, b.output)
    assert all(k[0] in ("decode", "prefill") for k in rt.buckets.keys())
    assert {k[1] for k in rt.buckets.keys() if k[0] == "prefill"} <= {1, 2, 4, 8}


def test_runtime_identity_with_padded_decode_bucket(served):
    """Six slots: a 3-active tick decodes in the 4-bucket with a duplicated
    slot index, which must not perturb any token."""
    cfg, params, *_ = served
    lens = [3, 11, 7, 19, 2]
    ref = ServeEngine(cfg, params, slots=6, max_len=64, precompile=False).serve(
        ragged_requests(cfg, lens, max_new=3))
    rt = ServingRuntime(cfg, params, slots=6, max_len=64, prefill_chunk=8, precompile=False)
    got = rt.serve(ragged_requests(cfg, lens, max_new=3))
    assert [r.output for r in got] == [r.output for r in ref]
    assert rt.lattice.slot_buckets == (1, 2, 4, 6)
    assert ("decode", 4, None) in rt.buckets.keys()


def test_runtime_greedy_tokens_equal_the_jax_runtime(served):
    """Prompts of whole chunks keep the JAX runtime to three compiled
    steps (one prefill chunk, two decode buckets); the raggedness is the
    legacy-engine tests' part."""
    cfg, params, jcfg, jp = served
    lens = [8, 16, 24, 8]
    want = JServingRuntime(jcfg, jp, slots=2, max_len=64, prefill_chunk=8,
                           precompile=False).serve(
        ragged_requests(jcfg, lens, cls=JRequest))
    got = ServingRuntime(cfg, params, slots=2, max_len=64, prefill_chunk=8,
                         precompile=False).serve(ragged_requests(cfg, lens))
    assert [r.output for r in got] == [r.output for r in want]


def test_runtime_zero_rebuilds_after_warmup(served):
    cfg, params, *_ = served
    rt = ServingRuntime(cfg, params, slots=2, max_len=64, prefill_chunk=8)
    assert rt.program_stats["programs"] > 0       # the warm-up ran every lattice point
    rt.serve(ragged_requests(cfg, [3, 11, 7, 19], max_new=3))
    warm = rt.buckets.compiles
    rt.serve(ragged_requests(cfg, [5, 14, 1, 9, 12], max_new=3))
    assert rt.buckets.compiles == warm
    assert rt.buckets.stats()["bucket_hits"] > 0
    assert rt.precompile_buckets() == len(rt.lattice.slot_buckets) + len(
        rt.lattice.chunk_buckets)


def test_chunked_prefill_matches_whole_prompt(served):
    """The port's invariant: prefilling 8+4+1 chunks gives the 13-token
    one-shot prefill's next token, logits within 1e-5 of the largest."""
    cfg, params, *_ = served
    prompt = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, 13))[None]
    want, want_cache = T.prefill(cfg, params, {"tokens": prompt},
                                 T.init_cache(cfg, 1, 32, device="cpu"))
    cache, pos = T.init_cache(cfg, 1, 32, device="cpu"), 0
    for chunk in (8, 4, 1):
        got, cache = T.prefill(cfg, params, {"tokens": prompt[:, pos:pos + chunk]}, cache)
        pos += chunk
    assert torch.argmax(got) == torch.argmax(want)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    for a, b in zip(jax.tree.leaves(want_cache), jax.tree.leaves(cache)):
        torch.testing.assert_close(b.float(), a.float(), rtol=1e-5, atol=1e-5)


def test_runtime_eviction_and_slot_reuse(served):
    cfg, params, *_ = served
    rt = ServingRuntime(cfg, params, slots=1, max_len=64, precompile=False)
    reqs = ragged_requests(cfg, [4, 4], max_new=50)
    rt.submit(reqs[0])
    rt.submit(reqs[1])
    rt.tick()          # admits rid 0: prefill + first token + first decode
    assert reqs[0].status == "decode" and len(reqs[0].output) == 2
    rt.evict(0)
    assert reqs[0].status == "evicted" and not reqs[0].done
    rt.tick()          # rid 1 reuses the slot
    assert reqs[1].status in ("prefill", "decode")
    while rt.scheduler.has_work() and len(reqs[1].output) < 3:
        rt.tick()
    assert len(reqs[1].output) >= 1 and rt.metrics.evictions == 1


def test_runtime_cache_length_cap_evicts(served):
    cfg, params, *_ = served
    rt = ServingRuntime(cfg, params, slots=1, max_len=8, precompile=False)
    (req,) = ragged_requests(cfg, [5], max_new=100)
    rt.serve([req], max_steps=50)
    assert req.status == "evicted" and not req.done
    assert len(req.output) == 4        # 5 prompt + first token + decodes to row 7


def test_runtime_rejects_prompt_longer_than_max_len(served):
    cfg, params, *_ = served
    rt = ServingRuntime(cfg, params, slots=1, max_len=8, precompile=False)
    (req,) = ragged_requests(cfg, [9])
    with pytest.raises(ValueError, match="exceeds max_len"):
        rt.submit(req)
    long, ok = ragged_requests(cfg, [9, 8], max_new=5)
    with pytest.warns(RuntimeWarning, match="rejected"):
        rt.serve([long, ok])
    assert long.status == "rejected" and ok.output and ok.status == "evicted"


def test_runtime_nongreedy_is_reproducible_per_request(served):
    cfg, params, *_ = served

    def run(greedy):
        rt = ServingRuntime(cfg, params, slots=2, max_len=64, greedy=greedy,
                            precompile=False)
        return [r.output for r in rt.serve(ragged_requests(cfg, [6, 9, 4], max_new=5))]

    a, b = run(False), run(False)
    assert a == b                              # deterministic streams
    assert run(True) != a                      # sampling actually happens
    assert all(len(o) == 5 for o in a)


def test_runtime_rejects_chunking_on_ssm_archs_and_unported_modes(served):
    cfg = get_config("jamba-v0.1-52b", smoke=True, n_periods=1)
    assert not supports_chunked_prefill(cfg)
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingRuntime(cfg, {}, slots=1, max_len=16, chunked_prefill=True)
    with pytest.raises(ValueError, match="cannot be paged"):
        ServingRuntime(cfg, {}, slots=1, max_len=16, paged=True)
    cfg, params, *_ = served
    # the mesh hooks serve (on a gloo world of one, every block the whole
    # tensor: the unsharded tokens); the paged pool does not serve sharded
    import torch.distributed as dist

    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import make_host_mesh

    want = [r.output for r in ServeEngine(cfg, params, slots=2, max_len=32).serve(
        ragged_requests(cfg, [5, 3], max_new=3))]
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="paged"):
            ServingRuntime(cfg, params, mesh=mesh, paged=True)
        got = ServingRuntime(cfg, params, slots=2, max_len=32, mesh=mesh).serve(
            ragged_requests(cfg, [5, 3], max_new=3))
        assert [r.output for r in got] == want
        got = ServeEngine(cfg, params, slots=2, max_len=32,
                          sharding_rules=ShardingRules(mesh)).serve(
            ragged_requests(cfg, [5, 3], max_new=3))
        assert [r.output for r in got] == want
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(get_config("hubert-xlarge", smoke=True), {}, slots=1, max_len=8)


def test_runtime_metrics_snapshot_end_to_end(served):
    cfg, params, *_ = served
    rt = ServingRuntime(cfg, params, slots=2, max_len=64, prefill_chunk=8, precompile=False)
    reqs = rt.serve(ragged_requests(cfg, [3, 11, 7], max_new=3))
    snap = rt.metrics.snapshot(rt.buckets)
    assert snap["requests_done"] == 3
    assert snap["tokens_out"] == sum(len(r.output) for r in reqs)
    assert snap["prefill_tokens"] == sum(len(r.prompt) for r in reqs)
    assert 0 < snap["bucket_hit_rate"] <= 1 and snap["throughput_tok_s"] > 0
    assert 0 < snap["slot_occupancy"] <= 1
    reg = rt.register_metrics(__import__("repro_torch.obs.registry", fromlist=["x"])
                              .MetricsRegistry())
    assert {"serving", "buckets", "programs"} <= set(reg.snapshot())


# -------------------------------------------------- batched bucket decode
def filled_slots(cfg, params, lens, max_len=32):
    """A slot-stacked cache with one prefilled request per slot, and each
    slot's next token."""
    cache = slot_cache(cfg, len(lens), max_len, device="cpu")
    toks = []
    for slot, n in enumerate(lens):
        prompt = torch.from_numpy(np.random.default_rng(slot).integers(0, cfg.vocab_size, n))
        logits, one = T.prefill(cfg, params, {"tokens": prompt[None]},
                                T.init_cache(cfg, 1, max_len, device="cpu"))
        _write_slot(cache, one, slot)
        toks.append(int(torch.argmax(logits[0])))
    return cache, torch.tensor(toks)[:, None]


def slot_of(cache, slot):
    """Slot ``slot`` of a slot-stacked cache as a batch-1 cache with scalar
    lengths (the JAX package's form)."""
    def one(x, axis):
        row = x.narrow(axis, slot, 1)
        return row.squeeze(axis) if x.ndim == axis + 1 else row
    return tree_map(one, cache, {"length": 0, "prefix": tree_map(lambda _: 0, cache["prefix"]),
                                 "pattern": tree_map(lambda _: 1, cache["pattern"])})


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2-moe-a2.7b", "jamba-v0.1-52b",
                                  "gemma2-27b"])
def test_batched_decode_equals_per_slot_loop(arch):
    """One batched decode over 8 slots of ragged lengths equals 8
    batch-1 ``decode_step`` calls.  For qwen2-moe the bucket (8 tokens) is
    above the per-group capacity: routing all 8 as one group would drop
    tokens, which the per-row groups must not."""
    cfg = get_config(arch, smoke=True, n_periods=1)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    lens = [3, 9, 5, 1, 12, 7, 2, 6]
    cache, toks = filled_slots(cfg, params, lens)
    logits, new = T.decode_step(cfg, params, cache, toks)
    assert new["length"].tolist() == [n + 1 for n in lens]
    for slot in range(len(lens)):
        want, want_cache = T.decode_step(cfg, params, slot_of(cache, slot), toks[slot:slot + 1])
        torch.testing.assert_close(logits[slot:slot + 1], want, rtol=1e-5, atol=1e-5)
        for a, b in zip(jax.tree.leaves(want_cache), jax.tree.leaves(slot_of(new, slot))):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
    if cfg.moe is not None:
        # eight rows routed alike: 8 tokens for each of two experts, above a
        # group of 8's capacity of 6 (a row's own group holds 4 of 1)
        x = torch.randn(1, 1, cfg.d_model, generator=torch.Generator().manual_seed(1))
        x = x.expand(8, 1, cfg.d_model)
        j = next(j for j, spec in enumerate(cfg.pattern) if spec.ff == "moe")
        p = tree_map(lambda t: t[0], params["pattern"][j]["moe"])
        per_row, _ = moe.moe_ffn(cfg, p, x, group=1)
        one_group, _ = moe.moe_ffn(cfg, p, x)
        rows = torch.cat([moe.moe_ffn(cfg, p, x[i:i + 1])[0] for i in range(8)])
        torch.testing.assert_close(per_row, rows)
        assert not torch.allclose(one_group, rows, atol=1e-3)   # the one group drops


def test_runtime_serves_qwen2_moe_like_the_legacy_engine():
    """MoE through the bucketed decode (buckets of 1 to 8 rows) gives the
    legacy engine's tokens.  Prefill is whole-prompt on both sides: a
    chunk routes as its own dispatch group, so chunked prefill drops other
    tokens than the whole prompt does, in the JAX package as here."""
    cfg = get_config("qwen2-moe-a2.7b", smoke=True, n_periods=1)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    lens = [3, 11, 7, 19, 2, 13, 5, 8]

    def requests():
        reqs = ragged_requests(cfg, lens)
        for r, n in zip(reqs, [2, 6, 3, 7, 1, 5, 4, 2]):
            r.max_new_tokens = n
        return reqs

    ref = ServeEngine(cfg, params, slots=8, max_len=64, precompile=False).serve(requests())
    rt = ServingRuntime(cfg, params, slots=8, max_len=64, chunked_prefill=False,
                        precompile=False)
    got = rt.serve(requests())
    assert {k[1] for k in rt.buckets.keys() if k[0] == "decode"} > {8}
    assert [r.output for r in got] == [r.output for r in ref]


# ------------------------------------------------------- serving (legacy)
def test_engine_matches_manual_greedy_decode(served):
    cfg, params, *_ = served
    prompt = np.array([3, 14, 15, 92], np.int32)
    cache = T.init_cache(cfg, 1, 64, device="cpu")
    logits, cache = T.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)[None]}, cache)
    want = [int(torch.argmax(logits[0]))]
    for _ in range(5):
        logits, cache = T.decode_step(cfg, params, cache, torch.tensor([[want[-1]]]))
        want.append(int(torch.argmax(logits[0])))
    (req,) = ServeEngine(cfg, params, slots=2, max_len=64).serve(
        [Request(rid=0, prompt=prompt, max_new_tokens=6)])
    assert req.done and req.output == want


def test_continuous_batching_slot_isolation(served):
    cfg, params, *_ = served
    prompts = [np.array(p, np.int32) for p in ([1, 2, 3], [10, 20, 30, 40, 50], [7], [99, 98])]
    solo = [ServeEngine(cfg, params, slots=1, max_len=64, precompile=False).serve(
        [Request(rid=i, prompt=p, max_new_tokens=4)])[0].output for i, p in enumerate(prompts)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    ServeEngine(cfg, params, slots=2, max_len=64, precompile=False).serve(reqs)
    for r, want in zip(reqs, solo):
        assert r.done and r.output == want, (r.rid, r.output, want)


def test_admission_when_full(served):
    cfg, params, *_ = served
    eng = ServeEngine(cfg, params, slots=2, max_len=64, precompile=False)
    reqs = [Request(rid=i, prompt=np.array([i + 1, i + 2], np.int32), max_new_tokens=3)
            for i in range(3)]
    assert eng.admit(reqs[0]) and eng.admit(reqs[1])
    assert not eng.admit(reqs[2])
    assert reqs[2].output == [] and reqs[2].status == "queued"
    while eng.active:
        eng.step()
    assert eng.admit(reqs[2])
    while eng.active:
        eng.step()
    assert all(r.done and len(r.output) == 3 for r in reqs)


def test_max_steps_exhaustion_marks_unfinished(served):
    cfg, params, *_ = served
    eng = ServeEngine(cfg, params, slots=1, max_len=64, precompile=False)
    reqs = [Request(rid=0, prompt=np.array([1, 2], np.int32), max_new_tokens=30),
            Request(rid=1, prompt=np.array([3], np.int32), max_new_tokens=30)]
    with pytest.warns(RuntimeWarning, match="max_steps=3"):
        eng.serve(reqs, max_steps=3)
    assert all(not r.done and r.status == "unfinished" for r in reqs)
    assert 0 < len(reqs[0].output) < 30 and reqs[1].output == []


def test_hybrid_arch_serving():
    """Jamba: attention KV + mamba recurrent state in one slot-stacked
    cache; the bucketed runtime gives the legacy engine's tokens."""
    cfg = get_config("jamba-v0.1-52b", smoke=True, n_periods=1)
    params = T.init_params(torch.Generator().manual_seed(1), cfg)
    prompts = [np.array([5, 6, 7], np.int32), np.array([8, 9], np.int32),
               np.array([1, 2, 3, 4, 5], np.int32)]
    ref = ServeEngine(cfg, params, slots=2, max_len=32).serve(
        [Request(rid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)])
    got = ServingRuntime(cfg, params, slots=2, max_len=32, precompile=False).serve(
        [Request(rid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)])
    assert all(r.done and len(r.output) == 3 for r in ref)
    assert [r.output for r in got] == [r.output for r in ref]


# ------------------------------------------------------------------- CLI
def test_serve_cli_on_the_cpu(tmp_path):
    """The launcher serves on the CPU, with the ported observability and
    tuning flags wired in; ``--mesh 1x1`` serves sharded in one process, and
    a mesh of more ranks without ``torch.distributed.run`` exits naming it."""
    # one intra-op thread, as in this process: the launcher must not
    # crowd the parallel test workers
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "minicpm-2b",
         "--smoke", "--device", "cpu", "--requests", "3", "--max-new", "4",
         "--trace", str(tmp_path / "trace.json"), "--metrics-jsonl", str(tmp_path / "m.jsonl"),
         "--metrics-interval", "0", "--watchdogs", "--numerics-every", "1", "--drift-check",
         "--pretune", "--tuning-cache", str(tmp_path / "tuning.json")],
        env=env, capture_output=True, text=True, timeout=300, stdin=subprocess.DEVNULL)
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests, 12 tokens" in proc.stdout
    assert "pretune:" in proc.stdout and "drift:" in proc.stdout and "health:" in proc.stdout
    for name in ("trace.json", "m.jsonl", "tuning.json"):
        assert (tmp_path / name).stat().st_size > 0
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "minicpm-2b",
            "--smoke", "--device", "cpu", "--requests", "2", "--max-new", "3"]
    mesh = subprocess.run(base + ["--mesh", "1x1"], env=env, capture_output=True, text=True,
                          timeout=300, stdin=subprocess.DEVNULL)
    assert mesh.returncode == 0, mesh.stderr
    assert "mesh: 1x1 over 1 cpu ranks" in mesh.stdout
    assert "served 2 requests, 6 tokens" in mesh.stdout
    alone = subprocess.run(base + ["--mesh", "2x4"], env=env, capture_output=True, text=True,
                           timeout=300, stdin=subprocess.DEVNULL)
    assert alone.returncode != 0 and "torch.distributed.run" in alone.stderr


# ------------------------------------------------------------------ card
@pytest.mark.gpu
def test_runtime_serves_a_smoke_model_on_the_card():
    """On the card, with the kernel backend: the runtime gives the legacy
    engine's tokens and the CPU run's, and launches ``native_gemm``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.sb_gemm import native_gemm

    cfg = get_config("minicpm-2b", smoke=True, n_periods=1, contract_backend="kernel")
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    on_card = tree_map(lambda t: t.cuda(), params)
    lens = [3, 11, 7, 19, 2]
    before = native_gemm.launches
    got = ServingRuntime(cfg, on_card, slots=4, max_len=64, prefill_chunk=8).serve(
        ragged_requests(cfg, lens))
    assert native_gemm.launches > before
    ref = ServeEngine(cfg, on_card, slots=4, max_len=64).serve(ragged_requests(cfg, lens))
    cpu = ServingRuntime(cfg, params, slots=4, max_len=64, prefill_chunk=8).serve(
        ragged_requests(cfg, lens))
    assert [r.output for r in got] == [r.output for r in ref] == [r.output for r in cpu]
