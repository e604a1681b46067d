"""The port's paged KV-cache (``repro_torch.runtime.pages`` and the
``paged=True`` runtime): the counterparts of ``tests/test_pages.py``, and
the port held against the JAX package.

- Pool bookkeeping, prefix sharing and the page lattice: the JAX
  package's unit tests, on the port.
- Admission/register/share/release sequences replayed through both
  packages' ``PagePool``s give identical page tables, hashes, refcounts
  and free lists.
- The paged runtime gives the unpaged runtime's greedy tokens (null-page
  padding, page-count buckets, prefix sharing), drains its pool, evicts
  under pressure, and gives the JAX package's paged runtime's tokens on
  the same weights.
- The gather into the slot-stacked layout and the row commits are exact
  copies (checked leaf by leaf)."""

import os
import pathlib
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro.runtime.engine import ServingRuntime as JServingRuntime
from repro.runtime.pages import PagePool as JPagePool
from repro.runtime.pages import PoolExhausted as JPoolExhausted
from repro.runtime.scheduler import Request as JRequest
from repro.runtime.scheduler import RequestState as JRequestState
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.models.tree import tree_leaves_with_path, tree_map
from repro_torch.runtime.buckets import BucketLattice, BucketTable
from repro_torch.runtime.engine import ServingRuntime
from repro_torch.runtime.pages import NULL_PAGE, PagedKV, PagePool, PoolExhausted
from repro_torch.runtime.scheduler import Request, RequestState

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()


# ----------------------------------------------------------------- helpers
def _state(rid, prompt, max_new=4, cls=RequestState, req=Request):
    return cls(req(rid=rid, prompt=np.asarray(prompt, np.int32), max_new_tokens=max_new))


# ---------------------------------------------------------------- PagePool
class TestPagePool:
    def test_geometry_and_null_page_reserved(self):
        pool = PagePool(9, 4)
        assert pool.usable == 8 and pool.n_free == 8
        assert pool.pages_for(1) == 1 and pool.pages_for(4) == 1
        assert pool.pages_for(5) == 2
        # prompt + first decode row, capped at max_rows
        assert pool.required_pages(3) == 1        # 4 rows
        assert pool.required_pages(4) == 2        # 5 rows
        pages = pool.alloc(8)
        assert NULL_PAGE not in pages             # never handed out
        assert pool.n_free == 0

    def test_alloc_exhaustion_is_atomic(self):
        pool = PagePool(4, 2)
        pool.alloc(2)
        with pytest.raises(PoolExhausted):
            pool.alloc(2)
        assert pool.n_free == 1                   # nothing half-allocated

    def test_release_refcounts_and_free_list(self):
        pool = PagePool(5, 2)
        pages = pool.alloc(3)
        pool.refcount[pages[0]] += 1              # simulate one sharer
        freed = pool.release(pages)
        assert freed == 2                         # shared page survives
        assert pool.refcount == {pages[0]: 1}
        assert pool.release([pages[0]]) == 1
        assert pool.n_free == pool.usable and not pool.refcount

    def test_chain_hashes_prefix_property(self):
        pool = PagePool(9, 4)
        a = pool._chain_hashes(np.arange(12, dtype=np.int32))
        b = pool._chain_hashes(np.r_[np.arange(8), 99, 1, 2, 3].astype(np.int32))
        assert a[:2] == b[:2] and a[2] != b[2]    # chain digest covers prefix
        assert len(pool._chain_hashes(np.arange(7, dtype=np.int32))) == 1

    def test_admit_register_share_release_cycle(self):
        pool = PagePool(17, 4)
        prompt = np.arange(13, dtype=np.int32)    # 3 full pages + 1 row
        s0 = _state(0, prompt)
        assert pool.try_admit(s0)
        assert len(s0.pages) == 4 and s0.shared_tokens == 0
        pool.register(s0)
        assert pool.stats()["prefix_index_size"] == 3

        s1 = _state(1, prompt)                    # identical prompt
        assert pool.try_admit(s1)
        assert s1.pages[:3] == s0.pages[:3]       # mapped, not recomputed
        assert s1.shared_tokens == 12
        assert pool.prefix_hits == 1 and pool.prefix_shared_tokens == 12
        assert [pool.refcount[p] for p in s0.pages[:3]] == [2, 2, 2]

        pool.release(s0.pages, rid=0)             # owner leaves first
        assert all(p in pool.refcount for p in s1.pages)
        pool.release(s1.pages, rid=1)
        assert pool.n_free == pool.usable and not pool.refcount
        assert pool.stats()["prefix_index_size"] == 0

    def test_share_capped_to_leave_one_prefill_token(self):
        """A fully-resident prompt still prefills its last page — the
        first token's logits must come from a real prefill."""
        pool = PagePool(17, 4)
        prompt = np.arange(12, dtype=np.int32)    # exactly 3 pages
        s0 = _state(0, prompt)
        pool.try_admit(s0)
        pool.register(s0)
        s1 = _state(1, prompt)
        pool.try_admit(s1)
        assert s1.shared_tokens == 8              # (12-1)//4 = 2 pages

    def test_register_repoints_duplicate_prefix(self):
        """Two requests admitted together prefill the same prefix into
        private pages; the index must survive the first one's release by
        re-pointing at the newer copy (latest-registrant-wins)."""
        pool = PagePool(17, 4)
        prompt = np.arange(13, dtype=np.int32)
        s0, s1 = _state(0, prompt), _state(1, prompt)
        pool.try_admit(s0)
        pool.try_admit(s1)                        # index empty: no sharing
        assert s1.shared_tokens == 0
        pool.register(s0)
        pool.register(s1)                         # re-points to s1's pages
        pool.release(s0.pages, rid=0)
        assert pool.stats()["prefix_index_size"] == 3
        s2 = _state(2, prompt)
        pool.try_admit(s2)
        assert s2.pages[:3] == s1.pages[:3]

    def test_can_admit_is_pure(self):
        pool = PagePool(3, 4, max_rows=64)        # 2 usable pages
        assert pool.can_admit(np.arange(7, dtype=np.int32))
        assert not pool.can_admit(np.arange(12, dtype=np.int32))
        assert pool.n_free == 2 and pool.admission_blocks == 0

    def test_try_admit_blocks_without_allocating(self):
        pool = PagePool(3, 4, max_rows=64)
        s = _state(0, np.arange(12, dtype=np.int32))  # needs 4 pages
        assert not pool.try_admit(s)
        assert s.pages == [] and pool.n_free == 2
        assert pool.admission_blocks == 1

    def test_prefix_sharing_off(self):
        pool = PagePool(17, 4, prefix_sharing=False)
        prompt = np.arange(13, dtype=np.int32)
        s0 = _state(0, prompt)
        pool.try_admit(s0)
        pool.register(s0)
        s1 = _state(1, prompt)
        pool.try_admit(s1)
        assert s1.shared_tokens == 0 and pool.prefix_hits == 0


def _replay(pool_cls, state_cls, req_cls, exhausted, ops, n_pages, page_size, **kw):
    """Run ``ops`` against a fresh pool; return every observable after
    each op: the op's result, each live request's page table, shared
    tokens and hashes, the refcounts, the free list, the prefix index and
    the counters."""
    pool = pool_cls(n_pages, page_size, **kw)
    live, log = {}, []
    for op, rid, *arg in ops:
        if op in ("register", "grow", "release") and rid not in live:
            res = None                 # its admission was refused
        elif op == "admit":
            st = _state(rid, arg[0], cls=state_cls, req=req_cls)
            ok = pool.try_admit(st)
            if ok:
                live[rid] = st
            res = ok
        elif op == "can":
            res = pool.can_admit(np.asarray(arg[0], np.int32))
        elif op == "register":
            res = pool.register(live[rid])
        elif op == "grow":         # a decode step's page growth
            try:
                live[rid].pages += pool.alloc(arg[0], rid=rid)
                res = True
            except exhausted:
                res = False
        else:                      # release
            res = pool.release(live.pop(rid).pages, rid=rid)
        log.append((op, rid, res,
                    {r: (list(s.pages), s.shared_tokens, list(s.page_hashes))
                     for r, s in sorted(live.items())},
                    dict(sorted(pool.refcount.items())), list(pool._free),
                    dict(sorted(pool._hash_to_page.items())),
                    dict(sorted(pool._page_hash.items())), pool.stats()))
    return log


def _admission_ops(seed):
    """A random sequence over prompts that share system-prompt prefixes:
    admissions (some refused for want of pages), registrations, decode
    growth and releases in random order."""
    rng = np.random.default_rng(seed)
    sysps = [rng.integers(0, 50, size=n) for n in (8, 13)]
    ops, live = [], []
    for rid in range(40):
        k = rng.integers(0, 4)
        if k == 0 and live:
            r = live.pop(int(rng.integers(len(live))))
            ops.append(("release", r))
            continue
        if k == 1 and live:
            r = live[int(rng.integers(len(live)))]
            ops.append(("grow", r, int(rng.integers(1, 3))))
            continue
        base = sysps[int(rng.integers(2))] if rng.random() < 0.7 else np.zeros(0, np.int64)
        prompt = np.concatenate([base, rng.integers(0, 50, size=int(rng.integers(1, 11)))])
        ops.append(("can", rid, prompt))
        ops.append(("admit", rid, prompt))
        live.append(rid)
        if rng.random() < 0.8:
            ops.append(("register", rid))
    return ops


@pytest.mark.parametrize("seed,sharing", [(0, True), (1, True), (2, False)])
def test_page_pool_replays_like_the_jax_pool(seed, sharing):
    """One admission/register/share/release sequence through both
    packages' pools: identical page tables, hashes, refcounts, free lists,
    prefix indexes and counters after every step."""
    ops = _admission_ops(seed)
    kw = dict(max_rows=32, prefix_sharing=sharing)
    got = _replay(PagePool, RequestState, Request, PoolExhausted, ops, 12, 4, **kw)
    want = _replay(JPagePool, JRequestState, JRequest, JPoolExhausted, ops, 12, 4,
                   **kw)
    assert got == want
    blocked = got[-1][-1]["admission_blocks"]
    assert blocked > 0 and (got[-1][-1]["prefix_hits"] > 0) == sharing


# ------------------------------------------------------------ page lattice
class TestPageLattice:
    def test_page_buckets(self):
        lat = BucketLattice(4, max_chunk=8, max_pages=16)
        assert lat.page_buckets == (1, 2, 4, 8, 16)
        assert lat.page_bucket(3) == 4 and lat.page_bucket(16) == 16
        with pytest.raises(ValueError):
            lat.page_bucket(17)
        unpaged = BucketLattice(4, max_chunk=8)
        assert unpaged.page_buckets == ()
        with pytest.raises(ValueError):
            unpaged.page_bucket(1)

    def test_tuple_bucket_keys(self):
        t = BucketTable()
        assert t.key("decode", (4, np.int64(8)), None) == ("decode", (4, 8), None)
        assert t.key("prefill", 4, None) == ("prefill", 4, None)


# ----------------------------------------------------- the device half
def test_paged_kv_gather_and_commits_are_exact_copies():
    """A gather of page tables into the slot-stacked layout, a prefill
    commit of a request's own pages and a decode step's row commit each
    move rows exactly, and touch nothing else of the pool."""
    cfg = get_config("minicpm-2b", smoke=True, n_periods=2)
    kv = PagedKV(cfg, 7, 4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _, leaf in tree_leaves_with_path(kv.pool):
        if leaf.dtype.is_floating_point:
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    k = kv.pool["pattern"][0]["k"]                  # (periods, pages, 4, G, D)
    tables = torch.tensor([[3, 1, 0], [5, 6, 2]])
    view = kv._gather(tables, torch.tensor([9, 2], dtype=torch.int32))
    assert view["pattern"][0]["k"].shape == (2, 2, 12) + k.shape[3:]
    assert torch.equal(view["pattern"][0]["k"][:, 1, 4:8], k[:, 6])
    assert view["length"].tolist() == [9, 2]
    assert view["pattern"][0]["length"].shape == (2, 2)

    stage = kv.build_view(3)(torch.tensor([4, 2, 0]), 4)    # batch-1 view
    assert stage["pattern"][0]["length"].tolist() == [4, 4]
    assert torch.equal(stage["pattern"][0]["k"][:, 0, :4], k[:, 4])
    before = k.clone()
    stage["pattern"][0]["k"] = torch.randn(stage["pattern"][0]["k"].shape, generator=gen)
    kv.build_commit(3)(stage, torch.tensor([4, 2]), 1)      # page 4 is shared
    assert torch.equal(k[:, 2], stage["pattern"][0]["k"][:, 0, 4:8])
    untouched = [p for p in range(7) if p != 2]
    assert torch.equal(k[:, untouched], before[:, untouched])

    def step(params, cache, toks):
        new = {**cache, "pattern": [dict(cache["pattern"][0],
                                         k=cache["pattern"][0]["k"] + 1.0)]}
        return toks.float(), new

    before = k.clone()
    kv.build_decode(step, 2, 3)(None, tables, torch.tensor([9, 2], dtype=torch.int32),
                                torch.zeros((2, 1)))
    # row 9 of the first table is row 1 of page 0; row 2 of the second is
    # row 2 of page 5; nothing else moves
    want = before.clone()
    want[:, 0, 1] += 1.0
    want[:, 5, 2] += 1.0
    assert torch.equal(k, want)


# ------------------------------------------------- paged runtime (w/ model)
@pytest.fixture(scope="module")
def served():
    """minicpm-2b smoke at one period: the JAX package's weights, carried
    over."""
    jcfg = jget_config("minicpm-2b", smoke=True).with_(n_periods=1)
    cfg = get_config("minicpm-2b", smoke=True).with_(n_periods=1)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    return cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu"), jcfg, jp


def _requests(cfg, lens, max_new=4, prefix=None, cls=Request):
    out = []
    for i, ln in enumerate(lens):
        rng = np.random.default_rng(1000 + i)
        tail = rng.integers(0, cfg.vocab_size, size=ln).astype(np.int32)
        prompt = tail if prefix is None else np.concatenate([prefix, tail])
        out.append(cls(rid=i, prompt=prompt,
                       max_new_tokens=max_new[i] if isinstance(max_new, list) else max_new))
    return out


def _assert_drained(rt):
    """The page-leak invariant: after serve() drains, every page is back
    on the free list and no refcount survives."""
    assert rt.pool.n_free == rt.pool.usable
    assert not rt.pool.refcount


def test_paged_token_identity_and_leak_invariant(served):
    """Paged gather/commit over page tables (with null-page padding and
    page-count bucketing) is greedy token-identical to the unpaged
    runtime on ragged traffic."""
    cfg, params, *_ = served
    lens = [3, 11, 7, 19, 2, 13]
    ref = _requests(cfg, lens)
    ServingRuntime(cfg, params, slots=2, max_len=64, prefill_chunk=8,
                   precompile=False).serve(ref)

    got = _requests(cfg, lens)
    rt = ServingRuntime(cfg, params, slots=2, max_len=64, prefill_chunk=8,
                        precompile=False, paged=True, page_size=4)
    rt.serve(got)
    for a, b in zip(ref, got):
        assert b.done and b.output == a.output, (a.rid, a.output, b.output)
    _assert_drained(rt)
    # paged bucket keys are lattice tuples; unpaged stay ints
    kinds = {k[0] for k in rt.buckets.keys()}
    assert kinds <= {"decode", "prefill", "page_view", "page_commit"}
    assert all(isinstance(k[1], tuple) for k in rt.buckets.keys()
               if k[0] in ("decode", "prefill"))


def test_paged_runtime_matches_the_jax_paged_runtime(served):
    """The port's paged runtime gives the JAX package's paged runtime's
    greedy tokens on the same weights, with prefix sharing at work."""
    cfg, params, jcfg, jp = served
    sysp = np.random.default_rng(7).integers(0, cfg.vocab_size, size=12).astype(np.int32)
    lens, stagger = [3, 5, 4, 6, 2], [4, 7, 10, 13, 16]
    kw = dict(slots=2, max_len=64, prefill_chunk=8, precompile=False, paged=True,
              page_size=4)
    want = _requests(jcfg, lens, max_new=stagger, prefix=sysp, cls=JRequest)
    jrt = JServingRuntime(jcfg, jp, **kw)
    jrt.serve(want)
    got = _requests(cfg, lens, max_new=stagger, prefix=sysp)
    rt = ServingRuntime(cfg, params, **kw)
    rt.serve(got)
    assert [r.output for r in got] == [r.output for r in want]
    assert rt.pool.stats() == jrt.pool.stats()
    assert rt.pool.prefix_hits > 0


def test_prefix_sharing_differential(served):
    """Shared system prompt: the sharing runtime must emit exactly the
    tokens the non-sharing one does — a shared page is bit-identical to
    what prefill would recompute — while actually sharing."""
    cfg, params, *_ = served
    rng = np.random.default_rng(7)
    sysp = rng.integers(0, cfg.vocab_size, size=12).astype(np.int32)
    lens = [3, 5, 4, 6, 2]
    stagger = [4, 7, 10, 13, 16]      # lifetimes overlap → sharing chains

    ref = _requests(cfg, lens, max_new=stagger, prefix=sysp)
    unshared = ServingRuntime(cfg, params, slots=2, max_len=64,
                              prefill_chunk=8, precompile=False,
                              paged=True, page_size=4, prefix_sharing=False)
    unshared.serve(ref)
    assert unshared.pool.prefix_hits == 0
    _assert_drained(unshared)

    got = _requests(cfg, lens, max_new=stagger, prefix=sysp)
    rt = ServingRuntime(cfg, params, slots=2, max_len=64, prefill_chunk=8,
                        precompile=False, paged=True, page_size=4)
    rt.serve(got)
    for a, b in zip(ref, got):
        assert b.done and b.output == a.output, (a.rid, a.output, b.output)
    assert rt.pool.prefix_hits > 0
    assert rt.metrics.prefix_shared_tokens > 0
    _assert_drained(rt)


def test_pool_exhaustion_preempts_and_drains(served):
    """A pool too small for the offered load: admission blocks, decode
    growth preempts (youngest evicted, marked not dropped), and the pool
    still drains clean."""
    cfg, params, *_ = served
    rt = ServingRuntime(cfg, params, slots=4, max_len=64, prefill_chunk=8,
                        precompile=False, paged=True, page_size=4, pages=9)
    reqs = _requests(cfg, [14, 15, 13, 14], max_new=12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rt.serve(reqs, max_steps=200)
    assert all(r.status in ("done", "evicted") for r in reqs)
    assert any(r.status == "done" for r in reqs)
    assert rt.pool.admission_blocks > 0 or rt.metrics.evictions > 0
    _assert_drained(rt)


def test_cancel_while_queued(served):
    """A rid still in the queue (no slot, no pages) is cancellable."""
    cfg, params, *_ = served
    rt = ServingRuntime(cfg, params, slots=1, max_len=64, prefill_chunk=8,
                        precompile=False, paged=True, page_size=4)
    a, b = _requests(cfg, [5, 7])
    rt.submit(a)
    rt.submit(b)                      # b queued behind a's slot
    req = rt.evict(b.rid)
    assert req is b
    assert b.status == "evicted" and not b.done
    assert rt.metrics.evictions == 1
    rt.serve([])                      # drain a
    assert a.done
    _assert_drained(rt)
    with pytest.raises(KeyError, match="neither active nor queued"):
        rt.scheduler.evict(99)


def test_evict_while_prefilling_releases_pages(served):
    """Evicting mid-prefill (slot bound, pages held, prompt not yet
    committed) releases the slot and every page."""
    cfg, params, *_ = served
    rt = ServingRuntime(cfg, params, slots=1, max_len=64, prefill_chunk=4,
                        precompile=False, paged=True, page_size=4)
    (a,) = _requests(cfg, [19])       # several chunks of prefill
    rt.submit(a)
    rt.tick()                         # admit + first chunk only
    assert a.status == "prefill" and rt.pool.n_free < rt.pool.usable
    rt.evict(a.rid)
    assert a.status == "evicted" and not a.done
    _assert_drained(rt)
    assert not rt.scheduler.has_work()


def test_serve_rejects_offender_and_serves_rest(served):
    """An over-long prompt mid-list must not abandon the half-submitted
    batch — it is marked rejected and the rest are served to completion."""
    cfg, params, *_ = served
    rt = ServingRuntime(cfg, params, slots=2, max_len=16, prefill_chunk=8,
                        precompile=False)
    good1, good2 = _requests(cfg, [5, 6], max_new=3)
    bad = Request(rid=99, prompt=np.zeros(17, np.int32), max_new_tokens=3)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rt.serve([good1, bad, good2])
    assert bad.status == "rejected" and not bad.done and bad.output == []
    assert good1.done and good2.done
    assert rt.metrics.rejections == 1
    assert rt.metrics.snapshot()["rejections"] == 1
    assert any("rejected" in str(x.message) for x in w)
    # direct submit of an unservable request still raises
    with pytest.raises(ValueError, match="exceeds max_len"):
        rt.submit(Request(rid=100, prompt=np.zeros(17, np.int32)))


def test_paged_rejects_prompt_too_big_for_pool(served):
    cfg, params, *_ = served
    rt = ServingRuntime(cfg, params, slots=2, max_len=64, prefill_chunk=8,
                        precompile=False, paged=True, page_size=4, pages=5)
    with pytest.raises(ValueError, match="pool holds"):
        rt.submit(Request(rid=0, prompt=np.zeros(30, np.int32)))


def test_precompile_buckets_pins_compile_set(served):
    """After precompile_buckets(), a served trace creates no new bucket
    entries — the steady state builds nothing, whatever the warm-up."""
    cfg, params, *_ = served
    rt = ServingRuntime(cfg, params, slots=2, max_len=32, prefill_chunk=8,
                        precompile=False, paged=True, page_size=4)
    n = rt.precompile_buckets()
    assert n == rt.buckets.compiles > 0
    reqs = _requests(cfg, [3, 9, 14], max_new=4)
    rt.serve(reqs)
    assert all(r.done for r in reqs)
    assert rt.buckets.compiles == n
    _assert_drained(rt)


def test_paged_guardrails(served):
    cfg, params, *_ = served
    with pytest.raises(NotImplementedError, match="sharded"):
        ServingRuntime(cfg, params, slots=2, max_len=32, paged=True,
                       precompile=False, mesh=object())
    with pytest.raises(ValueError, match="cannot be paged"):
        ServingRuntime(get_config("jamba-v0.1-52b", smoke=True, n_periods=1), params,
                       slots=1, max_len=16, paged=True, precompile=False)


def test_paged_registry_and_working_set(served):
    """The paged runtime registers its ``pages`` source, and its warm-up
    runs decode at every page-lattice width."""
    from repro_torch.obs.registry import MetricsRegistry

    cfg, params, *_ = served
    rt = ServingRuntime(cfg, params, slots=2, max_len=16, prefill_chunk=8,
                        paged=True, page_size=4)
    snap = rt.register_metrics(MetricsRegistry()).snapshot()
    assert snap["pages"]["pages_total"] == rt.pool.usable == 2 * 4
    rec = rt.contraction_working_set()
    widths = {dims["t"] for spec, dims, _ in rec if spec == "bsgrd,btgd->bgrst"}
    assert widths >= {4 * P for P in rt.lattice.page_buckets}


def test_serve_cli_paged_on_the_cpu():
    """``--paged`` serves through the page pool and prints its counters."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "minicpm-2b",
         "--smoke", "--device", "cpu", "--requests", "3", "--max-new", "4", "--paged",
         "--page-size", "8", "--no-prefix-share"],
        env=env, capture_output=True, text=True, timeout=300, stdin=subprocess.DEVNULL)
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests, 12 tokens" in proc.stdout
    assert "prefix sharing off" in proc.stdout and "pages: page_size=8" in proc.stdout


# ------------------------------------------------------------------ card
@pytest.mark.gpu
def test_paged_runtime_on_the_card():
    """On the card, with the kernel backend: the paged runtime gives the
    unpaged runtime's tokens and the CPU paged run's, drains its pool, and
    launches ``native_gemm``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.sb_gemm import native_gemm

    cfg = get_config("minicpm-2b", smoke=True, n_periods=1, contract_backend="kernel")
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    on_card = tree_map(lambda t: t.cuda(), params)
    sysp = np.random.default_rng(7).integers(0, cfg.vocab_size, size=12).astype(np.int32)
    kw = dict(slots=2, max_len=64, prefill_chunk=8, paged=True, page_size=4)
    before = native_gemm.launches
    runs = {}
    for name, p, extra in (("card", on_card, {}), ("card unpaged", on_card, {"paged": False}),
                           ("cpu", params, {})):
        rt = ServingRuntime(cfg, p, **{**kw, **extra})
        reqs = rt.serve(_requests(cfg, [3, 5, 4, 6, 2], max_new=[4, 7, 10, 13, 16],
                                  prefix=sysp))
        assert all(r.done for r in reqs)
        if rt.pool is not None:
            _assert_drained(rt)
        runs[name] = [r.output for r in reqs]
    assert runs["card"] == runs["card unpaged"] == runs["cpu"]
    assert native_gemm.launches > before
