"""Serving qwen2-moe-a2.7b with the port: the launches, plans and peaks of
its passes at published width and depth, its served rows held against the
JAX package, and the MoE dispatch group of a request that shares a batch.

- At published width the passes ``chip_smoke.py`` phase 28 serves (chunks
  of 512 and 1, whole prompts, 4-slot and 1-slot decodes, paged views)
  are traced on fake tensors under ``utils.CostCounter`` at 1 and 2 layers
  and scaled to 24 by the layer's difference: 505 ``native_gemm`` calls a
  pass, 385 on ``wgmma`` (Q, K, V, O and the 4 shared experts' 3 SwiGLU
  products a layer, the untied head) and 120 on ``batched`` (the scores,
  P·V and the 3 expert products a layer), as ``chip_smoke.ssm_routes``
  derives them once it counts shared experts.
- At 24 layers: 57.26 GB of f32 masters, and every stage of the phase
  traced under 75 GB (1e9).  A 6000-token prompt (6016 cache rows) would
  put the paged decode pass at 76.19 GB, so the longest prompt is 4097
  (4112 rows with 8 new tokens); a float32 oracle on 4 slots would take
  76.67 GB there, so it runs on 3.
- ``native_plan`` on fake tensors laid out as ``moe_ffn`` lays them: the 60
  experts a grid mode of ``batched`` that X and W walk at a stride (the
  paper's strided batch, no copy); in a 4-slot decode pass the slots a
  grid mode of the up-projections whose W stride is 0 (each slot re-reads
  the weights: ``expert_in`` is slot-major).
- The float32 smoke qwen2-moe (4 experts top-2, 2 shared experts, 2
  periods) with the JAX package's weights carried across: the port
  runtime's tokens equal the JAX runtime's, chunked (chunks of up to 8)
  and whole-prompt, unpaged and paged, on both backends, in traffic whose
  capacity drops tokens; the whole-prompt runtime's prefills within 1e-4
  of the JAX ``forward``; the chunked prefill of a prompt whose chunks
  drop other tokens than its whole prompt gives other logits than
  ``forward`` in both packages alike (the reference's semantics).
- ``moe_ffn``'s ``group`` is a request's tokens: on a 2-row slot-stacked
  cache ``transformer.prefill`` routes each row in groups as the JAX
  package routes that row alone (``GROUP_SIZE`` patched small in both).
- ``chip_smoke.qwen2_moe_serve_path`` (phase 28) runs through on the CPU
  at narrow widths in bf16, its card-only calls stubbed.

JAX is imported only inside the parity tests."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_rehearsal
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe, transformer
from repro_torch.runtime.buckets import chunk_schedule, pow2_buckets
from repro_torch.runtime.engine import ServingRuntime, slot_cache
from repro_torch.runtime.scheduler import Request

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ARCH = "qwen2-moe-a2.7b"
#: float32 on both sides: the packages differ by summation order only
TOL = 1e-4
PROMPTS = (3, 8, 9, 17, 30)
NEW = 12
SLOTS = 4
#: chunks of up to 8 tokens: a group of 8 has capacity 6 an expert for its
#: 16 assignments, so chunks drop tokens too (a chunk of 4 never can)
CHUNK = 8
PAGE = 4
MAX_LEN = max(PROMPTS) + NEW
#: phase 28's cache width (4097 + 8 rounded up to 16) and the 6000-token
#: prompt's it replaced
ROWS, ROWS_6000 = 4112, 6016
#: the passes of a pass-count check: 385 wgmma and 120 batched at 24 layers
PER_PASS = {"wgmma": 385, "batched": 120}
UP, DOWN = "xgce,xef->xgcf", "xgcf,xfe->xgce"


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    import sys

    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------ launches and peaks at width
def wide(periods: int = 24, **kw):
    return get_config(ARCH, n_periods=periods, contract_backend="kernel",
                      contract_strategy="native").with_(**kw)


def traced(kind: str, n: int, periods: int = 24, rows: int = ROWS, held: int = 0,
           dtype: str | None = None):
    """``CostCounter.costs()`` of one pass at published width on fake
    tensors, ``periods`` layers deep, the masters held as arguments: a
    prefill of ``n`` tokens on a batch-1 cache of ``rows`` rows
    (``"prefill"``), a decode pass of ``n`` slots over a slot cache of
    ``rows`` rows (``"decode"``), a paged decode pass of ``n`` slots over
    views of ``rows`` rows gathered from the default pool (``"paged"``:
    the pool, the views and the pass), or ``forward`` over ``n`` tokens.
    With ``held`` a slot cache of that many rows of ``rows`` is held as
    the runtime holds its own, and the pass's own caches are made under
    the counter.  ``dtype="float32"`` traces the float32 oracle (the torch
    backend)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.runtime.pages import PagedKV
    from repro_torch.utils import CostCounter

    cfg = wide(periods)
    if dtype is not None:
        cfg = cfg.with_(dtype=dtype, contract_backend="torch", contract_strategy="auto")
    with FakeTensorMode(), torch.no_grad():
        params = transformer.init_params(None, cfg, device="cpu")
        toks = torch.zeros((n, 1) if kind in ("decode", "paged") else (1, n), dtype=torch.long)
        with CostCounter() as cc:
            cc.hold(params)
            kept = slot_cache(cfg, held, rows, device="cpu") if held else None
            cc.hold(kept)
            if kind == "forward":
                transformer.forward(cfg, params, {"tokens": toks})
            elif kind == "decode":
                transformer.decode_step(cfg, params, slot_cache(cfg, n, rows, device="cpu"), toks)
            elif kind == "paged":
                P = rows // 16
                kv = PagedKV(cfg, SLOTS * P + 1, 16, device="cpu")
                step = kv.build_decode(
                    lambda p, c, t: transformer.decode_step(cfg, p, c, t), n, P)
                step(params, torch.arange(n * P).reshape(n, P) + 1,
                     torch.full((n,), rows - 1, dtype=torch.int32), toks)
            else:
                transformer.prefill(cfg, params, {"tokens": toks},
                                    transformer.init_cache(cfg, 1, rows, device="cpu"))
    return cc.costs()


#: (kind, tokens or slots, cache rows) of the phase's passes: chunks of 512
#: and 1, the 4097 and 4096 prompts whole (the whole-prompt runtime), decode
#: buckets 4 and 1, a 4-slot paged decode over 257 pages
PASSES = [("prefill", 512, ROWS), ("prefill", 1, ROWS), ("prefill", 4097, ROWS),
          ("prefill", 4096, ROWS), ("decode", 4, ROWS), ("decode", 1, ROWS),
          ("paged", 4, 257 * 16)]


@pytest.mark.parametrize("kind,n,rows", PASSES, ids=lambda v: str(v))
def test_every_pass_launches_505_by_route_at_published_width(kind, n, rows):
    """At 1 and 2 layers each pass launches what ``ssm_routes`` derives
    for that depth (17 ``wgmma`` and 5 ``batched`` a layer, the head once);
    scaled to 24 layers by the second layer's difference, 505: 385
    ``wgmma`` and 120 ``batched``, ``ssm_routes``' count at 24.  The
    router and the dispatch and combine einsums launch no ``native_gemm``
    (they are ``aten.bmm`` on the library)."""
    cs = chip_rehearsal.chip_smoke()
    got = {}
    for periods in (1, 2):
        c = traced(kind, n, periods, rows)
        got[periods] = c["routes"]["repro_torch.native_gemm"]
        assert got[periods] == cs.ssm_routes(wide(periods))
        assert c["ops"]["repro_torch.native_gemm"] == sum(got[periods].values())
    scaled = {r: got[1][r] + 23 * (got[2][r] - got[1][r]) for r in got[1]}
    assert scaled == cs.ssm_routes(wide()) == PER_PASS


def test_the_shared_experts_are_counted():
    """``ssm_routes`` counts each shared expert's 3 SwiGLU products on
    ``wgmma``: without them qwen2-moe would come to 217 a pass; jamba's
    MoE has none, so its counts stay 31 and 21 a decode pass."""
    cs = chip_rehearsal.chip_smoke()
    cfg = wide()
    assert cs.ssm_routes(cfg.with_(moe=dataclasses.replace(cfg.moe, n_shared=0))) == {
        "wgmma": 97, "batched": 120}
    jamba = get_config("jamba-v0.1-52b", n_periods=1)
    assert cs.ssm_routes(jamba) == {"wgmma": 31, "batched": 21}


#: (stage, trace arguments, traced GB at most): the runtime's 512 chunk
#: beside its cache, its 4-slot decode, the paged decode, the whole-prompt
#: runtime's (and ServeEngine's) 4097 prefill beside its cache, forward at
#: 4097, the float32 oracle's chunk beside its 3-slot cache and its decode
STAGES = [
    ("chunk", ("prefill", 512), dict(held=4), 63.0),
    ("decode", ("decode", 4), dict(), 67.0),
    ("paged decode", ("paged", 4), dict(), 70.3),
    ("whole prompt", ("prefill", 4097), dict(held=4), 65.0),
    ("forward", ("forward", 4097), dict(), 61.1),
    ("float32 chunk", ("prefill", 512), dict(held=3, dtype="float32"), 67.0),
    ("float32 decode", ("decode", 3), dict(dtype="float32"), 71.9),
]


@pytest.mark.parametrize("stage,args,kw,gb", STAGES, ids=[s[0] for s in STAGES])
def test_every_stage_fits_under_75_gb_at_24_layers(stage, args, kw, gb):
    """The f32 masters 57.26 GB (14.316B params); each stage of phase 28 at
    4112 cache rows traced under 75 GB with them.  A decode pass holds its
    slot cache, each layer's rewrite of it (out of place) and their stack
    over the layers: three caches of 3.23 GB (bf16, 4 slots)."""
    got = traced(*args, **kw)
    assert round(got["argument_bytes"] / 1e9, 2) == 57.26
    assert got["peak_bytes"] / 1e9 < gb < 75


def test_the_6000_token_prompt_and_a_4_slot_oracle_would_not_fit():
    """Why the phase's longest prompt is 4097 and its oracle takes 3 slots:
    at 6016 rows the paged decode pass traces to 76.19 GB, and at 4112 a
    4-slot float32 decode pass with its cache to 76.67 GB."""
    paged = traced("paged", 4, rows=ROWS_6000)["peak_bytes"] / 1e9
    assert 76.1 < paged < 76.3
    f32 = traced("decode", 4, dtype="float32")["peak_bytes"] / 1e9
    assert 76.6 < f32 < 76.7


def test_the_phases_prompts_and_their_dispatch_groups():
    """511, 512, 513 on the chunk edge; 4096 one dispatch group of
    ``GROUP_SIZE`` (capacity 342) and 4097 17 groups of 241 (capacity 21)
    whole, a chunk of 512 one group of capacity 43; 36 chunks in all, of
    which only 64 and 512 are one chunk; a cache of 4112 rows."""
    cs = chip_rehearsal.chip_smoke()
    spec, cfg = cs.QWEN2_MOE_SERVE, wide()
    assert {511, 512, 513, 4096, 4097} <= set(spec["prompts"])
    assert -(-(max(spec["prompts"]) + spec["max_new"]) // 16) * 16 == ROWS
    chunks = pow2_buckets(spec["chunk"])
    schedules = {n: chunk_schedule(n, chunks) for n in spec["prompts"]}
    assert sum(map(len, schedules.values())) == 36
    assert [n for n, s in schedules.items() if len(s) == 1] == [64, 512]
    m = cfg.moe

    def groups(T):
        g = min(moe.GROUP_SIZE, T)
        while T % g:
            g -= 1
        return T // g, g, max(int(m.capacity_factor * m.top_k * g / m.n_experts) + 1, 4)

    assert groups(4096) == (1, 4096, 342) and groups(4097) == (17, 241, 21)
    assert groups(512) == (1, 512, 43) and groups(1) == (1, 1, 4)
    assert round(4 * cfg.param_count() / 1e9, 2) == 57.26
    assert round(cfg.param_count(active_only=True) / 1e9, 3) == 2.689


# --------------------------------------------------------------- plans
def expert_plans(tokens: int, group: int | None) -> dict:
    """``native_plan`` of one qwen2-moe layer's expert products at
    published width, recorded from ``moe_ffn`` on fake tensors (so
    ``expert_in`` has the layout its dispatch einsum gives): a chunk of
    ``tokens`` (``group`` None) or a decode pass of ``tokens`` slots
    (``group`` 1, a request's one token)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.tree import tree_map

    cs = chip_rehearsal.chip_smoke()
    cfg = wide(1)
    with FakeTensorMode(), torch.no_grad():
        layer = tree_map(lambda t: t[0], transformer.init_params(None, cfg, device="cpu")[
            "pattern"][0])
        x = torch.zeros((1, tokens, cfg.d_model) if group is None else (tokens, 1, cfg.d_model),
                        dtype=torch.bfloat16)
        with cs.recording_plans() as plans:
            moe.moe_ffn(cfg, layer["moe"], x, group=group)
    return {s: plans[s] for s in (UP, DOWN)}


def test_a_chunk_walks_the_60_experts_as_a_strided_batch_mode():
    """A 512-token chunk: all three expert products on ``batched``, the 60
    experts their one grid mode, walked by X and W at a constant stride
    (no copy), the 43 capacity rows the tile's rows: 660 and 960 tiles."""
    cs = chip_rehearsal.chip_smoke()
    plans = expert_plans(512, None)
    assert len(plans[UP]) == 2 and len(plans[DOWN]) == 1
    for s, tiles in ((UP, 660), (DOWN, 960)):
        route, plan, shapes = plans[s][0]
        assert route == "batched" and plan["M"] == 43 and plan["tiles"] == tiles
        mode = cs.expert_mode(plan, 60)
        assert mode is not None and plan["grid"] == [mode] and plan["n_split"] == 1


def test_a_decode_pass_rereads_the_up_weights_per_slot():
    """A 4-slot decode pass: ``expert_in`` comes out slot-major, so in the
    up-projections the slot ``g`` does not fuse with the capacity row
    ``c``: the slots are a grid mode of W stride 0 beside the experts' (each
    slot re-reads the 60 experts' 346 MB of bf16 weights), 2640 tiles; the
    down-projection's X comes out expert-major and fuses them (16 rows)."""
    cs = chip_rehearsal.chip_smoke()
    plans = expert_plans(4, 1)
    route, up, _ = plans[UP][0]
    assert route == "batched" and up["M"] == 4 and up["tiles"] == 2640
    assert cs.expert_mode(up, 60) is not None
    assert cs.broadcast_mode(up, 4) is not None
    route, down, _ = plans[DOWN][0]
    assert route == "batched" and down["M"] == 16 and down["grid"] == [cs.expert_mode(down, 60)]
    assert cs.broadcast_mode(down, 4) is None


# ------------------------------ parity on the smoke config (float32)
def smoke(get, **kw):
    """qwen2-moe's smoke config: float32, d_model 64, 4 heads of 16 (MHA),
    4 routed experts of 32 top-2 and 2 shared experts, 2 periods."""
    return get(ARCH, smoke=True, **kw)


@functools.cache
def carried():
    """The JAX params and the same weights in the port."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtransformer

    jcfg = smoke(jget_config)
    assert (jcfg.moe.n_experts, jcfg.moe.top_k, jcfg.moe.n_shared) == (4, 2, 2)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(smoke(get_config), jax.tree.map(np.asarray, jp), "cpu")


@functools.cache
def prompts():
    rng = np.random.default_rng(36)
    vocab = smoke(get_config).vocab_size
    return tuple(rng.integers(0, vocab, n).astype(np.int32) for n in PROMPTS)


def requests(cls):
    return [cls(rid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts())]


def runtime_kw(paged: bool, chunked: bool) -> dict:
    kw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK, precompile=False,
              chunked_prefill=chunked)
    return kw | (dict(paged=True, page_size=PAGE) if paged else {})


@functools.cache
def jax_served(paged: bool, chunked: bool):
    from repro.configs import get_config as jget_config
    from repro.runtime.engine import ServingRuntime as JServingRuntime
    from repro.runtime.scheduler import Request as JRequest

    jp, _ = carried()
    rt = JServingRuntime(smoke(jget_config), jp, **runtime_kw(paged, chunked))
    return [r.output for r in rt.serve(requests(JRequest))]


@functools.cache
def port_served(backend: str, paged: bool, chunked: bool):
    """The port runtime's tokens, logits by ``(request, tokens generated
    before)`` and the tokens GShard dropped in its prefills."""
    cs = chip_rehearsal.chip_smoke()
    _, tp = carried()
    rt = ServingRuntime(smoke(get_config, contract_backend=backend), tp,
                        **runtime_kw(paged, chunked))
    logits, drops = {}, []
    reqs = requests(Request)
    with cs.served_events(rt, logits, [], drops=drops):
        rt.serve(reqs)
    assert all(r.done for r in reqs)
    if paged:
        assert rt.pool.n_free == rt.pool.usable and not rt.pool.refcount
    lost = sum(n for kind, *_, seen in drops if kind == "prefill" for _, _, n, _ in seen)
    return [r.output for r in reqs], logits, lost


BACKENDS = ["torch", "kernel"]
MODES = [(False, True), (True, True), (False, False), (True, False)]
MODE_IDS = ["unpaged-chunked", "paged-chunked", "unpaged-whole", "paged-whole"]


@pytest.mark.parametrize("paged,chunked", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_runtime_tokens_equal_the_jax_runtimes(backend, paged, chunked):
    """Chunked prefill in chunks of up to 8 or whole prompts, unpaged or
    off 4-row pages: the JAX runtime's greedy tokens, in traffic where
    GShard's capacity drops tokens in the prefills."""
    got, _, lost = port_served(backend, paged, chunked)
    assert got == jax_served(paged, chunked)
    assert all(len(o) == NEW for o in got)
    assert lost > 0


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_whole_prompt_prefill_matches_jax_forward_last_position(backend, paged):
    """The whole-prompt runtime routes a prompt as ``forward`` does: its
    served prefill logits within 1e-4 of the JAX ``forward``'s last
    position at every prompt."""
    _, logits, _ = port_served(backend, paged, False)
    for i, n in enumerate(PROMPTS):
        assert rel_err(logits[(i, 0)], jax_forward_last(i)) <= TOL, n


@functools.cache
def jax_forward_last(i: int):
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtransformer

    jp, _ = carried()
    logits, _ = jtransformer.forward(smoke(jget_config), jp,
                                     {"tokens": jnp.asarray(prompts()[i][None])})
    return np.asarray(logits)[0, -1]


@functools.cache
def jax_chunked_last(i: int):
    """The JAX package's prefill of prompt ``i`` in the runtime's chunks
    (``chunk_schedule``'s, each a ``prefill`` call on a batch-1 cache): its
    last logits."""
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtransformer

    jp, _ = carried()
    jcfg = smoke(jget_config)
    cache, at, prompt = jtransformer.init_cache(jcfg, 1, MAX_LEN), 0, prompts()[i]
    for c in chunk_schedule(len(prompt), pow2_buckets(CHUNK)):
        logits, cache = jtransformer.prefill(jcfg, jp, {"tokens": jnp.asarray(
            prompt[None, at:at + c])}, cache)
        at += c
    return np.asarray(logits)[0]


@pytest.mark.parametrize("backend", BACKENDS)
def test_chunks_that_drop_other_tokens_give_other_logits_in_both_packages(backend):
    """The reference's semantics: a chunk routes as dispatch groups of its
    own, so where its capacity drops other tokens than the whole prompt's
    the chunked prefill leaves ``forward``.  The 30-token prompt: the
    JAX package's chunked prefill is farther than 1e-3 from its
    ``forward``, the port's chunked runtime within 1e-4 of the JAX chunked
    prefill and as far from ``forward``, and the port's two serves drop
    different numbers of tokens in its prefill."""
    cs = chip_rehearsal.chip_smoke()
    i = PROMPTS.index(30)
    gap = rel_err(jax_chunked_last(i), jax_forward_last(i))
    assert gap > 1e-3
    _, chunked, _ = port_served(backend, False, True)
    assert rel_err(chunked[(i, 0)], jax_chunked_last(i)) <= TOL
    assert abs(rel_err(chunked[(i, 0)], jax_forward_last(i)) - gap) <= TOL
    _, tp = carried()
    cfg = smoke(get_config, contract_backend=backend)
    lost = {}
    for chunked_ in (True, False):
        rt = ServingRuntime(cfg, tp, **runtime_kw(False, chunked_))
        drops = []
        req = Request(rid=0, prompt=prompts()[i], max_new_tokens=1)
        with cs.served_events(rt, {}, [], drops=drops):
            rt.serve([req])
        lost[chunked_] = sum(n for kind, *_, seen in drops if kind == "prefill"
                             for _, _, n, _ in seen)
    assert lost[True] != lost[False]


def test_the_forward_check_holds_the_prompts_that_route_alike():
    """``chip_smoke.prefill_vs_forward`` with the served prefills' routing
    (phase 28's (c)): a prompt whose served routing is forward's in every
    MoE layer is held to 2e-2; one token routed otherwise in layer 1 (a
    near-tie flipped by other bf16 bits) leaves its prompt logged, not
    held; every token of layer 0 routed otherwise (a fault of positions,
    masks or cache) fails the check, as does no prompt routing alike."""
    cs = chip_rehearsal.chip_smoke()
    _, tp = carried()
    cfg = smoke(get_config)
    reqs = requests(Request)
    seen, routing = {}, {}
    with torch.no_grad():
        for r in reqs:
            with cs.dropped_tokens() as d:
                logits, _ = transformer.forward(cfg, tp, {"tokens": torch.from_numpy(
                    r.prompt[None].astype(np.int64))})
            seen[(r.rid, 0)] = logits[0, -1]
            routing[r.rid] = [x[3] for x in d]

    def run(routes):
        return cs.prefill_vs_forward("moe", cfg, tp, reqs, seen, "cpu", beside=seen,
                                     routing=routes)

    errs, _, routed = run(routing)
    assert routed["alike"] == list(PROMPTS) and max(errs.values()) == 0.0

    def other(x, rows=slice(None)):
        # the tokens ``rows`` of a routing choose the next expert first
        x = x.clone()
        e = x[0, rows, 0]
        x[0, rows, 0] = torch.where(e < 0, -1 - (-1 - e + 1) % 4, (e + 1) % 4)
        return x

    flipped = routing | {4: [routing[4][0], other(routing[4][1], 7)]}
    _, _, routed = run(flipped)
    assert routed["diverged"] == {30: dict(layer=1, tokens=1, err=0.0)}
    assert routed["alike"] == [3, 8, 9, 17]
    with pytest.raises(AssertionError, match="over 5%"):
        run(routing | {4: [other(routing[4][0]), routing[4][1]]})
    with pytest.raises(AssertionError, match=r"routed alike: \[\]"):
        run({rid: [r[0], other(r[1], 0)] for rid, r in routing.items()})


# ------------------------------------------------ the group of a request
@pytest.mark.parametrize("S", [12, 30])
def test_a_slot_stacked_prefill_groups_each_row_as_the_jax_package(S, monkeypatch):
    """``GROUP_SIZE`` 8 in both packages: ``transformer.prefill`` of two
    rows of ``S`` tokens on a slot-stacked cache (a ``(B,)`` length) gives
    each row within 1e-4 of the JAX ``prefill`` of that row alone, which
    routes it in groups of ``min(8, S)`` lowered until they divide ``S``
    (6 at 12, 6 at 30).  Taking the row's ``S`` as the group, uncapped,
    gave 0.095 and 0.895 at 12 tokens, 0.248 and 0.039 at 30."""
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import moe as jmoe
    from repro.models import transformer as jtransformer

    monkeypatch.setattr(jmoe, "GROUP_SIZE", 8)
    monkeypatch.setattr(moe, "GROUP_SIZE", 8)
    jp, tp = carried()
    rng = np.random.default_rng(S)
    toks = rng.integers(0, smoke(get_config).vocab_size, (2, S)).astype(np.int32)
    cfg = smoke(get_config)
    with torch.no_grad():
        got, _ = transformer.prefill(cfg, tp, {"tokens": torch.from_numpy(toks).long()},
                                     slot_cache(cfg, 2, 64, device="cpu"))
    jcfg = smoke(jget_config)
    for b in range(2):
        want, _ = jtransformer.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[b:b + 1])},
                                       jtransformer.init_cache(jcfg, 1, 64))
        assert rel_err(got[b], np.asarray(want)[0]) <= TOL, b


# ------------------------------------------------- phase 28 on the CPU
def test_phase_28_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.qwen2_moe_serve_path`` with qwen2-moe's widths shrunk
    (d_model 256, 4 heads of 64, 8 routed experts of 128 top-4, 4 shared
    experts of 128, vocab 1024), 2 periods, ``GROUP_SIZE`` 64, prompts of
    8-128 tokens in chunks of up to 32 (8 and 32 one chunk), 8 new tokens
    each, card-only calls stubbed: every check passes; every pass
    launches 43 (33 ``wgmma``, 10 ``batched``), the whole-prompt serve's
    too; the plans put the 8 experts on a strided grid mode and a decode
    pass's slots on a W-stride-0 one; drops are logged by layer and no
    decode pass drops."""
    import repro_torch.configs as configs

    cs = chip_rehearsal.chip_smoke()
    real_get = configs.get_config

    def shrunk(arch, **kw):
        cfg = real_get(arch, **kw)
        return cfg.with_(d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=128,
                         vocab_size=1024, n_periods=2, moe=dataclasses.replace(
                             cfg.moe, n_experts=8, d_expert=128, d_shared=128))

    monkeypatch.setattr(configs, "get_config", shrunk)
    monkeypatch.setattr(moe, "GROUP_SIZE", 64)
    monkeypatch.setattr(cs, "QWEN2_MOE_SERVE", dict(
        cs.QWEN2_MOE_SERVE, prompts=(8, 31, 32, 33, 64, 65, 100, 128), max_new=8, chunk=32))
    counters, profiled = chip_rehearsal.card_stubbed(monkeypatch, cs)
    rec = cs.qwen2_moe_serve_path(torch.device("cpu"), 0, counters)
    assert rec["launches_per_pass"] == {"wgmma": 33, "batched": 10}
    assert rec["launches"] == 43 * (rec["prefill_chunks"] + rec["decode_passes"])
    assert rec["paged_launches"] == rec["launches"]
    plans = rec["experts"]["plans"]
    for key in (f"chunk {UP}", f"chunk {DOWN}", f"decode {UP}", f"decode {DOWN}"):
        assert plans[key]["route"] == "batched" and cs.expert_mode(plans[key], 8), key
    assert cs.broadcast_mode(plans[f"decode {UP}"], 4) is not None
    assert rec["experts"]["moe_err"]["same_input"] <= 2e-2
    assert rec["experts"]["reread_bytes"]["per_pass"] > 0
    dropped = rec["dropped"]
    assert set(dropped) == {"chunk", "chunk decode", "whole", "whole decode"}
    assert not any(map(any, dropped["chunk decode"] + dropped["whole decode"]))
    assert len(dropped["whole"]) == 8 and all(len(p) == 1 for p in dropped["whole"].values())
    assert set(rec["chunked_prefill_logits_err"]) == set(rec["prefill_logits_err"])
    assert rec["weight_cast"]["bytes"] > 0 and len(profiled) == 2
