"""Serving gemma2-27b with the port: the launches and peaks of its passes
at published width, and its served rows held against the JAX package.

- At published width, 8 periods of a local (window 4096) and a global
  layer (twice the depth ``chip_smoke.py`` serves), prefill chunks against the
  8208-row cache, decode passes over it and the paged views' widths are
  traced on fake tensors under ``utils.CostCounter``: every pass makes 145
  ``native_gemm`` calls (113 ``wgmma``, 32 ``batched``), as
  ``chip_smoke.ssm_routes`` derives them, over 40.96 GB of masters; beside
  its cache a 512-token chunk peaks under 44.5 GB and a 4-slot decode pass
  under 49.6.
  At the phase's longest prompt, 8192 tokens, ``transformer.forward`` and
  the legacy engine's whole-prompt prefill beside its 4-slot cache each
  peak under 75 GB, so the phase runs both at every prompt.
- On a narrow float32 config with the published ratios (4 query heads
  over 2 KV heads, both softcaps, the tied head, a window of 8 on the
  local layer, 2 periods) and the JAX package's weights carried across,
  prompts of 3, 8, 9, 17 and 30 tokens, 12 new tokens each, chunks of up
  to 4 on both sides: the port's ``ServingRuntime`` gives the JAX
  runtime's tokens, unpaged and paged (4-row pages, under the window), on
  the ``torch`` and ``kernel`` backends; each served prefill's logits are
  within 1e-4 of the largest magnitude of the JAX ``forward``'s last
  position; the 9-token prompt, whose last chunk starts on the window's
  edge (its query 8 is the first to drop key 0), gives the whole-prompt
  prefill's logits and cache; the same weights with ``window=None`` give
  other logits.
- A runtime fed its own served tokens (``chip_smoke.served_events``'s
  ``forced``, the float32 oracle's feed) repeats its rows, also where a
  request finishes while another decodes in a slot the finished one's
  token must not reach.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import LayerSpec as JLayerSpec
from repro.models import transformer as jtransformer
from repro.runtime.engine import ServingRuntime as JServingRuntime
from repro.runtime.scheduler import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.configs.base import LayerSpec
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer
from repro_torch.models.tree import tree_leaves_with_path
from repro_torch.runtime.buckets import chunk_schedule, pow2_buckets
from repro_torch.runtime.engine import ServingRuntime
from repro_torch.runtime.scheduler import Request

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "gemma2-27b"
#: float32 on both sides: the packages differ by summation order only
TOL = 1e-4
PROMPTS = (3, 8, 9, 17, 30)
NEW = 12
SLOTS = 4
CHUNK = 4
WINDOW = 8
PAGE = 4
MAX_LEN = max(PROMPTS) + NEW
#: twice the depth chip_smoke.py serves (a bound on its peaks), and its
#: cache width
PERIODS = 8
ROWS = 8208


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------ launches at published width
def wide():
    return get_config(ARCH, n_periods=PERIODS, contract_backend="kernel",
                      contract_strategy="native")


def traced(kind: str, n: int, rows: int = ROWS, held_slots: int = 0):
    """``CostCounter.costs()`` of one pass at published width on fake
    tensors: a prefill of ``n`` tokens against a batch-1 cache of ``rows``
    rows (``kind="prefill"``), a decode pass of ``n`` slots over ``rows``
    rows (``"decode"``) or ``forward`` over ``n`` tokens (``"forward"``).
    The masters are held as arguments; the pass's cache is made before
    the counter and not held (the peaks are the masters and the pass's
    temporaries), but with ``held_slots`` a slot cache of ``ROWS`` rows is
    held and the prefill's batch-1 cache made under the counter, as the
    legacy engine holds and makes them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.runtime.engine import slot_cache
    from repro_torch.utils import CostCounter

    cfg = wide()
    with FakeTensorMode(), torch.no_grad():
        params = transformer.init_params(None, cfg, device="cpu")
        toks = torch.zeros((n, 1) if kind == "decode" else (1, n), dtype=torch.long)
        cache = (slot_cache(cfg, n, rows, device="cpu") if kind == "decode"
                 else None if kind == "forward" or held_slots
                 else transformer.init_cache(cfg, 1, rows, device="cpu"))
        with CostCounter() as cc:
            cc.hold(params)
            if held_slots:
                held = slot_cache(cfg, held_slots, ROWS, device="cpu")
                cc.hold(held)
                cache = transformer.init_cache(cfg, 1, rows, device="cpu")
            if kind == "forward":
                transformer.forward(cfg, params, {"tokens": toks})
            elif kind == "decode":
                transformer.decode_step(cfg, params, cache, toks)
            else:
                transformer.prefill(cfg, params, {"tokens": toks}, cache)
    return cc.costs()


#: (kind, tokens or slots, cache rows) of the passes the phase's serves
#: make: chunks of 512 and 1 against the unpaged 8208 rows, a 256-token
#: chunk on a paged staging view of 32 pages, decode buckets 4 and 1, a
#: 4-slot paged decode at 513 pages
PASSES = [("prefill", 512, ROWS), ("prefill", 1, ROWS), ("prefill", 256, 512),
          ("decode", 4, ROWS), ("decode", 1, ROWS), ("decode", 4, 513 * 16)]


@pytest.mark.parametrize("kind,n,rows", PASSES, ids=lambda v: str(v))
def test_every_pass_launches_145_by_route_at_published_width(kind, n, rows):
    """113 ``wgmma`` (7 dense products a layer and the tied head) and 32
    ``batched`` (scores and P·V a layer), whatever the chunk, bucket or
    cache width; the masters 40.96 GB; beside its cache a 512-token
    chunk peaks at 44.40 GB (3.44 of temporaries) and a 4-slot decode
    pass at 8208 rows at 49.56 (8.61: each layer's cache rewritten out of
    place, then stacked over the periods)."""
    cs = _chip_smoke()
    cfg = wide()
    got = traced(kind, n, rows)
    routes = {"wgmma": 113, "batched": 32}
    assert got["routes"] == {"repro_torch.native_gemm": routes}
    assert got["ops"] == {"repro_torch.native_gemm": 145}
    assert cs.ssm_routes(cfg) == routes
    assert round(got["argument_bytes"] / 1e9, 2) == 40.96
    if (kind, n, rows) == ("prefill", 512, ROWS):
        assert got["peak_bytes"] < 44.5e9
    if (kind, n, rows) == ("decode", 4, ROWS):
        assert got["peak_bytes"] < 49.6e9


@pytest.mark.parametrize("kind", ["forward", "legacy"])
def test_the_longest_prompt_fits_whole_on_the_card(kind):
    """``chip_smoke.py`` runs (c) ``forward`` (its (S, 256000) float32
    logits and dense S × S scores) and (d) the legacy engine's
    whole-prompt prefill (beside its 4-slot cache) at every prompt: at the
    longest, 8192 tokens, each peaks under 75 GB (1e9) with the masters."""
    n = max(_chip_smoke().GEMMA_SERVE["prompts"])
    got = traced("forward", n) if kind == "forward" else traced("prefill", n, held_slots=SLOTS)
    assert got["peak_bytes"] < 75e9


def test_the_phases_prompts_cross_the_window_and_fill_the_context():
    """4095 crosses the window while decoding, 4097 drops key 0 at its
    last prompt token, 8192 is Gemma 2's context and its last chunk of
    512 drops keys on the local layer; 78 chunks of up to 512 in all."""
    cs = _chip_smoke()
    spec, cfg = cs.GEMMA_SERVE, wide()
    window = cfg.pattern[0].window
    assert (window, cfg.pattern[1].window) == (4096, None)
    assert {window - 1, window, window + 1, 8192} <= set(spec["prompts"])
    assert max(spec["prompts"]) - spec["chunk"] >= window
    chunks = pow2_buckets(spec["chunk"])
    assert len(chunk_schedule(8192, chunks)) == 16
    assert sum(len(chunk_schedule(n, chunks)) for n in spec["prompts"]) == 78


# ------------------------------ parity on a narrow config, published ratios
def narrow(get, window=WINDOW, spec_cls=None):
    """gemma2's smoke config (float32, d_model 64, head_dim 16) at the
    published 2:1 GQA, 2 periods of a local layer (``window``) and a
    global one; both softcaps and the tied head as published."""
    spec_cls = spec_cls or (JLayerSpec if get is jget_config else LayerSpec)
    return get(ARCH, smoke=True, n_periods=2, n_kv_heads=2, pattern=(
        spec_cls(mixer="attn", ff="dense", window=window),
        spec_cls(mixer="attn", ff="dense", window=None)))


@functools.cache
def carried():
    """The JAX params and the same weights in the port."""
    jcfg = narrow(jget_config)
    assert jcfg.attn_softcap and jcfg.final_softcap and jcfg.tie_embeddings
    assert jcfg.n_heads == 2 * jcfg.n_kv_heads
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(narrow(get_config), jax.tree.map(np.asarray, jp), "cpu")


@functools.cache
def prompts():
    rng = np.random.default_rng(33)
    vocab = narrow(get_config).vocab_size
    return tuple(rng.integers(0, vocab, n).astype(np.int32) for n in PROMPTS)


def requests(cls):
    return [cls(rid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts())]


def runtime_kw(paged: bool) -> dict:
    kw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK, precompile=False)
    return kw | (dict(paged=True, page_size=PAGE) if paged else {})


@functools.cache
def jax_served(paged: bool):
    jp, _ = carried()
    return [r.output for r in JServingRuntime(narrow(jget_config), jp,
                                              **runtime_kw(paged)).serve(requests(JRequest))]


@functools.cache
def port_served(backend: str, paged: bool):
    """The port runtime's tokens and logits by ``(request, tokens generated
    before)``."""
    _, tp = carried()
    rt = ServingRuntime(narrow(get_config).with_(contract_backend=backend), tp,
                        **runtime_kw(paged))
    logits = {}
    reqs = requests(Request)
    with _chip_smoke().served_events(rt, logits, []):
        rt.serve(reqs)
    assert all(r.done for r in reqs)
    if paged:
        assert rt.pool.n_free == rt.pool.usable and not rt.pool.refcount
    return [r.output for r in reqs], logits


@functools.cache
def jax_forward_last(i: int, window=WINDOW):
    jp, _ = carried()
    logits, _ = jtransformer.forward(narrow(jget_config, window), jp,
                                     {"tokens": jnp.asarray(prompts()[i][None])})
    return np.asarray(logits)[0, -1]


BACKENDS = ["torch", "kernel"]


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_runtime_tokens_equal_the_jax_runtimes(backend, paged):
    """Chunked prefill in chunks of up to 4 and bucketed decode, unpaged
    and off 4-row pages (under the window): the JAX runtime's greedy
    tokens, the window dropping keys in prefill and in decode."""
    got, _ = port_served(backend, paged)
    assert got == jax_served(paged)
    assert all(len(o) == NEW for o in got)


@pytest.mark.parametrize("backend", BACKENDS)
def test_served_prefill_matches_jax_forward_last_position(backend):
    _, logits = port_served(backend, False)
    for i, n in enumerate(PROMPTS):
        assert rel_err(logits[(i, 0)], jax_forward_last(i)) <= TOL, n
    _, paged = port_served(backend, True)
    for i, n in enumerate(PROMPTS):
        assert rel_err(paged[(i, 0)], jax_forward_last(i)) <= TOL, n


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_chunk_edge_on_the_window_edge_gives_the_whole_prompt_prefill(backend):
    """The 9-token prompt in chunks of 4, 4 and 1: the last chunk is query
    8, the first to drop key 0.  Its logits and cache equal the
    whole-prompt prefill's, and the JAX package's prefill's."""
    _, tp = carried()
    cfg = narrow(get_config).with_(contract_backend=backend)
    i = PROMPTS.index(WINDOW + 1)
    toks = torch.from_numpy(prompts()[i][None].astype(np.int64))
    schedule = chunk_schedule(len(prompts()[i]), pow2_buckets(CHUNK))
    assert schedule == [4, 4, 1] and sum(schedule[:-1]) == WINDOW
    with torch.no_grad():
        whole, whole_cache = transformer.prefill(
            cfg, tp, {"tokens": toks}, transformer.init_cache(cfg, 1, MAX_LEN, device="cpu"))
        cache, pos = transformer.init_cache(cfg, 1, MAX_LEN, device="cpu"), 0
        for c in schedule:
            got, cache = transformer.prefill(cfg, tp, {"tokens": toks[:, pos:pos + c]}, cache)
            pos += c
    assert rel_err(got, whole) <= TOL
    jp, _ = carried()
    want, want_cache = jtransformer.prefill(
        narrow(jget_config), jp, {"tokens": jnp.asarray(prompts()[i][None])},
        jtransformer.init_cache(narrow(jget_config), 1, MAX_LEN))
    assert rel_err(got, np.asarray(want)) <= TOL
    chunked = dict(tree_leaves_with_path(cache))
    for ref in (dict(tree_leaves_with_path(whole_cache)),
                dict(tree_leaves_with_path(jax.tree.map(np.asarray, want_cache)))):
        assert chunked.keys() == ref.keys()
        for path, leaf in chunked.items():
            assert rel_err(leaf, np.asarray(ref[path])) <= TOL, path


@pytest.mark.parametrize("backend", BACKENDS)
def test_the_window_changes_the_logits(backend):
    """The same weights with ``window=None`` on the local layer: every
    prompt longer than the window gives other last-position logits, in
    both packages alike; a prompt within it the same ones."""
    _, tp = carried()
    cfg = narrow(get_config, None).with_(contract_backend=backend)
    for i, n in enumerate(PROMPTS):
        toks = torch.from_numpy(prompts()[i][None].astype(np.int64))
        with torch.no_grad():
            got, _ = transformer.forward(cfg, tp, {"tokens": toks})
        assert rel_err(got[0, -1], jax_forward_last(i, None)) <= TOL, n
        moved = rel_err(got[0, -1], jax_forward_last(i))
        assert moved > TOL if n > WINDOW else moved <= TOL, n


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_runtime_fed_its_own_tokens_repeats_its_rows(backend):
    """``served_events(forced=...)`` feeds every request the given tokens
    in place of its samples: fed the tokens it served, the runtime gives
    its own rows again.  The 3-token request finishes while the 17-token
    one still decodes in slot 0; a freed slot is ``None``, which numpy
    reads as a new axis, so writing the finished request's token there
    would feed it to slot 0."""
    _, tp = carried()
    outputs, logits = port_served(backend, False)
    rt = ServingRuntime(narrow(get_config).with_(contract_backend=backend), tp,
                        **runtime_kw(False))
    fed, reqs = {}, requests(Request)
    with _chip_smoke().served_events(rt, fed, [], forced=dict(enumerate(outputs))):
        rt.serve(reqs)
    assert [r.output for r in reqs] == outputs
    assert fed.keys() == logits.keys()
    for key, row in logits.items():
        assert torch.equal(fed[key], row), key
