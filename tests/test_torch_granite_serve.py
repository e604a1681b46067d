"""Serving granite-20b with the port: the launches, plans and peaks of its
passes at published width, its served rows held against the JAX package,
and the broadcast of its one KV head held against a copy per query head.

- At published width, 16 of 52 layers (twice the depth ``chip_smoke.py``
  serves), prefill chunks against the 8208-row cache, decode passes over
  it and the paged views' widths are traced on fake tensors under
  ``utils.CostCounter``: every pass makes 129 ``native_gemm`` calls over
  26.68 GB of masters, 97 on ``wgmma`` (Q, K, V, O and the GELU MLP's two
  products a layer, the untied head) and 32 on ``batched`` (scores and
  P·V a layer), as ``chip_smoke.ssm_routes`` derives them, a pass of one
  query row (a 1-token chunk, a 1-slot decode) too.  Beside its
  cache a 512-token chunk peaks under 29.0 GB and a 4-slot decode pass
  under 27.7; the phase's longest prompt, 8192 tokens, through
  ``transformer.forward`` or the legacy engine's whole-prompt prefill
  beside its 4-slot cache, under 62 GB.
- ``native_plan`` on meta tensors: a 512-token chunk's scores and P·V
  take ``batched`` with the 48 query heads a grid mode whose K (V) stride
  is 0, one K (V) tile serving every head with no copy; a 4-slot decode
  pass's take ``batched`` with the 48 heads as the tile's rows and the
  slots the only grid mode, its P·V 4 tiles.  One query row alone would
  leave them no grid mode (the one KV head is no batch mode): they would
  take ``wgmma``, which splits P·V's contraction over the cache width at
  width-dependent points, so on the card a request got other bits, and
  other tokens, off the page pool than in its slot.  ``layers.attention``
  copies such a row: both products stay on ``batched``, unsplit (pinned
  here on CPU tensors, and bit for bit at every cache width on the card,
  ``gpu``).
- On granite's smoke config, float32 with the published ratios (4 query
  heads over 1 KV head, GELU, the untied head, 2 periods), the JAX
  package's weights carried across, prompts of 3, 8, 9, 17 and 30
  tokens, 12 new tokens each, chunks of up to 4 on both sides: the port's
  ``ServingRuntime`` gives the JAX runtime's tokens, unpaged and paged
  (4-row pages), on the ``torch`` and ``kernel`` backends; each served
  prefill's logits are within 1e-4 of the largest magnitude of the JAX
  ``forward``'s last position.
- The same model with ``n_kv_heads=4`` and its K and V weights repeated
  per head (the copy the broadcast avoids) gives logits within 1e-5 of
  the one KV head's, in both packages.
- ``chip_smoke.granite_serve_path`` (phase 27) and
  ``gemma2_serve_path`` (phase 25), which share ``serve_at_width``, run
  through on the CPU at narrow widths in bf16, their card-only calls
  stubbed.

JAX is imported only inside the parity tests."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_rehearsal
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.sb_gemm import native_plan
from repro_torch.models import transformer
from repro_torch.runtime.buckets import chunk_schedule, pow2_buckets
from repro_torch.runtime.engine import ServingRuntime
from repro_torch.runtime.scheduler import Request

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ARCH = "granite-20b"
#: float32 on both sides: the packages differ by summation order only
TOL = 1e-4
#: the broadcast against its copy: the same sums over other modes
COPY_TOL = 1e-5
PROMPTS = (3, 8, 9, 17, 30)
NEW = 12
SLOTS = 4
CHUNK = 4
PAGE = 4
MAX_LEN = max(PROMPTS) + NEW
#: twice the depth chip_smoke.py serves (a bound on its peaks), and its
#: cache width
PERIODS = 16
ROWS = 8208
SCORES, PV = "bsgrd,btgd->bgrst", "bgrst,btgd->bsgrd"


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
PER_PASS = {"wgmma": 97, "batched": 32}


@pytest.mark.parametrize("kind,n,rows", PASSES, ids=lambda v: str(v))
def test_every_pass_launches_129_by_route_at_published_width(kind, n, rows):
    """129 calls a pass whatever the chunk, bucket or cache width, 97
    ``wgmma`` and 32 ``batched`` (a pass of one query row too, its row
    copied), as ``chip_smoke.ssm_routes`` derives them from the layer
    pattern; the masters 26.68 GB; beside its
    cache a 512-token chunk peaks at 28.79 GB (2.11 of temporaries: the
    (1, 1, 48, 512, 8208) f32 scores, 807 MB a copy) and a 4-slot decode
    pass at 8208 rows at 27.55 (0.87: each layer's cache rewritten out of
    place, then stacked over the periods)."""
    cs = chip_rehearsal.chip_smoke()
    cfg = wide()
    got = traced(kind, n, rows)
    assert got["routes"] == {"repro_torch.native_gemm": PER_PASS}
    assert got["ops"] == {"repro_torch.native_gemm": 129}
    assert cs.ssm_routes(cfg) == PER_PASS
    assert round(got["argument_bytes"] / 1e9, 2) == 26.68
    if (kind, n, rows) == ("prefill", 512, ROWS):
        assert got["peak_bytes"] < 29.0e9
    if (kind, n, rows) == ("decode", 4, ROWS):
        assert got["peak_bytes"] < 27.7e9


@pytest.mark.parametrize("kind", ["forward", "legacy"])
def test_the_longest_prompt_fits_whole_on_the_card(kind):
    """``chip_smoke.py`` runs (c) ``forward`` (its dense (1, 1, 48, 8192,
    8192) f32 scores, 12.9 GB a copy) and (d) the legacy engine's
    whole-prompt prefill (beside its 4-slot cache) at every prompt: at the
    longest, 8192 tokens, each peaks under 62 GB (1e9) with the masters
    (59.36 and 59.83), on an 80 GB card."""
    n = max(chip_rehearsal.chip_smoke().GRANITE_SERVE["prompts"])
    got = traced("forward", n) if kind == "forward" else traced("prefill", n, held_slots=SLOTS)
    assert got["peak_bytes"] < 62e9


def test_the_phases_prompts_sit_on_chunk_and_page_edges():
    """511, 512 and 513 on the chunk's edge, 4097 one past a page and a
    chunk edge, 8192 granite-20b-code's context; 57 chunks of up to 512
    in all, 3 of them of one token (the last of 511, 513 and 4097: passes
    of one query row); the published config at 52 layers would need 81.26 GB
    of f32 masters."""
    cs = chip_rehearsal.chip_smoke()
    spec = cs.GRANITE_SERVE
    assert {511, 512, 513, 4097, 8192} <= set(spec["prompts"])
    assert max(spec["prompts"]) + spec["max_new"] == ROWS
    assert (4097 - 1) % spec["page_size"] == 0 and (4097 - 1) % spec["chunk"] == 0
    chunks = pow2_buckets(spec["chunk"])
    schedules = {n: chunk_schedule(n, chunks) for n in spec["prompts"]}
    assert schedules[513] == [512, 1] and schedules[4097] == [512] * 8 + [1]
    assert len(schedules[8192]) == 16
    assert sum(map(len, schedules.values())) == 57
    assert [n for n, s in schedules.items() if s[-1] == 1] == [511, 513, 4097]
    assert sum(c == 1 for s in schedules.values() for c in s) == 3
    full = get_config(ARCH)
    assert full.n_kv_heads == 1 and full.n_heads == 48 and full.mlp_act == "gelu"
    assert not full.tie_embeddings
    assert round(4 * full.param_count() / 1e9, 2) == 81.26
    assert round(4 * full.with_(n_periods=PERIODS).param_count() / 1e9, 2) == 26.68


# --------------------------------------------------------------- plans
def attention_plans(batch: int, seq: int, keys: int = ROWS) -> dict:
    """``native_plan`` of the scores and P·V of one granite layer in a
    pass of ``batch`` rows of ``seq`` query tokens against ``keys`` cache
    rows, on meta tensors laid out as ``layers.attention`` lays them."""
    cfg = wide()
    G, D = cfg.n_kv_heads, cfg.hd
    R = cfg.n_heads // G

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    kv = meta(batch, keys, G, D)
    return {SCORES: native_plan(meta(batch, seq, G, R, D), kv, a_modes="bsgrd",
                                b_modes="btgd", c_modes="bgrst"),
            PV: native_plan(meta(batch, G, R, seq, keys), kv, a_modes="bgrst",
                            b_modes="btgd", c_modes="bsgrd")}


def test_a_chunk_broadcasts_the_kv_head_on_a_stride_0_grid_mode():
    """A 512-token chunk: both products on ``batched``, the 512 rows the
    tile's row mode and the 48 query heads a grid mode that X carries and
    W (the cache's K or V) does not, at stride 0: one K (V) tile serves
    all 48 heads; 12480 and 192 tiles."""
    cs = chip_rehearsal.chip_smoke()
    plans = attention_plans(1, 512)
    for spec, tiles, N, K in ((SCORES, 12480, ROWS, 128), (PV, 192, 128, ROWS)):
        route, plan = plans[spec]
        assert route == "batched" and (plan["M"], plan["N"], plan["K"]) == (512, N, K)
        mode = cs.broadcast_mode(plan, 48)
        assert mode is not None and mode[2] == 0 and plan["grid"] == [mode]
        assert plan["G"] == 48 and plan["tiles"] == tiles


def test_a_decode_pass_puts_the_heads_on_the_tile_rows():
    """A 4-slot decode pass at 8208 rows: both products on ``batched``
    with the 48 heads as the tile's 48 rows (one 64-row tile) and the
    slots the only grid mode, carried by both operands: no grid mode of
    48, and W carries no head mode.  The scores 260 tiles, P·V (8208 deep,
    never split on ``batched``) 4, one a slot."""
    cs = chip_rehearsal.chip_smoke()
    plans = attention_plans(4, 1)
    for spec, tiles in ((SCORES, 260), (PV, 4)):
        route, plan = plans[spec]
        assert route == "batched" and plan["M"] == 48 and plan["tiles"] == tiles
        assert cs.broadcast_mode(plan, 48) is None
        assert len(plan["grid"]) == 1 and plan["grid"][0][0] == 4
        assert all(g[1] and g[2] for g in plan["grid"])
        assert plan["n_split"] == 1


def narrow_bf16(head_dim: int = 64):
    """granite at phase 27's CPU rehearsal widths: d_model 256, 4 query
    heads over 1 KV head of ``head_dim``, bf16 on the kernel backend."""
    return get_config(ARCH, smoke=True, d_model=256, n_heads=4, n_kv_heads=1, head_dim=head_dim,
                      d_ff=512, vocab_size=1024, dtype="bfloat16", contract_backend="kernel",
                      contract_strategy="native")


def one_row(cfg, p, x, width: int, dev="cpu"):
    """``layers.attention``'s output for ``x``'s last row after its rows
    before filled a cache of ``width`` rows, under the runtime's
    ``cached_rows(8208)``."""
    from repro_torch.models import layers

    n = x.shape[1] - 1
    cache = {"k": torch.zeros(1, width, cfg.n_kv_heads, cfg.hd, dtype=x.dtype, device=dev),
             "v": torch.zeros(1, width, cfg.n_kv_heads, cfg.hd, dtype=x.dtype, device=dev),
             "length": torch.zeros((), dtype=torch.int32, device=dev)}
    with torch.no_grad(), layers.cached_rows(ROWS):
        _, cache = layers.attention(cfg, p, x[:, :n], positions=torch.arange(n, device=dev),
                                    kv_cache=cache)
        out, _ = layers.attention(cfg, p, x[:, n:], positions=torch.arange(n, n + 1, device=dev),
                                  kv_cache=cache)
    return out


def test_a_one_row_pass_keeps_its_attention_on_batched_unsplit():
    """One query row alone (a 1-token chunk, a 1-slot decode): the scores
    and P·V as laid out would have no grid mode and take ``wgmma``, which
    splits P·V's 8208-deep contraction (26 splits; a 33-page view of 528
    rows 2), so the row's bits would depend on the cache width.
    ``layers.attention`` copies the row: through it both products take
    ``batched`` with the heads as the tile's rows and the copy a grid mode
    of 2, unsplit, and the output keeps one row."""
    from repro_torch.models import layers

    cs = chip_rehearsal.chip_smoke()
    raw = attention_plans(1, 1)
    assert {spec: route for spec, (route, _) in raw.items()} == {SCORES: "wgmma", PV: "wgmma"}
    assert raw[PV][1]["n_split"] == 26 and attention_plans(1, 1, 528)[PV][1]["n_split"] == 2
    cfg = narrow_bf16()
    gen = torch.Generator().manual_seed(4)
    p = layers.init_attn(gen, cfg, device="cpu")
    x = torch.randn(1, 61, cfg.d_model, generator=gen).to(torch.bfloat16)
    with cs.recording_plans() as plans:
        out = one_row(cfg, p, x, 136)
    assert out.shape == (1, 1, cfg.d_model)
    for spec in (SCORES, PV):
        route, plan, shapes = plans[spec][-1]
        assert route == "batched" and plan["n_split"] == 1 and plan["M"] == 4, spec
        assert [g[0] for g in plan["grid"]] == [2] and shapes[0][1 if spec == SCORES else 3] == 2


@pytest.mark.gpu
def test_a_one_row_pass_gets_the_same_bits_at_any_cache_width():
    """bf16 on the kernel backend, 4 query heads over 1 KV head of 128: 60
    cached keys and one new row through one layer under
    ``cached_rows(8208)`` at cache widths from a 4-page view (65 rows) to
    wider than the runtime's: bit for bit the same output, and the same as
    that row's in a pass of two rows."""
    from repro_torch.models import layers

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    cfg = narrow_bf16(head_dim=128)
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = layers.init_attn(gen, cfg, device="cuda")
    x = torch.randn(1, 62, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    outs = {w: one_row(cfg, p, x[:, :61], w, "cuda") for w in (65, 528, 4096, ROWS, ROWS + 16)}
    want = outs.pop(ROWS)
    for width, out in outs.items():
        assert torch.equal(out, want), width
    cache = {"k": torch.zeros(1, ROWS, 1, cfg.hd, dtype=x.dtype, device="cuda"),
             "v": torch.zeros(1, ROWS, 1, cfg.hd, dtype=x.dtype, device="cuda"),
             "length": torch.zeros((), dtype=torch.int32, device="cuda")}
    with torch.no_grad(), layers.cached_rows(ROWS):
        _, cache = layers.attention(cfg, p, x[:, :60], positions=torch.arange(60, device="cuda"),
                                    kv_cache=cache)
        two, _ = layers.attention(cfg, p, x[:, 60:], positions=torch.arange(60, 62, device="cuda"),
                                  kv_cache=cache)
    assert torch.equal(two[:, :1], want)


# ------------------------------ parity on a narrow config, published ratios
def narrow(get, **kw):
    """granite's smoke config: float32, d_model 64, 4 query heads of 16
    over 1 KV head, GELU, the untied head, 2 periods."""
    return get(ARCH, smoke=True, **kw)


def repeated(tree, heads: int):
    """A numpy parameter tree with each layer's K and V projections
    repeated ``heads`` times along their output: every KV head the one
    KV head's copy."""
    attn = tree["pattern"][0]["attn"]
    reps = dict(attn, **{k: np.tile(attn[k], (1, 1, heads)) for k in ("wk", "wv")})
    block = dict(tree["pattern"][0], attn=reps)
    return dict(tree, pattern=[block, *tree["pattern"][1:]])


@functools.cache
def carried():
    """The JAX params, their numpy tree and the same weights in the port."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtransformer

    jcfg = narrow(jget_config)
    assert (jcfg.n_heads, jcfg.n_kv_heads, jcfg.mlp_act, jcfg.tie_embeddings) == (
        4, 1, "gelu", False)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    numpy_tree = jax.tree.map(np.asarray, jp)
    return jp, numpy_tree, params_from_numpy(narrow(get_config), numpy_tree, "cpu")


@functools.cache
def prompts():
    rng = np.random.default_rng(35)
    vocab = narrow(get_config).vocab_size
    return tuple(rng.integers(0, vocab, n).astype(np.int32) for n in PROMPTS)


def requests(cls):
    return [cls(rid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts())]


def runtime_kw(paged: bool) -> dict:
    kw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK, precompile=False)
    return kw | (dict(paged=True, page_size=PAGE) if paged else {})


@functools.cache
def jax_served(paged: bool):
    from repro.configs import get_config as jget_config
    from repro.runtime.engine import ServingRuntime as JServingRuntime
    from repro.runtime.scheduler import Request as JRequest

    jp, _, _ = carried()
    return [r.output for r in JServingRuntime(narrow(jget_config), jp,
                                              **runtime_kw(paged)).serve(requests(JRequest))]


@functools.cache
def port_served(backend: str, paged: bool):
    """The port runtime's tokens and logits by ``(request, tokens generated
    before)``."""
    _, _, tp = carried()
    rt = ServingRuntime(narrow(get_config, contract_backend=backend), tp, **runtime_kw(paged))
    logits = {}
    reqs = requests(Request)
    with chip_rehearsal.chip_smoke().served_events(rt, logits, []):
        rt.serve(reqs)
    assert all(r.done for r in reqs)
    if paged:
        assert rt.pool.n_free == rt.pool.usable and not rt.pool.refcount
    return [r.output for r in reqs], logits


@functools.cache
def jax_forward_last(i: int):
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtransformer

    jp, _, _ = carried()
    logits, _ = jtransformer.forward(narrow(jget_config), jp,
                                     {"tokens": jnp.asarray(prompts()[i][None])})
    return np.asarray(logits)[0, -1]


BACKENDS = ["torch", "kernel"]


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_runtime_tokens_equal_the_jax_runtimes(backend, paged):
    """Chunked prefill in chunks of up to 4 and bucketed decode, unpaged
    and off 4-row pages of the one KV head: the JAX runtime's greedy
    tokens."""
    got, _ = port_served(backend, paged)
    assert got == jax_served(paged)
    assert all(len(o) == NEW for o in got)


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_served_prefill_matches_jax_forward_last_position(backend, paged):
    _, logits = port_served(backend, paged)
    for i, n in enumerate(PROMPTS):
        assert rel_err(logits[(i, 0)], jax_forward_last(i)) <= TOL, n


@pytest.mark.parametrize("package", ["torch", "kernel", "jax"])
def test_the_kv_head_copied_per_query_head_gives_the_same_logits(package):
    """``n_kv_heads=4`` (one KV head per query head, G = 4, R = 1) with
    each layer's K and V weights the one head's, repeated: the same
    logits at every position of every prompt, within 1e-5 of the largest
    magnitude, in the port on both backends and in the JAX package."""
    jp, numpy_tree, tp = carried()
    copies = repeated(numpy_tree, 4)
    for i, n in enumerate(PROMPTS):
        toks = prompts()[i][None]
        if package == "jax":
            import jax.numpy as jnp

            from repro.configs import get_config as jget_config
            from repro.models import transformer as jtransformer

            one, _ = jtransformer.forward(narrow(jget_config), jp, {"tokens": jnp.asarray(toks)})
            four, _ = jtransformer.forward(narrow(jget_config, n_kv_heads=4), copies,
                                           {"tokens": jnp.asarray(toks)})
            one, four = np.asarray(one), np.asarray(four)
        else:
            cfg = narrow(get_config, contract_backend=package)
            cfg4 = cfg.with_(n_kv_heads=4)
            batch = {"tokens": torch.from_numpy(toks.astype(np.int64))}
            with torch.no_grad():
                one, _ = transformer.forward(cfg, tp, batch)
                four, _ = transformer.forward(cfg4, params_from_numpy(cfg4, copies, "cpu"),
                                              batch)
        assert rel_err(four, one if package == "jax" else one.numpy()) <= COPY_TOL, n


# ------------------------------------------- phases 27 and 25 on the CPU
def test_phase_27_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.granite_serve_path`` with granite's widths shrunk
    (d_model 256, 4 query heads over 1 KV head of 64, d_ff 512, vocab
    1024), 2 periods, prompts of 8-128 tokens in chunks of up to 32, 8
    new tokens each (a cache width of 136, a multiple of 8), card-only
    calls stubbed: every check passes; every pass launches 17 (13
    ``wgmma``, 4 ``batched``), a pass of one query row (the 31-, 33- and 65-token
    prompts' last chunks, 1-slot decodes, their row copied) the same; the plans put
    the 4 heads on a stride-0 grid mode in a chunk and on the tile's rows
    in a decode pass, whose P·V has 4 tiles."""
    import repro_torch.configs as configs

    cs = chip_rehearsal.chip_smoke()
    real_get = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda arch, **kw: real_get(arch, **kw).with_(
        d_model=256, n_heads=4, n_kv_heads=1, head_dim=64, d_ff=512, vocab_size=1024))
    monkeypatch.setattr(cs, "GRANITE_SERVE", dict(
        cs.GRANITE_SERVE, periods=2, prompts=(8, 31, 32, 33, 64, 65, 100, 128), max_new=8,
        chunk=32))
    counters, profiled = chip_rehearsal.card_stubbed(monkeypatch, cs)
    rec = cs.granite_serve_path(torch.device("cpu"), 0, counters)
    assert rec["launches_per_pass"] == {"wgmma": 13, "batched": 4}
    assert rec["launches"] == 17 * (rec["prefill_chunks"] + rec["decode_passes"])
    assert rec["paged_launches"] == rec["launches"]
    plans = rec["broadcast"]["plans"]
    for spec in (SCORES, PV):
        assert cs.broadcast_mode(plans[f"chunk {spec}"], 4)[2] == 0
        assert plans[f"decode {spec}"]["M"] == 4
    assert rec["decode_pv"]["tiles"] == 4 and rec["decode_pv"]["launches"] == 2
    assert rec["broadcast"]["kernel_err"] <= 2e-2 and rec["broadcast"]["copy_err"] <= 2e-2
    assert rec["weight_cast"]["bytes"] > 0 and len(profiled) == 2


def test_phase_25_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.gemma2_serve_path`` through the same
    ``serve_at_width``, gemma2's widths shrunk (d_model 256, 8 query heads
    over 4 KV heads of 64, d_ff 512, vocab 1024, a window of 64), 2
    periods, prompts of 8-128 tokens in chunks of up to 32: every check
    passes (the window's among them), every pass launches 37 (29
    ``wgmma``, 8 ``batched``)."""
    import repro_torch.configs as configs

    cs = chip_rehearsal.chip_smoke()
    real_get = configs.get_config

    def shrunk(arch, **kw):
        cfg = real_get(arch, **kw)
        return cfg.with_(d_model=256, n_heads=8, n_kv_heads=4, head_dim=64, d_ff=512,
                         vocab_size=1024, pattern=tuple(
                             dataclasses.replace(p, window=64 if p.window else None)
                             for p in cfg.pattern))

    monkeypatch.setattr(configs, "get_config", shrunk)
    monkeypatch.setattr(cs, "GEMMA_SERVE", dict(
        cs.GEMMA_SERVE, periods=2, prompts=(8, 31, 63, 64, 65, 100, 128), max_new=8, chunk=32))
    counters, profiled = chip_rehearsal.card_stubbed(monkeypatch, cs)
    rec = cs.gemma2_serve_path(torch.device("cpu"), 0, counters)
    assert rec["launches_per_pass"] == {"wgmma": 29, "batched": 8}
    assert rec["launches"] == 37 * (rec["prefill_chunks"] + rec["decode_passes"])
    assert rec["paged_launches"] == rec["launches"]
    assert rec["window_err"]["kernel"] <= 2e-2
    assert rec["window_err"]["no_window"] > 10 * rec["window_err"]["kernel"]
    assert len(profiled) == 2
