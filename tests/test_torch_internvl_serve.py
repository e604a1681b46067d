"""Serving internvl2-2b with the port: one image a request through the
model's own ``prefill`` and ``decode_step``, held against the JAX package,
and the launches of its passes at published width.

- A reduced internvl2 in float32 that keeps the published head ratio and
  patch count (2 layers, d_model 256, 4 query heads over 2 KV heads, d_ff
  1024, an odd vocab of 1001 padded to 1024 as ``get_config`` pads 92553,
  256 patch positions of 128 features), the JAX package's weights carried
  across by ``params_from_numpy``: a prefill of 2 requests of 12 text
  tokens, each with its image, then 4 decode steps, within 1e-4 of the
  largest magnitude of the JAX ``prefill`` and ``decode_step`` (its
  ``xla`` backend) on the port's ``kernel`` backend (the plain version on
  the CPU) and its ``torch`` backend; the cache holds 256 + 12 rows after
  the prefill in both packages; zeroed features move the logits in both;
  the decode loop's logits are the port's ``forward`` over image, prompt
  and the tokens before, within 1e-4.
- At published width on fake tensors, at 1 and 2 layers: a prefill (the
  image and 32 or 3840 text tokens) and a decode pass (1 and 4 slots)
  launch what ``chip_smoke.ssm_routes`` derives, which at 24 layers is
  218 a prefill (170 ``wgmma``: Q, K, V, O and the 3 SwiGLU products a
  layer, the head, the projector; 48 ``batched``: the scores and P·V a
  layer) and 217 a decode pass (no projector); the projector
  ``bpf,fe->bpe`` and the head take ``wgmma``.
- ``chip_smoke.internvl2_serve_path`` (phase 30) runs through on the CPU
  at the reduced widths in bf16, its card-only calls stubbed.

JAX is imported only inside the parity tests."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_rehearsal
from repro_torch.configs import get_config
from repro_torch.configs.registry import VOCAB_PAD
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ARCH = "internvl2-2b"
#: float32 on both sides: the packages differ by summation order only
TOL = 1e-4
#: the reduced config: the published head ratio (2 query heads a KV head)
#: and patch count, an odd vocab padded as get_config pads
REDUCED = dict(n_periods=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=1024,
               vocab_size=-(-1001 // VOCAB_PAD) * VOCAB_PAD, dtype="float32")
FEATURES = 128
PROMPT, BATCH, STEPS = 12, 2, 4
MAX_LEN = 256 + PROMPT + STEPS + 4
#: a pass's launches at 24 layers
PER_PREFILL = {"wgmma": 170, "batched": 48}
PER_DECODE = {"wgmma": 169, "batched": 48}
PROJECTOR, HEAD = "bpf,fe->bpe", "bse,ev->bsv"


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


def reduced(get, **kw):
    cfg = get(ARCH)
    return cfg.with_(frontend=dataclasses.replace(cfg.frontend, feature_dim=FEATURES),
                     **REDUCED, **kw)


# ------------------------------------------- parity with the JAX package
@functools.cache
def carried():
    """The JAX params and the same weights in the port."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtransformer

    jcfg = reduced(jget_config)
    assert jcfg.contract_backend == "xla" and jcfg.vocab_size == 1024
    assert jcfg.frontend.n_positions == 256 and jcfg.n_heads // jcfg.n_kv_heads == 2
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(reduced(get_config), jax.tree.map(np.asarray, jp), "cpu")


@functools.cache
def inputs():
    rng = np.random.default_rng(38)
    return (rng.integers(0, 1001, (BATCH, PROMPT)).astype(np.int32),
            rng.standard_normal((BATCH, 256, FEATURES), dtype=np.float32))


@functools.cache
def jax_served(zeroed: bool = False):
    """The JAX package's prefill of the two requests and its greedy decode
    steps: the logits of each pass, the tokens fed, the cache length after
    the prefill."""
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtransformer

    jp, _ = carried()
    jcfg = reduced(jget_config)
    toks, feats = inputs()
    feats = np.zeros_like(feats) if zeroed else feats
    logits, cache = jtransformer.prefill(
        jcfg, jp, {"tokens": jnp.asarray(toks), "features": jnp.asarray(feats)},
        jtransformer.init_cache(jcfg, BATCH, MAX_LEN))
    length = int(cache["length"])
    out, fed = [np.asarray(logits)], []
    for _ in range(STEPS):
        fed.append(np.argmax(out[-1], axis=-1).astype(np.int32))
        logits, cache = jtransformer.decode_step(jcfg, jp, cache, jnp.asarray(fed[-1][:, None]))
        out.append(np.asarray(logits))
    return out, fed, length


def port_served(backend: str, zeroed: bool = False):
    """The port's prefill and decode steps fed the JAX package's tokens:
    the logits of each pass and the cache length after the prefill."""
    _, tp = carried()
    cfg = reduced(get_config, contract_backend=backend)
    toks, feats = inputs()
    feats = np.zeros_like(feats) if zeroed else feats
    _, fed, _ = jax_served(zeroed)
    with torch.no_grad():
        logits, cache = transformer.prefill(
            cfg, tp, {"tokens": torch.from_numpy(toks).long(),
                      "features": torch.from_numpy(feats)},
            transformer.init_cache(cfg, BATCH, MAX_LEN, device="cpu"))
        length = int(cache["length"])
        out = [logits]
        for t in fed:
            logits, cache = transformer.decode_step(cfg, tp, cache,
                                                    torch.from_numpy(t[:, None]).long())
            out.append(logits)
    return out, length


BACKENDS = ["kernel", "torch"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_and_decode_steps_match_the_jax_package(backend):
    """The prefill of two requests with their images and 4 decode steps:
    every pass's logits within 1e-4 of the JAX package's."""
    want, _, _ = jax_served()
    got, _ = port_served(backend)
    assert len(got) == len(want) == STEPS + 1
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (BATCH, 1024)
        assert rel_err(g, w) <= TOL, step


@pytest.mark.parametrize("backend", BACKENDS)
def test_the_cache_holds_the_image_and_zeroed_features_move_the_logits(backend):
    """After the prefill both packages' caches hold 256 image rows and the
    12 text tokens; with zeroed features the prefill's logits move by more
    than 10x the card's 2e-2 tolerance in both, and still agree."""
    (want, _, length_j), (got, length_p) = jax_served(), port_served(backend)
    (want0, _, _), (got0, _) = jax_served(zeroed=True), port_served(backend, zeroed=True)
    assert length_j == length_p == 256 + PROMPT
    assert rel_err(want0[0], want[0]) > 0.2 and rel_err(got0[0], got[0]) > 0.2
    assert rel_err(got0[0], want0[0]) <= TOL


@pytest.mark.parametrize("pad_to", [None, MAX_LEN], ids=["unpadded", "padded"])
def test_decode_loop_logits_equal_forward_over_the_tokens_before(pad_to):
    """Each pass's logits are ``forward``'s position over the image, the
    prompt and the tokens fed before (``chip_smoke.vlm_forward_rows``, one
    forward a request), within 1e-4 (the kernel backend); padded after the
    last token to the cache's width too, since the mask is causal."""
    cs = chip_rehearsal.chip_smoke()
    _, tp = carried()
    cfg = reduced(get_config, contract_backend="kernel")
    toks, feats = inputs()
    _, fed, _ = jax_served()
    got, _ = port_served("kernel")
    reqs = [cs.VlmRequest(b, toks[b], feats[b]) for b in range(BATCH)]
    outputs = {b: [int(t[b]) for t in fed] for b in range(BATCH)}
    rows = cs.vlm_forward_rows(cfg, tp, reqs, outputs, STEPS + 1, "cpu", pad_to=pad_to)
    assert len(rows) == BATCH * (STEPS + 1)
    for (b, step), row in rows.items():
        assert rel_err(got[step][b], row) <= TOL, (b, step)


# ------------------------------------------ launches at published width
def wide(periods: int = 24):
    return get_config(ARCH, n_periods=periods, contract_backend="kernel",
                      contract_strategy="native")


def traced(kind: str, n: int, periods: int):
    """``CostCounter.costs()`` and the plans by spec of one pass at
    published width on fake tensors, ``periods`` layers deep: a prefill of
    the image and ``n`` text tokens on a batch-1 cache of 4112 rows, or a
    decode pass of ``n`` slots over the same width."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.utils import CostCounter

    cs = chip_rehearsal.chip_smoke()
    cfg = wide(periods)
    fe = cfg.frontend
    with FakeTensorMode(), torch.no_grad():
        params = transformer.init_params(None, cfg, device="cpu")
        B = n if kind == "decode" else 1
        cache = transformer.init_cache(cfg, B, 4112, device="cpu")
        with CostCounter() as cc, cs.recording_plans() as plans:
            cc.hold(params)
            if kind == "decode":
                transformer.decode_step(cfg, params, cache, torch.zeros((n, 1), dtype=torch.long))
            else:
                transformer.prefill(cfg, params, {
                    "tokens": torch.zeros((1, n), dtype=torch.long),
                    "features": torch.zeros((1, fe.n_positions, fe.feature_dim))}, cache)
    return cc.costs(), plans


PASSES = [("prefill", 32), ("prefill", 3840), ("decode", 1), ("decode", 4)]


@pytest.mark.parametrize("kind,n", PASSES, ids=lambda v: str(v))
def test_every_pass_launches_what_ssm_routes_derives_at_published_width(kind, n):
    """At 1 and 2 layers each pass launches what ``ssm_routes`` derives
    for that depth (7 ``wgmma`` and 2 ``batched`` a layer, the head, and
    the projector in a prefill); scaled to 24 layers by the second layer's
    difference, 218 a prefill and 217 a decode pass, ``ssm_routes``' count
    at 24.  The projector and the head take ``wgmma``."""
    cs = chip_rehearsal.chip_smoke()
    got = {}
    for periods in (1, 2):
        costs, plans = traced(kind, n, periods)
        got[periods] = costs["routes"]["repro_torch.native_gemm"]
        assert got[periods] == cs.ssm_routes(wide(periods), n if kind == "prefill" else None)
        assert costs["ops"]["repro_torch.native_gemm"] == sum(got[periods].values())
        assert [route for route, *_ in plans[HEAD]] == ["wgmma"]
        assert [route for route, *_ in plans.get(PROJECTOR, [])] == (
            ["wgmma"] if kind == "prefill" else [])
    scaled = {r: got[1][r] + 23 * (got[2][r] - got[1][r]) for r in got[1]}
    want = PER_PREFILL if kind == "prefill" else PER_DECODE
    assert scaled == cs.ssm_routes(wide(), n if kind == "prefill" else None) == want


def test_the_projector_is_counted_in_a_prefill_only():
    """``ssm_routes`` adds the frontend's projection to a prefill of a
    stack with a frontend, and nothing to a stack without one (granite's
    counts stay 97 and 32 a pass)."""
    cs = chip_rehearsal.chip_smoke()
    cfg = wide()
    assert cs.ssm_routes(cfg, 64) == PER_PREFILL and cs.ssm_routes(cfg) == PER_DECODE
    assert cs.ssm_routes(cfg.with_(frontend=None), 64) == PER_DECODE
    granite = get_config("granite-20b", n_periods=16)
    assert cs.ssm_routes(granite, 512) == cs.ssm_routes(granite) == {"wgmma": 97, "batched": 32}


def test_the_phases_requests_and_cache_width():
    """8 requests alone of 32-3840 text tokens and a batch of 4 of 1024,
    each with its own 256 x 1024 image, 16 new tokens: 4112 cache rows
    (the longest prompt's 4096 positions and 16, a multiple of 16) for
    every request; the f32 masters 1.892B params with the projector."""
    cs = chip_rehearsal.chip_smoke()
    spec, cfg = cs.VLM_SERVE, wide()
    batches = cs.vlm_traffic(cfg, 0, spec)
    assert [len(b) for b in batches] == [1] * 8 + [4]
    assert [len(b[0].prompt) for b in batches[:-1]] == list(spec["prompts"])
    assert {len(r.prompt) for r in batches[-1]} == {1024}
    assert len({r.rid for b in batches for r in b}) == 12
    assert all(r.features.shape == (256, 1024) and r.features.dtype == np.float32
               for b in batches for r in b)
    assert -(-(256 + max(spec["prompts"]) + spec["max_new"]) // 16) * 16 == 4112
    assert cfg.vocab_size == 92672
    assert round((cfg.param_count() + 1024 * cfg.d_model) / 1e9, 3) == 1.892


# ------------------------------------------------- phase 30 on the CPU
def test_phase_30_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.internvl2_serve_path`` at the reduced widths in bf16 (2
    periods, 256 patch positions of 128 features), requests alone of 8-40
    text tokens and a batch of 4 of 16, 4 new tokens each, card-only calls
    stubbed: every check passes; every prefill launches 20 (16 ``wgmma``,
    the projector among them, and 4 ``batched``) and every decode pass 19,
    as ``ssm_routes`` derives; the batch's 16 rows are held to its
    requests alone."""
    import repro_torch.configs as configs

    cs = chip_rehearsal.chip_smoke()
    real_get = configs.get_config

    def shrunk(arch, **kw):
        cfg = real_get(arch, **kw)
        return cfg.with_(frontend=dataclasses.replace(cfg.frontend, feature_dim=FEATURES),
                         **{k: v for k, v in REDUCED.items() if k != "dtype"})

    monkeypatch.setattr(configs, "get_config", shrunk)
    monkeypatch.setattr(cs, "VLM_SERVE", dict(cs.VLM_SERVE, prompts=(8, 16, 24, 40), max_new=4,
                                              batch_prompt=16))
    counters, profiled = chip_rehearsal.card_stubbed(monkeypatch, cs)
    rec = cs.internvl2_serve_path(torch.device("cpu"), 0, counters)
    assert rec["prefill_launches_by_route"] == {"wgmma": 16, "batched": 4}
    assert rec["decode_launches_by_route"] == {"wgmma": 15, "batched": 4}
    assert rec["prefills"] == 5 and rec["decode_passes"] == 15
    assert rec["launches"] == 20 * 5 + 19 * 15
    assert rec["projector"]["routes"] == {"wgmma": 1}
    assert rec["batch_vs_alone"]["rows"] == 16
    assert len(profiled) == 4
