"""Serving jamba-v0.1-52b with the port: the launches of its passes at
published width, and its served rows held against the JAX package.

- At published width, one period of 8 layers (the depth ``chip_smoke.py``
  serves), a prefill and a 4-slot decode pass on the kernel backend are
  traced on fake tensors under ``utils.CostCounter``: ``native_gemm``'s
  calls by route are what ``chip_smoke.ssm_routes`` derives from the
  layer pattern (every prefill 73, a decode pass 52), beside the MoE
  router's, dispatch's and combine's ``aten.bmm``; the 4096-token
  prefill's temporaries stay under 8 GB beside 53.07 GB of masters.
- On a narrow float32 config with the published ratios (GQA 4:1, 16
  experts top-2, d_state 16, headdim 64, chunk 128, the 8-layer period)
  and the JAX package's weights carried across, prompts of 131 (prime:
  chunks of 1), 200 (chunks of 100) and 256 tokens (chunks of 128), on
  the ``torch`` and ``kernel`` backends, within 1e-4 of the largest
  magnitude: the prefill ``ServingRuntime`` serves against the JAX
  ``forward``'s last position (both route a prompt as one dispatch group);
  the runtime's batched decode rows (4 slots) against a per-slot loop of
  batch-1 ``decode_step`` calls; the port's token-by-token ``decode_step``
  against the JAX package's; and every served row against the JAX decode
  loop.
- A prompt routed as one group drops tokens at the config's capacity
  factor (1.25), where a decode loop, one token a group, drops none: the
  served rows meet the JAX decode loop only at a capacity factor under
  which nothing drops (``NO_DROP``), and differ from it at 1.25.
"""

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer
from repro_torch.models.tree import tree_leaves_with_path
from repro_torch.runtime.engine import ServingRuntime
from repro_torch.runtime.scheduler import Request

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "jamba-v0.1-52b"
#: float32 on both sides: the packages differ by summation order only
TOL = 1e-4
PROMPTS = (131, 200, 256)
#: tokens fed after each prompt (drawn, so every runtime sees the same)
NEW = 6
SLOTS = 4
MAX_LEN = max(PROMPTS) + NEW
#: a capacity factor under which no group drops a token: a group of t
#: tokens gets int(8 · top_k · t / 16) + 1 = t + 1 slots an expert
NO_DROP = 8.0


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()


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
#: (prompt length or None for a 4-slot decode pass) → native_gemm calls by
#: route and aten.bmm calls (the MoE router, dispatch and combine; a decode
#: row's one-token dispatch and combine contract nothing and take no bmm)
PASSES = {
    4096: ({"wgmma": 31, "fbatched": 7, "gathered": 7, "batched": 28}, 12),
    131: ({"wgmma": 31, "fbatched": 21, "batched": 21}, 12),
    128: ({"wgmma": 31, "stream": 7, "gathered": 7, "batched": 28}, 12),
    None: ({"wgmma": 31, "batched": 21}, 8),
}


@pytest.mark.parametrize("L", list(PASSES), ids=lambda L: f"prefill{L}" if L else "decode")
def test_kernel_launches_by_route_at_published_width(L):
    """A pass of jamba-v0.1-52b at published width, one period, traced on
    fake tensors: ``native_gemm``'s calls by route are
    ``chip_smoke.ssm_routes``'s, 73 a prefill and 52 a decode pass; a
    prompt of one chunk (128) puts ``CBt`` on ``stream``, a 16-deep
    write-kind product, where more chunks make the chunk a batch mode
    (``fbatched``).  The 4096-token prefill holds 53.07 GB of masters
    and under 8 GB of temporaries."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.runtime.engine import slot_cache
    from repro_torch.utils import CostCounter

    cs = _chip_smoke()
    cfg = get_config(ARCH, n_periods=1, contract_backend="kernel",
                     contract_strategy="native")
    routes, bmm = PASSES[L]
    with FakeTensorMode(), torch.no_grad():
        params = transformer.init_params(None, cfg, device="cpu")
        if L is None:
            cache = slot_cache(cfg, SLOTS, 4112, device="cpu")
            toks = torch.zeros((SLOTS, 1), dtype=torch.long)
        else:
            cache = transformer.init_cache(cfg, 1, 4112, device="cpu")
            toks = torch.zeros((1, L), dtype=torch.long)
        with CostCounter() as cc:
            cc.hold(params)
            if L is None:
                transformer.decode_step(cfg, params, cache, toks)
            else:
                transformer.prefill(cfg, params, {"tokens": toks}, cache)
    got = cc.costs()
    assert got["routes"] == {"repro_torch.native_gemm": routes}
    assert routes == cs.ssm_routes(cfg, L)
    assert got["ops"] == {"repro_torch.native_gemm": 52 if L is None else 73, "aten.bmm": bmm}
    if L == 4096:
        assert round(got["argument_bytes"] / 1e9, 2) == 53.07
        assert got["temp_bytes"] < 8e9


# ------------------------------ parity on a narrow config, published ratios
def narrow(get, capacity_factor=None):
    """jamba's smoke config (float32, d_model 64) at the published ratios:
    8 query heads over 2 KV heads, 16 experts top-2, d_state 16, headdim
    64, chunk 128, one period of 8 layers."""
    cfg = get(ARCH, smoke=True, n_periods=1)
    extra = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    return cfg.with_(n_heads=8, n_kv_heads=2,
                     moe=dataclasses.replace(cfg.moe, n_experts=16, top_k=2, **extra),
                     ssm=dataclasses.replace(cfg.ssm, d_state=16, headdim=64, chunk=128))


@functools.cache
def carried():
    """The JAX params and the same weights in the port."""
    jcfg = narrow(jget_config)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(narrow(get_config), jax.tree.map(np.asarray, jp), "cpu")


@functools.cache
def sequences():
    """Each prompt and the tokens fed after it, drawn from a seed."""
    rng = np.random.default_rng(32)
    vocab = narrow(get_config).vocab_size
    return tuple(rng.integers(0, vocab, L + NEW).astype(np.int32) for L in PROMPTS)


@functools.cache
def jax_loop(i: int):
    """The JAX package's ``decode_step`` over sequence ``i`` one token at a
    time (``NO_DROP``; a one-token group's capacity is 4 under either
    factor): the logits after every token, and the cache after the
    prompt's last token."""
    jcfg = narrow(jget_config, NO_DROP)
    jp, _ = carried()
    step = jax.jit(functools.partial(jtransformer.decode_step, jcfg))
    seq, L = sequences()[i], PROMPTS[i]
    cache, rows = jtransformer.init_cache(jcfg, 1, MAX_LEN), []
    for t in range(len(seq)):
        logits, cache = step(jp, cache, jnp.asarray(seq[None, t:t + 1]))
        rows.append(np.asarray(logits)[0])
        if t == L - 1:
            at_prompt = jax.tree.map(np.asarray, cache)
    return np.stack(rows), at_prompt


@functools.cache
def jax_forward_last(i: int):
    """The JAX ``forward``'s last-position logits on prompt ``i`` (the
    config's own capacity)."""
    jp, _ = carried()
    seq, L = sequences()[i], PROMPTS[i]
    logits, _ = jax.jit(functools.partial(jtransformer.forward, narrow(jget_config)))(
        jp, {"tokens": jnp.asarray(seq[None, :L])})
    return np.asarray(logits)[0, -1]


def served(cfg, params):
    """The runtime's logits, ``(request, tokens generated before) → (V,)``:
    each request a prompt of :data:`PROMPTS` fed the drawn tokens after
    it, on 4 slots (a decode bucket of 4: one slot a padding duplicate)."""
    cs = _chip_smoke()
    seqs = sequences()
    reqs = [Request(rid=i, prompt=s[:L], max_new_tokens=NEW + 1)
            for i, (s, L) in enumerate(zip(seqs, PROMPTS))]
    forced = {i: [int(t) for t in s[L:]] + [0] for i, (s, L) in enumerate(zip(seqs, PROMPTS))}
    rt = ServingRuntime(cfg, params, slots=SLOTS, max_len=MAX_LEN + 1, precompile=False)
    logits = {}
    with cs.served_events(rt, logits, [], forced=forced):
        rt.serve(reqs)
    assert all(r.done for r in reqs)
    assert len(logits) == len(PROMPTS) * (NEW + 1)
    return logits


BACKENDS = ["torch", "kernel"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_served_prefill_matches_jax_forward_last_position(backend):
    """At the config's own capacity: each served prefill's logits against
    the JAX ``forward``'s last position on the prompt; both route the
    prompt as one dispatch group, so they agree whatever it drops."""
    _, tp = carried()
    logits = served(narrow(get_config).with_(contract_backend=backend), tp)
    for i, L in enumerate(PROMPTS):
        assert rel_err(logits[(i, 0)], jax_forward_last(i)) <= TOL, L


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_decode_matches_the_per_slot_loop(backend):
    """At the config's own capacity: the runtime's decode rows (every slot
    in one batched pass, each row its own dispatch group) against each
    request alone, a batch-1 prefill and then ``decode_step`` a token at a
    time on the same tokens."""
    _, tp = carried()
    cfg = narrow(get_config).with_(contract_backend=backend)
    logits = served(cfg, tp)
    with torch.no_grad():
        for i, (seq, L) in enumerate(zip(sequences(), PROMPTS)):
            toks = torch.from_numpy(seq[None].astype(np.int64))
            row, cache = transformer.prefill(cfg, tp, {"tokens": toks[:, :L]},
                                             transformer.init_cache(cfg, 1, MAX_LEN + 1,
                                                                    device="cpu"))
            assert rel_err(logits[(i, 0)], row[0]) <= TOL, (L, 0)
            for pos in range(1, NEW + 1):
                row, cache = transformer.decode_step(cfg, tp, cache,
                                                     toks[:, L + pos - 1:L + pos])
                assert rel_err(logits[(i, pos)], row[0]) <= TOL, (L, pos)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_step_token_by_token_matches_the_jax_packages(backend):
    """The port's ``decode_step`` over the 131-token prompt and the tokens
    after it, one token at a time from an empty cache: the logits after
    every token and the cache after the prompt (SSM conv windows and
    states, the attention layer's KV) against the JAX package's loop."""
    _, tp = carried()
    cfg = narrow(get_config, NO_DROP).with_(contract_backend=backend)
    seq, L = sequences()[0], PROMPTS[0]
    want, want_cache = jax_loop(0)
    cache = transformer.init_cache(cfg, 1, MAX_LEN, device="cpu")
    with torch.no_grad():
        for t in range(len(seq)):
            logits, cache = transformer.decode_step(
                cfg, tp, cache, torch.from_numpy(seq[None, t:t + 1].astype(np.int64)))
            assert rel_err(logits[0], want[t]) <= TOL, t
            if t == L - 1:
                got = dict(tree_leaves_with_path(cache))
                ref = dict(tree_leaves_with_path(want_cache))
                assert got.keys() == ref.keys()
                assert {p[-1] for p in got} >= {"conv", "state", "k", "v"}
                for path, leaf in got.items():
                    assert rel_err(leaf, ref[path]) <= TOL, path


@pytest.mark.parametrize("backend", BACKENDS)
def test_served_rows_match_the_jax_decode_loop_where_nothing_drops(backend):
    """At ``NO_DROP``: every served row, prefill and decode, against the
    JAX package's decode loop over the same tokens."""
    _, tp = carried()
    logits = served(narrow(get_config, NO_DROP).with_(contract_backend=backend), tp)
    for i, L in enumerate(PROMPTS):
        want, _ = jax_loop(i)
        for pos in range(NEW + 1):
            assert rel_err(logits[(i, pos)], want[L - 1 + pos]) <= TOL, (L, pos)


def test_a_prompt_routed_as_one_group_drops_tokens_at_its_own_capacity():
    """At capacity factor 1.25 each prompt's prefill, one dispatch group,
    drops tokens and its logits leave the JAX decode loop's by more than
    ``TOL``; at ``NO_DROP`` nothing drops, in the prefill or in a one-token
    decode group."""
    _, tp = carried()
    cs = _chip_smoke()
    for capacity_factor in (None, NO_DROP):
        cfg = narrow(get_config, capacity_factor)
        for i, (seq, L) in enumerate(zip(sequences(), PROMPTS)):
            toks = torch.from_numpy(seq[None, :L].astype(np.int64))
            with torch.no_grad(), cs.dropped_tokens() as dispatched:
                logits, cache = transformer.prefill(
                    cfg, tp, {"tokens": toks},
                    transformer.init_cache(cfg, 1, MAX_LEN, device="cpu"))
                transformer.decode_step(cfg, tp, cache, toks[:, -1:])
            # (tokens a group, lost) of 4 MoE layers' prefill, then decode
            lost = [(t, n) for t, _, n, _ in dispatched]
            assert [t for t, _ in lost] == [L] * 4 + [1] * 4
            want, _ = jax_loop(i)
            if capacity_factor is None:
                assert sum(n for _, n in lost[:4]) > 0, L
                assert rel_err(logits[0], want[L - 1]) > TOL, L
            else:
                assert sum(n for _, n in lost) == 0, L
                assert rel_err(logits[0], want[L - 1]) <= TOL, L
            assert sum(n for _, n in lost[4:]) == 0, L
