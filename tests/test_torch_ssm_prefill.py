"""The port's cached SSM prefill (``repro_torch.models.ssm.mamba_mixer``
with a cache and more than one token) against the JAX package's model.

A cached prefill runs the chunked SSD over the whole prompt, starting
from the cache's conv window and state, so it must compute what the JAX
package's ``forward`` gives at the last position and what its
token-by-token ``decode_step`` loop leaves in the cache: logits, conv
windows, states (and jamba's attention KV), within 1e-4 of the largest
magnitude (float32 smoke configs, both backends).  Prompt lengths 16
(one chunk), 37 (prime: chunks of 1), 40 (chunks of 10) and 48 (three
chunks of 16).

jamba's smoke MoE drops tokens at these lengths when a prompt routes as
one dispatch group (the forward's and the prefill's routing) and none
when each token routes alone (the decode loop's).  Its prefill is held to
the JAX forward as it stands, and to the decode loop at a capacity
factor under which neither routing drops a token.

The JAX package's own prefill sends every cached call to its one-token
step, which folds the prompt into its last token; one test pins that
deviation of the reference, which the port does not copy."""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe, transformer
from repro_torch.models.ssm import init_ssm_cache, mamba_decode_step, mamba_mixer
from repro_torch.models.tree import tree_leaves_with_path, tree_map
from repro_torch.runtime.engine import ServingRuntime
from repro_torch.runtime.scheduler import Request

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

#: float32 smoke configs: the two packages differ by summation order only
TOL = 1e-4
LENGTHS = (16, 37, 40, 48)
#: the smoke MoE's capacity factor under which no token drops: a group of
#: t tokens gets int(2.0 · top_k · t / n_experts) + 1 = t + 1 slots an expert
NO_DROP = 2.0
PERIODS = {"mamba2-1.3b": 2, "jamba-v0.1-52b": 1}


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(arch, capacity_factor=None):
    """The JAX package's and the port's smoke config of ``arch``, MoE
    capacity factor changed where given."""
    jcfg = jget_config(arch, smoke=True, n_periods=PERIODS[arch])
    tcfg = get_config(arch, smoke=True, n_periods=PERIODS[arch])
    if capacity_factor is not None:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


_PARAMS = {}


def carried(arch, capacity_factor=None):
    """Configs and the same weights in both packages, once per config."""
    key = (arch, capacity_factor)
    if key not in _PARAMS:
        jcfg, tcfg = configs(arch, capacity_factor)
        jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
        _PARAMS[key] = (jcfg, tcfg, jp,
                        params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[key]


def prompt(cfg, L, B=2, seed=None):
    rng = np.random.default_rng(L if seed is None else seed)
    return rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)


def jax_decode_loop(jcfg, jp, toks, max_len=64):
    """The JAX package's ``decode_step`` over the prompt one token at a
    time: the last logits and the cache."""
    step = jax.jit(functools.partial(jtransformer.decode_step, jcfg))
    cache = jtransformer.init_cache(jcfg, toks.shape[0], max_len)
    for t in range(toks.shape[1]):
        logits, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1]))
    return np.asarray(logits), jax.tree.map(np.asarray, cache)


_JAX = {}


def jax_oracles(arch, L, capacity_factor=None):
    """The JAX forward's last-position logits and the decode loop's logits
    and cache on the ``L``-token prompt, once per case."""
    key = (arch, L, capacity_factor)
    if key not in _JAX:
        jcfg, _, jp, _ = carried(arch, capacity_factor)
        toks = prompt(jcfg, L)
        logits, _ = jax.jit(functools.partial(jtransformer.forward, jcfg))(
            jp, {"tokens": jnp.asarray(toks)})
        _JAX[key] = (np.asarray(logits)[:, -1], *jax_decode_loop(jcfg, jp, toks))
    return _JAX[key]


def port_prefill(tcfg, tp, toks, cache=None):
    cache = cache if cache is not None else transformer.init_cache(tcfg, toks.shape[0], 64,
                                                                   device="cpu")
    with torch.no_grad():
        return transformer.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, cache)


def cache_errors(got, want) -> dict:
    """Each cache leaf's error over the largest magnitude of the JAX leaf,
    keyed by path; lengths must be equal."""
    want = dict(tree_leaves_with_path(want))
    got = dict(tree_leaves_with_path(got))
    assert got.keys() == want.keys()
    errs = {}
    for path, leaf in got.items():
        if path[-1] == "length":
            assert np.array_equal(leaf.numpy(), want[path]), path
        else:
            errs[path] = rel_err(leaf, want[path])
    return errs


@contextlib.contextmanager
def dropped_tokens():
    """Within the block ``moe._dispatch_tensors`` counts, into the list it
    yields, the tokens that lost a slot to capacity in each call."""
    real, counts = moe._dispatch_tensors, []

    def count(gates, top_w, top_e, n_experts, capacity):
        dispatch, combine = real(gates, top_w, top_e, n_experts, capacity)
        counts.append(int((dispatch.sum((-1, -2)) < top_e.shape[-1]).sum()))
        return dispatch, combine

    moe._dispatch_tensors = count
    try:
        yield counts
    finally:
        moe._dispatch_tensors = real


# ------------------------------------------------- prefill against the JAX model
CASES = [("mamba2-1.3b", None), ("jamba-v0.1-52b", NO_DROP)]


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("arch,capacity_factor", CASES, ids=[a for a, _ in CASES])
def test_cached_prefill_matches_jax_forward_and_decode_loop(arch, capacity_factor, backend, L):
    """The port's prefill of an ``L``-token prompt: its logits against the
    JAX forward's last position and the JAX decode loop's last logits,
    and every cache leaf (conv windows, states, jamba's KV) against the
    decode loop's cache."""
    jcfg, tcfg, _, tp = carried(arch, capacity_factor)
    want_fwd, want_loop, want_cache = jax_oracles(arch, L, capacity_factor)
    assert rel_err(want_loop, want_fwd) <= TOL          # the two oracles agree
    logits, cache = port_prefill(tcfg.with_(contract_backend=backend), tp, prompt(jcfg, L))
    assert rel_err(logits, want_fwd) <= TOL
    assert rel_err(logits, want_loop) <= TOL
    errs = cache_errors(cache, want_cache)
    assert {p[-1] for p in errs} >= {"conv", "state"}
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("L", LENGTHS)
def test_jamba_prefill_at_its_own_capacity_matches_jax_forward(L):
    """jamba's smoke config as it stands: the port's prefill routes the
    prompt as one dispatch group, as the JAX forward does, so the two agree
    whatever that group drops."""
    jcfg, tcfg, jp, tp = carried("jamba-v0.1-52b")
    toks = prompt(jcfg, L)
    want, _ = jax.jit(functools.partial(jtransformer.forward, jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    logits, _ = port_prefill(tcfg, tp, toks)
    assert rel_err(logits, np.asarray(want)[:, -1]) <= TOL


def test_jamba_smoke_moe_drops_tokens_in_one_group_and_none_at_no_drop_capacity():
    """Why jamba meets the decode loop at ``NO_DROP``: at its own capacity
    a prompt routed as one group drops tokens at some of these lengths,
    and at ``NO_DROP`` neither one group nor one token at a time drops."""
    _, tcfg, _, tp = carried("jamba-v0.1-52b")
    _, tcfg_n, _, tp_n = carried("jamba-v0.1-52b", NO_DROP)
    with dropped_tokens() as own:
        for L in LENGTHS:
            port_prefill(tcfg, tp, prompt(tcfg, L))
    assert sum(own) > 0
    with dropped_tokens() as none:
        for L in LENGTHS:
            toks = prompt(tcfg_n, L)
            port_prefill(tcfg_n, tp_n, toks)
            cache = transformer.init_cache(tcfg_n, 2, 64, device="cpu")
            with torch.no_grad():
                for t in range(L):
                    _, cache = transformer.decode_step(tcfg_n, tp_n, cache,
                                                       torch.from_numpy(toks[:, t:t + 1]))
    assert len(none) > 0 and sum(none) == 0


@pytest.mark.parametrize("arch,capacity_factor", CASES, ids=[a for a, _ in CASES])
def test_prompt_prefilled_in_two_parts_equals_the_whole_prefill(arch, capacity_factor):
    """20 tokens then 28 (chunks of 10, then of 14) continue the conv
    window and the state: the same logits and cache as the 48-token
    prefill."""
    _, tcfg, _, tp = carried(arch, capacity_factor)
    toks = prompt(tcfg, 48)
    want, want_cache = port_prefill(tcfg, tp, toks)
    _, cache = port_prefill(tcfg, tp, toks[:, :20])
    got, cache = port_prefill(tcfg, tp, toks[:, 20:], cache)
    assert rel_err(got, want) <= TOL
    errs = cache_errors(cache, tree_map(lambda t: t.numpy(), want_cache))
    assert max(errs.values()) <= TOL, errs


def test_single_token_cached_call_is_the_recurrent_step():
    """One token with a cache takes ``mamba_decode_step``: the decode bits
    are those of the recurrent step."""
    cfg = get_config("mamba2-1.3b", smoke=True, n_periods=1)
    p = tree_map(lambda t: t[0], transformer.init_params(
        torch.Generator().manual_seed(0), cfg)["pattern"][0]["mamba"])
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 1, cfg.d_model, generator=gen)
    cache = init_ssm_cache(cfg, 3, torch.float32, device="cpu")
    cache = tree_map(lambda t: torch.randn(t.shape, generator=gen), cache)
    got, got_cache = mamba_mixer(cfg, p, x, kv_cache=cache)
    want, want_cache = mamba_decode_step(cfg, p, x, cache)
    assert torch.equal(got, want)
    assert all(torch.equal(got_cache[k], want_cache[k]) for k in ("conv", "state"))


def test_serving_runtime_gives_the_jax_forward_greedy_tokens():
    """mamba2 through ``ServingRuntime`` (whole-prompt prefill, 2 slots):
    each request's greedy tokens are the argmax of the JAX forward re-run
    over its prompt and the tokens before."""
    jcfg, tcfg, jp, tp = carried("mamba2-1.3b")
    rng = np.random.default_rng(11)
    lens, max_new = (16, 37, 40, 5), 6
    reqs = [Request(rid=i, prompt=rng.integers(0, jcfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=max_new) for i, n in enumerate(lens)]
    out = ServingRuntime(tcfg, tp, slots=2, max_len=64, precompile=False).serve(reqs)
    forward = jax.jit(functools.partial(jtransformer.forward, jcfg))
    for r in out:
        assert r.done and len(r.output) == max_new
        seq = np.concatenate([r.prompt, np.asarray(r.output[:-1], np.int32)])
        logits, _ = forward(jp, {"tokens": jnp.asarray(seq[None])})
        want = np.argmax(np.asarray(logits)[0, len(r.prompt) - 1:], -1)
        assert list(want) == list(r.output), r.rid


def test_jax_prefill_folds_the_prompt_into_its_last_token():
    """The reference's deviation, pinned: the JAX package's cached prefill
    of a 16-token prompt takes the recurrent one-token step, so its logits
    differ from its own decode loop's (and forward's) by more than a tenth
    of the largest logit."""
    jcfg, _, jp, _ = carried("mamba2-1.3b")
    toks = prompt(jcfg, 16)
    folded, _ = jax.jit(functools.partial(jtransformer.prefill, jcfg))(
        jp, {"tokens": jnp.asarray(toks)}, jtransformer.init_cache(jcfg, 2, 64))
    _, loop, _ = jax_oracles("mamba2-1.3b", 16)
    assert rel_err(np.asarray(folded), loop) > 0.1
