"""The port's model zoo (``repro_torch.models``) against the JAX package's
(``repro.models``), on the same weights and inputs.

The JAX package's ``init_params`` tree crosses as numpy arrays through
``repro_torch.interop.params_from_numpy``; tokens, features and
activations are drawn with numpy.  Every smoke architecture's forward
logits, aux and ``lm_loss``, and (decoders) prefill plus three decode
steps, must match the JAX ``xla`` backend within 1e-4 of the largest
magnitude, on the port's ``torch`` backend and on its ``kernel`` backend
(whose wrapper takes ``native_gemm``'s plain version for CPU tensors).
For the models with SSM layers the JAX side prefills token by token
through its ``decode_step`` (its own ``prefill`` folds the prompt into the
last token; ``tests/test_torch_ssm_prefill.py`` pins that).
Then the paths the smoke configs do not reach (int8 KV cache, chunked
attention, a gemma2 window shorter than the sequence, capacity drops,
top-k ties), the port's own invariants, and one architecture through the
JAX package's ``pallas`` backend (interpret mode)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import LayerSpec as JLayerSpec
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import LayerSpec
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe, transformer
from repro_torch.models.ssm import init_mamba, init_ssm_cache, mamba_decode_step, mamba_mixer
from repro_torch.models.tree import tree_map

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

#: float32 smoke configs: the two packages differ by summation order only
TOL = 1e-4
DECODERS = [a for a in list_archs() if not get_config(a, smoke=True).encoder_only]


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    """The JAX side compiles many programs here; drop them when the module
    ends, so later timing-sensitive tests in the same worker run as alone."""
    yield
    jax.clear_caches()


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(arch, **overrides):
    """The JAX package's and the port's smoke config of ``arch``."""
    return (jget_config(arch, smoke=True, **overrides),
            get_config(arch, smoke=True, **overrides))


def jax_params(jcfg, seed=0):
    return jtransformer.init_params(jax.random.PRNGKey(seed), jcfg)


def carried_params(jcfg, tcfg, seed=0):
    jp = jax_params(jcfg, seed)
    return jp, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), "cpu")


def smoke_batch(cfg, B=2, S=16, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend is not None:
        n = S if cfg.frontend.kind == "audio" else cfg.frontend.n_positions
        batch["features"] = rng.standard_normal((B, n, cfg.frontend.feature_dim)).astype(np.float32)
        batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return batch


def both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


_FORWARD = {}


def jax_forward(arch):
    """The JAX package's forward and loss of ``arch``, once per module."""
    if arch not in _FORWARD:
        jcfg, tcfg = configs(arch)
        jp, tp = carried_params(jcfg, tcfg)
        jb, tb = both(smoke_batch(jcfg))
        (logits, aux), (loss, parts) = jax.jit(lambda p, b: (
            jtransformer.forward(jcfg, p, b), jtransformer.lm_loss(jcfg, p, b)))(jp, jb)
        _FORWARD[arch] = (tcfg, tp, tb, np.asarray(logits),
                          {k: float(v) for k, v in aux.items()},
                          float(loss), {k: float(v) for k, v in parts.items()})
    return _FORWARD[arch]


# ------------------------------------------------------------ configs/params
def test_params_from_numpy_checks_every_leaf():
    jcfg, tcfg = configs("qwen2-moe-a2.7b")
    jp = jax.tree.map(np.asarray, jax_params(jcfg))
    tp = params_from_numpy(tcfg, jp, "cpu")
    assert np.array_equal(tp["pattern"][0]["moe"]["wi"].numpy(), jp["pattern"][0]["moe"]["wi"])
    bad = dict(jp, embed=jp["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(tcfg, bad, "cpu")
    with pytest.raises(ValueError, match="paths differ"):
        params_from_numpy(tcfg, {k: v for k, v in jp.items() if k != "lm_head"}, "cpu")
    with pytest.raises(ValueError, match="float32"):
        params_from_numpy(tcfg, dict(jp, embed=jp["embed"].astype(np.float64)), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_numpy(tcfg, jp)           # the card is the default


def test_bfloat16_params_cross_as_bits():
    jcfg, tcfg = configs("minicpm-2b", n_periods=1, param_dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jax_params(jcfg))
    assert jp["embed"].dtype.name == "bfloat16"
    tp = params_from_numpy(tcfg, jp, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].view(torch.int16).numpy(),
                                  jp["embed"].view(np.int16))


def test_port_init_params_tree_matches_jax():
    """The port draws its own weights from a ``torch.Generator``: the same
    tree (paths, shapes, dtypes) as the JAX package's, with the scales the
    JAX package gives each leaf."""
    jcfg, tcfg = configs("jamba-v0.1-52b")
    jp = jax.tree.map(np.asarray, jax_params(jcfg))
    tp = transformer.init_params(torch.Generator().manual_seed(0), tcfg)
    params_from_numpy(tcfg, jp, "cpu")            # the check passes on the JAX tree ...
    for name in ("embed", "lm_head"):             # ... and the draws have its scales
        assert np.std(jp[name]) == pytest.approx(tp[name].std().item(), rel=0.05)
    with pytest.raises(ValueError, match="generator or a device"):
        transformer.init_params(None, tcfg)


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("arch", list_archs())
def test_forward_and_loss_match_jax(arch, backend):
    tcfg, tp, tb, want, want_aux, want_loss, want_parts = jax_forward(arch)
    cfg = tcfg.with_(contract_backend=backend)
    logits, aux = transformer.forward(cfg, tp, tb)
    assert rel_err(logits, want) <= TOL
    assert aux.keys() == want_aux.keys()
    for k, v in aux.items():
        assert float(v) == pytest.approx(want_aux[k], rel=TOL, abs=TOL), k
    loss, parts = transformer.lm_loss(cfg, tp, tb)
    assert float(loss) == pytest.approx(want_loss, rel=TOL)
    assert parts.keys() == want_parts.keys()
    assert float(parts["ce_loss"]) == pytest.approx(want_parts["ce_loss"], rel=TOL)


# --------------------------------------------------------- prefill + decode
def prefill_decode(pkg, cfg, params, prompt, steps, cache, jax_prefill=None):
    """Last logits of a prefill of ``prompt`` (a dict of numpy arrays)
    and of ``steps`` greedy decode steps after it, as numpy.  On the JAX
    side ``jax_prefill`` replaces the package's ``prefill``."""
    run_prefill = functools.partial(jax_prefill or pkg.prefill, cfg)
    run_decode = functools.partial(pkg.decode_step, cfg)
    if pkg is jtransformer:
        arr, argmax = jnp.asarray, lambda x: jnp.argmax(x, -1)[:, None]
        run_prefill, run_decode = jax.jit(run_prefill), jax.jit(run_decode)
    else:
        arr, argmax = torch.from_numpy, lambda x: torch.argmax(x, -1)[:, None]
    batch = {k: arr(v) for k, v in prompt.items()}
    logits, cache = run_prefill(params, batch, cache)
    out = [np.asarray(logits)]
    for _ in range(steps):
        logits, cache = run_decode(params, cache, argmax(logits))
        out.append(np.asarray(logits))
    return out, cache


def jax_prefill_by_steps(cfg, params, batch, cache):
    """The JAX oracle of an SSM model's prefill: its ``decode_step`` over
    the prompt one token at a time.  (The JAX package's ``prefill`` sends
    a cached SSM call to the one-token step, which folds the prompt into
    its last token; the port's prefill runs the SSD over the prompt.)"""
    for t in range(batch["tokens"].shape[1]):
        logits, cache = jtransformer.decode_step(cfg, params, cache, batch["tokens"][:, t:t + 1])
    return logits, cache


def has_ssm(cfg) -> bool:
    return any(s.mixer == "mamba" for s in tuple(cfg.prefix) + tuple(cfg.pattern))


def check_prefill_decode(jcfg, tcfg, backends=("torch", "kernel"), S=12, steps=3):
    jp, tp = carried_params(jcfg, tcfg)
    prompt = smoke_batch(jcfg, S=S, seed=3)            # a vision model's patches too
    prompt.pop("labels", None)
    want, _ = prefill_decode(jtransformer, jcfg, jp, prompt, steps,
                             jtransformer.init_cache(jcfg, 2, 32),
                             jax_prefill=jax_prefill_by_steps if has_ssm(jcfg) else None)
    for backend in backends:
        cfg = tcfg.with_(contract_backend=backend)
        got, _ = prefill_decode(transformer, cfg, tp, prompt, steps,
                                transformer.init_cache(cfg, 2, 32, device="cpu"))
        for i, (g, w) in enumerate(zip(got, want)):
            assert rel_err(g, w) <= TOL, (backend, i)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_matches_jax(arch):
    check_prefill_decode(*configs(arch, n_periods=1))


def test_int8_kv_cache_matches_jax():
    check_prefill_decode(*configs("internlm2-20b", n_periods=1, kv_quant=True))


def test_gemma2_window_shorter_than_the_sequence_matches_jax():
    """gemma2's local layer with a window of 5 over 12 prompt tokens and
    3 decode steps, and both softcaps."""
    specs = [dict(mixer="attn", ff="dense", window=5),
             dict(mixer="attn", ff="dense", window=None)]
    jcfg = jget_config("gemma2-27b", smoke=True, n_periods=1,
                       pattern=tuple(JLayerSpec(**s) for s in specs))
    tcfg = get_config("gemma2-27b", smoke=True, n_periods=1,
                      pattern=tuple(LayerSpec(**s) for s in specs))
    assert tcfg.attn_softcap and tcfg.final_softcap
    check_prefill_decode(jcfg, tcfg)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_chunked_attention_matches_jax(backend):
    """``attn_impl="chunked"`` with S = 40 over chunks of 16: two full
    chunks and a padded third."""
    jcfg, tcfg = configs("granite-20b", n_periods=1, attn_impl="chunked", attn_chunk=16)
    jp, tp = carried_params(jcfg, tcfg)
    jb, tb = both(smoke_batch(jcfg, S=40))
    want, _ = jtransformer.forward(jcfg, jp, jb)
    got, _ = transformer.forward(tcfg.with_(contract_backend=backend), tp, tb)
    assert rel_err(got, want) <= TOL
    dense_, _ = transformer.forward(tcfg.with_(attn_impl="dense"), tp, tb)
    assert rel_err(got, dense_) > 0          # the chunked path really ran


# --------------------------------------------------------------------- MoE
def test_top_k_takes_ties_in_index_order_like_jax():
    rng = np.random.default_rng(0)
    gates = rng.integers(0, 3, (5, 7, 8)).astype(np.float32) / 4   # many ties
    jw, je = jax.lax.top_k(jnp.asarray(gates), 3)
    tw, te = moe.top_k(torch.from_numpy(gates), 3)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_capacity_dropping_moe_matches_jax(backend):
    """Capacity 2 over 32 tokens in one group: most tokens are dropped.
    The routing indices must agree before the outputs are compared."""
    jcfg, tcfg = configs("qwen2-moe-a2.7b", n_periods=1)
    jp, tp = carried_params(jcfg, tcfg)
    jm, tm = jp["pattern"][0]["moe"], tp["pattern"][0]["moe"]
    jm, tm = jax.tree.map(lambda p: p[0], jm), tree_map(lambda p: p[0], tm)
    x = np.random.default_rng(5).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    gates = jax.nn.softmax(jnp.asarray(x.reshape(1, 32, -1)) @ jm["router"], -1)
    _, je = jax.lax.top_k(gates, jcfg.moe.top_k)
    _, te = moe.top_k(torch.softmax(torch.from_numpy(x.reshape(1, 32, -1)) @ tm["router"], -1),
                      tcfg.moe.top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    want, want_aux = jmoe.moe_ffn(jcfg, jm, jnp.asarray(x), capacity=2)
    got, aux = moe.moe_ffn(tcfg.with_(contract_backend=backend), tm, torch.from_numpy(x),
                           capacity=2)
    assert rel_err(got, want) <= TOL
    for k in want_aux:
        assert float(aux[k]) == pytest.approx(float(want_aux[k]), rel=TOL)
    full, _ = moe.moe_ffn(tcfg, tm, torch.from_numpy(x))
    assert rel_err(got, full) > 1e-3          # capacity 2 really dropped tokens


# --------------------------------------------------------- port invariants
def test_ssd_chunked_matches_recurrent():
    """The port's SSD chunked form equals its step-by-step recurrence."""
    cfg = get_config("mamba2-1.3b", smoke=True, n_periods=1)
    p = init_mamba(torch.Generator().manual_seed(0), cfg)
    B, L = 2, 48  # not a multiple of chunk=16 → exercises chunk fallback
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, L, cfg.d_model))
                         .astype(np.float32) * 0.5)
    y_chunk, _ = mamba_mixer(cfg, p, x)
    cache = init_ssm_cache(cfg, B, torch.float32, device="cpu")
    ys = []
    for t in range(L):
        yt, cache = mamba_decode_step(cfg, p, x[:, t : t + 1], cache)
        ys.append(yt)
    torch.testing.assert_close(y_chunk, torch.cat(ys, dim=1), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["internlm2-20b", "gemma2-27b", "mamba2-1.3b"])
def test_prefill_then_decode_equals_forward(arch):
    """Prefill of 8 tokens then 4 decode steps give the forward's logits
    at positions 7..11 (mamba2: the SSD over the prompt, then the
    recurrent step).  (Not for MoE: the forward routes all tokens as one
    dispatch group, a decode step its own tokens, so capacity drops
    differ.)"""
    cfg = get_config(arch, smoke=True)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)))
    full, _ = transformer.forward(cfg, params, {"tokens": toks})
    logits, cache = transformer.prefill(cfg, params, {"tokens": toks[:, :8]},
                                        transformer.init_cache(cfg, 2, 16, device="cpu"))
    torch.testing.assert_close(logits, full[:, 7], rtol=2e-3, atol=2e-3)
    for t in range(8, 12):
        logits, cache = transformer.decode_step(cfg, params, cache, toks[:, t : t + 1])
        torch.testing.assert_close(logits, full[:, t], rtol=2e-3, atol=2e-3)


def test_remat_checkpoints_periods_under_autograd():
    """``remat`` changes nothing in value; under autograd it recomputes
    each period in the backward pass, and the gradients agree."""
    cfg = get_config("minicpm-2b", smoke=True)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8)))
    grads = []
    for remat in (True, False):
        w = params["pattern"][0]["mlp"]["wi"].clone().requires_grad_()
        p = dict(params, pattern=[dict(params["pattern"][0],
                                       mlp=dict(params["pattern"][0]["mlp"], wi=w))])
        loss, _ = transformer.lm_loss(cfg, p, {"tokens": toks}, remat=remat)
        loss.backward()
        grads.append((loss.detach(), w.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0])
    torch.testing.assert_close(grads[0][1], grads[1][1])


# ------------------------------------------------------------ pallas backend
def test_kernel_backend_matches_jax_pallas_backend():
    """The JAX package's ``pallas`` backend (its kernels in interpret mode)
    against the port's ``kernel`` backend, at one period and 8 tokens."""
    jcfg, tcfg = configs("minicpm-2b", n_periods=1, contract_backend="xla")
    jcfg = jcfg.with_(contract_backend="pallas")
    jp, tp = carried_params(jcfg, tcfg)
    jb, tb = both(smoke_batch(jcfg, B=1, S=8))
    want, _ = jtransformer.forward(jcfg, jp, jb)
    got, _ = transformer.forward(tcfg.with_(contract_backend="kernel"), tp, tb)
    assert rel_err(got, want) <= TOL
