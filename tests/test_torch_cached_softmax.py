"""A serving runtime takes every cached attention row's softmax at one
width, its ``max_len`` rounded up to a multiple of 16.

A cached row is as wide as its cache: the unpaged runtime's slot cache
(``max_len`` rows) or a page view of the page pool (a lattice width).
Masked keys are exact zeros after the softmax, but PyTorch's CUDA softmax
sums a row in an order that depends on its width, so the same request
served at two widths got other bits, and on the card the paged runtime
gave other greedy tokens than the unpaged one (gemma2-27b at published
width: the 511-token prompt on a 512-row page view against the 8208-row
slot cache).  The runtime runs its model steps under
``layers.cached_rows(max_len)``, which pads a narrower row with masked
keys and cuts a wider one.

- On the CPU: within a runtime, paged or unpaged, every softmax of a
  prefill or decode pass runs over that one width; outside one, a cached
  row keeps its cache's width and ``forward`` (no cache) its own length;
  padding and cutting leave the values.
- On the card (``gpu``): one layer's output for the same keys is bit for
  bit the same at every cache width, from 64 rows to wider than the
  runtime's width, at a ``max_len`` of 8208 (gemma2's slot cache) and of
  32786 (past 32k, no multiple of 4), in a prefill chunk and a decode row.
  No JAX here: the card's machine collects this file.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers, transformer
from repro_torch.runtime.engine import ServingRuntime
from repro_torch.runtime.scheduler import Request

torch.set_num_threads(1)

ARCH = "gemma2-27b"


def small(**kw):
    return get_config(ARCH, smoke=True, n_periods=1, **kw)


@pytest.fixture
def widths(monkeypatch):
    """The key widths of every ``torch.softmax`` call."""
    seen, real = [], torch.softmax

    def recording(x, dim=None, **kw):
        seen.append(x.shape[-1])
        return real(x, dim=dim, **kw)

    monkeypatch.setattr(torch, "softmax", recording)
    return seen


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
def test_a_runtime_takes_every_cached_row_at_its_width(widths, paged):
    """``max_len`` 30 (32 keys), chunks of up to 4, paged off 4-row pages
    (views 4 to 32 rows wide): prompts of 3 to 17 tokens, 6 new each."""
    cfg = small()
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    rt = ServingRuntime(cfg, params, slots=2, max_len=30, prefill_chunk=4, precompile=False,
                        **(dict(paged=True, page_size=4) if paged else {}))
    gen = torch.Generator().manual_seed(1)
    reqs = [Request(rid=i, prompt=torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy(),
                    max_new_tokens=6) for i, n in enumerate((3, 9, 17))]
    rt.serve(reqs)
    assert all(r.done and len(r.output) == 6 for r in reqs)
    assert widths and set(widths) == {32}


def test_outside_a_runtime_a_row_takes_its_cache_width(widths):
    cfg = small()
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 12), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, cache = transformer.prefill(cfg, params, {"tokens": toks},
                                       transformer.init_cache(cfg, 1, 40, device="cpu"))
        transformer.decode_step(cfg, params, cache, toks[:, :1])
        assert widths == [40] * 4
        widths.clear()
        with layers.cached_rows(40):
            transformer.decode_step(cfg, params, cache, toks[:, :1])
        assert widths == [48] * 2
        widths.clear()
        transformer.forward(cfg, params, {"tokens": toks})
    assert widths == [12, 12]


def one_layer(cfg, p, x, width, S, dev="cpu"):
    """One layer's output for ``x``'s last ``S`` rows after its rows before
    filled a cache of ``width`` rows (a window of 32 keys)."""
    dt = x.dtype
    n = x.shape[1] - S
    cache = {"k": torch.zeros(1, width, cfg.n_kv_heads, cfg.hd, dtype=dt, device=dev),
             "v": torch.zeros(1, width, cfg.n_kv_heads, cfg.hd, dtype=dt, device=dev),
             "length": torch.zeros((), dtype=torch.int32, device=dev)}
    with torch.no_grad():
        _, cache = layers.attention(cfg, p, x[:, :n], positions=torch.arange(n, device=dev),
                                    window=32, kv_cache=cache)
        out, _ = layers.attention(cfg, p, x[:, n:], positions=torch.arange(n, n + S, device=dev),
                                  window=32, kv_cache=cache)
    return out


@pytest.mark.parametrize("S", [1, 7])
def test_padding_and_cutting_leave_the_values(S):
    """Float32 on the CPU: 60 cached keys and ``S`` new rows under
    ``cached_rows(100)`` (112 keys) at cache widths 80 (padded), 112 and
    130 (cut), against the row at its own width 130, within 1e-6 of the
    largest magnitude."""
    cfg = small()
    gen = torch.Generator().manual_seed(2)
    p = layers.init_attn(gen, cfg, device="cpu")
    x = torch.randn(1, 60 + S, cfg.d_model, generator=gen)
    want = one_layer(cfg, p, x, 130, S)
    with layers.cached_rows(100):
        for width in (80, 112, 130):
            got = one_layer(cfg, p, x, width, S)
            assert (got - want).abs().max() <= 1e-6 * want.abs().max(), width


@pytest.mark.gpu
@pytest.mark.parametrize("max_len,widths", [
    (8208, (512, 4096, 8208, 8224)),
    (32786, (8208, 16400, 32784, 32800, 32816)),
], ids=["8208", "32786"])
@pytest.mark.parametrize("S", [1, 64])
def test_a_request_gets_the_same_bits_at_any_cache_width(S, max_len, widths):
    """bf16 on the kernel backend, GQA 2:1 at head_dim 128: 60 cached keys
    and ``S`` new rows (a decode row, a prefill chunk) through one layer
    under ``cached_rows(max_len)``, at cache widths from ``64 + S`` (a page
    view of 4 pages) to wider than the runtime's width: bit for bit the
    same output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    cfg = small(d_model=256, n_heads=4, n_kv_heads=2, head_dim=128, dtype="bfloat16",
                contract_backend="kernel", contract_strategy="native")
    gen = torch.Generator(device="cuda").manual_seed(3)
    p = layers.init_attn(gen, cfg)
    x = torch.randn(1, 60 + S, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    with layers.cached_rows(max_len):
        outs = {w: one_layer(cfg, p, x, w, S, "cuda") for w in (64 + S, *widths)}
    want = outs.pop(widths[-1])
    for width, out in outs.items():
        assert torch.equal(out, want), width
