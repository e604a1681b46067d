"""The port's flash attention (``kernels/flash_attn.py``) against the JAX
package's Pallas kernel, on the same numpy inputs.

The JAX kernel runs in interpret mode with the ``blocks`` of its own tests
(TPU tiles, which the port's wrapper does not take); the port's wrapper
takes its plain version on the CPU.  Tolerances are the
JAX tests': 2e-5 for float32, 2e-2 for bfloat16 (in interpret mode the JAX
kernel upcasts bfloat16 to float32, so its ``p`` is not rounded to bfloat16
before ``P·V``; the port's plain version rounds it, as the TPU and CUDA
kernels do).  The wrapper's route choice (``wgmma`` or ``fma``) is a plain
function of dtype, shape, strides and pointers, tested here on CPU
tensors.  The CUDA kernels are held against the plain version on the card
by ``chip_smoke.py`` and by the ``gpu``-marked test below."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as jflash
from repro_torch import interop
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels.flash_attn import (
    flash_attention, flash_attention_ref, flash_route, fma_tiles, wgmma_tiles)

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    """The JAX side compiles many programs here; drop them when the module
    ends, so later timing-sensitive tests in the same worker run as alone."""
    yield
    jax.clear_caches()


TOL = {"f32": 2e-5, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# tests/test_flash_attn.py's SHAPES: (bh, s, t, block, d)
SHAPES = [
    (2, 64, 64, 64, 16),     # aligned, S == T
    (1, 96, 96, 32, 16),     # ragged blocks
    (3, 128, 256, 64, 32),   # cross attention T > S
    (2, 200, 200, 48, 64),   # odd sizes
]


def _qkv(rng, bh, s, t, d):
    return (rng.standard_normal((bh, s, d)).astype(np.float32),
            rng.standard_normal((bh, t, d)).astype(np.float32),
            rng.standard_normal((bh, t, d)).astype(np.float32))


def _run_both(qn, kn, vn, *, causal, dtype, blocks):
    jdt, tdt = DTYPES[dtype]
    want = jflash(*(jnp.asarray(x, jdt) for x in (qn, kn, vn)), causal=causal,
                  blocks=blocks)
    q, k, v = (t.to(tdt) for t in interop.from_numpy((qn, kn, vn), device="cpu"))
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == qn.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("bh,s,t,bq,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_matches_jax(bh, s, t, bq, d, causal, dtype):
    """The JAX tests' grid; the causal T > S case, which they skip against
    their dense oracle, is held here to JAX's top-left mask."""
    qkv = _qkv(np.random.default_rng(bh * 100 + s), bh, s, t, d)
    got, want = _run_both(*qkv, causal=causal, dtype=dtype, blocks={"q": bq, "k": bq})
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_gqa_fold_matches_jax():
    """GQA: fold (B, G, R) into BH with each q head given its kv head's K/V."""
    rng = np.random.default_rng(1)
    B, G, R, S, D = 2, 2, 3, 64, 16
    q = rng.standard_normal((B, G, R, S, D)).astype(np.float32)
    k = rng.standard_normal((B, G, S, D)).astype(np.float32)
    v = rng.standard_normal((B, G, S, D)).astype(np.float32)
    qf = q.reshape(B * G * R, S, D)
    kf = np.broadcast_to(k[:, :, None], (B, G, R, S, D)).reshape(B * G * R, S, D)
    vf = np.broadcast_to(v[:, :, None], (B, G, R, S, D)).reshape(B * G * R, S, D)
    got, want = _run_both(qf, kf, vf, causal=True, dtype="f32", blocks=None)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,t", [(40, 72), (72, 40)], ids=["t_gt_s", "t_lt_s"])
def test_causal_ragged_cross_attention_matches_jax(s, t):
    """Causal with T != S is top-left aligned (query i sees keys j <= i),
    with ragged S and T masked, not padded."""
    qkv = _qkv(np.random.default_rng(s + t), 2, s, t, 32)
    got, want = _run_both(*qkv, causal=True, dtype="f32", blocks={"q": 16, "k": 16})
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    if s > t:  # rows at or past T - 1 see every key, as in full attention
        full = flash_attention_ref(*interop.from_numpy(qkv, device="cpu"), causal=False)
        np.testing.assert_allclose(got[:, t - 1:], full[:, t - 1:].numpy(),
                                   rtol=2e-5, atol=2e-5)


def test_broadcast_kv_is_read_through_its_strides():
    """One K/V shared by every head (stride 0 along BH) gives the result of
    the materialised copy."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((6, 24, 16)).astype(np.float32))
    k1, v1 = (torch.from_numpy(rng.standard_normal((1, 24, 16)).astype(np.float32))
              for _ in range(2))
    kb, vb = k1.expand(6, 24, 16), v1.expand(6, 24, 16)
    assert kb.stride(0) == 0
    got = flash_attention(q, kb, vb)
    want = flash_attention(q, kb.contiguous(), vb.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_defaults_and_constants_equal_jax():
    assert fa._NEG_INF == -2.0**30


def test_wrapper_validates_the_launch_on_the_cpu():
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="rank-3"):
        flash_attention(x[0], x[0], x[0])
    with pytest.raises(ValueError, match="shapes disagree"):
        flash_attention(x, torch.zeros(2, 8, 8), x)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(x, x.bfloat16(), x)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(x.double(), x.double(), x.double())
    big = torch.zeros(1, 4, 264)
    with pytest.raises(ValueError, match="exceeds 256"):
        flash_attention(big, big, big)
    with pytest.raises(ValueError, match="unit stride along D"):
        flash_attention(x, torch.zeros(2, 16, 8).transpose(1, 2), x)
    with pytest.raises(TypeError, match="blocks"):
        flash_attention(x, x, x, blocks={"q": 8})
    assert fa.flash_attention.launches == 0


def test_cpu_tensor_takes_the_plain_version():
    rng = np.random.default_rng(2)
    q, k, v = interop.from_numpy(_qkv(rng, 2, 16, 16, 8), device="cpu")
    before, by_route = flash_attention.launches, dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=True)
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=True))
    assert flash_attention.launches == before
    assert flash_attention.launches_by_route == by_route
    assert set(by_route) == set(fa.ROUTES) == {"wgmma", "fma"}


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


# (q, k, v) builders and the route each layout must take
ROUTE_CASES = {
    "aligned_bf16": (lambda: (_bf16(2, 64, 128), _bf16(2, 96, 128), _bf16(2, 96, 128)),
                     "wgmma"),
    "head_dim_16": (lambda: (_bf16(3, 40, 16), _bf16(3, 72, 16), _bf16(3, 72, 16)), "wgmma"),
    "stride0_kv": (lambda: (_bf16(6, 24, 64), _bf16(1, 30, 64).expand(6, 30, 64),
                            _bf16(1, 30, 64).expand(6, 30, 64)), "wgmma"),
    "q_from_s_bh_d": (lambda: (_bf16(90, 4, 64).transpose(0, 1), _bf16(4, 90, 64),
                               _bf16(4, 90, 64)), "wgmma"),
    "single_row_any_stride": (lambda: (_bf16(96).as_strided((2, 1, 40), (48, 3, 1)),
                                       _bf16(2, 8, 40), _bf16(2, 8, 40)), "wgmma"),
    "f32": (lambda: tuple(x.float() for x in (_bf16(2, 64, 128),) * 3), "fma"),
    "head_dim_4": (lambda: (_bf16(2, 16, 4), _bf16(2, 16, 4), _bf16(2, 16, 4)), "fma"),
    "odd_row_stride": (lambda: (_bf16(2, 16, 33)[..., :32], _bf16(2, 16, 32),
                                _bf16(2, 16, 32)), "fma"),
    "head_stride_not_16_bytes": (lambda: (_bf16(260).as_strided((2, 16, 8), (132, 8, 1)),
                                          _bf16(2, 16, 8), _bf16(2, 16, 8)), "fma"),
    "misaligned_base": (lambda: (_bf16(2 * 16 * 8 + 1)[1:].view(2, 16, 8), _bf16(2, 16, 8),
                                 _bf16(2, 16, 8)), "fma"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_follows_dtype_and_layout(case):
    """bf16 that a TMA tensor map can describe takes ``wgmma``; float32
    and other bf16 layouts take ``fma``."""
    build, route = ROUTE_CASES[case]
    assert flash_route(*build()) == route


@pytest.mark.parametrize("D", [1, 16, 48, 64, 65, 100, 128, 129, 160, 200, 256])
def test_wgmma_tiles_fit_shared_memory(D):
    """The padded head dim is the next of 64/128/256, and the ring (Q
    tile, two K/V stages, barriers, alignment slack) fits the 232,448
    bytes of shared memory a Hopper block may use."""
    t = wgmma_tiles(D)
    assert t["dp"] == next(p for p in (64, 128, 256) if D <= p)
    assert t["bk"] * t["dp"] <= 128 * 128 and t["bk"] % 16 == 0
    assert t["stages"] >= 2
    assert t["smem_bytes"] <= 232_448
    assert t["smem_bytes"] >= 2 * (128 * t["dp"] + 2 * t["stages"] * t["bk"] * t["dp"])


def test_wgmma_tiles_reject_head_dims_out_of_range():
    for D in (0, 257):
        with pytest.raises(ValueError, match="head dim"):
            wgmma_tiles(D)


def test_fma_tiles_reject_head_dims_out_of_range():
    for D in (0, 257):
        with pytest.raises(ValueError, match="head dim"):
            fma_tiles(D)


def test_fma_tiles_fit_shared_memory():
    """For every head dim 1..256 the fma route's f32 tiles (Q transposed,
    K, V, P transposed) fit the 232,448 bytes a Hopper block may use, each
    thread holds rows x 4 keys of S and rows x cols of O over 256 threads,
    and the padded rows keep 16-byte alignment."""
    for D in range(1, 257):
        t = fma_tiles(D)
        assert t["dp"] == next(p for p in (64, 128, 256) if D <= p)
        assert t["bq"] == (128 if t["dp"] <= 128 else 64) and t["bk"] == 64
        assert t["rows"] * 16 == t["bq"] and t["cols"] * 16 == t["dp"]
        assert t["threads"] == 256 and t["cols"] % 4 == 0 and t["rows"] % 4 == 0
        assert t["rows"] * t["cols"] <= 64      # O accumulators per thread
        assert t["smem_bytes"] <= 232_448
        assert t["smem_bytes"] == 4 * (t["dp"] * t["bq"] + t["bk"] * (t["dp"] + 4)
                                       + t["bk"] * t["dp"] + t["bk"] * (t["bq"] + 4))
    assert fma_tiles(128)["smem_bytes"] == 165_888


def test_fma_tiles_mirror_the_cuda_source():
    """``fma_tiles`` is ``FaTile`` and the ``#define``s of
    ``csrc/flash_attn.cu``."""
    import re

    from repro_torch.kernels import _build

    text = (_build.CSRC / "flash_attn.cu").read_text()
    defs = {k: int(v) for k, v in re.findall(r"#define (FA_\w+) (\d+)\b", text)}
    assert (defs["FA_BK"], defs["FA_THREADS"]) == (fma_tiles(64)["bk"], fma_tiles(64)["threads"])
    tile = text[text.index("template <int DP> struct FaTile {"):]
    tile = tile[:tile.index("};")]
    for line in ("BQ = DP <= 128 ? 128 : 64;", "RM = BQ / 16;", "NC = DP / 16;",
                 "LDK = DP + 4;", "LDP = BQ + 4;", "Q_FLOATS = DP * BQ;",
                 "K_FLOATS = FA_BK * LDK;", "V_FLOATS = FA_BK * DP;", "P_FLOATS = FA_BK * LDP;",
                 "SMEM = 4 * (Q_FLOATS + K_FLOATS + V_FLOATS + P_FLOATS);"):
        assert f"static constexpr int {line}" in tile
    assert "if (a.D <= 64) return fa_launch_t<T, 64>" in text
    assert "if (a.D <= 128) return fa_launch_t<T, 128>" in text


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    rng = np.random.default_rng(5)
    for bh, s, t, _, d in SHAPES:
        q, k, v = interop.from_numpy(_qkv(rng, bh, s, t, d))
        for causal in (True, False):
            for dt, tol, route in ((torch.float32, 2e-5, "fma"),
                                   (torch.bfloat16, 2e-2, "wgmma")):
                args = [x.to(dt) for x in (q, k, v)]
                before = flash_attention.launches_by_route[route]
                got = flash_attention(*args, causal=causal)
                assert flash_attention.launches_by_route[route] == before + 1
                want = flash_attention_ref(*args, causal=causal)
                torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16_head_dim_4"])
def test_fma_route_matches_plain_version_at_ragged_lengths_on_the_card(dtype, tol):
    """The fma route at S and T off its 128-row (64 at D > 128) query tile
    and 64-key tile, causal and not, with scores over a wide range; bf16
    takes it at D = 4, a layout TMA cannot read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    rng = np.random.default_rng(9)
    dims = [(2, 333, 260), (3, 100, 150), (1, 129, 700)]
    for (bh, s, t), d in zip(dims, (128, 256, 64) if dtype == torch.float32 else (4, 4, 4)):
        q, k, v = (x.to(dtype) for x in interop.from_numpy(_qkv(rng, bh, s, t, d)))
        for causal in (True, False):
            assert flash_route(q, k, v) == "fma"
            before = flash_attention.launches_by_route["fma"]
            got = flash_attention(q * 8, k, v, causal=causal)
            assert flash_attention.launches_by_route["fma"] == before + 1
            want = flash_attention_ref(q * 8, k, v, causal=causal)
            err = ((got.float() - want.float()).abs().amax(-1)
                   / want.float().abs().amax(-1).clamp_min(1e-30)).max().item()
            assert err <= tol, f"{(bh, s, t, d)} causal={causal}: worst row {err}"
