"""Transformer building blocks.

Every matmul routes through :func:`repro_torch.core.einsum.xeinsum` — the
n-ary front-end of the paper's strided-batched contraction engine — so
model compute and decomposition compute share one planned code path.
Attention's QKᵀ/PV products *are* strided-batched GEMMs (batch =
(batch, head-group)); projections are flattened GEMMs.  With
``cfg.contract_backend="kernel"`` each of them launches ``native_gemm``
on a card (its plain version on the CPU).

The port of ``repro.models.layers``.  Differences, each on purpose:

* Parameters are made from a ``torch.Generator`` (on the device that
  holds them), and each ``init_*`` takes ``lead``, a shape prepended to
  every leaf, so that blocks stacked over periods are drawn in place.
* :func:`attention` also serves a batch of independent requests: the
  cache's ``length`` may be a ``(B,)`` vector, one length per row, and
  ``positions`` then ``(B, S)``.  Each row takes its own rope positions,
  causal and valid mask, and cache write.  A scalar length is the JAX
  package's form, where every row shares one.
* The cache write is out of place (``index_put``), as
  ``jax.lax.dynamic_update_slice`` is, with the same clamp of the start
  row to ``T - S``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.einsum import xeinsum

__all__ = [
    "rms_norm", "rope", "attention", "mlp", "init_attn", "init_mlp",
    "dense", "init_dense", "softcap",
]

_NEG_INF = -2.0**30  # large-negative mask value safe in bf16


def _ctr(cfg: ModelConfig):
    return functools.partial(
        xeinsum, strategy=cfg.contract_strategy, backend=cfg.contract_backend
    )


def softcap(x, cap: float | None):
    """Gemma-2 style logit soft-capping."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------- norms
def rms_norm(x, scale, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def init_rms(gen, d, *, lead=(), device=None):
    return torch.zeros(tuple(lead) + (d,), dtype=torch.float32,
                       device=_device(gen, device))


def _device(gen, device):
    """Where a leaf is drawn: the generator's device, or ``device`` when
    there is no generator (``"meta"`` draws shapes only)."""
    return gen.device if gen is not None else torch.device(device)


def normal(gen, shape, *, device=None):
    """Standard normal float32 draws of ``shape`` from ``gen``."""
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=_device(gen, device))


# ---------------------------------------------------------------- rope
def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding on the last axis of x: (..., seq, heads, head_dim).

    ``positions`` is ``(seq,)``, or ``(batch, seq)`` for one row each."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., seq, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ projections
def dense(cfg: ModelConfig, x, w, spec: str = "bse,ef->bsf"):
    """Linear layer via the contraction engine."""
    return _ctr(cfg)(spec, x, w.to(x.dtype))


def init_dense(gen, d_in, d_out, dtype=torch.float32, scale=None, *, lead=(), device=None):
    scale = scale or d_in**-0.5
    return (normal(gen, tuple(lead) + (d_in, d_out), device=device) * scale).to(dtype)


# ------------------------------------------------------------- attention
def init_attn(gen, cfg: ModelConfig, *, lead=(), device=None):
    E, H, G, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(lead=lead, device=device)
    return {
        "wq": init_dense(gen, E, H * D, dt, **kw),
        "wk": init_dense(gen, E, G * D, dt, **kw),
        "wv": init_dense(gen, E, G * D, dt, **kw),
        "wo": init_dense(gen, H * D, E, dt, scale=(H * D) ** -0.5, **kw),
    }


def _attn_mask(q_pos, k_pos, *, causal: bool, window: int | None):
    """(q, k) boolean mask, or (batch, q, k) for per-row positions:
    True = attend."""
    rel = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        ok &= rel >= 0
    if window is not None:
        ok &= rel < window
    return ok


def _write_rows(cache, update, start):
    """``update`` (B, S, ...) written into ``cache`` (B, T, ...) from row
    ``start`` (a scalar or one per batch row) on, out of place; the start
    is clamped to ``T - S`` as ``jax.lax.dynamic_update_slice`` clamps
    it."""
    B, S = update.shape[:2]
    start = start.clamp(0, cache.shape[1] - S).long()
    rows = start[..., None] + torch.arange(S, device=cache.device)      # (S,) or (B, S)
    rows = rows.expand(B, S)
    batch = torch.arange(B, device=cache.device)[:, None].expand(B, S)
    return cache.index_put((batch, rows), update.to(cache.dtype))


def attention(
    cfg: ModelConfig,
    params,
    x,                      # (B, S, E)
    *,
    positions,              # (S,) or (B, S) token positions (rope + causal mask)
    window: int | None = None,
    kv_cache=None,          # optional dict(k=(B,T,G,D), v=..., length=() or (B,))
):
    """GQA/MQA attention.  Returns (out, new_kv_cache | None).

    QKᵀ and PV are evaluated through the engine with shared batch modes
    (b, g) — strided-batched GEMMs in the paper's sense, with the repeat
    group r of GQA riding the GEMM's free rows (granite's MQA: G=1 and the
    K/V operands are *broadcast* across q-heads — Listing 1's lo=0).
    """
    ctr = _ctr(cfg)
    B, S, E = x.shape
    H, G, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    R = H // G
    q = dense(cfg, x, params["wq"]).reshape(B, S, G, R, D)
    k = dense(cfg, x, params["wk"]).reshape(B, S, G, D)
    v = dense(cfg, x, params["wv"]).reshape(B, S, G, D)
    q = rope(q.reshape(B, S, H, D), positions, cfg.rope_theta).reshape(B, S, G, R, D)
    k = rope(k, positions, cfg.rope_theta)

    if kv_cache is not None:
        # decode: append new k/v at cache.length (one length per row, or one for all)
        T = kv_cache["k"].shape[1]
        idx = kv_cache["length"]
        if "k_scale" in kv_cache:  # int8 KV cache (per token×head scales)
            ks = torch.amax(torch.abs(k), dim=-1).float() / 127.0 + 1e-9
            vs = torch.amax(torch.abs(v), dim=-1).float() / 127.0 + 1e-9
            kq = torch.round(k.float() / ks[..., None]).to(torch.int8)
            vq = torch.round(v.float() / vs[..., None]).to(torch.int8)
            new_cache = {
                "k": _write_rows(kv_cache["k"], kq, idx),
                "v": _write_rows(kv_cache["v"], vq, idx),
                "k_scale": _write_rows(kv_cache["k_scale"], ks, idx),
                "v_scale": _write_rows(kv_cache["v_scale"], vs, idx),
                "length": idx + S,
            }
            k = (new_cache["k"].float() * new_cache["k_scale"][..., None]).to(q.dtype)
            v = (new_cache["v"].float() * new_cache["v_scale"][..., None]).to(q.dtype)
        else:
            ck = _write_rows(kv_cache["k"], k, idx)
            cv = _write_rows(kv_cache["v"], v, idx)
            k, v = ck, cv
            new_cache = {"k": ck, "v": cv, "length": idx + S}
        k_pos = torch.arange(T, device=x.device)
        valid = k_pos <= (idx + S - 1)[..., None]        # (1, T) or (B, T)
    else:
        k_pos = positions
        valid = None
        new_cache = None

    causal = cfg.causal and not cfg.encoder_only
    if cfg.attn_impl == "chunked" and kv_cache is None and S > cfg.attn_chunk:
        out = _chunked_attention(
            cfg, q, k.to(q.dtype), v.to(q.dtype), positions, k_pos,
            causal=causal, window=window,
        )
    else:
        # scores: contract over D with shared batch (b, g) — sb_gemm territory
        scores = ctr("bsgrd,btgd->bgrst", q, k.to(q.dtype))
        scores = scores.float() * (D**-0.5)
        scores = softcap(scores, cfg.attn_softcap)

        mask = _attn_mask(positions, k_pos, causal=causal, window=window)
        if valid is not None:
            mask = mask & valid[..., None, :]
        if mask.ndim == 2:
            mask = mask[None]
        scores = torch.where(mask[:, None, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)

        out = ctr("bgrst,btgd->bsgrd", probs, v.to(x.dtype))
    out = out.reshape(B, S, H * D)
    out = dense(cfg, out, params["wo"], "bsh,he->bse")
    return out, new_cache


def _chunked_attention(cfg, q, k, v, q_pos, k_pos, *, causal, window):
    """Flash-style streaming attention: loop over KV in blocks, online
    softmax.  Its two products run on the library (``strategy="direct"``
    ignores the backend), as in the JAX package.

    Live memory per layer is O(S·chunk) instead of O(S·T).
    Returns (B, S, G, R, D).
    """
    B, S, G, R, D = q.shape
    T = k.shape[1]
    Ck = cfg.attn_chunk
    pad = (-T) % Ck
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.cat([k_pos, torch.full((pad,), -(10**9), dtype=k_pos.dtype,
                                             device=k_pos.device)])
    nC = k.shape[1] // Ck
    kc = k.reshape(B, nC, Ck, G, D)
    vc = v.reshape(B, nC, Ck, G, D)
    pc = k_pos.reshape(nC, Ck)
    scale = D**-0.5

    m = torch.full((B, G, R, S), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, G, R, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, G, R, S, D), dtype=torch.float32, device=q.device)
    for i in range(nC):
        k_i, v_i, p_i = kc[:, i], vc[:, i], pc[i]
        s = xeinsum("bsgrd,btgd->bgrst", q, k_i, strategy="direct")
        s = s.float() * scale
        s = softcap(s, cfg.attn_softcap)
        ok = _attn_mask(q_pos, p_i, causal=causal, window=window)  # (S, Ck)
        s = torch.where(ok[None, None, None], s, _NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        upd = xeinsum("bgrst,btgd->bgrsd", p.to(q.dtype), v_i, strategy="direct").float()
        acc = acc * corr[..., None] + upd
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B,S,G,R,D)


# ------------------------------------------------------------------ mlp
def init_mlp(gen, cfg: ModelConfig, d_ff: int | None = None, *, lead=(), device=None):
    E = cfg.d_model
    F_ = d_ff or cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(lead=lead, device=device)
    if cfg.mlp_act == "swiglu":
        return {
            "wi": init_dense(gen, E, F_, dt, **kw),
            "wg": init_dense(gen, E, F_, dt, **kw),
            "wo": init_dense(gen, F_, E, dt, scale=F_**-0.5, **kw),
        }
    return {
        "wi": init_dense(gen, E, F_, dt, **kw),
        "wo": init_dense(gen, F_, E, dt, scale=F_**-0.5, **kw),
    }


def mlp(cfg: ModelConfig, params, x):
    h = dense(cfg, x, params["wi"], "bse,ef->bsf")
    if cfg.mlp_act == "swiglu":
        g = dense(cfg, x, params["wg"], "bse,ef->bsf")
        h = F.silu(g) * h
    else:
        h = gelu(h)
    return dense(cfg, h, params["wo"], "bsf,fe->bse")
