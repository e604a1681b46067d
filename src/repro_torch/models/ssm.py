"""Mamba-2 (SSD — state-space duality) mixer, chunked.

The SSD algorithm evaluates a selective state-space model as a sequence of
*per-chunk batched GEMMs* plus a tiny inter-chunk scan — which is exactly
the regime the paper targets: many small/medium GEMMs walked at constant
stride (batch modes = (batch, chunk, head)).  All heavy contractions route
through ``repro_torch.core.einsum.xeinsum``.

Decode is O(1) in sequence length: the recurrent state (B, H, N, P) *is*
the "KV cache".  Every row of the batch carries its own state, so the
decode step serves a batch of independent requests as it stands.

The port of ``repro.models.ssm``: the ``jax.lax.scan`` over chunks is a
loop here.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.core.einsum import xeinsum
from repro_torch.models.layers import _device, init_dense, normal, rms_norm

__all__ = ["init_mamba", "mamba_mixer", "mamba_decode_step", "init_ssm_cache"]


def _ctr(cfg: ModelConfig):
    return functools.partial(
        xeinsum, strategy=cfg.contract_strategy, backend=cfg.contract_backend
    )


def _dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_in = s.expand * cfg.d_model
    heads = d_in // s.headdim
    return s, d_in, heads


def init_mamba(gen, cfg: ModelConfig, *, lead=(), device=None):
    s, d_in, heads = _dims(cfg)
    E = cfg.d_model
    dt = getattr(torch, cfg.param_dtype)
    dev = _device(gen, device)
    lead = tuple(lead)
    conv_dim = d_in + 2 * s.n_groups * s.d_state

    def per_head(values):
        return values.to(dev).expand(lead + (heads,)).clone()

    return {
        # projects to [z (gate), x, B, C, dt]
        "in_proj": init_dense(gen, E, 2 * d_in + 2 * s.n_groups * s.d_state + heads, dt,
                              lead=lead, device=device),
        "conv_w": (normal(gen, lead + (s.conv_kernel, conv_dim), device=device) * 0.1).to(dt),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dt, device=dev),
        "A_log": per_head(torch.log(torch.linspace(1.0, 16.0, heads))),
        "D": torch.ones(lead + (heads,), dtype=torch.float32, device=dev),
        "dt_bias": per_head(torch.full((heads,), math.log(math.expm1(0.01)))),
        "norm": torch.zeros(lead + (d_in,), dtype=torch.float32, device=dev),
        "out_proj": init_dense(gen, d_in, E, dt, lead=lead, device=device),
    }


def _split_proj(cfg, proj):
    s, d_in, heads = _dims(cfg)
    gn = s.n_groups * s.d_state
    z, xbc, dt_raw = torch.split(proj, [d_in, d_in + 2 * gn, heads], dim=-1)
    return z, xbc, dt_raw


def _causal_conv(xbc, w, b, cache=None):
    """Depthwise causal conv1d over (B, L, C).  Returns (y, new_cache)."""
    K = w.shape[0]
    if cache is None:
        pad = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = cache
    full = torch.cat([pad, xbc], dim=1)
    # windowed sum: y[t] = Σ_k w[k] · x[t - (K-1) + k]
    y = sum(full[:, i : i + xbc.shape[1]] * w[i] for i in range(K))
    new_cache = full[:, -(K - 1):] if K > 1 else pad[:, :0]
    return F.silu(y + b), new_cache


def mamba_mixer(cfg: ModelConfig, params, x, *, positions=None, kv_cache=None):
    """Full-sequence SSD forward.  x: (B, L, E) → (B, L, E).

    If ``kv_cache`` is given (dict with conv/ssm state), runs as a
    single-step decode (L == 1 expected) via the recurrent form.
    """
    if kv_cache is not None:
        return mamba_decode_step(cfg, params, x, kv_cache)
    ctr = _ctr(cfg)
    s, d_in, heads = _dims(cfg)
    B, L, E = x.shape
    G, N, P = s.n_groups, s.d_state, s.headdim
    Q = min(s.chunk, L)
    while L % Q:
        Q -= 1  # largest chunk dividing L (configs use powers of two)
    nc = L // Q

    proj = ctr("ble,ef->blf", x, params["in_proj"].to(x.dtype))
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, _ = _causal_conv(xbc, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype))
    xs, Bm, Cm = torch.split(xbc, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(B, L, heads, P)
    Bm = Bm.reshape(B, L, G, N)
    Cm = Cm.reshape(B, L, G, N)

    A = -torch.exp(params["A_log"])                                    # (H,)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])                # (B,L,H)

    # ---- chunked SSD ---------------------------------------------------
    xs_c = xs.reshape(B, nc, Q, heads, P)
    B_c = Bm.reshape(B, nc, Q, G, N).float()
    C_c = Cm.reshape(B, nc, Q, G, N).float()
    dt_c = dt.reshape(B, nc, Q, heads)

    dA = dt_c * A  # (B,nc,Q,H)
    seg = torch.cumsum(dA, dim=2)                                      # s_i
    # intra-chunk kernel: Lmat[i,j] = exp(s_i - s_j) · dt_j  for i ≥ j
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]               # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Lmat = torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0)
    Lmat = Lmat * dt_c[:, :, None, :, :]                               # apply dt_j

    # CBt[b,c,i,j,g] = C_i · B_j   (batched GEMM over (b, c, g))
    CBt = ctr("bcign,bcjgn->bcijg", C_c, B_c)
    # heads-per-group: head h = g·HpG + r, matching the repeat() convention
    HpG = heads // G
    Lh = Lmat.reshape(B, nc, Q, Q, G, HpG)
    W = CBt[..., None] * Lh                       # (B, nc, i, j, G, HpG)
    # fold (G, HpG) → H on the last axes and contract j against x_j
    W = W.reshape(B, nc, Q, Q, heads).to(x.dtype)
    y_intra = ctr("bcijh,bcjhp->bcihp", W, xs_c)

    # ---- inter-chunk state passing --------------------------------------
    # chunk state: S_c = Σ_j exp(s_Q - s_j) dt_j · B_j ⊗ x_j   (B,nc,H,N,P)
    decay_out = torch.exp(seg[:, :, -1:, :] - seg) * dt_c              # (B,nc,Q,H)
    Bx = B_c[:, :, :, :, None, :].expand(B, nc, Q, G, HpG, N).reshape(B, nc, Q, heads, N)
    contrib = (Bx * decay_out[..., None]).to(x.dtype)
    S = ctr("bcjhn,bcjhp->bchnp", contrib, xs_c)                       # per-chunk state

    # loop over chunks: running = running · exp(Σ dA) + S_c
    chunk_decay = torch.exp(torch.sum(dA, dim=2))                      # (B,nc,H)
    carry = torch.zeros((B, heads, N, P), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)  # the state *before* this chunk
        carry = carry * chunk_decay[:, c][:, :, None, None].to(x.dtype) + S[:, c]
    prev_states = torch.stack(prev, dim=1)                             # (B,nc,H,N,P)

    # y_inter[i] = exp(s_i) · C_i · S_prev
    Ch = C_c[:, :, :, :, None, :].expand(B, nc, Q, G, HpG, N).reshape(B, nc, Q, heads, N)
    Ch = (Ch * torch.exp(seg)[..., None]).to(x.dtype)
    y_inter = ctr("bcihn,bchnp->bcihp", Ch, prev_states)

    y = (y_intra + y_inter).reshape(B, L, heads, P)
    y = y + xs * params["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, L, d_in)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.rms_eps)
    out = ctr("bld,de->ble", y, params["out_proj"].to(x.dtype))
    return out, None


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, *, lead=(), device="cuda"):
    s, d_in, heads = _dims(cfg)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, s.conv_kernel - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros(lead + (batch, heads, s.d_state, s.headdim), dtype=dtype,
                             device=device),
    }


def mamba_decode_step(cfg: ModelConfig, params, x, cache):
    """Recurrent single-token step.  x: (B, 1, E)."""
    ctr = _ctr(cfg)
    s, d_in, heads = _dims(cfg)
    B, L, E = x.shape
    G, N, P = s.n_groups, s.d_state, s.headdim

    proj = ctr("ble,ef->blf", x, params["in_proj"].to(x.dtype))
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, new_conv = _causal_conv(
        xbc, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype),
        cache["conv"],
    )
    xs, Bm, Cm = torch.split(xbc[:, -1], [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(B, heads, P)
    HpG = heads // G
    Bm = Bm.reshape(B, G, N).repeat_interleave(HpG, dim=1).reshape(B, heads, N)
    Cm = Cm.reshape(B, G, N).repeat_interleave(HpG, dim=1).reshape(B, heads, N)

    A = -torch.exp(params["A_log"])
    dt = F.softplus(dt_raw[:, -1].float() + params["dt_bias"])        # (B,H)
    decay = torch.exp(dt * A).to(x.dtype)                             # (B,H)

    # S ← decay · S + dt · B ⊗ x
    outer = (Bm * dt[..., None]).to(x.dtype)
    new_state = cache["state"] * decay[:, :, None, None] + (
        outer[:, :, :, None] * xs[:, :, None, :]
    )
    y = ctr("bhn,bhnp->bhp", Cm.to(x.dtype), new_state)
    y = y + xs * params["D"][None, :, None].to(x.dtype)
    y = y.reshape(B, 1, d_in)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.rms_eps)
    out = ctr("bld,de->ble", y, params["out_proj"].to(x.dtype))
    return out, {"conv": new_conv, "state": new_state}
