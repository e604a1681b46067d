"""Mixture-of-Experts with GShard-style grouped, capacity-based routing.

Tokens are split into *groups*; each group dispatches into per-expert
capacity slots through one-hot dispatch/combine tensors.

The expert FFN itself is the paper's primitive incarnate: a strided-batched
GEMM with the *expert* as batch mode — ``contract("xge,xef->xgf", ...)``
walks expert weight matrices at constant stride exactly like ``sb_gemm``'s
``loa`` walk, and is planned by the engine as such.  Only those three
expert products take ``cfg.contract_backend``; the router and the
dispatch/combine einsums are ``strategy="direct"``, as in the JAX package.

The port of ``repro.models.moe``, with two differences:

* ``moe_impl="a2a"`` takes the GShard path: the port has no mesh yet
  (ROADMAP item 12), and the JAX package takes the same path outside a
  sharding-rules context.
* ``group`` may set the tokens per dispatch group.  A batched decode
  passes the tokens of one row, so that each request routes as its own
  group, as each slot does under the JAX runtime's ``vmap``; one group of
  all rows would change the capacity and so which tokens are dropped.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.einsum import xeinsum
from repro_torch.models.layers import gelu, init_dense, init_mlp, mlp, normal

__all__ = ["init_moe", "moe_ffn", "router_aux_loss", "top_k"]


def _ctr(cfg: ModelConfig):
    return functools.partial(
        xeinsum, strategy=cfg.contract_strategy, backend=cfg.contract_backend
    )


def init_moe(gen, cfg: ModelConfig, *, lead=(), device=None):
    m: MoEConfig = cfg.moe
    E, F_ = cfg.d_model, m.d_expert
    dt = getattr(torch, cfg.param_dtype)
    lead = tuple(lead)
    X = (m.n_experts,)
    params = {
        "router": init_dense(gen, E, m.n_experts, torch.float32, lead=lead, device=device),
        "wi": (normal(gen, lead + X + (E, F_), device=device) * E**-0.5).to(dt),
        "wo": (normal(gen, lead + X + (F_, E), device=device) * F_**-0.5).to(dt),
    }
    if cfg.mlp_act == "swiglu":
        params["wg"] = (normal(gen, lead + X + (E, F_), device=device) * E**-0.5).to(dt)
    if m.n_shared:
        params["shared"] = init_mlp(gen, cfg, d_ff=m.d_shared or m.d_expert,
                                    lead=lead + (m.n_shared,), device=device)
    return params


#: tokens per dispatch group (GShard "group size").
GROUP_SIZE = 4096


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, ties taken in index order (lower index first)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _dispatch_tensors(gates, top_w, top_e, n_experts: int, capacity: int):
    """Build one-hot dispatch/combine tensors, slot-by-slot (GShard alg).

    gates: (g, t, X); top_w/top_e: (g, t, k).
    Returns dispatch (g,t,X,C) in {0,1} and combine (g,t,X,C) weights.
    """
    g, t, k = top_e.shape
    counts = torch.zeros((g, n_experts), dtype=torch.int32, device=gates.device)
    dispatch = 0.0
    combine = 0.0
    for i in range(k):
        oh = _one_hot(top_e[:, :, i], n_experts, torch.int32)        # (g,t,X)
        pos_in_e = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]
        pos = torch.sum(pos_in_e * oh, dim=-1)                       # (g,t) slot index
        keep = pos < capacity
        counts = counts + torch.sum(oh, dim=1)
        slot_oh = _one_hot(pos, capacity, torch.float32)             # (g,t,C)
        d_i = (oh.float() * keep[..., None])[..., None] * slot_oh[:, :, None, :]
        dispatch = dispatch + d_i
        combine = combine + d_i * top_w[:, :, i, None, None]
    return dispatch, combine


def moe_ffn(cfg: ModelConfig, params, x, *, capacity: int | None = None,
            group: int | None = None):
    """x: (B, S, E) → (B, S, E), plus aux metrics dict.

    ``group`` caps the tokens per dispatch group (default
    :data:`GROUP_SIZE`); it is lowered until it divides ``B·S``."""
    ctr = _ctr(cfg)
    m: MoEConfig = cfg.moe
    B, S, E = x.shape
    T = B * S
    dt = x.dtype

    group = min(GROUP_SIZE if group is None else group, T)
    while T % group:
        group -= 1
    n_g = T // group
    xt = x.reshape(n_g, group, E)

    gate_logits = xeinsum("gte,ef->gtf", xt.float(), params["router"], strategy="direct")
    gates = torch.softmax(gate_logits, dim=-1)                         # (g,t,X)
    top_w, top_e = top_k(gates, m.top_k)
    top_w = top_w / (torch.sum(top_w, dim=-1, keepdim=True) + 1e-9)

    C = capacity or max(int(m.capacity_factor * m.top_k * group / m.n_experts) + 1, 4)
    dispatch, combine = _dispatch_tensors(gates, top_w, top_e, m.n_experts, C)
    dispatch = dispatch.to(dt)
    combine = combine.to(dt)

    # dispatch: (g,t,X,C),(g,t,E) → (X,g,C,E) — data movement, evaluated
    # direct; the GEMMs below are the paper's kernels.
    expert_in = xeinsum("gtxc,gte->xgce", dispatch, xt, strategy="direct")

    # ---- expert FFN: strided-batched GEMM, batch mode = expert ----------
    wi = params["wi"].to(dt)
    h = ctr("xgce,xef->xgcf", expert_in, wi)
    if "wg" in params:
        g_ = ctr("xgce,xef->xgcf", expert_in, params["wg"].to(dt))
        h = F.silu(g_) * h
    else:
        h = gelu(h)
    out = ctr("xgcf,xfe->xgce", h, params["wo"].to(dt))

    # combine back to tokens
    y = xeinsum("gtxc,xgce->gte", combine, out, strategy="direct")

    if m.n_shared:
        xs = xt.reshape(B, S, E)
        shared = params["shared"]
        y_shared = mlp(cfg, {k: v[0] for k, v in shared.items()}, xs)
        for i in range(1, m.n_shared):
            y_shared = y_shared + mlp(cfg, {k: v[i] for k, v in shared.items()}, xs)
        y = y + y_shared.reshape(n_g, group, E)

    aux = router_aux_loss(gates.reshape(T, -1), top_e.reshape(T, -1), m.n_experts)
    return y.reshape(B, S, E), aux


def router_aux_loss(gates, top_e, n_experts: int):
    """Switch-style load-balancing loss + routing stats."""
    T = gates.shape[0]
    flat = top_e.reshape(-1)
    frac_tokens = torch.zeros(n_experts, dtype=torch.float32, device=gates.device).index_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=gates.device)
    ) / (T * top_e.shape[-1])
    frac_probs = torch.mean(gates, dim=0)
    lb = n_experts * torch.sum(frac_tokens * frac_probs)
    return {"load_balance_loss": lb, "max_expert_frac": torch.max(frac_tokens)}
