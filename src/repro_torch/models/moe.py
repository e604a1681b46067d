"""Mixture-of-Experts with GShard-style grouped, capacity-based routing.

Tokens are split into *groups*; each group dispatches into per-expert
capacity slots through one-hot dispatch/combine tensors.

The expert FFN itself is the paper's primitive incarnate: a strided-batched
GEMM with the *expert* as batch mode — ``contract("xge,xef->xgf", ...)``
walks expert weight matrices at constant stride exactly like ``sb_gemm``'s
``loa`` walk, and is planned by the engine as such.  Only those three
expert products take ``cfg.contract_backend``; the router and the
dispatch/combine einsums are ``strategy="direct"``, as in the JAX package.

The port of ``repro.models.moe``.  ``moe_impl="a2a"`` under a
sharding-rules context whose mesh size divides the tokens runs the
expert-parallel all-to-all (:func:`repro_torch.distributed.moe_a2a.
moe_ffn_a2a`) on the rules' mesh, with the shared experts through
:func:`~repro_torch.models.layers.mlp` and the router statistics
recomputed (``strategy="direct"``); otherwise, and outside rules, it
takes the GShard path, as the JAX package does.  One difference:
``group`` may name the tokens of one request.  A batched decode or
prefill passes the tokens of one row, so that each request routes in
groups of its own, as each slot does under the JAX runtime's ``vmap``;
groups across rows would change the capacity and so which tokens are
dropped.
Under a2a each such row takes the JAX package's per-slot decision by its
own token count (the all-to-all on that row alone, or GShard) and its
own capacity.
"""

from __future__ import annotations


import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed.sharding import current_rules, logical
from repro_torch.models.layers import (
    _ctr, contraction, gelu, init_dense, init_mlp, mlp, normal, reshape,
)

__all__ = ["init_moe", "moe_ffn", "router_aux_loss", "top_k"]



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

    ``group``, where given, is the tokens of one request (a row's ``S``):
    each request is grouped as the JAX package groups a call of its own,
    from ``min(GROUP_SIZE, group)`` lowered until it divides ``group``, so
    no dispatch group straddles two requests.  Without it the ``B·S``
    tokens are one request.  Under a2a a ``group`` below ``B·S`` makes
    each row a request of its own."""
    ctr = _ctr(cfg)
    m: MoEConfig = cfg.moe
    B, S, E = x.shape
    T = B * S
    dt = x.dtype

    rules = current_rules() if cfg.moe_impl == "a2a" else None
    if rules is not None:
        rows = B if group is not None and group < T else 1  # a request per row
        if (T // rows) % rules.mesh.size() == 0:
            return _moe_a2a(cfg, params, x, rules.mesh, rows=rows)
        # a token count the mesh does not divide → the GShard path
    request = T if group is None else group
    group = min(GROUP_SIZE, request)
    while request % group:
        group -= 1
    n_g = T // group
    xt = reshape(x, n_g, group, E)
    xt = logical(xt, "batch", None, None)

    gate_logits = contraction("gte,ef->gtf", xt.float(), params["router"], strategy="direct")
    gates = torch.softmax(gate_logits, dim=-1)                         # (g,t,X)
    top_w, top_e = top_k(gates, m.top_k)
    top_w = top_w / (torch.sum(top_w, dim=-1, keepdim=True) + 1e-9)

    C = capacity or max(int(m.capacity_factor * m.top_k * group / m.n_experts) + 1, 4)
    dispatch, combine = _dispatch_tensors(gates, top_w, top_e, m.n_experts, C)
    dispatch = logical(dispatch.to(dt), "batch", None, "expert", None)
    combine = logical(combine.to(dt), "batch", None, "expert", None)

    # dispatch: (g,t,X,C),(g,t,E) → (X,g,C,E) — data movement, evaluated
    # direct; the GEMMs below are the paper's kernels.
    expert_in = contraction("gtxc,gte->xgce", dispatch, xt, strategy="direct")
    expert_in = logical(expert_in, "expert", "batch", None, None)

    # ---- expert FFN: strided-batched GEMM, batch mode = expert ----------
    wi = params["wi"].to(dt)
    h = ctr("xgce,xef->xgcf", expert_in, wi)
    if "wg" in params:
        g_ = ctr("xgce,xef->xgcf", expert_in, params["wg"].to(dt))
        h = F.silu(g_) * h
    else:
        h = gelu(h)
    h = logical(h, "expert", "batch", None, "expert_ff")
    out = ctr("xgcf,xfe->xgce", h, params["wo"].to(dt))

    # combine back to tokens
    y = contraction("gtxc,xgce->gte", combine, out, strategy="direct")

    if m.n_shared:
        xs = reshape(xt, B, S, E)
        shared = params["shared"]
        y_shared = mlp(cfg, {k: v[0] for k, v in shared.items()}, xs)
        for i in range(1, m.n_shared):
            y_shared = y_shared + mlp(cfg, {k: v[i] for k, v in shared.items()}, xs)
        y = y + reshape(y_shared, n_g, group, E)

    aux = router_aux_loss(reshape(gates, T, -1), reshape(top_e, T, -1), m.n_experts)
    return logical(reshape(y, B, S, E), "batch", "seq_sharded", None), aux


def _moe_a2a(cfg: ModelConfig, params, x, mesh, *, rows: int):
    """The a2a branch of :func:`moe_ffn`: the all-to-all over the whole
    batch (``rows`` 1), or over each row alone (``rows`` = B)."""
    from repro_torch.distributed.moe_a2a import moe_ffn_a2a

    m: MoEConfig = cfg.moe
    B, S, _ = x.shape
    if rows == 1:
        y = moe_ffn_a2a(cfg, params, x, mesh)
    else:
        y = torch.cat([moe_ffn_a2a(cfg, params, x[b:b + 1], mesh) for b in range(B)])
    if m.n_shared:
        shared = params["shared"]
        for i in range(m.n_shared):
            y = y + mlp(cfg, {k: v[i] for k, v in shared.items()}, x)
    # router stats recomputed (cheap: E×X); the load-balance loss
    # gradient flows through this pass
    gl = contraction("bse,ef->bsf", x.float(), params["router"], strategy="direct")
    gates = reshape(torch.softmax(gl, dim=-1), B * S, -1)
    _, top_e = top_k(gates, m.top_k)
    aux = router_aux_loss(gates, top_e, m.n_experts)
    return logical(y, "batch", "seq_sharded", None), aux


def router_aux_loss(gates, top_e, n_experts: int):
    """Switch-style load-balancing loss + routing stats."""
    T = gates.shape[0]
    flat = reshape(top_e, -1)
    frac_tokens = torch.zeros(n_experts, dtype=torch.float32, device=gates.device).index_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=gates.device)
    ) / (T * top_e.shape[-1])
    frac_probs = torch.mean(gates, dim=0)
    lb = n_experts * torch.sum(frac_tokens * frac_probs)
    return {"load_balance_loss": lb, "max_expert_frac": torch.max(frac_tokens)}
