"""Expert parallelism through an explicit fixed-capacity all-to-all.

The GShard one-hot dispatch (:mod:`repro_torch.models.moe`) builds a
dispatch tensor of O(tokens × experts × capacity).  This module is the
expert-parallel path: every rank

  1. holds its own block of the tokens (sharded over *all* mesh axes as
     one flat group of ``D`` ranks, outer axis major);
  2. routes its tokens, sorts them by destination rank, and gathers them
     into a fixed-capacity ``(D, cap, E)`` send buffer — local index ops,
     no one-hot tensors;
  3. exchanges the buffers with one ``all_to_all_single`` over the group
     (experts are round-robin over ranks, padded to a multiple of ``D``);
  4. runs its local experts as three strided-batched products with the
     expert as batch mode (``contract``; on the kernel backend each is a
     ``native_gemm`` launch on the card);
  5. returns the outputs with the inverse all-to-all, and the senders
     combine them with their routing weights (gathers and a sum over
     each token's ``k`` entries, differentiable).

Capacity is ``cap = T_loc·k/D·capacity_factor + 1`` per destination
rank and ``C2 = cap·D // Xloc`` per local expert after the exchange;
overflow drops.  ``C2`` rounds to 0 when ``T_loc·k·capacity_factor <
Xloc`` (a decode row on a few ranks with many experts): then every routed
token drops, as in the JAX package.

The port of ``repro.distributed.moe_a2a``, with one deliberate
difference: **expert ownership**.  Routing sends expert ``e`` to rank
``e % D``, local slot ``e // D`` (as in the JAX package), and here rank
``d``'s slot ``j`` holds expert ``j·D + d``: rank ``d`` takes experts
``w[d::D]`` of the padded stack (of a plain stack a strided view, which
``native_gemm`` reads without a copy; a DTensor stack sends each rank
only those experts, in one all-to-all).  The JAX package hands each device a contiguous block of the
stack, so device ``d`` slot ``j`` holds expert ``d·Xloc + j`` and a token
routed to ``e`` meets another expert's weights whenever ``Xloc > 1``;
this port computes what the routing says (the JAX package fed the stack
permuted so that block ``d`` is ``w[d::D]`` computes the same).  Routing,
capacities, the trash-bin slot and the stable sorts are the JAX
package's, so the same tokens drop.  The JAX package scatter-adds each
token's ``k`` weighted outputs in place; here they are adjacent rows
summed in a fixed order, and each token's rows are gathered from its
``k`` copies, so that no gradient or output is an atomic sum on the card
(the same values, in a deterministic order).

Each exchange is an autograd Function whose backward is the inverse
all-to-all; an exchange over a group of one rank is not issued.
Operands are DTensors on ``mesh`` or plain tensors holding the global
value on every rank.  A DTensor hands back the gradient of what this rank
used (the tokens of its block, the experts it owns, a ``Partial`` share
of the router); a plain leaf gets this rank's share, and the gradient is
the sum over ranks.  The result is a DTensor on ``mesh``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed.contract import _process_group
from repro_torch.distributed.sharding import P, group_index, local_block, placements

__all__ = ["moe_ffn_a2a", "pad_expert_params"]


def pad_expert_params(params: dict, n_devices: int) -> dict:
    """Pad expert-stacked weights to a multiple of the device count.

    Virtual (padded) experts have zero weights and are never routed to.
    """
    out = dict(params)
    for name in ("wi", "wg", "wo"):
        if name in params:
            w = params[name]
            X = w.shape[0]
            Xv = -(-X // n_devices) * n_devices
            if Xv != X:
                out[name] = torch.cat([w, w.new_zeros((Xv - X,) + tuple(w.shape[1:]))], 0)
    return out


def _ranks_within_groups(groups, order, starts):
    """Position of each element inside its group, given the stable sort."""
    n = groups.shape[0]
    slot_sorted = torch.arange(n, device=groups.device) - starts[groups[order]]
    out = torch.zeros(n, dtype=torch.int32, device=groups.device)
    out[order] = slot_sorted.to(torch.int32)
    return out


def _all_to_all_(x, pg, in_splits=None, out_splits=None):
    x = x.contiguous()
    rows = x.shape[0] if out_splits is None else sum(out_splits)
    out = x.new_empty((rows,) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes=out_splits,
                           input_split_sizes=in_splits, group=pg)
    return out


class _AllToAll(torch.autograd.Function):
    """Block ``j`` of dim 0 goes to group rank ``j``; block ``j`` of the
    result came from rank ``j``: equal blocks, or ``in_splits`` rows sent
    and ``out_splits`` received.  Its dual swaps the splits."""

    @staticmethod
    def forward(ctx, x, pg, in_splits=None, out_splits=None):
        ctx.pg, ctx.splits = pg, (in_splits, out_splits)
        return _all_to_all_(x, pg, in_splits, out_splits)

    @staticmethod
    def backward(ctx, g):
        sent, received = ctx.splits
        return _all_to_all_(g, ctx.pg, received, sent), None, None, None


def _exchange(x, pg, in_splits=None, out_splits=None):
    if pg is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, pg, in_splits, out_splits)
    return _all_to_all_(x, pg, in_splits, out_splits)


def _whole(w, mesh):
    """The global value of a parameter on this rank.  A DTensor's
    gradient comes back as this rank's ``Partial`` share (each rank uses
    a part of it); on a mesh of one rank the local tensor is the whole."""
    from torch.distributed.tensor import DTensor, Partial

    if not isinstance(w, DTensor):
        return w
    if mesh.size() == 1:
        return w.to_local()
    return w.full_tensor(grad_placements=[Partial()] * mesh.ndim)


def _bincount(idx, n: int):
    """``torch.bincount(idx, minlength=n)`` for ``idx < n``: its length is
    ``n`` whatever the data, so a step traced on fake tensors runs it."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int64))


def owned_counts(lo: int, hi: int, D: int) -> list[int]:
    """How many of experts ``[lo, hi)`` each of ``D`` ranks owns (rank
    ``d`` owns the experts ``e`` with ``e % D == d``), from the integers
    alone: no tensor is read, so a step traced on fake tensors runs it."""
    return [len(range(lo + (d - lo) % D, hi, D)) for d in range(D)]


def _flat_blocks(n: int, sizes) -> list:
    """``[lo, hi)`` of each flat rank's block (outer mesh dim major) of a
    dim of ``n`` sharded over mesh dims of ``sizes``: DTensor splits it as
    ``torch.chunk`` does, the first mesh dim outermost."""
    spans = [(0, n)]
    for k in sizes:
        nxt = []
        for lo, hi in spans:
            c = -(-(hi - lo) // k)
            nxt += [(min(lo + i * c, hi), min(lo + (i + 1) * c, hi)) for i in range(k)]
        spans = nxt
    return spans


def _owned(w, mesh, axes, pg, d: int, D: int, Xloc: int, dt):
    """Rank ``d``'s experts ``j·D + d`` (``j < Xloc``) of the stack ``w`` in
    ``dt``, with zero experts appended past the stack's end.  A plain
    tensor holds the whole stack: the strided view ``w[d::D]``.  A DTensor
    sends each rank only its own experts: each rank casts its block, the
    stack is resharded in contiguous blocks over the flat group, and one
    all-to-all hands every expert to its owner (its gradient goes back the
    same way, to the one block that holds it)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(w, DTensor):
        own = w[d::D].to(dt)
    elif D == 1:
        own = w.to_local().to(dt)
    else:
        blk = w.to(dt).redistribute(mesh, placements(P(axes), mesh)).to_local()
        spans = _flat_blocks(w.shape[0], mesh.shape)
        lo, hi = spans[d]
        if blk.shape[0] != hi - lo:
            raise AssertionError(f"rank {d} holds {blk.shape[0]} experts, not {hi - lo}")
        owner = torch.arange(lo, hi) % D
        order = torch.argsort(owner, stable=True)       # this block's experts by owner
        sent = owned_counts(lo, hi, D)
        received = [owned_counts(l, h, D)[d] for l, h in spans]
        own = _exchange(blk[order.to(blk.device)], pg, sent, received)
    if own.shape[0] < Xloc:
        own = torch.cat([own, own.new_zeros((Xloc - own.shape[0],) + tuple(own.shape[1:]))])
    return own


def _local_tokens(x, mesh, axes):
    """This rank's ``(T_loc, E)`` block of the tokens of ``x`` (B, S, E),
    flat tokens sharded over ``axes`` outer axis major."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    B, S, E = x.shape
    flat = P(axes)
    if not isinstance(x, DTensor):
        return local_block(x.reshape(B * S, E), flat, mesh)
    if mesh.size() == 1:
        return x.to_local().reshape(B * S, E)
    if B % mesh.size() == 0:
        # rows over the flat group: rank g's rows are flat tokens block g
        return x.redistribute(mesh, placements(P(axes), mesh)).to_local().reshape(-1, E)
    whole = x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial()] * mesh.ndim)
    return local_block(whole.reshape(B * S, E), flat, mesh)


def _global_output(y, B: int, S: int, mesh, axes):
    """The DTensor ``(B, S, E)`` whose flat tokens are this rank's block
    ``y`` (T_loc, E) over ``axes``."""
    from torch.distributed.tensor import DTensor, Replicate

    E = y.shape[-1]
    flat = placements(P(axes), mesh)
    if B % mesh.size() == 0:
        return DTensor.from_local(y.reshape(-1, S, E), mesh, flat, run_check=False,
                                  shape=torch.Size((B, S, E)),
                                  stride=(S * E, E, 1))
    out = DTensor.from_local(y, mesh, flat, run_check=False,
                             shape=torch.Size((B * S, E)), stride=(E, 1))
    return out.redistribute(mesh, [Replicate()] * mesh.ndim).reshape(B, S, E)


def moe_ffn_a2a(cfg, params, x, mesh, *, strategy=None, backend=None):
    """x: (B, S, E) → (B, S, E), a DTensor on ``mesh`` (a
    ``DeviceMesh``).  ``B·S`` must divide by the mesh's size.

    ``params`` uses the standard moe layout; rank ``d`` takes experts
    ``w[d::D]``, with zero experts appended where the count is short of a
    multiple of ``D``.  The three expert products run through
    :func:`repro_torch.core.contract.contract` with ``strategy`` and
    ``backend`` (default: the config's)."""
    from repro_torch.core.contract import contract
    from repro_torch.models.moe import top_k as _top_k

    m = cfg.moe
    axes = tuple(mesh.mesh_dim_names)
    D = mesh.size()
    B, S, E = x.shape
    T = B * S
    if T % D:
        raise ValueError(f"moe_ffn_a2a: {T} tokens do not divide over {D} ranks")
    T_loc = T // D
    k = m.top_k
    Xv = -(-m.n_experts // D) * D
    Xloc = Xv // D
    cap = max(int(T_loc * k / D * m.capacity_factor) + 1, 1)
    C2 = cap * D // Xloc  # local per-expert capacity after the exchange
    dt = x.dtype
    strategy = strategy or cfg.contract_strategy
    backend = backend or cfg.contract_backend
    pg = _process_group(mesh, axes) if D > 1 else None
    d = group_index(axes, mesh)

    xt = _local_tokens(x, mesh, axes)                   # (T_loc, E)
    if C2 == 0:
        # no local expert has a slot: every routed token drops
        return _global_output(xt.new_zeros((T_loc, E)), B, S, mesh, axes)
    dev = xt.device
    router = _whole(params["router"], mesh)
    logits = xt.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)               # (T_loc, X)
    top_w, top_e = _top_k(gates, k)
    top_w = top_w / (torch.sum(top_w, dim=-1, keepdim=True) + 1e-9)

    flat_e = top_e.reshape(-1)                          # (N,) N = T_loc·k
    flat_w = top_w.reshape(-1).to(dt)
    N = flat_e.shape[0]
    dest = flat_e % D                                   # owning rank
    local_e = flat_e // D                               # slot on the owner

    # ---- sort by destination, fixed-capacity send buffer (gathers) ------
    order = torch.argsort(dest, stable=True)
    counts = _bincount(dest, D)
    starts = torch.cumsum(counts, 0) - counts
    slot = _ranks_within_groups(dest, order, starts)    # (N,)
    kept = slot < cap
    ar_cap = torch.arange(cap, device=dev)
    pick = starts[:, None] + ar_cap[None]               # (D, cap)
    valid = ar_cap[None] < torch.clamp(counts, max=cap)[:, None]
    item = order[torch.clamp(pick, 0, N - 1)]
    # entry n is token n // k; each entry lands in at most one slot, so
    # the gather's gradient sums no two values (deterministic on the card)
    send = xt.repeat_interleave(k, dim=0)[item] * valid[..., None].to(dt)  # (D, cap, E)
    send_le = torch.where(valid, local_e[item], Xloc)   # Xloc = trash bin

    recv = _exchange(send, pg)                          # (D, cap, E)
    recv_le = _exchange(send_le.int(), pg).long()       # sent as int32, as in JAX

    # ---- regroup by local expert (gathers again) -------------------------
    e2 = recv_le.reshape(-1)                            # (D·cap,)
    rflat = recv.reshape(-1, E)
    order2 = torch.argsort(e2, stable=True)
    counts2 = _bincount(e2, Xloc + 1)
    starts2 = torch.cumsum(counts2, 0) - counts2
    slot2 = _ranks_within_groups(e2, order2, starts2)
    ar_c2 = torch.arange(C2, device=dev)
    pick2 = starts2[:Xloc, None] + ar_c2[None]
    valid2 = ar_c2[None] < torch.clamp(counts2[:Xloc], max=C2)[:, None]
    item2 = order2[torch.clamp(pick2, 0, e2.shape[0] - 1)]
    ebuf = rflat[item2] * valid2[..., None].to(dt)      # (Xloc, C2, E)

    # ---- the paper's kernel: expert-batched strided GEMM -----------------
    def ctr(spec, a, name):
        w = _owned(params[name], mesh, axes, pg, d, D, Xloc, dt)
        return contract(spec, a, w, strategy=strategy, backend=backend)

    h = ctr("xce,xef->xcf", ebuf, "wi")
    if "wg" in params:
        h = F.silu(ctr("xce,xef->xcf", ebuf, "wg")) * h
    else:
        h = F.gelu(h, approximate="tanh")
    obuf = ctr("xcf,xfe->xce", h, "wo")                 # (Xloc, C2, E)

    # ---- route back: gather to recv layout, inverse a2a, combine ---------
    ok_back = (e2 < Xloc) & (slot2 < C2)
    back_flat = obuf[torch.clamp(e2, 0, Xloc - 1),
                     torch.clamp(slot2, 0, C2 - 1)] * ok_back[:, None].to(dt)
    back = _exchange(back_flat.reshape(D, cap, E), pg)

    vals = back[dest, torch.clamp(slot, 0, cap - 1)]    # (N, E)
    vals = vals * kept[:, None].to(dt)
    # a token's k entries are adjacent: a sum over them, in a fixed order
    y = (vals * flat_w[:, None]).reshape(T_loc, k, E).sum(dim=1)
    return _global_output(y, B, S, mesh, axes)
