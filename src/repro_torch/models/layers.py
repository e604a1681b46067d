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

Under a sharding-rules context (:func:`repro_torch.distributed.sharding.
use_rules`) the models run on DTensors: parameters and batches placed by
:mod:`repro_torch.launch.shardings`, elementwise work through DTensor's
own dispatch, ``logical(...)`` annotations where the JAX package has them,
and every contraction through :func:`contraction`'s mesh route, which
hands ``xeinsum`` the mesh and the operands' specs, so the products run
on each rank's local blocks (one ``native_gemm`` launch per block product
on the kernel backend: the ``repro_torch::native_gemm`` operator has no
DTensor strategy)
with the plan's collectives.  The loss's log-likelihoods
(:func:`token_nll`) run on each rank's vocab block, with three
all-reduces of one value a position.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.einsum import parse_nary, xeinsum
from repro_torch.distributed.sharding import (
    P, current_rules, logical, reduce_partial, spec_of, use_rules,
)

__all__ = [
    "rms_norm", "rope", "attention", "mlp", "init_attn", "init_mlp",
    "dense", "init_dense", "softcap", "contraction", "mesh_scope", "replicated",
    "reshape", "token_nll", "cached_rows",
]

_NEG_INF = -2.0**30  # large-negative mask value safe in bf16
_ROWS = threading.local()  # the cached rows' softmax width (:func:`cached_rows`)


def contraction(spec: str, *operands, strategy: str, backend: str = "torch"):
    """``xeinsum(spec, *operands, strategy=, backend=)``; under a rules
    context with a DTensor operand, its mesh route: ``xeinsum`` on the
    rules' mesh with ``in_specs`` read from the operands (a plain operand
    holds the global value: spec ``None``).

    A ``Partial`` placement is reduced to ``Replicate`` first.  Where two
    operands' shardings cannot stand together in one plan (one mesh axis
    on two modes, one mode on two groups), the later operand's wins (the
    weight, in ``x · W``) and the other is gathered along that mode; so
    is a sharding that does not divide its dim or that splits a mode one
    operand sums out alone.  A DTensor operand outside rules raises:
    nothing hands it to DTensor's own dispatch."""
    from torch.distributed.tensor import DTensor

    rules = current_rules()
    if not any(isinstance(x, DTensor) for x in operands):
        return xeinsum(spec, *operands, strategy=strategy, backend=backend)
    if rules is None:
        raise ValueError(f"{spec}: a DTensor operand outside sharding rules; run the model "
                         f"under use_rules so that the contraction takes the mesh route")
    ops = [reduce_partial(x) for x in operands]
    return xeinsum(spec, *ops, strategy=strategy, backend=backend, mesh=rules.mesh,
                   in_specs=_mesh_specs(spec, ops, rules.mesh))


def _mesh_specs(spec: str, operands, mesh) -> tuple:
    """One ``PartitionSpec`` per operand that the sharded planner accepts
    (see :func:`contraction`); ``None`` for a plain operand."""
    from torch.distributed.tensor import DTensor

    inputs, output = parse_nary(spec)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    seen = [m for modes in inputs for m in modes]
    mode_group: dict = {}
    axis_mode: dict = {}
    specs = [None] * len(operands)
    for i in reversed(range(len(operands))):
        x = operands[i]
        if not isinstance(x, DTensor):
            continue
        entries = list(spec_of(x)) + [None] * (x.ndim - len(spec_of(x)))
        kept = []
        for dim, (mode, entry) in enumerate(zip(inputs[i], entries)):
            g = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
            keep = (bool(g) and x.shape[dim] % math.prod(sizes[a] for a in g) == 0
                    and (mode in output or seen.count(mode) > 1))
            if keep and mode in mode_group:
                keep = mode_group[mode] == g
            elif keep:
                keep = not any(a in axis_mode for a in g)
                if keep:
                    mode_group[mode] = g
                    axis_mode.update({a: mode for a in g})
            kept.append(entry if keep else None)
        specs[i] = P(*kept)
    return tuple(specs)


@contextlib.contextmanager
def mesh_scope(rules=None):
    """The context a model pass runs in: under sharding rules (``rules``,
    or the current ones), those rules, and plain tensors made inside the
    model join DTensor ops as replicated DTensors (every rank makes the
    same ones); outside rules, nothing.  Both settings are per thread, so
    work that autograd replays on its own thread (remat's recompute)
    enters this again with the rules it captured.  Nests."""
    rules = rules if rules is not None else current_rules()
    if rules is None:
        yield
        return
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        with use_rules(rules):
            yield
    finally:
        dispatcher._allow_implicit_replication = before


def replicated(x):
    """``x`` as a replicated DTensor under sharding rules, otherwise ``x``.

    A plain tensor (every rank makes the same one) is wrapped, so that
    autograd saves no plain tensor beside DTensors for a backward that may
    run on another thread; a DTensor is gathered whole (the token ids of a
    lookup: DTensor's scatter-add for its gradient with sharded indices
    fails in torch 2.11)."""
    from torch.distributed.tensor import DTensor, Replicate

    rules = current_rules()
    if rules is None:
        return x
    whole = [Replicate()] * rules.mesh.ndim
    if isinstance(x, DTensor):
        return x if list(x.placements) == whole else x.redistribute(rules.mesh, whole)
    return DTensor.from_local(x, rules.mesh, whole, run_check=False)


def token_nll(logits, targets):
    """``-log_softmax(logits)[..., target]`` at each position, computed so
    that nothing of the vocab's width leaves a rank.

    ``logits`` (..., V) and ``targets`` (...) integer ids.  On a DTensor,
    each rank works on its own vocab block: the row max (detached) and the
    sum of ``exp(logits - max)`` are all-reduced (max, sum) over the mesh
    dims that shard the vocab, and the target's shifted logit comes from
    the rank whose block holds it (0 elsewhere, summed); the targets are
    placed as the logits' other dims first.  The result is a DTensor
    placed as the logits less the vocab's sharding.  With the vocab whole
    on every rank, or on a plain tensor, the same arithmetic runs with no
    collective, so a mesh of one rank computes the plain tensor's bits.
    ``log_softmax`` and ``gather`` on a DTensor would instead gather the
    vocab and build the gradient at the global shape on every rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(logits, DTensor):
        return _nll_block(logits, targets.long(), 0, lambda x, op: x)
    from repro_torch.distributed.contract import _all_reduce

    logits = reduce_partial(logits)
    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab = [d for d, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == last]
    rest = [Replicate() if d in vocab else p for d, p in enumerate(logits.placements)]
    if not isinstance(targets, DTensor):  # the global ids on every rank
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
    targets = targets.redistribute(mesh, rest)
    group = tuple(mesh.mesh_dim_names[d] for d in vocab)
    nll = _nll_block(logits.to_local(), targets.to_local().long(),
                     _block_start(logits.shape[-1], mesh, vocab),
                     lambda x, op: _all_reduce(x, mesh, group, op))
    shape = tuple(targets.shape)
    return DTensor.from_local(nll, mesh, rest, run_check=False, shape=shape,
                              stride=tuple(math.prod(shape[i + 1:]) for i in range(len(shape))))


def _nll_block(x, t, offset: int, reduce):
    """:func:`token_nll` on one vocab block ``x`` whose first column is
    vocab id ``offset``; ``reduce(y, op)`` all-reduces ``y`` over the
    blocks (``op`` a ``ReduceOp``)."""
    from torch.distributed import ReduceOp

    m = reduce(x.detach().amax(-1), ReduceOp.MAX)
    z = x - m[..., None]
    lse = torch.log(reduce(torch.exp(z).sum(-1), ReduceOp.SUM))
    idx = t - offset
    held = (idx >= 0) & (idx < x.shape[-1])
    zt = torch.gather(z, -1, torch.where(held, idx, 0)[..., None])[..., 0]
    return lse - reduce(torch.where(held, zt, 0.0), ReduceOp.SUM)


def _block_start(n: int, mesh, dims) -> int:
    """The first index of this rank's block of a dim of ``n`` sharded over
    mesh dims ``dims`` (DTensor's ``Shard``: ``torch.chunk`` by each mesh
    dim in turn, the first outermost)."""
    coord = mesh.get_coordinate()
    start = 0
    for d in sorted(dims):
        chunk = -(-n // mesh.shape[d])
        lo = min(coord[d] * chunk, n)
        start, n = start + lo, min(lo + chunk, n) - lo
    return start


def reshape(x, *shape):
    """``x.reshape(shape)``.  A DTensor is first gathered along every
    sharded dim the reshape merges or splits, since DTensor's view rules
    refuse them; a dim that passes through whole keeps its sharding."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    if -1 in shape:
        known = math.prod(n for n in shape if n != -1)
        shape = tuple(x.numel() // known if n == -1 else n for n in shape)
    kept = _whole_dims(tuple(x.shape), tuple(shape))
    want = [p if not isinstance(p, Shard) or p.dim in kept else Replicate()
            for p in x.placements]
    if want != list(x.placements):
        x = x.redistribute(x.device_mesh, want)
    return x.reshape(*shape)


def _whole_dims(src: tuple, dst: tuple) -> set:
    """The dims of ``src`` that a reshape to ``dst`` carries over whole
    (a group of one dim on each side, of equal size)."""
    whole, i, j = set(), 0, 0
    while i < len(src) or j < len(dst):
        gi, gj = [i], [j]
        a = src[i] if i < len(src) else 1
        b = dst[j] if j < len(dst) else 1
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                a *= src[i]
                gi.append(i)
                i += 1
            else:
                b *= dst[j]
                gj.append(j)
                j += 1
        if len(gi) == 1 and len(gj) == 1 and gi[0] < len(src) and gj[0] < len(dst):
            whole.add(gi[0])
    return whole


def _ctr(cfg: ModelConfig):
    return functools.partial(
        contraction, strategy=cfg.contract_strategy, backend=cfg.contract_backend
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
    ok = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        ok &= rel >= 0
    if window is not None:
        ok &= rel < window
    return ok


@contextlib.contextmanager
def cached_rows(max_len: int):
    """Within the block every cached attention row's softmax is taken over
    ``max_len`` keys rounded up to a multiple of 16 (outside, over its
    cache's width).  A cached row is as wide as its cache: a serving
    runtime's slot cache (``max_len`` rows) or a page view of its pool (a
    lattice width).  The keys past a request's length come out of the
    softmax as exact zeros, but CUDA's softmax sums a row in an order that
    depends on its width (the kernel it picks by width, the row's split
    over threads and vector loads), so a request would get other bits from
    a page view than from its slot.  A runtime runs its model steps in
    this context with its ``max_len``: a narrower row is padded with
    masked keys and a wider one cut (its keys there lie past every
    request) to one width, at which every row starts 64-byte aligned.
    Per thread; nests."""
    prev = getattr(_ROWS, "width", None)
    _ROWS.width = -(-max_len // 16) * 16
    try:
        yield
    finally:
        _ROWS.width = prev


def _row_softmax(scores, width: int):
    """Softmax over the keys (last axis) of cached rows, taken over
    ``width`` keys: masked keys padded on, or the keys past ``width`` cut
    off and given probability 0."""
    T = scores.shape[-1]
    if T == width:
        return torch.softmax(scores, dim=-1)
    if T < width:
        return torch.softmax(F.pad(scores, (0, width - T), value=_NEG_INF), dim=-1)[..., :T]
    return F.pad(torch.softmax(scores[..., :width], dim=-1), (0, T - width))


def _write_rows(cache, update, start):
    """``update`` (B, S, ...) written into ``cache`` (B, T, ...) from row
    ``start`` (a scalar or one per batch row) on, out of place; the start
    is clamped to ``T - S`` as ``jax.lax.dynamic_update_slice`` clamps
    it."""
    B, S = update.shape[:2]
    start = start.clamp(0, cache.shape[1] - S).long()
    rows = start[..., None] + replicated(torch.arange(S, device=cache.device))  # (S,)/(B, S)
    rows = rows.expand(B, S)
    batch = replicated(torch.arange(B, device=cache.device))[:, None].expand(B, S)
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
    q = reshape(dense(cfg, x, params["wq"]), B, S, G, R, D)
    k = reshape(dense(cfg, x, params["wk"]), B, S, G, D)
    v = reshape(dense(cfg, x, params["wv"]), B, S, G, D)
    q = reshape(rope(reshape(q, B, S, H, D), positions, cfg.rope_theta), B, S, G, R, D)
    k = rope(k, positions, cfg.rope_theta)
    q = logical(q, "batch", None, "kv_heads", None, None)
    k = logical(k, "batch", None, "kv_heads", None)

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
        k_pos = replicated(torch.arange(T, device=x.device))
        valid = k_pos <= (idx + S - 1)[..., None]        # (1, T) or (B, T)
    else:
        k_pos = positions
        valid = None
        new_cache = None

    # one cached query row of a multi-query stack (a 1-token chunk, a
    # 1-slot decode): its scores and P·V would have no grid mode, so
    # native_gemm would take them as plain GEMMs and split P·V's
    # contraction over the cache width at width-dependent points, giving
    # the row other bits in a page view than in its slot, and than in a
    # pass of more rows.  A copy of the row keeps a grid mode: both
    # products stay unsplit, as in every other pass; the copy is dropped.
    one_row = kv_cache is not None and B == 1 and S == 1 and G == 1 and R > 1
    if one_row:
        q = torch.cat([q, q], dim=1)
        positions = torch.cat([positions, positions], dim=-1)

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
        width = getattr(_ROWS, "width", None)
        probs = (torch.softmax(scores, dim=-1) if kv_cache is None or width is None
                 else _row_softmax(scores, width)).to(x.dtype,
                                                      memory_format=torch.contiguous_format)

        out = ctr("bgrst,btgd->bsgrd", probs, v.to(x.dtype))
    if one_row:
        out = out[:, :S]
    out = reshape(out, B, S, H * D)
    out = dense(cfg, out, params["wo"], "bsh,he->bse")
    return logical(out, "batch", "seq_sharded", None), new_cache


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
        k_pos = torch.cat([k_pos, replicated(torch.full(
            (pad,), -(10**9), dtype=k_pos.dtype, device=k_pos.device))])
    nC = k.shape[1] // Ck
    kc = reshape(k, B, nC, Ck, G, D)
    vc = reshape(v, B, nC, Ck, G, D)
    pc = reshape(k_pos, nC, Ck)
    scale = D**-0.5

    m = replicated(torch.full((B, G, R, S), -torch.inf, dtype=torch.float32, device=q.device))
    l = replicated(torch.zeros((B, G, R, S), dtype=torch.float32, device=q.device))
    acc = replicated(torch.zeros((B, G, R, S, D), dtype=torch.float32, device=q.device))
    for i in range(nC):
        k_i, v_i, p_i = kc[:, i], vc[:, i], pc[i]
        s = contraction("bsgrd,btgd->bgrst", q, k_i, strategy="direct")
        s = s.float() * scale
        s = softcap(s, cfg.attn_softcap)
        ok = _attn_mask(q_pos, p_i, causal=causal, window=window)  # (S, Ck)
        s = torch.where(ok[None, None, None], s, _NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        upd = contraction("bgrst,btgd->bgrsd", p.to(q.dtype), v_i, strategy="direct").float()
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
    h = logical(h, "batch", None, "ff")
    return dense(cfg, h, params["wo"], "bsf,fe->bse")
