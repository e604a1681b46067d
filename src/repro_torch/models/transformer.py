"""The LM backbone: pattern blocks over all 10 architectures.

Layers are organised as ``prefix`` (run once, e.g. kimi's first dense
layer) + a repeating ``pattern`` run ``n_periods`` times with its
parameters **stacked over periods** (every pattern leaf has a leading
``n_periods`` axis), as in the JAX package, so its parameter trees carry
over one to one (:func:`repro_torch.interop.params_from_numpy`).

The port of ``repro.models.transformer``.  The ``jax.lax.scan`` over
periods is a loop that indexes the stack; ``remat`` checkpoints each
period (``torch.utils.checkpoint``) when autograd is on.

Caches come in two forms.  :func:`init_cache` gives the JAX package's:
one ``length`` scalar shared by every row.  The serving runtime keeps one
request per row, each at its own length: its caches hold ``length`` as a
``(B,)`` vector (and ``(n_periods, B)`` in the pattern), and
:func:`decode_step` on such a cache is one batched pass in which every row
takes its own positions, masks and cache rows, and every row routes its
MoE tokens as a dispatch group of its own — what the JAX runtime gets
from ``jax.vmap`` of :func:`decode_step` over batch-1 slots.
"""

from __future__ import annotations


import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed.sharding import current_rules, logical
from repro_torch.interop import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import _ctr, mesh_scope, replicated
from repro_torch.models.frontend import apply_frontend, init_frontend
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.ssm import init_mamba, init_ssm_cache, mamba_mixer
from repro_torch.models.tree import tree_map

__all__ = [
    "init_params", "forward", "prefill", "lm_loss", "init_cache",
    "decode_step", "Model",
]



# ------------------------------------------------------------------ blocks
def _init_block(gen, cfg: ModelConfig, spec: LayerSpec, *, lead=(), device=None):
    kw = dict(lead=lead, device=device)
    p = {
        "norm1": L.init_rms(gen, cfg.d_model, **kw),
        "norm2": L.init_rms(gen, cfg.d_model, **kw),
    }
    if spec.mixer == "attn":
        p["attn"] = L.init_attn(gen, cfg, **kw)
    else:
        p["mamba"] = init_mamba(gen, cfg, **kw)
    if spec.ff == "dense":
        p["mlp"] = L.init_mlp(gen, cfg, **kw)
    elif spec.ff == "moe":
        p["moe"] = init_moe(gen, cfg, **kw)
    return p


def _block(cfg: ModelConfig, spec: LayerSpec, params, x, *, positions, cache=None,
           moe_group=None):
    """Pre-norm residual block.  Returns (x, new_cache, aux)."""
    aux = {}
    h = L.rms_norm(x, params["norm1"], cfg.rms_eps)
    if spec.mixer == "attn":
        out, new_cache = L.attention(
            cfg, params["attn"], h, positions=positions,
            window=spec.window, kv_cache=cache,
        )
    else:
        out, new_cache = mamba_mixer(
            cfg, params["mamba"], h, positions=positions, kv_cache=cache
        )
    x = x + out
    if spec.ff != "none":
        h = L.rms_norm(x, params["norm2"], cfg.rms_eps)
        if spec.ff == "dense":
            x = x + L.mlp(cfg, params["mlp"], h)
        else:
            y, aux = moe_ffn(cfg, params["moe"], h, group=moe_group)
            x = x + y
    return x, new_cache, aux


# ------------------------------------------------------------------ params
def init_params(gen: torch.Generator | None, cfg: ModelConfig, *, device=None):
    """Random parameters drawn from ``gen`` on its device.  With
    ``gen=None`` pass ``device`` (``"meta"`` gives the tree's shapes and
    types without memory)."""
    if gen is None and device is None:
        raise ValueError("init_params needs a generator or a device")
    dt = getattr(torch, cfg.param_dtype)
    kw = dict(device=device)
    params = {
        "embed": (L.normal(gen, (cfg.vocab_size, cfg.d_model), **kw) * 0.02).to(dt),
        "final_norm": L.init_rms(gen, cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(gen, cfg.d_model, cfg.vocab_size, dt, **kw)
    if cfg.frontend is not None:
        params["frontend"] = init_frontend(gen, cfg, **kw)
    if cfg.prefix:
        params["prefix"] = [_init_block(gen, cfg, s, **kw) for s in cfg.prefix]
    # pattern params stacked over periods: tree of (n_periods, ...) leaves
    params["pattern"] = [
        _init_block(gen, cfg, s, lead=(cfg.n_periods,), **kw) for s in cfg.pattern
    ]
    return params


def _acc_aux(acc, aux):
    out = dict(acc)
    for k, v in (aux or {}).items():
        zero = torch.zeros((), dtype=torch.float32, device=v.device)
        out[k] = out.get(k, zero) + v.float().sum()
    return out


def _period(tree, i: int):
    """Period ``i`` of a tree stacked over periods (views)."""
    return tree_map(lambda t: t[i], tree)


# -------------------------------------------------------------- the stack
def _embed_inputs(cfg: ModelConfig, params, batch):
    dt = cfg.activation_dtype()
    if cfg.frontend is not None and cfg.frontend.kind == "audio":
        # audio: precomputed frames are the whole sequence (tokens = targets)
        return apply_frontend(cfg, params["frontend"], batch["features"].to(dt))
    x = params["embed"][replicated(batch["tokens"]).long()].to(dt)
    if cfg.frontend is not None:  # vision: prepend projected patch tokens
        x = apply_frontend(cfg, params["frontend"], batch["features"].to(dt), x)
    return x


def _run_stack(cfg: ModelConfig, params, x, positions, cache=None, remat=False,
               moe_group=None):
    """Shared stack runner.  Returns (x, new_cache | None, aux)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux_acc = {"load_balance_loss": zero}
    new_prefix = []
    prefix_caches = cache["prefix"] if cache is not None else [None] * len(cfg.prefix)
    for spec, p, c in zip(cfg.prefix, params.get("prefix", []), prefix_caches):
        x, nc, aux = _block(cfg, spec, p, x, positions=positions, cache=c,
                            moe_group=moe_group)
        aux_acc = _acc_aux(aux_acc, aux)
        new_prefix.append(nc)

    if cache is None:
        rules = current_rules()  # remat replays the body on autograd's thread

        def period_body(x, period_params):
            with mesh_scope(rules):
                aux_p = {"load_balance_loss": zero}
                for spec, p in zip(cfg.pattern, period_params):
                    x, _, aux = _block(cfg, spec, p, x, positions=positions,
                                       moe_group=moe_group)
                    aux_p = _acc_aux(aux_p, aux)
                return x, aux_p

        per_period = []
        for i in range(cfg.n_periods):
            pp = _period(params["pattern"], i)
            if remat and torch.is_grad_enabled():
                x, aux_p = checkpoint(period_body, x, pp, use_reentrant=False)
            else:
                x, aux_p = period_body(x, pp)
            per_period.append(aux_p)
        aux_acc = _acc_aux(aux_acc, {
            k: torch.stack([a[k] for a in per_period]).sum() for k in per_period[0]
        })
        return x, None, aux_acc

    per_period = []
    for i in range(cfg.n_periods):
        period_params, period_cache = _period(params["pattern"], i), _period(cache["pattern"], i)
        new_caches = []
        for j, spec in enumerate(cfg.pattern):
            x, nc, _ = _block(
                cfg, spec, period_params[j], x, positions=positions,
                cache=period_cache[j], moe_group=moe_group,
            )
            new_caches.append(nc)
        per_period.append(new_caches)
    new_pattern = [
        tree_map(lambda *xs: torch.stack(xs), *[p[j] for p in per_period])
        for j in range(len(cfg.pattern))
    ]
    new_cache = {
        "prefix": new_prefix,
        "pattern": new_pattern,
        "length": cache["length"] + positions.shape[-1],
    }
    return x, new_cache, aux_acc


def _lm_head(cfg: ModelConfig, params, x):
    dt = cfg.activation_dtype()
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    spec = "bse,ve->bsv" if cfg.tie_embeddings else "bse,ev->bsv"
    logits = _ctr(cfg)(spec, x, head.to(dt))
    logits = L.softcap(logits.float(), cfg.final_softcap)
    return logical(logits, "batch", None, "vocab")


def _positions(cache, n: int, device):
    """Absolute positions of ``n`` new tokens after the cache's length:
    ``(n,)`` for a shared length, ``(B, n)`` for one per row."""
    return cache["length"][..., None] + replicated(torch.arange(n, device=device))


def _row_groups(cache, n: int):
    """Tokens per MoE dispatch group: one row's, when each row is a
    request of its own (a ``(B,)`` length vector), else the default."""
    return n if cache["length"].ndim == 1 else None


# ----------------------------------------------------------------- forward
def forward(cfg: ModelConfig, params, batch, *, remat: bool = True):
    """Training forward.  Returns (logits, aux)."""
    with mesh_scope():
        x = _embed_inputs(cfg, params, batch)
        x = logical(x, "batch", "seq_sharded", None)
        positions = replicated(torch.arange(x.shape[1], device=x.device))
        x, _, aux = _run_stack(cfg, params, x, positions, remat=remat)
        return _lm_head(cfg, params, x), aux


def prefill(cfg: ModelConfig, params, batch, cache):
    """Serving prefill: runs the prompt, fills the cache.

    Returns (last_logits (B, V), new_cache).  Only the last position hits
    the LM head.  Positions continue from ``cache["length"]``, so a prompt
    may be prefilled in chunks (the runtime's chunked prefill)."""
    with mesh_scope():
        x = _embed_inputs(cfg, params, batch)
        positions = _positions(cache, x.shape[1], x.device)
        x, new_cache, _ = _run_stack(cfg, params, x, positions, cache=cache,
                                     moe_group=_row_groups(cache, x.shape[1]))
        return _lm_head(cfg, params, x[:, -1:])[:, -1], new_cache


def lm_loss(cfg: ModelConfig, params, batch, *, remat: bool = True,
            lb_coeff: float = 0.01):
    """Next-token (or frame-target) cross-entropy + MoE balance loss.

    The log-likelihoods are :func:`~repro_torch.models.layers.token_nll`'s:
    under sharding rules each rank keeps its own vocab block of the logits
    and of their gradient."""
    with mesh_scope():
        logits, aux = forward(cfg, params, batch, remat=remat)
        if cfg.encoder_only or cfg.frontend is not None:
            # targets provided explicitly, aligned to the end of the sequence
            targets = batch["labels"]
            logits_t = logits[:, -targets.shape[1]:]
        else:
            targets = batch["tokens"][:, 1:]
            logits_t = logits[:, :-1]
        nll = L.token_nll(logits_t, targets)
        mask = batch.get("mask")
        if mask is not None:
            mask = mask[:, -targets.shape[1]:]
            loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
        else:
            loss = torch.mean(nll)
        total = loss + lb_coeff * aux.get("load_balance_loss", 0.0)
        return total, {"ce_loss": loss, **aux}


# ------------------------------------------------------------------ decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *, device="cuda"):
    """Per-layer cache, stacked over periods for the pattern; one
    ``length`` scalar for all rows (the JAX package's form)."""
    dt = dtype or cfg.activation_dtype()
    dev = resolve_device(device)
    G, D = cfg.n_kv_heads, cfg.hd

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def one(spec: LayerSpec, lead=()):
        if spec.mixer == "attn":
            rows = lead + (batch, max_len, G)
            if cfg.kv_quant:
                return {
                    "k": zeros(rows + (D,), torch.int8),
                    "v": zeros(rows + (D,), torch.int8),
                    "k_scale": zeros(rows, torch.float32),
                    "v_scale": zeros(rows, torch.float32),
                    "length": zeros(lead, torch.int32),
                }
            return {
                "k": zeros(rows + (D,), dt),
                "v": zeros(rows + (D,), dt),
                "length": zeros(lead, torch.int32),
            }
        return init_ssm_cache(cfg, batch, dt, lead=lead, device=dev)

    prefix = [one(s) for s in cfg.prefix]
    pattern = [one(s, (cfg.n_periods,)) for s in cfg.pattern]
    return {"prefix": prefix, "pattern": pattern, "length": zeros((), torch.int32)}


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step.  tokens: (B, 1).  Returns (logits (B, V), new_cache).

    On a cache whose ``length`` is a ``(B,)`` vector, each row decodes as
    a request of its own (see the module docstring)."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.arch_id} is encoder-only: no decode step")
    dt = cfg.activation_dtype()
    with mesh_scope():
        x = params["embed"][tokens.long()].to(dt)
        pos = _positions(cache, 1, x.device)
        x, new_cache, _ = _run_stack(cfg, params, x, pos, cache=cache,
                                     moe_group=_row_groups(cache, 1))
        return _lm_head(cfg, params, x)[:, -1], new_cache


class Model:
    """Thin OO wrapper tying config + functions (public API convenience)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, gen):
        return init_params(gen, self.cfg)

    def __call__(self, params, batch, **kw):
        return forward(self.cfg, params, batch, **kw)

    def loss(self, params, batch, **kw):
        return lm_loss(self.cfg, params, batch, **kw)

    def prefill(self, params, batch, cache):
        return prefill(self.cfg, params, batch, cache)

    def init_cache(self, batch, max_len, dtype=None, *, device="cuda"):
        return init_cache(self.cfg, batch, max_len, dtype, device=device)

    def decode_step(self, params, cache, tokens):
        return decode_step(self.cfg, params, cache, tokens)
