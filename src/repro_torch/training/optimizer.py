"""AdamW with schedules (cosine / WSD), clipping and accumulation.

Plain tensor arithmetic (no ``torch.optim``): the optimizer state mirrors
the parameter tree, and one update is a pure function of (params, grads,
state) returning new trees, as in the JAX package.

WSD (warmup–stable–decay) is the MiniCPM schedule: linear warmup → long
flat stage → short decay tail; it is the training preset for minicpm-2b.

The port of ``repro.training.optimizer``.  Every step of the arithmetic
is the JAX package's, in its order and in float32 (a schedule's step is
taken as float32, a Python scalar joins as float32); the update runs under
``torch.no_grad()``.

On DTensor trees (a trainer under sharding rules) the moments may be
placed otherwise than the parameters (ZeRO-1 shards them over ``data``):
each gradient is redistributed to its moments' placements, the update is
computed on the moments' blocks, and the new parameter is redistributed
back to the parameter's placements.  Elementwise arithmetic per element is
the same, so only the global norm's sum order can differ from one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models.tree import tree_leaves, tree_map

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "global_norm", "clip_by_global_norm",
    "cosine_schedule", "wsd_schedule", "constant_schedule", "make_schedule",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"            # "cosine" | "wsd" | "constant"
    warmup_steps: int = 100
    total_steps: int = 10_000
    stable_frac: float = 0.8            # WSD: fraction of run at peak lr
    #: moment storage dtype.  f32 default; bf16 for trillion-scale presets.
    moment_dtype: str = "float32"


# ----------------------------------------------------------------- schedules
def _step(step) -> torch.Tensor:
    """The step as a float32 tensor (the JAX package divides an int32 step
    into float32)."""
    return torch.as_tensor(step).to(torch.float32)


def _warm(cfg: AdamWConfig, step):
    return torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)


def constant_schedule(cfg: AdamWConfig):
    def f(step):
        return cfg.lr * _warm(cfg, _step(step))
    return f


def cosine_schedule(cfg: AdamWConfig):
    def f(step):
        step = _step(step)
        warm = _warm(cfg, step)
        t = torch.clamp(
            (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
            0.0, 1.0,
        )
        return cfg.lr * warm * (0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * t)))
    return f


def wsd_schedule(cfg: AdamWConfig):
    """Warmup → stable plateau → 1-sqrt decay tail (MiniCPM §4)."""
    decay_start = cfg.warmup_steps + int(
        cfg.stable_frac * (cfg.total_steps - cfg.warmup_steps)
    )

    def f(step):
        step = _step(step)
        warm = _warm(cfg, step)
        t = torch.clamp(
            (step - decay_start) / max(cfg.total_steps - decay_start, 1),
            0.0, 1.0,
        )
        decay = 1.0 - (1.0 - 0.1) * torch.sqrt(t)
        return cfg.lr * warm * decay
    return f


def make_schedule(cfg: AdamWConfig) -> Callable:
    return {"cosine": cosine_schedule, "wsd": wsd_schedule,
            "constant": constant_schedule}[cfg.schedule](cfg)


# ------------------------------------------------------------------- adamw
def adamw_init(params, moment_dtype=torch.float32):
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    # Python's sum, left to right over the leaves, as the JAX package adds
    return torch.sqrt(
        sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    )


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _placed_like(x, ref):
    """``x`` redistributed to ``ref``'s placements, where both are DTensors."""
    from torch.distributed.tensor import DTensor

    if (isinstance(x, DTensor) and isinstance(ref, DTensor)
            and tuple(x.placements) != tuple(ref.placements)):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, *, schedule=None):
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    schedule = schedule or make_schedule(cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = schedule(step)
    b1, b2 = cfg.b1, cfg.b2

    grads = tree_map(_placed_like, grads, state["mu"])
    mu = tree_map(lambda m, g: (b1 * m.float() + (1 - b1) * g).to(m.dtype),
                  state["mu"], grads)
    nu = tree_map(lambda v, g: (b2 * v.float() + (1 - b2) * g * g).to(v.dtype),
                  state["nu"], grads)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, m, v):
        m, v = m.float(), v.float()
        pm = _placed_like(p, m)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * pm.float()
        return _placed_like((pm.float() - lr * u).to(p.dtype), p)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "step": step}, {
        "lr": lr, "grad_norm": gnorm,
    }
