"""Fault-tolerant training loop.

* the train step: gradients (accumulated over microbatches) → optional
  compression (bf16 / int8 with error feedback) → AdamW;
* checkpoint/restart (atomic, manifest-driven) including the data cursor
  and the optimizer step;
* straggler accounting — a per-step deadline; steps that exceed it are
  logged and counted.

The port of ``repro.training.trainer``.  The step runs eagerly (no
``torch.compile``): :func:`make_train_step` returns a plain function of
``(params, opt_state, batch, residual)`` whose gradients come from
``torch.autograd.grad`` on detached copies of the parameter leaves, so the
trees stay plain tensors, as the JAX package's stay arrays.  A leaf the
loss does not reach gets a zero gradient, as under ``jax.grad``.

On ``contract_backend="kernel"`` every model contraction of the forward
and the backward is a ``native_gemm`` launch when the config says
``contract_strategy="native"`` (each product's backward is two native
contractions).  The role-based strategies are forward-only on the kernel
backend and raise under autograd (:func:`repro_torch.kernels.ops.
execute_plan`), as the JAX package's ``pallas`` backend does.

``Trainer(rules=ShardingRules(mesh))`` trains on a mesh: the parameters
are placed by :func:`~repro_torch.launch.shardings.param_logical_axes`,
the AdamW moments by :func:`~repro_torch.launch.shardings.
opt_state_logical_axes` (ZeRO-1) and each batch by
:func:`~repro_torch.launch.shardings.batch_logical_axes`, all DTensors
over views of the global values; every rank draws the same global batch
from the same data seed, and each step runs under ``use_rules``, so every
model contraction takes the mesh route (local blocks, explicit
collectives; on the kernel backend one ``native_gemm`` launch per block
product).  Gradients still come from ``torch.autograd.grad`` on detached
leaves, now DTensors.  bf16 and int8 compression and microbatches work on
them; the int8 residual is placed as the parameters and travels in
:meth:`Trainer.state_tree`, so a sharded checkpoint holds it.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compress import Int8Compressor, compress_bf16
from repro_torch.distributed.sharding import device_put, reduce_partial, use_rules
from repro_torch.models.transformer import lm_loss
from repro_torch.models.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update, make_schedule

log = logging.getLogger("repro_torch.trainer")

__all__ = ["TrainConfig", "Trainer", "make_train_step", "value_and_grad"]


@dataclasses.dataclass
class TrainConfig:
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    microbatches: int = 1              # gradient accumulation
    remat: bool = True
    compression: str | None = None     # None | "bf16" | "int8"
    step_deadline_s: float | None = None  # straggler threshold
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    ckpt_keep: int = 3


def value_and_grad(cfg: ModelConfig, params, batch, *, remat: bool = True):
    """``lm_loss`` and its gradient with respect to every parameter leaf:
    ``(loss, metrics, grads)``, all detached; ``grads`` has the structure
    of ``params`` (a leaf the loss does not reach gets zeros)."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = lm_loss(cfg, tree_unflatten(params, live), batch, remat=remat)
        loss = reduce_partial(loss)  # a mean over a sharded batch is pending
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, compressor=None):
    """Build the train step: grads (+accum) → compress → AdamW."""
    schedule = make_schedule(tcfg.opt)

    def train_step(params, opt_state, batch, residual=None):
        if tcfg.microbatches > 1:
            # split the batch's leading dim into microbatches; accumulate grads
            n = tcfg.microbatches
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            lsum = 0.0
            for i in range(n):
                micro = {k: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
                         for k, x in batch.items()}
                loss_i, _, g = value_and_grad(cfg, params, micro, remat=tcfg.remat)
                gsum = tree_map(lambda a, b: a + b.float(), gsum, g)
                lsum = lsum + loss_i
            grads = tree_map(lambda g: g / n, gsum)
            loss = lsum / n
            metrics = {}
        else:
            loss, metrics, grads = value_and_grad(cfg, params, batch, remat=tcfg.remat)

        new_residual = residual
        if tcfg.compression == "bf16":
            grads = compress_bf16(grads)
        elif tcfg.compression == "int8":
            grads, new_residual = compressor.compress(grads, residual)

        params, opt_state, opt_metrics = adamw_update(
            tcfg.opt, params, grads, opt_state, schedule=schedule
        )
        out_metrics = {"loss": loss, **opt_metrics}
        if metrics:
            out_metrics.update(metrics)
        return params, opt_state, new_residual, out_metrics

    return train_step


def _scalar(v) -> float:
    """A metric as a Python float (a DTensor's global value)."""
    from torch.distributed.tensor import DTensor

    return float(v.full_tensor() if isinstance(v, DTensor) else v)


class Trainer:
    """Owns params/opt-state/data and runs the fault-tolerant loop.

    Training runs on the device that holds ``params``; each batch from
    ``data`` (numpy) is placed there."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, params, data, rules=None):
        self.cfg, self.tcfg, self.data = cfg, tcfg, data
        self.rules = rules
        self.device = tree_leaves(params)[0].device
        self.opt_state = adamw_init(params)
        self.params = params
        self.compressor = Int8Compressor() if tcfg.compression == "int8" else None
        if rules is not None:
            from repro_torch.launch import shardings as sh

            self.shardings = {
                "params": sh.tree_shardings(rules, sh.param_logical_axes(params), params),
                "opt": sh.tree_shardings(rules, sh.opt_state_logical_axes(params),
                                         self.opt_state),
            }
            if self.compressor:
                self.shardings["residual"] = self.shardings["params"]
            self.params = device_put(params, self.shardings["params"])
            self.opt_state = device_put(self.opt_state, self.shardings["opt"])
        self.residual = (
            self.compressor.init_residual(self.params) if self.compressor else None
        )
        self.step = 0
        self.straggler_steps = 0
        self.ckpt = (
            Checkpointer(tcfg.ckpt_dir, keep=tcfg.ckpt_keep, every=tcfg.ckpt_every)
            if tcfg.ckpt_dir else None
        )
        self._step_fn = make_train_step(cfg, tcfg, self.compressor)

    # -------------------------------------------------------------- state
    def state_tree(self):
        tree = {"params": self.params, "opt": self.opt_state}
        if self.residual is not None:
            tree["residual"] = self.residual
        return tree

    def save(self, force=False):
        if self.ckpt is None:
            return None
        extra = {"step": self.step, "data": self.data.state(),
                 "straggler_steps": self.straggler_steps}
        return self.ckpt.maybe_save(self.step, self.state_tree(), extra, force=force)

    def restore(self, shardings=None):
        """Resume from the latest checkpoint (written on any mesh, or none),
        onto this trainer's device; with ``shardings`` (a tree matching
        :meth:`state_tree`) each leaf is placed on its sharding.  A
        trainer under rules places onto its own shardings by default."""
        if shardings is None and self.rules is not None:
            shardings = self.shardings
        tree, extra, step = self.ckpt.restore(self.state_tree(), shardings)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.residual = tree.get("residual", self.residual)
        self.step = int(extra["step"])
        self.straggler_steps = int(extra.get("straggler_steps", 0))
        self.data.restore(extra["data"])
        return step

    def place_batch(self, arrays: dict) -> dict:
        """A numpy batch on this trainer's device; under rules, a DTensor
        per leaf, sharded by :func:`~repro_torch.launch.shardings.
        batch_logical_axes` over a view of the global batch."""
        batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                 for k, v in arrays.items()}
        if self.rules is None:
            return batch
        from repro_torch.launch import shardings as sh

        return device_put(batch, sh.tree_shardings(
            self.rules, sh.batch_logical_axes(batch), batch))

    # --------------------------------------------------------------- loop
    def run(self, n_steps: int, *, log_every: int = 10, on_metrics=None):
        history = []
        for _ in range(n_steps):
            batch = self.place_batch(next(self.data))
            t0 = time.monotonic()
            with use_rules(self.rules):
                self.params, self.opt_state, self.residual, metrics = self._step_fn(
                    self.params, self.opt_state, batch, self.residual
                )
            metrics = {k: _scalar(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            metrics["step_time_s"] = dt
            if (
                self.tcfg.step_deadline_s is not None
                and dt > self.tcfg.step_deadline_s
            ):
                self.straggler_steps += 1
                log.warning("straggler step %d: %.2fs > deadline %.2fs",
                            self.step, dt, self.tcfg.step_deadline_s)
            self.step += 1
            history.append(metrics)
            if on_metrics and self.step % log_every == 0:
                on_metrics(self.step, metrics)
            self.save()
        return history
