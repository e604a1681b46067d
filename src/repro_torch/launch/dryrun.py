"""Multi-pod dry run: trace every (arch × shape × mesh) cell's step on a
fake world.

The scale proof for the production meshes — 16×16 (one 256-rank pod) and
2×16×16 (two pods, 512 ranks).  The JAX package lowers and compiles each
cell's step against abstract arrays; the port has no compiler, so it
*runs* one step of the real model code on fake tensors (``FakeTensorMode``:
shapes, types and devices, no memory) in a fake process group of 256 or
512 ranks, as rank 0, under :class:`repro_torch.utils.CostCounter`.  The
record holds that rank's flops, bytes (an unfused upper bound, and the
traffic of the step fused down to its products), collective bytes by kind
and the peak of its live storage, which feed
:mod:`repro_torch.launch.roofline`.

The fake world is started inside :func:`dryrun_cell` and destroyed on the
way out, on an error too; nothing runs at import and no environment
variable is set.  A world already started (a real one) makes
:func:`dryrun_cell` raise: it never joins or tears down a world it did not
start.

A cell on ``contract_backend="kernel"`` traces too: ``native_gemm`` is the
registered operator ``repro_torch::native_gemm``, whose fake kernel
(``_native_gemm_fake`` in :mod:`repro_torch.kernels.sb_gemm`) gives C's
shape, type and device, so each local block product of the mesh route is
one op of the trace.  Its flop formula makes it a product of the counter
(its flops, the storages it reads and writes in the fused bytes), the
record's ``ops`` counts its calls (the launches a rank would make) and
``routes`` their routes, planned as the card plans them (a fake tensor's
start taken as its storage offset over a 256-byte aligned base).  A
split's partial sums are allocated inside the CUDA kernel's launch, so
neither the trace nor a counter around a real step sees them.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b \\
        --shape train_4k [--multi-pod] [--device cuda|cpu] [--out results/torch/dryrun] \\
        [--cfg-overrides '{"n_periods": 4}']
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k \\
        --cfg-overrides '{"contract_backend": "kernel", "contract_strategy": "native"}'
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable_shapes
from repro_torch.distributed.sharding import ShardingRules, device_put, own_block, use_rules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shardings import (
    batch_logical_axes,
    cache_logical_axes,
    opt_state_logical_axes,
    param_logical_axes,
    tree_shardings,
)
from repro_torch.models.transformer import decode_step, init_cache, init_params, prefill
from repro_torch.models.tree import tree_map
from repro_torch.training.data import make_batch_specs
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.trainer import TrainConfig
from repro_torch.training.trainer import make_train_step as _trainer_step
from repro_torch.utils import CostCounter

__all__ = [
    "COLLECTIVES", "arch_preset", "shape_rules_overrides", "make_train_step",
    "make_serve_step", "make_prefill_step", "input_specs", "fake_world", "shard_blocks",
    "trace_step", "dryrun_cell",
]

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


# ----------------------------------------------------------------- presets
def arch_preset(cfg):
    """Scale-dependent training preset (documented in DESIGN.md §5)."""
    if cfg.param_count() > 5e11:  # kimi-k2: bf16 master + bf16 moments
        cfg = cfg.with_(param_dtype="bfloat16")
        opt = AdamWConfig(moment_dtype="bfloat16")
    else:
        opt = AdamWConfig()
    return cfg, opt


def shape_rules_overrides(cfg, shape: ShapeSpec) -> dict:
    over = {}
    if shape.kind == "decode":
        if shape.global_batch < 32:
            # long_500k: batch unshardable — put everything on the KV seq
            over["batch"] = None
            over["kv_seq"] = ("data", "model")
    return over


# ------------------------------------------------------------------- steps
def make_train_step(cfg, opt_cfg):
    """``(params, opt_state, batch) → (params, opt_state, metrics)``: the
    trainer's step (loss and gradients, then AdamW)."""
    step = _trainer_step(cfg, TrainConfig(opt=opt_cfg))

    def train_step(params, opt_state, batch):
        params, opt_state, _, metrics = step(params, opt_state, batch)
        return params, opt_state, metrics

    return train_step


def make_serve_step(cfg):
    def serve_step(params, cache, batch):
        return decode_step(cfg, params, cache, batch["tokens"])

    return serve_step


def make_prefill_step(cfg):
    def prefill_step(params, batch, cache):
        return prefill(cfg, params, batch, cache)

    return prefill_step


# ----------------------------------------------------------------- dry run
def input_specs(cfg, shape: ShapeSpec) -> dict:
    """Meta tensors (shape and type, no memory) for every model input of
    this cell."""
    if shape.kind == "decode":
        return {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                      device="meta")}
    return make_batch_specs(cfg, shape)


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0) for
    the ``with`` block; destroyed on the way out.  Raises if a world is
    already started."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already initialised: the dry run starts a fake world of its "
            "own and never joins or tears down another")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def shard_blocks(tree, shardings):
    """``tree`` on ``shardings``, each rank's block in a storage of its own
    (``device_put`` gives views of the global tensor's)."""
    return tree_map(own_block, device_put(tree, shardings))


def trace_step(cfg, opt_cfg, shape: ShapeSpec, rules: ShardingRules, device: str) -> dict:
    """Build this cell's fake arguments on ``rules``' mesh and run its step
    once under a :class:`~repro_torch.utils.CostCounter`.  Needs a world
    with the mesh's ranks.  Returns the counter's costs with
    ``lower_s`` (seconds to build the fake parameters
    and place them) and ``compile_s`` (seconds of the traced step)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def shard(tree, axes):
        return shard_blocks(tree, tree_shardings(rules, axes, tree))

    t0 = time.perf_counter()
    with FakeTensorMode():
        params = init_params(None, cfg, device=device)
        args = [shard(params, param_logical_axes(params))]
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in input_specs(cfg, shape).items()}
        batch = shard(batch, batch_logical_axes(batch))
        if shape.kind == "train":
            opt = adamw_init(params, getattr(torch, opt_cfg.moment_dtype))
            args += [shard(opt, opt_state_logical_axes(params)), batch]
            step = make_train_step(cfg, opt_cfg)
        else:
            cache_len = shape.seq_len
            if shape.kind == "prefill" and cfg.frontend and cfg.frontend.kind == "vision":
                cache_len += cfg.frontend.n_positions
            cache = init_cache(cfg, shape.global_batch, cache_len, device=device)
            cache = shard(cache, cache_logical_axes(cache))
            if shape.kind == "prefill":
                args += [batch, cache]
                step = make_prefill_step(cfg)
            else:
                args += [cache, batch]
                step = make_serve_step(cfg)
        del params, batch
        lower_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        with CostCounter() as counter, use_rules(rules):
            counter.hold(args)
            counter.output(step(*args))
        compile_s = time.perf_counter() - t0
    return {**counter.costs(), "lower_s": lower_s, "compile_s": compile_s}


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                rules_overrides: dict | None = None, verbose: bool = True,
                cfg_overrides: dict | None = None, device: str = "cuda"):
    """Trace one (arch × shape × mesh) cell; return the record.

    The record has the JAX package's keys.  ``lower_s`` is the seconds
    taken to build the fake parameters, optimizer state, cache and batch
    and place them on the mesh; ``compile_s`` the seconds of the traced
    step.  Costs are rank 0's, from :class:`~repro_torch.utils.CostCounter`
    (``bytes_accessed`` is its unfused upper bound and, beyond the JAX
    package's keys, ``fused_bytes_accessed`` the traffic of the step fused
    down to its products, which the roofline's memory term divides;
    ``peak_bytes_per_device``
    the peak of live storage, arguments included; ``temp_bytes`` the peak
    less the arguments; ``peak_live``, beyond the JAX package's keys, the
    largest storages live at that peak; ``ops``, the products' calls by op,
    and ``routes``, ``native_gemm``'s by route).  ``device`` is the fake tensors' device (the
    card's by default; ``"cpu"`` traces the same step without one).  With
    ``cfg_overrides`` the record carries them, so that
    :mod:`repro_torch.launch.roofline` rebuilds the same config."""
    cfg = get_config(arch, **(cfg_overrides or {}))
    shape = SHAPES[shape_name]
    app = applicable_shapes(cfg)
    if app[shape_name] is None:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": _skip_reason(cfg, shape_name)}
    cfg, opt_cfg = arch_preset(cfg)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        over = shape_rules_overrides(cfg, shape)
        over.update(rules_overrides or {})
        c = trace_step(cfg, opt_cfg, shape, ShardingRules(mesh, over), device)

    record = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "multi_pod": multi_pod,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "status": "ok",
        "lower_s": round(c["lower_s"], 1),
        "compile_s": round(c["compile_s"], 1),
        "flops": c["flops"],
        "bytes_accessed": c["bytes"],
        "fused_bytes_accessed": c["fused_bytes"],
        "peak_bytes_per_device": c["peak_bytes"],
        "temp_bytes": c["temp_bytes"],
        "argument_bytes": c["argument_bytes"],
        "output_bytes": c["output_bytes"],
        "peak_live": c["peak_live"],
        "collective_bytes": {k: c["collective_bytes"][k] for k in COLLECTIVES},
        "collective_counts": {k: c["collective_counts"][k] for k in COLLECTIVES},
        "ops": c["ops"],
        "routes": c["routes"],
        "params": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
    }
    if cfg_overrides:
        record["cfg_overrides"] = dict(cfg_overrides)
    if verbose:
        print(json.dumps(record))
    return record


def _skip_reason(cfg, shape_name: str) -> str:
    if cfg.encoder_only:
        return "encoder-only arch: no autoregressive decode step exists"
    return "long_500k requires sub-quadratic attention; this arch is full-attention"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) on both meshes")
    ap.add_argument("--out", default="results/torch/dryrun")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device")
    ap.add_argument("--cfg-overrides", type=json.loads, default=None,
                    help='config fields as JSON, e.g. \'{"n_periods": 4}\'')
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    from repro_torch.configs import list_archs

    cells = []
    if args.all:
        for arch in list_archs():
            for shape in SHAPES:
                for mp in (False, True):
                    cells.append((arch, shape, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape, args.multi_pod))

    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip existing] {tag}")
            continue
        print(f"[dryrun] {tag}")
        try:
            rec = dryrun_cell(arch, shape, multi_pod=mp, device=args.device,
                              cfg_overrides=args.cfg_overrides)
        except Exception as e:  # a failure here is a bug in the system
            rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                   "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
            print(json.dumps(rec))
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
