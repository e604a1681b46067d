"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --smoke \
        --steps 20 [--device cpu] [--ckpt-dir DIR [--resume]]

Trains on the card by default; ``--device cpu`` trains on the CPU.  The
weights are random, drawn from a ``torch.Generator`` seeded 0 on the
training device; the data is :class:`~repro_torch.training.data.SyntheticLM`
seeded 0.  Checkpoints are atomic; ``--resume`` continues from the
manifest's latest step (params, optimizer, data cursor).

``--mesh DATAxMODEL`` trains sharded (``Trainer(rules=)``): ``1x1`` in
this process; more ranks under the launcher, e.g.

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch minicpm-2b --smoke --device cpu --mesh 1x2

(gloo with ``--device cpu``, NCCL on the card).  Every rank draws the same
weights and batches; only rank 0 prints.

The port of ``repro.launch.train``, with its flags plus ``--device``.  The
JAX package simulates a multi-device mesh in one process; the port runs
one process per rank.
"""

from __future__ import annotations

import argparse
import logging

import torch

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.interop import resolve_device
from repro_torch.launch.mesh import cli_mesh
from repro_torch.models.transformer import init_params
from repro_torch.models.tree import tree_leaves
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: the card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default=None,
                    help="cosine|wsd|constant (minicpm defaults to wsd)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default=None, choices=[None, "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x4 (data x model); more than one rank runs under "
                         "python -m torch.distributed.run")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    with cli_mesh(args.mesh, device.type) as mesh:
        train(args, device, mesh)


def train(args, device, mesh):
    cfg = get_config(args.arch, smoke=args.smoke)
    # the WSD schedule is minicpm's training preset (its paper contribution)
    schedule = args.schedule or ("wsd" if args.arch.startswith("minicpm") else "cosine")

    params = init_params(torch.Generator(device).manual_seed(0), cfg)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.arch_id} params={n_params:,} device={device}")

    data = SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, seed=0,
        with_features=(
            (cfg.frontend.n_positions or None, cfg.frontend.feature_dim)
            if cfg.frontend else None),
        labels=cfg.frontend is not None or cfg.encoder_only,
    )
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, schedule=schedule, warmup_steps=20,
                        total_steps=args.steps),
        microbatches=args.microbatches,
        compression=args.compression,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
    )
    trainer = Trainer(cfg, tcfg, params, data,
                      rules=ShardingRules(mesh) if mesh is not None else None)
    if mesh is not None:
        print(f"mesh: {args.mesh} over {mesh.size()} {device.type} ranks")
    if args.resume and args.ckpt_dir:
        step = trainer.restore()
        print(f"resumed from step {step}")

    trainer.run(
        args.steps, log_every=min(10, args.steps),
        on_metrics=lambda s, m: print(
            f"step {s}: loss={m['loss']:.4f} lr={m['lr']:.2e} "
            f"gnorm={m['grad_norm']:.2f} dt={m['step_time_s']*1e3:.0f}ms"
        ),
    )
    if args.ckpt_dir:
        trainer.save(force=True)
        print(f"final checkpoint at step {trainer.step}")


if __name__ == "__main__":
    main()
