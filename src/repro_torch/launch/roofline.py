"""Roofline analysis of the dry run's records (§Roofline), with the
ceilings of the card the port runs on.

Terms per (arch × shape) on the single-pod mesh, per device:

    compute    = flops / peak(activation dtype)            [s]
    memory     = fused_bytes_accessed / HBM rate           [s]
    collective = collective bytes / link rate              [s]

The ceilings are :data:`repro_torch.obs.roofline.DEVICE_PEAKS`' entry for
the card (``device_name``, by default ``"NVIDIA H100 80GB HBM3"``): 989
TFLOP/s in bf16, 3.35 TB/s HBM, 900 GB/s NVLink.  A 16×16 H100 mesh spans
32 nodes of eight cards, and across nodes a card has its network's rate,
not NVLink's: the collective term at 900 GB/s is a lower bound.  The
memory term divides :class:`repro_torch.utils.CostCounter`'s fused count
(each storage that the step takes or returns, or that a product reads or
writes, once), so the largest term is a lower bound on the step's time
where every product reads and writes memory.  The unfused count (every
op's inputs and outputs in full, an upper bound) is kept beside it as
``unfused_bytes_per_chip``.

The JAX package corrects every term by ``(n_periods - 1) × body``
because XLA counts a ``lax.scan`` body once.  The port runs its periods as
a Python loop (``models/transformer.py``), so the traced record already
holds every period: :func:`roofline_cell` takes it as it is.
:func:`body_costs` gives one period's costs, for
:mod:`repro_torch.launch.perf` to print.

MODEL_FLOPS uses 6·N·D for training (2·N·D for inference), N = active
params for MoE; the ratio MODEL_FLOPS / traced flops exposes remat and
redundancy overhead.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import dryrun_cell
from repro_torch.obs.roofline import device_peaks

__all__ = ["roofline_cell", "body_costs", "DEFAULT_DEVICE"]

#: the card whose ceilings a row uses unless told otherwise
DEFAULT_DEVICE = "NVIDIA H100 80GB HBM3"


def _sum_collectives(coll: dict) -> int:
    return sum(coll.values())


def body_costs(arch: str, shape_name: str, cfg_overrides: dict | None = None, *,
               device: str = "cuda"):
    """One pattern period's per-device cost terms (``flops``, ``bytes`` —
    the fused count —, ``collective``): the cell on the single-pod mesh
    traced with two periods less the cell traced with one, through
    :func:`~repro_torch.launch.dryrun.dryrun_cell` with ``cfg_overrides``."""
    recs = [dryrun_cell(arch, shape_name, verbose=False, device=device,
                        cfg_overrides={**(cfg_overrides or {}), "n_periods": n})
            for n in (2, 1)]
    two, one = ({"flops": r["flops"], "bytes": r["fused_bytes_accessed"],
                 "collective": _sum_collectives(r["collective_bytes"])} for r in recs)
    return {k: two[k] - one[k] for k in two}


def roofline_cell(arch: str, shape_name: str, record: dict, *,
                  cfg_overrides: dict | None = None, device_name: str = DEFAULT_DEVICE):
    """A dry-run record's three roofline terms on the card ``device_name``.
    The config is ``arch``'s with ``cfg_overrides`` (by default the
    record's own), so model flops count the depth that was traced."""
    over = cfg_overrides if cfg_overrides is not None else record.get("cfg_overrides")
    cfg = get_config(arch, **(over or {}))
    shape = SHAPES[shape_name]
    peaks = device_peaks(device_name)
    peak_flops = peaks["flops_per_s"][str(cfg.activation_dtype()).removeprefix("torch.")]

    flops = record["flops"]
    bytes_ = record["fused_bytes_accessed"]
    coll = _sum_collectives(record["collective_bytes"])

    t_compute = flops / peak_flops
    t_memory = bytes_ / peaks["hbm_bytes_per_s"]
    t_collective = coll / peaks["link_bytes_per_s"]
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_collective}
    bottleneck = max(terms, key=terms.get)

    chips = 512 if record.get("multi_pod") else 256
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    n_active = cfg.param_count(active_only=True)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_active * tokens
    hlo_total = flops * chips
    useful = model_flops / hlo_total if hlo_total else 0.0
    # roofline fraction: useful model flops per chip-second at the bound
    t_bound = max(terms.values())
    mfu_bound = (model_flops / chips / peak_flops) / t_bound if t_bound else 0.0

    return {
        "arch": arch, "shape": shape_name, "chips": chips,
        "flops_per_chip": flops, "bytes_per_chip": bytes_,
        "collective_bytes_per_chip": coll,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_collective, "bottleneck": bottleneck,
        "model_flops": model_flops, "useful_flops_ratio": useful,
        "roofline_fraction": mfu_bound,
        "unfused_bytes_per_chip": record["bytes_accessed"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="results/torch/dryrun")
    ap.add_argument("--out", default="results/torch/roofline.json")
    ap.add_argument("--arch", default=None)
    args = ap.parse_args(argv)

    rows = []
    for fname in sorted(os.listdir(args.dryrun_dir)):
        if not fname.endswith(".json") or "2x16x16" in fname:
            continue  # roofline table is single-pod per the assignment
        with open(os.path.join(args.dryrun_dir, fname)) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        if args.arch and rec["arch"] != args.arch:
            continue
        print(f"[roofline] {rec['arch']} × {rec['shape']}")
        try:
            row = roofline_cell(rec["arch"], rec["shape"], rec)
        except Exception as e:
            row = {"arch": rec["arch"], "shape": rec["shape"],
                   "error": f"{type(e).__name__}: {e}"}
        rows.append(row)
        print(json.dumps(row))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {args.out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
