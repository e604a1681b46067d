"""§Perf hill-climb: hypothesis → change → re-trace → re-analyse.

Three cells, the JAX package's:

* granite-20b × prefill_32k  — worst roofline fraction (0.0034; memory-
  bound on O(S²) dense-attention score buffers).
* kimi-k2-1t   × train_4k    — most collective-bound AND most
  representative of the paper's technique (expert-batched GEMM).
* internlm2-20b × train_4k   — dense collective-bound cell (f32 score
  all-gathers in backward).

The selection and the numbers above are the JAX package's (its dry run on
TPU v5e ceilings).  Each variant re-runs the port's traced dry-run cell
(:func:`repro_torch.launch.dryrun.dryrun_cell`), one period's costs
(:func:`repro_torch.launch.roofline.body_costs`, printed: the port needs
no scan correction) and the roofline on the card's ceilings, and appends a
record to ``results/torch/perf/<cell>.json``.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import dryrun_cell
from repro_torch.launch.roofline import body_costs, roofline_cell

__all__ = ["CELLS", "run_cell"]

CELLS = {
    "granite_prefill": {
        "arch": "granite-20b", "shape": "prefill_32k",
        "variants": [
            ("baseline", {}, "paper-faithful dense attention"),
            ("chunked_attn", {"attn_impl": "chunked"},
             "flash-style KV streaming: kill O(S²) score buffers"),
            ("chunked_attn_2k", {"attn_impl": "chunked", "attn_chunk": 2048},
             "bigger KV chunk: fewer scan steps, same live memory bound"),
        ],
    },
    "kimi_train": {
        "arch": "kimi-k2-1t-a32b", "shape": "train_4k",
        "variants": [
            ("baseline", {}, "GShard one-hot dispatch (GSPMD einsum)"),
            ("a2a_moe", {"moe_impl": "a2a"},
             "shard_map fixed-capacity all-to-all EP"),
            ("a2a_moe_chunked", {"moe_impl": "a2a", "attn_impl": "chunked"},
             "a2a EP + flash attention"),
        ],
    },
    "internlm2_train": {
        "arch": "internlm2-20b", "shape": "train_4k",
        "variants": [
            ("baseline", {}, "dense attention, engine-planned einsums"),
            ("chunked_attn", {"attn_impl": "chunked"},
             "kill f32 (S,S) score all-gathers in backward"),
        ],
    },
}


def run_cell(name: str, out_dir: str, *, device: str = "cuda"):
    spec = CELLS[name]
    results = []
    for vname, overrides, hypothesis in spec["variants"]:
        print(f"=== {name} / {vname}: {hypothesis}")
        rec = dryrun_cell(spec["arch"], spec["shape"], cfg_overrides=overrides,
                          verbose=False, device=device)
        if rec["status"] != "ok":
            results.append({"variant": vname, "hypothesis": hypothesis,
                            "record": rec})
            print(json.dumps(rec))
            continue
        body = body_costs(spec["arch"], spec["shape"], overrides, device=device)
        roof = roofline_cell(spec["arch"], spec["shape"], rec, cfg_overrides=overrides)
        results.append({
            "variant": vname, "hypothesis": hypothesis,
            "overrides": overrides, "record": rec, "body": body, "roofline": roof,
        })
        print(json.dumps({k: roof[k] for k in (
            "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
            "roofline_fraction")}))
        print(f"one period: {json.dumps(body)}")
        print(f"temp_bytes={rec['temp_bytes']/1e9:.1f}GB")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS) + ["all"], default="all")
    ap.add_argument("--out", default="results/torch/perf")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device")
    args = ap.parse_args(argv)
    cells = list(CELLS) if args.cell == "all" else [args.cell]
    for c in cells:
        run_cell(c, args.out, device=args.device)


if __name__ == "__main__":
    main()
