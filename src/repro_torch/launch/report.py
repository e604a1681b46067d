"""Generate the §Dry-run / §Roofline / §Perf tables from the port's
results/torch/*.json.  Run after ``repro_torch.launch.dryrun --all``,
``repro_torch.launch.roofline`` and ``repro_torch.launch.perf``.

The JAX package's report with the port's result paths; the §Roofline
header names the H100's ceilings (``repro_torch.obs.roofline.DEVICE_PEAKS``),
and the two sections' notes say how the port counts: a step traced on fake
tensors over a fake world, every period traced (no scan correction)."""

from __future__ import annotations

import glob
import json
import os

GB = 1e9


def _fmt_b(x):
    return f"{x / GB:.1f}"


def dryrun_section(dryrun_dir="results/torch/dryrun"):
    lines = [
        "## §Dry-run — every (arch × shape × mesh) cell\n",
        "One step traced on fake tensors in a fake world of 256 ranks (16×16 "
        "`data×model`) or 512 (2×16×16 `pod×data×model`); memory/cost per rank "
        "as `CostCounter` counts the traced ops, with no compiler (`compile s` is "
        "the trace's). Skips are assignment rules, not failures.\n",
        "| arch | shape | mesh | status | compile s | args GB/dev | temp GB/dev | flops/dev | AG GB | AR GB | A2A GB |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    rows = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        rows.append(json.load(open(f)))
    rows.sort(key=lambda r: (r["arch"], r["shape"], str(r.get("multi_pod"))))
    n_ok = n_skip = 0
    for r in rows:
        if r["status"] == "skipped":
            n_skip += 1
            lines.append(
                f"| {r['arch']} | {r['shape']} | {'2x16x16' if r['multi_pod'] else '16x16'} "
                f"| skip | — | — | — | — | — | — | — |"
            )
            continue
        n_ok += 1
        c = r["collective_bytes"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
            f"| {r['compile_s']} | {_fmt_b(r['argument_bytes'])} "
            f"| {_fmt_b(r['temp_bytes'])} | {r['flops']:.2e} "
            f"| {_fmt_b(c['all-gather'])} | {_fmt_b(c['all-reduce'])} "
            f"| {_fmt_b(c['all-to-all'])} |"
        )
    lines.append(f"\n**{n_ok} cells compiled, {n_skip} skipped (9 rule-based "
                 "skips × 2 meshes).**\n")
    return "\n".join(lines)


def roofline_section(path="results/torch/roofline.json"):
    rows = json.load(open(path))
    rows = [r for r in rows if "error" not in r]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    lines = [
        "## §Roofline — single-pod (256 × H100: 989 TF/s bf16, 3.35 TB/s HBM, 900 GB/s NVLink)\n",
        "Per-rank terms of the traced step, every period traced, so no scan "
        "correction (see roofline.py docstring). "
        "`useful` = MODEL_FLOPS / total traced FLOPs (remat/redundancy overhead); "
        "`roof-frac` = achievable MFU at the dominant bound.\n",
        "| arch | shape | t_compute s | t_memory s | t_collective s | bound | useful | roof-frac | one-line fix |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    fixes = {
        "compute": "raise per-chip utilization (larger per-device GEMMs, fewer pads)",
        "memory": "stream KV / fuse elementwise / quantize cache (chunked attention where applied)",
        "collective": "restructure sharding-hostile ops (a2a MoE, chunked attention) / overlap",
    }
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4f} "
            f"| {r['t_memory_s']:.4f} | {r['t_collective_s']:.4f} "
            f"| {r['bottleneck']} | {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.4f} | {fixes[r['bottleneck']]} |"
        )
    return "\n".join(lines) + "\n"


def perf_section(perf_dir="results/torch/perf"):
    lines = ["## §Perf — hillclimb log (hypothesis → change → before/after)\n"]
    for f in sorted(glob.glob(os.path.join(perf_dir, "*.json"))):
        cell = json.load(open(f))
        name = os.path.basename(f)[:-5]
        lines.append(f"### {name}\n")
        lines.append("| variant | hypothesis | t_comp | t_mem | t_coll | bound | roof-frac | verdict |")
        lines.append("|---|---|---|---|---|---|---|---|")
        base = None
        for v in cell:
            r = v.get("roofline")
            if r is None:
                lines.append(f"| {v['variant']} | {v['hypothesis']} | — | — | — | — | — | failed |")
                continue
            if base is None:
                base = r
                verdict = "baseline"
            else:
                gain = r["roofline_fraction"] / max(base["roofline_fraction"], 1e-12)
                verdict = f"{'CONFIRMED' if gain > 1.05 else 'refuted'} ({gain:.1f}×)"
            lines.append(
                f"| {v['variant']} | {v['hypothesis']} | {r['t_compute_s']:.2f} "
                f"| {r['t_memory_s']:.2f} | {r['t_collective_s']:.2f} "
                f"| {r['bottleneck']} | {r['roofline_fraction']:.4f} | {verdict} |"
            )
        lines.append("")
    return "\n".join(lines)


def main():
    parts = []
    if os.path.isdir("results/torch/dryrun"):
        parts.append(dryrun_section())
    if os.path.exists("results/torch/roofline.json"):
        parts.append(roofline_section())
    if os.path.isdir("results/torch/perf"):
        parts.append(perf_section())
    print("\n\n".join(parts))


if __name__ == "__main__":
    main()
