"""The port's report (``repro_torch.launch.report``) against the JAX
package's, and the four launchers end to end on the CPU.

The JAX package's report imports only ``glob``, ``json`` and ``os``, so
both modules load here.  The port's is a copy, pinned by syntax tree, that
differs in its result paths (``results/torch/...``), its docstring, the
§Roofline header, which names the H100's ceilings, and the notes under the
§Dry-run and §Roofline headers, which say how the port counts (a step
traced on fake tensors over a fake world, no scan correction).  Fed the
same results tree, the two print the same report but for those three
lines.
"""

import ast
import contextlib
import io
import json
import os

import pytest

from repro.launch import report as jreport
from repro_torch.configs import registry
from repro_torch.launch import dryrun, perf, report, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


#: the first words of each package's note under a section's header, and
#: the note each normalises to
NOTES = {"`lower().compile()` on": "(dry-run note)", "One step traced on fake": "(dry-run note)",
         "Scan-trip-count-corrected": "(roofline note)",
         "Per-rank terms of the traced": "(roofline note)"}


class _Normalise(ast.NodeTransformer):
    """Drops the module docstring and maps the port's result paths,
    §Roofline header and section notes onto the JAX package's."""

    def visit_Module(self, node):
        if node.body and isinstance(node.body[0], ast.Expr):
            node.body = node.body[1:]
        return self.generic_visit(node)

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            v = node.value.replace("results/torch/", "results/")
            if v.startswith("## §Roofline — single-pod"):
                v = "## §Roofline — single-pod (ceilings)\n"
            v = next((n for start, n in NOTES.items() if v.startswith(start)), v)
            return ast.copy_location(ast.Constant(v), node)
        return node


def _dump(path) -> str:
    with open(path) as f:
        return ast.dump(_Normalise().visit(ast.parse(f.read())))


def test_report_is_the_jax_packages_copy():
    assert _dump(report.__file__) == _dump(jreport.__file__)


def _results_tree(root):
    """A synthetic results tree: two dry-run records (one skipped), a
    roofline file and a perf cell with a baseline, a variant and a
    failure."""
    os.makedirs(os.path.join(root, "dryrun"))
    os.makedirs(os.path.join(root, "perf"))
    coll = {"all-gather": 2.5e9, "all-reduce": 1.25e9, "reduce-scatter": 0,
            "all-to-all": 3e8, "collective-permute": 0}
    recs = {
        "minicpm-2b__train_4k__16x16": {
            "arch": "minicpm-2b", "shape": "train_4k", "multi_pod": False, "mesh": "16x16",
            "status": "ok", "compile_s": 12.5, "argument_bytes": 3.2e9, "temp_bytes": 7.9e9,
            "flops": 4.56e14, "collective_bytes": coll},
        "hubert-xlarge__decode_32k__2x16x16": {
            "arch": "hubert-xlarge", "shape": "decode_32k", "multi_pod": True,
            "status": "skipped", "reason": "encoder-only"},
    }
    for tag, rec in recs.items():
        with open(os.path.join(root, "dryrun", tag + ".json"), "w") as f:
            json.dump(rec, f)
    row = {"arch": "minicpm-2b", "shape": "train_4k", "t_compute_s": 0.5, "t_memory_s": 1.5,
           "t_collective_s": 0.25, "bottleneck": "memory", "useful_flops_ratio": 0.8,
           "roofline_fraction": 0.1234}
    with open(os.path.join(root, "roofline.json"), "w") as f:
        json.dump([row, {"arch": "x", "shape": "y", "error": "boom"}], f)
    cell = [{"variant": "baseline", "hypothesis": "h0", "roofline": row},
            {"variant": "better", "hypothesis": "h1",
             "roofline": dict(row, roofline_fraction=0.5, bottleneck="compute")},
            {"variant": "broken", "hypothesis": "h2", "record": {"status": "FAILED"}}]
    with open(os.path.join(root, "perf", "cell.json"), "w") as f:
        json.dump(cell, f)


def _main_output(module, cwd) -> list[str]:
    out = io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            module.main()
    finally:
        os.chdir(here)
    return out.getvalue().splitlines()


def test_report_output_matches_jax_but_the_roofline_header(tmp_path):
    """The same report but for the §Roofline header and the two notes,
    which describe the port's trace where the JAX package's describe its
    compiled module."""
    _results_tree(str(tmp_path / "jax" / "results"))
    _results_tree(str(tmp_path / "port" / "results" / "torch"))
    want = _main_output(jreport, tmp_path / "jax")
    got = _main_output(report, tmp_path / "port")
    assert len(got) == len(want) > 20
    differ = [(g, w) for g, w in zip(got, want) if g != w]
    assert differ == [
        ("One step traced on fake tensors in a fake world of 256 ranks (16×16 `data×model`) "
         "or 512 (2×16×16 `pod×data×model`); memory/cost per rank as `CostCounter` counts "
         "the traced ops, with no compiler (`compile s` is the trace's). Skips are "
         "assignment rules, not failures.",
         "`lower().compile()` on 256-chip (16×16 `data×model`) and 512-chip (2×16×16 "
         "`pod×data×model`) host-device meshes; memory/cost from the compiled SPMD module "
         "(per device). Skips are assignment rules, not failures."),
        ("## §Roofline — single-pod (256 × H100: 989 TF/s bf16, 3.35 TB/s HBM, 900 GB/s NVLink)",
         "## §Roofline — single-pod (256 × v5e: 197 TF/s bf16, 819 GB/s HBM, 50 GB/s/link)"),
        ("Per-rank terms of the traced step, every period traced, so no scan correction "
         "(see roofline.py docstring). `useful` = MODEL_FLOPS / total traced FLOPs "
         "(remat/redundancy overhead); `roof-frac` = achievable MFU at the dominant bound.",
         "Scan-trip-count-corrected per-chip terms (see roofline.py docstring). `useful` = "
         "MODEL_FLOPS / total HLO FLOPs (remat/redundancy overhead); `roof-frac` = "
         "achievable MFU at the dominant bound.")]
    assert any("CONFIRMED" in line for line in got) and any("failed" in line for line in got)


def test_launchers_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """``dryrun`` (a smoke cell and a skipped one) and ``roofline``
    through their ``main``s, ``perf.run_cell`` on a one-variant smoke cell
    and ``report`` over all three, on fake CPU tensors."""
    out = tmp_path / "results" / "torch"
    smoke = '{"smoke": true}'
    dryrun.main(["--arch", "minicpm-2b", "--shape", "train_4k", "--device", "cpu",
                 "--cfg-overrides", smoke, "--out", str(out / "dryrun")])
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k", "--device", "cpu",
                 "--out", str(out / "dryrun")])
    with open(out / "dryrun" / "minicpm-2b__train_4k__16x16.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["cfg_overrides"] == {"smoke": True}
    roofline.main(["--dryrun-dir", str(out / "dryrun"), "--out", str(out / "roofline.json")])
    with open(out / "roofline.json") as f:
        (row,) = json.load(f)
    cfg = registry.get_config("minicpm-2b", smoke=True)
    assert row["model_flops"] == 6 * cfg.param_count(active_only=True) * 256 * 4096
    assert row["t_compute_s"] == rec["flops"] / 67e12  # the smoke config is float32
    cells = {"minicpm_smoke": {"arch": "minicpm-2b", "shape": "train_4k", "variants": [
        ("baseline", {"smoke": True}, "smoke widths")]}}
    monkeypatch.setattr(perf, "CELLS", cells)
    (v,) = perf.run_cell("minicpm_smoke", str(out / "perf"), device="cpu")
    assert v["record"]["flops"] == rec["flops"] and v["roofline"] == row
    assert 0 < v["body"]["flops"] < rec["flops"]
    lines = _main_output(report, tmp_path)
    assert any(line.startswith("| minicpm-2b | train_4k | 16x16 | ok |") for line in lines)
    assert any(line.startswith("| hubert-xlarge | decode_32k | 16x16 | skip |")
               for line in lines)
    assert any(line.startswith("| minicpm-2b | train_4k | ") and f"| {row['bottleneck']} |" in line
               for line in lines)
    assert "### minicpm_smoke" in lines and any(
        line.startswith("| baseline | smoke widths |") for line in lines)


def test_report_main_without_results_prints_nothing(tmp_path):
    assert _main_output(report, tmp_path) == [""]


@pytest.mark.parametrize("module", [dryrun, roofline, perf, report])
def test_launcher_defaults_write_under_results_torch(module):
    """The port's launchers keep their results apart from the JAX
    package's ``results/``."""
    with open(module.__file__) as f:
        paths = [n.value for n in ast.walk(ast.parse(f.read()))
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)
                 and n.value.startswith("results/")]
    assert paths and all(p.startswith("results/torch/") for p in paths)
