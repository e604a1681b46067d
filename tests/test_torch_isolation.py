"""The port stands alone: it imports neither JAX nor the JAX package, its
kernel path calls no library GEMM, a CPU tensor takes the plain version,
and nothing falls back from the card to the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core.contract import contract
from repro_torch.core.table2 import CASES
from repro_torch.kernels import _build, sb_gemm

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > len(MODULES)
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_kernel_path_calls_no_library_gemm(monkeypatch):
    """With every library GEMM entry point made to raise, the kernel backend
    still computes each Table II case: only the kernel wrapper's plain
    version (taken here because the tensors lie on the CPU) may multiply."""
    einsum = torch.einsum

    def plain(A, B, *, a_modes, b_modes, c_modes, out_dtype=None):
        out = einsum(f"{a_modes},{b_modes}->{c_modes}", A.float(), B.float())
        return out.to(out_dtype or torch.promote_types(A.dtype, B.dtype))

    def forbidden(*args, **kwargs):
        raise AssertionError("library GEMM on the kernel path")

    monkeypatch.setattr(sb_gemm, "native_gemm_ref", plain)
    for name in ("einsum", "matmul", "mm", "bmm", "tensordot", "baddbmm", "addmm"):
        monkeypatch.setattr(torch, name, forbidden)
    monkeypatch.setattr(torch.Tensor, "__matmul__", forbidden)
    rng = np.random.default_rng(0)
    dims = {"m": 7, "n": 6, "p": 3, "k": 5}
    for label in sorted(CASES):
        rm = CASES[label].row_major()
        a, rest = rm.split(",")
        b, _ = rest.split("->")
        A = torch.from_numpy(rng.standard_normal([dims[m] for m in a]).astype(np.float32))
        B = torch.from_numpy(rng.standard_normal([dims[m] for m in b]).astype(np.float32))
        for strategy in ("auto", "batched", "native"):
            got = contract(rm, A, B, strategy=strategy, backend="kernel")
            want = einsum(rm, A, B)
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), (label, strategy)


def test_cpu_tensor_takes_the_plain_version():
    A, B = torch.randn(3, 4), torch.randn(4, 5)
    before = sb_gemm.native_gemm.launches
    got = sb_gemm.native_gemm(A, B, a_modes="mk", b_modes="kn", c_modes="mn")
    assert got.device.type == "cpu"
    torch.testing.assert_close(got, A @ B, rtol=1e-5, atol=1e-5)
    assert sb_gemm.native_gemm.launches == before


def test_tensor_creation_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((2, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.from_numpy(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.resolve_device()
    assert interop.from_numpy(x, device="cpu").device.type == "cpu"


def test_from_numpy_keeps_strides_and_copies_reversed_views():
    base = np.arange(24, dtype=np.float32).reshape(4, 6)
    for view in (base.T, base[:, ::2], np.broadcast_to(base[:1], (3, 6)), base[::-1]):
        t = interop.from_numpy(view, device="cpu")
        assert np.array_equal(t.numpy(), view)
        if all(s >= 0 for s in view.strides):
            assert t.stride() == tuple(s // 4 if d > 1 else 0
                                       for d, s in zip(view.shape, view.strides))


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "build_root", lambda: tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("sb_gemm")
    assert _build.library_path("sb_gemm").parent.parent == tmp_path / "build"
