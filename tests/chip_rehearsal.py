"""Running ``chip_smoke.py``'s phases on the CPU: the script loaded as a
module, and its card-only calls stubbed so that a phase runs through at
small sizes with every check it makes."""

import functools
import importlib.util
import pathlib

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.cache
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cpu_time(fn) -> float:
    """A CPU stand-in for the card's timers: calls ``fn`` once; the time
    means nothing."""
    fn()
    return 1.0


def card_stubbed(monkeypatch, cs) -> tuple:
    """``chip_smoke`` with its card-only calls stubbed (the CUDA memory
    functions and ``synchronize``, the timers, the bound, the profiler) and
    ``native_gemm`` wrapped to count each launch on the route
    ``native_route`` gives, since a CPU call counts none.  Returns the
    counters a phase takes and the profiled labels."""
    from repro_torch.kernels import ops, sb_gemm
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.grouped_gemm import grouped_gemm

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "queued_ms", lambda fn, reps: cpu_time(fn))
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, reps: cpu_time(fn))
    monkeypatch.setattr(cs, "bound", lambda nbytes, flops, dtype: (1e-3, "bytes"))
    profiled = []

    def profile_device(label, fn, top=10, kinds=None):
        fn()
        profiled.append(label)

    monkeypatch.setattr(cs, "profile_device", profile_device)
    real = sb_gemm.native_gemm

    def native_gemm(A, B, **kw):
        route = sb_gemm.native_route(A, B, a_modes=kw["a_modes"], b_modes=kw["b_modes"],
                                     c_modes=kw["c_modes"])
        out = real(A, B, **kw)
        native_gemm.launches += 1
        native_gemm.launches_by_route[route] += 1
        return out

    native_gemm.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(sb_gemm.ROUTES, 0)
    monkeypatch.setattr(sb_gemm, "native_gemm", native_gemm)
    monkeypatch.setattr(ops, "native_gemm", native_gemm)
    return [native_gemm, grouped_gemm, flash_attention], profiled
