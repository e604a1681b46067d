#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py [--seed 0] [--size 512] [--n-iter 10]

Run from the repository root (it imports ``src/repro_torch``).  Phases:

1. Device: fails without CUDA; prints the card's name and power limit.
2. Build: compiles ``src/repro_torch/kernels/csrc/sb_gemm.cu`` with nvcc.
3. Kernel vs plain version on the card: the 36 Table II cases (native and
   batched strategies, f32 and bf16, ragged dims), the 8 exceptional cases
   through ``ext_gemm``, the 100-spec layout-fuzz stream (integer-valued,
   bit-identical), and the native kernel's gradients.
4. Copy-freedom: the kernel path moves no data; the conventional baseline
   makes at least its counted transposes.
5. Main path: Tucker HOOI on a low-rank-plus-noise float32 tensor of
   ``size``³ with ranks (10, 10, 10) (the paper's Fig. 9 core), three ways:
   the kernel backend, the torch backend and the conventional baseline.
6. Kernel time at each of the main path's launch shapes (CUDA events),
   against its bound, the plain version and one library call.
7. A profile of one HOOI of each variant: device time by kernel name and
   the device's idle share.

Tolerances: integer-valued inputs are exact under any summation order, so
they must match bit for bit; float32 results may differ from the plain
version's by the summation order, 2e-5 of the largest output magnitude;
bfloat16 inputs keep ~3 digits, 2e-2.  TF32 is switched off for matmuls
and cuDNN, so the library calls compared against run in full float32.

The last lines of stdout are a JSON ``kernels`` record, the card's name and
power limit as ``nvidia-smi`` prints them, and the ``{"ok": true, ...}``
line.  Any failed check raises and exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: HBM rate and float32 FMA peak (outside the tensor cores) of an H100 SXM
#: at 700 W (NVIDIA data sheet); the kernel accumulates with plain FMA.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RAGGED_DIMS = {"m": 383, "n": 257, "p": 47, "k": 321}
RANKS = (10, 10, 10)


def log(*args):
    print(*args, flush=True)


def rel_err(got, want) -> float:
    """Largest absolute difference over the largest magnitude (at least 1)."""
    diff = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    scale = max(1.0, want.float().abs().max().item() if want.numel() else 0.0)
    return diff / scale


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after two warm-ups."""
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def modes_of(spec: str):
    a, rest = spec.split(",")
    b, c = rest.split("->")
    return a, b, c


# ----------------------------------------------------------------- phase 1/2
def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build() -> float:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load("sb_gemm")
    return time.perf_counter() - t0


# ------------------------------------------------------------------- phase 3
def check_table2(dev) -> dict:
    from repro_torch.core.contract import contract
    from repro_torch.core.table2 import CASES
    from repro_torch.kernels.ext_gemm import ext_gemm
    from repro_torch.kernels.sb_gemm import native_gemm_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_checks = 0
    for label in sorted(CASES):
        rm = CASES[label].row_major()
        a, b, c = modes_of(rm)
        for dt in worst:
            A = torch.randn([RAGGED_DIMS[m] for m in a], device=dev, generator=gen).to(dt)
            B = torch.randn([RAGGED_DIMS[m] for m in b], device=dev, generator=gen).to(dt)
            want = native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c,
                                   out_dtype=torch.float32)
            runs = {s: contract(rm, A, B, strategy=s, backend="kernel", out_dtype=torch.float32)
                    for s in ("native", "batched")}
            if CASES[label].exceptional:
                runs["ext_gemm"] = ext_gemm(rm, A, B, out_dtype=torch.float32)
            torch.cuda.synchronize()
            for how, got in runs.items():
                err = rel_err(got, want)
                check(err <= TOL[dt], f"Table II {label} {rm} {how} {dt}: error {err}")
                worst[dt] = max(worst[dt], err)
                n_checks += 1
    log(f"table2: {n_checks} checks (36 cases x native/batched + 8 ext_gemm, f32 and bf16) "
        f"worst error f32 {worst[torch.float32]:.3g} bf16 {worst[torch.bfloat16]:.3g}")
    return worst


def check_layoutfuzz(dev, n_cases: int = 100) -> None:
    from repro_torch import layoutfuzz
    from repro_torch.core.contract import contract
    from repro_torch.interop import from_numpy
    from repro_torch.kernels.sb_gemm import native_gemm_ref

    n = 0
    for i in range(n_cases):
        cs, _, An, Bn, treatments = layoutfuzz.gen_layout_case(i)
        A, B = from_numpy((An, Bn), device=dev)
        spec = cs.spec_str()
        want = np.einsum(spec, An, Bn)
        plain = native_gemm_ref(A, B, a_modes=cs.a_modes, b_modes=cs.b_modes,
                                c_modes=cs.c_modes).cpu().numpy()
        check(np.array_equal(plain, want), f"fuzz {i} {spec}: plain version vs numpy")
        for strategy in ("native", "auto", "batched"):
            got = contract(cs, A, B, strategy=strategy, backend="kernel").cpu().numpy()
            check(np.array_equal(got, plain),
                  f"fuzz {i} {spec} {treatments} {strategy}: not bit-identical")
            n += 1
    log(f"layoutfuzz: {n_cases} specs x native/auto/batched = {n} runs, all bit-identical")


def check_grads(dev) -> None:
    from repro_torch.core.contract import contract
    from repro_torch.kernels.sb_gemm import native_gemm_ref

    specs = [("pk,mkn->nmp", (5, 7), (4, 7, 3)), ("mk,kn->mn", (6, 4), (4, 5)),
             ("k,k->", (9,), (9,)), ("bmk,bkn->bnm", (2, 3, 4), (2, 4, 5)),
             ("mq,qn->qnm", (3, 4), (4, 5))]
    gen = torch.Generator(device=dev).manual_seed(6)
    for spec, sa, sb in specs:
        a, b, c = modes_of(spec)
        A0 = torch.randn(sa, device=dev, generator=gen)
        B0 = torch.randn(sb, device=dev, generator=gen)
        A, B = A0.clone().requires_grad_(), B0.clone().requires_grad_()
        (contract(spec, A, B, strategy="native") ** 2).sum().backward()
        Ar, Br = A0.clone().requires_grad_(), B0.clone().requires_grad_()
        (native_gemm_ref(Ar, Br, a_modes=a, b_modes=b, c_modes=c) ** 2).sum().backward()
        for g, r, name in ((A.grad, Ar.grad, "dA"), (B.grad, Br.grad, "dB")):
            err = rel_err(g, r)
            check(err <= TOL[torch.float32], f"grad {spec} {name}: error {err}")
    log(f"grads: execute_native gradients match the plain version on {len(specs)} specs")


# ------------------------------------------------------------------- phase 4
def check_copy_freedom(dev, working_set) -> None:
    from repro_torch.core.contract import (
        contract, conventional_transpose_count, count_copy_ops)

    gen = torch.Generator(device=dev).manual_seed(2)
    for spec, dims in working_set:
        a, b, _ = modes_of(spec)
        A = torch.randn([dims[m] for m in a], device=dev, generator=gen)
        B = torch.randn([dims[m] for m in b], device=dev, generator=gen)
        for strategy in ("auto", "native"):
            n = sum(count_copy_ops(
                lambda: contract(spec, A, B, strategy=strategy, backend="kernel")).values())
            check(n == 0, f"copy-freedom {spec} {strategy}/kernel: {n} copies")
        conv = sum(count_copy_ops(
            lambda: contract(spec, A, B, strategy="conventional")).values())
        want = conventional_transpose_count(spec)
        check(conv >= want, f"conventional {spec}: {conv} copies < {want} transposes")
        log(f"copies {spec} {dims}: kernel 0, conventional {conv} "
            f"(>= {want} counted transposes)")
        del A, B


# ------------------------------------------------------------------- phase 5
def low_rank_plus_noise(size: int, ranks, seed: int, noise_rel: float = 0.1,
                        device="cuda"):
    """``G ×1 A ×2 B ×3 C + noise`` made from a numpy seed, with the noise's
    norm ``noise_rel`` times the low-rank part's.  Returns (T, noise share
    of ||T||)."""
    rng = np.random.default_rng(seed)
    G = torch.from_numpy(rng.standard_normal(ranks).astype(np.float32)).to(device)
    A, B, C = (torch.from_numpy(np.linalg.qr(rng.standard_normal((size, r)))[0]
                                .astype(np.float32)).to(device) for r in ranks)
    T = torch.einsum("ijk,mi,nj,pk->mnp", G, A, B, C).contiguous()
    N = torch.from_numpy(rng.standard_normal((size,) * 3, dtype=np.float32)).to(device)
    N *= noise_rel * torch.linalg.norm(T) / torch.linalg.norm(N)
    T += N
    return T, (torch.linalg.norm(N) / torch.linalg.norm(T)).item()


VARIANTS = {"kernel": dict(strategy="auto", backend="kernel"),
            "torch": dict(strategy="auto", backend="torch"),
            "conventional": dict(strategy="conventional", backend="torch")}


def check_small_hooi(dev) -> None:
    """The kernel-backed HOOI on the card agrees with the port on the CPU."""
    from repro_torch.core.tucker import hooi

    T, _ = low_rank_plus_noise(24, (4, 3, 5), seed=3, noise_rel=0.05, device="cpu")
    want = hooi(T, (4, 3, 5), n_iter=5)
    got = hooi(T.to(dev), (4, 3, 5), n_iter=5, **VARIANTS["kernel"])
    d = abs(got.rel_error.item() - want.rel_error.item())
    check(d <= 1e-5, f"small HOOI: rel_error {got.rel_error.item()} vs CPU "
                     f"{want.rel_error.item()}")
    for f, w in zip(got.factors, want.factors):
        err = (f @ f.T).cpu().sub(w @ w.T).abs().max().item()
        check(err <= 1e-4, f"small HOOI: factor projector differs by {err}")
    log(f"small HOOI 24^3: card (kernel) rel_error {got.rel_error.item():.7f} = "
        f"CPU {want.rel_error.item():.7f}")


def run_hooi(T, n_iter, variant):
    from repro_torch.core.tucker import hooi

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = hooi(T, RANKS, n_iter=n_iter, **VARIANTS[variant])
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def main_path(T, noise_share, n_iter, counters):
    """HOOI three ways.  Returns the kernel launches of the counted run and
    the kernel run's per-shape launches."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.sb_gemm import native_gemm

    # warm-up of each variant; the kernel's one records what it launches
    launches: dict = {}
    real = ops.native_gemm

    def recording(A, B, **kw):
        key = (kw["a_modes"], kw["b_modes"], kw["c_modes"], tuple(A.shape), A.stride(),
               tuple(B.shape), B.stride(), kw.get("u"), kw.get("walk"), kw.get("walk_mode"))
        n, _ = launches.get(key, (0, None))
        launches[key] = (n + 1, (A, B, kw))
        return real(A, B, **kw)

    ops.native_gemm = recording
    try:
        run_hooi(T, n_iter, "kernel")
    finally:
        ops.native_gemm = real
    for v in ("torch", "conventional"):
        run_hooi(T, n_iter, v)

    # the main path: counts to 0 just before, read just after
    for c in counters:
        c.launches = 0
    res_k, ms_k = run_hooi(T, n_iter, "kernel")
    counted = {c.__name__: c.launches for c in counters}
    check(counted["native_gemm"] > 0, "main path launched native_gemm no time")
    check(counted["native_gemm"] == sum(n for n, _ in launches.values()),
          f"launch count {counted} differs from the recorded run's")
    native_gemm.launches = 0
    results, times = {"kernel": res_k}, {"kernel": [ms_k]}
    for v in ("torch", "conventional", "conventional", "torch", "kernel"):
        res, ms = run_hooi(T, n_iter, v)
        results[v] = res
        times.setdefault(v, []).append(ms)
    check(native_gemm.launches == sum(n for n, _ in launches.values()),
          "a baseline variant launched the kernel")

    rel = {v: r.rel_error.item() for v, r in results.items()}
    check(abs(rel["kernel"] - rel["torch"]) <= 1e-5,
          f"kernel rel_error {rel['kernel']} vs torch {rel['torch']}")
    for v, r in results.items():
        check(all(torch.isfinite(x).all().item() for x in (r.core, *r.factors)),
              f"{v}: non-finite result")
        check(tuple(r.core.shape) == RANKS, f"{v}: core shape {tuple(r.core.shape)}")
        check(rel[v] <= noise_share * 1.001, f"{v}: rel_error {rel[v]} above the noise "
                                             f"share {noise_share}")
    A = results["kernel"].factors[0]
    check((A.T @ A - torch.eye(RANKS[0], device=A.device)).abs().max().item() < 1e-4,
          "kernel factors not orthonormal")
    med = {v: sorted(t)[len(t) // 2] for v, t in times.items()}
    for v in VARIANTS:
        log(f"hooi {T.shape[0]}^3 ranks {RANKS} x{n_iter} [{v}]: {med[v]:.3f} ms per HOOI "
            f"(runs {', '.join(f'{t:.3f}' for t in times[v])}), rel_error {rel[v]:.7f}, "
            f"speedup over conventional {med['conventional'] / med[v]:.3f}x")
    log(f"hooi: noise share of ||T|| {noise_share:.7f}; kernel launches per HOOI "
        f"{counted['native_gemm']}")
    return counted, launches


# ------------------------------------------------------------------- phase 6
def time_shapes(launches, reps: int = 20) -> dict:
    """Kernel, plain-version and library time at each launch shape of the
    main path, and the bound; per-HOOI sums weight each shape by its
    launches."""
    from repro_torch.kernels.sb_gemm import native_gemm, native_gemm_ref

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes=0, flops=0)
    worst = 0.0
    for (a, b, c, *_), (n, (A, B, kw)) in sorted(launches.items(), key=lambda x: x[0][:3]):
        out_dtype = kw.get("out_dtype") or torch.promote_types(A.dtype, B.dtype)
        dims = dict(zip(a, A.shape)) | dict(zip(b, B.shape))
        flops = 2 * int(np.prod([dims[m] for m in set(a + b + c)], dtype=np.int64))
        nbytes = (A.numel() * A.element_size() + B.numel() * B.element_size()
                  + int(np.prod([dims[m] for m in c])) * out_dtype.itemsize)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S else "operations"
        spec = f"{a},{b}->{c}"
        saved = native_gemm.launches
        got = native_gemm(A, B, **kw)
        want = native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c, out_dtype=out_dtype)
        err = rel_err(got, want)
        check(err <= TOL[torch.float32], f"{spec} at {tuple(A.shape)}: error {err}")
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        ms = cuda_ms(lambda: native_gemm(A, B, **kw), reps)
        native_gemm.launches = saved          # comparison launches do not count
        plain = cuda_ms(lambda: native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c,
                                                out_dtype=out_dtype), reps)
        lib = cuda_ms(lambda: torch.einsum(spec, A, B), reps)
        log(f"shape {spec} A{tuple(A.shape)}{A.stride()} B{tuple(B.shape)}{B.stride()} "
            f"x{n}/HOOI: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
            f"{100 * bound / ms:.1f}% of bound, plain {plain:.4f} ms, einsum {lib:.4f} ms")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bound)):
            tot[k] += n * v
        tot["bytes"] += n * nbytes
        tot["flops"] += n * flops
    tot["max_abs_err"] = worst
    tot["bound_by"] = ("bytes" if tot["bytes"] / HBM_BYTES_PER_S
                       >= tot["flops"] / F32_FLOP_PER_S else "operations")
    log(f"native_gemm per HOOI: kernel {tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms, "
        f"plain {tot['plain_ms']:.4f} ms, einsum {tot['library_ms']:.4f} ms")
    return tot


# ------------------------------------------------------------------- phase 7
def profile_hooi(T, n_iter: int, variant: str, top: int = 10) -> None:
    """Where one HOOI of ``variant`` spends device time, by kernel name, and
    the device's idle share: of the host wall time under the profiler, and
    of the span from the first device activity to the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.tucker import hooi

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hooi(T, RANKS, n_iter=n_iter, **VARIANTS[variant])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log("profile: the profiler recorded no device activity (not measured)")
        return
    busy, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:      # union of intervals: overlaps count once
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + stop - start, n + 1)
    span_us = end - spans[0][0]
    log(f"profile of one HOOI [{variant}]: device busy {busy / 1e3:.3f} ms; idle share "
        f"{1 - busy / wall_us:.3f} of the host wall {wall_us / 1e3:.3f} ms under the "
        f"profiler, {1 - busy / span_us:.3f} of the device span {span_us / 1e3:.3f} ms; "
        f"{len(spans)} device activities")
    for name, (us, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:top]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  x{n:<5d} {name[:80]}")


# ---------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=512, help="HOOI tensor edge")
    ap.add_argument("--n-iter", type=int, default=10, help="HOOI iterations")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on a card")
        return 1
    # outside a checkout of the repository this import fails, before any output
    from repro_torch.core.contract import record_contractions
    from repro_torch.core.tucker import hooi
    from repro_torch.kernels.sb_gemm import native_gemm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = device_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"TF32 off for matmul and cuDNN")

    log(f"build: sb_gemm.cu compiled and loaded in {build():.2f} s")

    check_table2(dev)
    check_layoutfuzz(dev)
    check_grads(dev)
    check_small_hooi(dev)

    T, noise_share = low_rank_plus_noise(args.size, RANKS, args.seed, device=dev)
    with record_contractions() as rec:
        hooi(T, RANKS, n_iter=1, **VARIANTS["kernel"])
    working_set = list({s: d for s, d, _ in rec}.items())
    check_copy_freedom(dev, working_set)

    counted, launches = main_path(T, noise_share, args.n_iter, [native_gemm])
    tot = time_shapes(launches)
    for variant in VARIANTS:
        profile_hooi(T, args.n_iter, variant)

    kernels = [{
        "name": "native_gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sb_gemm.cu",
        "replaces": "src/repro/kernels/sb_gemm.py:87",
        "launches": counted["native_gemm"], "max_abs_err": tot["max_abs_err"],
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": tot["bound_by"], "library_ms": tot["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
