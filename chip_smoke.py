#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py [--seed 0] [--size 512] [--n-iter 10]

Run from the repository root (it imports ``src/repro_torch``).  Phases:

1. Device: fails without CUDA; prints the card's name and power limit.
2. Build: compiles the three kernels of ``src/repro_torch/kernels/csrc/``
   (``sb_gemm.cu``, ``grouped_gemm.cu``, ``flash_attn.cu``; the last two
   include ``hopper.cuh``, and so does ``sb_gemm.cu``) with nvcc, one
   process each, all at once; prints the registers, spills and shared
   memory of the wgmma and fma kernels (attention at D = 64, 128, 256;
   grouped for each type) and of the ``stream``, ``splitk`` and ``wgmma``
   kernels of ``native_gemm`` (``wgmma`` for each operand layout, and its
   split reduction); no fma kernel may spill, and each must have the
   shared memory its plan (``fma_tiles``, ``KERNEL_TILES``) gives.
3. Kernel vs plain version on the card: the 36 Table II cases (native and
   batched strategies, f32 and bf16, ragged dims), the 8 exceptional cases
   through ``ext_gemm``, the 100-spec layout-fuzz stream (integer-valued,
   bit-identical), the native kernel's gradients and a small HOOI, every
   ``native_gemm`` launch in them held to the route ``native_route``
   gives; then cases that force each ``native_gemm`` route at ragged
   extents (narrow widths 1, 10 and 16, depths and rows off the stage and
   tile sizes, bf16 output, integer-valued bit-identical; for ``wgmma``
   bf16 weight streaming at rows 1 (a stride-0 decode row), 2, 4, 63, 64,
   65 and 200, depths 6144, 1000 and 328, 1032 columns, each operand
   layout, bf16 and f32 output; and a bf16 case whose rows are no
   multiple of 16 bytes apart, which must stay ``generic``), each
   launched twice and bit-identical; ``grouped_gemm`` on
   the grouped cases of ``tests/test_runtime.py``, mixed bf16 x f32
   operands and the fig14 ragged set, then every ragged case again in
   bf16 under the default tiles
   (bf16 and f32 output), each case held to the route it must take
   (``wgmma`` for bf16 whose depths pack to multiples of 64, ``fma``
   otherwise); ``flash_attention`` on the grid of ``tests/test_flash_attn.py``,
   the GQA fold, causal cross attention, wide-range scores (f32 and bf16),
   float32 at S off the fma query tile and strided operands, each case
   held to the route it must take (``wgmma`` for every bf16 layout TMA can
   read, ``fma`` otherwise).
4. Copy-freedom: the kernel path moves no data; the conventional baseline
   makes at least its counted transposes.
5. Main path: Tucker HOOI on a low-rank-plus-noise float32 tensor of
   ``size``³ with ranks (10, 10, 10) (the paper's Fig. 9 core), three ways:
   the kernel backend, the torch backend and the conventional baseline.
10. Tuned HOOI (run right after phase 5, on its tensor): a ``"measure"``
   dispatcher with a fresh cache in a temporary directory pretunes the
   HOOI working set on the card (every candidate of every shape, the
   ``kernel`` ones through ``native_gemm``; one line per shape with each
   candidate's µs and the winner), then HOOI runs with
   ``strategy="tuned"`` under ``"cached"``: every lookup must hit with no
   measurement, ``native_gemm``'s launches by route must be what the
   winners imply, and ``rel_error`` within 1e-5 of the kernel variant's;
   its ms (upper median of 2 runs after a warm-up) is printed beside the
   three variants.  The cost model fitted on that cache predicts each
   shape, printed beside the measured winner.  One traced tuned HOOI
   iteration must give every ``contract`` span a ``roofline_fraction``
   (bound over device time, from CUDA events) in (0, 1.05], and its
   Chrome-trace export must parse.
6. Kernel time at each of the main path's launch shapes and its route:
   device time with the calls queued behind a sleeping kernel
   (``queued_ms``) and the call with its host time (CUDA events around
   back-to-back calls, ``cuda_ms``), against its bound, the plain version
   and ``torch.einsum`` timed both ways; two launches at each shape must
   be bit-identical.
7. A profile of one HOOI of each variant: device time by kernel name and
   the device's idle share.
8. Grouped path at full width: the routed experts of qwen2-moe-a2.7b (60
   experts, top-4, d_model 2048 -> d_expert 1408) over 4096 tokens with a
   skewed routing that leaves one expert empty, through ``grouped_matmul``
   in f32, bf16 and bf16 with weights stored ``(1408, 2048)``, and a
   uniform routing in bf16 (the bf16 runs on ``wgmma``, f32 on ``fma``);
   then times the kernel, the path and its packing alone, against
   ``torch._grouped_mm`` (bf16) and the per-group ``torch.matmul`` loop.
9. Attention path at full width: internlm2-20b prefill (48 query heads
   over 8 KV heads folded into BH = 48, D = 128, S = T = 4096) through
   ``flash_attention``: causal in bf16 and f32, non-causal in bf16; then
   times against SDPA, and names the backend SDPA's default call takes in
   f32 (bit-identical output to the efficient or math backend, each timed,
   and its device kernels' names).  Both bf16 runs must take the ``wgmma``
   route.

11. Serving at full width: internlm2-20b at its published widths (d_model
   6144, 48 query heads over 8 KV heads, head dim 128, d_ff 16384, vocab
   92544), bf16 activations over f32 master weights drawn on the card
   from ``--seed``, its depth cut to 4 layers (``SERVE["periods"]``; the
   cut is printed), ``contract_backend="kernel"``.  8 greedy requests of
   32-256 prompt tokens drawn from ``--seed``, 16 new tokens each,
   through ``ServingRuntime(slots=4, max_len=512, prefill_chunk=64)``:
   a warm-up serve, then the counted serve, which must give every
   request its 16 tokens, build no bucket entry, launch ``native_gemm``
   (every launch on the route ``native_route`` gives) and no other
   kernel; one decode pass and one prefill chunk must make one
   ``native_gemm`` launch per model contraction (9 a layer and the LM
   head): ``wgmma`` for the 7 dense products of a layer and the LM head,
   ``generic`` for the scores and P.V products (29 and 8 at 4 layers),
   and the counted serve launches the routes in that ratio.  The legacy
   ``ServeEngine`` must give the same tokens, and a prefill's logits on
   the kernel backend must be within 2e-2 of the largest magnitude of
   the torch backend's.  Then the two backends in
   turns (kernel, torch, torch, kernel): ms per prefill chunk by length,
   ms per decode tick by bucket and tokens/s, each chunk and tick timed
   by the host clock between synchronisations; and the top 8
   ``native_gemm`` launch shapes of the counted serve as in phase 6.
12. Every architecture: the ten smoke configs (float32) on the card with
   the kernel backend and on the CPU with the same weights (the plain
   version): one forward, and for decoders a prefill plus 3 decode steps
   (through ``ServingRuntime``, jamba's hybrid cache included; the
   vision model through the model functions, since its prompt carries
   patch features), logits within 1e-4 of the largest magnitude and the
   same tokens.

Each path (5, 10, 8, 9, 11, 12) is driven with every kernel's launch count set to
0 just before it and read just after; launches made to compare, time or
tune a kernel do not count.  Phases 5 and 10 also read ``native_gemm``'s
launches by route, which must be what ``native_route`` gives for each
launch shape (and, in phase 10, what the tuner's winners imply).

Tolerances: integer-valued inputs are exact under any summation order, so
they must match bit for bit; float32 results may differ from the plain
version's by the summation order, 2e-5 of the largest output magnitude;
bfloat16 inputs keep ~3 digits, 2e-2.  A grouped case takes its output
type's tolerance: bfloat16 inputs with a float32 output differ only by
the summation order, like float32.  Attention outputs take that
magnitude per row (see ``row_rel_err``), and at full width the bfloat16
kernel's distance to the float32 reference may be at most twice the
plain version's own.  TF32 is switched off for matmuls and cuDNN, so the
library calls compared against run in full float32.

The last lines of stdout are a JSON ``kernels`` record (the grouped and
attention entries carry their f32 run, the fma route, under ``"fma"``;
``native_gemm``'s carries the tuned HOOI's launches by route and the
serving phase's launches, routes, tokens/s and top-shape times),
the card's name and power limit as ``nvidia-smi`` prints them, and the
``{"ok": true, ...}`` line.  Any failed check raises and exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

KERNEL_SOURCES = ("sb_gemm", "grouped_gemm", "flash_attn")

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


def row_rel_err(got, want) -> float:
    """The worst row's largest absolute difference over that row's largest
    reference magnitude (rows along the last axis).  An attention output
    is a weighted mean of ``v``: its scale falls with the row's count of
    visible keys, so a scale taken over the whole tensor would let most
    rows differ by several times their own size."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    scale = w.abs().amax(dim=1).clamp_min(torch.finfo(torch.float32).tiny)
    return ((g - w).abs().amax(dim=1) / scale).max().item()


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


#: cycles of the sleeping kernel that a run of calls queues behind in
#: ``queued_ms``: about 50 ms at the H100's 1980 MHz
QUEUE_SLEEP_CYCLES = 100_000_000


def queued_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls are all queued behind
    a sleeping kernel before the first of them runs, and CUDA events time
    them from the sleep's end, so the host's time between launches is not
    counted (``cuda_ms`` counts it).  Of two rounds the first warms what a
    queue of calls needs (pinned host blocks); a round whose sleep ended
    before the queue was full is run again with a longer sleep."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    fn()
    cycles, rounds = QUEUE_SLEEP_CYCLES, 0
    while rounds < 2:
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()      # the sleep still ran: nothing waited on the host
        torch.cuda.synchronize()
        if queued:
            rounds += 1
        else:
            check(cycles < 8 * QUEUE_SLEEP_CYCLES, "calls could not be queued behind the sleep")
            cycles *= 2
    return start.elapsed_time(end) / reps


def dtype_label(dtype) -> str:
    return {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]


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


def build() -> dict:
    """Build every kernel source at once (nvcc runs outside the GIL);
    returns each one's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    def one(name):
        t0 = time.perf_counter()
        _build.load(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        return dict(zip(KERNEL_SOURCES, pool.map(one, KERNEL_SOURCES)))


def bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    """Least time (ms) for ``nbytes`` moved and ``flops`` done at the card's
    peaks for ``dtype``, and which of the two bounds it.  The peaks are the
    port's table (``repro_torch.obs.roofline.DEVICE_PEAKS``, from NVIDIA's
    data sheet), for whatever units the kernel uses: the port's float32
    kernels accumulate with plain FMA, so float32 takes the FMA peak."""
    from repro_torch.obs.roofline import roofline_bound

    us, by = roofline_bound(flops, nbytes, dtype, torch.cuda.get_device_name(0))
    return us / 1e3, by


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------------- phase 3
class native_routes_held:
    """Within the block, every ``native_gemm`` launch (through
    ``kernels.ops``, where every path calls it) must launch the route
    ``native_route`` gives for its operands; ``tally`` counts the routes
    seen.  A call with an empty output launches nothing."""

    def __init__(self):
        from repro_torch.kernels.sb_gemm import ROUTES

        self.tally = dict.fromkeys(ROUTES, 0)

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels.sb_gemm import native_gemm, native_route

        self.real = real = ops.native_gemm

        def held(A, B, **kw):
            want = native_route(A, B, a_modes=kw["a_modes"], b_modes=kw["b_modes"],
                                c_modes=kw["c_modes"])
            before = dict(native_gemm.launches_by_route)
            out = real(A, B, **kw)
            ran = {r: n - before[r] for r, n in native_gemm.launches_by_route.items()}
            launched = int(out.numel() > 0)
            check(ran == {r: launched * (r == want) for r in ran},
                  f"native_gemm {kw['a_modes']},{kw['b_modes']}->{kw['c_modes']} "
                  f"A{tuple(A.shape)}{A.stride()} B{tuple(B.shape)}{B.stride()}: launched "
                  f"{ran}, native_route says {want}")
            self.tally[want] += launched
            return out

        ops.native_gemm = held
        return self.tally

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.native_gemm = self.real
        return False


def routes_text(tally) -> str:
    return ", ".join(f"{r} {n}" for r, n in tally.items() if n) or "none"


def check_table2(dev) -> dict:
    from repro_torch.core.contract import contract
    from repro_torch.core.table2 import CASES
    from repro_torch.kernels.ext_gemm import ext_gemm
    from repro_torch.kernels.sb_gemm import native_gemm_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_checks = 0
    with native_routes_held() as tally:
        for label in sorted(CASES):
            rm = CASES[label].row_major()
            a, b, c = modes_of(rm)
            for dt in worst:
                A = torch.randn([RAGGED_DIMS[m] for m in a], device=dev, generator=gen).to(dt)
                B = torch.randn([RAGGED_DIMS[m] for m in b], device=dev, generator=gen).to(dt)
                want = native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c,
                                       out_dtype=torch.float32)
                runs = {s: contract(rm, A, B, strategy=s, backend="kernel",
                                    out_dtype=torch.float32)
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
        f"worst error f32 {worst[torch.float32]:.3g} bf16 {worst[torch.bfloat16]:.3g}; "
        f"native_gemm routes: {routes_text(tally)}")
    return worst


def check_layoutfuzz(dev, n_cases: int = 100) -> None:
    from repro_torch import layoutfuzz
    from repro_torch.core.contract import contract
    from repro_torch.interop import from_numpy
    from repro_torch.kernels.sb_gemm import native_gemm_ref

    n = 0
    with native_routes_held() as tally:
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
    log(f"layoutfuzz: {n_cases} specs x native/auto/batched = {n} runs, all bit-identical; "
        f"native_gemm routes: {routes_text(tally)}")


def check_grads(dev) -> None:
    from repro_torch.core.contract import contract
    from repro_torch.kernels.sb_gemm import native_gemm_ref

    specs = [("pk,mkn->nmp", (5, 7), (4, 7, 3)), ("mk,kn->mn", (6, 4), (4, 5)),
             ("k,k->", (9,), (9,)), ("bmk,bkn->bnm", (2, 3, 4), (2, 4, 5)),
             ("mq,qn->qnm", (3, 4), (4, 5))]
    gen = torch.Generator(device=dev).manual_seed(6)
    with native_routes_held() as tally:
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
    log(f"grads: execute_native gradients match the plain version on {len(specs)} specs; "
        f"native_gemm routes: {routes_text(tally)}")


def native_route_cases(dev):
    """Cases that force each route of ``native_gemm`` at ragged extents:
    (spec, A, B, out_dtype, route, integer-valued)."""
    from repro_torch.kernels.sb_gemm import STREAM_MIN_ROWS

    gen = torch.Generator(device=dev).manual_seed(16)
    # rows off the stream tile, a multiple of 4: a row stride TMA can step
    big = STREAM_MIN_ROWS + 436

    def rn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def ints(*shape):
        return torch.randint(-3, 4, shape, device=dev, generator=gen).float()

    cases = []
    for r in (1, 10, 16):
        # stream, read kind: m stride-1, then k stride-1 (rows 80 apart), k = 77
        cases += [("mn,mi->ni", rn(77, big), rn(77, r), None, "stream", False),
                  ("mp,pk->mk", rn(big, 80)[:, :77], rn(77, r), None, "stream", False),
                  # splitk: two C modes of X, three C modes in all, one long k
                  ("npi,nj->ijp", rn(300, 37, 10), rn(300, r), None, "splitk", False),
                  ("mnk,nj->mjk", rn(77, 300, 7), rn(300, r), None, "splitk", False),
                  ("mn,mi->in", rn(515, 1000), rn(r, 515).t(), None, "splitk", False)]
    # stream, write kind: depths 3, 10, 16; rows 512 and 130 wide (16-byte
    # and scalar stores)
    for k, p in ((3, 512), (10, 130), (16, 512)):
        cases.append(("km,pk->mp", rn(k, big), rn(p, k), None, "stream", False))
    # bf16 output on each kernel, and integer-valued inputs (exact sums)
    cases += [("mn,mi->ni", rn(77, big), rn(77, 10), torch.bfloat16, "stream", False),
              ("mp,pk->mk", rn(big, 80)[:, :77], rn(77, 10), torch.bfloat16, "stream", False),
              ("km,pk->mp", rn(10, big), rn(512, 10), torch.bfloat16, "stream", False),
              ("npi,nj->ijp", rn(300, 37, 10), rn(300, 10), torch.bfloat16, "splitk", False),
              ("mn,mi->ni", ints(77, big), ints(77, 10), None, "stream", True),
              ("mp,pk->mk", ints(big, 80)[:, :77], ints(77, 16), None, "stream", True),
              ("km,pk->mp", ints(10, big), ints(130, 10), None, "stream", True),
              ("mnk,nj->mjk", ints(77, 300, 7), ints(300, 10), None, "splitk", True),
              # a layout no new route takes: rows 77 floats apart
              ("mp,pk->mk", rn(big, 77), rn(77, 10), None, "generic", False)]

    # wgmma: bf16 weight streaming, 1032 columns (a ragged last tile), rows
    # 1 (a stride-0 decode row) to 200, depths 6144 (split 14 ways), 1000
    # (a ragged last split) and 328 (a ragged last stage)
    def bf(*shape):
        return rn(*shape).bfloat16()

    def bints(*shape):
        return ints(*shape).bfloat16()

    def rows(m, k):
        return bf(1, k).as_strided((1, k), (0, 1)) if m == 1 else bf(m, k)

    n = 1032
    for m in (1, 2, 4, 63, 64, 65, 200):
        for k in (6144, 328):
            cases.append(("be,ef->bf", rows(m, k), bf(k, n), None, "wgmma", False))
    # W K-major, X M-major, f32 output, integer-valued inputs (exact sums)
    for m, k in ((1, 6144), (65, 328), (200, 6144)):
        cases.append(("be,fe->bf", rows(m, k), bf(n, k), None, "wgmma", False))
    cases += [("eb,ef->bf", bf(6144, 200), bf(6144, n), None, "wgmma", False),
              ("eb,fe->bf", bf(328, 64), bf(n, 328), None, "wgmma", False),
              ("be,ef->bf", bf(4, 6144), bf(6144, n), torch.float32, "wgmma", False),
              ("be,fe->bf", bf(65, 328), bf(n, 328), torch.float32, "wgmma", False),
              ("be,ef->bf", bf(3, 1000), bf(1000, n), None, "wgmma", False),
              ("be,ef->bf", bints(2, 6144), bints(6144, n), None, "wgmma", True),
              ("be,fe->bf", bints(200, 6144), bints(n, 6144), torch.float32, "wgmma", True),
              ("eb,ef->bf", bints(328, 64), bints(328, n), None, "wgmma", True),
              # bf16 that TMA cannot read: W's rows 1030 bytes apart
              ("be,ef->bf", bf(4, 6144), bf(6144, 515)[:, :512], None, "generic", False)]
    return cases


def check_native_routes(dev) -> None:
    """Each forced case launches its route (twice, bit-identical) and
    matches the plain version: exactly where the inputs are integers."""
    from repro_torch.kernels.sb_gemm import native_gemm, native_gemm_ref, native_route

    worst = 0.0
    cases = native_route_cases(dev)
    for spec, A, B, out_dtype, route, exact in cases:
        a, b, c = modes_of(spec)
        kw = dict(a_modes=a, b_modes=b, c_modes=c, out_dtype=out_dtype)
        what = f"native_gemm {spec} A{tuple(A.shape)}{A.stride()} B{tuple(B.shape)} -> {out_dtype}"
        check(native_route(A, B, a_modes=a, b_modes=b, c_modes=c) == route,
              f"{what}: native_route does not give {route}")
        before = dict(native_gemm.launches_by_route)
        got, again = native_gemm(A, B, **kw), native_gemm(A, B, **kw)
        torch.cuda.synchronize()
        ran = {r: n - before[r] for r, n in native_gemm.launches_by_route.items()}
        check(ran == {r: 2 * (r == route) for r in ran}, f"{what}: launched {ran}, not {route}")
        check(torch.equal(got, again), f"{what}: two launches differ")
        want = native_gemm_ref(A, B, **kw)
        check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape or dtype")
        if exact:
            check(torch.equal(got, want), f"{what}: integer-valued case not bit-identical")
        else:
            err = rel_err(got, want)
            check(err <= TOL[got.dtype], f"{what}: error {err}")
        worst = max(worst, (got.float() - want.float()).abs().max().item())
    counts = {r: sum(1 for *_, rt, _ in cases if rt == r) for r in native_gemm.launches_by_route}
    log(f"native_gemm routes: {len(cases)} forced cases ({routes_text(counts)}; narrow widths "
        f"1/10/16, ragged rows and depths, bf16 weight streaming at 1-200 rows in every "
        f"operand layout, bf16 and f32 output, integer-valued bit-identical), each launched "
        f"twice on its route, bit-identical, matching the plain version "
        f"(max abs error {worst:.3g})")


GROUPED_T8 = {"u": 8, "v": 8, "k": 8}
#: the grouped shape lists of tests/test_runtime.py:27-32, (m, n, k) each
RUNTIME_SHAPE_LISTS = [
    [(5, 17, 9), (12, 3, 33), (1, 1, 1), (40, 20, 8)],
    [(8, 8, 8)],
    [(3, 3, 3), (3, 3, 3), (3, 3, 3)],
    [(33, 7, 65), (2, 31, 4)],
]


def fig14_shapes() -> list:
    """The ragged set of ``benchmarks/fig14_runtime.py:170-177`` (full run)."""
    rng = np.random.default_rng(14)
    shapes = [(int(m), 32, 64) for m in rng.integers(1, 33, size=8)]
    shapes[0] = (64, 32, 64)
    return shapes


def groups_of(shapes, dev, dtype, seed, ta=False, tb=False, integers=False):
    """Per-group operands from a numpy seed, stored transposed where
    flagged (``ta``/``tb`` scalar or per group)."""
    rng = np.random.default_rng(seed)
    ta = [ta] * len(shapes) if isinstance(ta, bool) else ta
    tb = [tb] * len(shapes) if isinstance(tb, bool) else tb

    def draw(shape):
        x = (rng.integers(-3, 4, shape) if integers else rng.standard_normal(shape))
        return torch.from_numpy(x.astype(np.float32)).to(dev, dtype)

    As = [draw((k, m) if ta[g] else (m, k)) for g, (m, n, k) in enumerate(shapes)]
    Bs = [draw((n, k) if tb[g] else (k, n)) for g, (m, n, k) in enumerate(shapes)]
    return As, Bs


def check_grouped_case(As, Bs, tiles, ta=False, tb=False, exact=False, out_dtype=None,
                       route=None) -> float:
    """``grouped_gemm`` against its plain version on the same packed
    buffers, and ``grouped_matmul`` against the per-group product, in
    ``out_dtype`` (default: the operands' promoted type); both calls must
    launch ``route``.  Returns the largest absolute difference."""
    from repro_torch.kernels.grouped_gemm import (
        grouped_gemm, grouped_gemm_packed_ref, pack_groups, packed_geometry)
    from repro_torch.kernels.ops import grouped_matmul

    dt = out_dtype or torch.promote_types(As[0].dtype, Bs[0].dtype)
    A_flat, B_flat, descs, problems = pack_groups(As, Bs, tiles, trans_a=ta, trans_b=tb)
    _, out_rows, out_cols = packed_geometry(problems, tiles)
    kw = dict(out_cols=out_cols, out_rows=out_rows, out_dtype=dt)
    before = dict(grouped_gemm.launches_by_route)
    got = grouped_gemm(A_flat, B_flat, descs, **kw)
    outs = grouped_matmul(As, Bs, tiles=tiles, trans_a=ta, trans_b=tb, out_dtype=dt)
    torch.cuda.synchronize()
    ran = {r: n - before[r] for r, n in grouped_gemm.launches_by_route.items()}
    launched = 2 if any(m and n for m, n, *_ in descs.tolist()) else 0
    what = f"grouped {[tuple(a.shape) for a in As]} tiles {tiles} ta {ta} tb {tb} -> {dt}"
    check(ran == {r: launched * (r == route) for r in ran}, f"{what}: launched {ran}, "
                                                          f"not {route}")
    want = grouped_gemm_packed_ref(A_flat, B_flat, descs, **kw)
    flags = [(ta if isinstance(ta, bool) else ta[g], tb if isinstance(tb, bool) else tb[g])
             for g in range(len(As))]
    refs = [((A.T if fa else A).float() @ (B.T if fb else B).float()).to(dt)
            for A, B, (fa, fb) in zip(As, Bs, flags)]
    pairs = [(got[c:c + m, :n], want[c:c + m, :n])
             for m, n, _, _, _, c, _, _ in descs.tolist()]
    pairs += list(zip(outs, refs))
    worst = 0.0
    for g, w in pairs:
        check(g.shape == w.shape and g.dtype == w.dtype, f"{what}: {g.shape} {g.dtype} "
                                                         f"vs {w.shape} {w.dtype}")
        if exact:
            check(torch.equal(g, w), f"{what}: integer-valued case not bit-identical")
        else:
            err = rel_err(g, w)
            check(err <= TOL[dt], f"{what}: error {err}")
        if g.numel():
            worst = max(worst, (g.float() - w.float()).abs().max().item())
    return worst


def native_kernel_info() -> None:
    """Registers, spills and shared memory of the built stream, splitk and
    wgmma kernels of ``native_gemm`` (the first two with float32 output,
    the stream read kernels at the HOOI depth 512 and the read kinds at
    rank 10, padded to 12; wgmma with bf16 output for each operand layout,
    and its split reduction).  The wgmma kernel must not spill: its 64
    accumulators a thread stay in registers."""
    from repro_torch.kernels.sb_gemm import route_info

    for name, info in route_info(K=512, rp=12).items():
        log(f"sb_gemm.cu {name}: {info['registers']} registers/thread, {info['spill_bytes']} "
            f"bytes spilled (local)/thread, {info['smem_bytes']} bytes shared memory/block")
        check(not name.startswith("wgmma") or info["spill_bytes"] == 0,
              f"sb_gemm.cu {name} spills {info['spill_bytes']} bytes a thread")


def grouped_kernel_info() -> None:
    """Registers, spills and shared memory of the built grouped kernels:
    wgmma for each output type, fma for each (A, B, C) type triple; no fma
    kernel may spill, and each must have the shared memory its tiles
    plan."""
    from repro_torch.kernels.grouped_gemm import FMA_DEPTH, KERNEL_TILES, fma_info, wgmma_info

    tm, tn = KERNEL_TILES["wgmma"]
    for dtype, info in wgmma_info().items():
        log(f"grouped_gemm.cu wgmma {tm}x{tn} -> {str(dtype).removeprefix('torch.')}: "
            f"{info['registers']} registers/thread at launch (then setmaxnreg: producer 40, "
            f"consumers 232), {info['spill_bytes']} bytes spilled (local)/thread, "
            f"{info['smem_bytes']} bytes dynamic shared memory/block")
    tu, tv = KERNEL_TILES["fma"]
    plan = 2 * FMA_DEPTH * (tu + 4 + tv + 4) * 4
    for types, info in fma_info().items():
        name = " x ".join(str(t).removeprefix("torch.") for t in types[:2])
        what = f"grouped_gemm.cu fma {tu}x{tv} {name} -> {str(types[2]).removeprefix('torch.')}"
        log(f"{what}: {info['registers']} registers/thread, {info['spill_bytes']} bytes "
            f"spilled (local)/thread, {info['smem_bytes']} bytes static shared memory/block")
        check(info["spill_bytes"] == 0, f"{what}: spills")
        check(info["smem_bytes"] == plan, f"{what}: smem {info['smem_bytes']} != planned {plan}")


def check_grouped(dev) -> None:
    bf16, f32 = torch.bfloat16, torch.float32
    n = 0
    for i, shapes in enumerate(RUNTIME_SHAPE_LISTS):     # T8 leaves ragged depths: fma
        for dt in (f32, bf16):
            check_grouped_case(*groups_of(shapes, dev, dt, seed=i), GROUPED_T8, route="fma")
            n += 1
    for dt in (f32, bf16):     # default tiles (8, 128, 128)
        check_grouped_case(*groups_of([(5, 130, 9), (20, 4, 140)], dev, dt, seed=8), None,
                           route="wgmma" if dt == bf16 else "fma")
        n += 1
    # empty groups (tests/test_runtime.py:121-133): k=0 gives exact zeros
    rng = np.random.default_rng(3)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    As, Bs = [r(4, 0), r(0, 6), r(4, 6), r(4, 6)], [r(0, 5), r(6, 5), r(6, 0), r(6, 5)]
    check_grouped_case(As, Bs, GROUPED_T8, route="fma")
    from repro_torch.kernels.ops import grouped_matmul

    outs = grouped_matmul(As, Bs, tiles=GROUPED_T8)
    check([tuple(o.shape) for o in outs] == [(4, 5), (0, 5), (4, 0), (4, 5)],
          "grouped: empty-group shapes")
    check(bool((outs[0] == 0).all()), "grouped: k=0 group not exact zeros")
    # per-group layout flags (tests/test_runtime.py:148-154), integer-valued
    ta, tb = [False, True, True], [False, True, False]
    shapes = [(5, 9, 7), (6, 4, 7), (12, 130, 9)]
    check_grouped_case(*groups_of(shapes, dev, f32, seed=7, ta=ta, tb=tb, integers=True),
                       None, ta, tb, exact=True, route="fma")
    # several kernel tiles and K stages per group, every layout, ragged
    multi = [(130, 260, 70), (64, 128, 200), (1, 300, 33), (77, 5, 513)]
    ta, tb = [True, False, True, False], [False, True, True, False]
    for dt in (f32, bf16):
        check_grouped_case(*groups_of(multi, dev, dt, seed=9, ta=ta, tb=tb), GROUPED_T8,
                           ta, tb, route="fma")
    check_grouped_case(*groups_of(multi, dev, f32, seed=10, ta=ta, tb=tb, integers=True),
                       GROUPED_T8, ta, tb, exact=True, route="fma")
    # mixed operand types (bf16 A, f32 B; tests/test_torch_grouped_gemm.py),
    # f32 and bf16 output, every layout, ragged; integer-valued bit-identical
    for out in (f32, bf16):
        As, _ = groups_of(multi, dev, bf16, seed=11, ta=ta, tb=tb)
        _, Bs = groups_of(multi, dev, f32, seed=12, ta=ta, tb=tb)
        check_grouped_case(As, Bs, GROUPED_T8, ta, tb, out_dtype=out, route="fma")
        As, _ = groups_of(multi, dev, bf16, seed=13, ta=ta, tb=tb, integers=True)
        _, Bs = groups_of(multi, dev, f32, seed=14, ta=ta, tb=tb, integers=True)
        check_grouped_case(As, Bs, None, ta, tb, exact=True, out_dtype=out, route="fma")
    # the fig14 ragged set at its tiles (k = 64: bf16 takes wgmma)
    for dt in (f32, bf16):
        check_grouped_case(*groups_of(fig14_shapes(), dev, dt, seed=14),
                           {"u": 8, "v": 32, "k": 32}, route="wgmma" if dt == bf16 else "fma")
    log(f"grouped_gemm: {n} runtime-test cases (f32 and bf16), empty groups (k=0 exact "
        f"zeros), trans flags and multi-tile layouts (integer-valued bit-identical), mixed "
        f"bf16 x f32 operands with f32 and bf16 output, fig14 ragged set: all match the "
        f"plain version, each on its route")
    check_grouped_wgmma(dev)


def check_grouped_wgmma(dev) -> None:
    """Every ragged case again under the default tiles in bf16, where the
    wgmma route takes each of them, with bf16 and float32 output: ragged M
    and N edges, sub-tile groups, one group, empty and k=0 groups, and all
    four trans_a/trans_b combinations over several tiles and ring laps."""
    from repro_torch.kernels.ops import grouped_matmul

    bf16, f32 = torch.bfloat16, torch.float32
    n = 0
    multi = [(130, 260, 70), (64, 128, 200), (1, 300, 33), (77, 5, 513), (260, 130, 900)]
    ta, tb = [True, False, True, False, True], [False, True, True, False, False]
    cases = [(shapes, False, False) for shapes in RUNTIME_SHAPE_LISTS]
    cases += [([(3, 5, 2), (1, 1, 1)], False, False), ([(13, 29, 7)], False, False),
              (multi, ta, tb)]
    for out in (bf16, f32):
        for i, (shapes, fa, fb) in enumerate(cases):
            check_grouped_case(*groups_of(shapes, dev, bf16, seed=40 + i, ta=fa, tb=fb), None,
                               fa, fb, out_dtype=out, route="wgmma")
            n += 1
        # integer-valued: sums are exact in f32, so kernel and plain version
        # round the same value and must agree bit for bit
        check_grouped_case(*groups_of(multi, dev, bf16, seed=50, ta=ta, tb=tb, integers=True),
                           None, ta, tb, exact=True, out_dtype=out, route="wgmma")
        n += 1
        # empty groups and a k=0 group
        rng = np.random.default_rng(3)

        def r(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, bf16)

        As, Bs = [r(4, 0), r(0, 6), r(4, 6), r(4, 6)], [r(0, 5), r(6, 5), r(6, 0), r(6, 5)]
        check_grouped_case(As, Bs, None, out_dtype=out, route="wgmma")
        outs = grouped_matmul(As, Bs, out_dtype=out)
        check([tuple(o.shape) for o in outs] == [(4, 5), (0, 5), (4, 0), (4, 5)],
              "grouped wgmma: empty-group shapes")
        check(bool((outs[0] == 0).all()), "grouped wgmma: k=0 group not exact zeros")
        n += 1
    log(f"grouped_gemm wgmma: {n} default-tile bf16 cases (runtime-test shapes, sub-tile, "
        f"single group, empty and k=0 groups with exact zeros, all four trans combinations "
        f"over up to 16 K stages, integer-valued bit-identical), bf16 and f32 output: all "
        f"on the wgmma route and matching the plain version")


#: tests/test_flash_attn.py's SHAPES: (bh, s, t, block, d)
FLASH_SHAPES = [(2, 64, 64, 64, 16), (1, 96, 96, 32, 16), (3, 128, 256, 64, 32),
                (2, 200, 200, 48, 64)]


def qkv_of(rng, bh, s, t, d, dev, dtype):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
            for shape in ((bh, s, d), (bh, t, d), (bh, t, d))]


def check_flash_case(q, k, v, causal, route) -> float:
    """One ``flash_attention`` call against its plain version; ``route`` is
    the route it must launch."""
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref

    before = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    what = f"flash {tuple(q.shape)}{q.stride()} {tuple(k.shape)}{k.stride()} causal={causal} {q.dtype}"
    ran = {r: n - before[r] for r, n in flash_attention.launches_by_route.items()}
    check(ran == {r: int(r == route) for r in ran}, f"{what}: launched {ran}, not {route}")
    check(got.shape == want.shape and got.dtype == q.dtype, "flash: shape or dtype")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = row_rel_err(got, want)
    check(err <= TOL[q.dtype], f"{what}: error {err}")
    return (got.float() - want.float()).abs().max().item()


def flash_kernel_info() -> None:
    """Registers, spills and shared memory of the built wgmma and fma
    kernels; the shared memory must be what ``wgmma_tiles`` and
    ``fma_tiles`` plan, and no fma kernel may spill."""
    from repro_torch.kernels.flash_attn import fma_info, fma_tiles, wgmma_info, wgmma_tiles

    for D in (64, 128, 256):
        info, plan = wgmma_info(D), wgmma_tiles(D)
        check(info["smem_bytes"] == plan["smem_bytes"],
              f"flash wgmma DP={plan['dp']}: kernel smem {info['smem_bytes']} != planned "
              f"{plan['smem_bytes']}")
        log(f"flash_attn.cu wgmma DP={plan['dp']} BK={plan['bk']} stages={plan['stages']}: "
            f"{info['registers']} registers/thread at launch (then setmaxnreg: producer 40, "
            f"consumers 232), {info['spill_bytes']} bytes spilled (local)/thread, "
            f"{info['smem_bytes']} bytes dynamic shared memory/block")
    for D in (64, 128, 256):
        plan = fma_tiles(D)
        for dt in (torch.float32, torch.bfloat16):
            info = fma_info(D, dt)
            what = (f"flash_attn.cu fma DP={plan['dp']} BQ={plan['bq']} BK={plan['bk']} "
                    f"{str(dt).removeprefix('torch.')}")
            log(f"{what}: {info['registers']} registers/thread ({plan['rows']} rows x 4 keys "
                f"of S, {plan['rows']} x {plan['cols']} of O), {info['spill_bytes']} bytes "
                f"spilled (local)/thread, {info['smem_bytes']} bytes dynamic shared memory/block")
            check(info["spill_bytes"] == 0, f"{what}: spills")
            check(info["smem_bytes"] == plan["smem_bytes"],
                  f"{what}: kernel smem {info['smem_bytes']} != planned {plan['smem_bytes']}")


def check_flash(dev) -> None:
    rng = np.random.default_rng(11)
    bf16, f32 = torch.bfloat16, torch.float32
    route = {f32: "fma", bf16: "wgmma"}
    n = 0
    for bh, s, t, _, d in FLASH_SHAPES:
        for causal in (True, False):
            for dt in (f32, bf16):
                check_flash_case(*qkv_of(rng, bh, s, t, d, dev, dt), causal, route[dt])
                n += 1
    # GQA fold (tests/test_flash_attn.py:61-76): each q head gets its kv head
    B, G, R, S, D = 2, 2, 3, 64, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dev)
               for sh in ((B, G, R, S, D), (B, G, S, D), (B, G, S, D)))
    fold = lambda x: x[:, :, None].expand(B, G, R, S, D).reshape(B * G * R, S, D)
    for dt in (f32, bf16):
        check_flash_case(q.reshape(B * G * R, S, D).to(dt), fold(k).to(dt), fold(v).to(dt),
                         True, route[dt])
    # causal cross attention, top-left aligned, ragged; every head-dim path
    # (160: a padded head dim whose last 64-column box lies past D)
    for bh, s, t, d in ((2, 100, 300, 128), (2, 300, 100, 128), (1, 70, 70, 256),
                        (2, 33, 65, 48), (1, 130, 200, 160)):
        for dt in (f32, bf16):
            check_flash_case(*qkv_of(rng, bh, s, t, d, dev, dt), True, route[dt])
    # scores over a wide range (q scaled by 8) across 6 (wgmma) or 11 (fma)
    # key tiles: the running max moves and the accumulator is rescaled from
    # tile to tile
    q, k, v = qkv_of(rng, 2, 300, 700, 128, dev, f32)
    for dt in (f32, bf16):
        for causal in (True, False):
            check_flash_case((q * 8).to(dt), k.to(dt), v.to(dt), causal, route[dt])
    # strided operands: q read from an (S, BH, D) layout, one K/V for all heads
    q = torch.from_numpy(rng.standard_normal((90, 4, 64)).astype(np.float32)).to(dev)
    k1, v1 = (torch.from_numpy(rng.standard_normal((1, 120, 64)).astype(np.float32))
              .to(dev) for _ in range(2))
    for dt in (f32, bf16):
        for causal in (True, False):
            check_flash_case(q.to(dt).transpose(0, 1),
                             k1.to(dt).expand(4, 120, 64), v1.to(dt).expand(4, 120, 64),
                             causal, route[dt])
    # one query row, then one key, each with a row stride TMA could not
    # step: a dimension of extent 1 is never stepped, so both take wgmma
    q, k, v = qkv_of(rng, 2, 40, 40, 64, dev, bf16)
    check_flash_case(q.as_strided((2, 1, 64), (64 * 40, 3, 1)), k, v, True, "wgmma")
    check_flash_case(q, *(x.as_strided((2, 1, 64), (64 * 40, 5, 1)) for x in (k, v)), False,
                     "wgmma")
    # bf16 layouts TMA cannot describe take the fma route: D = 4 (8-byte
    # rows) and rows 44 elements apart
    check_flash_case(*qkv_of(rng, 2, 50, 70, 4, dev, bf16), True, "fma")
    q, k, v = (x[..., :40] for x in qkv_of(rng, 2, 80, 96, 44, dev, bf16))
    check_flash_case(q, k, v, False, "fma")
    # float32 with S off the fma route's query tile (128 rows, 64 at D > 128)
    # and ragged T, each head-dim tile
    for bh, s, t, d in ((3, 333, 260, 128), (2, 100, 150, 256), (2, 130, 70, 64)):
        for causal in (True, False):
            check_flash_case(*qkv_of(rng, bh, s, t, d, dev, f32), causal, "fma")
    log(f"flash_attention: {n} cases of the SHAPES x causal/full x f32/bf16 grid, GQA fold, "
        f"causal T>S and T<S, D in 48/128/160/256, scores x8 over 6-11 key tiles (f32 and "
        f"bf16), strided and broadcast operands, S = 1 and T = 1, two bf16 layouts TMA "
        f"cannot read, f32 at S off the query tile: all match the plain version, every bf16 "
        f"case TMA can read on the wgmma route, every other case on fma")


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
#: every HOOI run: the three variants and phase 10's tuned run, in which
#: each step runs the tuner's winner (``backend`` unused)
RUNS = {**VARIANTS, "tuned": dict(strategy="tuned")}


def check_small_hooi(dev) -> None:
    """The kernel-backed HOOI on the card agrees with the port on the CPU."""
    from repro_torch.core.tucker import hooi

    T, _ = low_rank_plus_noise(24, (4, 3, 5), seed=3, noise_rel=0.05, device="cpu")
    want = hooi(T, (4, 3, 5), n_iter=5)
    with native_routes_held() as tally:
        got = hooi(T.to(dev), (4, 3, 5), n_iter=5, **VARIANTS["kernel"])
    d = abs(got.rel_error.item() - want.rel_error.item())
    check(d <= 1e-5, f"small HOOI: rel_error {got.rel_error.item()} vs CPU "
                     f"{want.rel_error.item()}")
    for f, w in zip(got.factors, want.factors):
        err = (f @ f.T).cpu().sub(w @ w.T).abs().max().item()
        check(err <= 1e-4, f"small HOOI: factor projector differs by {err}")
    log(f"small HOOI 24^3: card (kernel) rel_error {got.rel_error.item():.7f} = "
        f"CPU {want.rel_error.item():.7f}; native_gemm routes: {routes_text(tally)}")


@contextlib.contextmanager
def recording_launches():
    """Within the block, every ``native_gemm`` launch through
    ``kernels.ops`` is counted by its shape, strides and options; yields
    ``{key: (launches, (A, B, kwargs))}`` with one launch's operands per
    key, for :func:`time_shapes`."""
    from repro_torch.kernels import ops

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
        yield launches
    finally:
        ops.native_gemm = real


def run_hooi(T, n_iter, variant):
    from repro_torch.core.tucker import hooi

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = hooi(T, RANKS, n_iter=n_iter, **RUNS[variant])
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def main_path(T, noise_share, n_iter, counters):
    """HOOI three ways.  Returns the kernel launches of the counted run,
    ``native_gemm``'s launches in it by route, and the kernel run's
    per-shape launches."""
    from repro_torch.kernels.sb_gemm import native_gemm, native_route

    # warm-up of each variant; the kernel's one records what it launches
    with recording_launches() as launches:
        run_hooi(T, n_iter, "kernel")
    for v in ("torch", "conventional"):
        run_hooi(T, n_iter, v)

    # the main path: counts to 0 just before, read just after
    for c in counters:
        c.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
    res_k, ms_k = run_hooi(T, n_iter, "kernel")
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(native_gemm.launches_by_route)
    check(counted["native_gemm"] > 0, "main path launched native_gemm no time")
    check(counted["native_gemm"] == sum(n for n, _ in launches.values()),
          f"launch count {counted} differs from the recorded run's")
    want_routes = dict.fromkeys(routes, 0)
    for (a, b, c, *_), (n, (A, B, _)) in launches.items():
        want_routes[native_route(A, B, a_modes=a, b_modes=b, c_modes=c)] += n
    check(routes == want_routes, f"main path routes {routes}, native_route gives {want_routes}")
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
        f"{counted['native_gemm']}, by route {routes}")
    return counted, routes, launches, {"ms": med, "rel": rel}


# ------------------------------------------------------------------ phase 10
#: the tuned run's tolerance against the ``auto``+kernel variant's rel_error
TUNED_REL_TOL = 1e-5
#: a span's roofline fraction above this means its count or its clock is wrong
MAX_FRACTION = 1.05


def tuned_path(T, working_set, noise_share, n_iter, counters, hooi_summary) -> dict:
    """HOOI under ``strategy="tuned"``.  A ``"measure"`` dispatcher with a
    fresh cache in a temporary directory pretunes the recorded working set
    on the card (every candidate of every shape measured); the tuned HOOI
    then runs under ``"cached"``: every lookup a hit, no measurement,
    ``native_gemm``'s launches by route what the winners imply, and
    ``rel_error`` within :data:`TUNED_REL_TOL` of the ``auto``+kernel
    variant's.  Then the cost model fitted on that cache predicts each
    shape, and one traced tuned iteration must give every ``contract``
    span a roofline fraction in (0, :data:`MAX_FRACTION`], exported to a
    Chrome trace that parses.  Returns the tuned run's record."""
    import tempfile
    from collections import Counter

    from repro_torch.core.notation import parse_spec
    from repro_torch.obs import export, trace
    from repro_torch.tuning import Candidate, Dispatcher, canonical_key, set_dispatcher
    from repro_torch.tuning.cache import platform_of
    from repro_torch.tuning.candidates import enumerate_candidates
    from repro_torch.tuning.model import kernel_route
    from repro_torch.kernels.sb_gemm import native_gemm

    dev, both = T.device, ("torch", "kernel")
    platform = platform_of(dev)
    shapes = {}
    for spec, dims, dt in working_set:
        shapes.setdefault(canonical_key(spec, dims, dt, platform), (spec, dims, dt))
    with tempfile.TemporaryDirectory() as tmp:
        disp = Dispatcher(Path(tmp) / "tuning.json", policy="measure", backends=both)
        set_dispatcher(disp)
        try:
            t0 = time.perf_counter()
            stats = disp.pretune(working_set, device=dev)
            pretune_s = time.perf_counter() - t0
            check(stats["tuned"] == stats["unique"] == len(shapes),
                  f"pretune on a fresh cache: {stats}")
            n_cands = 0
            winner_route = {}
            for key, (spec, dims, dt) in shapes.items():
                cs = parse_spec(spec)
                entry = disp.cache.get(key)
                want = {c.key() for c in enumerate_candidates(cs, dims, backends=both)}
                check(set(entry["results"]) == want,
                      f"{key}: measured {sorted(entry['results'])}, candidates {sorted(want)}")
                n_cands += len(want)
                best = Candidate.from_key(entry["best"])
                winner_route[key] = (kernel_route(cs, dims, dt, best)[0]
                                     if best.backend == "kernel" else None)
                us = ", ".join(f"{k} {v:.2f}" for k, v in sorted(entry["results"].items(),
                                                                   key=lambda kv: kv[1]))
                log(f"tuned {spec} {dims}: winner {entry['best']}"
                    f"{' [' + winner_route[key] + ']' if winner_route[key] else ''}; "
                    f"µs {us}")
            check(disp.measurements == n_cands, f"{disp.measurements} measurements, "
                                                f"{n_cands} candidates")
            log(f"pretune: {stats['unique']} shapes, {n_cands} candidates measured on the card "
                f"in {pretune_s:.1f} s ({platform})")

            disp.policy = "cached"
            with native_routes_held() as warm:       # warm-up; launches held to native_route
                run_hooi(T, n_iter, "tuned")
            looked = Counter()
            real_lookup = disp.lookup

            def tally(spec, dims, dtype, plat=None):
                looked[canonical_key(spec, dims, dtype, plat)] += 1
                return real_lookup(spec, dims, dtype, plat)

            disp.lookup = tally
            disp.reset_counters()
            for c in counters:
                c.launches = 0
            native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
            res, ms = run_hooi(T, n_iter, "tuned")
            counted = {c.__name__: c.launches for c in counters}
            routes = dict(native_gemm.launches_by_route)
            disp.lookup = real_lookup
            implied = dict.fromkeys(routes, 0)
            for key, n in looked.items():
                if winner_route.get(key):
                    implied[winner_route[key]] += n
            log(f"tuned hooi: {disp.stats['hits']} lookups, all hits, "
                f"{disp.stats['measurements']} measurements; native_gemm launches by route "
                f"{routes}, implied by the winners {implied}, held in the warm-up run "
                f"{warm}")
            check(disp.misses == 0 and disp.measurements == 0 and disp.hits > 0
                  and disp.hits == sum(looked.values()),
                  f"tuned hooi under 'cached': {disp.stats}")
            check(set(looked) <= set(shapes), "a tuned lookup outside the pretuned working set")
            check(routes == implied == warm, f"native_gemm routes {routes}, implied {implied}, "
                                             f"warm-up {warm}")
            check(counted["native_gemm"] == sum(routes.values())
                  and counted["grouped_gemm"] == counted["flash_attention"] == 0,
                  f"tuned hooi launches {counted}")
            times = [ms, run_hooi(T, n_iter, "tuned")[1]]

            rel = res.rel_error.item()
            check(all(torch.isfinite(x).all().item() for x in (res.core, *res.factors))
                  and tuple(res.core.shape) == RANKS, "tuned hooi: non-finite or misshapen")
            check(abs(rel - hooi_summary["rel"]["kernel"]) <= TUNED_REL_TOL,
                  f"tuned rel_error {rel} vs auto+kernel {hooi_summary['rel']['kernel']}")
            check(rel <= noise_share * 1.001, f"tuned rel_error {rel} above the noise share")
            med = sorted(times)[len(times) // 2]
            log(f"hooi {T.shape[0]}^3 ranks {RANKS} x{n_iter} [tuned]: {med:.3f} ms per HOOI "
                f"(runs {', '.join(f'{t:.3f}' for t in times)}), rel_error {rel:.7f} "
                f"(auto+kernel {hooi_summary['rel']['kernel']:.7f}); beside "
                + ", ".join(f"{v} {t:.3f} ms" for v, t in hooi_summary["ms"].items()))

            pred = Dispatcher(disp.cache, policy="predict", backends=both)
            model = pred.model()
            log(f"cost model: families {sorted(model.families)}, {model.n_rows} rows")
            for key, (spec, dims, dt) in shapes.items():
                p = pred.predict(spec, dims, dt)
                entry = disp.cache.get(key)
                measured = entry["results"][entry["best"]]
                log(f"predict {spec} {dims}: "
                    + (f"{p.candidate.key()} {p.us:.2f} µs (confidence {p.confidence:.3f})"
                       if p else "no prediction")
                    + f"; measured {entry['best']} {measured:.2f} µs")

            tracer = trace.enable_tracing(trace.Tracer())
            try:
                hooi_traced = run_hooi(T, 1, "tuned")[0]
            finally:
                trace.disable_tracing()
            check(torch.isfinite(hooi_traced.rel_error).item(), "traced hooi: non-finite")
            spans = [e for e in tracer.events() if e["name"] == "contract"]
            fracs = [e["args"].get("roofline_fraction") for e in spans]
            check(spans and all(e["args"].get("roofline_bound_us", 0) > 0 for e in spans),
                  "a contract span on the card carries no roofline bound")
            bad = [(e["args"]["spec"], f) for e, f in zip(spans, fracs)
                   if f is None or not 0 < f <= MAX_FRACTION]
            by_spec = {}
            for e, f in zip(spans, fracs):
                by_spec.setdefault((e["args"]["spec"], e["args"]["strategy"]), []).append(f)
            for (spec, strategy), fs in sorted(by_spec.items()):
                log(f"trace contract {spec} [{strategy}] x{len(fs)}: roofline_fraction "
                    f"{min(fs):.4f}-{max(fs):.4f} of device time")
            check(not bad, f"roofline fractions outside (0, {MAX_FRACTION}]: {bad[:5]}")
            path = Path(tmp) / "tuned_hooi_trace.json"
            n_ev = export.write_chrome_trace(str(path), tracer)
            summary = export.validate_chrome_trace(str(path))
            check("contract" in summary["names"], "exported trace has no contract span")
            log(f"trace: {len(spans)} contract spans, fractions {min(fracs):.4f}-"
                f"{max(fracs):.4f}; {n_ev} Chrome-trace events exported, parsed and valid")
        finally:
            set_dispatcher(None)
    return {"launches": counted["native_gemm"], "launches_by_route": routes,
            "ms": med, "rel_error": rel}


# ------------------------------------------------------------------- phase 6
def launch_cost(A, B, kw) -> tuple[int, int]:
    """Bytes and flops of one ``native_gemm`` launch: each operand read
    once, the output written once; two flops per multiply-add."""
    a, b, c = kw["a_modes"], kw["b_modes"], kw["c_modes"]
    out_dtype = kw.get("out_dtype") or torch.promote_types(A.dtype, B.dtype)
    dims = dict(zip(a, A.shape)) | dict(zip(b, B.shape))
    flops = 2 * int(np.prod([dims[m] for m in set(a + b + c)], dtype=np.int64))
    nbytes = (A.numel() * A.element_size() + B.numel() * B.element_size()
              + int(np.prod([dims[m] for m in c])) * out_dtype.itemsize)
    return nbytes, flops


def time_shapes(launches, reps: int = 20, per: str = "HOOI", top: int | None = None) -> dict:
    """Kernel, plain-version and library time at each launch shape of the
    main path, its route and the bound at its type's peak; two launches at
    each shape must be bit-identical.  The kernel and ``torch.einsum`` are
    timed both with their calls queued (device time, ``queued_ms``) and
    back to back (the call with its host time, ``cuda_ms``).  Per-``per``
    sums weight each shape by its launches; ``top`` keeps only the shapes
    with the largest launches x bound."""
    from repro_torch.kernels.sb_gemm import native_gemm, native_gemm_ref, native_route

    keys = ("ms", "call_ms", "plain_ms", "library_ms", "library_call_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0) | dict(bytes=0, flops=0)
    worst = 0.0
    items = sorted(launches.items(), key=lambda x: x[0][:3])
    if top is not None:
        def weight(item):
            n, (A, B, kw) = item[1]
            nb, fl = launch_cost(A, B, kw)
            return n * bound(nb, fl, torch.promote_types(A.dtype, B.dtype))[0]
        items = sorted(sorted(items, key=weight, reverse=True)[:top], key=lambda x: x[0][:3])
    for (a, b, c, *_), (n, (A, B, kw)) in items:
        out_dtype = kw.get("out_dtype") or torch.promote_types(A.dtype, B.dtype)
        dtype = torch.promote_types(A.dtype, B.dtype)
        nbytes, flops = launch_cost(A, B, kw)
        b_ms, by = bound(nbytes, flops, dtype)
        spec = f"{a},{b}->{c}"
        route = native_route(A, B, a_modes=a, b_modes=b, c_modes=c)
        saved = native_gemm.launches, dict(native_gemm.launches_by_route)
        got, again = native_gemm(A, B, **kw), native_gemm(A, B, **kw)
        want = native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c, out_dtype=out_dtype)
        check(torch.equal(got, again), f"{spec} at {tuple(A.shape)}: two launches differ")
        err = rel_err(got, want)
        check(err <= TOL[out_dtype], f"{spec} at {tuple(A.shape)}: error {err}")
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        ms = queued_ms(lambda: native_gemm(A, B, **kw), reps)
        call_ms = cuda_ms(lambda: native_gemm(A, B, **kw), reps)
        # comparison launches do not count
        native_gemm.launches, native_gemm.launches_by_route = saved
        plain = cuda_ms(lambda: native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c,
                                                out_dtype=out_dtype), reps)
        lib = queued_ms(lambda: torch.einsum(spec, A, B), reps)
        lib_call = cuda_ms(lambda: torch.einsum(spec, A, B), reps)
        log(f"shape {spec} A{tuple(A.shape)}{A.stride()} B{tuple(B.shape)}{B.stride()} "
            f"x{n}/{per} [{route}] {dtype_label(dtype)}: kernel {ms:.4f} ms queued "
            f"({call_ms:.4f} ms by events), "
            f"bound {b_ms:.4f} ms ({by}), {100 * b_ms / ms:.1f}% of bound; plain "
            f"{plain:.4f} ms; einsum {lib:.4f} ms queued ({lib_call:.4f} ms by events); "
            f"two launches bit-identical")
        for k, v in zip(keys, (ms, call_ms, plain, lib, lib_call, b_ms)):
            tot[k] += n * v
        tot["bytes"] += n * nbytes
        tot["flops"] += n * flops
    tot["max_abs_err"] = worst
    tot["bound_by"] = bound(tot["bytes"], tot["flops"], dtype)[1]
    log(f"native_gemm per {per}{'' if top is None else f' (top {len(items)} shapes)'}: kernel "
        f"{tot['ms']:.4f} ms queued ({tot['call_ms']:.4f} ms by "
        f"events), bound {tot['bound_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, einsum "
        f"{tot['library_ms']:.4f} ms queued ({tot['library_call_ms']:.4f} ms by events)")
    return tot


# ------------------------------------------------------------------- phase 7
def profile_hooi(T, n_iter: int, variant: str, top: int = 10) -> None:
    """Where one HOOI of ``variant`` spends device time (see
    :func:`profile_device`)."""
    from repro_torch.core.tucker import hooi

    profile_device(f"one HOOI [{variant}]",
                   lambda: hooi(T, RANKS, n_iter=n_iter, **VARIANTS[variant]), top)


def profile_device(label: str, fn, top: int = 10) -> dict | None:
    """Where one call of ``fn`` spends device time, by kernel name, and the
    device's idle share: of the host wall time under the profiler, and of
    the span from the first device activity to the last.  Returns the
    busy and wall ms and the idle share of the wall, or ``None`` when the
    profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log(f"profile of {label}: the profiler recorded no device activity (not measured)")
        return None
    busy, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:      # union of intervals: overlaps count once
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + stop - start, n + 1)
    span_us = end - spans[0][0]
    log(f"profile of {label}: device busy {busy / 1e3:.3f} ms; idle share "
        f"{1 - busy / wall_us:.3f} of the host wall {wall_us / 1e3:.3f} ms under the "
        f"profiler, {1 - busy / span_us:.3f} of the device span {span_us / 1e3:.3f} ms; "
        f"{len(spans)} device activities")
    for name, (us, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:top]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  x{n:<5d} {name[:80]}")
    return dict(busy_ms=busy / 1e3, wall_ms=wall_us / 1e3, idle_share=1 - busy / wall_us)


# ------------------------------------------------------------------- phase 8
#: qwen2-moe-a2.7b's routed experts (src/repro/configs/qwen2_moe_a2p7b.py)
MOE = dict(n_experts=60, top_k=4, d_model=2048, d_expert=1408, tokens=4096)


def moe_counts(seed: int, skewed: bool = True) -> np.ndarray:
    """Rows per expert for ``MOE["tokens"]`` tokens, each routed to
    ``top_k`` distinct experts drawn (Gumbel top-k) from a popularity:
    ``skewed``, Zipf with the last expert never chosen (an assumption with
    no routing trace behind it), else uniform (what a load-balancing loss
    aims at)."""
    rng = np.random.default_rng(seed)
    E = MOE["n_experts"]
    pop = 1.0 / np.arange(1, E + 1) if skewed else np.ones(E)
    if skewed:
        pop[-1] = 0.0
    with np.errstate(divide="ignore"):
        scores = np.log(pop / pop.sum()) + rng.gumbel(size=(MOE["tokens"], E))
    top = np.argsort(-scores, axis=1)[:, :MOE["top_k"]]
    return np.bincount(top.ravel(), minlength=E)


def time_with(fn, reps: int, counters) -> float:
    """``cuda_ms`` of ``fn`` with every launch count put back afterwards:
    timing launches do not count."""
    saved = [c.launches for c in counters]
    ms = cuda_ms(fn, reps)
    for c, n in zip(counters, saved):
        c.launches = n
    return ms


def grouped_bytes(As, Bs, trans_b: bool, out_dtype) -> int:
    """Bytes the grouped product ``A_g (m, k) @ B_g`` must move: each group
    with output reads its A and B once and writes its C once, unpadded; a
    group with no rows or columns moves nothing (an expert with no tokens
    reads no weights)."""
    total = 0
    for A, B in zip(As, Bs):
        m, n = A.shape[0], B.shape[0 if trans_b else 1]
        if m and n:
            total += nbytes(A, B) + m * n * out_dtype.itemsize
    return total


def grouped_path(dev, seed: int, counters, reps: int = 10) -> dict:
    """The expert up-projection ``A_g (m_g, 2048) @ W_g (2048, 1408)`` of
    qwen2-moe-a2.7b through ``grouped_matmul``: under a skewed routing in
    f32, bf16, and bf16 with the weights stored ``(1408, 2048)``
    (``trans_b``); under a uniform routing in bf16.  Checks (the bf16 runs
    on the wgmma route, f32 on fma), then times the kernel, the path with
    its packing, ``pack_groups`` alone, the plain version and library
    calls.  Returns the skewed bf16 run's record for the kernels line, with
    the f32 run's (the fma route) under ``"fma"``."""
    from repro_torch.kernels.grouped_gemm import (
        grouped_gemm, grouped_gemm_packed_ref, grouped_gemm_ref, pack_groups,
        packed_geometry)
    from repro_torch.kernels.ops import grouped_matmul

    routings = {"skewed": moe_counts(seed), "uniform": moe_counts(seed, skewed=False)}
    check(routings["skewed"].min() == 0, "routing left no expert empty")
    M, K, N = MOE["tokens"] * MOE["top_k"], MOE["d_model"], MOE["d_expert"]
    for how, counts in routings.items():
        log(f"moe routing [{how}]: {MOE['tokens']} tokens x top-{MOE['top_k']} = {M} rows "
            f"over {MOE['n_experts']} experts; rows per expert max {counts.max()}, median "
            f"{int(np.median(counts))}, min {counts.min()} "
            f"({int((counts == 0).sum())} empty)")
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(M, K, device=dev, generator=gen)       # routed rows, by expert
    W = torch.randn(MOE["n_experts"], K, N, device=dev, generator=gen) * K**-0.5
    Xb, Wb = X.bfloat16(), W.bfloat16()
    runs = {"f32": (X, W, False, "skewed"), "bf16": (Xb, Wb, False, "skewed"),
            "bf16 trans_b": (Xb, Wb.transpose(1, 2).contiguous(), True, "skewed"),
            "bf16 uniform": (Xb, Wb, False, "uniform")}

    def split(x, counts):
        offs = np.concatenate([[0], np.cumsum(counts)])
        return [x[offs[g]:offs[g + 1]] for g in range(len(counts))]

    groups = {name: (split(x, routings[how]), list(w), tb, routings[how])
              for name, (x, w, tb, how) in runs.items()}

    for c in counters:
        c.launches = 0
    grouped_gemm.launches_by_route = dict.fromkeys(grouped_gemm.launches_by_route, 0)
    outs = {name: grouped_matmul(As, Bs, trans_b=tb) for name, (As, Bs, tb, _) in groups.items()}
    torch.cuda.synchronize()
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(grouped_gemm.launches_by_route)
    check(counted["grouped_gemm"] == len(runs) and sum(counted.values()) == len(runs),
          f"grouped path launches {counted}")
    check(routes == {"wgmma": 3, "fma": 1}, f"grouped path routes {routes}: the three bf16 "
                                            f"runs must take wgmma, f32 fma")

    rec = {}
    for name, (As, Bs, tb, counts) in groups.items():
        got = outs[name]
        want = grouped_gemm_ref(As, Bs, trans_b=tb)
        dt = As[0].dtype
        check([tuple(o.shape) for o in got] == [(int(c), N) for c in counts],
              f"moe {name}: output shapes")
        check(all(bool(torch.isfinite(o).all()) for o in got), f"moe {name}: non-finite")
        err = max(rel_err(o, w) for o, w in zip(got, want) if o.numel())
        check(err <= TOL[dt], f"moe {name}: error {err} against the plain version")
        abs_err = max((o.float() - w.float()).abs().max().item()
                      for o, w in zip(got, want) if o.numel())
        del want
        A_flat, B_flat, descs, problems = pack_groups(As, Bs, trans_b=tb)
        _, out_rows, out_cols = packed_geometry(problems)
        kw = dict(out_cols=out_cols, out_rows=out_rows)
        saved = (dict(grouped_gemm.launches_by_route), [c.launches for c in counters])
        ms = queued_ms(lambda: grouped_gemm(A_flat, B_flat, descs, **kw), reps)
        call_ms = cuda_ms(lambda: grouped_gemm(A_flat, B_flat, descs, **kw), reps)
        path_ms = cuda_ms(lambda: grouped_matmul(As, Bs, trans_b=tb), reps)
        grouped_gemm.launches_by_route = saved[0]
        for c, count in zip(counters, saved[1]):     # timing launches do not count
            c.launches = count
        pack_ms = cuda_ms(lambda: pack_groups(As, Bs, trans_b=tb), reps)
        aliased = B_flat.data_ptr() == Bs[0].data_ptr()
        plain_ms = cuda_ms(lambda: grouped_gemm_packed_ref(
            A_flat, B_flat, descs, out_cols=out_cols, out_rows=out_rows), reps)
        # 3 queued rounds of 60 matmuls stay inside the card's launch queue,
        # which a full queue would make the host wait on
        loop = lambda: [a @ (b.T if tb else b) for a, b in zip(As, Bs)]
        loop_ms, loop_q_ms = cuda_ms(loop, reps), queued_ms(loop, 3)
        W3 = torch.stack(Bs).transpose(1, 2) if tb else torch.stack(Bs)
        A_pad = torch.zeros(len(As), int(counts.max()), K, dtype=dt, device=dev)
        for g, a in enumerate(As):
            A_pad[g, :a.shape[0]] = a
        bmm_ms = cuda_ms(lambda: torch.bmm(A_pad, W3), reps)
        del A_pad
        lib_ms, lib_note = None, "none (torch._grouped_mm takes bf16 only)"
        if dt == torch.bfloat16:
            if hasattr(torch, "_grouped_mm"):
                x_cat = torch.cat(As)
                offs_t = torch.tensor(np.cumsum(counts), dtype=torch.int32, device=dev)
                try:
                    lib_ms = queued_ms(lambda: torch._grouped_mm(x_cat, W3, offs=offs_t), reps)
                    lib_note = f"{lib_ms:.4f} ms"
                except RuntimeError as exc:   # the yardstick only: the port never calls it
                    lib_note = f"none ({str(exc).splitlines()[0][:100]})"
            else:
                lib_note = "none (torch has no _grouped_mm)"
        flops = 2 * M * N * K
        b_ms, by = bound(grouped_bytes(As, Bs, tb, dt), flops, dt)
        log(f"moe up-projection [{name}] {M}x{K} @ {MOE['n_experts']}x{K}x{N}: kernel "
            f"{ms:.4f} ms (calls queued), {flops / ms / 1e9:.1f} TFLOP/s, bound {b_ms:.4f} ms "
            f"({by}), {100 * b_ms / ms:.1f}% of bound; grouped_gemm call {call_ms:.4f} ms "
            f"(CUDA events); grouped_matmul with packing {path_ms:.4f} ms; "
            f"pack_groups alone {pack_ms:.4f} ms (B a view of the weights: {aliased}); "
            f"plain {plain_ms:.4f} ms; library _grouped_mm {lib_note} (calls queued); per-group "
            f"torch.matmul loop {loop_q_ms:.4f} ms queued ({loop_ms:.4f} ms by events; "
            f"kernel/loop {ms / loop_q_ms:.3f}x); padded-to-largest torch.bmm {bmm_ms:.4f} ms; "
            f"max abs error {abs_err:.3g}")
        rec[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                         library_ms=lib_ms, loop_ms=loop_q_ms, max_abs_err=abs_err)
        del A_flat, B_flat
    same = all(torch.equal(a, b) for a, b in zip(outs["bf16"], outs["bf16 trans_b"]))
    log(f"moe: trans_b result bit-identical to the plain-layout bf16 result: {same}; "
        f"path launches {counted}, by route {routes}")
    f32 = rec["f32"]
    fma = {k: f32[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
    fma |= {"library_ms": f32["loop_ms"],
            "library": "per-group torch.matmul loop over the 60 experts (calls queued)"}
    return {**{k: v for k, v in rec["bf16"].items() if k != "loop_ms"},
            "launches": counted["grouped_gemm"], "fma": fma}


# ------------------------------------------------------------------- phase 9
#: internlm2-20b (src/repro/configs/internlm2_20b.py): 48 query heads over
#: 8 KV heads, d_model 6144
ATTN = dict(n_heads=48, n_kv_heads=8, d_model=6144, seq=4096)


def sdpa_backend(q4, k4, v4, causal: bool, reps: int) -> str:
    """Which backend the default SDPA call takes on these inputs: its
    output is compared bit for bit with the efficient-attention and math
    backends' (each timed as well), and one profiled call names its device
    kernels.  Returns the backend whose output it equals, else "unknown"."""
    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    default, found, notes = sdpa(), "unknown", []
    for name, backend, n in (("efficient", SDPBackend.EFFICIENT_ATTENTION, reps),
                             ("math", SDPBackend.MATH, 2)):
        with sdpa_kernel(backend):
            try:
                same = torch.equal(sdpa(), default)
                ms = cuda_ms(sdpa, n)
            except RuntimeError as exc:     # a backend that refuses these inputs
                notes.append(f"{name}: refused ({str(exc).splitlines()[0][:80]})")
                continue
        notes.append(f"{name} {ms:.4f} ms, output bit-identical to the default call: {same}")
        if same and found == "unknown":
            found = name
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sdpa()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
    log(f"SDPA {q4.dtype} causal={causal}: {'; '.join(notes)}; the default call takes "
        f"{found}; its device kernels: {', '.join(n[:100] for n in names) or 'none recorded'}")
    return found


def attention_path(dev, seed: int, counters, reps: int = 5) -> dict:
    """internlm2-20b prefill through ``flash_attention``, heads folded into
    BH as a GQA caller does: causal in bf16 and f32, and non-causal in
    bf16.  Checks (both bf16 runs on the wgmma route), then times the
    kernel, the plain version and SDPA, and names SDPA's backend for f32.
    Returns the causal bf16 run's record for the kernels line, with the
    f32 run's (the fma route) under ``"fma"``."""
    from repro_torch.kernels.flash_attn import flash_attention, flash_attention_ref

    H, Hkv, S = ATTN["n_heads"], ATTN["n_kv_heads"], ATTN["seq"]
    D, R = ATTN["d_model"] // H, H // Hkv
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(1, Hkv, R, S, D, device=dev, generator=gen)
    k, v = (torch.randn(1, Hkv, S, D, device=dev, generator=gen) for _ in range(2))

    def fold(x, dt):   # (1, Hkv, [R,] S, D) -> (H, S, D), each q head its kv head
        x = x if x.ndim == 5 else x[:, :, None].expand(1, Hkv, R, S, D)
        return x.reshape(H, S, D).to(dt)

    qkv = {dt: [fold(x, dt) for x in (q, k, v)] for dt in (torch.bfloat16, torch.float32)}
    runs = {"bf16": (torch.bfloat16, True), "f32": (torch.float32, True),
            "bf16 full": (torch.bfloat16, False)}
    for c in counters:
        c.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(flash_attention.launches_by_route, 0)
    outs = {name: flash_attention(*qkv[dt], causal=causal) for name, (dt, causal) in runs.items()}
    torch.cuda.synchronize()
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(flash_attention.launches_by_route)
    check(counted["flash_attention"] == len(runs) and sum(counted.values()) == len(runs),
          f"attention path launches {counted}")
    check(routes == {"wgmma": 2, "fma": 1}, f"attention path routes {routes}: both bf16 "
                                            f"prefills must take wgmma, f32 fma")

    # bf16 control: how far rounding to bf16 alone moves the plain version
    # from the f32 reference; the bf16 kernel may be at most twice as far
    want32 = flash_attention_ref(*qkv[torch.float32], causal=True)
    want16 = flash_attention_ref(*qkv[torch.bfloat16], causal=True)
    control = row_rel_err(want16, want32)
    to_f32 = row_rel_err(outs["bf16"], want32)
    log(f"attention bf16 against the f32 reference, worst row: kernel {to_f32:.4g}, plain "
        f"version {control:.4g} (the control; limit twice it)")
    check(to_f32 <= 2 * control, f"attention bf16: kernel {to_f32} from the f32 reference, "
                                 f"over twice the plain version's {control}")
    del want16

    rec = {}
    for name, (dt, causal) in runs.items():
        qf, kf, vf = qkv[dt]
        got = outs[name]
        check(tuple(got.shape) == (H, S, D) and got.dtype == dt, f"attention {name}: shape")
        check(bool(torch.isfinite(got).all()), f"attention {name}: non-finite")
        want = want32 if name == "f32" else flash_attention_ref(qf, kf, vf, causal=causal)
        err = row_rel_err(got, want)
        check(err <= TOL[dt], f"attention {name}: worst row's error {err} against the "
                              f"plain version")
        abs_err = (got.float() - want.float()).abs().max().item()
        log(f"attention {name}: worst row's error against the plain version {err:.4g} "
            f"(limit {TOL[dt]:g}), max abs error {abs_err:.3g}")
        del want
        ms = time_with(lambda: flash_attention(qf, kf, vf, causal=causal), reps, counters)
        plain_ms = cuda_ms(lambda: flash_attention_ref(qf, kf, vf, causal=causal), 2)
        q4, k4, v4 = (x.view(1, H, S, D) for x in (qf, kf, vf))
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), reps)
        pairs = S * (S + 1) // 2 if causal else S * S   # (i, j) pairs computed
        flops = 4 * H * D * pairs
        b_ms, by = bound(4 * nbytes(qf), flops, dt)
        log(f"attention prefill [{name}] BH={H} S=T={S} D={D} causal={causal}: kernel "
            f"{ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s, bound {b_ms:.4f} ms ({by}), "
            f"{100 * b_ms / ms:.2f}% of bound; plain {plain_ms:.4f} ms; SDPA {lib_ms:.4f} ms "
            f"(kernel/SDPA {ms / lib_ms:.3f}x); max abs error {abs_err:.3g}")
        rec[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                         library_ms=lib_ms, max_abs_err=abs_err)
        if dt == torch.float32:
            rec[name]["library"] = f"SDPA, default call ({sdpa_backend(q4, k4, v4, causal, reps)})"
    log(f"attention: path launches {counted}, by route {routes}")
    return {**rec["bf16"], "launches": counted["flash_attention"], "fma": rec["f32"]}


# ------------------------------------------------------------------ phase 11
#: the serving cell: internlm2-20b at its published widths, depth cut to
#: ``periods`` layers (the one cut); 8 greedy requests of 32-256 prompt
#: tokens and 16 new tokens on 4 slots
SERVE = dict(arch="internlm2-20b", periods=4, requests=8, prompt=(32, 256), max_new=16,
             slots=4, max_len=512, chunk=64, top_shapes=8)


def serve_traffic(cfg, seed: int):
    from repro_torch.runtime.scheduler import Request

    rng = np.random.default_rng(seed)
    lo, hi = SERVE["prompt"]
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
                    .astype(np.int32), max_new_tokens=SERVE["max_new"])
            for i in range(SERVE["requests"])]


def timed_serve(rt, traffic) -> dict:
    """Serve ``traffic`` with every prefill chunk and decode tick timed by
    the host clock between device synchronisations: ms per chunk by its
    length, ms per tick by its bucket, tokens/s over the whole serve."""
    chunks, ticks = {}, {}
    prefill_impl, decode_impl = rt._run_prefill_chunk_impl, rt._run_decode_impl

    def timed(fn, into, key):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        into.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)

    rt._run_prefill_chunk_impl = lambda state, chunk: timed(
        lambda: prefill_impl(state, chunk), chunks, chunk)
    rt._run_decode_impl = lambda decodes: timed(
        lambda: decode_impl(decodes), ticks, rt.lattice.decode_bucket(len(decodes)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.serve(traffic)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        rt._run_prefill_chunk_impl, rt._run_decode_impl = prefill_impl, decode_impl
    tokens = sum(len(r.output) for r in traffic)
    n_chunks = sum(len(v) for v in chunks.values())
    return dict(wall_ms=wall_ms, tokens_per_s=tokens / wall_ms * 1e3, tokens=tokens,
                chunk_ms=sum(map(sum, chunks.values())) / n_chunks, n_chunks=n_chunks,
                chunk_ms_by_len={c: sum(v) / len(v) for c, v in sorted(chunks.items())},
                tick_ms_by_bucket={b: sum(v) / len(v) for b, v in sorted(ticks.items())},
                ticks_by_bucket={b: len(v) for b, v in sorted(ticks.items())},
                outputs=[list(r.output) for r in traffic])


def serve_path(dev, seed: int, counters) -> dict:
    """internlm2-20b at full width through ``ServingRuntime`` on the kernel
    backend, then the same traffic on the torch backend (see the module
    docstring, phase 11).  Returns ``native_gemm``'s serving record."""
    from repro_torch.configs import get_config
    from repro_torch.core.contract import record_contractions
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.models import transformer
    from repro_torch.runtime.engine import ServingRuntime, slot_cache
    from repro_torch.serving.engine import ServeEngine

    periods = SERVE["periods"]
    full = get_config(SERVE["arch"])
    cfg = full.with_(n_periods=periods, contract_backend="kernel", contract_strategy="auto")
    cfg_t = cfg.with_(contract_backend="torch")
    log(f"serve: {cfg.arch_id} d_model {cfg.d_model}, {cfg.n_heads} query heads over "
        f"{cfg.n_kv_heads} KV heads, head dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype} activations, {cfg.param_dtype} params; depth cut "
        f"from {full.n_periods} layers to {periods} (the one cut); "
        f"{cfg.param_count() / 1e9:.2f}B params")
    t0 = time.perf_counter()
    params = transformer.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    torch.cuda.synchronize()
    log(f"serve: random weights drawn on the card in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated")
    kw = dict(slots=SERVE["slots"], max_len=SERVE["max_len"])

    t0 = time.perf_counter()
    rt = ServingRuntime(cfg, params, prefill_chunk=SERVE["chunk"], **kw)
    torch.cuda.synchronize()
    log(f"serve: runtime built, warm-up of every lattice point {rt.lattice.describe()} in "
        f"{time.perf_counter() - t0:.2f} s ({rt.program_stats})")
    warm = rt.serve(serve_traffic(cfg, seed))
    entries = rt.buckets.compiles

    # the main path: counts to 0 just before, read just after
    traffic = serve_traffic(cfg, seed)
    for c in counters:
        c.launches = 0
    native_gemm.launches_by_route = dict.fromkeys(native_gemm.launches_by_route, 0)
    with recording_launches() as launches, native_routes_held() as held:
        rt.serve(traffic)
        torch.cuda.synchronize()
    counted = {c.__name__: c.launches for c in counters}
    routes = dict(native_gemm.launches_by_route)
    outputs = [r.output for r in traffic]
    check(all(r.done and len(r.output) == SERVE["max_new"] for r in traffic),
          f"serve: not every request finished with its {SERVE['max_new']} tokens: "
          f"{[(r.rid, r.status, len(r.output)) for r in traffic]}")
    check(rt.buckets.compiles == entries, f"serve: the second serve built "
                                          f"{rt.buckets.compiles - entries} bucket entries")
    check(outputs == [r.output for r in warm], "serve: the warm-up serve gave other tokens")
    check(counted["native_gemm"] > 0, "serve: native_gemm launched no time")
    check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"serve: another kernel launched on the path: {counted}")
    check(counted["native_gemm"] == sum(n for n, _ in launches.values())
          and routes == held, f"serve: launch count {counted} or routes {routes} differ "
                              f"from the recorded run's {held}")
    log(f"serve: {len(traffic)} requests, prompts {[len(r.prompt) for r in traffic]}, "
        f"{sum(len(o) for o in outputs)} tokens; native_gemm launches {counted['native_gemm']} "
        f"by route {routes}; grouped_gemm {counted['grouped_gemm']}, flash_attention "
        f"{counted['flash_attention']}; bucket entries {entries}, none built by the second "
        f"serve")

    # every model contraction of a decode pass and of a prefill chunk
    # launches native_gemm once: 9 per layer (q, k, v, o, scores, P.V and
    # three MLP products) and the LM head
    scratch = slot_cache(cfg, SERVE["slots"], SERVE["max_len"], device=dev)
    toks = torch.zeros((SERVE["slots"], 1), dtype=torch.long, device=dev)
    prompt = torch.as_tensor(traffic[0].prompt[:SERVE["chunk"]], device=dev)[None].long()
    # launches ``wgmma`` for the 7 dense products of a layer and the LM head,
    # ``generic`` for the scores and P.V products
    per_pass = {"wgmma": 7 * periods + 1, "generic": 2 * periods}
    for name, run in (("decode pass", lambda: transformer.decode_step(cfg, params, scratch, toks)),
                      ("prefill chunk", lambda: transformer.prefill(
                          cfg, params, {"tokens": prompt},
                          transformer.init_cache(cfg, 1, SERVE["max_len"], device=dev)))):
        before = native_gemm.launches, dict(native_gemm.launches_by_route)
        with torch.no_grad(), record_contractions() as rec:
            run()
        n = native_gemm.launches - before[0]
        by_route = {r: c - before[1][r] for r, c in native_gemm.launches_by_route.items()
                    if c > before[1][r]}
        check(n == len(rec) == 9 * periods + 1,
              f"serve: a {name} made {len(rec)} contractions and {n} native_gemm launches, "
              f"not {9 * periods + 1} each")
        check(by_route == per_pass, f"serve: a {name} launched by route {by_route}, not "
                                    f"{per_pass}")
        log(f"serve: one {name}: {len(rec)} contractions, {n} native_gemm launches, by route "
            f"{by_route}")
    check(routes["wgmma"] * (9 * periods + 1) == per_pass["wgmma"] * counted["native_gemm"]
          and routes["wgmma"] + routes["generic"] == counted["native_gemm"],
          f"serve: the counted serve's routes {routes} are not {per_pass['wgmma']} wgmma in "
          f"every {9 * periods + 1} launches")
    native_gemm.launches = counted["native_gemm"]
    native_gemm.launches_by_route = dict(routes)

    legacy = ServeEngine(cfg, params, **kw).serve(serve_traffic(cfg, seed))
    check([r.output for r in legacy] == outputs,
          "serve: the runtime's tokens differ from ServeEngine's (the legacy oracle)")
    log("serve: tokens equal ServeEngine's (legacy engine, same kernels)")

    with torch.no_grad():
        cache = transformer.init_cache(cfg, 1, SERVE["max_len"], device=dev)
        prompt = torch.as_tensor(traffic[0].prompt, device=dev)[None].long()
        got, _ = transformer.prefill(cfg, params, {"tokens": prompt}, cache)
        want, _ = transformer.prefill(cfg_t, params, {"tokens": prompt}, cache)
    err = rel_err(got, want)
    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (1, cfg.vocab_size),
          "serve: prefill logits not finite or of the wrong shape")
    check(err <= TOL[torch.bfloat16], f"serve: kernel prefill logits {err} from the torch "
                                      f"backend's (limit {TOL[torch.bfloat16]})")
    log(f"serve: prefill logits of a {prompt.shape[1]}-token prompt, kernel against torch "
        f"backend: {err:.4g} of the largest magnitude (limit {TOL[torch.bfloat16]:g})")

    # times, the two backends in turns
    rt_t = ServingRuntime(cfg_t, params, prefill_chunk=SERVE["chunk"], **kw)
    rt_t.serve(serve_traffic(cfg, seed))
    saved = [c.launches for c in counters]
    runs = {"kernel": [], "torch": []}
    for backend in ("kernel", "torch", "torch", "kernel"):
        res = timed_serve(rt if backend == "kernel" else rt_t, serve_traffic(cfg, seed))
        runs[backend].append(res)
        log(f"serve [{backend}]: {res['tokens']} tokens in {res['wall_ms']:.1f} ms, "
            f"{res['tokens_per_s']:.1f} tokens/s; prefill {res['chunk_ms']:.3f} ms per chunk "
            f"over {res['n_chunks']} chunks (by length: "
            f"{', '.join(f'{c}: {m:.3f}' for c, m in res['chunk_ms_by_len'].items())}); "
            f"decode ms per tick by bucket: "
            f"{', '.join(f'{b}: {m:.3f} (x{res['ticks_by_bucket'][b]})' for b, m in res['tick_ms_by_bucket'].items())}")
    check(all(r["outputs"] == outputs for r in runs["kernel"]),
          "serve: a timed kernel serve gave other tokens")
    # where a decode pass (bucket 4) and a 64-token prefill chunk spend
    # device time, and how long the device idles, on each backend
    profiles = {}
    chunk = torch.as_tensor(traffic[0].prompt[:SERVE["chunk"]], device=dev)[None].long()
    with torch.no_grad():
        for backend, conf in (("kernel", cfg), ("torch", cfg_t)):
            for step, fn in (
                    ("decode pass", lambda conf=conf: transformer.decode_step(
                        conf, params, scratch, toks)),
                    ("prefill chunk", lambda conf=conf: transformer.prefill(
                        conf, params, {"tokens": chunk},
                        transformer.init_cache(conf, 1, SERVE["max_len"], device=dev)))):
                fn()
                profiles[f"{backend} {step}"] = profile_device(f"one {step} [{backend}]", fn, top=6)
    for c, n in zip(counters, saved):
        c.launches = n
    same = sum(a == b for r in runs["torch"] for a, b in zip(r["outputs"], outputs))
    log(f"serve: the torch backend's greedy tokens equal the kernel backend's in {same} of "
        f"{2 * len(outputs)} requests (bf16 rounding differs between the two)")
    del rt_t, legacy

    tot = time_shapes(launches, reps=10, per="serve", top=SERVE["top_shapes"])
    return dict(launches=counted["native_gemm"], launches_by_route=routes, periods=periods,
                profiles=profiles,
                tokens_per_s={b: [r["tokens_per_s"] for r in v] for b, v in runs.items()},
                runs={b: [{k: v for k, v in r.items() if k != "outputs"}
                                            for r in rs] for b, rs in runs.items()},
                top_shapes={k: tot[k] for k in ("ms", "library_ms", "bound_ms", "plain_ms",
                                                  "max_abs_err", "bound_by")})


# ------------------------------------------------------------------ phase 12
def every_arch(dev, seed: int, counters) -> dict:
    """Each of the ten smoke configs (float32) on the card with the kernel
    backend and on the CPU with the same weights (the plain version): one
    forward; for decoders, prefill plus 3 decode steps (through
    ``ServingRuntime`` with its decode logits, or through the model for a
    vision model, whose prompt carries patch features the runtime does not
    take).  Logits agree within 1e-4 of the largest magnitude."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import transformer
    from repro_torch.models.tree import tree_map
    from repro_torch.runtime.engine import ServingRuntime
    from repro_torch.runtime.scheduler import Request

    tol = 1e-4
    for c in counters:
        c.launches = 0
    worst = {}
    for arch in list_archs():
        cfg = get_config(arch, smoke=True, contract_backend="kernel")
        cpu = transformer.init_params(torch.Generator().manual_seed(seed), cfg)
        card = tree_map(lambda t: t.to(dev), cpu)
        rng = np.random.default_rng(seed)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
        if cfg.frontend is not None:
            n = 16 if cfg.frontend.kind == "audio" else cfg.frontend.n_positions
            batch["features"] = rng.standard_normal((2, n, cfg.frontend.feature_dim),
                                                    dtype=np.float32)
        on = {d: {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
              for d in (dev, torch.device("cpu"))}
        errs = []
        with torch.no_grad():
            got, _ = transformer.forward(cfg, card, on[dev])
            want, _ = transformer.forward(cfg, cpu, on[torch.device("cpu")])
            errs.append(rel_err(got.cpu(), want))
            if cfg.encoder_only:
                pass
            elif cfg.frontend is not None:
                outs = []
                for params, d in ((card, dev), (cpu, torch.device("cpu"))):
                    cache = transformer.init_cache(cfg, 2, 64, device=d)
                    logits, cache = transformer.prefill(cfg, params, on[d], cache)
                    seq = [logits.cpu()]
                    for _ in range(3):
                        logits, cache = transformer.decode_step(
                            cfg, params, cache, torch.argmax(logits, -1)[:, None])
                        seq.append(logits.cpu())
                    outs.append(seq)
                errs += [rel_err(g, w) for g, w in zip(*outs)]
            else:
                outs = []
                for params in (card, cpu):
                    rt = ServingRuntime(cfg, params, slots=2, max_len=64, prefill_chunk=8)
                    seen = []
                    rt.logits_probe = lambda logits: seen.append(logits.cpu())
                    reqs = rt.serve([Request(rid=i, prompt=batch["tokens"][i].astype(np.int32),
                                             max_new_tokens=4) for i in range(2)])
                    check(all(r.done and len(r.output) == 4 for r in reqs),
                          f"{arch}: a request did not finish")
                    outs.append((seen, [r.output for r in reqs]))
                (seen_g, toks_g), (seen_c, toks_c) = outs
                check(toks_g == toks_c, f"{arch}: tokens on the card {toks_g} differ from the "
                                        f"CPU's {toks_c}")
                check(len(seen_g) == len(seen_c) == 3, f"{arch}: {len(seen_g)} decode steps")
                errs += [rel_err(g, w) for g, w in zip(seen_g, seen_c)]
        worst[arch] = max(errs)
        check(worst[arch] <= tol, f"{arch}: card against CPU {worst[arch]} (limit {tol})")
        log(f"arch {arch}: forward{'' if cfg.encoder_only else ' + prefill + 3 decode steps'} "
            f"on the card (kernel) against the CPU (plain version): worst {worst[arch]:.3g} "
            f"of the largest logit magnitude over {len(errs)} comparisons (limit {tol:g})")
    torch.cuda.synchronize()
    counted = {c.__name__: c.launches for c in counters}
    check(counted["native_gemm"] > 0 and counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"every-arch launches {counted}")
    log(f"every arch: launches {counted}")
    return worst


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
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.grouped_gemm import grouped_gemm
    from repro_torch.kernels.sb_gemm import native_gemm

    counters = [native_gemm, grouped_gemm, flash_attention]

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = device_line()
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"TF32 off for matmul and cuDNN")

    t0 = time.perf_counter()
    secs = build()
    log(f"build: {', '.join(f'{n}.cu {t:.2f} s' for n, t in secs.items())}; all compiled "
        f"and loaded in {time.perf_counter() - t0:.2f} s")
    flash_kernel_info()
    grouped_kernel_info()
    native_kernel_info()

    check_table2(dev)
    check_layoutfuzz(dev)
    check_grads(dev)
    check_small_hooi(dev)
    check_native_routes(dev)
    check_grouped(dev)
    check_flash(dev)

    T, noise_share = low_rank_plus_noise(args.size, RANKS, args.seed, device=dev)
    with record_contractions() as rec:
        hooi(T, RANKS, n_iter=1, **VARIANTS["kernel"])
    working_set = list({s: d for s, d, _ in rec}.items())
    check_copy_freedom(dev, working_set)

    counted, routes, launches, hooi_summary = main_path(T, noise_share, args.n_iter, counters)
    check(counted["grouped_gemm"] == counted["flash_attention"] == 0,
          f"HOOI launched another kernel: {counted}")
    tuned = tuned_path(T, rec, noise_share, args.n_iter, counters, hooi_summary)
    tot = time_shapes(launches)
    for variant in VARIANTS:
        profile_hooi(T, args.n_iter, variant)
    del T

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    records = {
        "grouped_gemm": ("grouped_gemm.cu", "grouped_gemm.py:248",
                         grouped_path(dev, args.seed, counters)),
        "flash_attention": ("flash_attn.cu", "flash_attn.py:79",
                            attention_path(dev, args.seed, counters)),
    }
    serve = serve_path(dev, args.seed, counters)
    every_arch(dev, args.seed, counters)
    records = {
        "native_gemm": ("sb_gemm.cu", "sb_gemm.py:87",
                        {**tot, "launches": counted["native_gemm"],
                         "launches_by_route": routes,
                         "tuned_launches_by_route": tuned["launches_by_route"],
                         "serve_launches": serve["launches"],
                         "serve_launches_by_route": serve["launches_by_route"],
                         "serve": {k: v for k, v in serve.items()
                                   if k not in ("launches", "launches_by_route")}}),
        **records,
    }
    kernels = [{"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": f"src/repro/kernels/{tpu}",
                **{k: rec[k] for k in keys},
                **{k: rec[k] for k in ("launches_by_route", "tuned_launches_by_route",
                                       "serve_launches", "serve_launches_by_route", "serve",
                                       "fma") if k in rec}}
               for name, (src, tpu, rec) in records.items()]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was launched no time on its path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
