"""Timing harness for contraction candidates.

Warmup runs, then the median of ``iters`` timed samples — the discipline
the dispatcher, the serving warm-up pass and the benchmarks share.  The
clock depends on where the operands lie:

* on a card, each sample is the device time of one call queued behind a
  short sleeping kernel (CUDA events around the call, recorded while the
  sleep still runs), so the host's time to enqueue the call is not
  counted — a wrapper's Python can take as long as a small kernel;
* on the CPU, ``time.perf_counter`` around the call (PyTorch's CPU
  operators return when they are done).

No candidate is wrapped in ``try``: a candidate that fails to build or
launch raises out of the tuner, so a kernel fault can never turn into a
library candidate's win.  Optionally audits each candidate for copies
(:func:`repro_torch.core.contract.count_copy_ops`): a candidate that wins
on time but moves data is worth flagging (the paper's Fig. 1 cost).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.tuning.candidates import Candidate

__all__ = ["Measurement", "time_callable", "measure_candidate", "measure_candidates"]

#: cycles of the first sleeping kernel a sample's call is queued behind
#: (about 1 ms on an H100 at 1980 MHz); doubled until the call was
#: enqueued before the sleep ended
SLEEP_CYCLES = 2_000_000
_MAX_SLEEP_CYCLES = 64 * SLEEP_CYCLES


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One timed candidate: median µs over ``iters`` post-warmup samples."""

    us: float
    iters: int
    warmup: int
    transposes: int | None = None   # copies counted by count_copy_ops (audit)


class _Clock:
    """One sample of a call: device time behind a sleeping kernel on a
    card, host time on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.cycles = SLEEP_CYCLES
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def sample(self, fn) -> float:
        if not self.cuda:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e6
        stream = torch.cuda.current_stream(self.device)
        while True:
            torch.cuda.synchronize(self.device)
            with torch.cuda.device(self.device):
                torch.cuda._sleep(self.cycles)
            self.start.record(stream)
            fn()
            self.end.record(stream)
            queued = not self.start.query()   # the sleep outlasted the enqueue
            torch.cuda.synchronize(self.device)
            if queued:
                return self.start.elapsed_time(self.end) * 1e3
            if self.cycles >= _MAX_SLEEP_CYCLES:
                raise RuntimeError("a call could not be queued behind the sleep")
            self.cycles *= 2


def time_callable(fn, *args, iters: int = 5, warmup: int = 2) -> float:
    """Median µs of ``fn(*args)`` after ``warmup`` calls, on the device of
    the first tensor argument (see the module docstring)."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                torch.device("cpu"))
    return _median(_Clock(dev), lambda: fn(*args), iters, warmup)


def _median(clock: _Clock, fn, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    return float(np.median([clock.sample(fn) for _ in range(max(iters, 1))]))


def _call(cand: Candidate, spec, A, B):
    from repro_torch.core.contract import contract

    tiles = cand.tiles_dict or None
    return lambda: contract(spec, A, B, strategy=cand.strategy,
                            backend=cand.backend, tiles=tiles)


def _copies(fn) -> int:
    from repro_torch.core.contract import count_copy_ops

    return sum(count_copy_ops(fn).values())


def measure_candidate(
    cand: Candidate,
    spec,
    A,
    B,
    *,
    iters: int = 5,
    warmup: int = 2,
    audit_transposes: bool = False,
) -> Measurement:
    """Time one :class:`Candidate` on concrete operands.  With
    ``audit_transposes`` the copies its call makes
    (:func:`repro_torch.core.contract.count_copy_ops`) are counted and
    attached to the result."""
    fn = _call(cand, spec, A, B)
    return Measurement(us=_median(_Clock(A.device), fn, iters, warmup),
                       iters=iters, warmup=warmup,
                       transposes=_copies(fn) if audit_transposes else None)


def measure_candidates(
    cands,
    spec,
    A,
    B,
    *,
    iters: int = 5,
    warmup: int = 2,
    audit_transposes: bool = False,
) -> dict[str, Measurement]:
    """Time a whole candidate set with *interleaved* sampling.

    Every candidate is warmed first (on a card this builds and loads the
    kernel), then samples alternate round-robin across them — so slow
    machine drift (other tenants, clock states) hits every candidate
    equally instead of biasing whichever was timed last.  Returns
    ``{candidate.key(): Measurement}``.
    """
    fns = [(c.key(), _call(c, spec, A, B)) for c in cands]
    clock = _Clock(A.device)
    for _, f in fns:
        for _ in range(max(warmup, 1)):
            f()
    samples: dict[str, list[float]] = {k: [] for k, _ in fns}
    for _ in range(max(iters, 1)):
        for k, f in fns:
            samples[k].append(clock.sample(f))
    return {
        k: Measurement(us=float(np.median(samples[k])), iters=iters, warmup=warmup,
                       transposes=_copies(f) if audit_transposes else None)
        for k, f in fns
    }
