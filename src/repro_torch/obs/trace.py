"""Low-overhead span tracer: the process-wide observability substrate.

The paper's benchmarking methodology (Figs. 1-14) measures every
contraction offline; this module makes the same attribution available
*in production*: any layer can open a :func:`span` around work it does
and attach typed attributes (strategy, spec, flops, bytes), and the
exporter (:mod:`repro_torch.obs.export`) turns the recorded stream into a
Chrome-trace file (Perfetto / ``chrome://tracing``) plus flat JSONL
records usable as predictor training data (Peise et al.,
arXiv:1409.8608).

Design constraints, in priority order:

* **Disabled is (almost) free.** Tracing defaults off; every
  instrumentation site pays one module-global check.  ``span()`` with no
  attributes allocates nothing when disabled — it returns the shared
  :data:`NULL_SPAN` singleton, whose ``__bool__`` is ``False`` so hot
  sites guard attribute construction behind ``if sp:``.
* **Bounded memory.** Finished events land in a ring buffer of fixed
  ``capacity``; overflow overwrites the oldest events and counts
  ``dropped`` (never grows, never throws).
* **Deterministic tests.** The clock is injectable
  (``Tracer(clock=...)``); timestamps are monotonic µs relative to the
  tracer's epoch.

Hot-loop idiom (one branch when disabled, zero allocations)::

    from repro_torch.obs import trace

    with trace.span("decode_batch", "runtime") as sp:
        out = launch(...)
        if sp:                      # False for the disabled-mode no-op
            sp.set(bucket=bucket, n_active=n)

Spans nest lexically: the tracer tracks the open-span stack and records
each event's ``depth`` and ``cat`` (layer), so a ``contract`` span opened
inside an ``execute_native`` span is recorded one level deeper.

Span durations (``dur``) are host time: a span around a CUDA launch
measures the enqueue, not the kernel.  A span finishing with
``roofline_bound_us`` among its attributes gains a derived
``roofline_fraction`` (bound ÷ duration, see :mod:`repro_torch.obs.roofline`),
and the duration it divides by depends on where the work ran:

* a span that called :meth:`Span.time_device` (``contract`` does, for
  operands on the card) records a CUDA event pair around its body.  Its
  fraction divides by that device time, which is resolved when the
  tracer's events are read (:meth:`Tracer.events`, after one
  ``torch.cuda.synchronize()``, never at span exit) and recorded beside
  it as ``device_us``;
* any other span divides by its host duration, at exit, as the JAX
  package does.
"""

from __future__ import annotations

import time

import torch

__all__ = [
    "Tracer",
    "Span",
    "NULL_SPAN",
    "enabled",
    "enable_tracing",
    "disable_tracing",
    "get_tracer",
    "set_tracer",
    "span",
    "instant",
]

#: event phases (mirroring the Chrome trace ``ph`` field): complete
#: spans ("X") and zero-duration instants ("i").
PH_SPAN, PH_INSTANT = "X", "i"


class Span:
    """A live (open) span.  Use as a context manager; attach attributes
    with :meth:`set`.  Truthy — the disabled-mode :data:`NULL_SPAN` is
    falsy, which is the one branch hot sites pay for attributes."""

    __slots__ = ("_tracer", "name", "cat", "ts", "depth", "attrs", "_device")

    def __init__(self, tracer: "Tracer", name: str, cat: str, ts: float,
                 depth: int, attrs: dict | None):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.ts = ts
        self.depth = depth
        self.attrs = dict(attrs) if attrs else {}
        self._device = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def time_device(self, device) -> "Span":
        """Record a CUDA event on ``device``'s current stream now, and
        another at exit: the span's ``roofline_fraction`` then divides by
        the device time between them (see the module docstring)."""
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(device))
        self._device = (device, start)
        return self

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._finish(self)
        return False


class _NullSpan:
    """Shared no-op span: the disabled-mode fast path.  Falsy, so
    ``if sp: sp.set(...)`` skips attribute construction entirely."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


#: the singleton every disabled-mode ``span()`` call returns.
NULL_SPAN = _NullSpan()


class Tracer:
    """Ring-buffered span recorder with an injectable monotonic clock.

    Args:
      capacity: ring-buffer size in events; overflow overwrites the
        oldest events (``dropped`` counts them).
      clock: a monotonic ``() -> float`` seconds callable
        (default ``time.perf_counter``); injectable for tests.
    """

    def __init__(self, capacity: int = 65536, clock=time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self._epoch = clock()
        self._ring: list[dict] = []
        self._total = 0              # events ever recorded
        self._open: list[Span] = []  # lexical nesting stack
        # (event, start, end) of device-timed spans not yet resolved
        self._pending: list[tuple] = []

    # -------------------------------------------------------------- recording
    def now_us(self) -> float:
        """Microseconds since the tracer's epoch (monotonic)."""
        return (self.clock() - self._epoch) * 1e6

    def span(self, name: str, cat: str = "app", attrs: dict | None = None
             ) -> Span:
        """Open a span; it records itself on ``__exit__``."""
        sp = Span(self, name, cat, self.now_us(), len(self._open), attrs)
        self._open.append(sp)
        return sp

    def instant(self, name: str, cat: str = "app",
                attrs: dict | None = None) -> None:
        """Record a zero-duration event at the current time."""
        self._record({
            "ph": PH_INSTANT, "name": name, "cat": cat,
            "ts": self.now_us(), "dur": 0.0, "depth": len(self._open),
            "args": dict(attrs) if attrs else {},
        })

    def _finish(self, sp: Span) -> None:
        end = self.now_us()
        # pop by identity: tolerate out-of-order exits (e.g. a generator
        # holding a span open across another span's lifetime)
        for i in range(len(self._open) - 1, -1, -1):
            if self._open[i] is sp:
                del self._open[i]
                break
        dur = max(end - sp.ts, 0.0)
        ev = {
            "ph": PH_SPAN, "name": sp.name, "cat": sp.cat,
            "ts": sp.ts, "dur": dur, "depth": sp.depth, "args": sp.attrs,
        }
        bound = sp.attrs.get("roofline_bound_us")
        if sp._device is not None:
            device, start = sp._device
            stop = torch.cuda.Event(enable_timing=True)
            stop.record(torch.cuda.current_stream(device))
            self._pending.append((ev, start, stop))
            if len(self._pending) > self.capacity:
                del self._pending[0]     # its event has left the ring too
        elif bound is not None and "roofline_fraction" not in sp.attrs:
            sp.attrs["roofline_fraction"] = (
                float(bound) / dur if dur > 0 else 0.0
            )
        self._record(ev)

    def _record(self, ev: dict) -> None:
        ev["seq"] = self._total
        if len(self._ring) < self.capacity:
            self._ring.append(ev)
        else:
            self._ring[self._total % self.capacity] = ev
        self._total += 1

    # ------------------------------------------------------------- inspection
    @property
    def dropped(self) -> int:
        """Events lost to ring overflow."""
        return max(0, self._total - self.capacity)

    @property
    def total(self) -> int:
        """Events ever recorded (kept + dropped)."""
        return self._total

    def resolve_device_times(self) -> None:
        """Give every device-timed span its ``device_us`` and, where it
        carries a bound, its ``roofline_fraction`` (one
        ``torch.cuda.synchronize()`` when any is pending)."""
        if not self._pending:
            return
        torch.cuda.synchronize()
        for ev, start, stop in self._pending:
            us = start.elapsed_time(stop) * 1e3
            args = ev["args"]
            args["device_us"] = us
            bound = args.get("roofline_bound_us")
            if bound is not None and "roofline_fraction" not in args:
                args["roofline_fraction"] = float(bound) / us if us > 0 else 0.0
        self._pending.clear()

    def events(self) -> list[dict]:
        """Retained events in recording order (oldest first), with device
        times resolved (:meth:`resolve_device_times`)."""
        self.resolve_device_times()
        if self._total <= self.capacity:
            return list(self._ring)
        head = self._total % self.capacity
        return self._ring[head:] + self._ring[:head]

    def clear(self) -> None:
        self._ring.clear()
        self._total = 0
        self._open.clear()
        self._pending.clear()


# --------------------------------------------------------------------------
# Process-wide tracer (the module-level fast path)
# --------------------------------------------------------------------------

_TRACER: Tracer | None = None
_ENABLED = False


def enabled() -> bool:
    """Is tracing on?  The one branch instrumentation sites pay."""
    return _ENABLED


def get_tracer() -> Tracer | None:
    """The process tracer (present even while disabled), or ``None``."""
    return _TRACER


def set_tracer(tracer: Tracer | None) -> None:
    """Install (or clear) the process tracer without toggling enablement."""
    global _TRACER, _ENABLED
    _TRACER = tracer
    if tracer is None:
        _ENABLED = False


def enable_tracing(tracer: Tracer | None = None, *, capacity: int = 65536,
                   clock=time.perf_counter) -> Tracer:
    """Turn tracing on (creating a fresh :class:`Tracer` unless one is
    given) and return the active tracer."""
    global _TRACER, _ENABLED
    if tracer is not None:
        _TRACER = tracer
    elif _TRACER is None:
        _TRACER = Tracer(capacity=capacity, clock=clock)
    _ENABLED = True
    return _TRACER


def disable_tracing() -> Tracer | None:
    """Turn tracing off; the tracer (and its events) stays available for
    export.  Returns it."""
    global _ENABLED
    _ENABLED = False
    return _TRACER


def span(name: str, cat: str = "app"):
    """Open a span on the process tracer — or return :data:`NULL_SPAN`
    when tracing is disabled (no allocation; see the module docstring's
    hot-loop idiom for attaching attributes)."""
    if not _ENABLED:
        return NULL_SPAN
    return _TRACER.span(name, cat)


def instant(name: str, cat: str = "app", **attrs) -> None:
    """Record an instant event on the process tracer (no-op when
    disabled).  Keyword attributes become the event's ``args`` — fine
    for per-request events; inside per-tick loops prefer the span idiom."""
    if not _ENABLED:
        return
    _TRACER.instant(name, cat, attrs)
