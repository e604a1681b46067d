"""SLO watchdogs over the live metric series: typed health alerts.

The time-series layer (:mod:`repro_torch.obs.timeseries`) records what the
fleet is doing; this module decides when that is *wrong*.  Each
watchdog is a small pure predicate over a :class:`MetricsSampler`'s
series that fires a typed :class:`Alert`; the :class:`HealthMonitor`
runs the pack after every sample, emits each alert as a tracer instant
on the ``health`` category (rid-style correlation with the rest of the
trace), keeps a bounded recent-alerts list, and exposes its counts as a
registry source — so "is the fleet healthy" is one snapshot away.

Watchdog catalog (defaults in parentheses; thresholds are constructor
args, silencing = drop the watchdog from the pack):

* ``decode_stall`` (:class:`DecodeStallWatchdog`, budget 8 samples) —
  the runtime is ticking but no token/finish progress is made: the
  symptom of a wedged decode or a scheduler live-lock.
* ``recompile_storm`` (:class:`RecompileStormWatchdog`, warm-up 3
  samples) — ``bucket_compiles`` still growing after warm-up: the
  compile-once bucket contract is broken and latency cliffs follow.
* ``pool_pressure`` (:class:`PagePoolPressureWatchdog`, min free frac
  0.1) — the paged-KV free list is nearly dry: admissions will block
  and decode growth will start preempting.
* ``nonfinite_logits`` (:class:`NumericsProbe`, **off by default**) —
  a sampled ``isfinite`` reduction over decode logits; a NaN/Inf here
  means every later token from that request is garbage.  Costs one
  device reduction per probe, hence opt-in and sampled every N calls.

Alerts are **edge-triggered**: a watchdog fires when its condition
becomes true and re-arms only after it clears, so a persistent stall is
one alert, not one per sample.  With monitoring off nothing here is
ever constructed — the serving hot path keeps its disabled-is-free
contract (the engine's only addition is a single ``is not None`` test
on ``logits_probe``).

A copy of the JAX package's ``repro/obs/health.py``, apart from
:class:`NumericsProbe`, which reduces torch logits.  The serving runtime
that :meth:`HealthMonitor.attach` wires in is ROADMAP queue 1, item 11;
until it is ported, ``attach`` takes any object with a
``register_metrics(registry)`` method and a ``logits_probe`` attribute.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.obs import trace as _trace
from repro_torch.obs.timeseries import MetricsSampler

__all__ = [
    "Alert",
    "Watchdog",
    "DecodeStallWatchdog",
    "RecompileStormWatchdog",
    "PagePoolPressureWatchdog",
    "NumericsProbe",
    "HealthMonitor",
    "default_watchdogs",
]


@dataclasses.dataclass(frozen=True)
class Alert:
    """One typed health event."""

    name: str                     # watchdog id, e.g. "decode_stall"
    severity: str                 # "warning" | "critical"
    message: str                  # human-readable one-liner
    attrs: dict                   # the numbers behind the verdict
    t: float = 0.0                # sampler clock at fire time


class Watchdog:
    """Base: a named, edge-triggered predicate over the sampler."""

    name = "watchdog"
    severity = "warning"

    def __init__(self):
        self._active = False

    def check(self, sampler: MetricsSampler) -> Alert | None:
        """Fire on the rising edge of :meth:`condition`, re-arm on clear."""
        verdict = self.condition(sampler)
        if verdict is None:
            self._active = False
            return None
        if self._active:
            return None
        self._active = True
        msg, attrs = verdict
        return Alert(self.name, self.severity, msg, attrs)

    def condition(self, sampler: MetricsSampler):
        """``(message, attrs)`` when unhealthy, ``None`` when fine."""
        raise NotImplementedError


class DecodeStallWatchdog(Watchdog):
    """Ticks advance but neither tokens nor completions do.

    Over the last ``budget`` sampling intervals: ``serving.ticks`` grew
    by at least ``min_ticks`` (the runtime is alive and spinning) while
    ``serving.tokens_out`` and ``serving.requests_done`` are both flat —
    every spin did no useful work.
    """

    name = "decode_stall"
    severity = "critical"

    def __init__(self, budget: int = 8, min_ticks: int = 1):
        super().__init__()
        self.budget = int(budget)
        self.min_ticks = int(min_ticks)

    def condition(self, sampler):
        ticks = sampler.get("serving.ticks")
        toks = sampler.get("serving.tokens_out")
        done = sampler.get("serving.requests_done")
        if ticks is None or toks is None:
            return None
        d_ticks = ticks.delta(self.budget)
        d_toks = toks.delta(self.budget)
        if d_ticks is None or d_toks is None:
            return None
        d_done = done.delta(self.budget) if done is not None else 0.0
        if d_ticks >= self.min_ticks and d_toks == 0 and not d_done:
            return (
                f"no token/finish progress over {self.budget} samples "
                f"({d_ticks:.0f} ticks elapsed)",
                {"ticks_elapsed": d_ticks, "budget_samples": self.budget},
            )
        return None


class RecompileStormWatchdog(Watchdog):
    """``bucket_compiles`` growing after warm-up.

    The first ``warmup`` samples are free (the runtime legitimately
    compiles its lattice then); afterwards any growth beyond
    ``tolerance`` new compiles is a broken compile-once contract.
    """

    name = "recompile_storm"

    def __init__(self, warmup: int = 3, tolerance: int = 0):
        super().__init__()
        self.warmup = int(warmup)
        self.tolerance = int(tolerance)
        self._baseline: float | None = None

    def condition(self, sampler):
        ser = sampler.get("buckets.bucket_compiles")
        if ser is None or ser.total < self.warmup:
            return None
        if self._baseline is None:
            # compiles at the end of warm-up: everything after is storm
            self._baseline = ser.points()[min(self.warmup, len(ser)) - 1][1]
        latest = ser.latest()
        grown = latest - self._baseline
        if grown > self.tolerance:
            return (
                f"{grown:.0f} bucket recompiles after warm-up "
                f"(baseline {self._baseline:.0f}, now {latest:.0f})",
                {"recompiles": grown, "baseline": self._baseline,
                 "compiles": latest},
            )
        return None


class PagePoolPressureWatchdog(Watchdog):
    """The paged-KV free list is nearly dry.

    Fires when ``pages.pages_free / pages.pages_total`` drops below
    ``min_free_frac`` (only meaningful on the paged runtime; absent
    series never fire).
    """

    name = "pool_pressure"

    def __init__(self, min_free_frac: float = 0.1):
        super().__init__()
        self.min_free_frac = float(min_free_frac)

    def condition(self, sampler):
        free = sampler.get("pages.pages_free")
        total = sampler.get("pages.pages_total")
        if free is None or total is None:
            return None
        f, n = free.latest(), total.latest()
        if not n:
            return None
        frac = f / n
        if frac < self.min_free_frac:
            return (
                f"page pool {frac:.1%} free ({f:.0f}/{n:.0f} pages, "
                f"threshold {self.min_free_frac:.0%})",
                {"pages_free": f, "pages_total": n, "free_frac": frac},
            )
        return None


def default_watchdogs() -> list[Watchdog]:
    """The standard pack at default thresholds (see module doc)."""
    return [
        DecodeStallWatchdog(),
        RecompileStormWatchdog(),
        PagePoolPressureWatchdog(),
    ]


class NumericsProbe:
    """Sampled NaN/Inf check on decode logits — **off by default**.

    Installed on ``ServingRuntime.logits_probe`` by
    :meth:`HealthMonitor.attach`; every ``every``-th decode launch pays
    one ``torch.isfinite`` reduction (a device sync, which is why this is
    opt-in).  A non-finite batch fires a critical ``nonfinite_logits``
    alert through the monitor.
    """

    def __init__(self, monitor: "HealthMonitor", every: int = 16):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.monitor = monitor
        self.every = int(every)
        self.calls = 0
        self.probes = 0
        self.failures = 0

    def __call__(self, logits) -> None:
        self.calls += 1
        if self.calls % self.every:
            return
        self.probes += 1
        if bool(torch.isfinite(logits).all()):
            return
        self.failures += 1
        self.monitor.fire(Alert(
            "nonfinite_logits", "critical",
            "decode logits contain NaN/Inf",
            {"probe_calls": self.calls, "failures": self.failures},
        ))


class HealthMonitor:
    """Sampler + watchdog pack + alert sink, behind one ``tick()``.

    ``monitor.tick()`` samples the registry and runs every watchdog;
    fired alerts are appended to a bounded list, counted per name,
    emitted as tracer instants (cat ``health``) when tracing is on, and
    handed to ``on_alert`` (the launcher prints them).  Registry
    integration: :meth:`register` exposes ``health`` (alert counts) and
    ``timeseries`` (sampler stats) as sources — a monitor watching a
    registry it is also a source *of* is fine, since sources are
    late-bound and cycle-free.
    """

    def __init__(self, sampler: MetricsSampler | None = None,
                 watchdogs: list[Watchdog] | None = None, *,
                 on_alert=None, max_alerts: int = 256,
                 clock=time.monotonic):
        self.sampler = sampler if sampler is not None else MetricsSampler()
        self.watchdogs = (default_watchdogs() if watchdogs is None
                          else list(watchdogs))
        self.on_alert = on_alert
        self.max_alerts = int(max_alerts)
        self.clock = clock
        self.alerts: list[Alert] = []
        self.alert_counts: dict[str, int] = {}
        self.checks = 0
        self.probe: NumericsProbe | None = None

    # ------------------------------------------------------------------ core
    def tick(self) -> list[Alert]:
        """Sample (respecting the sampler's interval), then check every
        watchdog.  Returns new alerts; skipped samples check nothing —
        watchdog windows are counted in *samples*, so checking between
        samples would double-judge the same data."""
        if not self.sampler.maybe_sample():
            return []
        return self.check()

    def check(self) -> list[Alert]:
        """Run the watchdog pack over the current series."""
        self.checks += 1
        fired = []
        for wd in self.watchdogs:
            alert = wd.check(self.sampler)
            if alert is not None:
                fired.append(self.fire(alert))
        return fired

    def fire(self, alert: Alert) -> Alert:
        """Record + emit one alert (also the NumericsProbe entry point)."""
        alert = dataclasses.replace(alert, t=self.clock())
        self.alerts.append(alert)
        if len(self.alerts) > self.max_alerts:
            del self.alerts[: len(self.alerts) - self.max_alerts]
        self.alert_counts[alert.name] = self.alert_counts.get(alert.name, 0) + 1
        if _trace.enabled():
            _trace.instant(alert.name, "health", severity=alert.severity,
                           message=alert.message, **alert.attrs)
        if self.on_alert is not None:
            self.on_alert(alert)
        return alert

    # ------------------------------------------------------------- wiring
    def attach(self, runtime, *, numerics_every: int = 0) -> "HealthMonitor":
        """Wire a serving runtime in (see the module docstring):
        register its metric sources on the sampler's registry and, when
        ``numerics_every > 0``, install the sampled NaN/Inf probe on its
        decode path (the probe stays ``None`` — zero work — otherwise)."""
        runtime.register_metrics(self.sampler.registry)
        if numerics_every > 0:
            self.probe = NumericsProbe(self, every=numerics_every)
            runtime.logits_probe = self.probe
        return self

    def register(self, registry=None) -> None:
        """Expose this monitor on a registry (default: the sampler's)."""
        reg = registry if registry is not None else self.sampler.registry
        reg.register("health", self.stats)
        reg.register("timeseries", self.sampler.stats)

    # ------------------------------------------------------------------ view
    def stats(self) -> dict:
        out = {
            "checks": self.checks,
            "alerts_total": sum(self.alert_counts.values()),
        }
        for name, n in sorted(self.alert_counts.items()):
            out[f"alerts_{name}"] = n
        if self.probe is not None:
            out["numerics_probes"] = self.probe.probes
            out["numerics_failures"] = self.probe.failures
        return out
