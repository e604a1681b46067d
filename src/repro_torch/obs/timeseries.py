"""Time-series metrics: the fleet-health layer over the registry.

:mod:`repro_torch.obs.registry` answers "what are the counters *now*";
this module answers "what have they been doing" — which is what SLO
watchdogs (:mod:`repro_torch.obs.health`), drift detection
(:mod:`repro_torch.tuning.drift`) and any external scraper actually consume.
Everything is bounded-memory by construction: a serving process that
runs for a month must not grow its monitoring state with uptime.

Three layers:

* :class:`TimeSeries` — a fixed-capacity ring of ``(t, value)`` points
  (oldest samples fall off; ``dropped`` counts them, mirroring the
  tracer's ring contract);
* :class:`P2Quantile` / :class:`StreamingHistogram` — constant-memory
  quantile estimation via the P² algorithm (Jain & Chlamtac 1985:
  five markers per quantile, no sample buffer), so a p99 over millions
  of observations costs ~40 floats;
* :class:`MetricsSampler` — samples a
  :class:`~repro_torch.obs.registry.MetricsRegistry` snapshot on demand (or on
  a wall-clock interval via :meth:`~MetricsSampler.maybe_sample`),
  fans every numeric leaf into a named series
  (``"<source>.<metric>"``), feeds configured metrics into streaming
  histograms, and optionally appends each sample as one JSONL line.

Exposition: :meth:`MetricsSampler.prometheus_text` renders the latest
sample in Prometheus text format (``repro_serving_tokens_out 42``),
with histogram quantiles as ``{quantile="0.99"}``-labelled summary
rows — pointable at a node-exporter textfile collector or diffable in
CI.

The sampler never *enables* anything by itself: constructing one costs
a few dicts, and a runtime that is handed no sampler pays nothing —
the same disabled-is-free contract the tracer keeps.

A copy of the JAX package's ``repro/obs/timeseries.py``: it differs only
in import paths and docstrings.
"""

from __future__ import annotations

import json
import math
import re
import time

__all__ = [
    "TimeSeries",
    "P2Quantile",
    "StreamingHistogram",
    "MetricsSampler",
    "prom_name",
]


class TimeSeries:
    """Fixed-capacity ring of ``(t, value)`` samples (oldest drop)."""

    __slots__ = ("capacity", "_ring", "_total")

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: list[tuple[float, float]] = []
        self._total = 0

    def append(self, t: float, value: float) -> None:
        if len(self._ring) < self.capacity:
            self._ring.append((t, value))
        else:
            self._ring[self._total % self.capacity] = (t, value)
        self._total += 1

    def points(self) -> list[tuple[float, float]]:
        """Retained ``(t, value)`` pairs, oldest first."""
        if self._total <= self.capacity:
            return list(self._ring)
        head = self._total % self.capacity
        return self._ring[head:] + self._ring[:head]

    def values(self) -> list[float]:
        return [v for _, v in self.points()]

    def latest(self) -> float | None:
        if not self._ring:
            return None
        return self._ring[(self._total - 1) % self.capacity][1]

    def delta(self, window: int) -> float | None:
        """``latest - value window samples ago`` (monotonic-counter
        progress over the last ``window`` intervals), or ``None`` when
        fewer than ``window + 1`` samples are retained."""
        pts = self.points()
        if window < 1 or len(pts) < window + 1:
            return None
        return pts[-1][1] - pts[-1 - window][1]

    @property
    def total(self) -> int:
        return self._total

    @property
    def dropped(self) -> int:
        return max(0, self._total - self.capacity)

    def __len__(self) -> int:
        return len(self._ring)


class P2Quantile:
    """One streaming quantile via the P² algorithm — five markers, no
    sample buffer.  Exact until five observations, then a piecewise-
    parabolic estimate whose error vanishes as the stream grows."""

    __slots__ = ("p", "_q", "_n", "_np", "_dn", "count")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = float(p)
        self._q: list[float] = []            # marker heights
        self._n = [0, 1, 2, 3, 4]            # marker positions (0-based)
        self._np = [0.0, 2 * p, 4 * p, 2 + 2 * p, 4.0]   # desired positions
        self._dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]     # desired increments
        self.count = 0

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if len(self._q) < 5:
            self._q.append(x)
            self._q.sort()
            return
        q, n = self._q, self._n
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if q[i] <= x < q[i + 1])
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1 and n[i + 1] - n[i] > 1) or \
               (d <= -1 and n[i - 1] - n[i] < -1):
                s = 1 if d > 0 else -1
                qi = self._parabolic(i, s)
                if not q[i - 1] < qi < q[i + 1]:
                    qi = self._linear(i, s)
                q[i] = qi
                n[i] += s

    def _parabolic(self, i: int, s: int) -> float:
        q, n = self._q, self._n
        return q[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, s: int) -> float:
        q, n = self._q, self._n
        return q[i] + s * (q[i + s] - q[i]) / (n[i + s] - n[i])

    def value(self) -> float | None:
        """Current estimate (exact order statistic below 5 samples)."""
        if not self._q:
            return None
        if self.count < 5:
            srt = sorted(self._q)
            idx = self.p * (len(srt) - 1)
            lo = int(math.floor(idx))
            hi = min(lo + 1, len(srt) - 1)
            return srt[lo] + (srt[hi] - srt[lo]) * (idx - lo)
        return self._q[2]


class StreamingHistogram:
    """Count/sum/min/max plus P² estimates at fixed quantiles — a
    Prometheus-summary-shaped aggregate in constant memory."""

    def __init__(self, quantiles: tuple[float, ...] = (0.5, 0.9, 0.99)):
        self.quantiles = tuple(quantiles)
        self._est = {p: P2Quantile(p) for p in self.quantiles}
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        for est in self._est.values():
            est.observe(x)

    def quantile(self, p: float) -> float | None:
        return self._est[p].value()

    def summary(self) -> dict:
        out = {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count if self.count else 0.0,
            "min": self.min,
            "max": self.max,
        }
        for p in self.quantiles:
            out[f"p{int(p * 100)}"] = self._est[p].value()
        return out


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def prom_name(name: str) -> str:
    """``source.metric`` → a legal Prometheus metric name."""
    name = _PROM_BAD.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return f"repro_{name}"


class MetricsSampler:
    """Periodic snapshots of a registry, fanned into bounded series.

    Args:
      registry: the :class:`~repro_torch.obs.registry.MetricsRegistry` to
        sample (default: the process-wide one, resolved lazily at each
        sample so tests can swap it).
      capacity: ring size of every per-metric :class:`TimeSeries`.
      interval_s: minimum seconds between :meth:`maybe_sample` samples
        (0 = every call samples).
      clock: injectable seconds clock (default ``time.monotonic``).
      hist_metrics: series names (``"source.metric"``) additionally fed
        into a :class:`StreamingHistogram` each sample — gauges whose
        distribution matters (occupancy, pool pressure), not counters.
      jsonl_path: when set, every sample appends one flat JSON line
        (``{"t": ..., "source.metric": value, ...}``) — the durable
        record a fleet collector tails.
    """

    def __init__(self, registry=None, *, capacity: int = 512,
                 interval_s: float = 0.0, clock=time.monotonic,
                 hist_metrics: tuple[str, ...] = (),
                 jsonl_path: str | None = None):
        self._registry = registry
        self.capacity = int(capacity)
        self.interval_s = float(interval_s)
        self.clock = clock
        self.jsonl_path = jsonl_path
        self.series: dict[str, TimeSeries] = {}
        self.histograms: dict[str, StreamingHistogram] = {
            name: StreamingHistogram() for name in hist_metrics
        }
        self.samples = 0
        self._last_t: float | None = None

    @property
    def registry(self):
        if self._registry is not None:
            return self._registry
        from repro_torch.obs.registry import get_registry

        return get_registry()

    # -------------------------------------------------------------- sampling
    def maybe_sample(self) -> bool:
        """Sample iff ``interval_s`` has elapsed since the last sample."""
        now = self.clock()
        if self._last_t is not None and now - self._last_t < self.interval_s:
            return False
        self.sample(now)
        return True

    def sample(self, now: float | None = None) -> dict:
        """Take one snapshot now; returns the flat ``{series: value}``
        dict that was recorded (and appended to the JSONL, if any)."""
        t = self.clock() if now is None else now
        self._last_t = t
        flat: dict[str, float] = {}
        snap = self.registry.snapshot()
        for source, metrics in snap.items():
            if not isinstance(metrics, dict):
                continue
            for k, v in metrics.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                name = f"{source}.{k}"
                flat[name] = v
                ser = self.series.get(name)
                if ser is None:
                    ser = self.series[name] = TimeSeries(self.capacity)
                ser.append(t, float(v))
                hist = self.histograms.get(name)
                if hist is not None:
                    hist.observe(v)
        self.samples += 1
        if self.jsonl_path:
            with open(self.jsonl_path, "a", encoding="utf-8") as f:
                f.write(json.dumps({"t": t, **flat}, sort_keys=True) + "\n")
        return flat

    # ------------------------------------------------------------ inspection
    def get(self, name: str) -> TimeSeries | None:
        return self.series.get(name)

    def latest(self) -> dict[str, float]:
        """Most recent value of every series."""
        out = {}
        for name, ser in self.series.items():
            v = ser.latest()
            if v is not None:
                out[name] = v
        return out

    def stats(self) -> dict:
        """Registry-source-shaped self-description (``timeseries``)."""
        return {
            "samples": self.samples,
            "series": len(self.series),
            "series_capacity": self.capacity,
            "histograms": len(self.histograms),
        }

    # ------------------------------------------------------------ exposition
    def prometheus_text(self) -> str:
        """The latest sample in Prometheus text exposition format."""
        lines: list[str] = []
        for name in sorted(self.series):
            v = self.series[name].latest()
            if v is None:
                continue
            pn = prom_name(name)
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {_fmt(v)}")
        for name in sorted(self.histograms):
            hist = self.histograms[name]
            if hist.count == 0:
                continue
            pn = prom_name(name) + "_summary"
            lines.append(f"# TYPE {pn} summary")
            for p in hist.quantiles:
                q = hist.quantile(p)
                if q is not None:
                    lines.append(f'{pn}{{quantile="{p:g}"}} {_fmt(q)}')
            lines.append(f"{pn}_sum {_fmt(hist.sum)}")
            lines.append(f"{pn}_count {hist.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: str) -> None:
        """Write :meth:`prometheus_text` to ``path`` (textfile-collector
        style: whole-file replace per scrape)."""
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.prometheus_text())


def _fmt(v: float) -> str:
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return repr(float(v))
