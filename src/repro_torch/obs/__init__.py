"""Process-wide observability for the PyTorch port: spans, roofline
attribution, export, metrics, health.

The layer every other layer reports into (and nothing imports *from*
the rest of the stack at module scope, so any layer may import it):

* :mod:`repro_torch.obs.trace` — low-overhead span tracer (ring buffer,
  injectable clock, one-branch no-op when disabled; device time of
  ``contract`` spans on the card from CUDA events);
* :mod:`repro_torch.obs.roofline` — per-contraction flops/bytes/intensity
  and the card's roofline bound (its ceilings, per card and type, live
  here);
* :mod:`repro_torch.obs.export` — Chrome Trace Event JSON (Perfetto) and
  flat JSONL records, plus schema validation
  (``python -m repro_torch.obs.export --validate trace.json``);
* :mod:`repro_torch.obs.registry` — the MetricsRegistry behind one
  snapshot API;
* :mod:`repro_torch.obs.timeseries` — bounded time series over registry
  snapshots (P² streaming quantiles, Prometheus text, JSONL);
* :mod:`repro_torch.obs.health` — SLO watchdogs and the sampled NaN/Inf
  probe, emitting typed alerts through the tracer.
"""

from repro_torch.obs.health import (
    Alert,
    HealthMonitor,
    NumericsProbe,
    Watchdog,
    default_watchdogs,
)
from repro_torch.obs.registry import MetricsRegistry, get_registry, set_registry
from repro_torch.obs.timeseries import (
    MetricsSampler,
    P2Quantile,
    StreamingHistogram,
    TimeSeries,
)
from repro_torch.obs.trace import (
    NULL_SPAN,
    Span,
    Tracer,
    disable_tracing,
    enable_tracing,
    enabled,
    get_tracer,
    instant,
    set_tracer,
    span,
)

__all__ = [
    "Tracer", "Span", "NULL_SPAN",
    "enabled", "enable_tracing", "disable_tracing",
    "get_tracer", "set_tracer", "span", "instant",
    "MetricsRegistry", "get_registry", "set_registry",
    "TimeSeries", "P2Quantile", "StreamingHistogram", "MetricsSampler",
    "Alert", "Watchdog", "HealthMonitor", "NumericsProbe",
    "default_watchdogs",
]
