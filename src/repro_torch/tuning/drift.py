"""Tuning-drift detection: notice when cached winners stop being true.

A :class:`~repro_torch.tuning.cache.TuningCache` entry is a measurement of
*this machine at tune time*.  Machines drift — thermal throttling, BIOS
updates, a neighbor stealing memory bandwidth, a library upgrade
changing its kernels — and a drifted entry silently serves a stale winner while the
cost model keeps training on timings the hardware can no longer
reproduce.  This module closes the loop: compare what contractions
*actually cost* during serving (traced ``contract`` spans) against what
the cache *says* they cost, and when an entry has drifted, evict it
(forcing re-measurement on next use) and refit the cost model.

The comparison is deliberately *relative*, not absolute.  A live span's
time is its device time where it has one (``device_us``: a ``contract``
span on the card), else its host duration, which includes Python
dispatch and, for a CUDA launch, measures the enqueue; either sits a
systematic factor above the cache's carefully interleaved candidate
timings.  The detector therefore computes a per-key ratio
``live_us / cached_us`` and normalizes by the **median ratio across
keys**: the systematic factor cancels, and a key whose normalized score
exceeds ``ratio`` stands out against its peers on the same machine in
the same process.  With fewer than ``min_keys`` observed keys there is
no peer group, and the raw ratio is used as an absolute fallback.

Remediation is three-stage, each stage optional:

1. **evict** — :meth:`TuningCache.drop` removes the drifted entry and
   bumps the cache fingerprint;
2. **re-measure** — drifted keys are re-tuned immediately on synthetic
   operands (``remeasure=True``), exactly like
   :meth:`Dispatcher.pretune`; keys whose recorded platform differs
   from the process's default platform are evicted but never
   re-measured here;
3. **retrain** — when the drifted fraction crosses ``retrain_gate``
   the cost model is refit over the cleaned cache by calling
   :meth:`Dispatcher.model` (``model_for`` memoizes by fingerprint, so
   the eviction-bumped fingerprint makes this a real refit, trained
   without the poisoned entries).

Every verdict is observable: drifted keys emit ``tuning_drift`` tracer
instants and a retrain emits ``tuning_retrain`` (cat ``tuning``), so
drift shows up in the same Perfetto timeline as the serving spans that
exposed it.

Demo::

    det = DriftDetector(dispatcher)
    report = det.run(tracer.events())   # analyze + remediate
    print(report.summary())

A port of the JAX package's ``repro/tuning/drift.py``: the analysis is
the same; live times prefer device time, and re-measurement synthesizes
torch operands on the key's platform.
"""

from __future__ import annotations

import dataclasses
import statistics

from repro_torch.obs import trace as _trace
from repro_torch.tuning.dispatch import Dispatcher

__all__ = ["DriftDetector", "DriftReport", "KeyDrift"]


@dataclasses.dataclass(frozen=True)
class KeyDrift:
    """One cache key's live-vs-cached verdict."""

    key: str               # canonical cache key
    live_us: float         # median traced time of contract spans
    cached_us: float       # the entry's recorded best µs
    ratio: float           # live_us / cached_us (raw)
    score: float           # ratio / median-ratio baseline (what is judged)
    samples: int           # live spans behind the median
    predicted: bool        # entry was a model guess, not a measurement
    drifted: bool


@dataclasses.dataclass
class DriftReport:
    """Outcome of one :meth:`DriftDetector.analyze` / ``run`` pass."""

    keys: dict[str, KeyDrift]            # every scored key
    baseline_ratio: float                # median live/cached ratio (1.0 if absolute)
    normalized: bool                     # peer-group normalization applied?
    drifted: list[str] = dataclasses.field(default_factory=list)
    evicted: list[str] = dataclasses.field(default_factory=list)
    remeasured: list[str] = dataclasses.field(default_factory=list)
    retrained: bool = False

    @property
    def drifted_frac(self) -> float:
        return len(self.drifted) / len(self.keys) if self.keys else 0.0

    def summary(self) -> dict:
        """Flat dict for logs / JSON / the registry."""
        return {
            "keys_observed": len(self.keys),
            "drifted": len(self.drifted),
            "drifted_frac": round(self.drifted_frac, 4),
            "baseline_ratio": round(self.baseline_ratio, 4),
            "normalized": self.normalized,
            "evicted": len(self.evicted),
            "remeasured": len(self.remeasured),
            "retrained": self.retrained,
        }


class DriftDetector:
    """Scores live contract spans against the dispatcher's cache.

    Args:
      dispatcher: the :class:`Dispatcher` whose cache (and cost model)
        to check and remediate.
      ratio: a key drifts when its normalized score exceeds ``ratio``
        (live much slower than cached — a stale winner being served).
      flag_fast: also flag scores below ``1/ratio`` (live much *faster*
        than cached — the entry overprices, e.g. after a hardware
        upgrade).  Off by default: per-key dispatch overhead varies
        with problem size, so small contractions legitimately sit far
        below the cross-key baseline and the fast side false-positives.
      min_samples: live spans required per key before it is scored
        (medians over fewer are noise).
      min_keys: scored keys required before peer-group normalization is
        trusted; below it raw ratios are judged absolutely.
      retrain_gate: drifted fraction at which remediation refits the
        cost model (a couple of bad keys → evict quietly; a broad shift
        → the training set itself is suspect).
    """

    def __init__(self, dispatcher: Dispatcher, *, ratio: float = 3.0,
                 flag_fast: bool = False, min_samples: int = 3,
                 min_keys: int = 3, retrain_gate: float = 0.25):
        if ratio <= 1.0:
            raise ValueError(f"ratio must be > 1, got {ratio}")
        self.dispatcher = dispatcher
        self.ratio = float(ratio)
        self.flag_fast = bool(flag_fast)
        self.min_samples = int(min_samples)
        self.min_keys = int(min_keys)
        self.retrain_gate = float(retrain_gate)
        self.last_report: DriftReport | None = None

    # ---------------------------------------------------------------- observe
    def observe(self, events) -> dict[str, list[float]]:
        """Collect live µs per canonical cache key from trace events.

        A ``contract`` span counts with its device time (``device_us``)
        where it has one, else its host duration.  Spans must carry
        ``spec``/``dims``/``dtype`` (the roofline annotation), which
        ``contract`` attaches whenever tracing is on.
        """
        from repro_torch.tuning.cache import canonical_key

        live: dict[str, list[float]] = {}
        for ev in events:
            if ev.get("ph") != "X" or ev.get("name") != "contract":
                continue
            args = ev.get("args") or {}
            spec, dims, dtype = (
                args.get("spec"), args.get("dims"), args.get("dtype"))
            if not spec or not dims or not dtype:
                continue
            try:
                key = canonical_key(spec, dims, dtype)
            except (KeyError, ValueError, TypeError):
                continue
            live.setdefault(key, []).append(
                float(args.get("device_us", ev.get("dur", 0.0))))
        return live

    # ---------------------------------------------------------------- analyze
    def analyze(self, events) -> DriftReport:
        """Score every observed key with a cache entry; no mutation."""
        live = self.observe(events)
        cache = self.dispatcher.cache

        raw: dict[str, tuple[float, float, int, bool]] = {}
        for key, samples in live.items():
            if len(samples) < self.min_samples:
                continue
            entry = cache.get(key)
            if entry is None:
                continue  # no expectation to drift from
            try:
                cached_us = float(entry["results"][entry["best"]])
            except (KeyError, TypeError, ValueError):
                continue  # dangling entry; dispatch warns separately
            if cached_us <= 0:
                continue
            raw[key] = (
                statistics.median(samples), cached_us, len(samples),
                bool(entry.get("predicted")),
            )

        ratios = {k: v[0] / v[1] for k, v in raw.items()}
        normalized = len(ratios) >= self.min_keys
        baseline = statistics.median(ratios.values()) if normalized else 1.0
        if baseline <= 0:
            baseline, normalized = 1.0, False

        keys: dict[str, KeyDrift] = {}
        drifted: list[str] = []
        for key, (live_us, cached_us, n, predicted) in raw.items():
            score = ratios[key] / baseline
            is_drift = score > self.ratio or (
                self.flag_fast and score < 1.0 / self.ratio)
            keys[key] = KeyDrift(
                key=key, live_us=live_us, cached_us=cached_us,
                ratio=ratios[key], score=score, samples=n,
                predicted=predicted, drifted=is_drift,
            )
            if is_drift:
                drifted.append(key)

        report = DriftReport(
            keys=keys, baseline_ratio=baseline, normalized=normalized,
            drifted=sorted(drifted),
        )
        self.last_report = report
        return report

    # -------------------------------------------------------------- remediate
    def remediate(self, report: DriftReport, *, remeasure: bool = True
                  ) -> DriftReport:
        """Evict drifted entries, optionally re-measure, retrain on gate."""
        from repro_torch.tuning.cache import default_platform

        cache = self.dispatcher.cache
        # Grab the (memoized) pre-remediation model up front so the
        # retrained-or-not verdict compares object identity honestly.
        prev_model = self.dispatcher.model() if report.drifted else None

        for key in report.drifted:
            kd = report.keys[key]
            if cache.drop(key):
                report.evicted.append(key)
            if _trace.enabled():
                _trace.instant(
                    "tuning_drift", "tuning", key=key,
                    live_us=kd.live_us, cached_us=kd.cached_us,
                    score=round(kd.score, 3), samples=kd.samples,
                    predicted=kd.predicted,
                )
            if not remeasure:
                continue
            parsed = _parse_for_remeasure(key)
            if parsed is None:
                continue
            cs, dims, dtype_name, platform = parsed
            if platform != default_platform():
                continue  # foreign-platform entry: evicted, never retimed here
            A, B = _synthesize(cs, dims, dtype_name, seed=len(report.remeasured))
            self.dispatcher.tune(cs, A, B)
            report.remeasured.append(key)

        if report.drifted and report.drifted_frac >= self.retrain_gate:
            new_model = self.dispatcher.model()  # fingerprint changed → refit
            report.retrained = new_model is not prev_model
            if _trace.enabled():
                _trace.instant(
                    "tuning_retrain", "tuning",
                    drifted_frac=round(report.drifted_frac, 4),
                    evicted=len(report.evicted),
                    remeasured=len(report.remeasured),
                    retrained=report.retrained,
                )
        return report

    def run(self, events, *, remeasure: bool = True) -> DriftReport:
        """``analyze`` + ``remediate`` in one call."""
        return self.remediate(self.analyze(events), remeasure=remeasure)

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        """Registry-source view of the latest report (empty pre-first-run)."""
        return dict(self.last_report.summary()) if self.last_report else {}


def _parse_for_remeasure(key: str):
    """Canonical key → ``(cs, dims, dtype_name, platform)`` or ``None``."""
    from repro_torch.tuning.model import parse_cache_key

    return parse_cache_key(key)


def _synthesize(cs, dims, dtype_name, *, seed: int = 0):
    """Deterministic synthetic operands for a re-measurement sweep, on the
    default platform's device (the current card, else the CPU)."""
    import numpy as np
    import torch

    from repro_torch.tuning.cache import default_device
    from repro_torch.tuning.dispatch import _synthesize as synthesize

    return synthesize(cs, dims, getattr(torch, dtype_name),
                      np.random.default_rng(seed), default_device())
