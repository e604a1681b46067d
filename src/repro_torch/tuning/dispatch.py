"""Empirical dispatch: pick a contraction's execution mode by measurement.

``tuned_contract(spec, A, B)`` (or ``contract(..., strategy="tuned")``)
routes a pairwise contraction through a :class:`Dispatcher`:

1. look up the canonical key (spec-shape class, dims, dtype, and the
   platform of the operands' device) in the persistent
   :class:`~repro_torch.tuning.cache.TuningCache`;
2. on a **hit**, execute the recorded winner — no measurement, ever;
3. on a **miss**, behavior follows the :data:`TuningPolicy`:

   * ``"measure"`` (default) — enumerate legal candidates
     (:mod:`repro_torch.tuning.candidates`), time each
     (:mod:`repro_torch.tuning.measure`), persist the results, run the
     winner;
   * ``"predict"`` — ask the learned cost model
     (:mod:`repro_torch.tuning.model`, fitted on this cache's accumulated
     measurements) to pick the winner; when its confidence clears
     ``self.confidence`` the pick executes immediately — **zero
     measurement stall** — and is persisted as an entry flagged
     ``"predicted"`` (distinct from measured entries: the model never
     trains on it, and a later ``tune()`` re-measures from scratch);
     below the threshold, fall back to measurement;
   * ``"cached"`` — no measurement; fall back to the analytic
     ``strategy="auto"`` plan (warm caches only, e.g. CI);
   * ``"off"`` — always the analytic plan (a kill switch).

PyTorch runs eagerly, so every operand is concrete and a miss under
``"measure"`` can always be timed (the JAX package degrades to the
analytic plan under a ``jit`` trace).  Counters (``hits`` / ``misses`` /
``measurements`` / ``predictions``) are exposed on the dispatcher so
callers can assert "a warm cache performs zero new measurements".

Demo (on the card; ``--device cpu`` for the CPU)::

    PYTHONPATH=src python -m repro_torch.tuning.dispatch --demo
"""

from __future__ import annotations

import argparse
import os
import warnings
from typing import Iterable, Literal

import numpy as np
import torch

from repro_torch.core.notation import ContractionSpec, parse_spec
from repro_torch.obs import trace as _trace
from repro_torch.tuning.cache import (
    TuningCache, canonical_key, default_device, default_platform, platform_of)
from repro_torch.tuning.candidates import Candidate, enumerate_candidates
from repro_torch.tuning.federate import pick_best
from repro_torch.tuning.measure import measure_candidates

__all__ = [
    "TuningPolicy",
    "Dispatcher",
    "tuned_contract",
    "get_dispatcher",
    "set_dispatcher",
    "default_cache_path",
    "path_cost",
    "ANALYTIC_FLOPS_PER_US",
]

TuningPolicy = Literal["off", "cached", "measure", "predict"]

#: flops→µs bridge (10 GFLOP/s) that prices an unmeasured path step on the
#: CPU, which has no roofline ceilings (:func:`path_cost`)
ANALYTIC_FLOPS_PER_US = 1.0e4

#: cache keys whose entry turned out structurally dangling (``best`` not
#: in ``results``, or a candidate of the JAX package): each is warned
#: about once per process, then silently treated as a miss.
_WARNED_DANGLING: set[str] = set()


def default_cache_path() -> str:
    """``$REPRO_TUNING_CACHE``, else ``~/.cache/repro/tuning.json`` (the
    JAX package's file: the platform component keeps the two packages'
    entries apart)."""
    env = os.environ.get("REPRO_TUNING_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro", "tuning.json")


def _dtype_of(A, B):
    return torch.promote_types(A.dtype, B.dtype)


def _dims(cs, A, B) -> dict:
    from repro_torch.core.contract import infer_dims  # deferred: contract imports us

    return infer_dims(cs, A, B)


class Dispatcher:
    """Cache-backed empirical dispatcher for pairwise contractions.

    Args:
      cache: a :class:`TuningCache`, a path for one, or ``None`` for an
        in-memory cache.
      policy: ``"measure"`` | ``"predict"`` | ``"cached"`` | ``"off"``
        (see module doc).
      backends: backends candidates may use; default
        :func:`~repro_torch.tuning.candidates.default_backends` (both on a
        card, ``torch`` alone on the CPU, where the kernel backend is the
        kernel's plain version).
      iters/warmup: measurement repeats per candidate.
      confidence: minimum cost-model confidence for a ``"predict"``
        dispatch; below it the policy degrades to measurement.
      audit_transposes: count each measured candidate's copies
        (:func:`repro_torch.core.contract.count_copy_ops`) and store the
        counts in the cache entry's ``transposes`` — a Fig. 1-style
        regression signal and a cost-model feature.
    """

    def __init__(
        self,
        cache: TuningCache | str | os.PathLike | None = None,
        *,
        policy: TuningPolicy = "measure",
        backends: tuple[str, ...] | None = None,
        iters: int = 5,
        warmup: int = 2,
        confidence: float | None = None,
        audit_transposes: bool = False,
    ):
        from repro_torch.tuning.model import CONFIDENCE_THRESHOLD

        if not isinstance(cache, TuningCache):
            cache = TuningCache(cache)
        self.cache = cache
        self.policy = policy
        self.backends = backends
        self.iters = iters
        self.warmup = warmup
        self.confidence = (
            CONFIDENCE_THRESHOLD if confidence is None else float(confidence)
        )
        self.audit_transposes = audit_transposes
        self.hits = 0
        self.misses = 0
        self.measurements = 0   # individual candidate timings performed
        self.predictions = 0    # cold keys dispatched by the cost model

    # ---------------------------------------------------------------- lookup
    def lookup(self, spec, dims, dtype, platform: str | None = None
               ) -> tuple[Candidate, float] | None:
        """Cached (winning candidate, median µs) or ``None`` — no counters.
        ``platform`` defaults to :func:`~repro_torch.tuning.cache.default_platform`.

        Hardened against dangling entries whose ``best`` key is missing
        from ``results`` or no candidate of the port (possible after
        cross-machine merges or hand-edited caches): those are treated as
        a miss with a once-per-key warning, never a ``KeyError`` on the
        serve path.
        """
        key = canonical_key(spec, dims, dtype, platform)
        entry = self.cache.get(key)
        if entry is None:
            return None
        try:
            best = entry["best"]
            us = float(entry["results"][best])
            return Candidate.from_key(best), us
        except (KeyError, TypeError, ValueError):
            if key not in _WARNED_DANGLING:
                _WARNED_DANGLING.add(key)
                warnings.warn(
                    f"tuning cache entry for {key!r} is dangling "
                    f"(best={entry.get('best')!r} not usable); treating as "
                    f"a miss"
                )
            return None

    def step_us(self, spec, dims, dtype, platform: str | None = None
                ) -> float | None:
        """Measured best µs for one contraction, for path re-ranking."""
        hit = self.lookup(spec, dims, dtype, platform)
        return hit[1] if hit else None

    #: ties break toward the analytic plan: a challenger must beat
    #: ``strategy="auto"`` by more than this factor to dethrone it.  With
    #: measurement noise, a hair-thin "win" is as likely to be a loss —
    #: and auto is the choice the rest of the stack reasons about.
    TIE_MARGIN = 0.85

    # ------------------------------------------------------------------ tune
    def tune(self, spec, A, B) -> dict:
        """Measure every not-yet-measured legal candidate on ``A``, ``B``
        and persist.

        Incremental across schema growth: when the cache already holds an
        entry for this key (e.g. written before a new strategy existed),
        its per-candidate timings are kept and only the *new* candidate
        keys are timed — then the winner is re-picked over the merged
        results.  Candidates are timed with interleaved sampling
        (:func:`~repro_torch.tuning.measure.measure_candidates`) so machine
        drift cannot bias the winner.  A candidate that raises makes this
        raise: no other candidate wins in its place.  Counts one
        measurement per newly timed candidate.  Returns the stored entry.

        A prior entry flagged ``"predicted"`` is *discarded*, not
        merged — its µs are model guesses, and keeping them verbatim
        would launder a prediction into the training set.
        """
        cs = parse_spec(spec) if isinstance(spec, str) else spec
        dims = _dims(cs, A, B)
        dtype = _dtype_of(A, B)
        key = canonical_key(cs, dims, dtype, platform_of(A.device))
        with _trace.span("tune", "tuning") as sp:
            cands = enumerate_candidates(cs, dims, backends=self.backends)
            prior = self.cache.get(key)
            if prior is not None and prior.get("predicted"):
                prior = None
            results = dict(prior["results"]) if prior else {}
            transposes = dict(prior.get("transposes") or {}) if prior else {}
            todo = [c for c in cands if c.key() not in results]
            measured = (
                measure_candidates(
                    todo, cs, A, B, iters=self.iters, warmup=self.warmup,
                    audit_transposes=self.audit_transposes)
                if todo
                else {}
            )
            self.measurements += len(measured)
            results.update({k: m.us for k, m in measured.items()})
            transposes.update({
                k: m.transposes for k, m in measured.items()
                if m.transposes is not None
            })
            best = pick_best(results, tie_margin=self.TIE_MARGIN)
            entry = {"best": best, "results": results}
            if transposes:
                entry["transposes"] = transposes
            self.cache.put(key, entry)
            if sp:
                sp.set(spec=cs.spec_str(), n_candidates=len(cands),
                       n_measured=len(measured), winner=best,
                       best_us=float(results[best]))
            return entry

    # --------------------------------------------------------------- predict
    def model(self):
        """The cost model over this cache — lazily refit on cache change
        (:func:`repro_torch.tuning.model.model_for` memoizes by
        fingerprint)."""
        from repro_torch.tuning.model import model_for

        return model_for(self.cache)

    def predict(self, spec, dims: dict, dtype):
        """Cost-model verdict for one contraction (``None`` when no
        candidate family has enough training data)."""
        cs = parse_spec(spec) if isinstance(spec, str) else spec
        return self.model().predict(cs, dims, dtype, backends=self.backends)

    def _record_prediction(self, key: str, pred) -> None:
        """Persist a model pick, flagged distinctly from measured entries."""
        self.cache.put(key, {
            "best": pred.candidate.key(),
            "results": {k: float(v) for k, v in pred.per_candidate.items()},
            "predicted": True,
            "confidence": round(float(pred.confidence), 4),
        })

    def _try_predict(self, cs, dims, dtype, device):
        """The ``"predict"`` miss path: a confident model pick, recorded
        and traced, or ``None`` (caller falls back to measurement)."""
        pred = self.predict(cs, dims, dtype)
        if pred is None or pred.confidence < self.confidence:
            return None
        self.predictions += 1
        self._record_prediction(
            canonical_key(cs, dims, dtype, platform_of(device)), pred)
        if _trace.enabled():
            from repro_torch.obs.roofline import contraction_record

            rec = contraction_record(cs, dims, dtype, device)
            bound = rec.get("roofline_bound_us")
            _trace.instant(
                "tuning_predict", "tuning", spec=cs.spec_str(),
                winner=pred.candidate.key(), predicted_us=float(pred.us),
                confidence=float(pred.confidence),
                **({} if bound is None else {
                    "roofline_bound_us": bound,
                    "predicted_roofline_fraction": (
                        bound / pred.us if pred.us > 0 else 0.0)}),
            )
        return pred.candidate

    # -------------------------------------------------------------- contract
    def contract(
        self,
        spec: str | ContractionSpec,
        A,
        B,
        *,
        out_dtype=None,
    ):
        """Execute one contraction under the tuning policy (see module doc)."""
        from repro_torch.core.contract import contract

        cs = parse_spec(spec) if isinstance(spec, str) else spec
        if self.policy == "off":
            return contract(cs, A, B, strategy="auto", out_dtype=out_dtype)
        dims = _dims(cs, A, B)
        dtype = _dtype_of(A, B)

        hit = self.lookup(cs, dims, dtype, platform_of(A.device))
        if hit is None:
            self.misses += 1
            if _trace.enabled():
                _trace.instant("tuning_miss", "tuning", spec=cs.spec_str(),
                               policy=self.policy)
            cand = None
            if self.policy == "predict":
                cand = self._try_predict(cs, dims, dtype, A.device)
            if cand is None:
                if self.policy not in ("measure", "predict"):
                    return contract(cs, A, B, strategy="auto", out_dtype=out_dtype)
                entry = self.tune(cs, A, B)
                cand = Candidate.from_key(entry["best"])
        else:
            self.hits += 1
            cand, measured_us = hit
            if _trace.enabled():
                from repro_torch.obs.roofline import contraction_record

                rec = contraction_record(cs, dims, dtype, A.device)
                bound = rec.get("roofline_bound_us")
                _trace.instant(
                    "tuning_hit", "tuning", spec=cs.spec_str(),
                    winner=cand.key(), measured_us=measured_us,
                    flops=rec["flops"], bytes=rec["bytes"],
                    intensity=rec["intensity"],
                    **({} if bound is None else {"roofline_fraction": (
                        bound / measured_us if measured_us > 0 else 0.0)}),
                )
        return contract(
            cs, A, B,
            strategy=cand.strategy, backend=cand.backend,
            tiles=cand.tiles_dict or None, out_dtype=out_dtype,
        )

    # --------------------------------------------------------------- pretune
    def pretune(self, records: Iterable[tuple], *, seed: int = 0,
                device="cuda") -> dict:
        """Warm the cache for a contraction working set before serving.

        ``records`` are ``(spec_str, dims, dtype_str)`` tuples, e.g. from
        :func:`repro_torch.core.contract.record_contractions` around a
        model run.  Deduplicates by canonical key, skips existing entries,
        and measures the rest on synthetic operands made from ``seed`` on
        ``device`` (default the card; raises without one unless
        ``device="cpu"``).  Returns summary stats.

        Under the ``"predict"`` policy the warm-up is **predict-first**:
        each missing key is offered to the cost model, and only the keys
        it is *not* confident about are measured.
        """
        from repro_torch.interop import resolve_device

        dev = resolve_device(device)
        platform = platform_of(dev)
        rng = np.random.default_rng(seed)
        stats = {"unique": 0, "cached": 0, "tuned": 0, "predicted": 0,
                 "skipped": 0}
        seen: set[str] = set()
        with _trace.span("pretune", "tuning") as sp:
            for spec_str, dims, dtype_str in records:
                cs = parse_spec(spec_str)
                dtype = getattr(torch, str(dtype_str).removeprefix("torch."))
                key = canonical_key(cs, dims, dtype, platform)
                if key in seen:
                    continue
                seen.add(key)
                stats["unique"] += 1
                if key in self.cache:
                    stats["cached"] += 1
                    continue
                if self.policy == "predict":
                    if self._try_predict(cs, dims, dtype, dev) is not None:
                        stats["predicted"] += 1
                        continue
                elif self.policy != "measure":
                    stats["skipped"] += 1
                    continue
                A, B = _synthesize(cs, dims, dtype, rng, dev)
                self.tune(cs, A, B)
                stats["tuned"] += 1
            if sp:
                sp.set(**stats)
        return stats

    # ----------------------------------------------------------------- stats
    @property
    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "measurements": self.measurements,
            "predictions": self.predictions,
            "entries": len(self.cache),
            "policy": self.policy,
        }

    def reset_counters(self) -> None:
        """Zero the hit/miss/measurement counters (cache untouched)."""
        self.hits = 0
        self.misses = 0
        self.measurements = 0
        self.predictions = 0


def _synthesize(cs, dims, dtype, rng, device):
    """Standard-normal operands for ``cs`` at ``dims`` from numpy's
    ``rng``, in ``dtype`` on ``device``."""
    return tuple(
        torch.from_numpy(rng.standard_normal([dims[m] for m in modes]))
        .to(device=device, dtype=dtype)
        for modes in (cs.a_modes, cs.b_modes))


# -------------------------------------------------------------- path pricing
def path_cost(steps, dims: dict, dtype, dispatcher: "Dispatcher | None" = None
              ) -> tuple[float, int]:
    """Measured-cost price of a contraction path: ``(total µs, -n_measured)``.

    ``steps`` may be :class:`~repro_torch.core.einsum.PathStep` or
    :class:`~repro_torch.core.program.ContractionStep` objects — anything
    with a pairwise ``spec``.  Entries are looked up under the default
    platform (:func:`~repro_torch.tuning.cache.default_platform`).  Steps
    with a cache entry cost their recorded best µs (measured *or*
    model-predicted).  Cold steps under a ``"predict"`` dispatcher are
    priced by the cost model when it is confident; the final fallback is
    the step's roofline bound on the card
    (:func:`repro_torch.obs.roofline.roofline_bound_us`), or, on the CPU,
    which has no ceilings, its flops at :data:`ANALYTIC_FLOPS_PER_US`.
    The second component prefers the path with more cache-backed
    (trusted) steps on µs ties.  This is the objective behind
    ``optimize="tuned"`` — both the eager re-rank and the compiled-program
    pass (:class:`repro_torch.core.passes.TunedRerankPass`).
    """
    from repro_torch.obs.roofline import contraction_record

    disp = dispatcher or get_dispatcher()
    platform, device = default_platform(), default_device()
    total, trusted = 0.0, 0
    for s in steps:
        cs = s.spec if isinstance(s.spec, ContractionSpec) else parse_spec(s.spec)
        us = None
        if cs.c_modes and cs.a_modes and cs.b_modes:
            us = disp.step_us(cs, dims, dtype, platform)
        if us is not None:
            total += us
            trusted += 1
            continue
        if disp.policy == "predict":
            pred = disp.predict(cs, dims, dtype)
            if pred is not None and pred.confidence >= disp.confidence:
                total += pred.us
                continue
        rec = contraction_record(cs, dims, dtype, device)
        total += rec.get("roofline_bound_us", rec["flops"] / ANALYTIC_FLOPS_PER_US)
    return (total, -trusted)


# ------------------------------------------------------------------ default
_DEFAULT: Dispatcher | None = None


def get_dispatcher() -> Dispatcher:
    """The process-wide dispatcher behind ``strategy="tuned"``.

    Created lazily against :func:`default_cache_path`; replace it with
    :func:`set_dispatcher` (tests and the serving warm-up do).
    """
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Dispatcher(default_cache_path())
    return _DEFAULT


def set_dispatcher(dispatcher: Dispatcher | None) -> None:
    """Install (or clear, with ``None``) the process-wide dispatcher."""
    global _DEFAULT
    _DEFAULT = dispatcher


def tuned_contract(
    spec: str | ContractionSpec,
    A,
    B,
    *,
    dispatcher: Dispatcher | None = None,
    out_dtype=None,
):
    """Module-level convenience: dispatch through ``dispatcher`` (default:
    the process-wide one)."""
    d = dispatcher or get_dispatcher()
    return d.contract(spec, A, B, out_dtype=out_dtype)


# ---------------------------------------------------------------------- demo
def _demo(cache_path: str, size: int, device) -> None:
    from repro_torch.core.table2 import CASES
    from repro_torch.interop import resolve_device

    dev = resolve_device(device)
    disp = Dispatcher(cache_path, iters=5, warmup=2)
    dims = {m: size for m in "mnpk"}
    rng = np.random.default_rng(0)
    labels = ("1.1", "1.3", "2.4", "3.4")
    print(f"# tuning cache: {cache_path}  (platform={platform_of(dev)})")
    for label in labels:
        rm = CASES[label].row_major()
        cs = parse_spec(rm)
        A, B = _synthesize(cs, dims, torch.float32, rng, dev)
        disp.contract(cs, A, B)
        cand, us = disp.lookup(cs, dims, torch.float32, platform_of(dev))
        entry = disp.cache.get(canonical_key(cs, dims, torch.float32, platform_of(dev)))
        losers = {k: round(v, 1) for k, v in sorted(entry["results"].items())}
        print(f"case {label} {rm}: winner={cand.key()} ({us:.1f} µs)  all={losers}")
    print(f"# stats: {disp.stats}")
    disp2 = Dispatcher(cache_path)
    for label in labels:
        cs = parse_spec(CASES[label].row_major())
        disp2.contract(cs, *_synthesize(cs, dims, torch.float32, rng, dev))
    print(f"# second run (same cache): {disp2.stats}  <- zero new measurements")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="contraction autotuner CLI")
    ap.add_argument("--demo", action="store_true",
                    help="tune a few Table II cases and show the cache round-trip")
    ap.add_argument("--cache", default=None, help="cache path (default: env/XDG)")
    ap.add_argument("--size", type=int, default=64, help="mode size for --demo")
    ap.add_argument("--device", default="cuda",
                    help="device for --demo operands (default: the card)")
    args = ap.parse_args(argv)
    if args.demo:
        _demo(args.cache or default_cache_path(), args.size, args.device)
    else:
        ap.print_help()


if __name__ == "__main__":
    main()
