"""Trace export: Chrome Trace Event JSON (Perfetto) + flat JSONL records.

Two consumers, two formats off the same :class:`repro_torch.obs.trace.Tracer`:

* :func:`chrome_trace` / :func:`write_chrome_trace` — the Chrome Trace
  Event format (JSON object form), which opens directly in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing``.  Each span category
  (layer) gets its own named track — ``runtime``, ``scheduler``,
  ``core``, ``kernels``, ``tuning``, ``program`` — so a serving tick
  reads top-down: tick → prefill/decode → contract → kernel launch, with
  request-id correlation in the event ``args``.
* :func:`jsonl_records` / :func:`write_jsonl` — one flat JSON object per
  event with every span attribute hoisted to the top level: the
  ``(shape, strategy, tiles, measured time, arithmetic intensity)``
  stream Peise-style performance predictors train on.

:func:`validate_chrome_trace` schema-checks an exported file (CI gates
on it) and is exposed as a CLI::

    python -m repro_torch.obs.export --validate trace.json \
        --require-cat core --require-name contract --summary

A copy of the JAX package's ``repro/obs/export.py``: it differs only in
import paths and docstrings, so one trace exports to the same bytes from
either package.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.obs import trace as _trace

__all__ = [
    "chrome_trace",
    "write_chrome_trace",
    "jsonl_records",
    "write_jsonl",
    "validate_chrome_trace",
    "CATEGORY_TRACKS",
]

#: layer → Perfetto track (tid) ordering; unknown categories are
#: assigned the next free id at export time.
CATEGORY_TRACKS = {
    "serve": 1,
    "runtime": 2,
    "scheduler": 3,
    "program": 4,
    "core": 5,
    "tuning": 6,
    "kernels": 7,
    "bench": 8,
    "app": 9,
}

_PID = 1


def _json_safe(v):
    """Coerce an attribute value to something ``json.dump`` accepts."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_json_safe(x) for x in v]
    return str(v)


def _tracer_or_process(tracer):
    t = tracer if tracer is not None else _trace.get_tracer()
    if t is None:
        raise ValueError(
            "no tracer: pass one, or enable_tracing() before exporting"
        )
    return t


def chrome_trace(tracer: "_trace.Tracer | None" = None) -> dict:
    """The trace as a Chrome Trace Event JSON object (Perfetto-ready)."""
    t = _tracer_or_process(tracer)
    tids = dict(CATEGORY_TRACKS)
    events: list[dict] = []
    seen_cats: list[str] = []

    def tid_for(cat: str) -> int:
        if cat not in tids:
            tids[cat] = max(tids.values()) + 1
        if cat not in seen_cats:
            seen_cats.append(cat)
        return tids[cat]

    for ev in t.events():
        out = {
            "name": ev["name"],
            "cat": ev["cat"],
            "ph": ev["ph"],
            "ts": round(float(ev["ts"]), 3),
            "pid": _PID,
            "tid": tid_for(ev["cat"]),
            "args": _json_safe(ev["args"]),
        }
        if ev["ph"] == _trace.PH_SPAN:
            out["dur"] = round(float(ev["dur"]), 3)
        else:
            out["s"] = "t"           # instant scope: thread
        events.append(out)

    meta = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
             "args": {"name": "repro contraction engine"}}]
    for cat in sorted(seen_cats, key=lambda c: tids[c]):
        meta.append({
            "name": "thread_name", "ph": "M", "pid": _PID,
            "tid": tids[cat], "args": {"name": cat},
        })
        meta.append({
            "name": "thread_sort_index", "ph": "M", "pid": _PID,
            "tid": tids[cat], "args": {"sort_index": tids[cat]},
        })
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "recorded_events": t.total,
            "dropped_events": t.dropped,
        },
    }


def write_chrome_trace(path: str, tracer: "_trace.Tracer | None" = None
                       ) -> int:
    """Write the Chrome-trace JSON; returns the number of trace events."""
    obj = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(obj, f)
    return len(obj["traceEvents"])


def jsonl_records(tracer: "_trace.Tracer | None" = None):
    """Yield one flat dict per event: ``kind``/``name``/``cat``/``ts_us``/
    ``dur_us`` plus every span attribute hoisted to the top level (an
    attribute colliding with a base field keeps an ``arg_`` prefix)."""
    t = _tracer_or_process(tracer)
    base_fields = ("kind", "name", "cat", "ts_us", "dur_us", "seq")
    for ev in t.events():
        rec = {
            "kind": "span" if ev["ph"] == _trace.PH_SPAN else "instant",
            "name": ev["name"],
            "cat": ev["cat"],
            "ts_us": float(ev["ts"]),
            "dur_us": float(ev["dur"]),
            "seq": ev["seq"],
        }
        for k, v in ev["args"].items():
            key = f"arg_{k}" if k in base_fields else k
            rec[key] = _json_safe(v)
        yield rec


def write_jsonl(path: str, tracer: "_trace.Tracer | None" = None) -> int:
    """Write the flat record stream (one JSON object per line)."""
    n = 0
    with open(path, "w") as f:
        for rec in jsonl_records(tracer):
            f.write(json.dumps(rec) + "\n")
            n += 1
    return n


# --------------------------------------------------------------------------
# Validation
# --------------------------------------------------------------------------

_VALID_PH = {"X", "i", "I", "M", "b", "e", "C"}


def validate_chrome_trace(trace_obj) -> dict:
    """Schema-check a Chrome-trace object or file path.

    Raises ``ValueError`` on the first violation; returns summary stats
    (event counts per phase and category) on success.  Checks the
    subset of the Trace Event Format that Perfetto's JSON importer
    requires: a ``traceEvents`` list whose members carry a string
    ``name``, a known ``ph``, numeric non-negative ``ts``, integer
    ``pid``/``tid``, a ``dict`` ``args`` when present — and a numeric
    non-negative ``dur`` for complete ("X") events.
    """
    if isinstance(trace_obj, str):
        with open(trace_obj) as f:
            trace_obj = json.load(f)
    if not isinstance(trace_obj, dict):
        raise ValueError(f"top level must be a JSON object, got "
                         f"{type(trace_obj).__name__}")
    events = trace_obj.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    by_ph: dict[str, int] = {}
    by_cat: dict[str, int] = {}
    names: set[str] = set()
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: not an object")
        name, ph = ev.get("name"), ev.get("ph")
        if not isinstance(name, str) or not name:
            raise ValueError(f"{where}: missing/empty 'name'")
        if ph not in _VALID_PH:
            raise ValueError(f"{where} ({name!r}): bad phase {ph!r}")
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                raise ValueError(f"{where} ({name!r}): '{field}' must be int")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(
                    f"{where} ({name!r}): 'ts' must be a number >= 0"
                )
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"{where} ({name!r}): complete event needs 'dur' >= 0"
                )
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"{where} ({name!r}): 'args' must be an object")
        by_ph[ph] = by_ph.get(ph, 0) + 1
        if ph != "M":
            cat = ev.get("cat", "")
            by_cat[cat] = by_cat.get(cat, 0) + 1
            names.add(name)
    return {
        "events": len(events),
        "by_ph": by_ph,
        "by_cat": by_cat,
        "names": sorted(names),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="trace export / validation CLI")
    ap.add_argument("--validate", metavar="TRACE_JSON",
                    help="schema-check an exported Chrome-trace file")
    ap.add_argument("--require-cat", action="append", default=[],
                    help="fail unless events of this category are present")
    ap.add_argument("--require-name", action="append", default=[],
                    help="fail unless events of this name are present")
    ap.add_argument("--summary", action="store_true",
                    help="print per-phase/per-category event counts")
    args = ap.parse_args(argv)
    if not args.validate:
        ap.print_help()
        return
    stats = validate_chrome_trace(args.validate)
    missing_cat = [c for c in args.require_cat if c not in stats["by_cat"]]
    missing_name = [n for n in args.require_name if n not in stats["names"]]
    if missing_cat or missing_name:
        print(f"FAIL: missing categories={missing_cat} names={missing_name}",
              file=sys.stderr)
        sys.exit(1)
    if args.summary:
        print(json.dumps(
            {k: stats[k] for k in ("events", "by_ph", "by_cat")}, indent=1
        ))
        print("names: " + ", ".join(stats["names"]))
    print(f"OK: {args.validate} ({stats['events']} events, "
          f"{len(stats['by_cat'])} tracks)")


if __name__ == "__main__":
    main()
