"""Cross-machine tuning-cache federation: merge, import, CLI.

A fleet tunes in parallel — every machine accumulates its own cache of
measured (spec, dims, dtype, platform) entries.  Federation unions them
into one store so no machine re-measures a shape any peer has already
paid for, and so the learned cost model (:mod:`repro_torch.tuning.model`)
trains on the *fleet's* measurements rather than one box's::

    python -m repro_torch.tuning.federate merge a.json b.json -o fleet.json
    python -m repro_torch.tuning.federate stats fleet.json

Semantics:

* entries union by canonical key — the **platform fingerprint is part
  of the key**, so a CPU-measured µs can never pollute a TPU entry;
* within one key, per-candidate µs union under a ``conflict`` policy
  (``min`` — fastest observation wins, the default; ``max``; ``mean``);
  ``min``/``max`` make the merge commutative, associative *and*
  idempotent — merge order and repetition cannot change the result;
* the **winner is re-picked after every merge** over the unioned
  results, with the same analytic-tie margin the dispatcher uses
  (:func:`pick_best`) — two machines that measured disjoint candidate
  sets may both be "right" and still be beaten by the union;
* *measured* entries always beat *predicted* ones (entries the
  ``"predict"`` policy recorded are model guesses — they never survive
  a merge against real data, and two predicted entries merge to the
  higher-confidence one);
* imports are **strict**: unlike :class:`~repro_torch.tuning.cache.TuningCache`
  loads (which degrade to empty so the autotuner can always start), a
  federation source that is unreadable, has the wrong schema, or carries
  malformed entries raises :class:`FederationError` — silently dropping
  a fleet member's measurements is worse than failing loudly.

A copy of the JAX package's ``repro/tuning/federate.py``.  Files are the
same format, and the JAX package's entries merge here untouched under
their own platforms; ties break toward the analytic candidate of the
entry's own package (``torch:auto`` for the port's, ``xla:auto`` for the
JAX package's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.tuning.cache import SCHEMA_VERSION, TuningCache, valid_entry

__all__ = [
    "FederationError",
    "CONFLICT_POLICIES",
    "pick_best",
    "load_payload",
    "merge_entry",
    "merge_entries",
    "merge_payloads",
    "import_into",
    "main",
]

CONFLICT_POLICIES = ("min", "max", "mean")

#: mirrors :attr:`repro_torch.tuning.dispatch.Dispatcher.TIE_MARGIN`
#: (defined here, re-exported there — federate must stay importable
#: without pulling the dispatcher's measurement stack).
TIE_MARGIN = 0.85

#: the analytic candidate a tie breaks toward: the port's, or the JAX
#: package's in one of its entries
_AUTO_KEYS = ("torch:auto", "xla:auto")


class FederationError(ValueError):
    """A federation source failed validation (see module doc: strict)."""


def pick_best(results: dict, *, tie_margin: float = TIE_MARGIN) -> str:
    """Winner over a per-candidate µs map, ties broken toward analytic.

    The same rule :meth:`repro_torch.tuning.dispatch.Dispatcher.tune`
    applies: a challenger must beat ``torch:auto`` (``xla:auto`` in an
    entry of the JAX package) by more than ``tie_margin`` — with
    measurement noise a hair-thin win is as likely a loss, and auto is the
    plan the rest of the stack reasons about.
    """
    best = min(results, key=results.get)
    auto = next((k for k in _AUTO_KEYS if k in results), None)
    if (
        auto is not None
        and best != auto
        and results[best] > tie_margin * results[auto]
    ):
        best = auto
    return best


def _resolve(a: float, b: float, conflict: str) -> float:
    if conflict == "min":
        return min(a, b)
    if conflict == "max":
        return max(a, b)
    if conflict == "mean":
        return (a + b) / 2.0
    raise ValueError(
        f"unknown conflict policy {conflict!r}; choose from {CONFLICT_POLICIES}"
    )


def merge_entry(e1: dict, e2: dict, *, conflict: str = "min") -> dict:
    """Merge two entries for the *same* canonical key.

    Measured beats predicted wholesale; two measured entries union their
    per-candidate µs under ``conflict`` (transpose audits union with
    per-key ``min`` — counts from re-audits are equal or tighter); two
    predicted entries keep the higher-confidence guess.
    """
    p1, p2 = bool(e1.get("predicted")), bool(e2.get("predicted"))
    if p1 != p2:
        return dict(e2 if p1 else e1)
    if p1 and p2:
        keep = e1 if e1.get("confidence", 0.0) >= e2.get("confidence", 0.0) else e2
        return dict(keep)
    results = dict(e1["results"])
    for k, us in e2["results"].items():
        results[k] = _resolve(results[k], us, conflict) if k in results else us
    merged = {"best": pick_best(results), "results": results}
    transposes = dict(e1.get("transposes") or {})
    for k, n in (e2.get("transposes") or {}).items():
        transposes[k] = min(transposes[k], n) if k in transposes else n
    if transposes:
        merged["transposes"] = transposes
    return merged


def merge_entries(a: dict, b: dict, *, conflict: str = "min") -> dict:
    """Union two ``{key: entry}`` maps (see :func:`merge_entry`)."""
    out = {k: dict(v) for k, v in a.items()}
    for key, entry in b.items():
        out[key] = (
            merge_entry(out[key], entry, conflict=conflict)
            if key in out else dict(entry)
        )
    return out


# ----------------------------------------------------------------- I/O layer
def _validate_payload(payload, source: str) -> dict:
    if not isinstance(payload, dict):
        raise FederationError(f"{source}: not a JSON object")
    if payload.get("schema") != SCHEMA_VERSION:
        raise FederationError(
            f"{source}: schema {payload.get('schema')!r} "
            f"(expected {SCHEMA_VERSION})"
        )
    entries = payload.get("entries")
    if not isinstance(entries, dict):
        raise FederationError(f"{source}: no 'entries' map")
    bad = [k for k, v in entries.items() if not valid_entry(v)]
    if bad:
        raise FederationError(
            f"{source}: {len(bad)} malformed entries (e.g. {bad[0]!r})"
        )
    return payload


def load_payload(path: str | os.PathLike) -> dict:
    """Load one federation source, strictly validated (raises
    :class:`FederationError` — never degrades to empty)."""
    path = os.fspath(path)
    try:
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        raise FederationError(f"{path}: unreadable ({e})") from e
    return _validate_payload(payload, path)


def merge_payloads(payloads, *, conflict: str = "min") -> dict:
    """Fold validated payloads into one ``{"schema", "entries"}`` dict."""
    entries: dict = {}
    for p in payloads:
        entries = merge_entries(entries, p["entries"], conflict=conflict)
    return {"schema": SCHEMA_VERSION, "entries": entries}


def import_into(cache: TuningCache, source, *, conflict: str = "min") -> dict:
    """Merge a federation source (path or payload) into a live cache.

    Existing in-memory entries win conflicts per ``conflict``; winners
    are re-picked on merged keys.  Persists once at the end (when the
    cache has a path).  Returns ``{"imported", "merged", "added"}``.
    """
    payload = (
        _validate_payload(source, "<payload>") if isinstance(source, dict)
        else load_payload(source)
    )
    added = merged = 0
    for key, entry in payload["entries"].items():
        mine = cache.entries.get(key)
        if mine is None:
            cache.entries[key] = dict(entry)
            added += 1
        else:
            cache.entries[key] = merge_entry(mine, entry, conflict=conflict)
            merged += 1
    cache._version += 1          # content changed: invalidate fingerprints
    cache.save()
    return {"imported": len(payload["entries"]), "merged": merged,
            "added": added}


# ----------------------------------------------------------------------- CLI
def _platforms(entries: dict) -> dict:
    out: dict[str, int] = {}
    for key in entries:
        plat = key.rsplit("|", 1)[-1]
        out[plat] = out.get(plat, 0) + 1
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch.tuning.federate",
        description="merge tuning caches gathered across machines",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    mg = sub.add_parser("merge", help="union caches into one store")
    mg.add_argument("sources", nargs="+", help="input cache JSON files")
    mg.add_argument("-o", "--output", required=True, help="merged cache path")
    mg.add_argument("--conflict", default="min", choices=CONFLICT_POLICIES,
                    help="per-candidate µs conflict policy (default: min)")
    st = sub.add_parser("stats", help="summarize one cache file")
    st.add_argument("source", help="cache JSON file")
    args = ap.parse_args(argv)

    if args.cmd == "merge":
        payloads = [load_payload(p) for p in args.sources]
        merged = merge_payloads(payloads, conflict=args.conflict)
        out = TuningCache(args.output)
        before = len(out.entries)
        out.entries = merge_entries(
            out.entries, merged["entries"], conflict=args.conflict
        )
        out._version += 1
        out.save()
        total = sum(len(p["entries"]) for p in payloads)
        print(
            f"merged {len(args.sources)} caches ({total} entries) "
            f"+ {before} existing -> {len(out.entries)} unique "
            f"entries in {args.output} (conflict={args.conflict})"
        )
    elif args.cmd == "stats":
        payload = load_payload(args.source)
        entries = payload["entries"]
        predicted = sum(1 for e in entries.values() if e.get("predicted"))
        n_results = sum(len(e["results"]) for e in entries.values())
        print(f"{args.source}: {len(entries)} entries "
              f"({predicted} predicted), {n_results} candidate timings")
        for plat, n in sorted(_platforms(entries).items()):
            print(f"  platform {plat}: {n} entries")


if __name__ == "__main__":
    try:
        main()
    except FederationError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)
