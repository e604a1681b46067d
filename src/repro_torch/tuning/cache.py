"""Persistent tuning cache: a versioned, corruption-tolerant JSON store.

Keys are canonical — mode letters are renamed to a fixed alphabet in
order of first appearance, so ``"mk,pkn->pmn"`` and ``"ab,cbd->cad"`` at
the same dims share one entry — and qualified by dims signature, operand
dtype (numpy's names: ``float32``, ``bfloat16``), and the platform the
timings were taken on (a CPU-measured winner says nothing about a card).
Values record every measured candidate's median µs plus the winner, so
the einsum path optimizer can re-rank steps from the same entries the
dispatcher executes from.

The key, the entry and the file (:data:`SCHEMA_VERSION`) are the JAX
package's, so one file can hold both packages' entries.  Only the
platform component differs (:func:`platform_of`): the port writes
``torch-cpu`` on the CPU and ``torch-cuda:<card name>:sm_<XY>`` on a card,
never one of the JAX package's backend names (``cpu``, ``gpu``, ``tpu``),
so a lookup of the port never meets a JAX entry and federation never
mixes TPU, CPU and H100 timings.  An entry of the JAX package (``best``
``xla:…`` or ``pallas:…``) is well-formed here and kept, untouched, under
its own platform.  The reverse does not hold: the JAX package's loader
knows only its own backend names and drops the port's entries as
malformed.

Durability rules:

* **atomic writes** — serialize to a sibling temp file, fsync, then
  ``os.replace`` (POSIX-atomic): a crash mid-save leaves the previous
  cache intact, never a half-written JSON;
* **corruption-tolerant loads** — unreadable files, invalid JSON, wrong
  schema versions, or structurally bogus payloads degrade to an *empty*
  cache with a ``warnings.warn`` (the autotuner re-measures; it never
  refuses to start).
"""

from __future__ import annotations

import itertools
import json
import os
import string
import tempfile
import warnings

import torch

from repro_torch.core.notation import ContractionSpec, parse_spec

__all__ = [
    "SCHEMA_VERSION",
    "FOREIGN_BACKENDS",
    "TuningCache",
    "canonical_key",
    "canonical_spec",
    "default_device",
    "default_platform",
    "platform_of",
    "valid_entry",
]

SCHEMA_VERSION = 1

#: the JAX package's backend names: entries it wrote are well-formed here
#: (and kept), though the port never executes them
FOREIGN_BACKENDS = ("xla", "pallas")

#: per-process unique ids for cache instances (see TuningCache.fingerprint)
_CACHE_UIDS = itertools.count()


def platform_of(device) -> str:
    """The platform component of a key for tensors on ``device``:
    ``"torch-cpu"``, or ``"torch-cuda:<name>:sm_<major><minor>"`` for a
    card (``|`` in the name, which separates key fields, becomes ``/``)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "torch-cpu"
    if dev.type != "cuda":
        raise ValueError(f"no tuning platform for device {dev}")
    name = torch.cuda.get_device_name(dev).replace("|", "/")
    major, minor = torch.cuda.get_device_capability(dev)
    return f"torch-cuda:{name}:sm_{major}{minor}"


def default_device() -> torch.device:
    """The process's default device: the current card if there is one,
    else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def default_platform() -> str:
    """The platform of :func:`default_device` (the counterpart of the JAX
    package's ``jax.default_backend()``)."""
    return platform_of(default_device())


def canonical_spec(spec: str | ContractionSpec, dims: dict) -> tuple[str, tuple]:
    """(renamed spec string, dims signature) — the shape-equivalence class.

    Modes are renamed ``a, b, c, …`` in order of first appearance across
    ``A‖B‖C``; the dims signature lists sizes in that same order.
    """
    cs = parse_spec(spec) if isinstance(spec, str) else spec
    order = list(dict.fromkeys(cs.a_modes + cs.b_modes + cs.c_modes))
    ren = {m: string.ascii_lowercase[i] for i, m in enumerate(order)}

    def r(modes: str) -> str:
        return "".join(ren[m] for m in modes)

    sig = tuple(int(dims[m]) for m in order)
    return f"{r(cs.a_modes)},{r(cs.b_modes)}->{r(cs.c_modes)}", sig


def canonical_key(
    spec: str | ContractionSpec,
    dims: dict,
    dtype,
    platform: str | None = None,
) -> str:
    """Full cache key: canonical spec | dims | dtype | platform
    (default: :func:`default_platform`)."""
    cspec, sig = canonical_spec(spec, dims)
    platform = platform or default_platform()
    dt = str(dtype).removeprefix("torch.")
    return f"{cspec}|{'x'.join(map(str, sig))}|{dt}|{platform}"


def valid_entry(entry) -> bool:
    """Structural validation of one cache entry.

    ``best`` must be a parseable candidate key — the port's, or one of the
    JAX package's (:data:`FOREIGN_BACKENDS`) — present in ``results``, and
    every result a number.  Extra keys ride along untouched — the
    ``"predict"`` policy adds ``predicted``/``confidence``, the copy audit
    adds ``transposes`` — so caches grown by newer code stay loadable by
    older code and mergeable by :mod:`repro_torch.tuning.federate`.
    """
    if not (
        isinstance(entry, dict)
        and isinstance(entry.get("best"), str)
        and isinstance(entry.get("results"), dict)
        and all(
            isinstance(k, str) and isinstance(v, (int, float))
            for k, v in entry["results"].items()
        )
        and entry["best"] in entry["results"]
    ):
        return False
    from repro_torch.tuning.candidates import split_key  # deferred: no cycle

    try:  # "best" must name a candidate, not arbitrary text
        split_key(entry["best"], FOREIGN_BACKENDS)
    except (ValueError, TypeError):
        return False
    return True


class TuningCache:
    """Dict-like persistent store mapping canonical keys to entries.

    An entry is ``{"best": candidate_key, "results": {candidate_key: us}}``.
    With ``path=None`` the cache is purely in-memory (the dispatcher's
    default for throwaway tuning).
    """

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = os.fspath(path) if path is not None else None
        self.entries: dict[str, dict] = {}
        self._uid = next(_CACHE_UIDS)   # distinguishes cache instances
        self._version = 0               # bumped on every put
        if self.path is not None:
            self._load()

    def fingerprint(self) -> tuple:
        """A value that changes whenever this cache's content may have:
        (instance uid, mutation counter, size).  Consumers that bake
        decisions off cache content (the compiled-program signature for
        ``tuned`` programs) key on this so content changes — including
        same-size overwrites or a swapped-in cache instance — invalidate
        them."""
        return (self._uid, self._version, len(self.entries))

    # ------------------------------------------------------------- load/save
    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        try:
            with open(self.path, encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, ValueError) as e:
            warnings.warn(
                f"tuning cache {self.path!r} is unreadable ({e}); starting empty"
            )
            return
        if not isinstance(payload, dict) or payload.get("schema") != SCHEMA_VERSION:
            got = payload.get("schema") if isinstance(payload, dict) else type(payload)
            warnings.warn(
                f"tuning cache {self.path!r} has schema {got!r} "
                f"(expected {SCHEMA_VERSION}); starting empty"
            )
            return
        entries = payload.get("entries")
        if not isinstance(entries, dict):
            warnings.warn(
                f"tuning cache {self.path!r} has no valid 'entries'; starting empty"
            )
            return
        kept = {k: v for k, v in entries.items() if valid_entry(v)}
        dropped = len(entries) - len(kept)
        if dropped:
            warnings.warn(
                f"tuning cache {self.path!r}: dropped {dropped} malformed entries"
            )
        self.entries = kept

    def save(self) -> None:
        """Atomically persist to ``self.path`` (no-op for in-memory caches)."""
        if self.path is None:
            return
        payload = {"schema": SCHEMA_VERSION, "entries": self.entries}
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(self.path) + ".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # ------------------------------------------------------------ dict-like
    def get(self, key: str) -> dict | None:
        return self.entries.get(key)

    def put(self, key: str, entry: dict, *, persist: bool = True) -> None:
        if not valid_entry(entry):
            raise ValueError(f"malformed tuning entry for {key!r}: {entry!r}")
        self.entries[key] = entry
        self._version += 1
        if persist:
            self.save()

    def drop(self, key: str, *, persist: bool = True) -> bool:
        """Evict one entry (drift remediation: a stale winner must be
        re-measured, not served).  Bumps the fingerprint, so memoized
        consumers — the cost model via
        :func:`repro_torch.tuning.model.model_for`, tuned program
        signatures — refit/recompile on next use.  Returns whether the key
        existed."""
        if key not in self.entries:
            return False
        del self.entries[key]
        self._version += 1
        if persist:
            self.save()
        return True

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def __len__(self) -> int:
        return len(self.entries)
