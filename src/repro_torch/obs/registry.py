"""MetricsRegistry: one snapshot API over the stack's scattered counters.

Every layer keeps its own counters behind its own accessor — the
autotuner :class:`~repro_torch.tuning.dispatch.Dispatcher` (``stats``),
the program cache (:func:`repro_torch.core.program.program_cache_stats`),
and, once ported (ROADMAP queue 1, item 11), the serving runtime's — and a
fleet collector would have to know all of them.  The registry unifies
them behind *named sources*: any zero-arg callable returning a flat dict
registers under a name, and :meth:`MetricsRegistry.snapshot` returns one
nested ``{source: {metric: value}}`` dict, JSON-ready for a scraper or a
periodic printout.

Sources are late-bound (called at snapshot time), so a snapshot is
always current; a source that raises is reported as an ``"error"``
entry rather than taking the whole snapshot down.  The registry also
owns free-form counters (:meth:`counter`) for one-off events that have
no natural home object.

A copy of the JAX package's ``repro/obs/registry.py``: it differs only in
import paths and docstrings.
"""

from __future__ import annotations

import threading

__all__ = ["MetricsRegistry", "get_registry", "set_registry"]


class MetricsRegistry:
    """Named metric sources + free counters behind one snapshot call.

    Thread-safe where it must be: :meth:`counter` is a read-modify-write
    the serving runtime and pretune warm-up can hit from concurrent
    contexts, so counter bumps and source (un)registration are guarded
    by one lock.  Snapshots copy the source table under the lock but
    *call* the sources outside it — a slow or re-entrant source must not
    block every counter bump in the process.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: dict[str, object] = {}
        self._counters: dict[str, float] = {}

    # --------------------------------------------------------------- sources
    def register(self, name: str, source) -> None:
        """Register (or replace) a source: a zero-arg callable returning
        a dict of metric values."""
        if not callable(source):
            raise TypeError(f"source {name!r} must be callable")
        with self._lock:
            self._sources[str(name)] = source

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def sources(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._sources))

    # -------------------------------------------------------------- counters
    def counter(self, name: str, inc: float = 1) -> float:
        """Bump (and return) a registry-owned counter (atomic)."""
        with self._lock:
            v = self._counters.get(name, 0) + inc
            self._counters[name] = v
            return v

    def reset_counters(self) -> None:
        with self._lock:
            self._counters.clear()

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """``{source_name: source_dict}`` (+ ``"counters"`` when any) —
        every source called now.  A raising source contributes
        ``{"error": "<Type>: <msg>"}`` instead of propagating."""
        with self._lock:
            sources = dict(self._sources)
            counters = dict(self._counters)
        out: dict[str, dict] = {}
        for name in sorted(sources):
            try:
                val = sources[name]()
                out[name] = dict(val) if val is not None else {}
            except Exception as e:  # keep the rest of the snapshot alive
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        if counters:
            out["counters"] = counters
        return out

    def clear(self) -> None:
        with self._lock:
            self._sources.clear()
            self._counters.clear()


# --------------------------------------------------------------------------
# Process-wide registry
# --------------------------------------------------------------------------

_REGISTRY: MetricsRegistry | None = None


def get_registry() -> MetricsRegistry:
    """The process-wide registry (created lazily)."""
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = MetricsRegistry()
    return _REGISTRY


def set_registry(registry: MetricsRegistry | None) -> None:
    """Install (or clear, with ``None``) the process-wide registry."""
    global _REGISTRY
    _REGISTRY = registry
