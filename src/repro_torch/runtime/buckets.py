"""Bucketed program specialization: live shapes → a small compile lattice.

Serving shapes are a two-parameter family — how many slots decode this
tick, how many prompt tokens prefill this chunk — and XLA specializes an
executable per *exact* shape.  Left alone, ragged traffic compiles
without bound (the old engine rebuilt prefill for every distinct prompt
length).  Peise et al. ("Performance Prediction of BLAS-based Tensor
Contractions") make the case that BLAS-call performance is predictable
from shape *classes*, not exact shapes — which is precisely the license
a bucket lattice needs: snap the live shape onto a small power-of-two
lattice, compile each lattice point once, and reuse it forever.

Two lattices:

* **decode buckets** — active-slot counts round *up* to the next
  power of two (capped at the engine's slot count).  A decode launch
  pads its batch with a duplicated active slot; duplicates compute
  identical values, so the scatter back is value-deterministic.
* **prefill chunks** — prompt remainders decompose into power-of-two
  chunks (largest-first: 13 → 8+4+1).  Chunks are *exact* slices, never
  padded, so chunked prefill stays bit-identical to whole-prompt
  prefill; the distinct compiled chunk lengths are bounded by
  ``log2(max chunk)``.
* **page counts** (paged runtime only) — a request's page-table length
  rounds *up* to the next power of two (capped at the pages covering
  ``max_len``), so paged gather/commit/decode views come in
  ``log2(max pages)`` widths instead of one per live cache length.
  Page tables pad to the lattice width with the null page, whose rows
  only ever flow through exactly-zero masked attention probabilities.

:class:`BucketTable` is the build-once cache over those lattice
points.  In the port an entry is a step callable (PyTorch runs eagerly:
there is nothing to trace or compile); its ``xeinsum`` calls land in the
process program cache (:func:`repro_torch.core.program.compile_program`)
on their first run, and the **tuning-cache fingerprint is folded into
the bucket key** when the model dispatches ``strategy="tuned"``: warming
the tuning cache must give a new entry, not pin a stale winner.

The port of ``repro.runtime.buckets``: a copy, apart from this docstring
and :func:`tuning_key_component`, which reads the port's dispatcher.
(The page-count lattice serves the paged runtime, ROADMAP item 11b.)
"""

from __future__ import annotations

__all__ = [
    "BucketLattice", "BucketTable", "pow2_buckets", "chunk_schedule",
    "tuning_key_component",
]


def pow2_buckets(cap: int) -> tuple[int, ...]:
    """``(1, 2, 4, ..., cap)`` — cap included even when not a power of 2."""
    if cap < 1:
        raise ValueError(f"bucket cap must be >= 1, got {cap}")
    out = []
    b = 1
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return tuple(out)


def chunk_schedule(length: int, chunks: tuple[int, ...]) -> list[int]:
    """Greedy largest-first decomposition of ``length`` into lattice chunks."""
    todo, out = int(length), []
    while todo > 0:
        c = max(c for c in chunks if c <= todo)
        out.append(c)
        todo -= c
    return out


class BucketLattice:
    """The two serving lattices: decode slot-counts and prefill chunks.

    ``chunked=False`` collapses the prefill lattice to exact prompt
    lengths (one chunk per prompt — the legacy engine's behavior, and
    the mode SSM/hybrid and frontend architectures serve in).
    ``bucketed_decode=False`` pins every decode launch to the full slot
    count (legacy step-locked behavior).
    """

    def __init__(self, slots: int, *, max_chunk: int = 64,
                 chunked: bool = True, bucketed_decode: bool = True,
                 max_pages: int | None = None):
        if max_chunk < 1:
            raise ValueError(f"max_chunk must be >= 1, got {max_chunk}")
        self.slots = int(slots)
        self.max_chunk = int(max_chunk)
        self.chunked = bool(chunked)
        self.bucketed_decode = bool(bucketed_decode)
        self.slot_buckets = (
            pow2_buckets(self.slots) if bucketed_decode else (self.slots,)
        )
        self.chunk_buckets = pow2_buckets(self.max_chunk)
        self.max_pages = int(max_pages) if max_pages else None
        self.page_buckets = (
            pow2_buckets(self.max_pages) if self.max_pages else ()
        )

    def decode_bucket(self, n_active: int) -> int:
        """Smallest lattice point holding ``n_active`` slots."""
        if not 1 <= n_active <= self.slots:
            raise ValueError(f"n_active={n_active} outside 1..{self.slots}")
        return min(b for b in self.slot_buckets if b >= n_active)

    def next_chunk(self, remaining: int) -> int:
        """Tokens the next prefill chunk should take off ``remaining``."""
        if remaining < 1:
            raise ValueError(f"remaining={remaining} must be >= 1")
        if not self.chunked:
            return int(remaining)  # exact-length single-shot prefill
        return max(c for c in self.chunk_buckets if c <= remaining)

    def page_bucket(self, n_pages: int) -> int:
        """Smallest page-count lattice point holding ``n_pages`` pages."""
        if self.max_pages is None:
            raise ValueError("lattice has no page buckets (unpaged runtime)")
        if not 1 <= n_pages <= self.max_pages:
            raise ValueError(
                f"n_pages={n_pages} outside 1..{self.max_pages}")
        return min(b for b in self.page_buckets if b >= n_pages)

    def describe(self) -> dict:
        out = {
            "slot_buckets": self.slot_buckets,
            "chunk_buckets": self.chunk_buckets if self.chunked else "exact",
        }
        if self.max_pages is not None:
            out["page_buckets"] = self.page_buckets
        return out


class BucketTable:
    """Compile-once cache of bucket executables, with hit/compile counters.

    Keys are ``(kind, size)`` lattice points plus the tuning-cache
    fingerprint component from :func:`tuning_key_component` — pass it via
    ``fingerprint`` so a warmed tuning cache recompiles the bucket
    instead of serving a stale executable.  ``get`` returns the cached
    entry or builds it via the supplied thunk, counting compiles; after
    warm-up a well-bucketed trace shows ``compiles`` frozen while
    ``hits`` grows — the zero-recompile steady state the benchmark
    asserts.
    """

    def __init__(self):
        self._entries: dict[tuple, object] = {}
        self.hits = 0
        self.misses = 0

    @property
    def compiles(self) -> int:
        return len(self._entries)

    def key(self, kind: str, size, fingerprint=None) -> tuple:
        """``size`` is one lattice point: an int, or a tuple of ints for
        multi-axis lattices (the paged decode's (slot-bucket,
        page-bucket) product)."""
        if isinstance(size, tuple):
            size = tuple(int(s) for s in size)
        else:
            size = int(size)
        return (str(kind), size, fingerprint)

    def get(self, key: tuple, build):
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            return entry
        self.misses += 1
        entry = self._entries[key] = build()
        return entry

    def reset_stats(self) -> None:
        """Zero the hit/miss counters, keeping every compiled entry —
        for measuring a steady-state window (e.g. fig14 excludes its
        warm-up trace from the reported hit rate)."""
        self.hits = self.misses = 0

    def keys(self) -> list[tuple]:
        return sorted(self._entries, key=repr)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "bucket_hits": self.hits,
            "bucket_misses": self.misses,
            "bucket_compiles": self.compiles,
            "bucket_hit_rate": self.hits / total if total else 0.0,
        }


def tuning_key_component(strategy: str):
    """The fingerprint to fold into bucket keys, or ``None``.

    Only ``strategy="tuned"`` models read the tuning cache at trace
    time, so only their buckets must be invalidated when it warms —
    exactly the rule :func:`repro_torch.core.program.program_signature`
    applies to compiled programs.
    """
    if strategy != "tuned":
        return None
    from repro_torch.tuning.dispatch import get_dispatcher

    disp = get_dispatcher()
    return (disp.policy, disp.cache.fingerprint())
