"""Serving metrics: the counters the runtime is steered and judged by.

Everything is plain host-side bookkeeping — no device sync beyond what
the engine already does to sample tokens — so the collector can run in
the hot loop.  ``clock`` is injectable for deterministic tests.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["ServingMetrics"]


def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


class ServingMetrics:
    """Throughput / latency / utilization counters for one runtime.

    Latency accounting is per request: ``submit → first token`` (TTFT)
    and ``submit → completion``; percentiles are computed over completed
    requests at :meth:`snapshot` time.  Slot utilization distinguishes
    *occupancy* (active slots / engine slots — how full the engine runs)
    from *decode efficiency* (active slots / bucket rows — how much of
    each launched decode batch is useful work; 1.0 for a perfectly
    snapped bucket).

    **Event ordering is enforced.**  Per-request events are only
    honoured for a request with a live ``on_submit`` record, and a first
    token is only honoured once: an ``on_first_token`` for a request
    already evicted (or never submitted, or already credited) must not
    bump ``tokens_out`` or fabricate a TTFT sample, and a double
    ``on_finish`` must not double-count a latency.  Out-of-order events
    are dropped and counted in ``stray_events`` — visible in
    :meth:`snapshot`, so a runtime bug shows up as a nonzero counter
    instead of silently skewed latency percentiles.
    """

    def __init__(self, slots: int, clock=time.perf_counter):
        self.slots = int(slots)
        self.clock = clock
        self.reset()

    def reset(self) -> None:
        self.tokens_out = 0
        self.prefill_tokens = 0
        self.prefill_chunks = 0
        self.decode_calls = 0
        self.ticks = 0
        self.evictions = 0
        self.rejections = 0        # refused at submit (e.g. over-long prompt)
        self.stray_events = 0      # out-of-order request events, dropped
        self.peak_engaged = 0      # max requests doing work in one tick
        # paged-runtime counters (stay zero on the unpaged path)
        self.pages_allocated = 0
        self.pages_released = 0
        self.prefix_hits = 0
        self.prefix_shared_pages = 0
        self.prefix_shared_tokens = 0
        self._pool_free_min: int | None = None   # high-water memory pressure
        self._pool_used = 0.0      # Σ used fraction over gauge samples
        self._pool_samples = 0
        self._active_rows = 0      # Σ active slots over decode calls
        self._bucket_rows = 0      # Σ bucket rows over decode calls
        self._occupancy = 0.0      # Σ (active / slots) over ticks
        self._submit: dict[int, float] = {}
        self._first: dict[int, float] = {}
        self._ttft: list[float] = []
        self._latency: list[float] = []
        self._t0: float | None = None
        self._wall = 0.0

    # ------------------------------------------------------------ serve span
    def start(self) -> None:
        if self._t0 is None:
            self._t0 = self.clock()

    def stop(self) -> None:
        if self._t0 is not None:
            self._wall += self.clock() - self._t0
            self._t0 = None

    # ------------------------------------------------------- request events
    def on_submit(self, rid: int) -> None:
        self._submit[rid] = self.clock()

    def on_first_token(self, rid: int) -> None:
        if rid not in self._submit or rid in self._first:
            # evicted-then-completed, never submitted, or a duplicate:
            # no token credit, no fabricated TTFT sample
            self.stray_events += 1
            return
        t = self.clock()
        self._first[rid] = t
        self._ttft.append(t - self._submit[rid])
        self.tokens_out += 1

    def on_token(self, n: int = 1) -> None:
        self.tokens_out += n

    def on_finish(self, rid: int) -> None:
        if rid not in self._submit:
            self.stray_events += 1     # double-finish / finish-after-evict
            return
        self._latency.append(self.clock() - self._submit.pop(rid))
        self._first.pop(rid, None)

    def on_evict(self, rid: int) -> None:
        if rid not in self._submit:
            self.stray_events += 1     # double-evict / never submitted
            return
        self.evictions += 1
        self._submit.pop(rid, None)
        self._first.pop(rid, None)

    def on_reject(self, rid: int) -> None:
        """A request refused before it ever queued (no submit record
        expected — rejection happens instead of submission)."""
        self.rejections += 1
        self._submit.pop(rid, None)

    def on_unfinished(self, rid: int) -> None:
        """Drop a request that ended without completing (max_steps
        exhaustion): no latency sample, no leaked submit timestamp."""
        if rid not in self._submit:
            self.stray_events += 1
            return
        self._submit.pop(rid, None)
        self._first.pop(rid, None)

    # --------------------------------------------------------- batch events
    def on_prefill_chunk(self, n_tokens: int) -> None:
        self.prefill_chunks += 1
        self.prefill_tokens += int(n_tokens)

    def on_decode(self, n_active: int, bucket_rows: int) -> None:
        self.decode_calls += 1
        self._active_rows += int(n_active)
        self._bucket_rows += int(bucket_rows)

    def on_tick(self, n_active: int) -> None:
        self.ticks += 1
        self._occupancy += n_active / self.slots
        if n_active > self.peak_engaged:
            self.peak_engaged = n_active

    # ----------------------------------------------------- page-pool events
    def on_page_alloc(self, n: int) -> None:
        self.pages_allocated += int(n)

    def on_page_release(self, n: int) -> None:
        self.pages_released += int(n)

    def on_prefix_hit(self, n_pages: int, n_tokens: int) -> None:
        self.prefix_hits += 1
        self.prefix_shared_pages += int(n_pages)
        self.prefix_shared_tokens += int(n_tokens)

    def on_pool_gauge(self, free: int, total: int) -> None:
        """Sample pool occupancy (called once per tick by the engine)."""
        free, total = int(free), int(total)
        if self._pool_free_min is None or free < self._pool_free_min:
            self._pool_free_min = free
        if total > 0:
            self._pool_used += (total - free) / total
            self._pool_samples += 1

    # -------------------------------------------------------------- summary
    def snapshot(self, bucket_table=None) -> dict:
        """All counters as one flat dict (JSON-ready floats/ints)."""
        wall = self._wall + (self.clock() - self._t0 if self._t0 is not None
                             else 0.0)
        out = {
            "tokens_out": self.tokens_out,
            "prefill_tokens": self.prefill_tokens,
            "prefill_chunks": self.prefill_chunks,
            "decode_calls": self.decode_calls,
            "ticks": self.ticks,
            "evictions": self.evictions,
            "rejections": self.rejections,
            "stray_events": self.stray_events,
            "pages_allocated": self.pages_allocated,
            "pages_released": self.pages_released,
            "prefix_hits": self.prefix_hits,
            "prefix_shared_pages": self.prefix_shared_pages,
            "prefix_shared_tokens": self.prefix_shared_tokens,
            "pool_free_min": (
                -1 if self._pool_free_min is None else self._pool_free_min
            ),
            "pool_used_frac": (
                self._pool_used / self._pool_samples if self._pool_samples
                else 0.0
            ),
            "requests_done": len(self._latency),
            "wall_s": wall,
            "throughput_tok_s": self.tokens_out / wall if wall > 0 else 0.0,
            "p50_latency_s": _pct(self._latency, 50),
            "p99_latency_s": _pct(self._latency, 99),
            "p50_ttft_s": _pct(self._ttft, 50),
            "p99_ttft_s": _pct(self._ttft, 99),
            "peak_engaged": self.peak_engaged,
            "slot_occupancy": self._occupancy / self.ticks if self.ticks else 0.0,
            "decode_efficiency": (
                self._active_rows / self._bucket_rows if self._bucket_rows
                else 0.0
            ),
        }
        if bucket_table is not None:
            out.update(bucket_table.stats())
        return out
