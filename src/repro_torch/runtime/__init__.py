"""Continuous-batching serving runtime (the port of ``repro.runtime``).

* :mod:`repro_torch.runtime.scheduler` — request queue, prefill/decode
  interleaving with chunked prefill, slot eviction, per-request
  sampling state;
* :mod:`repro_torch.runtime.buckets` — the live ``(active-slots,
  chunk-length)`` shapes snap onto a small bucket lattice, each bucket's
  step built once and cached with the tuning-cache fingerprint folded
  into its key;
* :mod:`repro_torch.runtime.engine` — :class:`ServingRuntime`, the tick
  loop driving scheduler → buckets → kernels, with one batched decode
  pass per bucket;
* :mod:`repro_torch.runtime.metrics` — throughput, p50/p99 latency,
  slot-utilization and bucket-hit-rate counters.

:class:`repro_torch.serving.engine.ServeEngine` runs this runtime in its
legacy configuration (no chunking, full-slot decode), the correctness
oracle.  The paged KV-cache (``repro.runtime.pages``) is ROADMAP item 11b.
"""

from repro_torch.runtime.buckets import BucketLattice, BucketTable
from repro_torch.runtime.engine import ServingRuntime
from repro_torch.runtime.metrics import ServingMetrics
from repro_torch.runtime.scheduler import Request, RequestState, Scheduler

__all__ = [
    "BucketLattice",
    "BucketTable",
    "Request",
    "RequestState",
    "Scheduler",
    "ServingMetrics",
    "ServingRuntime",
]
