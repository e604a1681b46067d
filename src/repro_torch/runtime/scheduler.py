"""Request scheduling: the queue → slot → prefill → decode lifecycle.

The scheduler is pure host-side bookkeeping — it decides *what* runs
each tick (which requests prefill a chunk, which slots decode, who gets
admitted or evicted) and leaves *how* to the engine.  Design rules:

* **FIFO admission** — a request binds to a slot the tick one frees up;
  its prompt then prefills in lattice-sized chunks interleaved with
  everyone else's decode steps, so one long prompt cannot stall the
  decode batch (chunked prefill).
* **Per-request sampling state** — every request carries its own
  ``torch.Generator``, from which one sampling generator is split per
  sampled token, so non-greedy decode is reproducible per request
  regardless of batch composition.  (The JAX package splits a
  ``jax.random`` key; the two streams give different samples, so the
  port is held only to its own reproducibility.)
* **Eviction** — a slot can be reclaimed at any time (explicit
  ``evict`` or the engine's cache-length cap); the request is marked,
  never silently dropped.  Cancelling a request that is still *queued*
  (no slot yet) is eviction too: it leaves the queue marked
  ``evicted``.
* **Paged admission** — with a :class:`repro_torch.runtime.pages.PagePool`
  attached, admission is keyed on free *pages*, not free slots alone:
  the head-of-line request admits only when the pool can reserve its
  page table (prompt + first decode row, minus whatever prefix it
  shares).  Releasing a request's slot releases its pages in the same
  breath, so page lifetime is exactly slot lifetime.

The port of ``repro.runtime.scheduler``.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.obs import trace as _trace

__all__ = ["Request", "RequestState", "Scheduler", "TickPlan"]

#: request lifecycle states (``Request.status``).
QUEUED, PREFILL, DECODE, DONE, EVICTED, UNFINISHED, REJECTED = (
    "queued", "prefill", "decode", "done", "evicted", "unfinished",
    "rejected",
)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 16
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = QUEUED


class RequestState:
    """Engine-side bookkeeping for one live request."""

    __slots__ = ("request", "slot", "pos", "cache", "key",
                 "pages", "shared_tokens", "page_hashes")

    def __init__(self, request: Request, *, seed: int | None = None):
        self.request = request
        self.slot: int | None = None
        self.pos = 0                 # prompt tokens already prefilled
        self.cache = None            # batch-1 cache tree while prefilling
        self.key = torch.Generator().manual_seed(
            request.rid if seed is None else seed
        )
        # paged-runtime state (set by PagePool.try_admit at admission)
        self.pages: list[int] = []   # page table, shared prefix first
        self.shared_tokens = 0       # leading rows mapped from the prefix index
        self.page_hashes: list[str] = []

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def prompt_len(self) -> int:
        return int(len(self.request.prompt))

    @property
    def remaining_prompt(self) -> int:
        return self.prompt_len - self.pos

    @property
    def n_generated(self) -> int:
        return len(self.request.output)

    def next_key(self) -> torch.Generator:
        """Split off one sampling generator (per-request PRNG stream)."""
        seed = int(torch.randint(0, 2**62, (), generator=self.key))
        return torch.Generator().manual_seed(seed)


@dataclasses.dataclass
class TickPlan:
    """What one tick runs: admissions and chunked prefills.  The decode
    batch is *not* part of the plan — it must be collected with
    :meth:`Scheduler.decode_batch` **after** the prefills execute, so a
    request whose prompt completes this tick decodes this tick.  (A
    full-slot decode launch mutates every slot's cache row; if the
    just-prefilled slot were excluded from the batch, its discarded
    decode would still advance the cache and its first token would be
    fed twice.)"""

    admitted: list            # RequestStates bound to a slot this tick
    #                           (informational — admission already happened
    #                           inside schedule(); tests/telemetry read it)
    prefills: list            # (RequestState, chunk_len) pairs


class Scheduler:
    def __init__(self, slots: int, lattice, pool=None):
        self.slots = int(slots)
        self.lattice = lattice
        self.pool = pool             # PagePool | None — paged admission
        self.queue: collections.deque[RequestState] = collections.deque()
        self.active: dict[int, RequestState] = {}    # slot -> state
        self._free = list(range(self.slots))
        self._prefilling: list[RequestState] = []    # admission order

    # ------------------------------------------------------------ lifecycle
    def submit(self, request: Request, *, seed: int | None = None
               ) -> RequestState:
        state = RequestState(request, seed=seed)
        request.status = QUEUED
        self.queue.append(state)
        return state

    def admit_next(self) -> RequestState | None:
        """Bind the oldest queued request to a free slot, if any.

        With a page pool attached, the head-of-line request must also
        reserve its page table — FIFO order is preserved, so a blocked
        head blocks admission (no small-request overtaking that would
        starve long prompts)."""
        if not self._free or not self.queue:
            return None
        if self.pool is not None and not self.pool.try_admit(self.queue[0]):
            return None
        state = self.queue.popleft()
        state.slot = self._free.pop()
        state.pos = state.shared_tokens  # prefill resumes after shared prefix
        state.request.status = PREFILL
        self.active[state.slot] = state
        self._prefilling.append(state)
        if _trace.enabled():
            _trace.instant("admit", "scheduler", rid=state.rid,
                           slot=state.slot, pages=len(state.pages),
                           shared_tokens=state.shared_tokens)
        return state

    def prefill_done(self, state: RequestState) -> None:
        """Prompt fully consumed: the slot joins the decode batch."""
        state.request.status = DECODE
        state.cache = None
        self._prefilling.remove(state)

    def finish(self, state: RequestState, status: str = DONE) -> None:
        """Release the slot (and its pages); ``status`` records how the
        request ended."""
        state.request.status = status
        state.request.done = status == DONE
        if state.slot is not None:
            del self.active[state.slot]
            self._free.append(state.slot)
            state.slot = None
        if state in self._prefilling:
            self._prefilling.remove(state)
        if self.pool is not None and state.pages:
            self.pool.release(state.pages, rid=state.rid)
            state.pages = []
            state.page_hashes = []

    def evict(self, rid: int) -> RequestState:
        """Cancel a live *or still-queued* request (marked, not dropped).

        A queued request holds no slot or pages yet — it just leaves the
        queue as ``evicted``."""
        for state in list(self.active.values()):
            if state.rid == rid:
                self.finish(state, EVICTED)
                return state
        for state in self.queue:
            if state.rid == rid:
                self.queue.remove(state)
                state.request.status = EVICTED
                state.request.done = False
                return state
        raise KeyError(f"request {rid} is neither active nor queued")

    # ------------------------------------------------------------- planning
    def schedule(self) -> TickPlan:
        """Admissions + one prefill chunk per prefilling request, in
        FIFO/admission order."""
        with _trace.span("schedule", "scheduler") as sp:
            admitted = []
            while True:
                state = self.admit_next()
                if state is None:
                    break
                admitted.append(state)
            prefills = [
                (s, self.lattice.next_chunk(s.remaining_prompt))
                for s in list(self._prefilling)
            ]
            if sp:
                sp.set(admitted=[s.rid for s in admitted],
                       n_prefilling=len(self._prefilling),
                       queued=len(self.queue), free=len(self._free))
            return TickPlan(admitted=admitted, prefills=prefills)

    def decode_batch(self) -> list[RequestState]:
        """Every slot ready for one decode step, in slot order.  Collect
        this *after* the tick's prefills ran (see :class:`TickPlan`)."""
        return [
            s for _, s in sorted(self.active.items())
            if s.request.status == DECODE
        ]

    # ------------------------------------------------------------ inspection
    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def has_work(self) -> bool:
        return bool(self.queue or self.active)
