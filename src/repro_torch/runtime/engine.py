"""The continuous-batching serving runtime.

:class:`ServingRuntime` drives the tick loop over the three layers this
package separates:

* the :class:`~repro_torch.runtime.scheduler.Scheduler` decides *what*
  runs — admissions, one prefill chunk per prefilling request, the
  decode batch;
* the :class:`~repro_torch.runtime.buckets.BucketLattice` decides *at
  which shape* it runs — active-slot counts snap up to a power-of-two
  decode bucket, prompts decompose into exact power-of-two chunks — and
  the :class:`~repro_torch.runtime.buckets.BucketTable` builds each
  lattice point's step once;
* the kernels execute: decode gathers the bucket's slots out of the
  slot-stacked cache, runs **one batched pass** over them, and scatters
  back (bucket == slot count skips the gather entirely — the legacy
  step-locked pass).

The port of ``repro.runtime.engine``, unpaged.  Where the JAX package
decodes with ``jax.vmap(decode_step)`` over batch-1 slots, each with its
own cache length, the port's slot-stacked cache keeps one request per
batch row with its ``length`` as a ``(slots,)`` vector, and a decode
bucket is one :func:`~repro_torch.models.transformer.decode_step` over
the gathered rows: each row takes its own rope positions, masks, cache
row and MoE dispatch group (see :mod:`repro_torch.models.transformer`).
The runtime owns its slot-stacked cache and writes slots into it in
place.  ``paged=True`` (the page pool, ROADMAP item 11b) and ``mesh=``
(item 12) raise ``NotImplementedError``.

Correctness invariants the tests pin:

* **greedy token identity** — chunked prefill slices the prompt exactly
  (never pads), threads absolute positions, and cached attention always
  contracts against the full cache width with exact-zero masked
  probabilities, so every request's token stream equals the legacy
  engine's whatever the batch composition;
* **value-deterministic scatter** — a decode bucket pads its index
  vector by duplicating an active slot; duplicates compute identical
  updates, so the scatter cannot race on conflicting values;
* **bounded build set** — after warm-up every live shape is a bucket
  hit (``BucketTable.compiles`` frozen).

Chunked prefill is auto-disabled for SSM/hybrid and frontend
architectures: the recurrent decode path folds a multi-token chunk into
its last token, so only whole-prompt prefill matches the legacy oracle
there.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import decode_step, init_cache, prefill
from repro_torch.models.tree import tree_map
from repro_torch.obs import trace as _trace
from repro_torch.runtime.buckets import BucketLattice, BucketTable, tuning_key_component
from repro_torch.runtime.metrics import ServingMetrics
from repro_torch.runtime.scheduler import (
    EVICTED, PREFILL, REJECTED, UNFINISHED, Request, RequestState, Scheduler,
)

__all__ = ["ServingRuntime", "supports_chunked_prefill"]


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill is exact only for pure-attention decoder stacks.

    SSM/hybrid blocks run their cached prefill through the recurrent
    decode step, which folds a multi-token chunk into its last token;
    frontend models prepend non-token features.  Both must prefill the
    whole prompt in one shot to match the legacy engine.
    """
    specs = tuple(cfg.prefix) + tuple(cfg.pattern)
    return cfg.frontend is None and all(s.mixer == "attn" for s in specs)


def _row_axes(cache):
    """The batch axis of every leaf of a cache tree: 1 under the pattern
    (after the period axis), 0 elsewhere."""
    return {"length": 0,
            "prefix": tree_map(lambda _: 0, cache["prefix"]),
            "pattern": tree_map(lambda _: 1, cache["pattern"])}


def slot_cache(cfg: ModelConfig, slots: int, max_len: int, *, device="cuda"):
    """The runtime's slot-stacked cache: :func:`init_cache` for ``slots``
    rows, with every ``length`` one per row (``(slots,)``, and
    ``(n_periods, slots)`` under the pattern)."""
    cache = init_cache(cfg, slots, max_len, device=device)

    def per_row(x, axis):
        if x.ndim > axis:
            return x                      # has its batch axis already
        return x.unsqueeze(axis).repeat_interleave(slots, axis)

    return tree_map(per_row, cache, _row_axes(cache))


def _write_slot(cache, one, slot: int) -> None:
    """Copy a batch-1 cache tree (scalar lengths) into row ``slot`` of the
    slot-stacked cache, in place."""
    axes = _row_axes(cache)
    idx = None

    def write(dst, axis, src):
        nonlocal idx
        if idx is None:
            idx = torch.tensor([slot], device=dst.device)
        src = src.to(dst.dtype)
        if src.ndim < dst.ndim:
            src = src.unsqueeze(axis)
        dst.index_copy_(axis, idx, src)

    tree_map(write, cache, axes, one)


class ServingRuntime:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 1024, greedy: bool = True,
                 prefill_chunk: int = 64, chunked_prefill: bool | None = None,
                 bucketed_decode: bool = True, paged: bool = False,
                 pretune: bool = False, tuner=None, tuning_cache=None,
                 tune_policy: str | None = None,
                 pretune_prompt_lens: tuple[int, ...] = (8, 16, 32),
                 precompile: bool = True,
                 mesh=None, sharding_rules=None, clock=None):
        """``chunked_prefill=None`` auto-detects
        (:func:`supports_chunked_prefill`); ``bucketed_decode=False`` +
        ``chunked_prefill=False`` is the legacy step-locked engine.

        The runtime serves on the device that holds ``params`` (the
        model's ``init_params`` draws on its generator's device,
        :func:`repro_torch.interop.params_from_numpy` on the one it is
        given: the card unless the caller asks for the CPU).
        """
        if cfg.encoder_only:
            raise ValueError(f"{cfg.arch_id} is encoder-only; nothing to serve")
        if paged:
            raise NotImplementedError(
                "the paged KV-cache is not ported yet: ROADMAP.md queue 1, item 11b")
        if mesh is not None or sharding_rules is not None:
            raise NotImplementedError(
                "sharded serving (mesh=/sharding_rules=) is not ported yet: "
                "ROADMAP.md queue 1, item 12")
        self.cfg, self.params = cfg, params
        self.slots = slots
        self.max_len = max_len
        self.greedy = greedy
        self.mesh = None
        if chunked_prefill is None:
            chunked_prefill = supports_chunked_prefill(cfg)
        elif chunked_prefill and not supports_chunked_prefill(cfg):
            raise ValueError(
                f"{cfg.arch_id} has SSM/frontend layers: chunked prefill "
                f"would not match whole-prompt prefill (pass "
                f"chunked_prefill=False)"
            )
        self.device = params["embed"].device
        self.lattice = BucketLattice(
            slots, max_chunk=prefill_chunk, chunked=chunked_prefill,
            bucketed_decode=bucketed_decode,
        )
        self.buckets = BucketTable()
        self.metrics = ServingMetrics(slots, **({"clock": clock} if clock else {}))
        #: optional callable fed each decode step's logits (the numerics
        #: probe installs here — see repro_torch.obs.health.NumericsProbe);
        #: ``None`` keeps the decode path at a single branch.
        self.logits_probe = None
        self.scheduler = Scheduler(slots, self.lattice)
        # slot-stacked cache: one request per batch row, each row with its
        # own length
        self.cache = slot_cache(cfg, slots, max_len, device=self.device)
        self._axes = _row_axes(self.cache)
        self._tokens = np.zeros((slots, 1), np.int64)
        self.tuner = tuner
        self.pretune_stats: dict | None = None
        self.program_stats: dict | None = None
        # pretune BEFORE precompile: warming the tuning cache bumps its
        # fingerprint, which would invalidate every tuned program (and
        # every bucket key) precompile just built
        if pretune:
            self.pretune_stats = self.warmup_tuning(
                tuner=tuner, tuning_cache=tuning_cache,
                tune_policy=tune_policy,
                prompt_lens=pretune_prompt_lens,
            )
        if precompile:
            self.program_stats = self.precompile_programs(
                prompt_lens=pretune_prompt_lens
            )
        # the warm-up's dispatcher traffic is bookkept under
        # pretune_stats; the serve phase then starts its hit/miss/
        # measurement counters from a deterministic zero
        if pretune and self.tuner is not None:
            self.pretune_stats["dispatcher"] = dict(self.tuner.stats)
            if hasattr(self.tuner, "reset_counters"):
                self.tuner.reset_counters()

    # --------------------------------------------------------------- helpers
    def _fingerprint(self):
        return tuning_key_component(self.cfg.contract_strategy)

    def _decode(self, params, cache, toks):
        return decode_step(self.cfg, params, cache, toks)

    def _prefill(self, params, toks, cache):
        return prefill(self.cfg, params, {"tokens": toks}, cache)

    # ----------------------------------------------------------- autotuning
    def _trace_working_set(self, recorder, prompt_lens) -> list:
        """Run every decode bucket + every prefill length once under
        ``recorder`` (``record_contractions`` / ``record_programs``) and
        return the recording.

        The JAX package traces these abstractly with ``jax.eval_shape``;
        the port has no abstract evaluation through its kernels, so each
        lattice point runs **once for real** on scratch state (a zeroed
        cache, zero tokens) — which also builds and loads the kernels
        before the first request.  Nothing of it touches the runtime's
        cache, scheduler, metrics or bucket table.
        """
        with torch.no_grad(), recorder() as rec:
            for b in self.lattice.slot_buckets:
                scratch = slot_cache(self.cfg, b, self.max_len, device=self.device)
                toks = torch.zeros((b, 1), dtype=torch.long, device=self.device)
                self._decode(self.params, scratch, toks)
            for plen in dict.fromkeys(min(p, self.max_len) for p in prompt_lens):
                toks = torch.zeros((1, plen), dtype=torch.long, device=self.device)
                one = init_cache(self.cfg, 1, self.max_len, device=self.device)
                self._prefill(self.params, toks, one)
        return rec

    def _prefill_lens(self, prompt_lens) -> tuple[int, ...]:
        """The prefill lengths worth pre-running: the chunk lattice when
        chunking is on (the steady-state build set), the caller's
        prompt-length buckets otherwise."""
        if self.lattice.chunked:
            return self.lattice.chunk_buckets
        return tuple(prompt_lens)

    def contraction_working_set(
        self, prompt_lens: tuple[int, ...] = (8, 16, 32)
    ) -> list[tuple]:
        """The ``(spec, dims, dtype)`` set of every decode bucket + every
        steady-state prefill length (see :meth:`_trace_working_set`)."""
        from repro_torch.core.contract import record_contractions

        return self._trace_working_set(
            record_contractions, self._prefill_lens(prompt_lens)
        )

    def precompile_programs(
        self, prompt_lens: tuple[int, ...] = (8, 16, 32)
    ) -> dict:
        """Plan the contraction-program working set up front.

        Runs every decode bucket and every steady-state prefill length once
        (see :meth:`_trace_working_set`) under
        :func:`repro_torch.core.program.record_programs`, so every
        ``xeinsum`` the forward passes issue lands in the process program
        cache: parsed, path-planned and pass-pipelined exactly once.
        Returns ``{"programs": unique, "calls": recorded, "steps": total}``.
        """
        from repro_torch.core.program import record_programs

        rec = self._trace_working_set(
            record_programs, self._prefill_lens(prompt_lens)
        )
        unique = {p.signature for p in rec}
        return {
            "programs": len(unique),
            "calls": len(rec),
            "steps": sum(len(p.program.steps) for p in rec),
        }

    def precompile_buckets(self) -> int:
        """Create every bucket-table entry on the lattice up front.

        After it runs, ``BucketTable.compiles`` is frozen at the lattice
        size and every serve-time lookup is a hit.  Returns the entry
        count."""
        fp = self._fingerprint()
        bk, bg = self.buckets.key, self.buckets.get
        chunks = self.lattice.chunk_buckets if self.lattice.chunked else ()
        for b in self.lattice.slot_buckets:
            bg(bk("decode", b, fp), lambda b=b: self._build_decode(b))
        for c in chunks:
            bg(bk("prefill", c, fp), self._build_prefill)
        return self.buckets.compiles

    def warmup_tuning(self, *, tuner=None, tuning_cache=None,
                      tune_policy: str | None = None,
                      prompt_lens: tuple[int, ...] = (8, 16, 32)) -> dict:
        """Pre-tune the runtime's contraction working set before serving.

        Measures (and persists, when the dispatcher's cache has a path)
        the fastest execution mode for every distinct contraction the
        model issues at serving shapes, on the runtime's device.  With
        ``tune_policy="predict"`` the warm-up is *predict-first*.  Returns
        the pretune stats dict; the dispatcher is kept on ``self.tuner``.
        """
        if tuner is None:
            from repro_torch.tuning.dispatch import Dispatcher, get_dispatcher

            tuner = (
                Dispatcher(tuning_cache) if tuning_cache is not None
                else get_dispatcher()
            )
        if tune_policy is not None:
            tuner.policy = tune_policy
        self.tuner = tuner
        return tuner.pretune(self.contraction_working_set(prompt_lens),
                             device=self.device)

    # --------------------------------------------------------- bucket builds
    def _build_decode(self, bucket: int):
        """The decode step for one slot-count bucket.

        ``bucket == slots`` runs on the slot-stacked cache directly (the
        legacy pass — no gather, logits row == slot id).  Smaller buckets
        gather the indexed slots, decode them in one batched pass, and
        scatter back in place; logits rows align with the index vector.
        """
        step, axes = self._decode, self._axes
        if bucket == self.slots:
            def fn(p, cache, toks, idx):
                del idx  # full batch: row == slot id
                return step(p, cache, toks)
        else:
            def fn(p, cache, toks, idx):
                sub = tree_map(lambda x, a: x.index_select(a, idx), cache, axes)
                logits, new_sub = step(p, sub, toks[idx])
                tree_map(lambda full, a, ns: full.index_copy_(a, idx, ns),
                         cache, axes, new_sub)
                return logits, cache
        return fn

    def _build_prefill(self):
        return self._prefill

    # ------------------------------------------------------------ lifecycle
    def _reject_reason(self, request: Request) -> str | None:
        """Why a request could *never* be served, or ``None``.

        One rule, two callers: :meth:`submit` raises on it (programming
        error at the API), :meth:`serve` marks the offender ``rejected``
        and serves the rest of the batch (operational input)."""
        plen = len(request.prompt)
        if plen > self.max_len:
            return (
                f"prompt of {plen} tokens exceeds max_len={self.max_len} "
                f"(the KV cache cannot hold it)"
            )
        return None

    def submit(self, request: Request) -> RequestState:
        """Queue a request (admitted when a slot frees up).

        Prompts longer than ``max_len`` are rejected here: the prefill
        writes one cache row per prompt token, and an over-long prompt
        would have its writes clamped — silently overwriting earlier KV
        rows and emitting a first token from corrupted state.  (A prompt
        of exactly ``max_len`` is fine: the first token comes from the
        prefill logits, and the decode cache-length cap evicts before any
        out-of-range write.)"""
        reason = self._reject_reason(request)
        if reason is not None:
            raise ValueError(f"request {request.rid}: {reason}")
        state = self.scheduler.submit(request)
        self.metrics.on_submit(request.rid)
        if _trace.enabled():
            _trace.instant("submit", "runtime", rid=request.rid,
                           prompt_len=len(request.prompt),
                           max_new=request.max_new_tokens)
        return state

    def evict(self, rid: int) -> Request:
        """Reclaim a live request's slot; the request is marked
        ``"evicted"`` (``done`` stays False) and its slot is reusable
        immediately."""
        state = self.scheduler.evict(rid)
        self.metrics.on_evict(rid)
        if _trace.enabled():
            _trace.instant("evict", "runtime", rid=rid, reason="explicit")
        return state.request

    # ------------------------------------------------------------ metrics
    def register_metrics(self, registry=None):
        """Wire this runtime's counters into a
        :class:`repro_torch.obs.registry.MetricsRegistry` (default: the
        process-wide one) under the conventional source names:
        ``serving`` (request/token/latency metrics), ``buckets``
        (build-once table), ``programs`` (process program cache) and —
        when a tuner is attached — ``dispatcher``.  Returns the registry.

        Explicit, not automatic: constructing a runtime must not mutate
        process-global state behind a test's back."""
        from repro_torch.core.program import program_cache_stats
        from repro_torch.obs.registry import get_registry

        reg = registry if registry is not None else get_registry()
        reg.register("serving", self.metrics.snapshot)
        reg.register("buckets", self.buckets.stats)
        reg.register("programs", program_cache_stats)
        if self.tuner is not None:
            reg.register("dispatcher", lambda: self.tuner.stats)
        return reg

    # ------------------------------------------------------------- execution
    def _sample(self, state: RequestState, logits_row) -> int:
        """One token off a (V,) logits row — argmax, or a Gumbel-max draw
        from the request's own generator (on the host, so the sample is
        the same on every device)."""
        if self.greedy:
            return int(torch.argmax(logits_row))
        row = logits_row.float().cpu()
        u = torch.rand(row.shape, generator=state.next_key())
        return int(torch.argmax(row - torch.log(-torch.log(u))))

    def _run_prefill_chunk(self, state: RequestState, chunk: int) -> None:
        with _trace.span("prefill_chunk", "runtime") as sp:
            if sp:
                sp.set(rid=state.rid, chunk=chunk, pos=state.pos,
                       slot=state.slot)
            self._run_prefill_chunk_impl(state, chunk)

    def _run_prefill_chunk_impl(self, state: RequestState, chunk: int) -> None:
        if state.cache is None:
            state.cache = init_cache(self.cfg, 1, self.max_len, device=self.device)
        toks = torch.as_tensor(
            np.asarray(state.request.prompt[state.pos:state.pos + chunk],
                       np.int64)[None], device=self.device,
        )
        key = self.buckets.key("prefill", chunk, self._fingerprint())
        fn = self.buckets.get(key, self._build_prefill)
        with torch.no_grad():
            logits, state.cache = fn(self.params, toks, state.cache)
        state.pos += chunk
        self.metrics.on_prefill_chunk(chunk)
        if state.remaining_prompt == 0:
            first = self._sample(state, logits[0])
            state.request.output.append(first)
            self._tokens[state.slot, 0] = first
            _write_slot(self.cache, state.cache, state.slot)
            self.scheduler.prefill_done(state)
            self.metrics.on_first_token(state.rid)
            if _trace.enabled():
                _trace.instant("first_token", "runtime", rid=state.rid)
            self._maybe_finish(state)

    def _maybe_finish(self, state: RequestState) -> None:
        if state.n_generated >= state.request.max_new_tokens:
            self.scheduler.finish(state)
            self.metrics.on_finish(state.rid)
            if _trace.enabled():
                _trace.instant("finish", "runtime", rid=state.rid,
                               n_generated=state.n_generated)

    def _run_decode(self, decodes: list[RequestState]) -> None:
        # cache-length cap: a slot whose next token would fall off the
        # cache is evicted (marked, not silently corrupted)
        for state in list(decodes):
            if state.prompt_len + state.n_generated - 1 >= self.max_len:
                self.scheduler.finish(state, EVICTED)
                self.metrics.on_evict(state.rid)
                if _trace.enabled():
                    _trace.instant("evict", "runtime", rid=state.rid,
                                   reason="cache_cap")
                decodes.remove(state)
        if not decodes:
            return
        with _trace.span("decode_batch", "runtime") as sp:
            if sp:
                sp.set(n_active=len(decodes),
                       bucket=self.lattice.decode_bucket(len(decodes)),
                       rids=[s.rid for s in decodes])
            self._run_decode_impl(decodes)

    def _run_decode_impl(self, decodes: list[RequestState]) -> None:
        n = len(decodes)
        bucket = self.lattice.decode_bucket(n)
        key = self.buckets.key("decode", bucket, self._fingerprint())
        fn = self.buckets.get(key, lambda: self._build_decode(bucket))
        if bucket == self.slots:
            idx = np.arange(self.slots)
            rows = [s.slot for s in decodes]
        else:
            slot_ids = [s.slot for s in decodes]
            # pad with a duplicate of an active slot: duplicates compute
            # identical updates, so the scatter is value-deterministic
            idx = np.asarray(slot_ids + [slot_ids[0]] * (bucket - n))
            rows = list(range(n))
        with torch.no_grad():
            logits, self.cache = fn(
                self.params, self.cache,
                torch.as_tensor(self._tokens, device=self.device),
                torch.as_tensor(idx, device=self.device),
            )
        if self.logits_probe is not None:
            self.logits_probe(logits)
        self.metrics.on_decode(n, bucket)
        if self.greedy:
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            toks = [int(nxt[r]) for r in rows]
        else:
            toks = [self._sample(s, logits[r]) for s, r in zip(decodes, rows)]
        for state, tok in zip(decodes, toks):
            state.request.output.append(tok)
            self._tokens[state.slot, 0] = tok
            self.metrics.on_token()
            self._maybe_finish(state)

    def tick(self) -> None:
        """One scheduler round: admissions → prefill chunks → decode.

        The decode batch is collected *after* the prefills ran: a
        request whose prompt completes this tick takes its first decode
        step this tick (matching the legacy admit-then-step order).
        This is load-bearing for correctness, not just latency — the
        full-slot decode launch updates every slot's cache row, so a
        just-prefilled slot left out of the batch would have its cache
        advanced by a *discarded* decode and its first token would be
        fed again next tick."""
        with _trace.span("tick", "runtime") as sp:
            plan = self.scheduler.schedule()
            engaged = {s.rid for s, _ in plan.prefills}
            for state, chunk in plan.prefills:
                self._run_prefill_chunk(state, chunk)
            batch = self.scheduler.decode_batch()
            self._run_decode(batch)
            # occupancy counts slots that did work this tick: _run_decode
            # drops cap-evicted states from `batch` in place (they launched
            # nothing), and the count is taken before finish() released the
            # requests that completed, so a full-throughput stream of short
            # requests reads as busy
            engaged.update(s.rid for s in batch)
            self.metrics.on_tick(len(engaged))
            if sp:
                sp.set(n_prefills=len(plan.prefills), n_decode=len(batch),
                       engaged=sorted(engaged))

    def admit_now(self, request: Request) -> bool:
        """Legacy-style admission: bind a slot and run the *whole*
        prompt's prefill immediately (all chunks back to back).  Returns
        False when no slot is free — the old ``ServeEngine.admit``
        contract."""
        if self.scheduler.n_free == 0 or self.scheduler.queue:
            return False
        self.submit(request)
        state = self.scheduler.admit_next()
        while state.request.status == PREFILL:
            self._run_prefill_chunk(
                state, self.lattice.next_chunk(state.remaining_prompt)
            )
        return True

    def serve(self, requests: list[Request], max_steps: int = 10_000,
              tick_callback=None):
        """Run to completion with continuous batching.

        Requests still live when ``max_steps`` runs out are marked
        ``status="unfinished"`` (``done`` stays False) and a
        ``RuntimeWarning`` is emitted — never silently returned as if
        complete.  ``tick_callback``, when given, is invoked as
        ``tick_callback(step)`` after every tick.

        The whole batch is validated *before* anything queues: an
        unservable request (over-long prompt) is marked
        ``status="rejected"`` with a ``RuntimeWarning`` and the rest of
        the list is served."""
        for r in requests:
            reason = self._reject_reason(r)
            if reason is None:
                continue
            r.status = REJECTED
            r.done = False
            self.metrics.on_reject(r.rid)
            if _trace.enabled():
                _trace.instant("reject", "runtime", rid=r.rid)
            warnings.warn(
                f"request {r.rid} rejected (not served): {reason}",
                RuntimeWarning,
                stacklevel=2,
            )
        for r in requests:
            if r.status != REJECTED:
                self.submit(r)
        self.metrics.start()
        steps = 0
        while self.scheduler.has_work() and steps < max_steps:
            self.tick()
            steps += 1
            if tick_callback is not None:
                tick_callback(steps)
        self.metrics.stop()
        if self.scheduler.has_work():
            leftover = [s for s in list(self.scheduler.queue)
                        + list(self.scheduler.active.values())]
            for state in leftover:
                if state.slot is not None:
                    self.scheduler.finish(state, UNFINISHED)
                else:
                    state.request.status = UNFINISHED
                self.metrics.on_unfinished(state.rid)
            self.scheduler.queue.clear()
            warnings.warn(
                f"serve() exhausted max_steps={max_steps} with "
                f"{len(leftover)} unfinished request(s): "
                f"{sorted(s.rid for s in leftover)} (marked "
                f"status='unfinished', done=False)",
                RuntimeWarning,
                stacklevel=2,
            )
        return requests
