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
place.

``mesh=`` (a ``DeviceMesh`` with ``data``/``model`` axes; ``sharding_rules=``
overrides the default rules) serves sharded: the params are placed by
:func:`~repro_torch.launch.shardings.param_logical_axes` and every cache
(the slot-stacked one, each request's prefill cache, the warm-up's
scratch caches) by :func:`~repro_torch.launch.shardings.
cache_logical_axes`, and every prefill and decode step runs under the
rules (:meth:`_mesh_ctx`), so each model contraction takes the mesh
route.  Logits come back whole on every rank, so every rank samples the
same tokens.  ``paged=True`` does not serve sharded (as in the JAX
package).

``paged=True`` swaps the slot-stacked cache for the block pool of
:mod:`repro_torch.runtime.pages`: KV lives in fixed-size pages, requests
hold page tables, admission is keyed on free *pages* (a
:class:`~repro_torch.runtime.pages.PagePool` attached to the scheduler),
and prompts whose leading pages hash-match a resident prefix map those
pages by refcount instead of recomputing them.  A decode bucket then
gathers its requests' pages into the same slot-stacked layout (``P *
page_size`` rows each, one length per row), runs one batched pass and
writes each request's new row back into its page; prefill runs on a
batch-1 staging view of the request's pages and commits them when the
prompt is done.  Steps are keyed on a (slot-count × page-count) lattice.

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
architectures, the JAX package's rule: those prefill the whole prompt in
one shot (an SSM layer runs its chunked SSD over the prompt from the
cache's state; a frontend model prepends non-token features).
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ShardingRules, device_put
from repro_torch.models.layers import cached_rows, mesh_scope
from repro_torch.models.transformer import decode_step, init_cache, prefill
from repro_torch.models.tree import tree_map
from repro_torch.obs import trace as _trace
from repro_torch.runtime.buckets import BucketLattice, BucketTable, tuning_key_component
from repro_torch.runtime.metrics import ServingMetrics
from repro_torch.runtime.pages import NULL_PAGE, PagedKV, PagePool, PoolExhausted
from repro_torch.runtime.scheduler import (
    EVICTED, PREFILL, REJECTED, UNFINISHED, Request, RequestState, Scheduler,
)

__all__ = ["ServingRuntime", "supports_chunked_prefill"]


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill serves pure-attention decoder stacks only.

    The JAX package's rule, kept: SSM/hybrid stacks prefill the whole
    prompt in one shot (their cached prefill runs the SSD over it from
    the cache's state), and frontend models prepend non-token features to
    the prompt, so both take whole-prompt prefill.
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
        _copy_rows_(dst, axis, idx, src)

    tree_map(write, cache, axes, one)


def _local_rows(x, axis: int):
    """The local block of a DTensor cache leaf, whose row ``axis`` the
    cache rules never shard: its rows are the global rows, so rows are
    selected and written on it directly (torch 2.11's DTensor has no
    ``index_copy_``)."""
    from torch.distributed.tensor import Shard

    if any(isinstance(p, Shard) and p.dim % x.ndim == axis for p in x.placements):
        raise ValueError(f"a cache leaf is sharded on its row axis {axis}: {x.placements}")
    return x.to_local()


def _select_rows(x, axis: int, idx):
    """``x.index_select(axis, idx)``, a DTensor's on its local block."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.index_select(axis, idx)
    return DTensor.from_local(_local_rows(x, axis).index_select(axis, idx), x.device_mesh,
                              x.placements, run_check=False)


def _copy_rows_(dst, axis: int, idx, src) -> None:
    """``dst.index_copy_(axis, idx, src)``, a DTensor's on its local block
    (``src`` first placed as ``dst``)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(dst, DTensor):
        dst.index_copy_(axis, idx, src)
        return
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    _local_rows(dst, axis).index_copy_(axis, idx, _local_rows(src, axis))


class ServingRuntime:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 1024, greedy: bool = True,
                 prefill_chunk: int = 64, chunked_prefill: bool | None = None,
                 bucketed_decode: bool = True,
                 paged: bool = False, page_size: int = 16,
                 pages: int | None = None, prefix_sharing: bool = True,
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

        ``paged=True`` serves off a page pool of ``pages`` pages of
        ``page_size`` token rows each (default: the null page plus
        enough pages to match the unpaged runtime's ``slots × max_len``
        rows).  Memory then caps concurrency by *pages held*, not slots,
        and ``prefix_sharing`` maps hash-matching resident prompt
        prefixes instead of recomputing them.  Requires a pure-attention
        stack (the pool pages the token axis; SSM state has none).
        """
        if cfg.encoder_only:
            raise ValueError(f"{cfg.arch_id} is encoder-only; nothing to serve")
        if mesh is None and sharding_rules is not None:
            mesh = sharding_rules.mesh
        self.cfg, self.params = cfg, params
        self.slots = slots
        self.max_len = max_len
        self.greedy = greedy
        self.mesh = mesh
        self._rules = None
        if chunked_prefill is None:
            chunked_prefill = supports_chunked_prefill(cfg)
        elif chunked_prefill and not supports_chunked_prefill(cfg):
            raise ValueError(
                f"{cfg.arch_id} has SSM/frontend layers, which take "
                f"whole-prompt prefill: chunked prefill serves "
                f"pure-attention stacks only (pass chunked_prefill=False)"
            )
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.pool: PagePool | None = None
        self.kv: PagedKV | None = None
        max_pages = None
        if self.paged:
            if mesh is not None:
                raise NotImplementedError("paged KV-cache does not serve sharded yet")
            if not supports_chunked_prefill(cfg):
                raise ValueError(
                    f"{cfg.arch_id} has SSM/frontend layers: recurrent "
                    f"state has no token axis and cannot be paged"
                )
            max_pages = -(-max_len // self.page_size)  # pages per request
            if pages is None:
                # null page + the unpaged runtime's slots*max_len rows
                pages = slots * max_pages + 1
        self.device = params["embed"].device
        if mesh is not None:
            from repro_torch.launch.shardings import param_logical_axes, tree_shardings

            self._rules = sharding_rules or ShardingRules(mesh)
            self.params = device_put(params, tree_shardings(
                self._rules, param_logical_axes(params), params))
        self.lattice = BucketLattice(
            slots, max_chunk=prefill_chunk, chunked=chunked_prefill,
            bucketed_decode=bucketed_decode, max_pages=max_pages,
        )
        self.buckets = BucketTable()
        self.metrics = ServingMetrics(slots, **({"clock": clock} if clock else {}))
        #: optional callable fed each decode step's logits (the numerics
        #: probe installs here — see repro_torch.obs.health.NumericsProbe);
        #: ``None`` keeps the decode path at a single branch.
        self.logits_probe = None
        if self.paged:
            self.pool = PagePool(
                pages, self.page_size, max_rows=max_len,
                prefix_sharing=prefix_sharing, metrics=self.metrics,
            )
            self.kv = PagedKV(cfg, pages, self.page_size, device=self.device)
            self.cache = None        # KV lives in self.kv.pool
        else:
            # slot-stacked cache: one request per batch row, each row with
            # its own length
            self.cache = self._place_cache(
                slot_cache(cfg, slots, max_len, device=self.device))
            self._axes = _row_axes(self.cache)
        self.scheduler = Scheduler(slots, self.lattice, pool=self.pool)
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
    def _mesh_ctx(self):
        """The sharding rules and DTensor scope for model steps (nothing
        on one device)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return mesh_scope(self._rules)

    def _place_cache(self, cache):
        """A cache tree on the mesh by the cache rules (as it is without
        one)."""
        if self.mesh is None:
            return cache
        from repro_torch.launch.shardings import cache_logical_axes, tree_shardings

        return device_put(cache, tree_shardings(self._rules, cache_logical_axes(cache),
                                                cache))

    def _whole(self, logits):
        """Logits as one plain tensor on every rank, to sample from."""
        return logits.full_tensor() if self.mesh is not None else logits

    def _fingerprint(self):
        return tuning_key_component(self.cfg.contract_strategy)

    # every cached attention row at the runtime's width, so that a request
    # gets the same bits from a page view as from its slot
    def _decode(self, params, cache, toks):
        with cached_rows(self.max_len):
            return decode_step(self.cfg, params, cache, toks)

    def _prefill(self, params, toks, cache):
        with cached_rows(self.max_len):
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
        # paged decode runs on gathered views of every page-lattice
        # width, not on max_len slot rows
        widths = ([P * self.page_size for P in self.lattice.page_buckets] if self.paged
                  else [self.max_len])
        with torch.no_grad(), self._mesh_ctx(), recorder() as rec:
            for b in self.lattice.slot_buckets:
                toks = torch.zeros((b, 1), dtype=torch.long, device=self.device)
                for width in widths:
                    scratch = self._place_cache(
                        slot_cache(self.cfg, b, width, device=self.device))
                    self._decode(self.params, scratch, toks)
            for plen in dict.fromkeys(min(p, self.max_len) for p in prompt_lens):
                toks = torch.zeros((1, plen), dtype=torch.long, device=self.device)
                one = self._place_cache(
                    init_cache(self.cfg, 1, self.max_len, device=self.device))
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
        if self.paged:
            for P in self.lattice.page_buckets:
                bg(bk("page_view", P, fp), lambda P=P: self.kv.build_view(P))
                bg(bk("page_commit", P, fp),
                   lambda P=P: self.kv.build_commit(P))
                for c in chunks:
                    bg(bk("prefill", (c, P), fp), self._build_prefill)
                for b in self.lattice.slot_buckets:
                    bg(bk("decode", (b, P), fp),
                       lambda b=b, P=P: self.kv.build_decode(self._decode, b, P))
        else:
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
                sub = tree_map(lambda x, a: _select_rows(x, a, idx), cache, axes)
                logits, new_sub = step(p, sub, toks[idx])
                tree_map(lambda full, a, ns: _copy_rows_(full, a, idx, ns),
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
        if self.pool is not None:
            need = self.pool.required_pages(plen)
            if need > self.pool.usable:
                return (
                    f"prompt needs {need} page(s) but the pool holds "
                    f"only {self.pool.usable}"
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
        out-of-range write.)  The paged runtime also rejects prompts whose
        page table could never fit the pool."""
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
        (build-once table), ``programs`` (process program cache),
        ``pages`` (page-pool occupancy, paged runtime only) and — when a
        tuner is attached — ``dispatcher``.  Returns the registry.

        Explicit, not automatic: constructing a runtime must not mutate
        process-global state behind a test's back."""
        from repro_torch.core.program import program_cache_stats
        from repro_torch.obs.registry import get_registry

        reg = registry if registry is not None else get_registry()
        reg.register("serving", self.metrics.snapshot)
        reg.register("buckets", self.buckets.stats)
        reg.register("programs", program_cache_stats)
        if self.pool is not None:
            reg.register("pages", self.pool.stats)
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
            if self.paged:
                # gather the request's pages into a dense staging cache;
                # a shared prefix arrives pre-filled and prefill resumes
                # after it (state.pos started at shared_tokens)
                state.cache = self._page_stage(state)
            else:
                state.cache = self._place_cache(
                    init_cache(self.cfg, 1, self.max_len, device=self.device))
        toks = torch.as_tensor(
            np.asarray(state.request.prompt[state.pos:state.pos + chunk],
                       np.int64)[None], device=self.device,
        )
        # paged staging caches come in page-lattice widths, so the
        # prefill step is keyed on (chunk, width) lattice points
        size = (chunk, self._page_width(state)) if self.paged else chunk
        key = self.buckets.key("prefill", size, self._fingerprint())
        fn = self.buckets.get(key, self._build_prefill)
        with torch.no_grad(), self._mesh_ctx():
            logits, cache = fn(self.params, toks, state.cache)
            state.cache = self._place_cache(cache)
        logits = self._whole(logits)
        state.pos += chunk
        self.metrics.on_prefill_chunk(chunk)
        if state.remaining_prompt == 0:
            first = self._sample(state, logits[0])
            state.request.output.append(first)
            self._tokens[state.slot, 0] = first
            if self.paged:
                self._page_commit(state)
            else:
                with self._mesh_ctx():
                    _write_slot(self.cache, state.cache, state.slot)
            self.scheduler.prefill_done(state)
            self.metrics.on_first_token(state.rid)
            if _trace.enabled():
                _trace.instant("first_token", "runtime", rid=state.rid)
            self._maybe_finish(state)

    # ------------------------------------------------------- paged plumbing
    def _page_width(self, state: RequestState) -> int:
        """The page-lattice point covering ``state``'s page table."""
        return self.lattice.page_bucket(len(state.pages))

    def _page_table(self, state: RequestState, P: int) -> np.ndarray:
        """``state``'s page table padded to lattice width ``P`` with the
        null page (whose rows only flow through exactly-zero masked
        attention probabilities)."""
        t = np.full((P,), NULL_PAGE, np.int64)
        t[:len(state.pages)] = state.pages
        return t

    def _page_stage(self, state: RequestState):
        """Batch-1 prefill staging cache: the request's pages gathered
        dense (``P * page_size`` rows), cache length = shared prefix."""
        P = self._page_width(state)
        key = self.buckets.key("page_view", P, self._fingerprint())
        fn = self.buckets.get(key, lambda: self.kv.build_view(P))
        table = torch.as_tensor(self._page_table(state, P), device=self.device)
        return fn(table, state.shared_tokens)

    def _page_commit(self, state: RequestState) -> None:
        """Write a finished prefill's staging cache into the request's own
        pages and publish its full prompt pages to the prefix index.  The
        shared prefix pages are left as they are: prefill only read them."""
        P = self._page_width(state)
        key = self.buckets.key("page_commit", P, self._fingerprint())
        fn = self.buckets.get(key, lambda: self.kv.build_commit(P))
        pages = torch.as_tensor(np.asarray(state.pages, np.int64), device=self.device)
        fn(state.cache, pages, state.shared_tokens // self.page_size)
        self.pool.register(state)

    def _ensure_decode_capacity(self, decodes: list[RequestState]) -> None:
        """Grow page tables for this decode step, preempting on pressure.

        The step for request ``s`` writes cache row ``prompt_len +
        n_generated - 1``, so its table must cover ``prompt_len +
        n_generated`` rows.  When the pool is dry the *youngest* other
        decoding request (highest rid) is evicted — marked, its pages
        released — and the allocation retried; a request alone in the
        batch evicts itself."""
        for state in list(decodes):
            if state not in decodes:
                continue         # already preempted as a victim below
            need = self.pool.pages_for(state.prompt_len + state.n_generated)
            while len(state.pages) < need:
                try:
                    state.pages += self.pool.alloc(
                        need - len(state.pages), rid=state.rid
                    )
                except PoolExhausted:
                    others = [s for s in decodes if s is not state]
                    victim = (max(others, key=lambda s: s.rid) if others
                              else state)
                    self.scheduler.finish(victim, EVICTED)
                    self.metrics.on_evict(victim.rid)
                    if _trace.enabled():
                        _trace.instant("evict", "runtime", rid=victim.rid,
                                       reason="pool_exhausted")
                    decodes.remove(victim)
                    if victim is state:
                        break

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
        if self.paged:
            self._ensure_decode_capacity(decodes)
            if decodes:
                self._run_decode_paged(decodes)
            return
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
        with torch.no_grad(), self._mesh_ctx():
            logits, cache = fn(
                self.params, self.cache,
                torch.as_tensor(self._tokens, device=self.device),
                torch.as_tensor(idx, device=self.device),
            )
            # a step may hand back its cache placed otherwise (a write into
            # rows sharded over kv_seq gathers them): back onto the rules
            self.cache = self._place_cache(cache)
        logits = self._whole(logits)
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

    def _run_decode_paged(self, decodes: list[RequestState]) -> None:
        """One decode step over page tables: gather each request's pages
        into a view, step, write the one new KV row back.  The step is
        keyed on the (slot-bucket, page-bucket) lattice point; the batch
        pads with full duplicates of request 0's (table, length, token)
        row, so the padded rows compute — and write — identical values."""
        n = len(decodes)
        bucket = self.lattice.decode_bucket(n)
        P = self.lattice.page_bucket(max(len(s.pages) for s in decodes))
        key = self.buckets.key("decode", (bucket, P), self._fingerprint())
        fn = self.buckets.get(
            key, lambda: self.kv.build_decode(self._decode, bucket, P))
        tables = np.stack([self._page_table(s, P) for s in decodes])
        lengths = np.asarray(
            [s.prompt_len + s.n_generated - 1 for s in decodes], np.int32
        )
        toks = self._tokens[[s.slot for s in decodes]]
        if bucket > n:
            pad = bucket - n
            tables = np.concatenate([tables, np.repeat(tables[:1], pad, 0)])
            lengths = np.concatenate([lengths, np.repeat(lengths[:1], pad)])
            toks = np.concatenate([toks, np.repeat(toks[:1], pad, 0)])
        with torch.no_grad():
            logits = fn(self.params, torch.as_tensor(tables, device=self.device),
                        torch.as_tensor(lengths, device=self.device),
                        torch.as_tensor(toks, device=self.device))
        if self.logits_probe is not None:
            self.logits_probe(logits)
        self.metrics.on_decode(n, bucket)
        if self.greedy:
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            out = [int(nxt[r]) for r in range(n)]
        else:
            out = [self._sample(s, logits[r]) for r, s in enumerate(decodes)]
        for state, tok in zip(decodes, out):
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
            if self.pool is not None:
                self.metrics.on_pool_gauge(self.pool.n_free, self.pool.usable)
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
        if self.pool is not None and not self.pool.can_admit(request.prompt):
            return False         # paged: pool cannot hold the prompt now
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
