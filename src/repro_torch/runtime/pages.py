"""Paged KV-cache: a block-pool allocator with content-hash prefix reuse.

Without it the runtime gives every slot a contiguous ``max_len`` cache, so
device memory — not compute — caps concurrency.  This module replaces slot
caches with a **page pool**: KV state lives in fixed-size pages of
``page_size`` token rows, requests hold *page tables* (lists of page ids),
and the engine's gather/scatter becomes page-table indexed.  Decode over
scattered pages is a batch of contractions at non-contiguous strided
addresses, the source paper's pointer-interface case, and the page-count
*bucket lattice* (:mod:`repro_torch.runtime.buckets`) keeps the set of
built steps bounded.

Two halves, mirroring the scheduler/engine split:

* :class:`PagePool` — pure host-side bookkeeping: free list, per-page
  refcounts, and the **prefix index**: a chain hash per *full* prompt
  page (digest of all tokens up to and including that page), mapping to
  the resident page holding those rows.  A new prompt whose leading full
  pages hash-match maps them into its page table with a refcount bump —
  no prefill recompute; common system prompts prefill once and fork.
  Shared pages are *full* pages: writes only ever happen at the growing
  tail, so a full page is immutable and sharing needs no copy-on-write
  fault path.  Eviction is page release — refcounts drop, pages return to
  the free list at zero (and leave the prefix index).
* :class:`PagedKV` — the device half: one pooled cache tree and the
  gather/commit/decode builders the engine caches per lattice point.

**Page 0 is the null page.**  Gathers pad their page tables to the
lattice width with it; whatever lies there is only ever read through
positions the attention mask zeroes exactly, so the padding is value-safe
without per-request branches.

Correctness invariant (pinned by the differential tests): greedy output
is token-identical to the unpaged runtime.  The gathered view is shorter
than ``max_len`` but masked positions carry exactly-zero probabilities,
and a shared prefix page holds bit-identical KV to what prefill would
recompute (same tokens, same absolute positions, same params).

The port of ``repro.runtime.pages``.  :class:`PagePool` is the JAX
package's, line for line (its replays are pinned against it).
:class:`PagedKV` keeps the port's cache layout: the pool is
:func:`~repro_torch.models.transformer.init_cache` with its batch axis
standing for pages and its token axis ``page_size`` rows, so a gather of
``P`` pages per row is one ``index_select`` along that axis and a reshape
of ``(rows·P, page_size)`` into ``(rows, P·page_size)``: exactly the
runtime's slot-stacked cache (one ``length`` per row) that
:func:`~repro_torch.models.transformer.decode_step` takes, where the JAX
package ``vmap``s batch-1 views.  Commits write in place: a decode step's
one new row per request, a prefill's own pages.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.models.transformer import init_cache
from repro_torch.models.tree import tree_map
from repro_torch.obs import trace as _trace

__all__ = ["NULL_PAGE", "PagePool", "PagedKV", "PoolExhausted"]

#: reserved scratch page: pads page tables up to the lattice width.
NULL_PAGE = 0


class PoolExhausted(RuntimeError):
    """No free page — the caller decides who to preempt."""


# =========================================================== host bookkeeping
class PagePool:
    """Free list + refcounts + prefix index for a pool of KV pages.

    ``n_pages`` counts the whole pool including the reserved null page,
    so ``usable == n_pages - 1``.  ``max_rows`` caps how many cache rows
    one request may ever hold (the engine passes ``max_len``).
    ``metrics``, when given, is a
    :class:`repro_torch.runtime.metrics.ServingMetrics` that receives
    ``on_page_alloc`` / ``on_page_release`` / ``on_prefix_hit`` events.
    """

    def __init__(self, n_pages: int, page_size: int, *,
                 max_rows: int | None = None, prefix_sharing: bool = True,
                 metrics=None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if n_pages < 2:
            raise ValueError(
                f"pool needs the null page plus at least one usable page, "
                f"got n_pages={n_pages}"
            )
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.max_rows = (int(max_rows) if max_rows is not None
                         else (self.n_pages - 1) * self.page_size)
        self.prefix_sharing = bool(prefix_sharing)
        self.metrics = metrics
        # LIFO free list (recently-released pages are cache-warm); the
        # null page is never in it
        self._free = list(range(self.n_pages - 1, NULL_PAGE, -1))
        self.refcount: dict[int, int] = {}     # allocated pages only
        self._hash_to_page: dict[str, int] = {}
        self._page_hash: dict[int, str] = {}
        # counters (also surfaced via stats())
        self.page_allocs = 0
        self.page_releases = 0
        self.prefix_hits = 0
        self.prefix_shared_pages = 0
        self.prefix_shared_tokens = 0
        self.admission_blocks = 0

    # ------------------------------------------------------------- geometry
    @property
    def usable(self) -> int:
        return self.n_pages - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    def pages_for(self, rows: int) -> int:
        """Pages needed to hold ``rows`` cache rows."""
        return -(-int(rows) // self.page_size)

    def required_pages(self, prompt_len: int) -> int:
        """Pages a request must hold at admission: the prompt plus the
        first decode row (capped at ``max_rows`` — a prompt of exactly
        ``max_rows`` is legal, the cache-length cap evicts before any
        out-of-range write)."""
        return self.pages_for(min(int(prompt_len) + 1, self.max_rows))

    # ------------------------------------------------------------ alloc/free
    def alloc(self, n: int, *, rid: int | None = None) -> list[int]:
        """Pop ``n`` fresh pages (refcount 1 each), or raise
        :class:`PoolExhausted` without allocating any."""
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} page(s), {len(self._free)} free "
                f"(pool of {self.usable})"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self.refcount[p] = 1
        self.page_allocs += n
        if self.metrics is not None:
            self.metrics.on_page_alloc(n)
        if n and _trace.enabled():
            _trace.instant("page_alloc", "pages", rid=rid, n=n,
                           free=len(self._free))
        return pages

    def release(self, pages: list[int], *, rid: int | None = None) -> int:
        """Drop one reference per page; pages hitting refcount zero
        return to the free list and leave the prefix index.  Returns the
        number of pages actually freed."""
        freed = 0
        for p in pages:
            rc = self.refcount[p] - 1
            if rc:
                self.refcount[p] = rc
                continue
            del self.refcount[p]
            h = self._page_hash.pop(p, None)
            if h is not None and self._hash_to_page.get(h) == p:
                del self._hash_to_page[h]
            self._free.append(p)
            freed += 1
        self.page_releases += freed
        if self.metrics is not None and freed:
            self.metrics.on_page_release(freed)
        if pages and _trace.enabled():
            _trace.instant("page_release", "pages", rid=rid, n=len(pages),
                           freed=freed, free=len(self._free))
        return freed

    # --------------------------------------------------------- prefix index
    def _chain_hashes(self, prompt) -> list[str]:
        """One digest per *full* prompt page; digest ``i`` covers every
        token up to and including page ``i`` (chain hashing), so a hash
        match implies the whole leading prefix matches."""
        arr = np.ascontiguousarray(np.asarray(prompt, np.int32))
        h = hashlib.sha256()
        out = []
        for i in range(len(arr) // self.page_size):
            h.update(arr[i * self.page_size:(i + 1) * self.page_size].tobytes())
            out.append(h.hexdigest())
        return out

    def match_prefix(self, hashes: list[str], prompt_len: int) -> list[int]:
        """Resident pages matching the prompt's leading full pages.

        Capped so at least one prompt token is left to prefill: the
        first token's logits come from the prefill of the un-shared
        remainder, so a fully-resident prompt still prefills its last
        page."""
        if not self.prefix_sharing:
            return []
        shareable = (int(prompt_len) - 1) // self.page_size
        pages = []
        for h in hashes[:shareable]:
            p = self._hash_to_page.get(h)
            if p is None:
                break
            pages.append(p)
        return pages

    def can_admit(self, prompt) -> bool:
        """Would :meth:`try_admit` succeed right now?  Pure inspection —
        nothing is allocated and no counter moves (``admit_now`` uses it
        to refuse before enqueueing)."""
        plen = len(prompt)
        hashes = self._chain_hashes(prompt) if self.prefix_sharing else []
        shared = self.match_prefix(hashes, plen)
        return self.required_pages(plen) - len(shared) <= self.n_free

    def try_admit(self, state) -> bool:
        """Reserve pages for a request at admission, sharing what it can.

        Maps hash-matching resident prefix pages into ``state.pages``
        (refcount bump, zero recompute), allocates private pages for the
        remainder of ``prompt_len + 1`` rows, and records the chain
        hashes for :meth:`register` at prefill commit.  Returns False —
        allocating nothing — when the pool lacks the private pages."""
        prompt = state.request.prompt
        plen = len(prompt)
        hashes = self._chain_hashes(prompt) if self.prefix_sharing else []
        shared = self.match_prefix(hashes, plen)
        need = self.required_pages(plen) - len(shared)
        if need > self.n_free:
            self.admission_blocks += 1
            return False
        for p in shared:
            self.refcount[p] += 1
        state.pages = shared + self.alloc(need, rid=state.rid)
        state.shared_tokens = len(shared) * self.page_size
        state.page_hashes = hashes
        if shared:
            self.prefix_hits += 1
            self.prefix_shared_pages += len(shared)
            self.prefix_shared_tokens += state.shared_tokens
            if self.metrics is not None:
                self.metrics.on_prefix_hit(len(shared), state.shared_tokens)
            if _trace.enabled():
                _trace.instant("page_share", "pages", rid=state.rid,
                               n=len(shared), tokens=state.shared_tokens)
        return True

    def register(self, state) -> None:
        """Publish a request's *full prompt pages* into the prefix index
        (called once, when its prefill commits).  Full prompt pages are
        immutable — decode writes land at row ``prompt_len`` and beyond
        — so later prompts may map them directly.

        A hash already indexed is *re-pointed* at the newer copy: two
        requests admitted in the same tick prefill the same prefix into
        private pages (neither could share — the index fills at commit,
        after both were admitted), and if the older copy kept the index
        entry, its release would empty the index while the newer copy
        sat resident and unfindable.  Latest-registrant-wins keeps the
        entry on the page most likely to outlive it; the release guard
        (`_hash_to_page.get(h) == p`) makes the de-indexed older copy's
        retirement a no-op on the index."""
        if not self.prefix_sharing:
            return
        n_full = len(state.request.prompt) // self.page_size
        for h, p in zip(state.page_hashes[:n_full], state.pages):
            old = self._hash_to_page.get(h)
            if old == p:
                continue
            self._hash_to_page[h] = p
            self._page_hash[p] = h
            if old is not None and self._page_hash.get(old) == h:
                del self._page_hash[old]

    # -------------------------------------------------------------- summary
    def stats(self) -> dict:
        """Flat counters for the metrics registry (``pages`` source)."""
        used = self.usable - self.n_free
        return {
            "page_size": self.page_size,
            "pages_total": self.usable,
            "pages_free": self.n_free,
            "pages_in_use": used,
            "pool_occupancy": used / self.usable if self.usable else 0.0,
            "page_allocs": self.page_allocs,
            "page_releases": self.page_releases,
            "prefix_hits": self.prefix_hits,
            "prefix_shared_pages": self.prefix_shared_pages,
            "prefix_shared_tokens": self.prefix_shared_tokens,
            "prefix_index_size": len(self._hash_to_page),
            "admission_blocks": self.admission_blocks,
        }


# ============================================================== device half
def _leaf_token_axis(a, b):
    """Token axis of one cache leaf, found by differencing the shapes of
    two ``init_cache`` widths; ``-1`` marks a length leaf (no token
    axis).  Raises for state that cannot be paged (SSM recurrent state
    has no token axis and is not a length scalar)."""
    diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
    if not diffs:
        if not a.dtype.is_floating_point and a.ndim <= 1:
            return -1  # per-layer / top-level "length" scalar
        raise ValueError(
            f"cache leaf of shape {tuple(a.shape)} has no token axis — "
            f"SSM/hybrid recurrent state cannot be paged"
        )
    if len(diffs) != 1:
        raise ValueError(f"ambiguous token axis for leaf {tuple(a.shape)}/{tuple(b.shape)}")
    return diffs[0]


def _merged(shape, ax):
    """``shape`` with its axes ``ax - 1`` (rows or pages) and ``ax``
    (tokens) merged into one."""
    return shape[:ax - 1] + (shape[ax - 1] * shape[ax],) + shape[ax + 1:]


class PagedKV:
    """The pooled device cache and its gather/commit/decode steps.

    ``pool`` is ``init_cache(cfg, n_pages, page_size)``: every KV leaf's
    batch axis (the axis before its token axis) indexes pages, so one page
    table describes a request's rows in every layer at once.  The builders
    return callables the engine caches in its
    :class:`~repro_torch.runtime.buckets.BucketTable` keyed by the
    page-count lattice point ``P`` (views are ``P * page_size`` rows
    wide).  Tables and lengths are tensors on the pool's device.
    """

    def __init__(self, cfg, n_pages: int, page_size: int, dtype=None, *, device="cuda"):
        self.cfg = cfg
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        one = init_cache(cfg, 1, page_size, dtype, device="meta")
        two = init_cache(cfg, 1, 2 * page_size, dtype, device="meta")
        #: token axis per leaf, -1 = length
        self.axes = tree_map(_leaf_token_axis, one, two)
        self.pool = init_cache(cfg, self.n_pages, self.page_size, dtype, device=device)

    # ---------------------------------------------------------------- views
    def _gather(self, tables, length):
        """Cache views of ``tables`` (``(B, P)`` page ids, null-padded):
        every KV leaf ``B`` rows of ``P * page_size``; every length leaf
        ``length``: a ``(B,)`` tensor, one per row, or an ``int``, one for
        all rows as in :func:`init_cache`'s form."""
        B, P = tables.shape
        flat = tables.reshape(-1)

        def g(leaf, ax):
            if ax < 0:
                if isinstance(length, int):
                    return torch.full(leaf.shape, length, dtype=leaf.dtype,
                                      device=leaf.device)
                shape = leaf.shape + (B,)
                return length.to(leaf.dtype).reshape((1,) * leaf.ndim + (B,)).expand(shape)
            x = leaf.index_select(ax - 1, flat)             # (.., B·P, ps, ..)
            return x.reshape(leaf.shape[:ax - 1] + (B, P * self.page_size)
                             + leaf.shape[ax + 1:])

        return tree_map(g, self.pool, self.axes)

    def build_view(self, P: int):
        """Batch-1 view builder (prefill staging): a request's pages
        (``(P,)``, null-padded) as a dense cache of ``P * page_size`` rows
        in :func:`init_cache`'s form, its length the shared prefix's."""
        def fn(table, length: int):
            return self._gather(table.reshape(1, P), length)

        return fn

    def build_commit(self, P: int):
        """Prefill commit: re-cut a staged batch-1 cache of ``P *
        page_size`` rows into pages and write pages ``first`` onward of
        the request's ``pages`` into the pool.  The pages before ``first``
        hold a shared prefix the prefill only read."""
        ps = self.page_size

        def fn(stage, pages, first: int):
            n = pages.shape[0]

            def c(pool_leaf, stage_leaf, ax):
                if ax < 0:
                    return                    # lengths live host-side
                st = stage_leaf.reshape(stage_leaf.shape[:ax - 1] + (P, ps)
                                        + stage_leaf.shape[ax + 1:])
                pool_leaf.index_copy_(ax - 1, pages[first:],
                                      st.narrow(ax - 1, first, n - first).to(pool_leaf.dtype))

            tree_map(c, self.pool, stage, self.axes)

        return fn

    def build_decode(self, step, bucket: int, P: int):
        """Paged decode for one ``(slot-bucket, page-bucket)`` lattice
        point: gather the views, run one batched ``step`` over them, write
        the single new row of every KV leaf back into its page, in place.
        Returns the logits.

        The engine pads the batch to ``bucket`` by duplicating an active
        request's (table, length, token) row — duplicates compute identical
        updates, so the row scatter is value-deterministic (same rule as
        the unpaged slot scatter)."""
        ps = self.page_size

        def fn(params, tables, lengths, toks):
            view = self._gather(tables, lengths)
            logits, new_view = step(params, view, toks)
            lengths = lengths.long()
            rows = torch.arange(bucket, device=lengths.device)
            src = rows * (P * ps) + lengths
            pages = tables[rows, lengths // ps].long()
            dst = pages * ps + lengths % ps

            def s(pool_leaf, new_leaf, ax):
                if ax < 0:
                    return
                # (.., n_pages·ps, ..): a view, so the copy lands in the pool
                flat = pool_leaf.view(_merged(pool_leaf.shape, ax))
                new = new_leaf.reshape(_merged(new_leaf.shape, ax)).index_select(ax - 1, src)
                flat.index_copy_(ax - 1, dst, new.to(flat.dtype))

            tree_map(s, self.pool, new_view, self.axes)
            return logits

        return fn
