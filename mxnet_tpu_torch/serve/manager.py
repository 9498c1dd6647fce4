"""Per-slot page tables + the copy-on-write append rule.

The manager is the host brain of paged serving: it owns the
:class:`~mxnet_tpu_torch.serve.allocator.PageAllocator`, the
:class:`~mxnet_tpu_torch.serve.prefix_cache.PrefixCache` and one page-table row
per serving slot, and turns every upcoming device write into a plan the
decode layer executes:

* :meth:`gate` / :meth:`map_slot` — admission: match the prompt against
  the prefix cache, reserve the request's whole worst-case page budget
  (tail pages + generation cap + one fork), and map the matched shared
  pages.  Returns ``None`` when the pool cannot cover it — the
  serving loop keeps the request queued (backpressure) and retries after
  retirements free pages; LRU prefix-cache pages are evicted first.
* :meth:`ensure` — called before every append (chunk prefill, decode
  step) with the position range about to be written:
  allocates pages for unmapped table entries and **forks** any mapped
  page whose refcount exceeds 1 (copy-on-write — the first divergent
  write of a slot that shares a prefix).  Returns the (src, dst) page
  copies the caller must run on device BEFORE the step.
* :meth:`free_slot` — retirement: decref every mapped page (pages whose
  only other holder is the prefix cache survive for future prompts),
  release the leftover reservation.  Called the moment a request
  finishes, so the pages are available to the very next admission
  attempt.

Tables are plain numpy; the decode layer ships them to the device as data
(a few hundred int32s) whenever :attr:`version` says they changed.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from .allocator import PageAllocator
from .prefix_cache import PrefixCache

__all__ = ["PagedKVManager"]


def _pages_for(tokens, page_tokens):
    """Pages needed to hold ``tokens`` tokens."""
    return -(-int(tokens) // int(page_tokens))


class PagedKVManager:
    """Host-side paged-KV bookkeeping for ``slots`` serving slots of
    ``capacity`` tokens each (``capacity % page_tokens == 0``; the table
    ring-mods over ``capacity // page_tokens`` entries, so generation past
    capacity recycles the slot's own oldest page in place — the paged
    counterpart of the dense ring's wrap)."""

    def __init__(self, slots, capacity, page_tokens, pool_pages=0,
                 prefix_cache=True):
        self.page_tokens = int(page_tokens)
        if capacity % self.page_tokens:
            raise MXNetError(
                "paged capacity %d is not a multiple of page_tokens %d"
                % (capacity, self.page_tokens))
        self.capacity = int(capacity)
        self.slots = int(slots)
        self.pages_per_slot = self.capacity // self.page_tokens
        self.pool_pages = self.pool_sizing(slots, capacity, page_tokens,
                                           pool_pages)
        self.allocator = PageAllocator(self.pool_pages)
        self.prefix_cache = PrefixCache(self.page_tokens, self.allocator) \
            if prefix_cache else None
        # 0 = unmapped (the scratch page)
        self.tables = np.zeros((self.slots, self.pages_per_slot), np.int32)
        # bumped on every table mutation: the decode layer keys its
        # device-side copy of the tables on it, so steady-state decode
        # ticks (no page allocated, no fork) re-ship NOTHING
        self.version = 0
        self._reserve = np.zeros(self.slots, np.int64)
        # True where the slot allocated (or forked) the page itself: the
        # slot's appends land strictly PAST any published/matched
        # coverage of such a page, so in-place writes are safe even while
        # the prefix cache (or a matching slot) also references it —
        # only non-owned pages and wrap recycles fork
        self._own = np.zeros((self.slots, self.pages_per_slot), bool)

    @staticmethod
    def pool_sizing(slots, capacity, page_tokens, pool_pages=0):
        """Resolved pool page count for a serving batch: the explicit
        ``pool_pages`` when given, else the capacity-complete default
        (every slot can fill its table, plus the scratch page)."""
        if not pool_pages:
            return int(slots) * (int(capacity) // int(page_tokens)) + 1
        return int(pool_pages)

    # ------------------------------------------------------------------
    def _alloc(self, slot):
        """One page for ``slot``, spending its reservation first, then
        unreserved headroom, then evicting prefix-cache LRU pages."""
        if self._reserve[slot] > 0:
            self._reserve[slot] -= 1
            return self.allocator.alloc(from_reserve=True)
        if self.allocator.available() < 1 and self.prefix_cache is not None:
            self.prefix_cache.evict(1)
        return self.allocator.alloc()

    # admission is two-phase so the serving loop can gate BEFORE touching
    # any slot state:
    def gate(self, prompt, prompt_len, max_new, spec_k=0,
             budget_wrap_forks=True):
        """Reserve the worst-case page budget for a request; returns
        ``(matched_len, pages, reserve_n)`` or ``None`` on backpressure.
        ``pages`` are prefix-cache pages covering [0, matched_len),
        already INCREFED (pinned — the eviction a tight gate triggers
        must not free the very pages this request matched); pass them to
        :meth:`map_slot`, which takes ownership of the pin.  A failed
        gate drops the pins itself.

        ``budget_wrap_forks``: when ``max_new`` is a real cap (the
        serving loop), a generation that will wrap reserves one fork per
        matched shared page up front, so the recycle-time fork can never
        raise mid-decode.  Standalone prefill passes False — its
        generation length is unknown (``max_new`` = capacity, which
        would predict a wrap always) and the rare tight-pool wrap fork
        falls back to :meth:`ensure`'s eviction path instead.

        ``spec_k``: the serving loop's speculation width; a verify window
        makes positions up to ``spec_k + 1`` past the length writable, so
        the reservation covers them too.
        """
        prompt_len = int(prompt_len)
        matched, pages = (0, [])
        if self.prefix_cache is not None:
            matched, pages = self.prefix_cache.match(
                np.asarray(prompt).reshape(-1)[:prompt_len])
        for page in pages:
            self.allocator.incref(page)
        # pages still to allocate for the prompt itself...
        need_now = _pages_for(prompt_len, self.page_tokens) - len(pages)
        # ... plus one fork if the first tail write lands mid-page in a
        # shared page, plus the decode growth to capacity (a speculative
        # verify window reaches spec_k + 1 positions past the length)
        fork = 1 if matched % self.page_tokens else 0
        total = prompt_len + int(max_new) + int(spec_k) + 1
        if budget_wrap_forks and total > self.capacity and pages:
            fork += len(pages)
        growth = _pages_for(min(total, self.capacity), self.page_tokens) \
            - _pages_for(prompt_len, self.page_tokens)
        need = need_now + fork + growth
        if self.allocator.available() < need and self.prefix_cache is not None:
            self.prefix_cache.evict(need - self.allocator.available())
        if not self.allocator.reserve(need):
            for page in pages:
                self.allocator.decref(page)
            return None
        return matched, pages, need

    def map_slot(self, slot, pages, reserve_n):
        """Bind a gated request to ``slot``: map the matched prefix pages
        (the gate's pin becomes the slot's reference — shared until
        forked) and record the reservation."""
        row = self.tables[slot]
        assert not row.any(), "mapping into a non-empty slot %d" % slot
        for i, page in enumerate(pages):
            row[i] = page
            self._own[slot, i] = False
        self._reserve[slot] = int(reserve_n)
        self.version += 1

    # ------------------------------------------------------------------
    def gate_pages(self, need):
        """Reserve ``need`` pages for a restore (swap-in / migrated
        prefill) — the SAME admission gate a fresh prompt passes, minus
        the prefix-cache match (restored pages arrive with their
        content).  Evicts LRU prefix-cache pages first; False on
        backpressure (nothing changed)."""
        need = int(need)
        if self.allocator.available() < need and self.prefix_cache is not None:
            self.prefix_cache.evict(need - self.allocator.available())
        return self.allocator.reserve(need)

    def restore_slot(self, slot, valid, reserve_n):
        """Bind a restored request to ``slot``: allocate one fresh page
        per True entry of ``valid`` (a (pages_per_slot,) mask of the
        saved table row — ring positions matter for wrapped decodes),
        spending the :meth:`gate_pages` reservation.  All pages are
        slot-OWNED (refcount 1, private copies), so later appends never
        fork.  Returns the new table row (0 = unmapped)."""
        row = self.tables[slot]
        assert not row.any(), "restoring into a non-empty slot %d" % slot
        self._reserve[slot] = int(reserve_n)
        for i in np.flatnonzero(np.asarray(valid).reshape(-1)):
            self._reserve[slot] -= 1
            row[i] = self.allocator.alloc(from_reserve=True)
            self._own[slot, i] = True
        self.version += 1
        return row.copy()

    def slot_page_count(self, slot):
        """Mapped pages of ``slot`` (swap accounting)."""
        return int(np.count_nonzero(self.tables[slot]))

    def ensure(self, slot, lo, hi):
        """Make positions [lo, hi) of ``slot`` writable.

        Allocates unmapped table entries; copy-on-write forks a mapped
        page when the write would collide with another holder's view: a
        shared prefix page about to receive the slot's first divergent
        write (not owned), or a wrap recycle of a page other slots still
        read.  A slot's OWN page appends in place even while shared — its
        writes land past every published coverage — and a wrap recycle
        whose only other holder is the prefix cache releases the (now
        dead) cache entries instead of forking.  Returns the list of
        ``(src_page, dst_page)`` copies the caller must execute on device
        before the append runs.
        """
        copies = []
        if hi <= lo:
            return copies
        row = self.tables[slot]
        m = self.pages_per_slot
        v0 = self.version
        for ti in range(int(lo) // self.page_tokens,
                        (int(hi) - 1) // self.page_tokens + 1):
            idx = ti % m
            page = int(row[idx])
            wrapped = ti >= m
            if page == 0:
                row[idx] = self._alloc(slot)
                self._own[slot, idx] = True
                self.version = v0 + 1
                continue
            if wrapped and self.prefix_cache is not None \
                    and self.allocator.shared(page):
                # wrap recycle: this slot overwrites the page in place,
                # so its cached prompt content is dead — drop the
                # cache's refs rather than fork for a corpse
                self.prefix_cache.release_page(page)
            if not self.allocator.shared(page):
                self._own[slot, idx] = True
                continue
            if self._own[slot, idx] and not wrapped:
                continue        # in-place append past published coverage
            fresh = self._alloc(slot)
            copies.append((page, fresh))
            self.allocator.decref(page)
            row[idx] = fresh
            self._own[slot, idx] = True
            self.allocator.forks += 1
            self.version = v0 + 1
        if copies:
            from .. import obs as _obs

            _obs.registry.counter(
                "mx_cow_forks",
                "copy-on-write page forks planned").inc(len(copies))
            _obs.instant("cow_fork", cat="serve",
                         args={"slot": int(slot), "copies": len(copies)})
        return copies

    def publish(self, slot, prompt, prompt_len):
        """Insert a finished prefill's prompt pages into the prefix
        cache (no-op when the cache is disabled)."""
        if self.prefix_cache is None:
            return
        n = _pages_for(int(prompt_len), self.page_tokens)
        row = self.tables[slot]
        pages = [int(row[i]) for i in range(n)]
        if any(p == 0 for p in pages):
            return      # never published a hole (defensive)
        self.prefix_cache.insert(np.asarray(prompt).reshape(-1),
                                 prompt_len, pages)

    def free_slot(self, slot):
        """Retire ``slot`` NOW: drop its page refs (prefix-cache-held
        pages survive), zero its table row, release its reservation."""
        row = self.tables[slot]
        if row.any():
            self.version += 1
        for i in range(self.pages_per_slot):
            if row[i]:
                self.allocator.decref(int(row[i]))
                row[i] = 0
            self._own[slot, i] = False
        if self._reserve[slot]:
            self.allocator.unreserve(int(self._reserve[slot]))
            self._reserve[slot] = 0

    # ------------------------------------------------------------------
    def stats(self):
        a = self.allocator
        out = {"pool_pages": self.pool_pages,
               "used_pages": a.used_pages,
               "peak_used_pages": a.peak_used,
               "free_pages": a.free_pages,
               "cow_forks": a.forks,
               "kv_hbm_utilization": a.peak_used / max(self.pool_pages - 1,
                                                       1)}
        if self.prefix_cache is not None:
            c = self.prefix_cache
            out.update({"prefix_cache_hit_rate": c.hit_rate,
                        "prefix_cache_hits": c.hits,
                        "prefix_cache_lookups": c.lookups,
                        "prefix_cache_pages": c.pages_held})
        return out
