"""Refcounted page allocator with admission reservations.

One global page-id space covers every attention node's pool (the pools all
have the same page count, so a single id addresses the page in each of
them — the vLLM block-table convention).  Page 0 is reserved as the
scratch page: unmapped table entries point at it and masked writes are
redirected into it, so it is never allocated.

Two invariants the serving loop leans on:

* **Refcounts are ownership.**  ``ref == 1`` means exactly one holder
  (a slot, or the prefix cache) — writable in place.  ``ref > 1`` means
  shared — the manager forks (copy-on-write) before any append touches
  it.  ``decref`` to zero returns the page to the free list.
* **Reservations are admission control.**  ``reserve(n)`` succeeds only
  while ``available()`` (free minus already-reserved) covers ``n``; a
  request is admitted only after its whole worst-case page budget
  (prompt tail + generation cap + one fork) is
  reserved, so decode can never strand a half-served request — pool
  pressure shows up as requests WAITING in the queue (backpressure), and
  the queue drains as retirements free pages.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError

__all__ = ["PageAllocator"]


class PageAllocator:
    """Free list + refcounts + reservations over ``num_pages`` page ids
    (ids 1..num_pages-1 allocatable; id 0 is the scratch page)."""

    def __init__(self, num_pages):
        self.num_pages = int(num_pages)
        if self.num_pages < 2:
            raise MXNetError("page pool needs >= 2 pages (page 0 is the "
                             "scratch page); got %d" % self.num_pages)
        # pop() hands out ascending ids (nicer to read in tests/dumps)
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._ref = np.zeros(self.num_pages, np.int64)
        self._reserved = 0
        self.peak_used = 0
        self.forks = 0          # COW fork count (manager bumps it)

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def used_pages(self):
        return self.num_pages - 1 - len(self._free)

    def available(self):
        """Pages an admission gate may still claim: free minus reserved."""
        return len(self._free) - self._reserved

    def reserve(self, n):
        """Claim ``n`` future allocations; False (and no change) if the
        unreserved free pool cannot cover them."""
        n = int(n)
        if self.available() < n:
            return False
        self._reserved += n
        return True

    def unreserve(self, n):
        self._reserved -= int(n)
        assert self._reserved >= 0, "unreserve below zero"

    def alloc(self, from_reserve=False):
        """One fresh page at refcount 1.  ``from_reserve`` spends a prior
        :meth:`reserve` claim; otherwise the page must be unreserved
        headroom.  Raises :class:`MXNetError` on exhaustion — the caller
        (manager) evicts prefix-cache pages and retries before letting
        this surface."""
        if not self._free or (not from_reserve and self.available() < 1):
            raise MXNetError(
                "KV page pool exhausted (%d pages, %d free, %d reserved) — "
                "raise MXNET_KV_POOL_PAGES or admit fewer concurrent "
                "requests" % (self.num_pages, len(self._free),
                              self._reserved))
        if from_reserve:
            self._reserved -= 1
            assert self._reserved >= 0, "allocating from an empty reserve"
        page = self._free.pop()
        self._ref[page] = 1
        self.peak_used = max(self.peak_used, self.used_pages)
        return page

    def incref(self, page):
        assert self._ref[page] > 0, "incref of a free page"
        self._ref[page] += 1

    def decref(self, page):
        """Drop one reference; returns True when the page was freed."""
        assert self._ref[page] > 0, "decref of a free page"
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(int(page))
            return True
        return False

    def refcount(self, page):
        return int(self._ref[page])

    def shared(self, page):
        """True when more than one holder references the page — a write
        must copy-on-write fork it first."""
        return self._ref[page] > 1
