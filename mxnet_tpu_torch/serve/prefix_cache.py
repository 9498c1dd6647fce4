"""Copy-on-write prefix cache keyed on token chains.

Matching prompts share K/V pages instead of re-prefilling them: the cache
maps the tokens of each page-aligned prompt prefix to the page already
holding its K/V.  Keys are the literal token tuples (collision-free; the
chains are short at serving scale and the page granularity keeps the dict
small) in two granularities:

* **full-page entries** — key = ``tokens[:i*page_tokens]`` for each full
  page a finished prefill produced; a new prompt matches the longest
  chain of full pages it starts with;
* **partial-page entries** — key = (full-page prefix, the final partial
  page's tokens); they let a prompt whose divergence point is mid-page
  still share the page holding the common tokens.  The sharer maps the
  page read-only — its first append into it copy-on-write forks it
  (refcount > 1, see ``manager.PagedKVManager.ensure``), which is also
  why entries stay valid while live slots keep generating "into" them.

Matching inside the final page is **token-level radix**: after the exact
full-page chain, the cache takes the longest common token prefix between
the remaining prompt and any stored continuation of that chain — a
partial entry OR the last page of a one-page-deeper full chain.  A
prompt that diverges *mid-page* still shares the page up to the
divergence point (the length mask hides the tail; the slot's first
write there copy-on-write forks), where the older exact-content rule
matched nothing.

Matches are capped at ``len(prompt) - 1`` tokens so at least one position
always prefills — the sampled first token needs a freshly computed
distribution (the vLLM full-hit rule).

:func:`chain_hash` digests token chains for the
``/metrics.json`` **chain summary** (:meth:`PrefixCache.summary`) the
fleet router scores hosts against (``serve.fleet``): full-page chains
export as prefix hashes, partial entries as (prefix hash, length,
content hash) — compact, content-free, and computable on both ends.

The cache holds one refcount per cached page, so retirement of the slot
that produced a page does not free it; :meth:`evict` walks LRU order and
drops entries until enough pages actually return to the free list (pages
still mapped by live slots just lose their cache ref).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np

__all__ = ["PrefixCache", "chain_hash"]


def chain_hash(tokens):
    """Stable 16-hex-char digest of a token chain — the wire spelling of
    a cached prefix in the router-facing chain summary.  Both ends (the
    host's :meth:`PrefixCache.summary` and the router's prompt scoring)
    hash through here, so a match estimate is an exact set lookup."""
    arr = np.ascontiguousarray(np.asarray(tokens, np.int64).reshape(-1))
    return hashlib.blake2b(arr.tobytes(), digest_size=8).hexdigest()


class PrefixCache:
    """Token-chain -> page map with LRU eviction and hit accounting."""

    def __init__(self, page_tokens, allocator):
        self._pt = int(page_tokens)
        self._alloc = allocator
        # key -> page id; full keys are token tuples, partial keys are
        # (full-prefix tuple, partial-tokens tuple).  One OrderedDict so
        # eviction is a single LRU walk.
        self._entries = OrderedDict()
        # full-prefix tuple -> {content tuple: key}: every stored
        # continuation of a full-page chain — partial entries (content =
        # the partial tokens) AND the final page of one-page-deeper full
        # chains (content = that page's pt tokens).  The radix frontier:
        # match() takes the longest common token prefix of the remaining
        # prompt against these contents.
        self._children = {}
        # page id -> set of keys holding it (wrap recycling invalidates
        # a page's entries through this reverse map)
        self._by_page = {}
        self.lookup_tokens = 0
        self.matched_tokens = 0
        self.lookups = 0
        self.hits = 0           # lookups that matched at least one page
        self.radix_hits = 0     # frontier matches that diverged MID-page
        # content-mutation stamp: summary() caches against it, so the
        # router's per-submission polls re-hash nothing while the cache
        # is unchanged (the PagedKVManager.version pattern)
        self._content_version = 0
        self._summary_cache = None

    @property
    def pages_held(self):
        return len(self._entries)

    @property
    def hit_rate(self):
        """Matched prompt tokens / looked-up prompt tokens — the fraction
        of prefill work the cache removed."""
        return self.matched_tokens / max(self.lookup_tokens, 1)

    @staticmethod
    def _tokens(prompt):
        return tuple(int(t) for t in np.asarray(prompt).reshape(-1))

    def _touch(self, key):
        self._entries.move_to_end(key)

    # ------------------------------------------------------------------
    def match(self, prompt):
        """Longest cached prefix of ``prompt`` (1-D int tokens).

        Returns ``(matched_len, pages)``: ``pages`` covers positions
        [0, matched_len) in order — all full pages plus at most one
        partially-read page; ``matched_len <= len(prompt) - 1`` always.
        The caller maps the pages (increfs them) or drops the result;
        the cache itself keeps its own refs either way.
        """
        toks = self._tokens(prompt)
        cap = max(len(toks) - 1, 0)
        self.lookups += 1
        self.lookup_tokens += max(cap, 0)
        pages = []
        n_full = 0
        while (n_full + 1) * self._pt <= len(toks):
            key = toks[:(n_full + 1) * self._pt]
            page = self._entries.get(key)
            if page is None:
                break
            self._touch(key)
            pages.append(page)
            n_full += 1
        matched = n_full * self._pt
        # radix extension at the frontier: the longest common TOKEN
        # prefix between the remaining prompt and any stored
        # continuation of the matched chain — a partial entry, or the
        # final page of a one-page-deeper full chain (whose exact match
        # the walk above already ruled out).  Divergence mid-page still
        # shares the page up to the divergence point; the length mask
        # hides the tail and the first write there forks (COW).
        rest = toks[matched:]
        best_lcp, best_key, best_content = 0, None, None
        for content, key in self._children.get(toks[:matched],
                                               {}).items():
            lcp = 0
            for a, b in zip(content, rest):
                if a != b:
                    break
                lcp += 1
            if lcp > best_lcp:
                best_lcp, best_key, best_content = lcp, key, content
        if best_lcp > 0:
            self._touch(best_key)
            pages.append(self._entries[best_key])
            matched += best_lcp
            if best_lcp < len(best_content):
                self.radix_hits += 1
        if matched > cap:
            # never match the whole prompt: the last token must prefill so
            # the first sampled token has a distribution.  Trimming tokens
            # may drop the final page entirely (it held only trimmed ones).
            matched = cap
            if matched <= (len(pages) - 1) * self._pt:
                pages.pop()
        if matched > 0:
            self.hits += 1
        self.matched_tokens += matched
        return matched, pages

    # ------------------------------------------------------------------
    def insert(self, prompt, prompt_len, pages):
        """Publish a finished prefill's prompt pages.

        ``pages`` are the slot's table entries covering positions
        [0, prompt_len).  Each NEW key increfs its page (the cache's own
        reference); keys already cached keep their existing page
        (first-in wins — the duplicate page stays slot-owned only).
        """
        toks = self._tokens(prompt)[:int(prompt_len)]
        n_full = len(toks) // self._pt
        for i in range(n_full):
            key = toks[:(i + 1) * self._pt]
            if key in self._entries:
                self._touch(key)
                continue
            page = pages[i]
            self._alloc.incref(page)
            self._entries[key] = page
            self._by_page.setdefault(page, set()).add(key)
            self._children.setdefault(toks[:i * self._pt],
                                      {})[key[i * self._pt:]] = key
            self._content_version += 1
        tail = toks[n_full * self._pt:]
        if tail and n_full < len(pages):
            full_key = toks[:n_full * self._pt]
            key = (full_key, tail)
            if key in self._entries:
                self._touch(key)
            else:
                page = pages[n_full]
                self._alloc.incref(page)
                self._entries[key] = page
                self._by_page.setdefault(page, set()).add(key)
                self._children.setdefault(full_key, {})[tail] = key
                self._content_version += 1

    # ------------------------------------------------------------------
    def evict(self, need_pages):
        """Drop LRU entries until ``need_pages`` pages actually freed (or
        no more are evictable).  Entries whose page is still referenced
        outside the cache (a live slot maps it) are SKIPPED: dropping
        them would lose future sharing while freeing nothing — mere
        backpressure must not drain the cache.  Returns the number
        freed."""
        freed = 0
        if need_pages <= 0:
            return 0
        for key in list(self._entries):         # LRU order
            page = self._entries.get(key)
            if page is None:
                continue
            if self._alloc.refcount(page) > 1:
                continue                        # live holder beyond us
            self._drop(key)
            if self._alloc.decref(page):
                freed += 1
            if freed >= need_pages:
                break
        return freed

    def release_page(self, page):
        """Invalidate every entry holding ``page`` and drop the cache's
        refs — the wrap-recycle path: a slot is about to overwrite the
        page in place, so its cached content is dead.  Returns the number
        of entries dropped."""
        keys = list(self._by_page.get(page, ()))
        for key in keys:
            self._drop(key)
            self._alloc.decref(page)
        return len(keys)

    def _drop(self, key):
        self._content_version += 1
        page = self._entries.pop(key)
        held = self._by_page.get(page)
        if held is not None:
            held.discard(key)
            if not held:
                del self._by_page[page]
        if len(key) == 2 and isinstance(key[0], tuple) \
                and isinstance(key[1], tuple):
            parent, content = key[0], key[1]
        else:
            parent, content = key[:len(key) - self._pt], key[-self._pt:]
        kids = self._children.get(parent)
        if kids is not None:
            kids.pop(content, None)
            if not kids:
                del self._children[parent]

    def clear(self):
        """Decref every cached page and empty the cache."""
        for key, page in list(self._entries.items()):
            self._alloc.decref(page)
        self._entries.clear()
        self._children.clear()
        self._by_page.clear()
        self._content_version += 1

    # ------------------------------------------------------------------
    def summary(self):
        """Content-free digest of the cached chains for router scoring
        (served in ``/metrics.json``): full-page chains as prefix hashes
        (:func:`chain_hash`), partial entries as (parent-prefix hash,
        partial length, content hash).  The fleet router replays the
        same hashes over an incoming prompt to estimate each host's
        longest cached chain without ever shipping token content.
        Cached against the content version — a routing burst polling an
        unchanged cache re-hashes nothing (treat the result as
        read-only)."""
        if self._summary_cache is not None \
                and self._summary_cache[0] == self._content_version:
            return self._summary_cache[1]
        full, partial = [], []
        for key in self._entries:
            if len(key) == 2 and isinstance(key[0], tuple) \
                    and isinstance(key[1], tuple):
                partial.append({"prefix": chain_hash(key[0]),
                                "len": len(key[1]),
                                "hash": chain_hash(key[1])})
            else:
                full.append(chain_hash(key))
        out = {"page_tokens": self._pt, "full": full, "partial": partial}
        self._summary_cache = (self._content_version, out)
        return out
