"""Host half of paged serving: the refcounted page allocator with
admission reservations, the copy-on-write prefix cache and the per-slot
page-table manager (copies of the JAX package's numpy-only modules; the
decode layer, :mod:`mxnet_tpu_torch.decode`, executes their plans on the
device), and above a single host:

* :mod:`~mxnet_tpu_torch.serve.swap` — restorable page records:
  preemption swap-out to host RAM and the page-migration wire format of
  prefill/decode disaggregation (one extract and one install program,
  page ids as data);
* :mod:`~mxnet_tpu_torch.serve.fleet` — the front-end :class:`Router`
  over N per-host ``DecodeServer``s: cache-aware routing on
  prefix-chain summaries (:func:`chain_hash`), dedicated
  :class:`PrefillWorker` hosts shipping committed pages, and preemption
  rehoming.
"""
from __future__ import annotations

from .allocator import PageAllocator
from .manager import PagedKVManager
from .prefix_cache import PrefixCache, chain_hash
from .swap import SwapStore, SwappedRequest

__all__ = ["PageAllocator", "PrefixCache", "PagedKVManager",
           "SwapStore", "SwappedRequest", "chain_hash"]


def __getattr__(name):
    # fleet imports obs (and through it config/metrics); keep the base
    # package import light by resolving the router layer lazily
    if name in ("FleetHost", "PrefillWorker", "Router", "match_chains"):
        from . import fleet

        return getattr(fleet, name)
    raise AttributeError(name)
