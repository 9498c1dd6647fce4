"""Host half of paged serving: the refcounted page allocator with
admission reservations, the copy-on-write prefix cache and the per-slot
page-table manager.  Copies of the JAX package's numpy-only modules; the
decode layer (:mod:`mxnet_tpu_torch.decode`) executes their plans on the
device."""
from __future__ import annotations

from .allocator import PageAllocator
from .manager import PagedKVManager
from .prefix_cache import PrefixCache

__all__ = ["PageAllocator", "PrefixCache", "PagedKVManager"]
