"""Host-RAM page swap — the shippable state of a paged request (the
port of ``mxnet_tpu/serve/swap.py``).

When a decode host's page pool runs dry, the serving loop preempts its
lowest-priority slot: the slot's pages (quantized data + per-(token,
head) scales, gathered through ``DecodePredictor.extract_pages`` — one
captured program) move to host RAM as a :class:`SwappedRequest`, the
pages return to the pool, and the request re-queues — at the host, or at
the fleet router (``serve.fleet``), which may readmit it on ANY host:
page contents are raw pool bytes, so restore is host-agnostic.
Readmission allocates fresh pages through the normal
:meth:`~mxnet_tpu_torch.serve.manager.PagedKVManager.gate_pages`
reservation gate and scatters the saved bytes back (``install_pages``,
also one captured program) at the SAME ring positions, so a wrapped long
decode resumes bit-identically.

The same record is the wire format of **prefill/decode disaggregation**
(DistServe, Zhong et al. 2024): a dedicated prefill worker runs chunked
prefill into its own pool, extracts the committed prompt pages, and the
record — ``kind="migrate"``, carrying the chain keys via ``publish`` —
installs into the target decode host exactly like a swap-in, plus one
prefix-cache publication so later prompts match the migrated chain.

The record is numpy + ints; the decode layer executes the extract and
install programs.
"""
from __future__ import annotations

import numpy as np

__all__ = ["SwappedRequest", "SwapStore"]


def _leaves(tree):
    """The arrays of a page payload, in order: per attention node the K
    and V planes, each a data plane, or a (data, scale) pair."""
    if isinstance(tree, (tuple, list)):
        out = []
        for x in tree:
            out.extend(_leaves(x))
        return out
    return [tree]


class SwappedRequest:
    """One preempted (or migrated) request's complete restorable state.

    ``data`` is the per-attention-node nest of page contents in
    table-row order ((M, page_tokens, E) numpy per plane); ``row_valid``
    the (M,) mask of mapped ring positions; ``lens``/``tok`` the
    committed length and pending token; ``delivered`` the tokens already
    emitted to the caller (generation resumes counting toward ``cap``).

    ``kv_heads`` records the grouped-query K/V layout of the saved pages
    (None = MHA): a GQA source's page planes are H_kv head slices wide —
    G× fewer bytes on the swap/migration wire — and the readmitting host
    must run the SAME grouped layout (checked at install; raw pool bytes
    carry no head structure of their own).
    """

    __slots__ = ("prompt", "delivered", "history", "cap", "priority",
                 "lens", "tok", "row_valid", "data", "kind", "publish",
                 "submit_ts", "first_ts", "rid", "kv_heads")

    def __init__(self, prompt, delivered, history, cap, priority, lens,
                 tok, row_valid, data, kind="swap", publish=False,
                 submit_ts=None, first_ts=None, rid=None, kv_heads=None):
        self.prompt = np.asarray(prompt).reshape(-1).astype(np.int64)
        self.delivered = list(delivered)
        self.history = list(history)
        self.cap = int(cap)
        self.priority = int(priority)
        self.lens = int(lens)
        self.tok = int(tok)
        self.row_valid = np.asarray(row_valid).reshape(-1).astype(bool)
        self.data = data
        self.kind = kind            # "swap" | "migrate"
        self.publish = bool(publish)
        self.submit_ts = submit_ts
        self.first_ts = first_ts
        self.rid = rid              # the router-/host-level id it keeps
        self.kv_heads = int(kv_heads) if kv_heads else None

    @property
    def n_pages(self):
        return int(self.row_valid.sum())

    def nbytes(self):
        """Host-RAM footprint of the saved pages (swap accounting)."""
        return int(sum(np.asarray(leaf).nbytes
                       for leaf in _leaves(self.data)))


class SwapStore:
    """Bounded bookkeeping of swapped-out requests (host RAM).

    The serving loop / router parks :class:`SwappedRequest` records here
    between preemption and readmission; ``swapped_bytes`` is the live
    host-RAM bill, mirrored to the ``mx_fleet_swap_bytes`` gauge.
    """

    def __init__(self):
        self._by_rid = {}

    def put(self, record, key=None):
        """Park a record under ``key`` (default its rid; a fleet router
        keys by (host, rid) — host rids are per-server counters and may
        collide across hosts)."""
        self._by_rid[record.rid if key is None else key] = record
        self._note()
        return record

    def pop(self, key):
        rec = self._by_rid.pop(key, None)
        self._note()
        return rec

    def __len__(self):
        return len(self._by_rid)

    def swapped_bytes(self):
        return sum(rec.nbytes() for rec in self._by_rid.values())

    def _note(self):
        from .. import obs as _obs

        _obs.registry.gauge(
            "mx_fleet_swap_bytes",
            "host-RAM bytes held by swapped-out requests").set(
                self.swapped_bytes())
