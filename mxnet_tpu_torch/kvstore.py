"""KVStore — the data-parallel communication facade (the counterpart of
``mxnet_tpu/kvstore.py``).

``local`` / ``device`` / ``local_allreduce_*``: one process.  A pushed
list of values is summed on the first value's device, then the updater
runs on the sum (or the sum is stored); ``pull`` copies the stored
value out.  ``dist_sync`` / ``dist_device_sync`` / ``dist``: one process
a card (or ranks sharing a card over gloo) in the process group of
:func:`~mxnet_tpu_torch.parallel.launch.init`; ``push`` sums the value
across the processes with one ``all_reduce`` before the updater, so
every rank applies the same global gradient.  ``dist_async`` has no
counterpart in a collective and is accepted as ``dist_sync`` with a
logged deviation, as in the JAX package.

A stored value is a copy of the initial value on its device (the card
for a Module on the card): the updater updates it in place.  A Module
under ``update_on_kvstore`` hands the store its weights themselves
(:meth:`KVStore._init_shared`), so there is one copy of each.  Keys map to
updater indices by crc32 (:meth:`KVStore._str_to_int`), so every rank
and every run agrees.  A ``dist*`` store starts
:mod:`~mxnet_tpu_torch.parallel.health`'s heartbeat when
``MXNET_HEARTBEAT_DIR`` is set, and its constructor's startup barrier
rendezvouses the ranks (skipped by a restarted worker,
``MXNET_IS_RECOVERY``).
"""
from __future__ import annotations

import copy
import logging
import os
import pickle
import zlib

import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

TYPES = ("local", "device", "local_allreduce_cpu", "local_allreduce_device",
         "dist_sync", "dist_device_sync", "dist_async", "dist")


def _ensure_list(keys, vals):
    if isinstance(keys, (int, str)):
        return [keys], [vals]
    assert len(keys) == len(vals)
    return list(keys), list(vals)


class KVStore:
    """Key-value store for parameter synchronization."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._heartbeat = None
        if kv_type.startswith("dist"):
            self._start_heartbeat()
            # the dist store's constructor rendezvouses every worker,
            # unless this is a restarted worker whose peers are past it
            self.barrier(startup=True)

    def _start_heartbeat(self):
        """Liveness stamps under ``MXNET_HEARTBEAT_DIR`` (one stamping
        thread a process however many dist stores exist)."""
        directory = os.environ.get("MXNET_HEARTBEAT_DIR")
        if not directory:
            return
        from .parallel import health

        self._heartbeat = health.ensure_heartbeat(directory, self.rank)

    def close(self):
        """Stop this process's heartbeat (process-wide: every dist store
        sharing it)."""
        if self._heartbeat is not None:
            from .parallel import health

            health.stop_heartbeat(self._heartbeat.directory,
                                  self._heartbeat.rank)
            self._heartbeat = None

    def num_dead_node(self, node_id=0, timeout=None):
        """How many workers have a stale or missing heartbeat (0 without
        ``MXNET_HEARTBEAT_DIR`` or for a non-dist store)."""
        directory = os.environ.get("MXNET_HEARTBEAT_DIR")
        if not directory or not self._type.startswith("dist"):
            return 0
        from .parallel import health

        return health.num_dead_nodes(
            directory, self.num_workers,
            timeout if timeout is not None else health.DEFAULT_TIMEOUT)

    # -- core API ----------------------------------------------------------
    def init(self, key, value):
        """Store a copy of each value, on the value's device."""
        keys, vals = _ensure_list(key, value)
        for k, v in zip(keys, vals):
            if k in self._store:
                raise MXNetError("Key %s already initialized" % str(k))
            self._store[k] = v.copy() if isinstance(v, NDArray) else v

    def _init_shared(self, key, value):
        """Store ``value`` itself, not a copy: a module's weight, which
        the updater then writes in place and ``pull`` into it leaves
        be."""
        if key in self._store:
            raise MXNetError("Key %s already initialized" % str(key))
        self._store[key] = value

    def push(self, key, value, priority=0):
        """Sum each key's value(s) (a list is summed on its first value's
        device), across the processes for a dist store, then run the
        updater on the sum, or store it."""
        keys, vals = _ensure_list(key, value)
        for k, v in zip(keys, vals):
            if isinstance(v, (list, tuple)):
                merged = v[0]
                for other in v[1:]:
                    merged = merged + other.as_in_context(merged.context)
            else:
                merged = v
            merged = self._allreduce(merged)
            if self._updater is not None:
                self._updater(self._str_to_int(k), merged, self._store[k])
            else:
                with torch.no_grad():
                    self._store[k].data.copy_(merged.data)

    def pull(self, key, out=None, priority=0):
        keys, outs = _ensure_list(key, out)
        for k, o in zip(keys, outs):
            for dst in o if isinstance(o, (list, tuple)) else [o]:
                if dst is not self._store[k]:
                    self._store[k].copyto(dst)

    def _allreduce(self, arr):
        """The sum over the processes, for a dist store in a group."""
        from .parallel import collectives

        if not self._type.startswith("dist") or not collectives.active():
            return arr
        return NDArray(collectives.global_sum(arr.data))

    @staticmethod
    def _str_to_int(k):
        # crc32 is stable across processes and runs (str.__hash__ is
        # salted per interpreter), so optimizer-state indices agree
        # between workers and across save / load
        if isinstance(k, int):
            return k
        return zlib.crc32(k.encode("utf-8")) & 0x7FFFFFFF

    # -- updater / optimizer ----------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """Install the optimizer (the store's updater).  A dist store
        round-trips it through pickle, as the reference ships it to its
        servers; the bound symbol cannot cross the wire and is detached
        around the round trip (its lr / wd multiplier dicts are plain
        data)."""
        if self._type.startswith("dist"):
            clone = copy.copy(optimizer)      # never the caller's
            had_sym = hasattr(clone, "sym")
            if had_sym:
                bound_sym = clone.sym
                clone.sym = None
            optimizer = pickle.loads(pickle.dumps(clone))
            if had_sym:
                optimizer.sym = bound_sym
        from .optimizer import get_updater

        self._optimizer = optimizer
        self.set_updater(get_updater(optimizer))

    # -- cluster topology --------------------------------------------------
    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        from .parallel import collectives

        return collectives.rank() if self._type.startswith("dist") else 0

    @property
    def num_workers(self):
        from .parallel import collectives

        return collectives.world_size() if self._type.startswith("dist") \
            else 1

    def barrier(self, startup=False):
        """Global barrier.  A restarted worker (``MXNET_IS_RECOVERY=1``)
        skips startup barriers only: its peers are past them."""
        if startup:
            from .parallel.health import is_recovery

            if is_recovery():
                return
        if self.num_workers > 1:
            from .parallel import collectives

            collectives.barrier()

    _barrier = barrier

    def save_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot save states for distributed training")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states for distributed training")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    def send_command_to_servers(self, head, body):
        logging.debug("kvstore command %s ignored (no parameter server: "
                      "every process is a worker)", head)

    _send_command_to_servers = send_command_to_servers


def create(name="local"):
    """A KVStore of type ``name``: local | device | local_allreduce_cpu |
    local_allreduce_device | dist_sync | dist_device_sync | dist_async |
    dist.  ``dist_async`` runs as ``dist_sync`` (logged)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in TYPES:
        raise MXNetError("Unknown KVStore type %s" % name)
    if name == "dist_async":
        logging.warning("dist_async has no collective counterpart; using "
                        "synchronous all-reduce semantics (documented "
                        "deviation)")
    return KVStore(name)
