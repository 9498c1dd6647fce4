"""Monitor — per-op output statistics for debugging (NaN hunting), the
port of ``mxnet_tpu/monitor.py``.

Installed on an executor (``Module.install_monitor``), a Monitor's tap
sees every node's outputs by name during a collecting batch (one in
``interval``, armed by ``tic``); ``toc`` also samples every argument
array whose name matches.  Statistics are computed on the arrays'
device as the forward runs and read back to the host at ``toc``.  An
executor runs a collecting forward eagerly (the tap needs every
intermediate), and a monitored Module trains without its compiled step.
"""
from __future__ import annotations

import logging
import math
import re

import numpy as np
import torch

from .ndarray import NDArray

__all__ = ["Monitor"]


def _default_stat(x):
    """The norm over the square root of the size: scale-aware, and NaN
    propagates."""
    t = x.data
    return NDArray((torch.linalg.vector_norm(t)
                    / math.sqrt(t.numel())).reshape(1))


class _Tap:
    """The executor's callback: the monitor's observation and whether it
    is collecting (``active``)."""

    def __init__(self, monitor):
        self._monitor = monitor

    def __call__(self, name, array):
        self._monitor._observe(name, array)

    @property
    def active(self):
        return self._monitor._collecting


class Monitor:
    """Collects ``(step, name, stat)`` records during monitored batches.

    Parameters
    ----------
    interval : int
        Batches between collections.
    stat_func : callable, optional
        NDArray -> NDArray (or a list of them) statistic; the default is
        the norm over the square root of the size.
    pattern : str
        Regular expression the tensor names must match.
    sort : bool
        Order each ``toc``'s records by name.
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func or _default_stat
        self.sort = sort
        self._matches = re.compile(pattern).match
        self._records = []
        self._step = 0
        self._collecting = False
        self._executors = []

    def install(self, exe):
        """Put this monitor's tap on an executor."""
        exe.set_monitor_callback(_Tap(self))
        self._executors.append(exe)

    def _observe(self, name, array):
        if self._collecting and self._matches(name):
            self._records.append((self._step, name, self.stat_func(array)))

    def tic(self):
        """Before a batch: arms collection every ``interval`` steps."""
        if self._step % self.interval == 0:
            self._records = []
            self._collecting = True
        self._step += 1

    def toc(self):
        """After the batch: samples the matching argument arrays, disarms,
        and returns ``[(step, name, rendered stat)]``."""
        if not self._collecting:
            return []
        for exe in self._executors:
            for name, arr in zip(exe._symbol.list_arguments(),
                                 exe.arg_arrays):
                if self._matches(name):
                    self._records.append(
                        (self._step, name, self.stat_func(arr)))
        self._collecting = False
        records = sorted(self._records, key=lambda r: r[1]) if self.sort \
            else list(self._records)
        self._records = []
        return [(step, name, self._render(stat))
                for step, name, stat in records]

    def toc_print(self):
        """``toc`` and log each record."""
        for step, name, rendered in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, rendered)

    @staticmethod
    def _render(stat):
        values = stat if isinstance(stat, list) else [stat]
        parts = []
        for v in values:
            host = v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)
            parts.append(str(host.item()) if host.size == 1 else str(host))
        return "\t".join(parts)
