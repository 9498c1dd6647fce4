"""Training callbacks (the port of ``mxnet_tpu/callback.py``):
batch-end callbacks receive a ``BatchEndParam`` with ``epoch`` /
``nbatch`` / ``eval_metric``, epoch-end callbacks ``(epoch, symbol,
arg_params, aux_params)``.  Reading a metric in a callback drains its
device accumulation (the loop's only sync point for it).
"""
from __future__ import annotations

import logging
import sys
import time

__all__ = ["Speedometer", "do_checkpoint", "module_checkpoint",
           "log_train_metric", "ProgressBar"]


class _Every:
    """True once per ``n`` calls keyed on a monotonically growing counter;
    resets itself when the counter restarts (new epoch)."""

    def __init__(self, n):
        self.n = max(1, int(n))
        self._prev = None

    def ready(self, count):
        restarted = self._prev is not None and count < self._prev
        self._prev = count
        if restarted:
            return False
        return count > 0 and count % self.n == 0


def _emit_metric(prefix, metric, extra=""):
    for name, value in metric.get_name_value():
        logging.info("%s%s\tTrain-%s=%f", prefix, extra, name, value)


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving the full Module state every ``period``
    epochs (symbol + params + optionally optimizer states)."""
    gate = _Every(period)

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % gate.n == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback writing ``prefix-symbol.json`` +
    ``prefix-####.params`` every ``period`` epochs."""
    from .model import save_checkpoint

    gate = _Every(period)

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % gate.n == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the running training metric."""
    gate = _Every(period)

    def _callback(param):
        if param.eval_metric is None or not gate.ready(param.nbatch):
            return
        _emit_metric("Iter[%d] Batch[%d]" % (param.epoch, param.nbatch),
                     param.eval_metric)
        if auto_reset:
            param.eval_metric.reset()

    return _callback


class Speedometer:
    """Batch-end callback reporting throughput (samples/sec) and the
    training metric every ``frequent`` batches.  The metric is reset after
    each report, so values are per-window rather than running averages."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self._gate = _Every(frequent)
        self._window_start = None

    def __call__(self, param):
        now = time.time()
        if self._window_start is None or param.nbatch < (self._gate._prev or 0):
            self._window_start = now
        if not self._gate.ready(param.nbatch):
            return
        elapsed = max(now - self._window_start, 1e-9)
        speed = self.frequent * self.batch_size / elapsed
        head = "Epoch[%d] Batch [%d]" % (param.epoch, param.nbatch)
        if param.eval_metric is not None:
            _emit_metric(head, param.eval_metric,
                         "\tSpeed: %.2f samples/sec" % speed)
            param.eval_metric.reset()
        else:
            logging.info("%s\tSpeed: %.2f samples/sec", head, speed)
        self._window_start = now


class ProgressBar:
    """Batch-end callback drawing an in-place ASCII progress bar; useful
    for interactive runs where Speedometer logs would scroll."""

    def __init__(self, total, length=80):
        self.total = max(1, int(total))
        self.length = length

    def __call__(self, param):
        frac = min(param.nbatch / self.total, 1.0)
        done = int(self.length * frac)
        bar = "=" * done + "-" * (self.length - done)
        sys.stdout.write("[%s] %d%%\r" % (bar, int(100 * frac + 0.999)))
        sys.stdout.flush()
