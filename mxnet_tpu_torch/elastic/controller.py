"""The elastic controller: ``fit()``'s fault-tolerance sidecar (the
counterpart of ``mxnet_tpu/elastic/controller.py``).

``fit`` drives it through four hooks (all no-ops without a controller):
``attach`` once before the epoch loop (auto-resume from the latest
committed fence), ``on_epoch_start`` per epoch (mid-epoch fast-forward
and metric restore when resuming), ``on_step`` per dispatched step
(fault injection, the periodic fence checkpoint, the failure monitor's
poll: on a liveness transition it drains the dispatched steps and raises
:class:`ReconfigureSignal`), and ``handle_reconfigure`` when that signal
unwinds the epoch.  The JAX package re-forms its device mesh on the
survivors there; the port has one device and no mesh yet, so
``handle_reconfigure`` waits for the writer and raises
:class:`~mxnet_tpu_torch.base.MXNetError`: a mesh re-form waits for the
port of ``parallel/mesh.py`` and ``Module.reconfigure``.
"""
from __future__ import annotations

import logging
import time

from ..base import MXNetError

__all__ = ["ElasticController", "ReconfigureSignal", "from_env"]

log = logging.getLogger(__name__)


class ReconfigureSignal(Exception):
    """Raised out of the epoch body when the failure monitor reports a
    liveness transition; carries the
    :class:`~mxnet_tpu_torch.parallel.health.ReconfigEvent`.  The
    dispatched steps are drained before it is raised."""

    def __init__(self, event):
        super().__init__(str(event))
        self.event = event


def _metric_leaves(metric):
    from ..metric import DeviceMetricAccumulator

    return DeviceMetricAccumulator._flatten(metric)


class ElasticController:
    """Compose a :class:`~mxnet_tpu_torch.elastic.Checkpointer`, an
    optional :class:`~mxnet_tpu_torch.parallel.health.FailureMonitor` and
    an optional :class:`~mxnet_tpu_torch.elastic.FaultInjector` into the
    fit loop."""

    def __init__(self, checkpointer=None, monitor=None, injector=None,
                 poll_every=None):
        from .. import config as _config

        self.checkpointer = checkpointer
        self.monitor = monitor
        self.injector = injector
        self.poll_every = max(1, int(_config.get("MXNET_ELASTIC_POLL")
                                     if poll_every is None else poll_every))
        self.global_step = 0
        self.recoveries = 0
        self._resume_meta = None
        self._replay_epochs = 0   # cold resume: prior-epoch iterator replay
        self._metric = None

    # ------------------------------------------------------------------
    # fit wiring
    # ------------------------------------------------------------------
    def attach(self, module, eval_metric, begin_epoch):
        """Bind to the fitting module; auto-resume from the latest
        committed fence when the checkpointer allows it.  Returns the
        (possibly advanced) begin epoch."""
        from .. import obs as _obs
        from .. import profiler as _prof

        if getattr(module, "_exec_group", None) is None:
            raise MXNetError("elastic training needs a bound Module (its "
                             "executor-group state is what the fence "
                             "snapshots)")
        self._metric = eval_metric
        ck = self.checkpointer
        if ck is None:
            return begin_epoch
        if not ck.resume and ck.latest() is not None:
            # with resume off, this run's low-numbered fences would lose
            # every restore / prune decision to the old run's higher step
            # numbers: refuse to mix lineages
            raise MXNetError(
                "MXNET_CKPT_RESUME=0 but %s already holds committed "
                "checkpoints from a previous run; point MXNET_CKPT_DIR "
                "at a fresh directory (or clear this one) to start over"
                % ck.directory)
        if ck.resume:
            peeked = ck.peek()
            if peeked is not None and int(peeked["epoch"]) < begin_epoch:
                # a mid-epoch fence grafted onto a later epoch is a state
                # no uninterrupted run could reach
                raise MXNetError(
                    "checkpoint in %s is at epoch %d, behind the "
                    "requested begin_epoch %d; clear the directory or "
                    "lower begin_epoch" % (ck.directory,
                                           int(peeked["epoch"]),
                                           begin_epoch))
            meta = ck.restore(module)
            if meta is not None:
                self.global_step = int(meta["global_step"])
                self._resume_meta = meta
                # cold resume: the iterator is freshly built, so its
                # prior-epoch lifecycle is replayed (roll_over's reset
                # carries state)
                self._replay_epochs = int(meta["epoch"])
                self.recoveries += 1
                _prof.bump_recovery()
                _obs.instant("elastic_resume", cat="elastic",
                             args={"step": self.global_step,
                                   "epoch": int(meta["epoch"])})
                log.info("elastic resume: step %d (epoch %d, %d batches "
                         "into it) from %s", self.global_step,
                         meta["epoch"], meta["nbatch_done"], ck.directory)
                return max(begin_epoch, int(meta["epoch"]))
        if ck.latest() is None:
            # an initial fence: a failure before the first periodic one
            # still has a restore point (fresh parameters, step 0)
            ck.snapshot(module, self._meta(module, begin_epoch, 0))
        return begin_epoch

    def on_epoch_start(self, module, epoch, train_data, eval_metric):
        """Mid-epoch resume: the metric sums back to the fence's and the
        (freshly reset) iterator fast-forwarded.  Returns the batch index
        the epoch continues from (0 normally)."""
        meta, self._resume_meta = self._resume_meta, None
        if meta is None or int(meta["epoch"]) != epoch:
            return 0
        self._restore_metric(module, eval_metric, meta)
        # stateful-reset iterators (roll_over) replay each prior epoch's
        # drain and reset as the uninterrupted run did; the others reach
        # the same position from one reset and fast_forward
        replay, self._replay_epochs = self._replay_epochs, 0
        if not getattr(train_data, "reset_carries_state", False):
            replay = 0
        for _ in range(replay):
            try:
                while True:
                    train_data.next()
            except StopIteration:
                pass
            train_data.reset()
        n = int((meta.get("iterator") or {}).get("batches_done",
                                                 meta["nbatch_done"]))
        if n:
            if hasattr(train_data, "fast_forward"):
                train_data.fast_forward(n)
            else:
                for _ in range(n):
                    train_data.next()
        return n

    def on_step(self, module, epoch, nbatch, fences):
        """Once per dispatched step, on the loop thread."""
        self.global_step += 1
        step = self.global_step
        if self.injector is not None:
            # faults fire BEFORE this step's fence: "killed at N" means
            # N's checkpoint never happened, like a real death
            self.injector.fire(step)
        ck = self.checkpointer
        if ck is not None:
            ck.note_step()
            if ck.period and step % ck.period == 0:
                ck.snapshot(module, self._meta(module, epoch, nbatch + 1))
        if self.monitor is not None and step % self.poll_every == 0:
            event = self.monitor.poll()
            if event is not None:
                self._drain(fences)
                raise ReconfigureSignal(event)

    def handle_reconfigure(self, module, signal, eval_metric):
        """A liveness transition reached the loop.  The dispatched steps
        are drained; the writer is waited for.  Re-forming the mesh on
        the survivors is not ported: raises MXNetError."""
        from .. import obs as _obs

        if self.checkpointer is not None:
            self.checkpointer.wait()
        event = signal.event
        _obs.instant("elastic_" + event.kind, cat="elastic",
                     args={"dead": list(event.dead),
                           "returned": list(event.returned)})
        raise MXNetError(
            "elastic %s (dead ranks %s): re-forming the device mesh waits "
            "for the port of parallel/mesh.py and Module.reconfigure; the "
            "last committed fence in %s resumes the run"
            % (event.kind, event.dead,
               None if self.checkpointer is None
               else self.checkpointer.directory))

    def finish(self, raise_error=True):
        """fit() teardown: join any in-flight write.  Its failure is
        raised, or with ``raise_error=False`` (fit already unwinding on
        another exception) logged."""
        if self.checkpointer is None:
            return
        try:
            self.checkpointer.wait()
        except MXNetError:
            if raise_error:
                raise
            log.exception("checkpoint write failed while fit() was "
                          "unwinding; the original exception follows")

    # ------------------------------------------------------------------
    @staticmethod
    def _drain(fences):
        """Block until every dispatched step has completed: the steps run
        in order on one stream, so the newest event covers all."""
        if fences:
            from .. import profiler as _prof

            t0 = time.perf_counter()
            fences[-1].synchronize()
            _prof.record_host_wait(time.perf_counter() - t0)
            fences.clear()

    def _meta(self, module, epoch, nbatch_done):
        meta = {"epoch": int(epoch), "nbatch_done": int(nbatch_done),
                "global_step": int(self.global_step),
                "iterator": {"batches_done": int(nbatch_done)}}
        opt = getattr(module, "_optimizer", None)
        if opt is not None:
            # the update counts drive Adam's bias correction and lr
            # schedules: a replay with t reset would not be bit-identical
            meta["optimizer"] = {
                "num_update": int(opt.num_update),
                "begin_num_update": int(opt.begin_num_update),
                "index_update_count": {
                    str(k): int(v)
                    for k, v in opt._index_update_count.items()}}
        if self._metric is not None:
            # raw host sums, NOT the draining properties (reading them
            # would pull the device accumulators to the host); the device
            # half rides the snapshot as clones
            meta["metric_host"] = [
                {"sums": [float(s) for s in m._sums],
                 "counts": [float(c) for c in m._counts]}
                for m in _metric_leaves(self._metric)]
        return meta

    @staticmethod
    def _restore_metric(module, metric, meta):
        """The metric's sums back to the fence's: the host sums to the
        host, the fence's device sums into the train step's accumulators
        (they go on adding in f32 as the uninterrupted run's did, so the
        epoch's value is the same bit for bit), or, where the metric
        accumulates on the host, folded into the host sums."""
        import torch

        host = meta.get("metric_host")
        if host is None or metric is None:
            return
        leaves = _metric_leaves(metric)
        if len(leaves) != len(host):
            log.warning("checkpointed metric has %d leaves, live metric "
                        "%d; skipping metric restore", len(host),
                        len(leaves))
            return
        dev = meta.get("metric_device")
        find = getattr(module, "_device_metric", None)
        acc = find(metric) if dev and find is not None else None
        if acc is not None and [len(s) for s, _ in acc.state] != \
                [len(d[0]) for d in dev]:
            acc = None
        if acc is not None:
            with torch.no_grad():
                for (sums, counts), d in zip(acc.state, dev):
                    for t, v in zip(sums + counts, d[0] + d[1]):
                        t.fill_(v)
            acc.dirty = True
            dev = None
        dev = dev or [None] * len(leaves)
        for m, h, d in zip(leaves, host, dev):
            sums = [float(x) for x in h["sums"]]
            counts = [float(x) for x in h["counts"]]
            if d:
                # fold the fence's pending device sums as a drain would
                sums = [s + float(ds) for s, ds in zip(sums, d[0])]
                counts = [c + float(dc) for c, dc in zip(counts, d[1])]
            m._sums = sums
            m._counts = [int(c) if float(c).is_integer() else c
                         for c in counts]


def from_env():
    """An :class:`ElasticController` from the environment, or None.

    ``MXNET_CKPT_DIR`` + ``MXNET_CKPT_PERIOD`` arm fit-integrated fenced
    checkpoints with auto-resume; liveness monitoring stays explicit
    (construct a FailureMonitor and pass a controller): only the
    launcher knows the worker roster."""
    from .. import config as _config

    directory = _config.get("MXNET_CKPT_DIR")
    if not directory or not int(_config.get("MXNET_CKPT_PERIOD")):
        return None
    from .checkpointer import Checkpointer

    return ElasticController(checkpointer=Checkpointer(directory))
