"""The elastic controller: ``fit()``'s fault-tolerance sidecar (the
counterpart of ``mxnet_tpu/elastic/controller.py``).

``fit`` drives it through four hooks (all no-ops without a controller):
``attach`` once before the epoch loop (auto-resume from the latest
committed fence), ``on_epoch_start`` per epoch (mid-epoch fast-forward
and metric restore when resuming), ``on_step`` per dispatched step
(fault injection, the periodic fence checkpoint, the failure monitor's
poll: on a liveness transition it drains the dispatched steps and raises
:class:`ReconfigureSignal`), and ``handle_reconfigure`` when that signal
unwinds the epoch: it re-forms the mesh on the survivors, restores the
last committed fence re-sharded onto it and returns the epoch ``fit``
continues from.

A worker is a heartbeat stamp; workers map to ranks by the reference's
arithmetic (``parallel.mesh.rank_devices`` / ``survivor_submesh``) over
the process group's ranks as ``fit`` found them, so a worker owns whole
data rows of ranks (in one process with no group, over the module's
contexts, as the reference maps them over its devices).  On a
transition the survivors release the module's hold on the group, abandon
it (``parallel.launch.abandon``: no collective with a dead peer) and
form the next rendezvous generation (``parallel.launch.reform``, a
``FileStore`` under the heartbeat directory keyed by the generation and
the member ranks, renumbered in survivor order; a survivor alone keeps
no group and trains on the single-process path, its step captured).
Each member writes the generation's record (``gen-<g>.json``: members
and mesh) first.  A rank that is not among the survivors stands by: it
waits for a generation whose members include it (a regrow: it then
restores the same fence as every member) or for the survivors' ``done``
record (``fit`` then returns on it).  Every re-form restores the last
committed fence, the step agreed by one broadcast.

A real death: a collective whose peer is gone raises (gloo: "Connection
closed by peer"); under a controller with a monitor ``fit`` turns such
an error into a poll (:meth:`ElasticController.signal_after_fault`):
the rank abandons its group first (which fails the collectives its live
peers are blocked in, so they poll too) and polls until the dead
worker's stamp reads dead: at once for a process of this host that is
gone, else within the monitor's timeout; no transition within
``timeout + 2`` seconds re-raises the error.
"""
from __future__ import annotations

import logging
import os
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
        # the FULL roster as fit found it: regrow re-forms over it
        self._full_contexts = None
        self._full_mesh_config = None
        self._world = None        # the group's size at attach (None: none)
        self._orig_rank = 0       # this process's rank at attach
        self._members = None      # original ranks of the current group
        self._generation = 0      # rendezvous generation
        self.left = False         # this rank left the mesh for good
        self._rejoined = False    # a replacement that joined a generation
        self.last_reform = None   # seconds of the last re-form's parts

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
        self._roster(module)
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
            # a replacement restores the fence the survivors agree on, in
            # the same collectives
            meta = ck.restore(module, step=self._agreed_step(ck)
                              if self._rejoined else None)
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

    # ------------------------------------------------------------------
    # the elastic mesh
    # ------------------------------------------------------------------
    def _roster(self, module):
        """The full roster, once: the module's contexts and mesh config,
        and the process group's size and this process's rank."""
        from ..parallel import collectives, launch

        if self._full_contexts is not None:
            return
        self._full_contexts = list(module._contexts)
        self._full_mesh_config = module._mesh_config
        rec = launch.rejoined(take=True)
        if rec is not None:
            # a replacement: the roster it started with, the generation
            # it joined
            self._world, self._orig_rank = rec["world"], rec["rank"]
            self._members = list(rec["members"])
            self._generation = int(rec["generation"])
            self._rejoined = True
        elif collectives.active():
            self._world = collectives.world_size()
            self._orig_rank = collectives.rank()
            self._members = list(range(self._world))
        if self._world is not None and self.monitor is not None:
            # the others read this worker's stamp too: when they read it
            # dead, this rank must stand down with them
            self.monitor.watch_self = True

    def _ranks_of(self, workers):
        """``(original ranks, MeshConfig)`` of the mesh over ``workers``."""
        from ..parallel import mesh as mesh_mod

        cfg = self._full_mesh_config or mesh_mod.MeshConfig(data=-1)
        return mesh_mod.survivor_submesh(
            list(range(self._world)), self.monitor.num_workers, workers, cfg)

    def _join(self, module, members, cfg):
        """Form generation ``self._generation`` over ``members`` (original
        ranks) and rebind the module on it."""
        from ..parallel import launch

        t0 = time.perf_counter()
        launch.reform(self.monitor.directory, self._generation, members,
                      members.index(self._orig_rank))
        t1 = time.perf_counter()
        self._members = list(members)
        module.reconfigure(self._full_contexts,
                           cfg if len(members) > 1 else None)
        return t1 - t0, time.perf_counter() - t1

    def _stand_by(self):
        """This rank is not among the survivors: wait for a generation
        that takes it back (its members, its mesh) or for the survivors'
        ``done`` record (None).  The module keeps nothing of the group."""
        from ..parallel import launch
        from ..parallel.mesh import MeshConfig

        log.warning("elastic: rank %d is not among the survivors; standing "
                    "by for a regrow", self._orig_rank)
        directory, gen = self.monitor.directory, self._generation
        while True:
            if launch.read_record(directory, "done", gen) is not None:
                return None
            rec = launch.read_record(directory, "gen", gen + 1)
            if rec is None:
                time.sleep(0.05)
                continue
            gen += 1
            if self._orig_rank in rec["members"]:
                self._generation = gen
                return rec["members"], MeshConfig(**rec["mesh"])

    def signal_after_fault(self, module, message):
        """A collective failed under this controller (``fit`` calls it
        after the exception is gone): abandon the group, so the live
        peers blocked in a collective with this rank fail too, and poll
        the monitor until a transition shows.  Returns the
        :class:`ReconfigureSignal`; raises MXNetError naming ``message``
        when no worker reads dead within the monitor's timeout + 2 s."""
        from ..parallel import launch

        module.release_group()
        launch.abandon()
        bound = self.monitor.timeout + 2.0
        deadline = time.perf_counter() + bound
        while True:
            event = self.monitor.poll()
            if event is not None:
                log.warning("elastic: a collective failed (%s); the monitor "
                            "reads %s", message, event)
                return ReconfigureSignal(event)
            if time.perf_counter() > deadline:
                raise MXNetError(
                    "a collective failed (%s) and no worker's heartbeat "
                    "read dead within %.1f s" % (message, bound))
            time.sleep(0.05)

    def is_liveness_fault(self, exc):
        """Whether ``exc`` (raised out of an epoch) may be a peer's death:
        a RuntimeError (what a collective with a dead peer raises) under
        a controller with a monitor over a process group."""
        from .fault import WorkerKilled

        return self.monitor is not None and self._world is not None \
            and isinstance(exc, RuntimeError) \
            and not isinstance(exc, (WorkerKilled, MXNetError))

    def handle_reconfigure(self, module, signal, eval_metric):
        """Re-form the mesh on the survivors and restore the last fence
        (the reference's ``handle_reconfigure``).  Returns the epoch to
        resume from, or None when this rank left the mesh (the survivors
        finished without it)."""
        from .. import obs as _obs
        from .. import profiler as _prof
        from ..parallel import launch
        from ..parallel import mesh as mesh_mod

        if self.monitor is None:
            raise MXNetError("reconfiguration without a failure monitor")
        t0 = time.perf_counter()
        ck = self.checkpointer
        if ck is not None:
            try:
                ck.wait()
            except MXNetError:
                # a write the re-form interrupted never committed: the
                # fence before it is the restore point
                log.exception("elastic: the fence write in flight failed")
        event = signal.event
        num_workers = self.monitor.num_workers
        survivors = [w for w in range(num_workers)
                     if w not in set(event.dead)]
        if self._world is None:
            # one process: the workers map onto its contexts
            devs, cfg = mesh_mod.survivor_submesh(
                self._full_contexts, num_workers, survivors,
                self._full_mesh_config or mesh_mod.MeshConfig(data=-1))
            n_devices, total = len(devs), len(self._full_contexts)
        else:
            devs, cfg = self._ranks_of(survivors)
            n_devices, total = len(devs), self._world
        log.warning("elastic %s: dead=%s -> re-forming mesh on %d/%d "
                    "devices (data axis %d)", event.kind, event.dead,
                    n_devices, total, cfg.data)
        _obs.instant("elastic_" + event.kind, cat="elastic",
                     args={"dead": list(event.dead), "devices": n_devices,
                           "data_axis": int(cfg.data)})
        parts = {"kind": event.kind}
        if self._world is None:
            module.reconfigure(devs, None)
        else:
            module.release_group()
            parts["abandon_s"] = launch.abandon()
            self._generation += 1
            if self._orig_rank not in devs:
                self.recoveries += 1
                _prof.bump_recovery()
                back = self._stand_by()
                if back is None:
                    self.left = True
                    return None
                devs, cfg = back
                self._beat_returned()
                # the survivors' view from here on: the workers the
                # generation leaves out are the dead ones
                self.monitor.current_dead = set(
                    w for w in range(num_workers)
                    if not set(self._ranks_of([w])[0]) <= set(devs))
            else:
                launch.write_record(
                    self.monitor.directory, "gen", self._generation,
                    members=list(devs),
                    mesh={a: int(getattr(cfg, a)) for a in cfg.names})
            parts["rendezvous_s"], parts["rebind_s"] = self._join(
                module, list(devs), cfg)
        # the rebuilt step needs the metric re-armed
        module._bind_metric(eval_metric)
        self.recoveries += 1
        _prof.bump_recovery()
        if ck is None:
            raise MXNetError("reconfiguration without a checkpointer: the "
                             "re-formed mesh has no state to resume from")
        t1 = time.perf_counter()
        meta = ck.restore(module, step=self._agreed_step(ck))
        if meta is None:
            raise MXNetError("no committed fence checkpoint in %s to "
                             "resume the re-formed mesh from"
                             % ck.directory)
        parts["restore_s"] = time.perf_counter() - t1
        parts["total_s"] = time.perf_counter() - t0
        self.last_reform = parts
        self.global_step = int(meta["global_step"])
        self._resume_meta = meta
        # the abandoned epoch's mid-stream reset() leaves stateful-reset
        # iterators at the fresh-construction position: replay the
        # lifecycle for them as a cold resume does
        self._replay_epochs = int(meta["epoch"])
        return int(meta["epoch"])

    def _beat_returned(self):
        """A returning worker's first rank stamps its worker again (its own
        process: the stamp's pid must be a member's)."""
        from ..parallel.health import Heartbeat

        for worker in range(self.monitor.num_workers):
            if self._ranks_of([worker])[0][0] == self._orig_rank:
                Heartbeat(self.monitor.directory, worker).beat()

    def _agreed_step(self, ck):
        """The fence every member restores: the first rank's newest
        committed step, broadcast (None without a group)."""
        import torch

        from ..parallel import collectives

        step = ck.latest()
        if not collectives.active():
            return step
        t = torch.tensor([-1 if step is None else step], dtype=torch.int64)
        collectives.broadcast(t, 0)
        return None if int(t) < 0 else int(t)

    def finish(self, raise_error=True):
        """fit() teardown: join any in-flight write (its failure raised,
        or with ``raise_error=False``, fit already unwinding on another
        exception, logged); on a re-formed mesh the first member records
        ``done`` so that a rank standing by leaves."""
        if self._members is not None and not self.left \
                and self._members[0] == self._orig_rank \
                and self.monitor is not None:
            from ..parallel import launch

            launch.write_record(self.monitor.directory, "done",
                                self._generation, members=self._members)
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
    checkpoints with auto-resume.  Under a process group with
    ``MXNET_HEARTBEAT_DIR`` set, the elastic mesh is armed too: a
    :class:`~mxnet_tpu_torch.parallel.health.FailureMonitor` with one
    worker a rank, each stamping its heartbeat.  A roster of workers
    that own several ranks constructs the monitor and passes a
    controller."""
    from .. import config as _config

    directory = _config.get("MXNET_CKPT_DIR")
    if not directory or not int(_config.get("MXNET_CKPT_PERIOD")):
        return None
    from ..parallel import collectives, health, launch
    from .checkpointer import Checkpointer

    monitor = None
    hb = os.environ.get("MXNET_HEARTBEAT_DIR")
    if hb and collectives.active():
        # a replacement counts by the roster it started with, not by the
        # generation it joined
        rec = launch.rejoined()
        rank, world = (rec["rank"], rec["world"]) if rec is not None else \
            (collectives.rank(), collectives.world_size())
        health.ensure_heartbeat(hb, rank)
        monitor = health.FailureMonitor(hb, num_workers=world, my_rank=rank)
    return ElasticController(checkpointer=Checkpointer(directory),
                             monitor=monitor)
