"""Worker liveness: heartbeats grown into a reconfiguration protocol
(the counterpart of ``mxnet_tpu/parallel/health.py``, host code only).

The reference's elastic story: ps-lite heartbeats surface
``get_num_dead_node``, restarted workers set ``is_recovery`` to skip the
startup barrier, and recovery itself is a manual resume from epoch
checkpoints.  This module keeps that surface (a heartbeat registry over
a shared directory, ``num_dead_nodes``, ``is_recovery`` from the
environment) and the liveness half of the elastic protocol: a
:class:`FailureMonitor` polled at step fences turns heartbeat
transitions (a rank going stale, a dead rank returning) into
:class:`ReconfigEvent` s for the training loop.

The stamp files are the JAX package's (``worker-<rank>.heartbeat``: JSON
``{rank, time, pid}``, and the ``.heartbeat-epoch`` marker), so a stamp
written by either package reads the same in the other.  The port's loop
drains and stops at such an event: re-forming a device mesh on the
survivors waits for the port of ``parallel/mesh.py``.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
import weakref

__all__ = ["Heartbeat", "ensure_heartbeat", "stop_heartbeat",
           "num_dead_nodes", "dead_nodes", "is_recovery",
           "FailureMonitor", "ReconfigEvent",
           "DEFAULT_INTERVAL", "DEFAULT_TIMEOUT", "DEFAULT_GRACE"]

DEFAULT_INTERVAL = 2.0     # seconds between stamps
DEFAULT_TIMEOUT = 10.0     # stale-after threshold (ps-lite heartbeat
                           # timeout is likewise a few intervals)
DEFAULT_GRACE = 30.0       # missing-first-stamp allowance for workers that
                           # registered but have not stamped yet

_EPOCH_FILE = ".heartbeat-epoch"


def _stamp_path(directory, rank):
    return os.path.join(directory, "worker-%d.heartbeat" % rank)


def _ensure_epoch(directory):
    """Create-once epoch marker for the heartbeat directory; its mtime is
    the zero point the ``grace`` window for not-yet-stamped workers is
    measured from.  First creator wins (O_EXCL), so every monitor and
    worker agrees on one epoch."""
    path = os.path.join(directory, _EPOCH_FILE)
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.write(fd, b"%f\n" % time.time())
        os.close(fd)
    except FileExistsError:
        pass
    except OSError:
        return None
    try:
        return os.stat(path).st_mtime
    except OSError:
        return None


class Heartbeat:
    """Periodic liveness stamp for one worker process.

    Start on worker startup (``ensure_heartbeat`` starts one a process for a
    directory and rank); the daemon thread rewrites this rank's
    stamp file every ``interval`` seconds.  The thread is stopped by
    :meth:`stop`, by garbage collection (``__del__``), or by the module's
    ``atexit`` hook — an interpreter shutting down mid-fit must not leave
    a zombie stamper making a dead process look alive on shared storage.
    """

    def __init__(self, directory, rank, interval=DEFAULT_INTERVAL):
        self.directory = directory
        self.rank = rank
        self.interval = interval
        self._stop = threading.Event()
        self._thread = None
        os.makedirs(directory, exist_ok=True)
        _ensure_epoch(directory)

    def start(self):
        if self._thread is not None:
            return self
        if self._stop.is_set():
            # restarting after stop(): a fresh event, not a cleared one —
            # the old worker (if any straggler) keeps seeing its stop
            self._stop = threading.Event()
        self.beat()
        # the worker holds only a WEAK reference to this object: a
        # Heartbeat dropped without stop() is collected, its __del__ sets
        # the stop event, and the thread exits at the next tick — a bound
        # self._run target would pin the object (and stamp) forever
        self._thread = threading.Thread(
            target=_stamp_loop,
            args=(weakref.ref(self), self._stop, self.interval),
            daemon=True, name="mxtorch-heartbeat-%d" % self.rank)
        self._thread.start()
        return self

    def beat(self):
        """Write one stamp (atomic rename so readers never see a torn
        file)."""
        path = _stamp_path(self.directory, self.rank)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump({"rank": self.rank, "time": time.time(),
                       "pid": os.getpid()}, f)
        os.replace(tmp, path)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1)
            self._thread = None

    def __del__(self):
        # best-effort: interpreter teardown may have torn down threading
        # internals already, so never let collection raise
        try:
            self._stop.set()
        except Exception:
            pass


def _stamp_loop(ref, stop, interval):
    """Worker body for Heartbeat.start (module-level so the thread keeps
    no strong reference to the Heartbeat: GC can reclaim it)."""
    while not stop.wait(interval):
        hb = ref()
        if hb is None:
            return  # owner collected without stop(); go stale
        try:
            hb.beat()
        except OSError:
            pass  # shared dir hiccup; next beat retries
        del hb  # don't pin the owner across the sleep


# one stamping thread per (dir, rank) per process, however many callers
# ask for it; stop_heartbeat ends it process-wide
_active = {}
_active_lock = threading.Lock()


def _stop_all_heartbeats():
    """atexit: stop every process-wide stamper so a clean interpreter exit
    reads as a (soon-to-be-stale) departure, not an eternal liveness."""
    with _active_lock:
        beats = list(_active.values())
        _active.clear()
    for hb in beats:
        try:
            hb.stop()
        except Exception:
            pass


atexit.register(_stop_all_heartbeats)


def ensure_heartbeat(directory, rank, interval=DEFAULT_INTERVAL):
    """The process-wide heartbeat for (directory, rank), started on first
    use and shared by every caller in the process."""
    key = (os.path.abspath(directory), rank)
    with _active_lock:
        hb = _active.get(key)
        if hb is None:
            hb = Heartbeat(directory, rank, interval).start()
            _active[key] = hb
        return hb


def stop_heartbeat(directory, rank):
    """Stop (and forget) the process-wide heartbeat for (directory, rank)."""
    key = (os.path.abspath(directory), rank)
    with _active_lock:
        hb = _active.pop(key, None)
    if hb is not None:
        hb.stop()


def dead_nodes(directory, num_workers, timeout=DEFAULT_TIMEOUT, now=None,
               grace=0.0):
    """Ranks considered dead: stamp missing or older than ``timeout``.
    (``get_num_dead_node(node_id, timeout)`` analog, kvstore.h:235-244.)

    ``grace`` protects just-started workers: a rank whose stamp file does
    not exist yet (registered in the roster but first stamp pending) is
    NOT reported dead within ``grace`` seconds of the heartbeat
    directory's epoch marker.  A stamp that exists but is stale is always
    dead — grace covers startup, not silence."""
    now = time.time() if now is None else now
    epoch = None
    if grace > 0:
        epoch = _ensure_epoch(directory) if os.path.isdir(directory) else None
    dead = []
    for rank in range(num_workers):
        path = _stamp_path(directory, rank)
        try:
            with open(path) as f:
                stamp = json.load(f)
            if now - stamp["time"] > timeout:
                dead.append(rank)
        except FileNotFoundError:
            if epoch is not None and now - epoch <= grace:
                continue  # first stamp still pending; within grace
            dead.append(rank)
        except (OSError, ValueError, KeyError):
            dead.append(rank)
    return dead


def num_dead_nodes(directory, num_workers, timeout=DEFAULT_TIMEOUT):
    return len(dead_nodes(directory, num_workers, timeout))


def is_recovery():
    """Whether this worker is a restart (skip startup-only work like the
    initial barrier — kvstore_dist.h:39,77 ``is_recovery`` branches)."""
    return os.environ.get("MXNET_IS_RECOVERY", "0") not in ("", "0",
                                                            "false", "False")


class ReconfigEvent:
    """A liveness transition the training loop must react to.

    ``dead`` is the full current dead set; ``newly_dead`` / ``returned``
    are the deltas since the previous poll (a returned rank triggers
    regrow, a newly dead one triggers shrink)."""

    def __init__(self, dead, newly_dead, returned):
        self.dead = sorted(dead)
        self.newly_dead = sorted(newly_dead)
        self.returned = sorted(returned)

    @property
    def kind(self):
        return "shrink" if self.newly_dead else "regrow"

    def __repr__(self):
        return ("ReconfigEvent(kind=%s, dead=%s, newly_dead=%s, returned=%s)"
                % (self.kind, self.dead, self.newly_dead, self.returned))


class FailureMonitor:
    """Poll the heartbeat directory and report liveness TRANSITIONS.

    The elastic training loop calls :meth:`poll` at step fences (cheap:
    ``num_workers`` stat/read calls, no device work).  The first poll
    establishes the baseline dead set; every later poll returns a
    :class:`ReconfigEvent` when the set changed — rank(s) newly stale
    (shrink the mesh) or previously-dead rank(s) stamping again (regrow) —
    and None when nothing moved.  ``my_rank`` is never reported dead to
    itself: a worker that cannot see its own stamp has a storage problem,
    not a liveness one.
    """

    def __init__(self, directory, num_workers, my_rank=0,
                 timeout=None, grace=None):
        from .. import config as _config

        self.directory = directory
        self.num_workers = num_workers
        self.my_rank = my_rank
        self.timeout = float(_config.get("MXNET_ELASTIC_TIMEOUT")
                             if timeout is None else timeout)
        self.grace = float(_config.get("MXNET_ELASTIC_GRACE")
                           if grace is None else grace)
        self.current_dead = None   # unknown until the first poll
        os.makedirs(directory, exist_ok=True)
        _ensure_epoch(directory)

    def poll(self, now=None):
        dead = set(dead_nodes(self.directory, self.num_workers,
                              timeout=self.timeout, now=now,
                              grace=self.grace))
        dead.discard(self.my_rank)
        from .. import obs as _obs

        _obs.registry.gauge(
            "mx_dead_workers",
            "ranks the failure monitor currently reads as dead").set(
                len(dead))
        if self.current_dead is None:
            # the first poll is NOT a free pass: a rank that died between
            # launch and the first fence (e.g. while step 0 compiled) must
            # shrink now, not become an invisible baseline whose eventual
            # return fires a regrow for a shrink that never happened.
            # Workers that merely haven't stamped yet are covered by the
            # grace window, not by baseline adoption.
            self.current_dead = dead
            if dead:
                event = ReconfigEvent(dead, dead, set())
                _obs.instant("heartbeat_" + event.kind, cat="elastic",
                             args={"dead": event.dead,
                                   "newly_dead": event.newly_dead,
                                   "returned": event.returned})
                return event
            return None
        if dead == self.current_dead:
            return None
        prev, self.current_dead = self.current_dead, dead
        event = ReconfigEvent(dead, dead - prev, prev - dead)
        # the liveness transition itself (the controller marks the mesh
        # re-form separately — a transition can also be observed by
        # monitors outside a training loop)
        _obs.instant("heartbeat_" + event.kind, cat="elastic",
                     args={"dead": event.dead,
                           "newly_dead": event.newly_dead,
                           "returned": event.returned})
        return event
