"""Deterministic fault injection for the elastic subsystem (the
counterpart of ``mxnet_tpu/elastic/fault.py``).

Real failures are wall-clock events (a preempted machine stops stamping,
a process dies mid-write).  Here each is reproduced at a chosen global
step instead: the :class:`FaultInjector` rides the elastic controller's
per-step hook and fires registered actions: raise :class:`WorkerKilled`
(the kill -9 analog: the exception escapes ``fit()`` with whatever the
writer thread managed to commit), backdate a rank's heartbeat stamp
(stale-heartbeat death, no sleeping), write a fresh stamp (the worker's
return), or drop a torn step directory into a checkpoint directory (a
crash mid-save).
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["FaultInjector", "WorkerKilled"]


class WorkerKilled(RuntimeError):
    """The injected analog of the training process dying at a step."""


class FaultInjector:
    """Fire registered fault actions at exact global step numbers.

    Actions run on the loop thread at the TOP of the controller's
    per-step hook — before that step's fence checkpoint or monitor poll —
    so "kill at step N" means the checkpoint at N never happens, exactly
    like a real death."""

    def __init__(self):
        self._actions = {}
        self.fired = []

    def at_step(self, step, fn):
        """Run ``fn()`` when global step ``step`` is reached."""
        self._actions.setdefault(int(step), []).append(fn)
        return self

    def kill_at(self, step):
        """Simulate the worker dying at ``step`` (raises WorkerKilled)."""
        def _kill():
            raise WorkerKilled("fault injection: killed at step %d" % step)
        return self.at_step(step, _kill)

    def stale_heartbeat_at(self, step, directory, rank, age=1e6):
        """Backdate ``rank``'s stamp at ``step`` so the next monitor poll
        reads it as ``age`` seconds stale — deterministic death, no
        waiting for a timeout to elapse."""
        def _stale():
            path = os.path.join(directory, "worker-%d.heartbeat" % rank)
            # this process's own temporary: the ranks of a mesh inject
            # the same fault at the same step
            tmp = "%s.tmp.inject.%d" % (path, os.getpid())
            with open(tmp, "w") as f:
                json.dump({"rank": rank, "time": time.time() - age,
                           "pid": -1}, f)
            os.replace(tmp, path)
        return self.at_step(step, _stale)

    def revive_heartbeat_at(self, step, directory, rank):
        """Write a fresh stamp for ``rank`` at ``step`` (worker return)."""
        def _revive():
            from ..parallel.health import Heartbeat

            Heartbeat(directory, rank).beat()
        return self.at_step(step, _revive)

    def fire(self, global_step):
        """Controller hook: run (and consume) the actions for this step."""
        for fn in self._actions.pop(int(global_step), ()):
            self.fired.append(global_step)
            fn()

    @staticmethod
    def torn_checkpoint(directory, step):
        """Create an UNCOMMITTED step directory — the debris of a crash
        mid-save (no commit marker, no DCP metadata).
        ``checkpoint.latest_step`` must skip it."""
        path = os.path.join(os.path.abspath(directory), str(step))
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "shard-0.partial"), "w") as f:
            f.write("torn mid-write\n")
        return path
