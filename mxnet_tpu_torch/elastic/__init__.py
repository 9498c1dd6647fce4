"""Elastic training: async fenced checkpoints, deterministic resume and
the liveness protocol (the counterpart of ``mxnet_tpu/elastic/``, one
device).

* **Async fenced checkpoints** (:class:`Checkpointer`): at a step fence
  the training store (parameters, aux states, optimizer slots, metric
  accumulators) is cloned on the card behind the step, and a writer
  thread copies the clones to the host on a side stream and lands a
  committed ``torch.distributed.checkpoint`` step directory (at most one
  write in flight; crash-safe commit order via
  ``checkpoint.commit_step``).
* **Deterministic resume**: the fence's sidecar carries the epoch and
  step, the generators' states, the optimizer's update counts, the
  metric sums and the iterator cursor, so a killed and restarted
  ``fit()`` ends where the uninterrupted run ends.
* **Liveness** (:class:`~mxnet_tpu_torch.parallel.health.FailureMonitor`
  + :class:`ElasticController`): a heartbeat-declared dead rank drains
  the loop at the next fence and raises; re-forming the mesh on the
  survivors waits for the port of ``parallel/mesh.py``.

Wiring: pass an :class:`ElasticController` to ``fit(..., elastic=...)``,
or set ``MXNET_CKPT_DIR`` + ``MXNET_CKPT_PERIOD`` and ``fit`` arms one
itself (:func:`from_env`).  :class:`FaultInjector` drives the failures
deterministically (kill at step N, stale heartbeat, torn write).
"""
from ..parallel.health import FailureMonitor, ReconfigEvent
from .checkpointer import Checkpointer
from .controller import ElasticController, ReconfigureSignal, from_env
from .fault import FaultInjector, WorkerKilled

__all__ = ["Checkpointer", "ElasticController", "ReconfigureSignal",
           "FailureMonitor", "ReconfigEvent", "FaultInjector",
           "WorkerKilled", "from_env"]
