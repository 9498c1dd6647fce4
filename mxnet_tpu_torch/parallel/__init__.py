"""Parallelism (the counterpart of ``mxnet_tpu/parallel/``).  Ported so
far: worker liveness (:mod:`~mxnet_tpu_torch.parallel.health`), which the
elastic loop polls.  Meshes, collectives, the launcher, the ring and the
pipeline wait for the port on ``torch.distributed``."""
from . import health
from .health import (FailureMonitor, Heartbeat, ReconfigEvent, dead_nodes,
                     ensure_heartbeat, is_recovery, num_dead_nodes,
                     stop_heartbeat)

__all__ = ["health", "Heartbeat", "ensure_heartbeat", "stop_heartbeat",
           "dead_nodes", "num_dead_nodes", "is_recovery", "ReconfigEvent",
           "FailureMonitor"]
