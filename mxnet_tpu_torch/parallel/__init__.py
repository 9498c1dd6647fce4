"""Parallelism (the counterpart of ``mxnet_tpu/parallel/``) on
``torch.distributed``: the launcher (:mod:`~mxnet_tpu_torch.parallel.
launch`, one process a card), the collectives the ``dist_*`` KVStore
reduces through (:mod:`~mxnet_tpu_torch.parallel.collectives`), device
meshes (:mod:`~mxnet_tpu_torch.parallel.mesh`) and worker liveness
(:mod:`~mxnet_tpu_torch.parallel.health`), which the elastic loop polls.
The ring, the pipeline and the ``shard_map`` shim wait for the
tensor-parallel paths."""
from . import collectives
from . import health
from . import launch
from . import mesh
from .health import (FailureMonitor, Heartbeat, ReconfigEvent, dead_nodes,
                     ensure_heartbeat, is_recovery, num_dead_nodes,
                     stop_heartbeat)
from .mesh import MeshConfig, build_mesh, data_parallel_mesh

__all__ = ["collectives", "launch", "mesh", "build_mesh",
           "data_parallel_mesh", "MeshConfig", "health", "Heartbeat",
           "ensure_heartbeat", "stop_heartbeat", "dead_nodes",
           "num_dead_nodes", "is_recovery", "ReconfigEvent",
           "FailureMonitor"]
