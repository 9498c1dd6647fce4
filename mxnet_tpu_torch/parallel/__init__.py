"""Parallelism (the counterpart of ``mxnet_tpu/parallel/``) on
``torch.distributed``: the launcher (:mod:`~mxnet_tpu_torch.parallel.
launch`, one process a card), the collectives the ``dist_*`` KVStore
reduces through and the tensor-parallel ones
(:mod:`~mxnet_tpu_torch.parallel.collectives`), device meshes
(:mod:`~mxnet_tpu_torch.parallel.mesh`), the Megatron plan
(:mod:`~mxnet_tpu_torch.parallel.tp_rules`) and its realization on one
rank (:mod:`~mxnet_tpu_torch.parallel.tp_exec`, what a Module with a
``mesh_config`` and a mesh ``DecodePredictor`` run), the GPipe pipeline
over a pipe group (:mod:`~mxnet_tpu_torch.parallel.pipeline`, what a
``PipelineModule`` runs), ring attention over a seq group
(:mod:`~mxnet_tpu_torch.parallel.ring`, what a Module's attention runs
under a ``seq`` axis, kernels C, D and E a hop), the ``shard_map`` shim
over a mesh of ranks (:mod:`~mxnet_tpu_torch.parallel.compat`), and
worker liveness (:mod:`~mxnet_tpu_torch.parallel.health`), which the
elastic loop polls."""
from . import collectives
from . import compat
from . import health
from . import launch
from . import mesh
from . import pipeline
from . import ring
from . import tp_exec
from . import tp_rules
from .health import (FailureMonitor, Heartbeat, ReconfigEvent, dead_nodes,
                     ensure_heartbeat, is_recovery, num_dead_nodes,
                     stop_heartbeat)
from .mesh import MeshConfig, build_mesh, data_parallel_mesh
from .compat import shard_map
from .pipeline import pipeline_apply, stack_stage_params
from .ring import ring_attention

__all__ = ["collectives", "compat", "shard_map", "launch", "mesh",
           "tp_rules", "tp_exec", "ring", "ring_attention",
           "pipeline", "pipeline_apply", "stack_stage_params",
           "build_mesh",
           "data_parallel_mesh", "MeshConfig", "health", "Heartbeat",
           "ensure_heartbeat", "stop_heartbeat", "dead_nodes",
           "num_dead_nodes", "is_recovery", "ReconfigEvent",
           "FailureMonitor"]
