"""Device meshes (the counterpart of ``mxnet_tpu/parallel/mesh.py``).

:class:`MeshConfig` names the five axes (data / model / pipe / seq /
expert) and resolves their sizes exactly as the reference does;
:func:`rank_devices` and :func:`survivor_submesh` are the same list
arithmetic over any list of devices (or contexts, or ranks).
:func:`build_mesh` returns a ``torch.distributed.device_mesh.DeviceMesh``
over the process group's ranks, one device a rank (the port's data
parallelism is one process a card), with the five axis names.  Nothing
shards through it yet: data parallelism rides the ``dist_*`` KVStore.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..base import MXNetError

__all__ = ["MeshConfig", "build_mesh", "data_parallel_mesh",
           "rank_devices", "survivor_submesh"]


@dataclass
class MeshConfig:
    """Logical mesh shape.  Axis size -1 means 'absorb remaining devices'."""

    data: int = -1     # data parallel (gradient all-reduce)
    model: int = 1     # tensor parallel
    pipe: int = 1      # pipeline stages
    seq: int = 1       # sequence / context parallel
    expert: int = 1    # expert parallel
    names: tuple = ("data", "model", "pipe", "seq", "expert")

    def resolve(self, n_devices):
        sizes = [self.data, self.model, self.pipe, self.seq, self.expert]
        fixed = 1
        for s in sizes:
            if s != -1:
                fixed *= s
        free = [i for i, s in enumerate(sizes) if s == -1]
        if free:
            assert n_devices % fixed == 0, \
                "devices %d not divisible by fixed axes %d" % (n_devices, fixed)
            rem = n_devices // fixed
            sizes[free[0]] = rem
            for i in free[1:]:
                sizes[i] = 1
        total = int(np.prod(sizes))
        assert total == n_devices, \
            "mesh %s does not cover %d devices" % (sizes, n_devices)
        return sizes


def build_mesh(config=None, devices=None):
    """A ``DeviceMesh`` from ``config`` over ``devices``, the group's
    ranks to lay out (default: every rank).  Needs the process group of
    :func:`~mxnet_tpu_torch.parallel.launch.init`; its device type is
    the group's (cuda under NCCL, cpu under gloo)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise MXNetError("build_mesh needs a process group: call "
                         "parallel.launch.init() first")
    if devices is None:
        devices = list(range(dist.get_world_size()))
    config = config or MeshConfig()
    sizes = config.resolve(len(devices))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.tensor([int(d) for d in devices]).reshape(sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(config.names))


def data_parallel_mesh(devices=None):
    return build_mesh(MeshConfig(data=-1), devices)


# ---------------------------------------------------------------------------
# Elastic reconfiguration: the 'data' axis is the worker-ownership axis —
# rank r owns a contiguous block of data-axis rows, every other axis lives
# within one worker's devices.  Shrinking drops the dead ranks' rows;
# regrowing is the same computation with the returned ranks back in.
# ---------------------------------------------------------------------------

def rank_devices(devices, num_workers, config=None):
    """Partition ``devices`` into per-rank slices along the data axis
    (row-major over (data, model, pipe, seq, expert): rank ``r`` owns
    rows ``[r*data/W, (r+1)*data/W)``).  A list of ``num_workers``
    device lists."""
    config = config or MeshConfig()
    sizes = config.resolve(len(devices))
    data = sizes[config.names.index("data")]
    if data % num_workers != 0:
        raise ValueError("data axis %d not divisible by %d workers"
                         % (data, num_workers))
    rows_per = data // num_workers
    block = len(devices) // data          # devices per data-axis row
    per = rows_per * block
    return [list(devices[r * per:(r + 1) * per]) for r in range(num_workers)]


def survivor_submesh(devices, num_workers, survivors, config=None):
    """The survivors' devices and the shrunk MeshConfig: every non-data
    axis kept, 'data' scaled to the survivors' share (the per-replica
    batch grows, the global batch stays).  Passing every rank back
    reproduces the original mesh (regrow)."""
    survivors = sorted(set(survivors))
    if not survivors:
        raise ValueError("no surviving workers to re-form the mesh on")
    config = config or MeshConfig()
    parts = rank_devices(devices, num_workers, config)
    sizes = config.resolve(len(devices))
    data = sizes[config.names.index("data")]
    rows_per = data // num_workers
    devs = []
    for r in survivors:
        if r >= num_workers:
            raise ValueError("survivor rank %d out of range (%d workers)"
                             % (r, num_workers))
        devs.extend(parts[r])
    # every axis pinned to its resolved size (a -1 must not re-absorb the
    # shrunk device count into the wrong axis)
    resolved = dict(zip(config.names, sizes))
    resolved["data"] = rows_per * len(survivors)
    return devs, replace(config, **resolved)
