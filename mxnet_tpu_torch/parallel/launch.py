"""Multi-process launcher (the counterpart of
``mxnet_tpu/parallel/launch.py``) on ``torch.distributed``.

Every process is a worker; :func:`init` forms the process group.  The
reference's environment contract carries over unchanged:
``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT`` (default 9091) give the
coordinator's address, ``DMLC_NUM_WORKER`` the world size and
``DMLC_WORKER_ID`` (or ``DMLC_RANK``) the rank.  Without them,
torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
take the place of the reference's pod-metadata path; failing those the
process stays a single process with no group, as the reference's does.

The backend follows the device: NCCL for a rank that owns a card (rank
``r`` takes card ``LOCAL_RANK``, else ``r`` modulo the cards), gloo on
the CPU.  Ranks that share one card pass ``backend="gloo"`` (NCCL takes
one card a rank); gloo's ``all_reduce`` and ``broadcast`` take CUDA
tensors.  A backend that cannot start raises: there is no fallback.
"""
from __future__ import annotations

import datetime
import os

import torch

from ..base import MXNetError

__all__ = ["init", "shutdown", "backend_for", "DEFAULT_TIMEOUT"]

DEFAULT_TIMEOUT = 300.0     # seconds a collective waits for a dead peer

_initialized = False


def _env_contract():
    """``(address, world, rank)`` from the DMLC_* variables, else from
    torchrun's, else None."""
    env = os.environ
    if "DMLC_PS_ROOT_URI" in env:
        return ("%s:%s" % (env["DMLC_PS_ROOT_URI"],
                           env.get("DMLC_PS_ROOT_PORT", "9091")),
                int(env.get("DMLC_NUM_WORKER", "1")),
                int(env.get("DMLC_WORKER_ID", env.get("DMLC_RANK", "0"))))
    if "MASTER_ADDR" in env and "WORLD_SIZE" in env and "RANK" in env:
        return ("%s:%s" % (env["MASTER_ADDR"],
                           env.get("MASTER_PORT", "29500")),
                int(env["WORLD_SIZE"]), int(env["RANK"]))
    return None


def backend_for(backend=None):
    """The backend a rank of this process takes: ``backend`` when given,
    else NCCL where there is a card and gloo where there is none."""
    if backend is not None:
        return backend
    return "nccl" if torch.cuda.is_available() else "gloo"


def init(coordinator_address=None, num_processes=None, process_id=None,
         backend=None, timeout=DEFAULT_TIMEOUT):
    """Form the process group (idempotent once a group has formed).
    ``coordinator_address`` is ``host:port``; with none given the
    environment decides (see the module's docstring), and without one
    the process stays single: a later call with arguments still forms
    its group."""
    global _initialized
    import torch.distributed as dist

    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return
    if coordinator_address is None:
        contract = _env_contract()
        if contract is None:
            return                      # a single process, no group
        coordinator_address, num_processes, process_id = contract
    world = int(num_processes if num_processes is not None else 1)
    rank = int(process_id if process_id is not None else 0)
    backend = backend_for(backend)
    if not dist.is_available():
        raise MXNetError("torch.distributed is not available in this "
                         "build of PyTorch")
    if backend == "nccl":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise MXNetError("the NCCL backend needs a CUDA card and an "
                             "NCCL build of PyTorch; pass backend='gloo' "
                             "to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    try:
        dist.init_process_group(
            backend, init_method="tcp://" + coordinator_address,
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
    except Exception as exc:
        raise MXNetError("process group (%s, rank %d of %d at %s) did not "
                         "start: %s" % (backend, rank, world,
                                        coordinator_address, exc)) from exc
    _initialized = True


def shutdown():
    """Destroy the process group (a rank whose peer died leaves with
    ``os._exit`` instead: destroying would wait on the dead rank)."""
    global _initialized
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
