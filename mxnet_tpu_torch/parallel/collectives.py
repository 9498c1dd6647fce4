"""Cross-process collectives (the counterpart of
``mxnet_tpu/parallel/collectives.py``) over the process group
:func:`~mxnet_tpu_torch.parallel.launch.init` forms.

:func:`global_sum` is one ``all_reduce(SUM)``, where the reference
gathers every process's array and sums the stack: gloo has no
``all_gather`` of CUDA tensors, and the reduction order is the
backend's (a stated difference).  Both functions are the identity in a
process with no group.
"""
from __future__ import annotations

__all__ = ["global_sum", "barrier", "active", "world_size", "rank"]


def active():
    """Whether this process belongs to a process group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def world_size():
    import torch.distributed as dist

    return dist.get_world_size() if active() else 1


def rank():
    import torch.distributed as dist

    return dist.get_rank() if active() else 0


def global_sum(value):
    """The sum of ``value`` (a tensor) over every process, as a new
    tensor on ``value``'s device; ``value`` itself is left as it was."""
    import torch.distributed as dist

    if not active():
        return value
    out = value.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def barrier():
    """Wait until every process of the group gets here."""
    import torch.distributed as dist

    if not active():
        return
    dist.barrier()
