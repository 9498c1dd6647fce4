"""Cross-process collectives (the counterpart of
``mxnet_tpu/parallel/collectives.py``) over the process group
:func:`~mxnet_tpu_torch.parallel.launch.init` forms.

:func:`global_sum` is one ``all_reduce(SUM)``, where the reference
gathers every process's array and sums the stack: gloo has no
``all_gather`` of CUDA tensors, and the reduction order is the
backend's (a stated difference).  Both functions are the identity in a
process with no group.

The tensor-parallel collectives over a model group, each a
``torch.autograd.Function`` (the collectives the reference's
partitioner inserts, placed by :mod:`~mxnet_tpu_torch.parallel.
tp_exec`):

* :func:`copy_to` (Megatron's *f*): identity forward, all-reduce
  backward — at a column-parallel segment's replicated inputs;
* :func:`reduce_from` (*g*): all-reduce forward, identity backward — at
  a row-parallel segment's partial sums;
* :func:`gather_from`: all-gather along a dim forward, this rank's slice
  backward — where a sharded activation meets an op that does not keep
  it sharded;
* :func:`scatter_to`: this rank's slice forward, all-gather backward;
* :func:`sum_over` (over a data group): all-reduce forward and backward,
  the sums that synchronized BatchNorm takes over the data axis.

Every collective call adds to :data:`COUNTS` under its kind
(``all_reduce`` / ``all_gather`` / ``broadcast``): calls, bytes (the
tensor's) and host seconds (the call blocks until the backend is done;
set :data:`SYNC_TIMING` to synchronize the card first, so the seconds
exclude queued kernels).  :func:`reset_counts` zeroes them.

An all-gather of a CUDA tensor over a gloo group (ranks that share one
card) is an all-reduce of a zero-padded buffer: each rank writes its
slice at its offset and the sum is the gathered tensor.  It moves the
whole gathered size from every rank, M times an all-gather's bytes.

The point-to-point hops of a pipeline (:func:`send` / :func:`recv`,
counted under ``send`` / ``recv``) carry a tag each; a CUDA tensor
over gloo goes through a pinned host buffer (gloo's point-to-point
calls read and write host memory only).  :func:`send` never blocks
(gloo's blocking send waits for the matching receive): its request is
kept until :func:`wait_sends`.

On abstract tensors (``meta`` ones, or the fake tensors of an export
or a shape probe) every collective returns the shape it would give and
communicates nothing: a rank's programs trace alone.
"""
from __future__ import annotations

import time

import torch

__all__ = ["global_sum", "barrier", "active", "world_size", "rank",
           "copy_to", "reduce_from", "gather_from", "scatter_to",
           "sum_over", "all_gather", "all_reduce", "broadcast", "send",
           "recv", "wait_sends", "COUNTS", "reset_counts", "SYNC_TIMING"]

COUNTS = {}
SYNC_TIMING = False


def reset_counts():
    """Zero :data:`COUNTS`."""
    COUNTS.clear()


def _count(kind, tensor, seconds):
    c = COUNTS.setdefault(kind, {"calls": 0, "bytes": 0, "s": 0.0})
    c["calls"] += 1
    c["bytes"] += tensor.numel() * tensor.element_size()
    c["s"] += seconds


def _timed(kind, tensor, fn):
    if SYNC_TIMING and tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
    t0 = time.perf_counter()
    fn()
    if SYNC_TIMING and tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
    _count(kind, tensor, time.perf_counter() - t0)


def _abstract(tensor):
    """Whether ``tensor`` holds no data (meta, or fake under a trace)."""
    from torch._guards import detect_fake_mode

    return tensor.device.type == "meta" \
        or detect_fake_mode((tensor,)) is not None


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
    if not active():
        return value
    out = value.clone()
    all_reduce(out)
    return out


def barrier():
    """Wait until every process of the group gets here."""
    import torch.distributed as dist

    if not active():
        return
    dist.barrier()


# ---------------------------------------------------------------------------
# counted primitives over a group (None: the default group)
# ---------------------------------------------------------------------------

def _group_size(group):
    import torch.distributed as dist

    return dist.get_world_size(group) if active() else 1


def _group_rank(group):
    import torch.distributed as dist

    return dist.get_rank(group) if active() else 0


def all_reduce(tensor, group=None):
    """Sum ``tensor`` over ``group`` in place (counted)."""
    import torch.distributed as dist

    if _group_size(group) == 1 or _abstract(tensor):
        return tensor
    _timed("all_reduce", tensor,
           lambda: dist.all_reduce(tensor, op=dist.ReduceOp.SUM,
                                   group=group))
    return tensor


def broadcast(tensor, src=0, group=None):
    """``tensor`` of global rank ``src`` on every rank of ``group``, in
    place (counted)."""
    import torch.distributed as dist

    if _group_size(group) == 1 or _abstract(tensor):
        return tensor
    _timed("broadcast", tensor,
           lambda: dist.broadcast(tensor, src=src, group=group))
    return tensor


def _padded_route(tensor, group):
    """Whether an all-gather of ``tensor`` over ``group`` must go as an
    all-reduce of a zero-padded buffer (gloo takes no CUDA all-gather)."""
    import torch.distributed as dist

    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(tensor, dim, group=None):
    """The ranks' ``tensor``s of ``group`` concatenated along ``dim`` in
    rank order, as a new tensor (counted: an ``all_gather`` of the
    gathered size, or an ``all_reduce`` of it on the padded route)."""
    import torch.distributed as dist

    size = _group_size(group)
    if size == 1:
        return tensor
    dim = dim % tensor.dim()
    part = tensor.contiguous()
    shape = list(part.shape)
    shape[dim] *= size
    if _abstract(part):
        return part.new_empty(shape)
    me = _group_rank(group)
    if _padded_route(part, group):
        out = torch.zeros(shape, dtype=part.dtype, device=part.device)
        out.narrow(dim, me * part.shape[dim], part.shape[dim]).copy_(part)
        _timed("all_reduce", out,
               lambda: dist.all_reduce(out, op=dist.ReduceOp.SUM,
                                       group=group))
        return out
    # gather along dim 0 of a moved view, then move the dim back
    moved = part.movedim(dim, 0).contiguous()
    flat = torch.empty((size * moved.shape[0],) + tuple(moved.shape[1:]),
                       dtype=part.dtype, device=part.device)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    _timed("all_gather", flat, lambda: gather(flat, moved, group=group))
    return flat.movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# point to point (pipeline hops)
# ---------------------------------------------------------------------------

_PENDING = []


def _gloo(group):
    import torch.distributed as dist

    return dist.get_backend(group) == "gloo"


def send(tensor, dst, tag=0, group=None):
    """Send ``tensor`` to global rank ``dst`` without blocking (counted
    under ``send``); the request completes by :func:`wait_sends`."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    buf = tensor.detach().contiguous()
    if buf.is_cuda and _gloo(group):
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf)
        buf = host
    _PENDING.append((dist.isend(buf, dst, group=group, tag=tag), buf))
    _count("send", buf, time.perf_counter() - t0)


def recv(shape, dtype, device, src, tag=0, group=None):
    """A new tensor of ``shape`` received from global rank ``src``
    (blocking; counted under ``recv``)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    device = torch.device(device)
    staged = device.type == "cuda" and _gloo(group)
    buf = torch.empty(shape, dtype=dtype, pin_memory=staged,
                      device="cpu" if staged else device)
    dist.recv(buf, src, group=group, tag=tag)
    out = buf.to(device, non_blocking=True) if staged else buf
    _count("recv", buf, time.perf_counter() - t0)
    return out


def wait_sends():
    """Wait for every send not yet completed."""
    while _PENDING:
        work, _ = _PENDING.pop(0)
        work.wait()


def _my_slice(tensor, dim, group):
    size = _group_size(group)
    n = tensor.shape[dim] // size
    return tensor.narrow(dim, _group_rank(group) * n, n).contiguous()


# ---------------------------------------------------------------------------
# the autograd functions
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return _my_slice(dy, ctx.dim, ctx.group), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _my_slice(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return all_gather(dy, ctx.dim, ctx.group), None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.clone(), ctx.group), None


def copy_to(x, group):
    """*f*: ``x`` unchanged; its gradient summed over ``group``."""
    if _group_size(group) == 1:
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """*g*: ``x`` summed over ``group``; its gradient passed through."""
    if _group_size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def gather_from(x, dim, group):
    """The ranks' ``x`` concatenated along ``dim``; the gradient is this
    rank's slice."""
    if _group_size(group) == 1:
        return x
    return _GatherFrom.apply(x, dim, group)


def scatter_to(x, dim, group):
    """This rank's slice of ``x`` along ``dim`` (equal blocks in rank
    order); the gradient is all-gathered."""
    if _group_size(group) == 1:
        return x
    return _ScatterTo.apply(x, dim, group)


def sum_over(x, group):
    """``x`` summed over ``group`` (a data group: every rank's loss
    counts), its gradient summed too."""
    if _group_size(group) == 1:
        return x
    return _SumOver.apply(x, group)
