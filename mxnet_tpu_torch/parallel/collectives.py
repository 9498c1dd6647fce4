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
* :func:`seq_gather` (over a seq group): all-gather forward,
  reduce-scatter backward — where each rank uses the gathered value
  its own way (its queries against the gathered keys);
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

Ring attention's hops are :class:`RingShift` (``lax.ppermute`` by one
step around a group: every rank sends to the next rank and receives
from the previous one, over the same counted point-to-point calls;
posted at once and waited for later, so a hop's transfer can run while
the card computes) and :func:`ring_shift_grad` (posted and waited,
differentiable: the gradients travel back).

The expert exchange is :func:`all_to_all` (``lax.all_to_all(...,
tiled=True)``: ``split_dim`` cut into one block a rank, block j sent to
rank j, the blocks received concatenated along ``concat_dim`` in rank
order; counted under ``all_to_all`` with the tensor's bytes),
differentiable: the gradient is the reverse exchange (the two dims
swapped).  It is one ``all_to_all_single`` of the blocks stacked on a
new leading dim.  gloo takes CUDA tensors there (it stages them through
host memory itself, faster on the card than staging them here), though
not in the list ``all_to_all``; NCCL (one card a rank) exchanges on the card.

On abstract tensors (``meta`` ones, or the fake tensors of an export
or a shape probe) every collective returns the shape it would give and
communicates nothing: a rank's programs trace alone.
"""
from __future__ import annotations

import time

import torch

__all__ = ["global_sum", "barrier", "active", "world_size", "rank",
           "copy_to", "reduce_from", "gather_from", "scatter_to",
           "seq_gather", "sum_over", "all_gather", "all_reduce",
           "broadcast", "send", "recv", "wait_sends", "RingShift",
           "ring_shift_grad", "all_to_all", "COUNTS", "reset_counts",
           "SYNC_TIMING"]

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


def _global_rank(group, r):
    """The global rank of rank ``r`` of ``group`` (None: the default
    group, whose ranks are global)."""
    import torch.distributed as dist

    return r if group is None else dist.get_global_rank(group, r)


def _post_send(tensor, dst, tag, group):
    """``(request, buffer)`` of a send of ``tensor`` to global rank
    ``dst`` (counted under ``send``); a CUDA tensor over gloo is staged
    through a pinned host buffer first."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    buf = tensor.detach().contiguous()
    if buf.is_cuda and _gloo(group):
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf)
        buf = host
    work = dist.isend(buf, dst, group=group, tag=tag)
    _count("send", buf, time.perf_counter() - t0)
    return work, buf


class _Recv:
    """A posted receive of a ``shape`` / ``dtype`` tensor from global
    rank ``src`` (into a pinned host buffer for a CUDA ``device`` over
    gloo); :meth:`wait` returns it on ``device`` (counted under
    ``recv``: the seconds of the post and of the wait)."""

    def __init__(self, shape, dtype, device, src, tag, group):
        import torch.distributed as dist

        t0 = time.perf_counter()
        self.device = torch.device(device)
        self.staged = self.device.type == "cuda" and _gloo(group)
        self.buf = torch.empty(shape, dtype=dtype, pin_memory=self.staged,
                               device="cpu" if self.staged else self.device)
        self.work = dist.irecv(self.buf, src, group=group, tag=tag)
        self.s = time.perf_counter() - t0

    def wait(self):
        t0 = time.perf_counter()
        self.work.wait()
        out = self.buf.to(self.device, non_blocking=True) if self.staged \
            else self.buf
        _count("recv", self.buf, self.s + time.perf_counter() - t0)
        return out


def send(tensor, dst, tag=0, group=None):
    """Send ``tensor`` to global rank ``dst`` without blocking (counted
    under ``send``); the request completes by :func:`wait_sends`."""
    _PENDING.append(_post_send(tensor, dst, tag, group))


def recv(shape, dtype, device, src, tag=0, group=None):
    """A new tensor of ``shape`` received from global rank ``src``
    (blocking; counted under ``recv``)."""
    return _Recv(shape, dtype, device, src, tag, group).wait()


def wait_sends():
    """Wait for every send not yet completed."""
    while _PENDING:
        work, _ = _PENDING.pop(0)
        work.wait()


# ---------------------------------------------------------------------------
# the ring shift (ring attention's hops)
# ---------------------------------------------------------------------------

class RingShift:
    """A posted shift of ``tensors`` around ``group``: each goes to the
    next rank of the group (the previous one under ``reverse``) with its
    tag from ``tags``, and the previous rank's (the next one's) are
    received.  The receives are posted before the sends, and nothing
    blocks until :meth:`wait`, so every rank of a ring of any size may
    post its shift before it computes on the resident blocks.  For a
    group of one :meth:`wait` returns ``tensors`` themselves."""

    def __init__(self, tensors, group, tags, reverse=False):
        tensors = list(tensors)
        n = _group_size(group)
        self._out = tensors if n == 1 else None
        self._recvs, self._sends = [], []
        if n == 1:
            return
        if any(_abstract(t) for t in tensors):
            self._out = [t.new_empty(t.shape) for t in tensors]
            return
        me = _group_rank(group)
        nxt = _global_rank(group, (me + 1) % n)
        prv = _global_rank(group, (me - 1) % n)
        dst, src = (prv, nxt) if reverse else (nxt, prv)
        self._recvs = [_Recv(t.shape, t.dtype, t.device, src, tag, group)
                       for t, tag in zip(tensors, tags)]
        self._sends = [_post_send(t, dst, tag, group)
                       for t, tag in zip(tensors, tags)]

    def wait(self):
        """The received tensors (on the senders' devices), in order."""
        if self._out is None:
            self._out = [r.wait() for r in self._recvs]
            for work, _ in self._sends:
                work.wait()
        return self._out


class _RingShiftFn(torch.autograd.Function):
    """Forward: the tensors shifted forward around the ring.  Backward:
    their gradients shifted the other way, with ``grad_tags``."""

    @staticmethod
    def forward(ctx, group, tags, grad_tags, *tensors):
        ctx.group, ctx.grad_tags = group, grad_tags
        ctx.meta = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(RingShift(tensors, group, tags).wait())

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=d, device=v) if g is None else g
                 for g, (s, d, v) in zip(grads, ctx.meta)]
        back = RingShift(grads, ctx.group, ctx.grad_tags,
                         reverse=True).wait()
        return (None, None, None) + tuple(back)


def ring_shift_grad(tensors, group, tags, grad_tags):
    """``tensors`` (tagged ``tags``) shifted one rank forward around
    ``group`` as one differentiable step: the gradients travel back one
    rank, tagged ``grad_tags``.  A tuple; the identity for a group of
    one."""
    if _group_size(group) == 1:
        return tuple(tensors)
    return _RingShiftFn.apply(group, tuple(tags), tuple(grad_tags),
                              *tensors)


# ---------------------------------------------------------------------------
# the expert exchange
# ---------------------------------------------------------------------------

def _exchange(tensor, split_dim, concat_dim, group):
    """The tiled all-to-all of ``tensor`` over ``group`` (see
    :func:`all_to_all`), not differentiable."""
    import torch.distributed as dist

    n = _group_size(group)
    x = tensor.detach()
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    if x.shape[split_dim] % n:
        from ..base import MXNetError

        raise MXNetError("all_to_all: dim %d (%d) does not split over a "
                         "group of %d" % (split_dim, x.shape[split_dim], n))
    if n == 1:
        return x
    send = torch.stack(x.chunk(n, split_dim))      # block j goes to rank j
    if _abstract(send):
        return torch.cat(send.unbind(0), dim=concat_dim)
    recv = torch.empty_like(send)
    _timed("all_to_all", send, lambda: dist.all_to_all_single(
        recv, send, group=group))
    return torch.cat(recv.unbind(0), dim=concat_dim)   # rank i's block i-th


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _exchange(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, dy):
        split_dim, concat_dim = ctx.dims
        return (_exchange(dy, concat_dim, split_dim, ctx.group), None, None,
                None)


def all_to_all(x, split_dim, concat_dim, group):
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)`` over
    ``group``: ``x``'s ``split_dim`` cut into one equal block a rank in
    rank order, block j sent to rank j, and the blocks this rank receives
    concatenated along ``concat_dim`` in the senders' rank order.  The
    gradient is the reverse exchange.  The identity for a group of one;
    counted under ``all_to_all``."""
    if _group_size(group) == 1:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)


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


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        total = all_reduce(dy.contiguous().clone(), ctx.group)
        return _my_slice(total, ctx.dim, ctx.group), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _my_slice(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return all_gather(dy, ctx.dim, ctx.group), None, None


class _ShareGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, share):
        ctx.share = share
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dy * ctx.share, None


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


def seq_gather(x, dim, group):
    """The ranks' ``x`` concatenated along ``dim``, for a use that
    differs by rank (each attends its own queries to the gathered keys):
    the gradient is summed over ``group``, then sliced (a reduce-scatter:
    Megatron's sequence-parallel gather)."""
    if _group_size(group) == 1:
        return x
    return _SeqGather.apply(x, dim, group)


def scatter_to(x, dim, group):
    """This rank's slice of ``x`` along ``dim`` (equal blocks in rank
    order); the gradient is all-gathered."""
    if _group_size(group) == 1:
        return x
    return _ScatterTo.apply(x, dim, group)


def share_grad(x, share):
    """``x`` unchanged; its gradient times ``share`` (a value every rank
    of a group computes alike, whose gradient each rank's backward
    would otherwise count in full)."""
    return _ShareGrad.apply(x, share)


def sum_over(x, group):
    """``x`` summed over ``group`` (a data group: every rank's loss
    counts), its gradient summed too."""
    if _group_size(group) == 1:
        return x
    return _SumOver.apply(x, group)
