"""Pipeline parallelism (the counterpart of
``mxnet_tpu/parallel/pipeline.py``): GPipe microbatching over a pipe
group of ``torch.distributed``, one stage a rank.

The schedule is the classic GPipe fill-drain: with S stages and M
microbatches, at step s in [0, M + S - 1) the rank of stage d works on
microbatch s - d (when valid), and activations move one hop a step
(:func:`~mxnet_tpu_torch.parallel.collectives.send` /
:func:`~mxnet_tpu_torch.parallel.collectives.recv`, tagged by
microbatch; a CUDA tensor over gloo goes through a pinned host buffer).

Stated differences from the reference, whose schedule is a
differentiable ``lax.scan`` over ``ppermute``:

* the reverse pipeline is explicit: each hop is a
  ``torch.autograd.Function`` whose forward sends to stage d + 1 (or
  receives from d - 1) and whose backward receives the gradient from
  d + 1 (or sends it to d - 1), so autograd of a pipelined loss runs the
  backward schedule;
* a rank skips its bubble slots, where the reference computes on zeros
  (FLOPs only: the results are the same);
* ``remat`` checkpoints each stage call (``torch.utils.checkpoint``,
  non-reentrant) where the reference checkpoints each scan step.  A
  stage that draws random numbers from a generator of its own must seed
  it from (stage, microbatch) inside the call, as the reference folds
  both into its key: the recomputation then draws the forward's masks.

Constraint (the reference's): every stage maps activations of one fixed
shape to the same shape.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import collectives as C

__all__ = ["pipeline_apply", "stack_stage_params", "Schedule"]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *items) for items in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage_params):
    """Stack a list of per-stage trees (dicts, tuples or lists of tensors
    or arrays) into one tree with a leading stage axis: the tensors a
    pipe group splits, a stage a rank."""
    return _tree_map(lambda *xs: torch.stack([torch.as_tensor(x)
                                              for x in xs]),
                     *per_stage_params)


class _SendFn(torch.autograd.Function):
    """Forward: ``x`` to the next stage; a 0-d zero joins the sender's
    graph to the receiver's.  Backward: the gradient of ``x`` from the
    next stage."""

    @staticmethod
    def forward(ctx, x, sched, tag):
        ctx.sched, ctx.tag = sched, tag
        ctx.meta = (tuple(x.shape), x.dtype, x.device)
        sched.send_next(x, tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.meta
        return ctx.sched.recv_next(shape, dtype, device, ctx.tag + 1), \
            None, None


class _RecvFn(torch.autograd.Function):
    """Forward: the activation from the previous stage.  Backward: its
    gradient back to the previous stage (the ``anchor``, a leaf of
    this rank, is where autograd enters)."""

    @staticmethod
    def forward(ctx, anchor, sched, tag, shape, dtype):
        ctx.sched, ctx.tag = sched, tag
        return sched.recv_prev(shape, dtype, anchor.device, tag)

    @staticmethod
    def backward(ctx, grad):
        ctx.sched.send_prev(grad, ctx.tag + 1)
        torch.autograd.Variable._execution_engine.queue_callback(
            C.wait_sends)
        return torch.zeros((), device=grad.device), None, None, None, None


class _BroadcastFn(torch.autograd.Function):
    """The last stage's results on every rank of the group (the
    reference's psum of the last stage's buffer).  Backward: the last
    stage takes the gradient of its results; the others start their
    reverse pipeline at ``sink``."""

    @staticmethod
    def forward(ctx, value, sink, sched):
        ctx.last = sched.is_last
        out = value.clone() if sched.is_last else value.new_empty(
            value.shape)
        C.broadcast(out, sched.ranks[-1], sched.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        if ctx.last:
            return grad, None, None
        return None, torch.ones((), device=grad.device), None


class Schedule:
    """One GPipe fill-drain over ``group`` (this rank's stage is its rank
    in the group): :meth:`run` returns the last stage's outputs (None on
    the other ranks) and keeps what a backward pass needs.

    ``anchors`` are the leaves autograd must reach for the hops'
    backwards to run (``torch.autograd.grad`` prunes branches that lead
    to none of its inputs: pass them there too), ``sink`` the 0-d
    tensor a rank that is not the last starts its backward at."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        if C.active():
            self.ranks = dist.get_process_group_ranks(group)
            self.index = dist.get_rank(group)
        else:
            self.ranks, self.index = [0], 0
        self.n = len(self.ranks)
        self.is_first = self.index == 0
        self.is_last = self.index == self.n - 1
        self.anchors = []
        self.sink = None

    # hops ------------------------------------------------------------
    def send_next(self, x, tag):
        C.send(x, self.ranks[self.index + 1], tag, self.group)

    def recv_next(self, shape, dtype, device, tag):
        return C.recv(shape, dtype, device, self.ranks[self.index + 1], tag,
                      self.group)

    def send_prev(self, x, tag):
        C.send(x, self.ranks[self.index - 1], tag, self.group)

    def recv_prev(self, shape, dtype, device, tag):
        return C.recv(shape, dtype, device, self.ranks[self.index - 1], tag,
                      self.group)

    # -----------------------------------------------------------------
    def run(self, stage_fn, params, inputs, num_microbatches, act_shape,
            act_dtype, device, remat=False):
        """The schedule: ``stage_fn(params, activation, mb_id)`` at every
        valid slot.  ``inputs(j)`` gives microbatch j on the first stage;
        the others receive theirs.  Returns the list of the last stage's
        outputs by microbatch (None elsewhere)."""
        m, d = int(num_microbatches), self.index
        grad_on = torch.is_grad_enabled()
        outs = [None] * m
        sinks = []
        for s in range(m + self.n - 1):
            j = s - d
            if not 0 <= j < m:
                continue            # a bubble slot: skipped
            if self.is_first:
                inp = inputs(j)
            elif grad_on:
                anchor = torch.zeros((), device=device, requires_grad=True)
                self.anchors.append(anchor)
                inp = _RecvFn.apply(anchor, self, 2 * j, act_shape,
                                    act_dtype)
            else:
                inp = self.recv_prev(act_shape, act_dtype, device, 2 * j)
            if remat and grad_on:
                from torch.utils.checkpoint import checkpoint

                out = checkpoint(lambda a, j=j: stage_fn(params, a, j), inp,
                                 use_reentrant=False)
            else:
                out = stage_fn(params, inp, j)
            if tuple(out.shape) != tuple(act_shape):
                raise MXNetError(
                    "stage must preserve the activation shape (got %s from "
                    "%s)" % (tuple(out.shape), tuple(act_shape)))
            if self.is_last:
                outs[j] = out
            elif grad_on and out.requires_grad:
                sinks.append(_SendFn.apply(out, self, 2 * j))
            else:
                self.send_next(out, 2 * j)
        C.wait_sends()
        if sinks:
            self.sink = torch.stack(sinks).sum()
        return outs if self.is_last else None


def pipeline_apply(stage_fn, stage_params, x, group, num_microbatches,
                   remat=False):
    """Run a stage-a-rank pipeline over the ranks of ``group``.

    Args:
      stage_fn: ``(params, activation, mb_id) -> activation`` for ONE
        stage; ``mb_id`` (an int) is the microbatch the call processes.
      stage_params: this rank's stage parameters (a tree of tensors); a
        leading stage dim of 1 is squeezed, as the reference squeezes
        its ``shard_map`` slice.
      x: the batch, microbatched on axis 0: (num_microbatches, mb, ...);
        the first stage consumes it (the others read its shape).
      group: the pipe group (a ``torch.distributed`` group; None: the
        default group).
      num_microbatches: M; the schedule runs M + S - 1 steps.
      remat: checkpoint each stage call (see the module docstring).

    Returns the pipelined output (M, mb, ...) on every rank of the group
    (broadcast from the last stage); its gradient flows back through
    the reverse pipeline on every rank.
    """
    m = int(num_microbatches)
    if x.shape[0] != m:
        raise MXNetError("x must be microbatched: (M, mb, ...), got %s for "
                         "M=%d" % (tuple(x.shape), m))
    params = _tree_map(lambda p: p.reshape(p.shape[1:])
                       if p.dim() and p.shape[0] == 1 else p, stage_params)
    sched = Schedule(group)
    outs = sched.run(stage_fn, params, lambda j: x[j], m, x.shape[1:],
                     x.dtype, x.device, remat=remat)
    if sched.n == 1:
        return torch.stack(outs)
    if sched.is_last:
        value, sink = torch.stack(outs), None
    else:
        value = x.new_empty(x.shape)
        sink = sched.sink
    if sink is None:
        sink = torch.zeros((), device=x.device)
    return _BroadcastFn.apply(value, sink, sched)
