"""Imperative autograd on torch's autograd (counterpart of
``mxnet_tpu/autograd.py``).

The JAX package records a tape of imperative ops and replays it under
``jax.vjp``.  The port lets torch record instead:
:func:`mark_variables` makes each variable's tensor a leaf that requires
a gradient (a fresh tensor object over the same storage, so other
holders of the old tensor are untouched), ops run under torch's graph
only inside :class:`record` (outside it, under ``torch.no_grad()``),
and :func:`backward` takes ``torch.autograd.grad`` of the outputs with
respect to every marked variable and writes ("write") or adds ("add")
it into the variable's gradient buffer, in place; "null" leaves the
buffer alone.  A variable no recorded op reached takes a zero gradient,
as the reference's vjp gives.  Recording also sets the training flag
(``record(train_mode=True)``), which the ops read as ``is_train``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["is_recording", "is_training", "set_is_training",
           "mark_variables", "backward", "compute_gradient", "record",
           "train_section", "test_section", "grad_and_loss", "grad"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
        _state.variables = {}     # id(var) -> (var, grad buffer, req)
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_is_training(train_mode):
    """Set the training flag; returns the previous one."""
    st = _st()
    prev = st.training
    st.training = bool(train_mode)
    return prev


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to ``variables`` (NDArrays), with a
    gradient request each: "write", "add" or "null"."""
    st = _st()
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("unknown grad_req %r" % (req,))
        if req != "null" and var.data.is_floating_point():
            var._set_data(var.data.detach().requires_grad_(True))
        st.variables[id(var)] = (var, grad, req)


class record:
    """``with autograd.record():`` — ops inside build torch's graph, and
    the training flag is ``train_mode`` until the block ends."""

    def __init__(self, train_mode=True):
        self._train = train_mode
        self._prev = None

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        st.recording = True
        st.training = self._train
        return self

    def __exit__(self, *args):
        st = _st()
        st.recording, st.training = self._prev


class train_section(record):
    """The reference's contrib name for ``record(train_mode=True)``."""

    def __init__(self):
        super().__init__(train_mode=True)


class test_section(record):
    """The reference's contrib name for ``record(train_mode=False)``."""

    def __init__(self):
        super().__init__(train_mode=False)


def backward(outputs, out_grads=None, retain_graph=False):
    """Gradients of ``outputs`` (seeded with ones, or ``out_grads``) with
    respect to the marked variables, written or added into their
    buffers."""
    compute_gradient(outputs, out_grads, retain_graph=retain_graph)


def _grads(outs, seeds, leaves, retain_graph):
    """torch.autograd.grad over the outputs that carry a graph; a zero
    gradient for every leaf none of them reached."""
    pairs = [(o, s) for o, s in zip(outs, seeds) if o.requires_grad]
    found = [None] * len(leaves)
    if pairs and leaves:
        found = torch.autograd.grad([o for o, _ in pairs],
                                    leaves, [s for _, s in pairs],
                                    retain_graph=retain_graph,
                                    allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, found)]


def compute_gradient(outputs, out_grads=None, retain_graph=False):
    """:func:`backward`, returning the gradient buffers."""
    st = _st()
    if not st.variables:
        raise MXNetError("no variables marked for gradient")
    if not isinstance(outputs, (list, tuple)):
        outputs = [outputs]
    outs = [o.data for o in outputs]
    if out_grads is None:
        seeds = [torch.ones_like(o) for o in outs]
    else:
        if not isinstance(out_grads, (list, tuple)):
            out_grads = [out_grads]
        seeds = [g.data.to(o.device, o.dtype)
                 for g, o in zip(out_grads, outs)]
    entries = list(st.variables.values())
    live = [(var, buf, req) for var, buf, req in entries
            if req != "null" and var.data.requires_grad]
    grads = _grads(outs, seeds, [var.data for var, _, _ in live],
                   retain_graph)
    with torch.no_grad():
        for (var, buf, req), g in zip(live, grads):
            if req == "add":
                buf.data.add_(g.to(buf.data.dtype))
            else:
                buf.data.copy_(g)
    return [buf for _, buf, _ in entries]


def grad_and_loss(func, argnum=None):
    """A function returning ``(gradients, loss)`` of ``func``: the
    gradients of its (summed) output with respect to the arguments
    ``argnum`` names (all by default)."""
    from .ndarray import NDArray

    def wrapped(*args):
        idx = range(len(args)) if argnum is None else (
            [argnum] if isinstance(argnum, int) else argnum)
        idx = list(idx)
        leaves = {i: args[i].data.detach().requires_grad_(True)
                  for i in idx}
        full = [NDArray(leaves[i]) if i in leaves else a
                for i, a in enumerate(args)]
        with record(train_mode=is_training()):
            loss = func(*full)
        out = loss.data
        grads = _grads([out], [torch.ones_like(out)],
                       [leaves[i] for i in idx], False)
        return [NDArray(g) for g in grads], NDArray(out.detach())

    return wrapped


def grad(func, argnum=None):
    """A function returning the gradients of ``func``
    (:func:`grad_and_loss` without the loss)."""
    def wrapped(*args):
        return grad_and_loss(func, argnum)(*args)[0]

    return wrapped
