"""Device context: ``cpu()`` / ``gpu(i)`` mapped onto ``torch.device``.

The port runs on the card unless a caller asks for the CPU.
:func:`resolve_device` is the one place that rule lives: an entry point
given no device takes ``cuda:0`` and raises when there is no card — it
never falls back to the CPU quietly.  ``with ctx:`` scopes the default
context of array creation and imperative ops (:func:`current_context`),
as the JAX package's ``Context`` does.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_devices",
           "resolve_device"]


class Context:
    """A device handle: ``device_type`` 'cpu' or 'gpu' plus an ordinal.
    ``with ctx:`` makes it the default context until the block ends
    (scopes nest, one stack a thread)."""

    _state = threading.local()

    def __init__(self, device_type, device_id=0):
        if device_type not in ("cpu", "gpu"):
            raise MXNetError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self):
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        if not hasattr(Context._state, "stack"):
            Context._state.stack = []
        Context._state.stack.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        Context._state.stack.pop()


def cpu(device_id=0):
    """The host context."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """A CUDA card."""
    return Context("gpu", device_id)


def num_devices(device_type="gpu"):
    """How many devices of ``device_type`` there are: the host is one
    (``"cpu"`` / ``"cpu_pinned"``), any other type counts the CUDA cards
    (the JAX package counts its accelerators, default ``"tpu"``)."""
    if device_type in ("cpu", "cpu_pinned"):
        return 1
    return torch.cuda.device_count()


def current_context():
    """The innermost ``with ctx:`` scope's context, else ``gpu(0)``.

    A deliberate difference from the JAX package, whose default is
    ``cpu(0)``: the port's entry points run on the card unless the
    caller asks for the CPU, so with no scope this is the card, and
    without a card it raises :class:`MXNetError` (as
    :func:`resolve_device` does) instead of falling back to the host."""
    stack = getattr(Context._state, "stack", None)
    if stack:
        return stack[-1]
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available for the default context; run "
            "under 'with cpu():' or pass ctx=cpu() to use the host")
    return Context("gpu", 0)


def resolve_device(device=None):
    """``torch.device`` for an entry point's ``device`` argument (a
    :class:`Context`, a ``torch.device``, a string, or None = the
    card).  A CUDA device without a card raises :class:`MXNetError`."""
    if isinstance(device, Context):
        dev = device.torch_device
    elif device is None:
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev
