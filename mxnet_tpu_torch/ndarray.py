"""NDArray — a ``torch.Tensor`` on a device context.

The part of ``mxnet_tpu/ndarray.py`` that ``Module`` and ``io`` use:
:class:`NDArray` with ``shape``, ``dtype``, ``context``, ``asnumpy``,
``copyto`` and whole-array assignment, plus :func:`array` and
:func:`zeros`.  Unlike the JAX package's immutable arrays, an NDArray's
tensor is updated in place where that saves a copy (optimizer steps,
parameter loads); :meth:`NDArray._set_data` rebinds it.

New arrays live in host memory unless a context is given, as MXNet's
``nd.array`` does; ``Module`` moves each batch onto its own device.
``.params`` file I/O is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .context import Context

__all__ = ["NDArray", "array", "zeros"]

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.int8): torch.int8,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.bool_): torch.bool}


def torch_dtype(dtype):
    """A torch dtype from a numpy dtype, its name, or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None:
        return torch.float32
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return _NP_TO_TORCH[np.dtype(dtype)]


def _device(ctx):
    """A torch device from a :class:`Context` or a torch device; None is
    host memory."""
    if ctx is None:
        return torch.device("cpu")
    return ctx.torch_device if isinstance(ctx, Context) else torch.device(ctx)


class NDArray:
    """An n-dimensional array: a torch tensor plus its context."""

    __slots__ = ("_data",)

    def __init__(self, data):
        self._data = data

    @property
    def data(self):
        """The underlying ``torch.Tensor``."""
        return self._data

    def _set_data(self, new_data):
        self._data = new_data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy scalar type (``bfloat16`` stays a torch dtype)."""
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return torch.empty((), dtype=self._data.dtype).numpy().dtype.type

    @property
    def context(self):
        """The :class:`Context` of the tensor's device."""
        dev = self._data.device
        return Context("cpu") if dev.type == "cpu" \
            else Context("gpu", dev.index or 0)

    def asnumpy(self):
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def copyto(self, other):
        """Copy into ``other``, an NDArray written in place."""
        other[:] = self
        return other

    def __setitem__(self, key, value):
        if not (isinstance(key, slice) and key == slice(None)):
            raise NotImplementedError("NDArray assignment takes [:] only")
        if isinstance(value, NDArray):
            value = value.data
        with torch.no_grad():
            if isinstance(value, torch.Tensor):
                self._data.copy_(value)
            else:
                self._data.copy_(torch.as_tensor(np.asarray(value)))

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(s) for s in self.shape),
                                     self.context)


def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array`` (numpy, tensor or
    NDArray) on ``ctx`` (a Context or torch device; host memory when
    None); float64 becomes float32 unless ``dtype`` says otherwise."""
    if isinstance(source_array, NDArray):
        src = source_array.data.detach()
    elif isinstance(source_array, torch.Tensor):
        src = source_array.detach()
    else:
        arr = np.asarray(source_array)
        if dtype is None and arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        src = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None:
        src = src.to(torch_dtype(dtype))
    return NDArray(src.to(_device(ctx), copy=True))


def zeros(shape, ctx=None, dtype=None):
    """An NDArray of zeros on ``ctx`` (a Context or torch device; host
    memory when None)."""
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))
