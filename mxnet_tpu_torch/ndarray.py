"""NDArray — a ``torch.Tensor`` on a device context.

The part of ``mxnet_tpu/ndarray.py`` that ``Module`` and ``io`` use:
:class:`NDArray` with ``shape``, ``ndim``, ``size``, ``dtype``,
``context``, ``asnumpy``, ``copyto``, basic indexing (a view) and
whole-array assignment, plus :func:`array`, :func:`zeros`,
:func:`concatenate`, and :func:`save` / :func:`load` in the JAX
package's ``.params`` format.  Unlike the JAX package's immutable arrays, an
NDArray's tensor is updated in place where that saves a copy (optimizer
steps, parameter loads); :meth:`NDArray._set_data` rebinds it.

New arrays live in host memory unless a context is given, as MXNet's
``nd.array`` does; ``Module`` moves each batch onto its own device.
"""
from __future__ import annotations

import io
import struct

import numpy as np
import torch

from .base import MXNetError
from .context import Context

__all__ = ["NDArray", "array", "zeros", "concatenate", "save", "load"]

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
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

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

    def __getitem__(self, key):
        """Basic indexing (ints and slices): a view of the same
        storage."""
        return NDArray(self._data[key])

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


def concatenate(arrays, axis=0, always_copy=True):
    """One NDArray joining ``arrays`` along ``axis``, on the first one's
    device."""
    if not arrays:
        raise MXNetError("concatenate needs at least one array")
    return NDArray(torch.cat([a.data for a in arrays], dim=axis))


# ---------------------------------------------------------------------------
# .params files: the JAX package's MXTPU001 format (mxnet_tpu/ndarray.py
# :410-470): magic, count, then per array its name, dtype string, shape
# and raw little-endian bytes.  bfloat16 is written under its own dtype
# string as the raw 16-bit patterns (numpy has no bfloat16 here).
# ---------------------------------------------------------------------------

_MAGIC = b"MXTPU001"


def _raw(value):
    """(dtype string, shape, bytes) of an NDArray, tensor or array."""
    if isinstance(value, NDArray):
        value = value.data
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), \
                t.view(torch.int16).numpy().tobytes()
        value = t.numpy()
    npy = np.ascontiguousarray(np.asarray(value))
    return str(npy.dtype), npy.shape, npy.tobytes()


def save(fname, data):
    """Write an NDArray, a list of them or a ``{name: NDArray}`` dict
    (tensors and numpy arrays are taken too) to ``fname``."""
    if not isinstance(data, (dict, list, tuple)):
        data = [data]
    if isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    else:
        names, arrays = [""] * len(data), list(data)
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", len(arrays)))
        for name, arr in zip(names, arrays):
            nb = name.encode()
            dt, shape, raw = _raw(arr)
            f.write(struct.pack("<i", len(nb)))
            f.write(nb)
            f.write(struct.pack("<i", len(dt)))
            f.write(dt.encode())
            f.write(struct.pack("<i", len(shape)))
            f.write(struct.pack("<%dq" % len(shape), *shape))
            f.write(struct.pack("<q", len(raw)))
            f.write(raw)


def load(fname):
    """Host NDArrays from a ``.params`` path or an in-memory ``bytes``
    blob: a dict when the arrays are named, else a list."""
    if isinstance(fname, (bytes, bytearray, memoryview)):
        return _load_stream(io.BytesIO(bytes(fname)), "<bytes>")
    with open(fname, "rb") as f:
        return _load_stream(f, fname)


def _load_stream(f, fname):
    if f.read(8) != _MAGIC:
        raise MXNetError("Invalid NDArray file format: %s" % fname)
    (count,) = struct.unpack("<q", f.read(8))
    names, arrays = [], []
    for _ in range(count):
        (nlen,) = struct.unpack("<i", f.read(4))
        name = f.read(nlen).decode()
        (dlen,) = struct.unpack("<i", f.read(4))
        dt = f.read(dlen).decode()
        (ndim,) = struct.unpack("<i", f.read(4))
        shape = struct.unpack("<%dq" % ndim, f.read(8 * ndim)) if ndim \
            else ()
        (rawlen,) = struct.unpack("<q", f.read(8))
        raw = f.read(rawlen)
        if dt == "bfloat16":
            t = torch.from_numpy(np.frombuffer(raw, np.int16).copy()) \
                .view(torch.bfloat16).reshape(shape)
        else:
            t = torch.from_numpy(np.frombuffer(raw, np.dtype(dt))
                                 .reshape(shape).copy())
        names.append(name)
        arrays.append(NDArray(t))
    if any(names):
        return dict(zip(names, arrays))
    return arrays
