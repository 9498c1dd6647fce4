"""NDArray — the imperative array type, a ``torch.Tensor`` on a device
context (counterpart of ``mxnet_tpu/ndarray.py``).

:class:`NDArray` has ``shape``, ``ndim``, ``size``, ``dtype``,
``context``, ``T``, ``asnumpy`` / ``asscalar``, ``astype``, ``copy`` /
``copyto`` / ``as_in_context``, ``reshape`` / ``broadcast_to``,
``wait_to_read``, basic indexing (a view of the same storage) with
assignment through it, and the arithmetic, reflected, in-place and
comparison operators, each of which dispatches through the op registry
(so :mod:`~mxnet_tpu_torch.autograd` sees it).  The constructors are
:func:`array`, :func:`empty`, :func:`zeros`, :func:`ones`, :func:`full`,
:func:`arange`, :func:`concatenate` and :func:`onehot_encode`;
:func:`waitall` waits for the card.  :func:`save` / :func:`load` read
and write the JAX package's ``.params`` format.

Every registered op is also a function of this module (``nd.relu``,
``nd.FullyConnected`` ...), generated by :func:`_init_ndarray_module`
over :func:`imperative_invoke`, the one imperative dispatch path.  The
generated names shadow builtins (``slice``, ``abs``, ``sum``, ``max``,
``min``, ``round``) in this module's namespace; its own code uses
``_py_slice`` and friends.

**Default context.**  New arrays, the arrays :func:`load` reads and the
outputs of ops without array inputs go to
:func:`~mxnet_tpu_torch.context.current_context`: the innermost
``with ctx:`` scope, else the card (``gpu(0)``), and without a card
that raises.  This differs from the JAX package, whose default is
``cpu(0)``: run ``with mt.cpu():`` (or pass ``ctx=mt.cpu()``) to work
on the host.  The iterators make their batches on the host explicitly;
``Module`` moves each batch onto its own device.

**Mutation.**  Unlike the JAX package's immutable buffers, an NDArray's
tensor is written in place where that keeps storage shared (``x[:] =``,
``+=``, ``out=``, aux states, optimizer steps) — except while
:mod:`~mxnet_tpu_torch.autograd` is recording, when the write rebinds
the NDArray to a new tensor so the recorded graph stays intact (torch
refuses in-place writes to tensors the graph needs).  ``out=`` also
rebinds when the op's output differs from the destination in shape or
dtype: the destination takes the op's result, as the reference's does.
An op's output never shares storage with its inputs: where torch would
return a view (``Reshape``, ``transpose``, ``broadcast_to`` ...) the
output is a copy, as the reference's are.
"""
from __future__ import annotations

import contextlib

import io
import struct
import sys

import numpy as np
import torch

from . import registry as _reg
from .base import MXNetError
from .context import Context, cpu, current_context

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "onehot_encode", "imperative_invoke", "waitall",
           "save", "load"]

# generated op functions (slice, abs, sum, ...) shadow builtins at module
# level, as in the JAX package's nd namespace: keep the real ones here
_py_slice = slice

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.int8): torch.int8,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.bool_): torch.bool}
_NUMERIC = (int, float, np.generic)


def torch_dtype(dtype):
    """A torch dtype from a numpy dtype, its name, or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is None:
        return torch.float32
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return _NP_TO_TORCH[np.dtype(dtype)]


def dtype_name(dtype):
    """The name an op's ``dtype`` attribute takes ('float32',
    'bfloat16' ...) for a numpy or torch dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype)[len("torch."):]
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def _device(ctx):
    """A torch device from a :class:`Context`, a torch device or its
    name; None is :func:`current_context`."""
    if ctx is None:
        ctx = current_context()
    return ctx.torch_device if isinstance(ctx, Context) else torch.device(ctx)


def _recording():
    from . import autograd

    return autograd.is_recording()


def _grad_mode():
    """autograd's graph on while recording, off otherwise."""
    return torch.enable_grad() if _recording() else torch.no_grad()


def _module():
    return sys.modules[__name__]


class NDArray:
    """An n-dimensional array: a torch tensor plus its context."""

    __slots__ = ("_data", "writable")

    def __init__(self, data, writable=True):
        self._data = data
        # an array with writable False refuses item assignment, as the
        # JAX package's does
        self.writable = writable

    # -- data access -------------------------------------------------------
    @property
    def data(self):
        """The underlying ``torch.Tensor``."""
        return self._data

    def _set_data(self, new_data):
        self._data = new_data

    @property
    def handle(self):
        """The array itself (the JAX package's stand-in for the C
        handle)."""
        return self

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

    @property
    def T(self):
        return _module().transpose(self)

    # -- synchronization -----------------------------------------------------
    def wait_to_read(self):
        """Block until the value is computed."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    # -- conversions -------------------------------------------------------
    def asnumpy(self):
        """A numpy copy (never a view of a host tensor, which later
        in-place writes would change)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy() if t.is_cuda else t.numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype):
        """A copy in ``dtype`` (the ``Cast`` op, so autograd sees it)."""
        return _module().Cast(self, dtype=dtype_name(dtype))

    def copy(self):
        with _grad_mode():
            return NDArray(self._data.clone())

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, written in place) or onto a
        :class:`Context` (a new NDArray there)."""
        if isinstance(other, NDArray):
            other[:] = self
            return other
        if isinstance(other, Context):
            with _grad_mode():
                return NDArray(self._data.to(other.torch_device, copy=True))
        raise TypeError("copyto expects NDArray or Context")

    def as_in_context(self, context):
        if context == self.context:
            return self
        return self.copyto(context)

    def reshape(self, shape, **kwargs):
        """The same values in ``shape`` (0 copies a dimension, -1 is
        inferred): a new array, as the JAX package's is (the ``Reshape``
        op, so autograd sees it)."""
        return _module().Reshape(self, shape=(shape,)
                                 if isinstance(shape, int) else tuple(shape))

    def broadcast_to(self, shape):
        return _module().broadcast_to(self, shape=tuple(shape))

    # -- indexing ----------------------------------------------------------
    def _key(self, key):
        if isinstance(key, NDArray):
            return key._data.long()
        if isinstance(key, np.ndarray):
            return torch.as_tensor(key, device=self._data.device).long()
        return key

    def __getitem__(self, key):
        """Basic indexing (ints and unit-step slices): a view of the same
        storage, so writes through it reach this array."""
        if isinstance(key, _py_slice) and key.step not in (None, 1):
            raise ValueError("slice step cannot be non-unit")
        with _grad_mode():
            return NDArray(self._data[self._key(key)])

    def __setitem__(self, key, value):
        if not self.writable:
            raise MXNetError("trying to write to an immutable NDArray")
        t = self._data
        if isinstance(value, NDArray):
            value = value._data
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        value = value.to(t.device, t.dtype)
        key = self._key(key)
        whole = isinstance(key, _py_slice) and key == _py_slice(None)
        if _recording():
            # functional: the recorded graph keeps the old tensor
            if whole:
                self._data = value.expand(t.shape).clone()
            else:
                new = t.clone()
                new[key] = value
                self._data = new
            return
        with torch.no_grad():
            if whole:
                t.copy_(value)
            else:
                t[key] = value

    # -- arithmetic (through the op registry, so autograd sees it) ---------
    def _binary(self, other, op, scalar_op, rop=False):
        mod = _module()
        if isinstance(other, NDArray):
            lhs, rhs = (other, self) if rop else (self, other)
            return getattr(mod, op)(lhs, rhs)
        if isinstance(other, _NUMERIC):
            return getattr(mod, scalar_op)(self, scalar=float(other))
        raise TypeError("unsupported operand type %s" % type(other))

    def __add__(self, other):
        return self._binary(other, "broadcast_plus", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "broadcast_minus", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "broadcast_minus", "_rminus_scalar",
                            rop=True)

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "broadcast_div", "_div_scalar")

    __div__ = __truediv__

    def __rtruediv__(self, other):
        return self._binary(other, "broadcast_div", "_rdiv_scalar", rop=True)

    __rdiv__ = __rtruediv__

    def __pow__(self, other):
        return self._binary(other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return self._binary(other, "broadcast_power", "_rpower_scalar",
                            rop=True)

    def __mod__(self, other):
        return self._binary(other, "broadcast_mod", "_mod_scalar")

    def __neg__(self):
        return _module().negative(self)

    def __eq__(self, other):
        if isinstance(other, (NDArray,) + _NUMERIC):
            return self._binary(other, "broadcast_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (NDArray,) + _NUMERIC):
            return self._binary(other, "broadcast_not_equal",
                                "_not_equal_scalar")
        return NotImplemented

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous")

    # -- in-place: written into this array's storage, or rebound while
    # recording (see the module docstring)
    def _inplace(self, result):
        value = result._data.to(self._data.dtype)
        if _recording():
            self._data = value
        else:
            with torch.no_grad():
                self._data.copy_(value)
        return self

    def __iadd__(self, other):
        return self._inplace(self + other)

    def __isub__(self, other):
        return self._inplace(self - other)

    def __imul__(self, other):
        return self._inplace(self * other)

    def __itruediv__(self, other):
        return self._inplace(self / other)

    __idiv__ = __itruediv__

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(str(s) for s in self.shape),
                                     self.context)


# ---------------------------------------------------------------------------
# Creation
# ---------------------------------------------------------------------------

def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array`` (numpy, a list, a
    tensor or an NDArray) on ``ctx`` (a Context or torch device; None is
    :func:`~mxnet_tpu_torch.context.current_context`); float64 becomes
    float32 unless ``dtype`` says otherwise."""
    dev = _device(ctx)
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
    return NDArray(src.to(dev, copy=True))


def empty(shape, ctx=None, dtype=None):
    """An NDArray of ``shape`` (zero-filled, as the JAX package's)."""
    return zeros(shape, ctx, dtype)


def zeros(shape, ctx=None, dtype=None):
    """An NDArray of zeros on ``ctx`` (None: the current context)."""
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None):
    """An NDArray of ones on ``ctx`` (None: the current context)."""
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None):
    """An NDArray filled with ``val`` on ``ctx`` (None: the current
    context)."""
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """``numpy.arange(start, stop, step)`` in ``dtype`` (float32 by
    default), each value repeated ``repeat`` times."""
    dt = np.float32 if dtype is None else dtype
    if str(dt) == "bfloat16":
        arr = np.arange(start, stop, step, dtype=np.float32)
    else:
        arr = np.arange(start, stop, step, dtype=np.dtype(dt))
    if repeat != 1:
        arr = np.repeat(arr, repeat)
    return array(arr, ctx, dtype=dt)


def concatenate(arrays, axis=0, always_copy=True):
    """One NDArray joining ``arrays`` along ``axis``, on the first one's
    device."""
    if not arrays:
        raise MXNetError("concatenate needs at least one array")
    with _grad_mode():
        return NDArray(torch.cat([a.data for a in arrays], dim=axis))


def onehot_encode(indices, out):
    """Write the one-hot rows of ``indices`` into ``out`` (its second
    dimension is the depth) and return it."""
    out[:] = _module().one_hot(indices, depth=out.shape[1])
    return out


def waitall():
    """Wait for all work queued on the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Imperative dispatch — the generated op functions
# ---------------------------------------------------------------------------

def _attr_device(attrs):
    """The device an op without array inputs runs on: its ``ctx``
    attribute ('cpu(0)', 'gpu(1)', 'cuda:0'), else the current
    context."""
    ctx = attrs.get("ctx", "") or ""
    if not ctx:
        return _device(None)
    ctx = str(ctx)
    if ctx.startswith(("cpu", "gpu")):
        kind, _, rest = ctx.partition("(")
        idx = int(rest.rstrip(")") or 0)
        return Context(kind, idx).torch_device
    return torch.device(ctx)


def _fresh(outs, ins):
    """``outs`` with every tensor that shares storage with an input
    copied, so no op output aliases its inputs."""
    ptrs = {t.untyped_storage().data_ptr() for t in ins if t.numel()}
    if not ptrs:
        return outs
    return [o.clone() if o.numel()
            and o.untyped_storage().data_ptr() in ptrs else o for o in outs]


def imperative_invoke(opdef, nd_inputs, raw_attrs, out=None, is_train=None):
    """The one imperative dispatch path (the JAX package's
    ``imperative_invoke``): fills a variadic op's input count, splits
    trailing aux arrays (BatchNorm's moving statistics, written back in
    place), runs the op in training mode when
    :func:`autograd.is_training` says so, with the generator of its
    device from :mod:`~mxnet_tpu_torch.random`, under autograd's graph
    only while recording, and returns the visible outputs — or writes
    them into ``out`` (rebound while recording, so the graph continues
    from the destination)."""
    from . import autograd
    from . import random as _random

    if opdef.key_var_num_args and opdef.key_var_num_args not in raw_attrs:
        raw_attrs = dict(raw_attrs)
        raw_attrs[opdef.key_var_num_args] = str(len(nd_inputs))
    attrs = opdef.parse_attrs(raw_attrs)
    n_aux = len(opdef.list_aux(attrs))
    if n_aux and len(nd_inputs) == opdef.n_inputs(attrs) + n_aux:
        nd_aux = nd_inputs[-n_aux:]
        nd_inputs = nd_inputs[:-n_aux]
    else:
        nd_aux = []
    if is_train is None:
        is_train = autograd.is_training()
    ins = [a.data for a in nd_inputs]
    aux = [a.data for a in nd_aux]
    dev = ins[0].device if ins else _attr_device(attrs)
    recording = autograd.is_recording()
    from . import profiler as _prof

    with torch.enable_grad() if recording else torch.no_grad(), \
            _prof.Scope(opdef.name, "imperative") if _prof.is_running() \
            else contextlib.nullcontext():
        # a per-op dispatch span while the profiler runs (the engine's
        # OprExecStat analog)
        outs, new_aux = _reg.invoke(opdef, ins, attrs, is_train=is_train,
                                    generator=_random.generator(dev),
                                    aux=aux, device=dev)
    with torch.no_grad():
        for a, new in zip(nd_aux, new_aux):
            if new is not a.data:
                a.data.copy_(new)
    outs = _fresh(outs[:opdef.n_visible_outputs(attrs)], ins + aux)
    if out is None:
        res = [NDArray(o) for o in outs]
        return res[0] if len(res) == 1 else res
    dsts = out if isinstance(out, (list, tuple)) else [out]
    for dst, src in zip(dsts, outs):
        if recording or dst.shape != tuple(src.shape) \
                or dst.data.dtype != src.dtype:
            dst._set_data(src)
        else:
            with torch.no_grad():
                dst.data.copy_(src)
    return out


def _make_op_func(opdef):
    def op_func(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        nd_args = list(args)
        # NDArray keyword arguments bind by argument name, appended after
        # the positional ones in the op's argument order (the JAX
        # package's rule: pass every array by name when mixing)
        if any(isinstance(v, NDArray) for v in kwargs.values()):
            probe = {k: v for k, v in kwargs.items()
                     if not isinstance(v, NDArray)}
            if opdef.key_var_num_args \
                    and opdef.key_var_num_args not in probe:
                probe[opdef.key_var_num_args] = str(len(args) or 1)
            attrs0 = opdef.parse_attrs(probe)
            for n in opdef.list_arguments(attrs0) + opdef.list_aux(attrs0):
                if isinstance(kwargs.get(n), NDArray):
                    nd_args.append(kwargs.pop(n))
        return imperative_invoke(opdef, nd_args, kwargs, out)

    op_func.__name__ = opdef.name
    op_func.__doc__ = opdef.doc + "\n\nParameters\n----------\n" \
        + opdef.schema.doc()
    return op_func


def _init_ndarray_module():
    """A function of this module for every registered op."""
    mod = _module()
    for name in _reg.list_ops():
        setattr(mod, name, _make_op_func(_reg.get_op(name)))


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
    """NDArrays on :func:`current_context` from a ``.params`` path or an
    in-memory ``bytes`` blob: a dict when the arrays are named, else a
    list."""
    return _load(fname, None)


def _load(fname, ctx):
    """:func:`load` onto ``ctx`` (None: :func:`current_context`)."""
    dev = _device(ctx)
    if isinstance(fname, (bytes, bytearray, memoryview)):
        return _load_stream(io.BytesIO(bytes(fname)), "<bytes>", dev)
    with open(fname, "rb") as f:
        return _load_stream(f, fname, dev)


def _load_stream(f, fname, dev):
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
        arrays.append(NDArray(t.to(dev)))
    if any(names):
        return dict(zip(names, arrays))
    return arrays
