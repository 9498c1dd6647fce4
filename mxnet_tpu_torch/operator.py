"""User-defined operators (``mt.operator``), the counterpart of
``mxnet_tpu/operator.py``.

Users subclass :class:`CustomOp` (imperative ``forward`` / ``backward``
over NDArrays) and :class:`CustomOpProp` (argument and output names,
shape and type inference, the operator factory), register the prop
under a name, and use the op as ``sym.Custom(..., op_type=name)`` or
``nd.Custom(...)``.

The ``Custom`` op is a ``torch.autograd.Function`` whose forward and
backward call the user's methods with NDArrays on the op's own device
(the op's inputs, zero-filled outputs and input gradients), inside that
device's context scope, so arrays the user's code makes land there too.
The JAX package makes a host round trip (``pure_callback``) only
because XLA needs one.

**Stated difference from the JAX package: a graph with a Custom node
is never captured.**  A user's body may read values back to the host
(``asnumpy``), which a CUDA graph cannot record.  So
``train_step.CompiledTrainStep`` (and ``CompiledEvalStep``) refuse such
a graph with MXNetError: ``Module`` logs a warning and trains on the
eager path, as it does for ``grad_req="add"``, scores on the host path,
and its executor's inference forward runs eagerly.  The JAX package
compiles the node into its step as a host callback.  The purity contract
stays: ``forward`` / ``backward`` should be functions of their inputs.
Aux states are refused, as the JAX package refuses them.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .base import MXNetError
from .registry import OpDef, register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop"]

_CUSTOM_PROPS = {}

# attrs handled by the framework, never forwarded to the user's prop
_SYSTEM_KEYS = ("op_type", "ctx_group")


class CustomOp:
    """Base for user ops.  Subclasses implement ``forward`` and (when the
    op takes part in training) ``backward``; both receive NDArray lists
    and write results with :meth:`assign`."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise MXNetError("%s does not implement backward"
                         % type(self).__name__)

    @staticmethod
    def assign(dst, req, src):
        """Write ``src`` into ``dst`` honoring the grad request."""
        if req in ("null", 0):
            return
        if req in ("add", "add_to", 3):
            dst[:] = dst + src
        else:  # write / inplace
            dst[:] = src


class CustomOpProp:
    """Declares a custom op's signature: argument / output names, shape
    and dtype inference, and the operator factory."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def need_top_grad(self):
        return self.need_top_grad_

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Class decorator registering a CustomOpProp under ``reg_name``."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _CUSTOM_PROPS[reg_name] = prop_cls
        return prop_cls

    return deco


def get_prop(attrs):
    """Instantiate the registered prop from a Custom node's attrs."""
    op_type = attrs.get("op_type")
    if not op_type:
        raise MXNetError("Custom requires op_type=<registered name>")
    prop_cls = _CUSTOM_PROPS.get(op_type)
    if prop_cls is None:
        raise MXNetError("Custom op %r is not registered (have: %s)"
                         % (op_type, sorted(_CUSTOM_PROPS)))
    kwargs = {k: v for k, v in attrs.items()
              if k not in _SYSTEM_KEYS and not k.startswith("__")}
    return prop_cls(**kwargs)


# ---------------------------------------------------------------------------
# the Custom OpDef: the user's methods under an autograd Function
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _user_scope(device):
    """Run user code on ``device``'s context with imperative recording
    off: its NDArray ops are the op's body, not part of the caller's
    graph."""
    from . import autograd
    from .context import Context

    st = autograd._st()
    recording, st.recording = st.recording, False
    ctx = Context("cpu") if device.type == "cpu" \
        else Context("gpu", device.index or 0)
    try:
        with ctx, torch.no_grad():
            yield
    finally:
        st.recording = recording


def _wrap(tensors):
    from .ndarray import NDArray

    return [NDArray(t) for t in tensors]


class _CustomFunction(torch.autograd.Function):
    """forward(op, is_train, out_struct, *inputs): the user's forward into
    zero-filled outputs; backward: the user's backward into zero-filled
    input gradients."""

    @staticmethod
    def forward(fctx, op, is_train, out_struct, *inputs):
        dev = inputs[0].device if inputs else torch.device("cpu")
        ins = [x.detach() for x in inputs]
        out_data = _wrap([torch.zeros(s, dtype=t, device=dev)
                          for s, t in out_struct])
        with _user_scope(dev):
            op.forward(is_train, ["write"] * len(out_struct), _wrap(ins),
                       out_data, [])
        outs = [o.data.detach().to(dev, t)
                for o, (_, t) in zip(out_data, out_struct)]
        fctx.op = op
        fctx.save_for_backward(*(list(inputs) + outs))
        fctx.n_in = len(ins)
        return tuple(outs)

    @staticmethod
    def backward(fctx, *cts):
        saved = [t.detach() for t in fctx.saved_tensors]
        ins, outs = saved[:fctx.n_in], saved[fctx.n_in:]
        dev = ins[0].device if ins else torch.device("cpu")
        in_grad = _wrap([torch.zeros_like(x) for x in ins])
        cts = [torch.zeros_like(o) if c is None else c
               for c, o in zip(cts, outs)]
        with _user_scope(dev):
            fctx.op.backward(["write"] * len(ins), _wrap(cts), _wrap(ins),
                             _wrap(outs), in_grad, [])
        return (None, None, None) + tuple(
            g.data.to(x.device, x.dtype) for g, x in zip(in_grad, ins))


def _torch_dtype(t):
    from .ndarray import torch_dtype

    return torch_dtype(np.dtype(t) if not isinstance(t, torch.dtype) else t)


def _custom_fcompute(attrs, inputs, aux, octx):
    prop = get_prop(attrs)
    if prop.list_auxiliary_states():
        raise MXNetError(
            "Custom aux states are not supported; Custom forward/backward "
            "must be pure functions of their inputs — stateful "
            "computation belongs in PythonModule")
    in_shapes = [list(v.shape) for v in inputs]
    _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
    in_types = [np.dtype(torch.empty((), dtype=v.dtype).numpy().dtype)
                if v.dtype != torch.bfloat16 else v.dtype for v in inputs]
    _, out_types, _ = prop.infer_type(list(in_types))
    out_struct = tuple((tuple(s), _torch_dtype(t))
                       for s, t in zip(out_shapes, out_types))
    ctx = "cpu" if not inputs or inputs[0].device.type == "cpu" else "gpu"
    op = prop.create_operator(ctx, in_shapes, in_types)
    outs = _CustomFunction.apply(op, bool(octx.is_train), out_struct,
                                 *inputs)
    return list(outs), list(aux)


def _custom_infer_shape(attrs, in_shapes, aux_shapes):
    prop = get_prop(attrs)
    ins, outs, aux = prop.infer_shape([list(s) if s else s
                                       for s in in_shapes])
    return [tuple(s) for s in ins], [tuple(s) for s in outs], \
        [tuple(s) for s in (aux or [])]


def _custom_infer_type(attrs, in_types, aux_types):
    prop = get_prop(attrs)
    seed = [t if t is not None else np.dtype(np.float32) for t in in_types]
    ins, outs, aux = prop.infer_type(seed)
    return list(ins), list(outs), list(aux or aux_types)


register_op(OpDef(
    "Custom", _custom_fcompute,
    num_inputs=lambda a: len(get_prop(a).list_arguments()),
    num_outputs=lambda a: len(get_prop(a).list_outputs()),
    arguments=lambda a: get_prop(a).list_arguments(),
    outputs=lambda a: get_prop(a).list_outputs(),
    infer_shape=_custom_infer_shape, infer_type=_custom_infer_type,
    hint="custom", capturable=False,
    doc="User-defined Python operator; forward/backward run the user's "
        "methods on the op's device under an autograd Function "
        "(ref: src/operator/custom/custom.cc, python/mxnet/operator.py)."))
