"""The operator registry.

The port's counterpart of ``mxnet_tpu/registry.py``.  An :class:`OpDef`
bundles a parameter schema, shape inference, argument naming and
``fcompute``, whose contract is the JAX package's over torch tensors::

    fcompute(attrs, inputs, aux, octx) -> (outputs, new_aux)

PyTorch runs eagerly, so there is no per-op compile cache: :func:`invoke`
(the imperative path, ``ndarray.imperative_invoke``) and the executor's
graph walk both call ``fcompute`` directly.
"""
from __future__ import annotations

from .attrs import FrozenAttrs, ParamSchema
from .base import MXNetError

__all__ = ["OpDef", "OpContext", "register_op", "get_op", "list_ops",
           "simple_compute", "invoke"]

_OPS = {}


class OpContext:
    """Per-invocation execution context.

    ``is_train`` is the training flag (BatchNorm uses batch statistics
    and updates its moving ones only when it is set; Dropout and the
    RNN op's inter-layer dropout mask only then).  ``plain`` makes ops
    that own a hand-written CUDA kernel run the kernel's plain PyTorch
    version instead, whatever the device — the reference the kernels
    are held to (``DecodePredictor(plain=True)``).  ``generator`` is the
    ``torch.Generator`` random ops draw from (None: torch's default
    generator of the tensor's device).  ``device`` is where an op with
    no inputs (``_zeros``, ``_arange``, the samplers) puts its output
    (None: the host).
    """

    __slots__ = ("is_train", "plain", "generator", "device")

    def __init__(self, is_train=False, plain=False, generator=None,
                 device=None):
        self.is_train = is_train
        self.plain = plain
        self.generator = generator
        self.device = device


def _default_arg_names(n):
    if n == 1:
        return ["data"]
    if n == 2:
        return ["lhs", "rhs"]
    return ["arg%d" % i for i in range(n)]


class OpDef:
    """A registered operator."""

    def __init__(self, name, fcompute, schema=None, num_inputs=1,
                 num_outputs=1, num_visible_outputs=None, arguments=None,
                 outputs=None, aux=None, infer_shape=None, hint=None,
                 doc="", key_var_num_args=None, infer_type=None,
                 capturable=True):
        self.name = name
        self.fcompute = fcompute
        self.schema = schema or ParamSchema()
        self.num_inputs = num_inputs  # int or callable(attrs) -> int
        self.num_outputs = num_outputs
        # outputs a composed symbol exposes (defaults to num_outputs)
        self.num_visible_outputs = num_visible_outputs
        self._arguments = arguments
        self._outputs = outputs
        self._aux = aux
        self.infer_shape_fn = infer_shape
        # (attrs, in_types, aux_types) -> (in_types, out_types, aux_types)
        # for an op whose dtypes do not follow Symbol.infer_type's
        # unification (Embedding's ids, BatchNorm's f32 statistics)
        self.infer_type_fn = infer_type
        # the attr a variadic op's input count fills in (Concat's num_args)
        self.key_var_num_args = key_var_num_args
        self.hint = hint or name.lstrip("_").lower()
        self.doc = doc
        # False for an op whose body may read values back to the host
        # (Custom): the compiled steps refuse a graph holding one
        self.capturable = capturable

    def n_inputs(self, attrs):
        n = self.num_inputs
        return n(attrs) if callable(n) else n

    def n_outputs(self, attrs):
        n = self.num_outputs
        return n(attrs) if callable(n) else n

    def n_visible_outputs(self, attrs):
        n = self.num_visible_outputs
        if n is None:
            return self.n_outputs(attrs)
        return n(attrs) if callable(n) else n

    def list_outputs(self, attrs):
        if self._outputs is not None:
            o = self._outputs
            return list(o(attrs)) if callable(o) else list(o)
        n = self.n_outputs(attrs)
        return ["output"] if n == 1 else ["output%d" % i for i in range(n)]

    def list_arguments(self, attrs):
        if self._arguments is not None:
            a = self._arguments
            return list(a(attrs)) if callable(a) else list(a)
        return _default_arg_names(self.n_inputs(attrs))

    def list_aux(self, attrs):
        if self._aux is None:
            return []
        a = self._aux
        return list(a(attrs)) if callable(a) else list(a)

    def parse_attrs(self, raw):
        return raw if isinstance(raw, FrozenAttrs) else self.schema.parse(raw)

    def infer_shape(self, attrs, in_shapes, aux_shapes=None):
        """Returns (in_shapes, out_shapes, aux_shapes).  Ops without an
        explicit rule run ``fcompute`` on meta tensors."""
        if self.infer_shape_fn is not None:
            return self.infer_shape_fn(attrs, in_shapes, aux_shapes)
        if any(s is None for s in in_shapes):
            raise MXNetError("Op %s cannot infer missing input shapes "
                             "(got %s)" % (self.name, in_shapes))
        import torch

        ins = [torch.empty(tuple(s), device="meta") for s in in_shapes]
        outs, _ = self.fcompute(attrs, ins, [],
                                OpContext(device=torch.device("meta")))
        return in_shapes, [tuple(o.shape) for o in outs], aux_shapes or []

    def __repr__(self):
        return "OpDef(%s)" % self.name


def simple_compute(fn):
    """Adapt ``fn(attrs, *inputs) -> tensor|tuple`` to canonical
    fcompute."""

    def fcompute(attrs, inputs, aux, octx):
        out = fn(attrs, *inputs)
        if not isinstance(out, (tuple, list)):
            out = [out]
        return list(out), list(aux)

    return fcompute


def register_op(opdef, aliases=()):
    _OPS[opdef.name] = opdef
    for a in aliases:
        _OPS[a] = opdef
    return opdef


def get_op(name):
    op = _OPS.get(name)
    if op is None:
        raise MXNetError("Operator %s is not registered" % name)
    return op


def list_ops():
    return sorted(_OPS.keys())


def invoke(opdef, inputs, attrs=None, is_train=False, generator=None,
           aux=(), device=None):
    """Run an op on tensors: ``(outputs, new_aux)``, every output
    (hidden ones included).  The counterpart of the JAX package's
    ``registry.invoke``, without its per-op compile cache."""
    attrs = opdef.parse_attrs(attrs or {})
    octx = OpContext(is_train=bool(is_train), generator=generator,
                     device=device)
    outs, new_aux = opdef.fcompute(attrs, list(inputs), list(aux), octx)
    return list(outs), list(new_aux)
