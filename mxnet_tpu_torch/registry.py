"""The operator registry.

The port's counterpart of ``mxnet_tpu/registry.py``.  An :class:`OpDef`
bundles a parameter schema, shape inference, argument naming and
``fcompute``, whose contract is the JAX package's over torch tensors::

    fcompute(attrs, inputs, aux, octx) -> (outputs, new_aux)

PyTorch runs eagerly, so there is no per-op compile cache.
"""
from __future__ import annotations

from .attrs import FrozenAttrs, ParamSchema
from .base import MXNetError

__all__ = ["OpDef", "OpContext", "register_op", "get_op", "list_ops",
           "simple_compute"]

_OPS = {}


class OpContext:
    """Per-invocation execution context.

    ``plain`` makes ops that own a hand-written CUDA kernel run the
    kernel's plain PyTorch version instead, whatever the device — the
    reference the kernels are held to (``DecodePredictor(plain=True)``).
    """

    __slots__ = ("plain",)

    def __init__(self, plain=False):
        self.plain = plain


def _default_arg_names(n):
    if n == 1:
        return ["data"]
    if n == 2:
        return ["lhs", "rhs"]
    return ["arg%d" % i for i in range(n)]


class OpDef:
    """A registered operator."""

    def __init__(self, name, fcompute, schema=None, num_inputs=1,
                 num_outputs=1, arguments=None, aux=None,
                 infer_shape=None, hint=None, doc=""):
        self.name = name
        self.fcompute = fcompute
        self.schema = schema or ParamSchema()
        self.num_inputs = num_inputs  # int or callable(attrs) -> int
        self.num_outputs = num_outputs
        self._arguments = arguments
        self._aux = aux
        self.infer_shape_fn = infer_shape
        self.hint = hint or name.lstrip("_").lower()
        self.doc = doc

    def n_inputs(self, attrs):
        n = self.num_inputs
        return n(attrs) if callable(n) else n

    def n_outputs(self, attrs):
        n = self.num_outputs
        return n(attrs) if callable(n) else n

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
        outs, _ = self.fcompute(attrs, ins, [], OpContext())
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
