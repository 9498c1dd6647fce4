"""Elementwise ops (counterpart of ``mxnet_tpu/ops/elemwise.py``): the
unary table, ``_copy`` / ``identity``, ``Cast``, the binary arithmetic
family (plus, minus, mul, div, mod, power, maximum, minimum, hypot: the
elemwise form ``_plus`` ..., aliased ``elemwise_*`` for the first four,
the broadcast form ``broadcast_add`` ..., the scalar forms ``_plus_scalar``
... and ``_rminus_scalar`` / ``_rdiv_scalar`` / ``_rpower_scalar`` /
``_rmod_scalar`` with the scalar on the left), the comparisons
(``broadcast_equal`` / ``_equal`` / ``_equal_scalar`` ..., 0 / 1 in the
input's dtype), ``smooth_l1``, ``add_n`` / ``ElementWiseSum``,
``BlockGrad`` / ``stop_gradient``, ``clip`` and ``_grad_add`` — plain
torch, differentiated by autograd.

Names, hints and aliases follow the JAX package so that auto-naming —
and with it the symbol JSON — matches.  A scalar stays a Python number
where torch takes one (it is rounded to the tensor's dtype, as
``jnp.asarray(scalar, a.dtype)`` does); ``maximum`` / ``minimum`` /
``hypot`` / ``mod`` against a scalar make a 0-d tensor of it on the
device (no host copy), so ``maximum``'s tie splits the gradient as
jax's does.  ``mod`` is C's ``fmod`` (``a - trunc(a / b) * b``), as in
the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op, simple_compute
from .tensor import attr_dtype


def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_UNARY = {
    "abs": torch.abs,
    "sign": torch.sign,
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "round": torch.round,
    "square": lambda x: x * x,
    "sqrt": torch.sqrt,
    "rsqrt": lambda x: 1.0 / torch.sqrt(x),
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": lambda x: x * (180.0 / math.pi),
    "radians": lambda x: x * (math.pi / 180.0),
    # exp(gammaln), as the reference computes it
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "negative": torch.neg,
    "reciprocal": lambda x: 1.0 / x,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
    "softrelu": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "logical_not": lambda x: (x == 0).to(x.dtype),
}


def _scalar(a, s):
    """``s`` as a 0-d tensor of ``a``'s dtype on ``a``'s device."""
    return torch.full((), s, dtype=a.dtype, device=a.device)


def _fmod(a, b):
    return a - torch.trunc(a / b) * b


_BINARY = {"plus": torch.add, "minus": torch.sub, "mul": torch.mul,
           "div": torch.div, "power": torch.pow, "mod": _fmod,
           "maximum": torch.maximum, "minimum": torch.minimum,
           "hypot": torch.hypot}
# the scalar on the right: a Python number where torch takes one
_SCALAR = {"plus": torch.add, "minus": torch.sub, "mul": torch.mul,
           "div": torch.div, "power": torch.pow,
           "mod": lambda a, s: _fmod(a, _scalar(a, s)),
           "maximum": lambda a, s: torch.maximum(a, _scalar(a, s)),
           "minimum": lambda a, s: torch.minimum(a, _scalar(a, s)),
           "hypot": lambda a, s: torch.hypot(a, _scalar(a, s))}
# scalar on the left: s - a, s / a as a true quotient (torch's ``s / a``
# multiplies by the reciprocal, which rounds twice), s ** a, fmod(s, a)
_RSCALAR = {"minus": lambda a, s: torch.rsub(a, s),
            "div": lambda a, s: torch.full_like(a, s) / a,
            "power": lambda a, s: torch.pow(s, a),
            "mod": lambda a, s: _fmod(_scalar(a, s), a)}
_LOGIC = {"equal": torch.eq, "not_equal": torch.ne, "greater": torch.gt,
          "greater_equal": torch.ge, "lesser": torch.lt,
          "lesser_equal": torch.le}


def _cast_type(attrs, in_types, aux_types):
    dt = attrs["dtype"]
    out = torch.bfloat16 if dt == "bfloat16" else np.dtype(dt)
    return in_types, [out], aux_types


def _smooth_l1(attrs, x):
    # 0.5 (sigma x)^2 inside |x| < 1 / sigma^2, |x| - 0.5 / sigma^2
    # outside; torch.where routes the gradient (sigma^2 x, sign x) to the
    # branch taken, as the reference's custom JVP does
    s2 = float(attrs.get("scalar", 1.0)) ** 2
    ax = torch.abs(x)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


def _add_n(attrs, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def register_all():
    for name, fn in _UNARY.items():
        register_op(OpDef(name, simple_compute(lambda attrs, x, f=fn: f(x)),
                          doc="Elementwise %s." % name))
    register_op(OpDef("_copy", simple_compute(lambda attrs, x: x.clone())),
                aliases=["identity"])
    register_op(OpDef("_identity_with_attr_like_rhs",
                      simple_compute(lambda attrs, lhs, rhs: lhs),
                      num_inputs=2))
    register_op(OpDef("Cast",
                      simple_compute(lambda attrs, x:
                                     x.to(attr_dtype(attrs))),
                      schema=ParamSchema(Param("dtype", str, required=True)),
                      hint="cast", infer_type=_cast_type),
                aliases=["cast"])

    sschema = ParamSchema(Param("scalar", float, required=True))
    for name, fn in _BINARY.items():
        canon = {"plus": "add", "minus": "sub"}.get(name, name)
        extra = (["_" + canon] if canon != name else []) \
            + (["elemwise_" + canon]
               if name in ("plus", "minus", "mul", "div") else [])
        register_op(
            OpDef("_" + name,
                  simple_compute(lambda attrs, a, b, f=fn: f(a, b)),
                  num_inputs=2, hint=name),
            aliases=extra)
        main = "broadcast_" + canon
        ali = ["broadcast_" + name] if main != "broadcast_" + name else []
        register_op(
            OpDef(main, simple_compute(lambda attrs, a, b, f=fn: f(a, b)),
                  num_inputs=2, hint=main),
            aliases=ali)
        register_op(
            OpDef("_%s_scalar" % name,
                  simple_compute(lambda attrs, a, f=_SCALAR[name]:
                                 f(a, attrs["scalar"])),
                  schema=sschema, num_inputs=1, hint=name))
        if name in _RSCALAR:
            register_op(
                OpDef("_r%s_scalar" % name,
                      simple_compute(lambda attrs, a, f=_RSCALAR[name]:
                                     f(a, attrs["scalar"])),
                      schema=sschema, num_inputs=1, hint=name))

    for name, fn in _LOGIC.items():
        register_op(
            OpDef("broadcast_" + name,
                  simple_compute(lambda attrs, a, b, f=fn:
                                 f(a, b).to(a.dtype)),
                  num_inputs=2, hint=name),
            aliases=["_" + name])
        register_op(
            OpDef("_%s_scalar" % name,
                  simple_compute(lambda attrs, a, f=fn:
                                 f(a, attrs["scalar"]).to(a.dtype)),
                  schema=sschema, num_inputs=1, hint=name))

    register_op(OpDef("smooth_l1", simple_compute(_smooth_l1),
                      schema=ParamSchema(Param("scalar", float,
                                               default=1.0))))
    register_op(OpDef("add_n", simple_compute(_add_n),
                      schema=ParamSchema(Param("num_args", int,
                                               required=True)),
                      num_inputs=lambda attrs: attrs["num_args"],
                      arguments=lambda attrs: ["arg%d" % i for i in
                                               range(attrs["num_args"])],
                      key_var_num_args="num_args", hint="add_n"),
                aliases=["ElementWiseSum", "_sum", "elemwise_sum"])
    register_op(OpDef("BlockGrad",
                      simple_compute(lambda attrs, x: x.detach()),
                      hint="blockgrad"),
                aliases=["stop_gradient"])
    register_op(OpDef("clip",
                      simple_compute(lambda attrs, x: torch.clamp(
                          x, attrs["a_min"], attrs["a_max"])),
                      schema=ParamSchema(Param("a_min", float, required=True),
                                         Param("a_max", float,
                                               required=True))))
    register_op(OpDef("_grad_add",
                      simple_compute(lambda attrs, a, b: a + b),
                      num_inputs=2))
