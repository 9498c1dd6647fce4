"""Elementwise ops: ``square``, ``rsqrt`` and the binary arithmetic
family after ``mxnet_tpu/ops/elemwise.py``'s — for each of plus, minus,
mul, div and power the elemwise form (``_plus`` / ``_minus`` / ``_mul``
/ ``_div`` / ``_power``, the first four aliased ``elemwise_*``), the
broadcast form (``broadcast_add`` ...) and the scalar forms
(``_plus_scalar`` ..., ``_rminus_scalar``, ``_rdiv_scalar`` and
``_rpower_scalar`` with the scalar on the left) — plain torch,
differentiated by autograd.

Names, hints and aliases follow the JAX package so that auto-naming —
and with it the symbol JSON — matches.  A scalar stays a Python number
(no tensor is made, so nothing is copied to the card); torch rounds it
to the tensor's dtype, as ``jnp.asarray(scalar, a.dtype)`` does.
"""
from __future__ import annotations

import torch

from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op, simple_compute

_BINARY = {"plus": torch.add, "minus": torch.sub, "mul": torch.mul,
           "div": torch.div, "power": torch.pow}
# scalar on the left: s - a, and s / a as a true quotient (torch's
# ``s / a`` multiplies by the reciprocal, which rounds twice)
_RSCALAR = {"minus": lambda a, s: torch.rsub(a, s),
            "div": lambda a, s: torch.full_like(a, s) / a,
            "power": lambda a, s: torch.pow(s, a)}


def register_all():
    register_op(OpDef("square", simple_compute(lambda attrs, x: x * x),
                      doc="Elementwise square."))
    register_op(OpDef("rsqrt",
                      simple_compute(lambda attrs, x: 1.0 / torch.sqrt(x)),
                      doc="Elementwise 1/sqrt(x)."))

    sschema = ParamSchema(Param("scalar", float, required=True))
    for name, fn in _BINARY.items():
        canon = {"plus": "add", "minus": "sub"}.get(name, name)
        extra = (["_" + canon] if canon != name else []) \
            + (["elemwise_" + canon] if name != "power" else [])
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
                  simple_compute(lambda attrs, a, f=fn:
                                 f(a, attrs["scalar"])),
                  schema=sschema, num_inputs=1, hint=name))
        if name in _RSCALAR:
            register_op(
                OpDef("_r%s_scalar" % name,
                      simple_compute(lambda attrs, a, f=_RSCALAR[name]:
                                     f(a, attrs["scalar"])),
                      schema=sschema, num_inputs=1, hint=name))
