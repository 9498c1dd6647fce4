"""Elementwise ops of the LM: ``square``, ``rsqrt``, the binary
``_plus`` / ``broadcast_{add,sub,mul}`` and ``_plus_scalar`` — plain
torch, differentiated by autograd.

Names, hints and aliases follow ``mxnet_tpu/ops/elemwise.py`` so that
auto-naming — and with it the symbol JSON — matches the JAX package.
"""
from __future__ import annotations

import torch

from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op, simple_compute


def register_all():
    register_op(OpDef("square", simple_compute(lambda attrs, x: x * x),
                      doc="Elementwise square."))
    register_op(OpDef("rsqrt",
                      simple_compute(lambda attrs, x: 1.0 / torch.sqrt(x)),
                      doc="Elementwise 1/sqrt(x)."))

    binary = {"plus": torch.add, "minus": torch.sub, "mul": torch.mul}
    for name, fn in binary.items():
        canon = {"plus": "add", "minus": "sub"}.get(name, name)
        if name == "plus":
            register_op(
                OpDef("_plus", simple_compute(lambda attrs, a, b: a + b),
                      num_inputs=2, hint=name),
                aliases=["_add", "elemwise_add"])
            register_op(
                OpDef("_plus_scalar",
                      simple_compute(lambda attrs, a: a + attrs["scalar"]),
                      schema=ParamSchema(Param("scalar", float,
                                               required=True)),
                      num_inputs=1, hint=name))
        main = "broadcast_" + canon
        ali = ["broadcast_" + name] if main != "broadcast_" + name else []
        register_op(
            OpDef(main, simple_compute(lambda attrs, a, b, f=fn: f(a, b)),
                  num_inputs=2, hint=main),
            aliases=ali)
