"""FusedLNLinear — the LM's LN-affine -> (ReLU) -> linear (+bias)
(+residual) segment as one op (counterpart of
``mxnet_tpu/ops/fused_lm.py``).

The op calls :class:`~mxnet_tpu_torch.ops.fused_kernel.FusedLNLinearFn`:
kernel A forward and kernel F backward on CUDA tensors, their plain
versions on CPU tensors, or the plain versions everywhere under
``OpContext.plain``.  Gradients reach gamma and beta through the
(1, 1, E) -> (E,) reshape, so the q, k and v segments, which share
``normed``, gamma and beta, add theirs; ``no_affine`` segments pass
constant ones and zeros, which take no gradient.  The TPU gate
``pallas_fused.supported`` (a VMEM and tile limit) has no counterpart:
only the dtype is checked, and a CUDA tensor the kernels do not take
(anything but f32/bf16) raises.  Parameter names and shapes are the JAX
package's.
"""
from __future__ import annotations

import torch

from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op
from . import fused_kernel as fk

# Which path the last FusedLNLinear call took: "kernel" (kernel A
# launched) or "plain" (its plain version: CPU tensors or a plain run).
FUSED_PATH = {"last": None}


def _arg_names(attrs):
    # residual sits BEFORE weight/bias: composition auto-creates missing
    # trailing arguments, and callers pass the residual explicitly
    args = ["data"]
    if not attrs.get("no_affine", False):
        args += ["gamma", "beta"]
    if attrs.get("has_residual", False):
        args.append("residual")
    args += ["weight", "bias"]
    return args


def _flnl_shape(attrs, in_shapes, aux_shapes):
    dshape = in_shapes[0]
    nh = attrs["num_hidden"]
    e = dshape[-1]
    out = tuple(dshape[:-1]) + (nh,)
    shapes = [dshape]
    if not attrs.get("no_affine", False):
        shapes += [(1, 1, e), (1, 1, e)]
    if attrs.get("has_residual", False):
        shapes.append(out)
    shapes += [(nh, e), (nh,)]
    return shapes, [out], []


def _flnl(attrs, inputs, aux, octx):
    ins = list(inputs)
    data = ins.pop(0)
    gamma = beta = None
    if not attrs.get("no_affine", False):
        gamma = ins.pop(0)
        beta = ins.pop(0)
    residual = ins.pop(0) if attrs.get("has_residual", False) else None
    weight = ins.pop(0)
    bias = ins.pop(0)
    relu = attrs.get("relu", False)

    lead = tuple(data.shape[:-1])
    k = data.shape[-1]
    n = weight.shape[0]
    m = 1
    for s in lead:
        m *= int(s)

    dev = data.device
    scale = (gamma.reshape(-1).float() if gamma is not None
             else torch.ones((k,), dtype=torch.float32, device=dev))
    shift = (beta.reshape(-1).float() if beta is not None
             else torch.zeros((k,), dtype=torch.float32, device=dev))
    res2 = residual.reshape(m, n) if residual is not None else None
    # the (N,) statistics ride the epilogue; this segment does not consume
    # them, so their cotangents are absent from the backward
    y, _s1, _s2 = fk.FusedLNLinearFn.apply(data.reshape(m, k), scale, shift,
                                           weight, bias, res2, relu,
                                           octx.plain)
    FUSED_PATH["last"] = ("plain" if octx.plain or dev.type == "cpu"
                          else "kernel")
    return [y.reshape(lead + (n,))], list(aux)


def register_all():
    register_op(OpDef(
        "FusedLNLinear", _flnl,
        schema=ParamSchema(Param("num_hidden", int, required=True),
                           Param("relu", bool, default=False),
                           Param("no_affine", bool, default=False),
                           Param("has_residual", bool, default=False)),
        num_inputs=lambda a: len(_arg_names(a)),
        arguments=_arg_names,
        infer_shape=_flnl_shape, hint="fusedlnlinear",
        doc="LayerNorm-affine -> (ReLU) -> linear (+bias) (+residual) as "
            "one op; kernels A (forward) and F (backward) on the card, "
            "their plain versions on the CPU."))
