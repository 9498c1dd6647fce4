"""Tensor ops: ``mean``, ``Reshape``, ``Flatten``, ``Embedding`` and the
ops the RNN cells build — ``expand_dims``, ``SwapAxis``, ``Concat``
(variadic), ``SliceChannel`` (multi-output), ``zeros_like``,
``ones_like`` and ``where`` (names, schemas and hints as in
``mxnet_tpu/ops/tensor.py``).  Each is plain torch, so autograd
differentiates it: Embedding's weight gradient is the scatter-add of
torch indexing, and a SliceChannel output nothing reads takes a zero
gradient."""
from __future__ import annotations

import numpy as np
import torch

from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op, simple_compute


def _norm_axis(attrs, ndim):
    """MXNet reduce-axis semantics: axis=() -> all axes; exclude
    inverts."""
    axis = attrs.get("axis", ())
    if axis is None or axis == ():
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if attrs.get("exclude", False):
        axes = tuple(i for i in range(ndim) if i not in axes)
    return axes


_REDUCE_SCHEMA = ParamSchema(
    Param("axis", "shape", default=()),
    Param("keepdims", bool, default=False),
    Param("exclude", bool, default=False),
)


def _infer_reshape(target, in_shape, reverse=False):
    """MXNet Reshape semantics: 0 copy-dim, -1 infer, -2 copy-rest,
    -3 merge, -4 split."""
    if not target:
        return tuple(in_shape)
    src = list(in_shape[::-1]) if reverse else list(in_shape)
    tgt = list(target[::-1]) if reverse else list(target)
    out = []
    src_i = 0
    i = 0
    while i < len(tgt):
        s = tgt[i]
        if s == 0:
            out.append(src[src_i])
            src_i += 1
        elif s == -1:
            out.append(-1)
            src_i += 1
        elif s == -2:
            out.extend(src[src_i:])
            src_i = len(src)
        elif s == -3:
            out.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif s == -4:
            a, b = tgt[i + 1], tgt[i + 2]
            if a == -1:
                a = src[src_i] // b
            if b == -1:
                b = src[src_i] // a
            out.extend([a, b])
            src_i += 1
            i += 2
        else:
            out.append(s)
            src_i += 1
        i += 1
    if -1 in out:
        known = 1
        for v in out:
            if v != -1:
                known *= v
        total = 1
        for v in in_shape:
            total *= v
        out[out.index(-1)] = total // known
    return tuple(out[::-1]) if reverse else tuple(out)


def register_all():
    def _mean(attrs, x):
        axes = _norm_axis(attrs, x.ndim)
        return x.mean(dim=axes, keepdim=attrs.get("keepdims", False))

    register_op(OpDef("mean", simple_compute(_mean), schema=_REDUCE_SCHEMA,
                      hint="mean"))

    def _reshape(attrs, x):
        target = attrs.get("shape", ())
        if not target and attrs.get("target_shape"):
            target = attrs["target_shape"]
        return x.reshape(_infer_reshape(tuple(target), tuple(x.shape),
                                        attrs.get("reverse", False)))

    register_op(OpDef("Reshape", simple_compute(_reshape),
                      schema=ParamSchema(
                          Param("shape", "shape", default=()),
                          Param("reverse", bool, default=False),
                          Param("target_shape", "shape", default=()),
                          Param("keep_highest", bool, default=False)),
                      hint="reshape"),
                aliases=["reshape"])

    register_op(OpDef("Flatten",
                      simple_compute(lambda attrs, x:
                                     x.reshape(x.shape[0], -1)),
                      num_inputs=1, hint="flatten"),
                aliases=["flatten"])

    def _embedding(attrs, data, weight):
        # tokens arrive as float32 ids (the symbol's data variable).  The
        # reference's gather: truncate toward zero, wrap a negative id
        # once, clamp to the table.  On the device, with no host read
        # and no branch, so an out-of-range id neither asserts on the
        # card nor stops a capture
        n = weight.shape[0]
        idx = data.long()
        idx = torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)
        return weight[idx]

    def _embedding_shape(attrs, in_shapes, aux_shapes):
        dshape = in_shapes[0]
        wshape = (attrs["input_dim"], attrs["output_dim"])
        out = tuple(dshape) + (attrs["output_dim"],)
        return [dshape, wshape], [out], []

    def _embedding_type(attrs, in_types, aux_types):
        # ids keep their own dtype; the output follows the table's
        w = in_types[1] if in_types[1] is not None \
            else np.dtype(attrs.get("dtype", "float32"))
        d = in_types[0] if in_types[0] is not None else np.dtype(np.float32)
        return [d, w], [w], aux_types

    register_op(OpDef("Embedding", simple_compute(_embedding),
                      schema=ParamSchema(
                          Param("input_dim", int, required=True),
                          Param("output_dim", int, required=True),
                          Param("dtype", str, default="float32")),
                      num_inputs=2, arguments=["data", "weight"],
                      infer_shape=_embedding_shape,
                      infer_type=_embedding_type, hint="embedding"))

    register_op(OpDef("expand_dims",
                      simple_compute(lambda attrs, x:
                                     x.unsqueeze(attrs["axis"])),
                      schema=ParamSchema(Param("axis", int, required=True)),
                      num_inputs=1))

    register_op(OpDef("SwapAxis",
                      simple_compute(lambda attrs, x: x.transpose(
                          attrs.get("dim1", 0), attrs.get("dim2", 0))),
                      schema=ParamSchema(Param("dim1", int, default=0),
                                         Param("dim2", int, default=0)),
                      num_inputs=1, hint="swapaxis"),
                aliases=["swapaxes"])

    register_op(OpDef("Concat",
                      simple_compute(lambda attrs, *xs:
                                     torch.cat(xs, dim=attrs.get("dim", 1))),
                      schema=ParamSchema(Param("num_args", int,
                                               required=True),
                                         Param("dim", int, default=1)),
                      num_inputs=lambda a: a["num_args"],
                      arguments=lambda a: ["arg%d" % i
                                           for i in range(a["num_args"])],
                      key_var_num_args="num_args", hint="concat"),
                aliases=["concat"])

    def _split(attrs, x):
        n = attrs["num_outputs"]
        axis = attrs.get("axis", 1)
        if x.shape[axis] % n:
            raise ValueError("SliceChannel: axis %d of %s does not split "
                             "into %d equal parts" % (axis, tuple(x.shape),
                                                      n))
        parts = torch.split(x, x.shape[axis] // n, dim=axis)
        if attrs.get("squeeze_axis", False):
            parts = [p.squeeze(axis) for p in parts]
        return tuple(parts)

    register_op(OpDef("SliceChannel", simple_compute(_split),
                      schema=ParamSchema(Param("num_outputs", int,
                                               required=True),
                                         Param("axis", int, default=1),
                                         Param("squeeze_axis", bool,
                                               default=False)),
                      num_inputs=1, num_outputs=lambda a: a["num_outputs"],
                      hint="slicechannel"),
                aliases=["split"])

    register_op(OpDef("zeros_like",
                      simple_compute(lambda attrs, x: torch.zeros_like(x)),
                      num_inputs=1))
    register_op(OpDef("ones_like",
                      simple_compute(lambda attrs, x: torch.ones_like(x)),
                      num_inputs=1))

    def _where(attrs, cond, x, y):
        if cond.dim() == 1 and x.dim() > 1:
            cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(cond != 0, x, y)

    register_op(OpDef("where", simple_compute(_where), num_inputs=3,
                      arguments=["condition", "x", "y"]))
