"""Tensor ops of the LM: ``mean``, ``Reshape`` and ``Embedding`` (names,
schemas and hints as in ``mxnet_tpu/ops/tensor.py``).  Each is plain
torch, so autograd differentiates it; Embedding's weight gradient is
the scatter-add of torch indexing."""
from __future__ import annotations

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

    def _embedding(attrs, data, weight):
        # tokens arrive as float32 ids (the symbol's data variable)
        return weight[data.long()]

    def _embedding_shape(attrs, in_shapes, aux_shapes):
        dshape = in_shapes[0]
        wshape = (attrs["input_dim"], attrs["output_dim"])
        out = tuple(dshape) + (attrs["output_dim"],)
        return [dshape, wshape], [out], []

    register_op(OpDef("Embedding", simple_compute(_embedding),
                      schema=ParamSchema(
                          Param("input_dim", int, required=True),
                          Param("output_dim", int, required=True),
                          Param("dtype", str, default="float32")),
                      num_inputs=2, arguments=["data", "weight"],
                      infer_shape=_embedding_shape, hint="embedding"))
