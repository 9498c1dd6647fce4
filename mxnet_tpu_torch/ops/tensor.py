"""Tensor ops (names, schemas and hints as in
``mxnet_tpu/ops/tensor.py``): the reductions (``sum`` / ``mean`` /
``prod`` / ``nansum`` / ``nanprod`` / ``max`` / ``min``, ``norm``,
``argmax`` / ``argmin`` / ``argmax_channel``), broadcasting
(``broadcast_to`` / ``broadcast_axis``), shapes and copies
(``Reshape``, ``Flatten``, ``transpose``, ``expand_dims``, ``slice`` /
``_slice_assign`` / ``_crop_assign_scalar``, ``slice_axis``,
``repeat``, ``tile``, ``reverse``, ``SwapAxis``, ``Concat``,
``SliceChannel``), products (``dot``, ``batch_dot``), indexing
(``Embedding``, ``take``, ``batch_take``, ``one_hot``, ``pick``),
constructors (``_zeros``, ``_ones``, ``_arange``, ``zeros_like``,
``ones_like``), ordering (``topk``, ``sort``, ``argsort``), ``where``
and the softmax family (``softmax``, ``log_softmax``,
``softmax_cross_entropy``).  Each is plain torch, so autograd
differentiates it: Embedding's and take's weight gradients are the
scatter-adds of torch indexing, and a SliceChannel output nothing reads
takes a zero gradient.

The reference's dtype rules hold: integer reductions keep the input's
dtype (torch widens them to int64), ``argmax`` / ``argmin`` /
``argsort`` / ``topk``'s indices come back in the input's dtype,
``one_hot`` in its ``dtype`` attribute, ``norm`` is the flat L2 norm of
shape (1,).  ``sort`` / ``argsort`` descending are the stable ascending
order reversed, as the reference computes them.  ``softmax`` ignores
``temperature``, as the reference does.  Ops without inputs put their
output on ``OpContext.device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..attrs import Param, ParamSchema
from ..base import MXNetError
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


def _opt_int(s):
    return None if str(s) == "None" else int(float(s))


def _opt_float(s):
    return None if str(s) == "None" else float(s)


def _keep_int(fn):
    """A reduction that keeps an integer input's dtype (torch widens
    integer sums and products to int64; jnp keeps int32)."""
    def red(x, axes, keep):
        out = fn(x, axes, keep)
        return out if x.is_floating_point() else out.to(x.dtype)
    return red


def _prod(x, axes, keep):
    rest = [i for i in range(x.dim()) if i not in axes]
    out = x.permute(rest + list(axes)).reshape(
        [x.shape[i] for i in rest] + [-1]).prod(-1)
    if keep:
        out = out.reshape([1 if i in axes else x.shape[i]
                           for i in range(x.dim())])
    return out


_REDUCE = {
    "sum": _keep_int(lambda x, a, k: torch.sum(x, dim=a, keepdim=k)),
    "mean": lambda x, a, k: x.mean(dim=a, keepdim=k),
    "prod": _keep_int(_prod),
    "nansum": _keep_int(lambda x, a, k: torch.nansum(x, dim=a, keepdim=k)),
    "nanprod": _keep_int(lambda x, a, k: _prod(
        torch.where(torch.isnan(x), torch.ones_like(x), x), a, k)),
    "max": lambda x, a, k: torch.amax(x, dim=a, keepdim=k),
    "min": lambda x, a, k: torch.amin(x, dim=a, keepdim=k),
}


def _window(attrs):
    """The [begin, end) index tuple of slice and the slice assigns."""
    return tuple(slice(b, e) for b, e in zip(attrs["begin"], attrs["end"]))


def _slice_assign(attrs, lhs, rhs):
    out = lhs.clone()
    out[_window(attrs)] = rhs.to(lhs.dtype)
    return out


def _slice_assign_shape(attrs, in_shapes, aux_shapes):
    lhs = in_shapes[0]
    if lhs is None:
        raise MXNetError("_slice_assign cannot infer shapes without lhs")
    window = tuple(e - b for b, e in zip(attrs["begin"], attrs["end"]))
    return [tuple(lhs), window], [tuple(lhs)], []


def _crop_assign_scalar(attrs, data):
    out = data.clone()
    out[_window(attrs)] = attrs.get("scalar", 0.0)
    return out


def _slice_axis(attrs, x):
    axis = attrs["axis"] % x.dim()
    begin, end = attrs["begin"], attrs["end"]
    if end is None or end == 0 and begin > 0:
        end = x.shape[axis]
    if end is not None and end < 0:
        end = x.shape[axis] + end
    if begin < 0:
        begin = x.shape[axis] + begin
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


def _reverse_all(x):
    return x.permute(*reversed(range(x.dim())))


def _dot(attrs, a, b):
    if attrs.get("transpose_a", False):
        a = _reverse_all(a)
    if attrs.get("transpose_b", False):
        b = _reverse_all(b)
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b).reshape(1)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


def _batch_dot(attrs, a, b):
    if attrs.get("transpose_a", False):
        a = a.transpose(-1, -2)
    if attrs.get("transpose_b", False):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def _gather_ids(idx, n):
    """Float or integer ids as int64 rows of an n-row table: truncated,
    a negative id wrapped once, clamped (the reference's gather)."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _take(attrs, a, indices):
    axis = attrs.get("axis", 0) % a.dim()
    n = a.shape[axis]
    idx = indices.long()
    idx = idx.clamp(0, n - 1) if attrs.get("mode", "clip") == "clip" \
        else torch.remainder(idx, n)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(indices.shape)
                       + tuple(a.shape[axis + 1:]))


def _batch_take(attrs, a, indices):
    rows = torch.arange(a.shape[0], device=a.device)
    return a[rows, _gather_ids(indices, a.shape[1])]


def attr_dtype(attrs):
    """The torch dtype an op's ``dtype`` attribute names (float32 when
    unset)."""
    from ..ndarray import torch_dtype

    return torch_dtype(attrs.get("dtype", "float32") or "float32")


def _one_hot(attrs, indices):
    depth = attrs["depth"]
    on, off = attrs.get("on_value", 1.0), attrs.get("off_value", 0.0)
    ar = torch.arange(depth, device=indices.device)
    hot = (indices.long().unsqueeze(-1) == ar).to(attr_dtype(attrs))
    return hot * (on - off) + off


def _one_hot_type(attrs, in_types, aux_types):
    dt = attrs.get("dtype", "float32")
    return in_types, [torch.bfloat16 if dt == "bfloat16"
                      else np.dtype(dt)], aux_types


def _pick(attrs, data, index):
    axis = attrs.get("axis", -1) % data.dim()
    picked = torch.gather(data, axis, index.long().unsqueeze(axis))
    return picked if attrs.get("keepdims", False) else picked.squeeze(axis)


def _filled(value):
    def fcompute(attrs, inputs, aux, octx):
        out = torch.full(tuple(attrs.get("shape", ())), value,
                         dtype=attr_dtype(attrs), device=octx.device)
        return [out], []
    return fcompute


def _init_shape(attrs, in_shapes, aux_shapes):
    return [], [tuple(attrs.get("shape", ()))], []


def _arange(attrs, inputs, aux, octx):
    arr = np.arange(attrs["start"], attrs.get("stop", None),
                    attrs.get("step", 1.0))
    if attrs.get("repeat", 1) != 1:
        arr = np.repeat(arr, attrs["repeat"])
    out = torch.from_numpy(arr).to(octx.device or "cpu", attr_dtype(attrs))
    return [out], []


def _topk(attrs, x):
    axis = attrs.get("axis", -1)
    axis = x.dim() - 1 if axis is None else axis % x.dim()
    ret = attrs.get("ret_typ", "indices")
    vals, idxs = torch.topk(x, attrs.get("k", 1), dim=axis,
                            largest=not attrs.get("is_ascend", False),
                            sorted=True)
    if ret == "value":
        return vals
    if ret == "mask":
        return torch.zeros_like(x).scatter(axis, idxs, 1.0)
    if ret == "both":
        return vals, idxs.to(x.dtype)
    return idxs.to(x.dtype)


def _sorted(x, axis, ascend, indices):
    if axis is None:
        x, axis = x.reshape(-1), 0
    out = torch.argsort(x, dim=axis, stable=True) if indices \
        else torch.sort(x, dim=axis, stable=True).values
    return out if ascend else torch.flip(out, dims=(axis,))


def _softmax_cross_entropy(attrs, data, label):
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, -1, label.long().reshape(-1, 1))
    return -torch.sum(picked).reshape(1)


def register_all():
    for name, fn in _REDUCE.items():
        def _red(attrs, x, f=fn):
            axes = _norm_axis(attrs, x.dim())
            if not axes:
                return x.clone()
            return f(x, axes, attrs.get("keepdims", False))

        aliases = [name + "_axis"] if name in ("sum", "max", "min") else []
        register_op(OpDef(name, simple_compute(_red), schema=_REDUCE_SCHEMA,
                          hint=name), aliases=aliases)

    register_op(OpDef("norm", simple_compute(
        lambda attrs, x: torch.sqrt(torch.sum(x * x)).reshape(1))))

    arg_schema = ParamSchema(Param("axis", int, default=None),
                             Param("keepdims", bool, default=False))
    for name, fn in (("argmax", torch.argmax), ("argmin", torch.argmin)):
        def _arg(attrs, x, f=fn):
            axis = attrs.get("axis", None)
            keep = attrs.get("keepdims", False) and axis is not None
            return f(x, dim=axis, keepdim=keep).to(x.dtype)

        register_op(OpDef(name, simple_compute(_arg), schema=arg_schema))
    register_op(OpDef("argmax_channel", simple_compute(
        lambda attrs, x: torch.argmax(x, dim=1).to(x.dtype))))

    def _broadcast_to(attrs, x):
        shape = tuple(x.shape[i] if s == 0 else s
                      for i, s in enumerate(attrs["shape"]))
        return x.expand(shape)

    register_op(OpDef("broadcast_to", simple_compute(_broadcast_to),
                      schema=ParamSchema(Param("shape", "shape",
                                               required=True))))

    def _broadcast_axis(attrs, x):
        axes, sizes = attrs["axis"], attrs["size"]
        if isinstance(axes, int):
            axes, sizes = (axes,), (sizes,)
        shape = list(x.shape)
        for a, n in zip(axes, sizes):
            shape[a] = n
        return x.expand(tuple(shape))

    register_op(OpDef("broadcast_axis", simple_compute(_broadcast_axis),
                      schema=ParamSchema(Param("axis", "shape", default=()),
                                         Param("size", "shape", default=())),
                      hint="broadcast_axis"),
                aliases=["broadcast_axes"])

    register_op(OpDef("transpose", simple_compute(
        lambda attrs, x: x.permute(*attrs["axes"]) if attrs.get("axes")
        else _reverse_all(x)),
        schema=ParamSchema(Param("axes", "shape", default=()))))

    window_schema = (Param("begin", "shape", required=True),
                     Param("end", "shape", required=True))
    register_op(OpDef("slice", simple_compute(
        lambda attrs, x: x[_window(attrs)]),
        schema=ParamSchema(*window_schema), hint="slice"),
        aliases=["crop"])
    register_op(OpDef("_slice_assign", simple_compute(_slice_assign),
                      schema=ParamSchema(*window_schema), num_inputs=2,
                      arguments=["lhs", "rhs"],
                      infer_shape=_slice_assign_shape,
                      hint="slice_assign"),
                aliases=["_crop_assign"])
    register_op(OpDef("_crop_assign_scalar",
                      simple_compute(_crop_assign_scalar),
                      schema=ParamSchema(*window_schema,
                                         Param("scalar", float,
                                               default=0.0)),
                      infer_shape=lambda a, i, x: (i, [i[0]], []),
                      hint="crop_assign_scalar"),
                aliases=["_slice_assign_scalar"])
    register_op(OpDef("slice_axis", simple_compute(_slice_axis),
                      schema=ParamSchema(Param("axis", int, required=True),
                                         Param("begin", int, required=True),
                                         Param("end", _opt_int,
                                               default=None))))

    dot_schema = ParamSchema(Param("transpose_a", bool, default=False),
                             Param("transpose_b", bool, default=False))
    register_op(OpDef("dot", simple_compute(_dot), schema=dot_schema,
                      num_inputs=2))
    register_op(OpDef("batch_dot", simple_compute(_batch_dot),
                      schema=dot_schema, num_inputs=2))
    register_op(OpDef("repeat", simple_compute(
        lambda attrs, x: torch.repeat_interleave(
            x, attrs["repeats"], dim=attrs.get("axis", None))),
        schema=ParamSchema(Param("repeats", int, required=True),
                           Param("axis", _opt_int, default=None))))
    register_op(OpDef("tile", simple_compute(
        lambda attrs, x: torch.tile(x, tuple(attrs["reps"]))),
        schema=ParamSchema(Param("reps", "shape", required=True))))
    register_op(OpDef("reverse", simple_compute(
        lambda attrs, x: torch.flip(x, dims=tuple(attrs["axis"]))),
        schema=ParamSchema(Param("axis", "shape", required=True)),
        hint="reverse"), aliases=["flip"])

    register_op(OpDef("take", simple_compute(_take),
                      schema=ParamSchema(Param("axis", int, default=0),
                                         Param("mode", str, default="clip")),
                      num_inputs=2, arguments=["a", "indices"]))
    register_op(OpDef("batch_take", simple_compute(_batch_take),
                      num_inputs=2, arguments=["a", "indices"]))
    register_op(OpDef("one_hot", simple_compute(_one_hot),
                      schema=ParamSchema(Param("depth", int, required=True),
                                         Param("on_value", float,
                                               default=1.0),
                                         Param("off_value", float,
                                               default=0.0),
                                         Param("dtype", str,
                                               default="float32")),
                      arguments=["indices"], infer_type=_one_hot_type))
    register_op(OpDef("pick", simple_compute(_pick),
                      schema=ParamSchema(Param("axis", int, default=-1),
                                         Param("keepdims", bool,
                                               default=False)),
                      num_inputs=2, arguments=["data", "index"]))

    init_schema = ParamSchema(Param("shape", "shape", default=()),
                              Param("ctx", str, default=""),
                              Param("dtype", str, default="float32"))
    register_op(OpDef("_zeros", _filled(0), schema=init_schema,
                      num_inputs=0, infer_shape=_init_shape, hint="zeros"))
    register_op(OpDef("_ones", _filled(1), schema=init_schema,
                      num_inputs=0, infer_shape=_init_shape, hint="ones"))
    register_op(OpDef("_arange", _arange,
                      schema=ParamSchema(Param("start", float, default=0.0),
                                         Param("stop", _opt_float,
                                               default=None),
                                         Param("step", float, default=1.0),
                                         Param("repeat", int, default=1),
                                         Param("dtype", str,
                                               default="float32")),
                      num_inputs=0, hint="arange"))

    register_op(OpDef("topk", simple_compute(_topk),
                      schema=ParamSchema(Param("axis", _opt_int, default=-1),
                                         Param("k", int, default=1),
                                         Param("ret_typ", str,
                                               default="indices"),
                                         Param("is_ascend", bool,
                                               default=False)),
                      num_outputs=lambda a: 2 if a.get("ret_typ") == "both"
                      else 1))
    sort_schema = ParamSchema(Param("axis", _opt_int, default=-1),
                              Param("is_ascend", bool, default=True))
    register_op(OpDef("sort", simple_compute(
        lambda attrs, x: _sorted(x, attrs.get("axis", -1),
                                 attrs.get("is_ascend", True), False)),
        schema=sort_schema))
    register_op(OpDef("argsort", simple_compute(
        lambda attrs, x: _sorted(x, attrs.get("axis", -1),
                                 attrs.get("is_ascend", True),
                                 True).to(x.dtype)),
        schema=sort_schema))

    sm_schema = ParamSchema(Param("axis", int, default=-1),
                            Param("temperature", _opt_float, default=None))
    register_op(OpDef("softmax", simple_compute(
        lambda attrs, x: torch.softmax(x, dim=attrs.get("axis", -1))),
        schema=sm_schema))
    register_op(OpDef("log_softmax", simple_compute(
        lambda attrs, x: torch.log_softmax(x, dim=attrs.get("axis", -1))),
        schema=sm_schema))
    register_op(OpDef("softmax_cross_entropy",
                      simple_compute(_softmax_cross_entropy), num_inputs=2,
                      arguments=["data", "label"]))

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
        return weight[_gather_ids(data, weight.shape[0])]

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
