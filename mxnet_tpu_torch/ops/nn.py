"""Layer ops: ``FullyConnected`` and the ``SoftmaxOutput`` loss head.

FullyConnected is a plain ``torch.matmul``, differentiated by autograd:
the JAX package leaves this product to XLA, so it has no hand-written
kernel to port.  SoftmaxOutput's gradient is :class:`SoftmaxOutputFn`,
the head's custom VJP (``mxnet_tpu/ops/nn.py``): it ignores the upstream
gradient and returns (softmax - onehot(label)) masked by
``ignore_label``, normalised and scaled by ``grad_scale``.
"""
from __future__ import annotations

import torch

from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op, simple_compute


def _fc_shape(attrs, in_shapes, aux_shapes):
    dshape = in_shapes[0]
    nh = attrs["num_hidden"]
    if attrs.get("flatten", True):
        d = 1
        for s in dshape[1:]:
            d *= s
        wshape = (nh, d)
        out = (dshape[0], nh)
    else:
        wshape = (nh, dshape[-1])
        out = tuple(dshape[:-1]) + (nh,)
    shapes = [dshape, wshape]
    if not attrs.get("no_bias", False):
        shapes.append((nh,))
    return shapes, [out], []


def _softmax_out_shape(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if attrs.get("multi_output", False):
        lshape = (d[0],) + tuple(d[2:])
    elif attrs.get("preserve_shape", False):
        lshape = tuple(d[:-1])
    else:
        lshape = (d[0],)
    return [d, lshape], [d], []


def _softmax_fwd(attrs, data):
    # normalize in f32, as the JAX head does
    d32 = data.float()
    if attrs.get("multi_output", False):
        out = torch.softmax(d32, dim=1)
    elif attrs.get("preserve_shape", False):
        out = torch.softmax(d32, dim=-1)
    else:
        out = torch.softmax(d32.reshape(data.shape[0], -1),
                            dim=-1).reshape(data.shape)
    return out.to(data.dtype)


def _onehot(ids, classes, dtype, dim):
    """One-hot along ``dim``; ids outside [0, classes) give all zeros, as
    ``jax.nn.one_hot`` does."""
    ar = torch.arange(classes, device=ids.device)
    shape = [1] * (ids.dim() + 1)
    shape[dim] = classes
    return (ids.unsqueeze(dim) == ar.reshape(shape)).to(dtype)


class SoftmaxOutputFn(torch.autograd.Function):
    """SoftmaxOutput's forward (softmax in f32) and its loss gradient
    (``mxnet_tpu/ops/nn.py`` head_bwd); the label takes no gradient."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        out = _softmax_fwd(attrs, data)
        ctx.save_for_backward(out, label)
        ctx.attrs = attrs
        return out

    @staticmethod
    def backward(ctx, _upstream):
        out, label = ctx.saved_tensors
        attrs = ctx.attrs
        use_ignore = attrs.get("use_ignore", False)
        ignore = attrs.get("ignore_label", -1.0)
        if attrs.get("multi_output", False):
            # data (N, C, ...); label (N, ...)
            grad = out - _onehot(label.long(), out.shape[1], out.dtype, 1)
            mask = label != ignore
            if use_ignore:
                grad = grad * mask.unsqueeze(1).to(out.dtype)
        else:
            flat = out if attrs.get("preserve_shape", False) \
                else out.reshape(out.shape[0], -1)
            lflat = label.reshape(flat.shape[:-1])
            grad = flat - _onehot(lflat.long(), flat.shape[-1], out.dtype,
                                  -1)
            mask = lflat != ignore
            if use_ignore:
                grad = grad * mask.unsqueeze(-1).to(out.dtype)
            grad = grad.reshape(out.shape)
        norm = attrs.get("normalization", "null")
        if norm == "batch":
            grad = grad / out.shape[0]
        elif norm == "valid":
            valid = mask.sum().to(out.dtype) if use_ignore \
                else torch.tensor(float(mask.numel()), dtype=out.dtype)
            grad = grad / torch.clamp_min(valid, 1.0)
        return grad * attrs.get("grad_scale", 1.0), None, None


def register_all():
    def _fc(attrs, data, weight, *bias):
        x = data.reshape(data.shape[0], -1) if attrs.get("flatten", True) \
            else data
        out = torch.matmul(x, weight.t())
        if bias:
            out = out + bias[0]
        return out

    register_op(OpDef(
        "FullyConnected", simple_compute(_fc),
        schema=ParamSchema(Param("num_hidden", int, required=True),
                           Param("no_bias", bool, default=False),
                           Param("flatten", bool, default=True)),
        num_inputs=lambda a: 2 if a.get("no_bias") else 3,
        arguments=lambda a: ["data", "weight"] if a.get("no_bias")
        else ["data", "weight", "bias"],
        infer_shape=_fc_shape, hint="fullyconnected"))

    def _softmax_output(attrs, data, label):
        return SoftmaxOutputFn.apply(data, label, attrs)

    register_op(OpDef(
        "SoftmaxOutput", simple_compute(_softmax_output),
        schema=ParamSchema(Param("grad_scale", float, default=1.0),
                           Param("ignore_label", float, default=-1.0),
                           Param("multi_output", bool, default=False),
                           Param("use_ignore", bool, default=False),
                           Param("preserve_shape", bool, default=False),
                           Param("normalization", str, default="null"),
                           Param("out_grad", bool, default=False)),
        num_inputs=2, arguments=["data", "label"],
        infer_shape=_softmax_out_shape, hint="softmaxoutput"),
        aliases=["Softmax"])
