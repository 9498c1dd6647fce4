"""Layer ops: ``FullyConnected``, ``Convolution``, ``Activation``,
``Pooling``, ``BatchNorm``, ``Dropout``, ``LRN`` and the ``SoftmaxOutput``
loss head (names, schemas and hints as in ``mxnet_tpu/ops/nn.py``).

FullyConnected and Convolution are plain ``torch.matmul`` /
``F.conv2d``, differentiated by autograd: the JAX package leaves these
products to XLA, so they have no hand-written kernel to port.  Pooling
pads explicitly (``pooling_convention="full"`` pads the far edge) and
its average divides by kh * kw, padding included, as ``reduce_window``
does.  BatchNorm's training form is :class:`BatchNormTrainFn`, the JAX
package's custom VJP: shifted single-pass statistics with a refine pass
selected on the device, compute-dtype residuals and f32 statistics.
Dropout draws its Bernoulli mask from the executor's generator
(``OpContext.generator``) and is the identity outside training or at
p = 0; its second output is the mask scaled by 1 / (1 - p).  LRN
(AlexNet's local response normalisation across channels) is
``x / (knorm + alpha / nsize * S) ** beta``, S the sum of x^2 over
``nsize`` neighbouring channels zero-padded by ``nsize // 2`` a side,
every step in the input's dtype as the JAX package computes it, with
autograd's gradient.
SoftmaxOutput's gradient is :class:`SoftmaxOutputFn`, the head's custom
VJP: it ignores the upstream gradient and returns (softmax -
onehot(label)) masked by ``ignore_label``, normalised and scaled by
``grad_scale``.  The other loss heads (``LinearRegressionOutput``,
``LogisticRegressionOutput``, ``MAERegressionOutput``, ``MakeLoss``,
``SVMOutput``) are :class:`LossHeadFn`: their forward and the
reference's gradient, the upstream gradient ignored.

Convolution and Pooling take ``layout="NHWC"`` (the weight stays OIHW,
as in the reference) by running the NCHW op between two transposes.
Deconvolution is ``F.conv_transpose2d`` over the full output, cropped
(or zero-padded) to the reference's ``pad`` / ``adj`` /
``target_shape`` window; its weight is (C, F / g, kh, kw), the
reference's and torch's layout.  The rest of the reference's layer ops
are element-wise torch: ``LeakyReLU`` (leaky, rrelu as leaky, elu,
prelu), ``SoftmaxActivation``, ``InstanceNorm`` (population variance),
``L2Normalization``, ``Pad`` (constant, edge, reflect), ``UpSampling``
(nearest; bilinear as half-pixel interpolation, which is what
``jax.image.resize`` computes when enlarging by an integer factor; only
the first input is read, as in the reference), ``SequenceLast`` /
``SequenceMask`` / ``SequenceReverse`` over time-major data and
``IdentityAttachKLSparseReg`` (the identity, as in the reference).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op, simple_compute


def _pair(v, n=2):
    if isinstance(v, int):
        return (v,) * n
    if len(v) == 1:
        return tuple(v) * n
    return tuple(v)


def _nhwc(attrs):
    return attrs.get("layout") == "NHWC"


def _conv_shape(attrs, in_shapes, aux_shapes):
    if _nhwc(attrs):
        n, h, w, c = in_shapes[0]
    else:
        n, c, h, w = in_shapes[0]
    kh, kw = _pair(attrs["kernel"])
    sh, sw = _pair(attrs.get("stride", (1, 1)))
    ph, pw = _pair(attrs.get("pad", (0, 0)))
    dh, dw = _pair(attrs.get("dilate", (1, 1)))
    nf = attrs["num_filter"]
    shapes = [tuple(in_shapes[0]),
              (nf, c // attrs.get("num_group", 1), kh, kw)]
    if not attrs.get("no_bias", False):
        shapes.append((nf,))
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    return shapes, [(n, oh, ow, nf) if _nhwc(attrs) else (n, nf, oh, ow)], []


def _bn_shape(attrs, in_shapes, aux_shapes):
    dshape = in_shapes[0]
    axis = attrs.get("axis", 1) if len(dshape) > 1 else 0
    c = dshape[axis]
    return [dshape, (c,), (c,)], [dshape, (c,), (c,)], [(c,), (c,)]


def _pool_geometry(attrs, h, w):
    """((kh, kw), (sh, sw), (top, bottom, left, right) pads, (oh, ow))."""
    kh, kw = _pair(attrs["kernel"])
    sh, sw = _pair(attrs.get("stride", (1, 1)))
    ph, pw = _pair(attrs.get("pad", (0, 0)))
    if attrs.get("global_pool", False):
        return (h, w), (1, 1), (0, 0, 0, 0), (1, 1)
    if attrs.get("pooling_convention", "valid") == "full":
        oh = int(math.ceil((h + 2 * ph - kh) / sh)) + 1
        ow = int(math.ceil((w + 2 * pw - kw) / sw)) + 1
    else:
        oh = (h + 2 * ph - kh) // sh + 1
        ow = (w + 2 * pw - kw) // sw + 1
    eh = max(0, (oh - 1) * sh + kh - h - 2 * ph)
    ew = max(0, (ow - 1) * sw + kw - w - 2 * pw)
    return (kh, kw), (sh, sw), (ph, ph + eh, pw, pw + ew), (oh, ow)


def _pool_shape(attrs, in_shapes, aux_shapes):
    if _nhwc(attrs):
        n, h, w, c = in_shapes[0]
    else:
        n, c, h, w = in_shapes[0]
    _, _, _, (oh, ow) = _pool_geometry(attrs, h, w)
    out = (n, oh, ow, c) if _nhwc(attrs) else (n, c, oh, ow)
    return [tuple(in_shapes[0])], [out], []


def _as_nchw(fn):
    """``fn(attrs, x, *rest)`` on NCHW data, run on NHWC data (layout
    "NHWC") between two transposes."""
    def run(attrs, x, *rest):
        if not _nhwc(attrs):
            return fn(attrs, x, *rest)
        return fn(attrs, x.permute(0, 3, 1, 2), *rest).permute(0, 2, 3, 1)
    return run


def _activation(attrs, x):
    act = attrs.get("act_type", "relu")
    if act == "relu":
        return torch.relu(x)
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act == "tanh":
        return torch.tanh(x)
    if act == "softrelu":
        return torch.logaddexp(x, torch.zeros_like(x))
    if act == "softsign":
        return x / (1 + torch.abs(x))
    raise ValueError("unknown act_type %s" % act)


@_as_nchw
def _conv(attrs, data, weight, *bias):
    out = F.conv2d(data, weight, stride=_pair(attrs.get("stride", (1, 1))),
                   padding=_pair(attrs.get("pad", (0, 0))),
                   dilation=_pair(attrs.get("dilate", (1, 1))),
                   groups=attrs.get("num_group", 1))
    if bias:
        out = out + bias[0].reshape(1, -1, 1, 1)
    return out.to(data.dtype)


@_as_nchw
def _pooling(attrs, x):
    (kh, kw), stride, (top, bottom, left, right), _ = _pool_geometry(
        attrs, x.shape[2], x.shape[3])
    ptype = attrs.get("pool_type", "max")
    fill = float("-inf") if ptype == "max" else 0.0
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=fill)
    if ptype == "max":
        return F.max_pool2d(x, (kh, kw), stride)
    # the window sum, then (avg) one division by the full window size
    out = F.avg_pool2d(x, (kh, kw), stride, divisor_override=1)
    return out / (kh * kw) if ptype == "avg" else out


def _bn_stats(x, center, eps, red, bshape):
    """Batch mean and variance, f32, in the JAX package's shifted single
    pass: var = E[(x - c)^2] - (mean - c)^2 centred on c = the moving
    mean.  Where that would lose the variance to cancellation (|mean - c|
    much larger than the spread, as at the zero-initialised moving mean)
    the exact two-pass variance replaces it, for every channel, as the
    reference's ``lax.cond`` does; the selection is a ``torch.where`` on
    the device, so both variances are always computed and the host never
    waits on the predicate."""
    x32 = x.float()
    if not red:
        return x32.reshape(-1), torch.zeros_like(x32.reshape(-1))
    xc = x32 - center.reshape(bshape)
    mc = xc.mean(dim=red)
    var_fast = torch.clamp_min(xc.square().mean(dim=red) - mc.square(), 0.0)
    mean = mc + center
    mc2 = mc.square()
    bad = ((var_fast <= 1e-5 * mc2) & (1e-7 * mc2 > eps)).any()
    refine = (x32 - mean.reshape(bshape)).square().mean(dim=red)
    return mean, torch.where(bad, refine, var_fast)


def _bn_apply(x, gamma, beta, mean, inv, bshape):
    g32 = gamma.float()
    scale = (inv * g32).to(x.dtype)
    shift = (beta.float() - mean * inv * g32).to(x.dtype)
    return x * scale.reshape(bshape) + shift.reshape(bshape)


class BatchNormTrainFn(torch.autograd.Function):
    """Training-mode BatchNorm, ``(out, mean, var)`` from (x, gamma, beta,
    center): the JAX package's ``_bn_train_core`` custom VJP.  The saved
    residuals are x in its compute dtype plus the (C,) f32 statistics; the
    backward folds the mean / var outputs' cotangents into dx."""

    @staticmethod
    def forward(ctx, x, gamma, beta, center, eps, caxis):
        red = tuple(i for i in range(x.dim()) if i != caxis)
        bshape = tuple(x.shape[caxis] if i == caxis else 1
                       for i in range(x.dim()))
        mean, var = _bn_stats(x, center, eps, red, bshape)
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.geometry = (red, bshape)
        ctx.set_materialize_grads(False)
        return _bn_apply(x, gamma, beta, mean, inv, bshape), mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        red, bshape = ctx.geometry
        n = math.prod(x.shape[i] for i in red)
        xmu = x.float() - mean.reshape(bshape)
        xhat = xmu * inv.reshape(bshape)
        dy32 = dy.float() if dy is not None else torch.zeros_like(xhat)
        dbeta = dy32.sum(dim=red)
        dgamma = (dy32 * xhat).sum(dim=red)
        dx = (inv * gamma.float()).reshape(bshape) \
            * (dy32 - (dbeta / n).reshape(bshape)
               - xhat * (dgamma / n).reshape(bshape))
        if dmean is not None:
            dx = dx + (dmean / n).reshape(bshape)
        if dvar is not None:
            dx = dx + (dvar * 2.0 / n).reshape(bshape) * xmu
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None, None)


def _lrn(attrs, x):
    n = attrs["nsize"]
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    knorm = attrs.get("knorm", 2.0)
    half = n // 2
    padded = F.pad(x * x, (0, 0, 0, 0, half, half))
    # the window sum term by term, in the reference's order
    win = padded[:, 0:x.shape[1]]
    for i in range(1, n):
        win = win + padded[:, i:i + x.shape[1]]
    return x / torch.pow(knorm + (alpha / n) * win, beta)


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


def _leaky_relu(attrs, x, *rest):
    act = attrs.get("act_type", "leaky")
    slope = attrs.get("slope", 0.25)
    if act in ("leaky", "rrelu"):
        return torch.where(x > 0, x, slope * x)
    if act == "elu":
        return torch.where(x > 0, x, slope * (torch.exp(x) - 1))
    if act == "prelu":
        gamma = rest[0].reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x > 0, x, gamma * x)
    raise ValueError(act)


def _lrelu_shape(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if attrs.get("act_type", "leaky") == "prelu":
        return [d, (d[1],)], [d], []
    return [d], [d], []


def _softmax_act(attrs, x):
    if attrs.get("mode", "instance") == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


def _deconv_pad(attrs, h, w):
    """(pad h, pad w, adj h, adj w); ``target_shape`` overrides pad and
    adj so the output comes out exactly that size (the reference's
    InferPad: pad = ceil(d / 2), adj = d % 2, d = stride (in - 1) +
    kernel - target)."""
    kh, kw = _pair(attrs["kernel"])
    sh, sw = _pair(attrs.get("stride", (1, 1)))
    target = tuple(attrs.get("target_shape", ()) or ())
    if target:
        th, tw = _pair(target)
        dh = (h - 1) * sh + kh - th
        dw = (w - 1) * sw + kw - tw
        if dh < 0 or dw < 0:
            raise ValueError(
                "Deconvolution target_shape %s is larger than the maximum "
                "output %s for input %s" % (target, ((h - 1) * sh + kh,
                                                     (w - 1) * sw + kw),
                                            (h, w)))
        return (dh + 1) // 2, (dw + 1) // 2, dh % 2, dw % 2
    ph, pw = _pair(attrs.get("pad", (0, 0)))
    ah, aw = _pair(attrs.get("adj", (0, 0)))
    return ph, pw, ah, aw


def _deconv_shape(attrs, in_shapes, aux_shapes):
    n, c, h, w = in_shapes[0]
    kh, kw = _pair(attrs["kernel"])
    sh, sw = _pair(attrs.get("stride", (1, 1)))
    ph, pw, ah, aw = _deconv_pad(attrs, h, w)
    nf = attrs["num_filter"]
    shapes = [tuple(in_shapes[0]),
              (c, nf // attrs.get("num_group", 1), kh, kw)]
    if not attrs.get("no_bias", True):
        shapes.append((nf,))
    oh = (h - 1) * sh - 2 * ph + kh + ah
    ow = (w - 1) * sw - 2 * pw + kw + aw
    return shapes, [(n, nf, oh, ow)], []


def _deconv(attrs, data, weight, *bias):
    ph, pw, ah, aw = _deconv_pad(attrs, data.shape[2], data.shape[3])
    full = F.conv_transpose2d(data, weight,
                              stride=_pair(attrs.get("stride", (1, 1))),
                              groups=attrs.get("num_group", 1))
    # the reference's window: rows [pad, pad + out) of the full output,
    # zeros past its end (negative F.pad widths crop)
    out = F.pad(full, (-pw, aw - pw, -ph, ah - ph))
    if bias:
        out = out + bias[0].reshape(1, -1, 1, 1)
    return out.to(data.dtype)


def _instance_norm(attrs, x, gamma, beta):
    red = tuple(range(2, x.dim()))
    mean = x.mean(dim=red, keepdim=True)
    var = x.var(dim=red, unbiased=False, keepdim=True)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean) / torch.sqrt(var + attrs.get("eps", 1e-3)) \
        * gamma.reshape(bshape) + beta.reshape(bshape)


def _in_shape(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    return [d, (d[1],), (d[1],)], [d], []


def _l2norm(attrs, x):
    mode = attrs.get("mode", "instance")
    if mode == "instance":
        red = tuple(range(1, x.dim()))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, x.dim()))
    return x / torch.sqrt(torch.sum(x * x, dim=red, keepdim=True)
                          + attrs.get("eps", 1e-10))


def _pad(attrs, x):
    pw = attrs["pad_width"]
    widths = []
    for i in reversed(range(x.dim())):
        widths += [pw[2 * i], pw[2 * i + 1]]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return F.pad(x, widths, value=attrs.get("constant_value", 0.0))
    while widths and widths[-1] == 0 and widths[-2] == 0:
        widths = widths[:-2]       # unpadded leading (batch) dims
    return F.pad(x, widths, mode="replicate" if mode == "edge"
                 else "reflect")


def _upsampling(attrs, *xs):
    scale = attrs["scale"]
    x = xs[0]
    if attrs.get("sample_type", "nearest") == "nearest":
        return x.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                   dim=3)
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


def _seq_args(a):
    return ["data", "sequence_length"] if a.get("use_sequence_length") \
        else ["data"]


def _seq_n(a):
    return 2 if a.get("use_sequence_length") else 1


def _seq_last(attrs, data, *seq_len):
    if attrs.get("use_sequence_length", False) and seq_len:
        idx = (seq_len[0] - 1).long()
        return data[idx, torch.arange(data.shape[1], device=data.device)]
    return data[-1]


def _seqlast_shape(attrs, in_shapes, aux_shapes):
    d = in_shapes[0]
    if attrs.get("use_sequence_length"):
        return [d, (d[1],)], [tuple(d[1:])], []
    return [d], [tuple(d[1:])], []


def _time_index(data, seq_len):
    """(T, N) time indices against (N,) lengths (truncated)."""
    t = torch.arange(data.shape[0], device=data.device)[:, None]
    return t, seq_len.long()[None, :]


def _seq_mask(attrs, data, *seq_len):
    if not attrs.get("use_sequence_length", False) or not seq_len:
        return data.clone()
    t, sl = _time_index(data, seq_len[0])
    mask = (t < sl).reshape(t.shape[0], -1, *(1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full_like(
        data, attrs.get("value", 0.0)))


def _seq_reverse(attrs, data, *seq_len):
    if not attrs.get("use_sequence_length", False) or not seq_len:
        return torch.flip(data, dims=(0,))
    t, sl = _time_index(data, seq_len[0])
    src = torch.where(t < sl, sl - 1 - t, t)
    src = src.reshape(src.shape + (1,) * (data.dim() - 2)).expand_as(data)
    return torch.gather(data, 0, src)


class LossHeadFn(torch.autograd.Function):
    """A loss head: ``fwd(data)`` forward and the reference's gradient
    ``grad(out, data, label)`` backward, whatever the upstream gradient
    (the reference's custom VJPs ignore it); the label takes none."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad):
        out = fwd(data)
        ctx.save_for_backward(out, data, label)
        ctx.grad = grad
        return out

    @staticmethod
    def backward(ctx, _upstream):
        out, data, label = ctx.saved_tensors
        return ctx.grad(out, data, label), None, None, None


def _regression(fwd, grad):
    def fcompute(attrs, inputs, aux, octx):
        data, label = inputs
        scale = attrs.get("grad_scale", 1.0)

        def head_grad(out, d, l):
            n = math.prod(out.shape[1:])
            return grad(out, l.reshape(out.shape)) * scale / n

        return [LossHeadFn.apply(data, label, fwd, head_grad)], []
    return fcompute


def _make_loss(attrs, inputs, aux, octx):
    scale = attrs.get("grad_scale", 1.0)
    norm = attrs.get("normalization", "null")

    def head_grad(out, d, _label):
        g = torch.full_like(d, scale)
        if norm == "batch":
            g = g / d.shape[0]
        elif norm == "valid":
            valid = (d > attrs.get("valid_thresh", 0.0)).to(d.dtype).sum()
            g = g / torch.clamp_min(valid, 1.0)
        return g

    return [LossHeadFn.apply(inputs[0], None, torch.clone, head_grad)], []


def _svm_output(attrs, inputs, aux, octx):
    margin = attrs.get("margin", 1.0)
    reg = attrs.get("regularization_coefficient", 1.0)
    linear = attrs.get("use_linear", False)

    def head_grad(out, d, label):
        sgn = 2 * _onehot(label.long(), d.shape[1], d.dtype, -1) - 1
        if linear:   # the L1-SVM subgradient
            return -sgn * ((margin - sgn * d) > 0).to(d.dtype) * reg
        return -2.0 * sgn * torch.clamp_min(margin - sgn * d, 0.0) * reg

    return [LossHeadFn.apply(inputs[0], inputs[1], torch.clone,
                             head_grad)], []


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

    register_op(OpDef(
        "Activation", simple_compute(_activation),
        schema=ParamSchema(Param("act_type", str, required=True,
                                 enum=("relu", "sigmoid", "tanh",
                                       "softrelu", "softsign"))),
        num_inputs=1, hint="activation"))

    register_op(OpDef(
        "Convolution", simple_compute(_conv),
        schema=ParamSchema(
            Param("kernel", "shape", required=True),
            Param("stride", "shape", default=(1, 1)),
            Param("dilate", "shape", default=(1, 1)),
            Param("pad", "shape", default=(0, 0)),
            Param("num_filter", int, required=True),
            Param("num_group", int, default=1),
            Param("workspace", int, default=1024),
            Param("no_bias", bool, default=False),
            Param("cudnn_tune", str, default=None),
            Param("cudnn_off", bool, default=False),
            Param("layout", str, default=None)),
        num_inputs=lambda a: 2 if a.get("no_bias") else 3,
        arguments=lambda a: ["data", "weight"] if a.get("no_bias")
        else ["data", "weight", "bias"],
        infer_shape=_conv_shape, hint="convolution"))

    register_op(OpDef(
        "Pooling", simple_compute(_pooling),
        schema=ParamSchema(
            Param("kernel", "shape", required=True),
            Param("pool_type", str, default="max",
                  enum=("max", "avg", "sum")),
            Param("global_pool", bool, default=False),
            Param("pooling_convention", str, default="valid"),
            Param("stride", "shape", default=(1, 1)),
            Param("pad", "shape", default=(0, 0)),
            Param("layout", str, default=None)),
        num_inputs=1, infer_shape=_pool_shape, hint="pooling"))

    def _batchnorm(attrs, inputs, aux, octx):
        data, gamma, beta = inputs
        moving_mean, moving_var = aux
        eps = attrs.get("eps", 1e-3)
        momentum = attrs.get("momentum", 0.9)
        caxis = attrs.get("axis", 1) if data.dim() > 1 else 0
        if caxis < 0:
            caxis += data.dim()
        if attrs.get("fix_gamma", True):
            # a constant: the gamma parameter takes a zero gradient, and
            # weight decay still moves it, as in the reference
            gamma = torch.ones_like(gamma)
        if attrs.get("use_global_stats", False) or not octx.is_train:
            bshape = tuple(data.shape[caxis] if i == caxis else 1
                           for i in range(data.dim()))
            mean, var = moving_mean, moving_var
            out = _bn_apply(data, gamma, beta, mean,
                            torch.rsqrt(var + eps), bshape)
            return [out, mean, var], [moving_mean, moving_var]
        out, mean, var = BatchNormTrainFn.apply(
            data, gamma, beta, moving_mean.detach().float(), eps, caxis)
        new_mm = momentum * moving_mean + (1 - momentum) * mean.detach()
        new_mv = momentum * moving_var + (1 - momentum) * var.detach()
        return [out, mean, var], [new_mm, new_mv]

    def _bn_type(attrs, in_types, aux_types):
        # the output follows the data; the statistics stay f32
        f32 = np.dtype(np.float32)
        d = in_types[0] if in_types[0] is not None else f32
        return [d, f32, f32], [d, f32, f32], [f32, f32]

    register_op(OpDef(
        "BatchNorm", _batchnorm,
        schema=ParamSchema(
            Param("eps", float, default=1e-3),
            Param("momentum", float, default=0.9),
            Param("fix_gamma", bool, default=True),
            Param("use_global_stats", bool, default=False),
            Param("output_mean_var", bool, default=False),
            Param("axis", int, default=1)),
        num_inputs=3, num_outputs=3,
        num_visible_outputs=lambda a: 3 if a.get("output_mean_var") else 1,
        arguments=["data", "gamma", "beta"],
        outputs=["output", "mean", "var"],
        aux=["moving_mean", "moving_var"],
        infer_shape=_bn_shape, infer_type=_bn_type, hint="batchnorm"))

    def _dropout(attrs, inputs, aux, octx):
        (x,) = inputs
        p = attrs.get("p", 0.5)
        if not octx.is_train or p <= 0.0:
            return [x, torch.ones_like(x)], []
        keep = 1.0 - p
        mask = torch.empty_like(x).bernoulli_(keep,
                                              generator=octx.generator) / keep
        return [x * mask, mask], []

    register_op(OpDef(
        "Dropout", _dropout,
        schema=ParamSchema(Param("p", float, default=0.5),
                           Param("mode", str, default="training")),
        num_inputs=1, num_outputs=2, num_visible_outputs=1,
        outputs=["output", "mask"], hint="dropout"))

    register_op(OpDef(
        "LRN", simple_compute(_lrn),
        schema=ParamSchema(Param("nsize", int, required=True),
                           Param("alpha", float, default=1e-4),
                           Param("beta", float, default=0.75),
                           Param("knorm", float, default=2.0)),
        num_inputs=1, hint="lrn"))

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

    register_op(OpDef(
        "LeakyReLU", simple_compute(_leaky_relu),
        schema=ParamSchema(Param("act_type", str, default="leaky"),
                           Param("slope", float, default=0.25),
                           Param("lower_bound", float, default=0.125),
                           Param("upper_bound", float, default=0.334)),
        num_inputs=lambda a: 2 if a.get("act_type") == "prelu" else 1,
        arguments=lambda a: ["data", "gamma"]
        if a.get("act_type") == "prelu" else ["data"],
        infer_shape=_lrelu_shape, hint="leakyrelu"))
    register_op(OpDef(
        "SoftmaxActivation", simple_compute(_softmax_act),
        schema=ParamSchema(Param("mode", str, default="instance")),
        hint="softmaxactivation"))
    register_op(OpDef(
        "Deconvolution", simple_compute(_deconv),
        schema=ParamSchema(
            Param("kernel", "shape", required=True),
            Param("stride", "shape", default=(1, 1)),
            Param("pad", "shape", default=(0, 0)),
            Param("adj", "shape", default=(0, 0)),
            Param("target_shape", "shape", default=()),
            Param("num_filter", int, required=True),
            Param("num_group", int, default=1),
            Param("workspace", int, default=512),
            Param("no_bias", bool, default=True),
            Param("cudnn_tune", str, default=None),
            Param("cudnn_off", bool, default=False),
            Param("layout", str, default=None)),
        num_inputs=lambda a: 2 if a.get("no_bias", True) else 3,
        arguments=lambda a: ["data", "weight"] if a.get("no_bias", True)
        else ["data", "weight", "bias"],
        infer_shape=_deconv_shape, hint="deconvolution"))
    register_op(OpDef(
        "InstanceNorm", simple_compute(_instance_norm),
        schema=ParamSchema(Param("eps", float, default=1e-3)),
        num_inputs=3, arguments=["data", "gamma", "beta"],
        infer_shape=_in_shape, hint="instancenorm"))
    register_op(OpDef(
        "L2Normalization", simple_compute(_l2norm),
        schema=ParamSchema(Param("eps", float, default=1e-10),
                           Param("mode", str, default="instance")),
        hint="l2normalization"))
    register_op(OpDef(
        "Pad", simple_compute(_pad),
        schema=ParamSchema(Param("mode", str, default="constant"),
                           Param("pad_width", "shape", required=True),
                           Param("constant_value", float, default=0.0)),
        hint="pad"), aliases=["pad"])
    register_op(OpDef(
        "UpSampling", simple_compute(_upsampling),
        schema=ParamSchema(Param("scale", int, required=True),
                           Param("num_filter", int, default=0),
                           Param("sample_type", str, default="nearest"),
                           Param("multi_input_mode", str, default="concat"),
                           Param("num_args", int, default=1),
                           Param("workspace", int, default=512)),
        num_inputs=lambda a: a.get("num_args", 1),
        key_var_num_args="num_args", hint="upsampling"))

    seq_schema = ParamSchema(Param("use_sequence_length", bool,
                                   default=False),
                             Param("value", float, default=0.0),
                             Param("axis", int, default=0))
    register_op(OpDef("SequenceLast", simple_compute(_seq_last),
                      schema=seq_schema, num_inputs=_seq_n,
                      arguments=_seq_args, infer_shape=_seqlast_shape,
                      hint="sequencelast"))
    register_op(OpDef("SequenceMask", simple_compute(_seq_mask),
                      schema=seq_schema, num_inputs=_seq_n,
                      arguments=_seq_args, hint="sequencemask"))
    register_op(OpDef("SequenceReverse", simple_compute(_seq_reverse),
                      schema=seq_schema, num_inputs=_seq_n,
                      arguments=_seq_args, hint="sequencereverse"))
    register_op(OpDef(
        "IdentityAttachKLSparseReg",
        simple_compute(lambda attrs, x: x.clone()),
        schema=ParamSchema(Param("sparseness_target", float, default=0.1),
                           Param("penalty", float, default=0.001),
                           Param("momentum", float, default=0.9)),
        hint="identityattachklsparsereg"))

    def _same_shape(attrs, in_shapes, aux_shapes):
        return [in_shapes[0], in_shapes[0]], [in_shapes[0]], []

    reg_schema = ParamSchema(Param("grad_scale", float, default=1.0))
    for name, fwd, grad in (
            ("LinearRegressionOutput", torch.clone, lambda o, l: o - l),
            ("LogisticRegressionOutput", torch.sigmoid, lambda o, l: o - l),
            ("MAERegressionOutput", torch.clone,
             lambda o, l: torch.sign(o - l))):
        register_op(OpDef(name, _regression(fwd, grad), schema=reg_schema,
                          num_inputs=2, arguments=["data", "label"],
                          infer_shape=_same_shape, hint=name.lower()))
    register_op(OpDef(
        "MakeLoss", _make_loss,
        schema=ParamSchema(Param("grad_scale", float, default=1.0),
                           Param("valid_thresh", float, default=0.0),
                           Param("normalization", str, default="null")),
        hint="makeloss"), aliases=["make_loss"])

    def _svm_shape(attrs, in_shapes, aux_shapes):
        d = in_shapes[0]
        return [d, (d[0],)], [d], []

    register_op(OpDef(
        "SVMOutput", _svm_output,
        schema=ParamSchema(Param("margin", float, default=1.0),
                           Param("regularization_coefficient", float,
                                 default=1.0),
                           Param("use_linear", bool, default=False)),
        num_inputs=2, arguments=["data", "label"], infer_shape=_svm_shape,
        hint="svmoutput"))
