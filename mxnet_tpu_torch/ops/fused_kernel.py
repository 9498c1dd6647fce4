"""Kernels A and F: fused scale/shift(+ReLU) -> matmul (+bias) (+residual)
with per-column statistics, forward and backward — the counterpart of
``mxnet_tpu/ops/pallas_fused.py``.

* :func:`fused_scale_relu_matmul` (kernel A, ``csrc/fused_fwd.cu``) and
  its plain version :func:`fused_plain`, which mirrors
  ``pallas_fused.reference_impl``;
* :func:`fused_bwd` (kernel F, ``csrc/fused_bwd.cu``): dx, dW, dscale
  and dshift from x and dy, and its plain version
  :func:`fused_bwd_plain`;
* :class:`FusedLNLinearFn`: the autograd Function pairing them, with the
  statistics outputs' cotangents folded into dy as the TPU path's custom
  VJP folds them.

Each wrapper launches its kernel on a CUDA tensor (built at first use,
see :mod:`~mxnet_tpu_torch.cuda_build`) or raises, and runs its plain
version on a CPU tensor.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import cuda_build

__all__ = ["fused_scale_relu_matmul", "fused_plain", "fused_bwd",
           "fused_bwd_plain", "FusedLNLinearFn", "LAUNCHES"]

# kernel launches since the count was last set to 0 (plain-version calls
# do not count)
LAUNCHES = {"fused_fwd": 0, "fused_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_plain(x, scale, shift, w, residual=None, relu=True, bias=None,
                wt=True):
    """Plain PyTorch version: ``(y, ysum, ysumsq)`` with the TPU kernel's
    numerics — the activation is cast to x's dtype before an f32-accumulated
    product, y is cast back to x's dtype, and the statistics are sums of the
    stored y."""
    a = x.float() * scale + shift
    if relu:
        a = torch.clamp_min(a, 0.0)
    a = a.to(x.dtype).float()
    wf = w.float()
    y = torch.matmul(a, wf.t() if wt else wf)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    y = y.to(x.dtype)
    y32 = y.float()
    return y, y32.sum(0), (y32 * y32).sum(0)


def _check(t, name, shape, dtype, device, where="fused_scale_relu_matmul"):
    if t.device != device:
        raise ValueError("%s: %s on %s, x on %s"
                         % (where, name, t.device, device))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s: %s shape %s != %s"
                         % (where, name, tuple(t.shape), tuple(shape)))
    if t.dtype != dtype:
        raise ValueError("%s: %s dtype %s != %s"
                         % (where, name, t.dtype, dtype))
    return t.contiguous()


def fused_scale_relu_matmul(x, scale, shift, w, residual=None, relu=True,
                            bias=None, wt=True):
    """y = [relu](x*scale + shift) @ W^T (+ bias) (+ residual); returns
    ``(y, ysum, ysumsq)``.

    x: (M, K) f32 or bf16; scale, shift: (K,) f32; w: (N, K) in x's dtype
    (FullyConnected's layout, ``wt=True``); bias: (N,) or None; residual:
    (M, N) in x's dtype or None.  ysum/ysumsq are the per-column sums of
    the stored y (f32).  CPU tensors take :func:`fused_plain`; CUDA
    tensors launch kernel A."""
    if x.device.type == "cpu":
        return fused_plain(x, scale, shift, w, residual=residual, relu=relu,
                           bias=bias, wt=wt)
    if not wt:
        raise NotImplementedError(
            "fused_scale_relu_matmul: only the (N, K) weight layout "
            "(wt=True) has a kernel")
    code = _DTYPE_CODE.get(x.dtype)
    if code is None or x.dim() != 2:
        raise ValueError("fused_scale_relu_matmul: x must be a 2-D f32 or "
                         "bf16 tensor (got %s %s)" % (x.dtype,
                                                      tuple(x.shape)))
    if x.device.type != "cuda":
        raise ValueError("fused_scale_relu_matmul: unsupported device %s"
                         % x.device)
    m, k = x.shape
    n = w.shape[0]
    dev = x.device
    x = x.contiguous()
    w = _check(w, "w", (n, k), x.dtype, dev)
    scale = _check(scale, "scale", (k,), torch.float32, dev)
    shift = _check(shift, "shift", (k,), torch.float32, dev)
    if bias is not None:
        bias = _check(bias.float(), "bias", (n,), torch.float32, dev)
    if residual is not None:
        residual = _check(residual, "residual", (m, n), x.dtype, dev)
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    s1 = torch.zeros((n,), dtype=torch.float32, device=dev)
    s2 = torch.zeros((n,), dtype=torch.float32, device=dev)
    lib = cuda_build.lib("fused_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_fwd(
            code, x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            w.data_ptr(), bias.data_ptr() if bias is not None else None,
            residual.data_ptr() if residual is not None else None,
            y.data_ptr(), s1.data_ptr(), s2.data_ptr(), m, k, n,
            int(bool(relu)), stream)
    cuda_build.check(lib, rc, "fused_fwd")
    LAUNCHES["fused_fwd"] += 1
    return y, s1, s2


def fused_bwd_plain(x, dy, scale, shift, w, relu):
    """Plain PyTorch version of kernel F: ``(dx, dw, dscale, dshift)``
    with the TPU kernel's numerics — u recomputed from x, the activation
    cast to dy's dtype for dW, f32 products, the strict ``u > 0`` ReLU
    mask, dx cast to x's dtype, dW / dscale / dshift in f32."""
    x32 = x.float()
    u = x32 * scale + shift
    a = torch.clamp_min(u, 0.0) if relu else u
    dyf = dy.float()
    dw = torch.matmul(dyf.t(), a.to(dy.dtype).float())
    dz = torch.matmul(dyf, w.float())
    du = torch.where(u > 0, dz, torch.zeros_like(dz)) if relu else dz
    dx = (du * scale).to(x.dtype)
    return dx, dw, (du * x32).sum(0), du.sum(0)


def fused_bwd(x, dy, scale, shift, w, relu):
    """dx (M, K) in x's dtype, dW (N, K) f32, dscale and dshift (K,) f32
    for y = [relu](x*scale + shift) @ W^T; dy (M, N) in x's dtype, w
    (N, K).  CPU tensors take :func:`fused_bwd_plain`; CUDA tensors
    launch kernel F."""
    if x.device.type == "cpu":
        return fused_bwd_plain(x, dy, scale, shift, w, relu)
    code = _DTYPE_CODE.get(x.dtype)
    if code is None or x.dim() != 2:
        raise ValueError("fused_bwd: x must be a 2-D f32 or bf16 tensor "
                         "(got %s %s)" % (x.dtype, tuple(x.shape)))
    if x.device.type != "cuda":
        raise ValueError("fused_bwd: unsupported device %s" % x.device)
    m, k = x.shape
    n = w.shape[0]
    dev = x.device
    x = x.contiguous()
    dy = _check(dy, "dy", (m, n), x.dtype, dev, "fused_bwd")
    w = _check(w, "w", (n, k), x.dtype, dev, "fused_bwd")
    scale = _check(scale, "scale", (k,), torch.float32, dev, "fused_bwd")
    shift = _check(shift, "shift", (k,), torch.float32, dev, "fused_bwd")
    dx = torch.empty_like(x)
    dw = torch.empty((n, k), dtype=torch.float32, device=dev)
    dscale = torch.zeros((k,), dtype=torch.float32, device=dev)
    dshift = torch.zeros((k,), dtype=torch.float32, device=dev)
    lib = cuda_build.lib("fused_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_bwd(code, x.data_ptr(), dy.data_ptr(),
                           scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
                           dx.data_ptr(), dw.data_ptr(), dscale.data_ptr(),
                           dshift.data_ptr(), m, k, n, int(bool(relu)),
                           stream)
    cuda_build.check(lib, rc, "fused_bwd")
    LAUNCHES["fused_bwd"] += 1
    return dx, dw, dscale, dshift


class FusedLNLinearFn(torch.autograd.Function):
    """Differentiable kernel A: ``(y, ysum, ysumsq)`` from (x, scale,
    shift, w, bias, residual), forward through kernel A and backward
    through kernel F (their plain versions on CPU tensors and under
    ``plain``).

    The backward folds the statistics' cotangents into an effective dy,
    ``dy + dysum + 2 y dysumsq`` in f32 cast to x's dtype
    (``pallas_fused.py`` custom VJP); dbias is that dy's column sum in
    f32, dresidual the cast dy itself, and dW is cast to w's dtype.
    bias and residual may be None."""

    @staticmethod
    def forward(ctx, x, scale, shift, w, bias, residual, relu, plain):
        fwd = fused_plain if plain else fused_scale_relu_matmul
        y, s1, s2 = fwd(x, scale, shift, w, residual=residual, relu=relu,
                        bias=bias, wt=True)
        ctx.save_for_backward(x, scale, shift, w, y)
        ctx.args = (relu, plain, bias is not None, residual is not None)
        ctx.set_materialize_grads(False)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, dysum, dysumsq):
        x, scale, shift, w, y = ctx.saved_tensors
        relu, plain, has_bias, has_res = ctx.args
        dy32 = (dy.float() if dy is not None
                else torch.zeros(y.shape, dtype=torch.float32,
                                 device=y.device))
        if dysum is not None:
            dy32 = dy32 + dysum[None, :]
        if dysumsq is not None:
            dy32 = dy32 + 2.0 * y.float() * dysumsq[None, :]
        dy_eff = dy32.to(x.dtype)
        bwd = fused_bwd_plain if plain else fused_bwd
        dx, dw, dscale, dshift = bwd(x, dy_eff, scale, shift, w, relu)
        need = ctx.needs_input_grad
        return (dx, dscale if need[1] else None,
                dshift if need[2] else None, dw.to(w.dtype),
                dy32.sum(0) if has_bias else None,
                dy_eff if has_res else None, None, None)
