"""Kernel A: fused scale/shift(+ReLU) -> matmul (+bias) (+residual) with
per-column statistics — the counterpart of ``mxnet_tpu/ops/pallas_fused.py``
(forward only).

:func:`fused_scale_relu_matmul` is the wrapper: on a CUDA tensor it
launches the hand-written kernel in ``csrc/fused_fwd.cu`` (built at first
use, see :mod:`~mxnet_tpu_torch.cuda_build`) or raises; on a CPU tensor
it runs :func:`fused_plain`, the kernel's plain PyTorch version, which
mirrors ``pallas_fused.reference_impl``.  ``LAUNCHES["fused_fwd"]``
counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import cuda_build

__all__ = ["fused_scale_relu_matmul", "fused_plain", "LAUNCHES"]

# kernel launches since the count was last set to 0 (plain-version calls
# do not count)
LAUNCHES = {"fused_fwd": 0}

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


def _check(t, name, shape, dtype, device):
    if t.device != device:
        raise ValueError("fused_scale_relu_matmul: %s on %s, x on %s"
                         % (name, t.device, device))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("fused_scale_relu_matmul: %s shape %s != %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if t.dtype != dtype:
        raise ValueError("fused_scale_relu_matmul: %s dtype %s != %s"
                         % (name, t.dtype, dtype))
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
