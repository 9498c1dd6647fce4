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

Which variant of a kernel runs is chosen here, by :func:`_plan`, from the
shape and dtype alone, and handed to the C entry as an int:

* ``decode`` (kernel A, M <= 16): weight streaming, one warp per output
  column;
* ``simt128`` / ``simt64`` / ``simt32``: the f32 tile engine of
  ``csrc/fused_tiles.cuh`` with square tiles of that side, the largest
  that gives the grid about one block per SM (``SMS``);
* ``wgmma128`` (kernel A): bf16 on the tensor cores by
  ``wgmma.mma_async``, 128 x 128 tiles, the activation built in
  registers;
* ``mma128`` / ``mma64``: bf16 on the tensor cores by ``mma.sync``
  (kernel A at the serve's chunks takes ``mma64``; kernel F both);
* a ``_scalar`` suffix: the same kernel with scalar loads, for widths
  that are not multiples of the 16-byte load or unaligned pointers
  (bf16 shapes the tensor-core path cannot load take the scalar f32
  engine).

Kernel F's dW product splits its contraction over M into ``splits``
ranges when its (N, K) tiles are too few to fill the card; the partials
are summed in a fixed order, so dW stays deterministic.
``LAST_VARIANT`` records what the last launch of each kernel ran.
"""
from __future__ import annotations

from collections import namedtuple

import torch

from .. import cuda_build

__all__ = ["fused_scale_relu_matmul", "fused_plain", "fused_bwd",
           "fused_bwd_plain", "FusedLNLinearFn", "LAUNCHES", "LAST_VARIANT",
           "VARIANTS"]

# kernel launches since the count was last set to 0 (plain-version calls
# do not count)
LAUNCHES = {"fused_fwd": 0, "fused_bwd": 0}
# the variant(s) the last launch ran: kernel A's name; kernel F's
# "<dx variant>/<dW variant>x<splits>"
LAST_VARIANT = {"fused_fwd": None, "fused_bwd": None}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the C entries' variant codes (csrc/fused_fwd.cu, csrc/fused_bwd.cu)
VARIANTS = ("decode", "decode_scalar", "simt128", "simt128_scalar",
            "simt64", "simt64_scalar", "simt32", "simt32_scalar", "mma128",
            "mma64", "wgmma128")
SMS = 132            # streaming multiprocessors of an H100 SXM
DECODE_ROWS = 16     # kernel A streams W up to this many rows
DW_SPLIT_MIN_M = 1024  # dW splits M only when M is at least this deep
DW_SPLIT_ROWS = 1024   # and each range keeps at least this many rows
MAX_SPLITS = 16

Plan = namedtuple("Plan", "variant code splits")


def _cdiv(a, b):
    return -(-a // b)


def _plan(m, k, n, dtype, product="fwd", aligned=True):
    """The variant of kernel A (``product="fwd"``) or of one of kernel
    F's products (``"dx"``, ``"dw"``) for x (m, k), W (n, k) in
    ``dtype``: a :class:`Plan` of the variant's name, its C code and,
    for dW, the number of ranges M is split into.  ``aligned``: every
    pointer is 16-byte aligned.  The C entry sizes its grid from the
    variant's tile side."""
    bf16 = dtype == torch.bfloat16
    if product == "fwd" and m <= DECODE_ROWS:
        width = 8 if bf16 else 4   # elements of a 16-byte load
        vec = aligned and k % width == 0
        variant = "decode" if vec else "decode_scalar"
        return Plan(variant, VARIANTS.index(variant), 1)
    # output rows, columns and the contraction of the product
    rows, cols, depth = {"fwd": (m, n, k), "dx": (m, k, n),
                         "dw": (n, k, m)}[product]
    mma = bf16 and aligned and k % 8 == 0 and n % 8 == 0
    vec = not bf16 and aligned and k % 4 == 0 and n % 4 == 0
    sides = (128, 64) if mma else (128, 64, 32)

    def blocks(side):
        return _cdiv(rows, side) * _cdiv(cols, side)

    if product == "dw" and depth >= DW_SPLIT_MIN_M:
        side = 128          # a deep contraction: split it, keep the tile
    else:
        side = next((t for t in sides if blocks(t) >= SMS), sides[-1])
    splits = 1
    if product == "dw" and depth >= DW_SPLIT_MIN_M:
        splits = max(1, min(MAX_SPLITS, (2 * SMS) // blocks(side),
                            depth // DW_SPLIT_ROWS))
    if mma and product == "fwd" and side == 128:
        variant = "wgmma128"
    elif mma:
        variant = "mma%d" % side
    else:
        variant = "simt%d%s" % (side, "" if vec else "_scalar")
    return Plan(variant, VARIANTS.index(variant), splits)


def _aligned(*tensors):
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


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
    plan = _plan(m, k, n, x.dtype, "fwd",
                 _aligned(x, w, scale, shift, bias, residual, y))
    lib = cuda_build.lib("fused_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_fwd(
            code, x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            w.data_ptr(), bias.data_ptr() if bias is not None else None,
            residual.data_ptr() if residual is not None else None,
            y.data_ptr(), s1.data_ptr(), s2.data_ptr(), m, k, n,
            int(bool(relu)), plan.code, stream)
    cuda_build.check(lib, rc, "fused_fwd")
    LAUNCHES["fused_fwd"] += 1
    LAST_VARIANT["fused_fwd"] = plan.variant
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
    aligned = _aligned(x, dy, w, scale, shift, dx, dw)
    pdx = _plan(m, k, n, x.dtype, "dx", aligned)
    pdw = _plan(m, k, n, x.dtype, "dw", aligned)
    # the dW partials, summed by the kernel's second pass
    part = (torch.empty((pdw.splits, n, k), dtype=torch.float32, device=dev)
            if pdw.splits > 1 else None)
    lib = cuda_build.lib("fused_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_bwd(code, x.data_ptr(), dy.data_ptr(),
                           scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
                           dx.data_ptr(), dw.data_ptr(), dscale.data_ptr(),
                           dshift.data_ptr(), m, k, n, int(bool(relu)),
                           pdx.code, pdw.code, pdw.splits,
                           part.data_ptr() if part is not None else None,
                           stream)
    cuda_build.check(lib, rc, "fused_bwd")
    LAUNCHES["fused_bwd"] += 1
    LAST_VARIANT["fused_bwd"] = "%s/%sx%d" % (pdx.variant, pdw.variant,
                                              pdw.splits)
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
