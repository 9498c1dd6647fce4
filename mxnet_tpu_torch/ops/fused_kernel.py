"""Kernels A and F: fused scale/shift(+ReLU) -> matmul (+bias) (+residual)
with per-column statistics, forward and backward — the counterpart of
``mxnet_tpu/ops/pallas_fused.py``.

* :func:`fused_scale_relu_matmul` (kernel A, ``csrc/fused_fwd.cu``) and
  its plain version :func:`fused_plain`, which mirrors
  ``pallas_fused.reference_impl``: the wrapper calls the torch operator
  ``mxnet_tpu_torch::fused_fwd`` (:func:`fused_fwd_op`), whose CUDA
  implementation is the launch and whose CPU implementation is the plain
  version, so a traced graph (``torch.export``) holds one node that
  launches kernel A once its tensors are on the card;
* :func:`fused_bwd` (kernel F, ``csrc/fused_bwd.cu``): dx, dW, dscale
  and dshift from x and dy, through the operator
  ``mxnet_tpu_torch::fused_bwd`` (:func:`fused_bwd_op`), and its plain
  version :func:`fused_bwd_plain`.  F's operator is A's operator's
  registered gradient, so a traced training graph holds both nodes;
* :class:`FusedLNLinearFn`: the path onto the two operators (or, under
  ``plain``, their plain versions), with the statistics outputs'
  cotangents folded into dy as the TPU path's custom VJP folds them.

Each operator launches its kernel on a CUDA tensor (built at first use,
see :mod:`~mxnet_tpu_torch.cuda_build`) or raises, and runs its plain
version on a CPU tensor through the operator's dispatch.  ``LAUNCHES``
counts kernel launches.

Which variant of a kernel runs is chosen here, by :func:`_plan`, from the
shape and dtype alone, and handed to the C entry as an int:

* ``decode`` (kernel A, M <= 16): weight streaming, one warp per output
  column;
* ``simt128`` / ``simt64`` / ``simt32``: the f32 tile engine of
  ``csrc/fused_tiles.cuh`` with square tiles of that side, the largest
  that gives the grid about one block per SM (the card's SM count);
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

The tile sides and the split cap are the tunable space ``"fused_kernel"``
(``ops/tuning.py``): ``fwd_side`` (A), ``dx_side`` and ``dw_side`` (F's
products) and ``dw_splits`` (F's cap on the split count, ``MAX_SPLITS``),
0 meaning the rule above, keyed by the ``(m, k, n)`` class and the
dtype.  With a cold cache every plan is the rule's.  A's weight-streaming
``decode`` variant stays outside the space.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from .. import cuda_build

__all__ = ["fused_scale_relu_matmul", "fused_fwd_op", "fused_plain",
           "fused_bwd", "fused_bwd_op", "fused_bwd_plain", "FusedLNLinearFn",
           "LAUNCHES",
           "LAST_VARIANT", "VARIANTS"]

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
# the SM count _plan assumes when it is given none (an H100 SXM's); a
# launch passes its card's
SMS = 132
DECODE_ROWS = 16     # kernel A streams W up to this many rows
DW_SPLIT_MIN_M = 1024  # dW splits M only when M is at least this deep
DW_SPLIT_ROWS = 1024   # and each range keeps at least this many rows
MAX_SPLITS = 16

Plan = namedtuple("Plan", "variant code splits")

# the tunable space's params (0 = the rule) and the product each sizes
TUNE_DEFAULTS = {"fwd_side": 0, "dx_side": 0, "dw_side": 0, "dw_splits": 0}
_SIDE_PARAM = {"fwd": "fwd_side", "dx": "dx_side", "dw": "dw_side"}


def _cdiv(a, b):
    return -(-a // b)


def _plan(m, k, n, dtype, product="fwd", aligned=True, params=None,
          sms=SMS):
    """The variant of kernel A (``product="fwd"``) or of one of kernel
    F's products (``"dx"``, ``"dw"``) for x (m, k), W (n, k) in
    ``dtype``: a :class:`Plan` of the variant's name, its C code and,
    for dW, the number of ranges M is split into.  ``aligned``: every
    pointer is 16-byte aligned.  ``params``: the resolved tunable space
    (``TUNE_DEFAULTS`` keys; None or 0 = the rule); ``sms``: the card's
    SM count.  The C entry sizes its grid from the variant's tile
    side."""
    params = params or TUNE_DEFAULTS
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

    want = params.get(_SIDE_PARAM[product], 0)
    if want in sides:
        side = want         # the tuned side
    elif product == "dw" and depth >= DW_SPLIT_MIN_M:
        side = 128          # a deep contraction: split it, keep the tile
    else:
        side = next((t for t in sides if blocks(t) >= sms), sides[-1])
    splits = 1
    if product == "dw" and depth >= DW_SPLIT_MIN_M:
        cap = params.get("dw_splits", 0) or MAX_SPLITS
        splits = max(1, min(cap, (2 * sms) // blocks(side),
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


def _tuned(m, k, n, dtype, dev):
    """The tuning cache's resolution for this ``(m, k, n)`` class —
    ``TUNE_DEFAULTS`` when the cache is cold and no sweep is armed."""
    from . import tuning

    return tuning.resolve("fused_kernel",
                          tuning.shape_class_for(m=m, k=k, n=n),
                          _dtype_name(dtype), device=dev)


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


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


def _refuse_meta(x, where):
    """A ``meta`` tensor given directly (not a fake one of a traced graph)
    stands for a device no kernel runs on: raise, as a launch would."""
    if x.device.type == "meta" and not is_fake(x):
        raise ValueError("%s: unsupported device %s" % (where, x.device))


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


def _fused_fwd_check(x, scale, shift, w, bias, residual):
    """Kernel A's contract for a tensor off the host (a CUDA tensor, or a
    fake one while a graph is traced): ``(m, k, n)``, or a ValueError
    naming what the kernel does not take."""
    if _DTYPE_CODE.get(x.dtype) is None or x.dim() != 2:
        raise ValueError("fused_scale_relu_matmul: x must be a 2-D f32 or "
                         "bf16 tensor (got %s %s)" % (x.dtype,
                                                      tuple(x.shape)))
    m, k = x.shape
    n = w.shape[0]
    dev = x.device
    _check(w, "w", (n, k), x.dtype, dev)
    _check(scale, "scale", (k,), torch.float32, dev)
    _check(shift, "shift", (k,), torch.float32, dev)
    if bias is not None:
        _check(bias.float(), "bias", (n,), torch.float32, dev)
    if residual is not None:
        _check(residual, "residual", (m, n), x.dtype, dev)
    return m, k, n


@torch.library.custom_op("mxnet_tpu_torch::fused_fwd", mutates_args=(),
                         device_types="cuda")
def fused_fwd_op(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 w: torch.Tensor, bias: Optional[torch.Tensor],
                 residual: Optional[torch.Tensor], relu: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel A as a torch operator: its CUDA implementation launches
    ``csrc/fused_fwd.cu``; its CPU implementation is :func:`fused_plain`;
    its fake implementation gives the shapes and dtypes a launch gives,
    so a traced (exported) graph holds this one node."""
    m, k, n = _fused_fwd_check(x, scale, shift, w, bias, residual)
    params = _tuned(m, k, n, x.dtype, x.device) if m > DECODE_ROWS \
        else None
    return _fwd_launch(x, scale, shift, w, bias, residual, relu, params)


def _fwd_launch(x, scale, shift, w, bias, residual, relu, params):
    """Launch kernel A on checked CUDA tensors under the space's
    ``params`` (None: the rule's plan)."""
    m, k = x.shape
    n = w.shape[0]
    dev = x.device
    x = x.contiguous()
    w = w.contiguous()
    scale = scale.contiguous()
    shift = shift.contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    if residual is not None:
        residual = residual.contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    s1 = torch.zeros((n,), dtype=torch.float32, device=dev)
    s2 = torch.zeros((n,), dtype=torch.float32, device=dev)
    plan = _plan(m, k, n, x.dtype, "fwd",
                 _aligned(x, w, scale, shift, bias, residual, y), params,
                 cuda_build.sm_count(dev))
    lib = cuda_build.lib("fused_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_fwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), w.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            residual.data_ptr() if residual is not None else None,
            y.data_ptr(), s1.data_ptr(), s2.data_ptr(), m, k, n,
            int(bool(relu)), plan.code, stream)
    cuda_build.check(lib, rc, "fused_fwd")
    LAUNCHES["fused_fwd"] += 1
    LAST_VARIANT["fused_fwd"] = plan.variant
    return y, s1, s2


@fused_fwd_op.register_kernel("cpu")
def _fused_fwd_cpu(x, scale, shift, w, bias, residual, relu):
    return fused_plain(x, scale, shift, w, residual=residual, relu=relu,
                       bias=bias)


@fused_fwd_op.register_fake
def _fused_fwd_fake(x, scale, shift, w, bias, residual, relu):
    if x.device.type == "cpu":
        m, n = x.shape[0], w.shape[0]
    else:
        m, _, n = _fused_fwd_check(x, scale, shift, w, bias, residual)
        _refuse_meta(x, "fused_scale_relu_matmul")
    return (x.new_empty((m, n)),
            x.new_empty((n,), dtype=torch.float32),
            x.new_empty((n,), dtype=torch.float32))


def fused_scale_relu_matmul(x, scale, shift, w, residual=None, relu=True,
                            bias=None, wt=True):
    """y = [relu](x*scale + shift) @ W^T (+ bias) (+ residual); returns
    ``(y, ysum, ysumsq)``.

    x: (M, K) f32 or bf16; scale, shift: (K,) f32; w: (N, K) in x's dtype
    (FullyConnected's layout, ``wt=True``; ``wt=False`` takes a (K, N)
    weight, passed on transposed); bias: (N,) or None; residual: (M, N)
    in x's dtype or None.  ysum/ysumsq are the per-column sums of the
    stored y (f32).  The call is the operator ``mxnet_tpu_torch::
    fused_fwd``: CPU tensors take :func:`fused_plain`, CUDA tensors
    launch kernel A, and any other device raises."""
    return fused_fwd_op(x, scale, shift, w if wt else w.t(), bias,
                        residual, bool(relu))


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


def _fused_bwd_check(x, dy, scale, shift, w):
    """Kernel F's contract for a tensor off the host (a CUDA tensor, or a
    fake one while a graph is traced): ``(m, k, n)``, or a ValueError
    naming what the kernel does not take."""
    if _DTYPE_CODE.get(x.dtype) is None or x.dim() != 2:
        raise ValueError("fused_bwd: x must be a 2-D f32 or bf16 tensor "
                         "(got %s %s)" % (x.dtype, tuple(x.shape)))
    m, k = x.shape
    n = w.shape[0]
    dev = x.device
    _check(dy, "dy", (m, n), x.dtype, dev, "fused_bwd")
    _check(w, "w", (n, k), x.dtype, dev, "fused_bwd")
    _check(scale, "scale", (k,), torch.float32, dev, "fused_bwd")
    _check(shift, "shift", (k,), torch.float32, dev, "fused_bwd")
    return m, k, n


@torch.library.custom_op("mxnet_tpu_torch::fused_bwd", mutates_args=(),
                         device_types="cuda")
def fused_bwd_op(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor, w: torch.Tensor, relu: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Kernel F as a torch operator: its CUDA implementation launches
    ``csrc/fused_bwd.cu``; its CPU implementation is
    :func:`fused_bwd_plain`; its fake implementation gives the shapes and
    dtypes, so a traced training graph holds this one node."""
    m, k, n = _fused_bwd_check(x, dy, scale, shift, w)
    return _bwd_launch(x, dy, scale, shift, w, relu,
                       _tuned(m, k, n, x.dtype, x.device))


@fused_bwd_op.register_kernel("cpu")
def _fused_bwd_cpu(x, dy, scale, shift, w, relu):
    return fused_bwd_plain(x, dy, scale, shift, w, relu)


@fused_bwd_op.register_fake
def _fused_bwd_fake(x, dy, scale, shift, w, relu):
    if x.device.type != "cpu":
        _fused_bwd_check(x, dy, scale, shift, w)
        _refuse_meta(x, "fused_bwd")
    k, n = x.shape[1], w.shape[0]
    f32 = torch.float32
    return (x.new_empty(x.shape), x.new_empty((n, k), dtype=f32),
            x.new_empty((k,), dtype=f32), x.new_empty((k,), dtype=f32))


def fused_bwd(x, dy, scale, shift, w, relu):
    """dx (M, K) in x's dtype, dW (N, K) f32, dscale and dshift (K,) f32
    for y = [relu](x*scale + shift) @ W^T; dy (M, N) in x's dtype, w
    (N, K).  The call is the operator ``mxnet_tpu_torch::fused_bwd``:
    CPU tensors take :func:`fused_bwd_plain`, CUDA tensors launch
    kernel F, and any other device raises."""
    return fused_bwd_op(x, dy, scale, shift, w, bool(relu))


def _bwd_launch(x, dy, scale, shift, w, relu, params):
    """Launch kernel F on checked CUDA tensors under the space's
    ``params`` (None: the rule's plans)."""
    code = _DTYPE_CODE[x.dtype]
    m, k = x.shape
    n = w.shape[0]
    dev = x.device
    x, dy, w = x.contiguous(), dy.contiguous(), w.contiguous()
    scale, shift = scale.contiguous(), shift.contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty((n, k), dtype=torch.float32, device=dev)
    dscale = torch.zeros((k,), dtype=torch.float32, device=dev)
    dshift = torch.zeros((k,), dtype=torch.float32, device=dev)
    aligned = _aligned(x, dy, w, scale, shift, dx, dw)
    sms = cuda_build.sm_count(dev)
    pdx = _plan(m, k, n, x.dtype, "dx", aligned, params, sms)
    pdw = _plan(m, k, n, x.dtype, "dw", aligned, params, sms)
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


def _fold_backward(saved, args, needs, grads, bwd):
    """The gradients of ``(x, scale, shift, w, bias, residual)`` from the
    cotangents ``(dy, dysum, dysumsq)`` of ``(y, ysum, ysumsq)``: the
    statistics' cotangents folded into an effective dy, ``dy + dysum +
    2 y dysumsq`` in f32 cast to x's dtype (``pallas_fused.py`` custom
    VJP; a cotangent that is None is skipped, not added as zeros), then
    ``bwd`` (kernel F's operator or its plain version).  dbias is that
    dy's column sum in f32, dresidual the cast dy itself, and dW is cast
    to w's dtype."""
    x, scale, shift, w, y = saved
    relu, has_bias, has_res = args
    dy, dysum, dysumsq = grads
    dy32 = (dy.float() if dy is not None
            else torch.zeros(y.shape, dtype=torch.float32, device=y.device))
    if dysum is not None:
        dy32 = dy32 + dysum[None, :]
    if dysumsq is not None:
        dy32 = dy32 + 2.0 * y.float() * dysumsq[None, :]
    dy_eff = dy32.to(x.dtype)
    dx, dw, dscale, dshift = bwd(x, dy_eff, scale, shift, w, relu)
    return (dx, dscale if needs[1] else None, dshift if needs[2] else None,
            dw.to(w.dtype), dy32.sum(0) if has_bias else None,
            dy_eff if has_res else None)


def _fused_fwd_setup(ctx, inputs, output):
    x, scale, shift, w, bias, residual, relu = inputs
    ctx.save_for_backward(x, scale, shift, w, output[0])
    ctx.args = (relu, bias is not None, residual is not None)
    # cotangents of unused statistics arrive as None (not zeros)
    ctx.set_materialize_grads(False)


def _fused_fwd_backward(ctx, dy, dysum, dysumsq):
    return _fold_backward(ctx.saved_tensors, ctx.args, ctx.needs_input_grad,
                          (dy, dysum, dysumsq), fused_bwd) + (None,)


# kernel A's gradient is kernel F (through its operator)
fused_fwd_op.register_autograd(_fused_fwd_backward,
                               setup_context=_fused_fwd_setup)


class _FusedPlainFn(torch.autograd.Function):
    """The plain versions of kernels A and F as one autograd Function,
    with the same statistics fold as the operators' gradient."""

    @staticmethod
    def forward(ctx, x, scale, shift, w, bias, residual, relu):
        y, s1, s2 = fused_plain(x, scale, shift, w, residual=residual,
                                relu=relu, bias=bias, wt=True)
        ctx.save_for_backward(x, scale, shift, w, y)
        ctx.args = (relu, bias is not None, residual is not None)
        ctx.set_materialize_grads(False)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, dysum, dysumsq):
        return _fold_backward(ctx.saved_tensors, ctx.args,
                              ctx.needs_input_grad, (dy, dysum, dysumsq),
                              fused_bwd_plain) + (None,)


class FusedLNLinearFn:
    """Differentiable kernel A: ``(y, ysum, ysumsq)`` from (x, scale,
    shift, w, bias, residual).  ``apply`` calls the operator
    ``mxnet_tpu_torch::fused_fwd``, whose registered gradient is the
    operator ``mxnet_tpu_torch::fused_bwd`` (kernel F on the card, its
    plain version on the CPU); under ``plain`` it runs the two plain
    versions.  Either way the backward folds the statistics' cotangents
    into an effective dy (:func:`_fold_backward`).  bias and residual
    may be None."""

    @staticmethod
    def apply(x, scale, shift, w, bias, residual, relu, plain):
        if plain:
            return _FusedPlainFn.apply(x, scale, shift, w, bias, residual,
                                       relu)
        return fused_fwd_op(x, scale, shift, w, bias, residual, bool(relu))


# ---------------------------------------------------------------------------
# tunable space (ops/tuning.py): A's side, F's dx / dW sides and split cap
# per (m, k, n) class
# ---------------------------------------------------------------------------

# a candidate's outputs against the plain versions', as chip_smoke.py's
# kernel A and F phases hold them: A's y within tol x max(1, max|y|), its
# column statistics within tol x max(1, the column sum of |y| or y^2);
# F's dx within tol x max(1, max|dx|), its M-long sums (dW, dscale,
# dshift) within 1e-4 of their largest magnitude
SWEEP_TOL = {"a": {"float32": 1e-5, "bfloat16": 2 ** -7},
             "a_stats": {"float32": 1e-4, "bfloat16": 2 ** -7},
             "dx": {"float32": 1e-5, "bfloat16": 2 ** -7},
             "long": 1e-4}
_SPLIT_CAPS = (1, 2, MAX_SPLITS)


def _tuning_candidates(shape_class, interpret):
    """The defaults (the rule), then every combination of the sides the
    C entries take for the class's dtype-independent widths (f32 ``simt``
    128 / 64 / 32; bf16 ``mma`` 128 / 64, A's 128 being ``wgmma128``)
    and the split caps; the runner refuses sides its dtype does not
    take."""
    out = [dict(TUNE_DEFAULTS)]
    for fs in (128, 64, 32):
        for dxs in (128, 64, 32):
            for dws in (128, 64, 32):
                for cap in _SPLIT_CAPS:
                    out.append({"fwd_side": fs, "dx_side": dxs,
                                "dw_side": dws, "dw_splits": cap})
    return out


def _tuning_runner(params, shape_class, dtype, interpret):
    """Kernel A (bias, ReLU) then kernel F (ReLU) at the class's bucket
    shape under ``params``, launched directly (the sweep must not
    re-enter ``resolve``), with a check of both against their plain
    versions on the same inputs."""
    from . import tuning

    dims = tuning.parse_shape_class(shape_class)
    m, k, n = dims["m"], dims["k"], dims["n"]
    dt = getattr(torch, dtype, None)
    if dt not in _DTYPE_CODE:
        raise tuning.SpaceError("no kernel for dtype %r" % dtype)
    if m <= DECODE_ROWS:
        raise tuning.SpaceError("m=%d takes A's decode variant" % m)
    mma = dt == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
    sides = (128, 64) if mma else (128, 64, 32)
    for key in _SIDE_PARAM.values():
        if params[key] and params[key] not in sides:
            raise tuning.SpaceError("%s %d: the %s kernels take sides %s"
                                    % (key, params[key], dtype, sides))
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x = r(m, k).to(dt)
    w = (r(n, k) / k ** 0.5).to(dt)
    scale, shift, bias = 1 + 0.1 * r(k), 0.1 * r(k), 0.1 * r(n)
    dy = r(m, n).to(dt)
    out = {}

    def run():
        out["a"] = _fwd_launch(x, scale, shift, w, bias, None, True, params)
        out["f"] = _bwd_launch(x, dy, scale, shift, w, True, params)

    def check():
        ya, fa = out["a"], out["f"]
        wa = fused_plain(x, scale, shift, w, relu=True, bias=bias)
        wf = fused_bwd_plain(x, dy, scale, shift, w, True)
        errs = [tuning.error_share(ya[0], wa[0], SWEEP_TOL["a"][dtype])]
        yabs = wa[0].float().abs()
        for i, lim in ((1, yabs.sum(0)), (2, (yabs * yabs).sum(0))):
            serr = (ya[i] - wa[i]).abs()
            errs.append((float(serr.max()), float(
                (serr / (SWEEP_TOL["a_stats"][dtype]
                         * torch.clamp_min(lim, 1.0))).max())))
        errs.append(tuning.error_share(fa[0], wf[0], SWEEP_TOL["dx"][dtype]))
        errs += [tuning.error_share(gv, wv, SWEEP_TOL["long"])
                 for gv, wv in zip(fa[1:], wf[1:])]
        return max(e for e, _ in errs), max(sh for _, sh in errs)

    return tuning.Probe(run, check)


def _register_space():
    from . import tuning

    tuning.register_space(
        "fused_kernel", version=1, defaults=TUNE_DEFAULTS,
        constants=("MAX_SPLITS", "DW_SPLIT_MIN_M", "DW_SPLIT_ROWS"),
        candidates=_tuning_candidates, runner=_tuning_runner,
        sources=("fused_fwd", "fused_bwd"))


_register_space()
