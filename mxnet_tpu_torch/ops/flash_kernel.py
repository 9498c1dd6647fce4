"""Kernels C, D and E: causal flash attention for training — the
counterpart of ``mxnet_tpu/ops/pallas_attention.py``'s forward (with
its lse residual) and its dQ and dK/dV backward kernels.

Tensors are head-folded: q (B*H, T, hd), k and v (B*H_kv, T, hd), q-row
``b`` attending kv-row ``b // G`` with G = H / H_kv.

* :func:`flash_fwd` — the torch operator ``mxnet_tpu_torch::flash_fwd``
  (:func:`flash_fwd_op`): kernel C on a CUDA tensor,
  :func:`flash_plain_fwd` on a CPU tensor, ``(o, lse)`` with lse (B*H,
  T) f32; a traced graph (``torch.export``) holds it as one node.
* :func:`flash_bwd` — the operators ``mxnet_tpu_torch::flash_bwd_dq``
  (kernel D, :func:`flash_bwd_dq_op`) and ``::flash_bwd_dkv`` (kernel E,
  :func:`flash_bwd_dkv_op`): the kernels on a CUDA tensor, the plain
  backward's dq and dk / dv on a CPU tensor: ``(dq, dk, dv)``.  delta =
  rowsum(dO * O) is computed in f32 before the kernels
  (:func:`flash_delta`), as the TPU path does.  D and E are C's
  operator's registered gradient, so a traced training graph holds all
  three nodes.
* :class:`FlashAttentionFn` — the path the ``dot_product_attention``
  op calls: C's operator (backward D and E), or under ``plain`` the
  plain versions.

A CUDA tensor the kernels do not take (dtype other than f32/bf16, head
dim other than 64 or 128, q and k/v of different dtypes or lengths)
raises; nothing falls back.  :func:`supported` is the gate the
``dot_product_attention`` op asks first (as the JAX package asks
``pallas_attention.supported``): shapes it refuses go to ``sdpa``.
``LAUNCHES`` counts kernel launches.

Kernels C, D and E each have two variants, picked by :func:`_variant`
from the dtype alone (the C entries dispatch on the same dtype code):

* ``simt`` (f32): register-blocked tiles on the CUDA cores;
* ``wgmma`` (bf16): ``wgmma.mma_async`` on the tensor cores.

All read 16-byte chunks: a tensor whose storage is not 16-byte aligned
is copied first (:func:`_aligned16`).  ``LAST_VARIANT`` records what the
last launch of C, of D and of E ran.

Their tiles are compiled in (:data:`TILES`).  They are registered as the
tunable space ``"flash_kernel"`` (``ops/tuning.py``) with the compiled
tiles as the defaults and the only candidate, keyed by the ``(t, d, g)``
class and the dtype: a sweep times C, D and E and records the times in
the tuning cache.  Until the tiles become launch arguments a launch
reads nothing from the cache.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from .. import cuda_build

__all__ = ["flash_fwd", "flash_fwd_op", "flash_bwd", "flash_bwd_dq",
           "flash_bwd_dq_op", "flash_bwd_dkv", "flash_bwd_dkv_op",
           "flash_delta", "flash_plain_fwd",
           "flash_plain_bwd",
           "FlashAttentionFn", "HEAD_DIMS", "LAUNCHES", "LAST_VARIANT",
           "supported"]

# kernel launches since the counts were last set to 0 (plain-version calls
# do not count)
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
# the variant the last launch of kernel C / D / E ran (see _variant)
LAST_VARIANT = {"flash_fwd": None, "flash_bwd_dq": None,
                "flash_bwd_dkv": None}

# head dims the kernels are built for
HEAD_DIMS = (64, 128)
# the (query rows, keys) tiles csrc/flash_attention.cu compiles in:
# FwdSimt, DqSimt and BwdSimt (f32), FwdWg, DqWg and BwdWg (bf16)
TILES = {"simt_fwd": (64, 64), "simt_dq": (64, 64), "simt_dkv": (32, 64),
         "wgmma_fwd": (64, 64), "wgmma_dq": (64, 64), "wgmma_dkv": (64, 64)}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supported(q_shape, k_shape, dtype, num_heads=1, num_kv_heads=0,
              v_shape=None):
    """Whether kernels C, D and E take this (B, T, E) self-attention:
    equal query and key lengths, heads dividing the embed dims with the
    K (and V) width exactly H_kv head slices of the query's head dim, a
    head dim in :data:`HEAD_DIMS` and a float32 or bfloat16 dtype.  Any
    T is taken (the kernels mask ragged tiles).  The counterpart of
    ``pallas_attention.supported``, with the port's head dims and dtypes
    in place of the TPU tile rules."""
    b, tq, e = q_shape
    if tq != k_shape[1] or tq <= 0:
        return False
    heads = int(num_heads)
    kvh = int(num_kv_heads) or heads
    if heads <= 0 or kvh <= 0 or heads % kvh or e % heads:
        return False
    hd = e // heads
    if k_shape[2] != kvh * hd:
        return False
    if v_shape is not None and (tuple(v_shape[:2]) != tuple(k_shape[:2])
                                or v_shape[2] != kvh * hd):
        return False
    return hd in HEAD_DIMS and dtype in _DTYPE_CODE


def _variant(dtype, hd):
    """The variant of kernels C, D and E for ``dtype`` and head dim
    ``hd``: ``"simt"`` for float32, ``"wgmma"`` for bfloat16 (every head
    dim the kernels take)."""
    if dtype not in _DTYPE_CODE or hd not in HEAD_DIMS:
        raise ValueError("no flash kernel for %s, head dim %d" % (dtype, hd))
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def _aligned16(x):
    """``x``, or a copy of it where its data is not 16-byte aligned (the
    kernels read 16-byte chunks; a fresh allocation is aligned)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _expand_kv(x, groups):
    """(B*H_kv, T, hd) -> (B*H, T, hd): q-row b reads kv-row b // G."""
    return x.repeat_interleave(groups, dim=0) if groups > 1 else x


def _logits(q, k, scale, causal, groups):
    s = torch.matmul(q.float(), _expand_kv(k, groups).float()
                     .transpose(1, 2)) * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, float("-inf"))
    return s


def flash_plain_fwd(q, k, v, scale, causal, groups=1):
    """Plain PyTorch version of kernel C: ``(o, lse)`` with the TPU
    kernel's numerics (f32 logits and P.V, m_safe for all-masked rows, a
    zero denominator read as 1, lse = m + log(l))."""
    s = _logits(q, k, scale, causal, groups)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.matmul(p, _expand_kv(v, groups).float()) / denom
    lse = (m_safe + torch.log(denom)).squeeze(-1)
    return o.to(q.dtype), lse


def flash_plain_bwd(q, k, v, o, lse, do, scale, causal, groups=1):
    """Plain PyTorch version of kernels D and E: ``(dq, dk, dv)``,
    recomputing p = exp(s - lse) with the TPU kernels' casts (ds to k's
    dtype before ds.K, p to do's dtype and ds to q's dtype before the
    dK/dV products; dK/dV summed over a kv group in f32)."""
    return _plain_grads(q, k, v, do, lse, flash_delta(o, do), scale, causal,
                        groups)


def _plain_grads(q, k, v, do, lse, delta, scale, causal, groups):
    """:func:`flash_plain_bwd` from delta = rowsum(do * o) (B*H, T) f32:
    the CPU implementations of the D and E operators."""
    s = _logits(q, k, scale, causal, groups)
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.matmul(do.float(), _expand_kv(v, groups).float()
                      .transpose(1, 2))
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), _expand_kv(k, groups).float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(1, 2), q.float())
    if groups > 1:
        bh, t, d = dk.shape
        dk = dk.reshape(bh // groups, groups, t, d).sum(dim=1)
        dv = dv.reshape(bh // groups, groups, t, d).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, groups, where, fake=False):
    """The kernels' contract for CUDA tensors; returns (dtype code,
    contiguous q, k, v).  ``fake``: only check (the operator's fake
    implementation, which a ``meta`` tensor given directly reaches)."""
    code = _DTYPE_CODE.get(q.dtype)
    if code is None:
        raise ValueError("%s: the kernel takes float32 or bfloat16, not %s"
                         % (where, q.dtype))
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("%s: q, k and v must be (rows, T, hd)" % where)
    bh, t, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError("%s: head dim %d has no kernel (built for %s)"
                         % (where, hd, HEAD_DIMS))
    want = (bh // groups, t, hd)
    if groups < 1 or bh % groups or tuple(k.shape) != want \
            or tuple(v.shape) != want:
        raise ValueError("%s: k %s / v %s do not match q %s with groups=%d"
                         % (where, tuple(k.shape), tuple(v.shape),
                            tuple(q.shape), groups))
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError("%s: %s is %s on %s, q is %s on %s"
                             % (where, name, x.dtype, x.device, q.dtype,
                                q.device))
    if q.device.type != "cuda" and not (fake and is_fake(q)):
        raise ValueError("%s: unsupported device %s" % (where, q.device))
    if fake:
        return None
    return code, _aligned16(q.contiguous()), _aligned16(k.contiguous()), \
        _aligned16(v.contiguous())


@torch.library.custom_op("mxnet_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, causal: bool, groups: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C as a torch operator: its CUDA implementation launches
    ``csrc/flash_attention.cu``'s forward; its CPU implementation is
    :func:`flash_plain_fwd`; its fake implementation gives ``(o, lse)``'s
    shapes and dtypes, so a traced (exported) graph holds this one
    node."""
    code, q, k, v = _check(q, k, v, groups, "flash_fwd")
    bh, t, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    lib = cuda_build.lib("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd(code, hd, q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, t,
                           groups, float(scale), int(bool(causal)), stream)
    cuda_build.check(lib, rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    LAST_VARIANT["flash_fwd"] = _variant(q.dtype, hd)
    return o, lse


@flash_fwd_op.register_kernel("cpu")
def _flash_fwd_cpu(q, k, v, scale, causal, groups):
    return flash_plain_fwd(q, k, v, scale, causal, groups)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, scale, causal, groups):
    if q.device.type != "cpu":
        _check(q, k, v, groups, "flash_fwd", fake=True)
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def flash_fwd(q, k, v, scale, causal, groups=1):
    """``(o, lse)`` through the operator ``mxnet_tpu_torch::flash_fwd``:
    kernel C on a CUDA tensor (or an error where it does not take the
    shapes), :func:`flash_plain_fwd` on a CPU tensor."""
    return flash_fwd_op(q, k, v, float(scale), bool(causal), int(groups))


def _check_bwd(q, do, lse, delta, where, fake=False):
    bh, t, _ = q.shape
    if tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype:
        raise ValueError("%s: do %s %s does not match q %s %s"
                         % (where, tuple(do.shape), do.dtype,
                            tuple(q.shape), q.dtype))
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (bh, t) or x.dtype != torch.float32 \
                or x.device != q.device:
            raise ValueError("%s: %s must be (%d, %d) float32 on %s"
                             % (where, name, bh, t, q.device))
    if fake:
        return None
    return _aligned16(do.contiguous()), lse.contiguous(), delta.contiguous()


@torch.library.custom_op("mxnet_tpu_torch::flash_bwd_dq", mutates_args=(),
                         device_types="cuda")
def flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    scale: float, causal: bool, groups: int) -> torch.Tensor:
    """Kernel D as a torch operator: dq from ``csrc/flash_attention.cu``
    on CUDA tensors, the plain backward's dq on CPU tensors, dq's shape
    and dtype when a graph is traced.  delta = rowsum(do * o) in f32,
    (B*H, T)."""
    code, q, k, v = _check(q, k, v, groups, "flash_bwd_dq")
    do, lse, delta = _check_bwd(q, do, lse, delta, "flash_bwd_dq")
    bh, t, hd = q.shape
    dq = torch.empty_like(q)
    lib = cuda_build.lib("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd_dq(code, hd, q.data_ptr(), k.data_ptr(),
                              v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(), bh, t, groups,
                              float(scale), int(bool(causal)), stream)
    cuda_build.check(lib, rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    LAST_VARIANT["flash_bwd_dq"] = _variant(q.dtype, hd)
    return dq


@flash_bwd_dq_op.register_kernel("cpu")
def _flash_bwd_dq_cpu(q, k, v, do, lse, delta, scale, causal, groups):
    return _plain_grads(q, k, v, do, lse, delta, scale, causal, groups)[0]


@flash_bwd_dq_op.register_fake
def _flash_bwd_dq_fake(q, k, v, do, lse, delta, scale, causal, groups):
    if q.device.type != "cpu":
        _check(q, k, v, groups, "flash_bwd_dq", fake=True)
        _check_bwd(q, do, lse, delta, "flash_bwd_dq", fake=True)
    return q.new_empty(q.shape)


@torch.library.custom_op("mxnet_tpu_torch::flash_bwd_dkv", mutates_args=(),
                         device_types="cuda")
def flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                     scale: float, causal: bool, groups: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel E as a torch operator: (dk, dv), summed over the G q-heads
    of each kv group, from ``csrc/flash_attention.cu`` on CUDA tensors,
    the plain backward's dk and dv on CPU tensors, their shapes and
    dtypes when a graph is traced."""
    code, q, k, v = _check(q, k, v, groups, "flash_bwd_dkv")
    do, lse, delta = _check_bwd(q, do, lse, delta, "flash_bwd_dkv")
    bh, t, hd = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = cuda_build.lib("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_bwd_dkv(code, hd, q.data_ptr(), k.data_ptr(),
                               v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), bh // groups, t, groups,
                               float(scale), int(bool(causal)), stream)
    cuda_build.check(lib, rc, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    LAST_VARIANT["flash_bwd_dkv"] = _variant(q.dtype, hd)
    return dk, dv


@flash_bwd_dkv_op.register_kernel("cpu")
def _flash_bwd_dkv_cpu(q, k, v, do, lse, delta, scale, causal, groups):
    return _plain_grads(q, k, v, do, lse, delta, scale, causal, groups)[1:]


@flash_bwd_dkv_op.register_fake
def _flash_bwd_dkv_fake(q, k, v, do, lse, delta, scale, causal, groups):
    if q.device.type != "cpu":
        _check(q, k, v, groups, "flash_bwd_dkv", fake=True)
        _check_bwd(q, do, lse, delta, "flash_bwd_dkv", fake=True)
    return k.new_empty(k.shape), v.new_empty(v.shape)


def flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, groups=1):
    """dq through the operator ``mxnet_tpu_torch::flash_bwd_dq`` (kernel
    D on CUDA tensors); delta = rowsum(do * o) in f32, (B*H, T)."""
    return flash_bwd_dq_op(q, k, v, do, lse, delta, float(scale),
                           bool(causal), int(groups))


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, groups=1):
    """(dk, dv) through the operator ``mxnet_tpu_torch::flash_bwd_dkv``
    (kernel E on CUDA tensors), summed over the G q-heads of each kv
    group."""
    return flash_bwd_dkv_op(q, k, v, do, lse, delta, float(scale),
                            bool(causal), int(groups))


def flash_delta(o, do):
    """delta = rowsum(do * o) in f32 — computed before the backward
    kernels, as ``pallas_attention._bwd_call`` computes it."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_bwd(q, k, v, o, lse, do, scale, causal, groups=1):
    """``(dq, dk, dv)`` through the operators of kernels D and E: on
    CUDA tensors the kernels, on CPU tensors the plain backward."""
    if tuple(o.shape) != tuple(q.shape):
        raise ValueError("flash_bwd: o %s does not match q %s"
                         % (tuple(o.shape), tuple(q.shape)))
    do = do.to(q.dtype)
    delta = flash_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, groups)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, groups)
    return dq, dk, dv


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, scale, causal, groups = inputs
    ctx.save_for_backward(q, k, v, output[0], output[1])
    ctx.args = (scale, causal, groups)
    # lse is a residual: its cotangent arrives as None, not zeros
    ctx.set_materialize_grads(False)


def _flash_fwd_backward(ctx, do, dlse):
    if do is None:
        return None, None, None, None, None, None
    q, k, v, o, lse = ctx.saved_tensors
    scale, causal, groups = ctx.args
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do, scale, causal, groups)
    return dq, dk, dv, None, None, None


# kernel C's gradient is kernels D and E (through their operators)
flash_fwd_op.register_autograd(_flash_fwd_backward,
                               setup_context=_flash_fwd_setup)


class _FlashPlainFn(torch.autograd.Function):
    """The plain forward and backward as one autograd Function."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, groups):
        o, lse = flash_plain_fwd(q, k, v, scale, causal, groups)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, groups)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, causal, groups = ctx.args
        dq, dk, dv = flash_plain_bwd(q, k, v, o, lse, do, scale, causal,
                                     groups)
        return dq, dk, dv, None, None, None


class FlashAttentionFn:
    """Differentiable flash attention over head-folded tensors: ``apply``
    calls the operator ``mxnet_tpu_torch::flash_fwd`` (kernel C), whose
    registered gradient is the D and E operators; under ``plain``, the
    plain forward and backward.  Returns o."""

    @staticmethod
    def apply(q, k, v, scale, causal, groups, plain):
        if plain:
            return _FlashPlainFn.apply(q, k, v, scale, causal, groups)
        return flash_fwd_op(q, k, v, float(scale), bool(causal),
                            int(groups))[0]


# ---------------------------------------------------------------------------
# tunable space (ops/tuning.py): the compiled tiles per (t, d, g) class
# ---------------------------------------------------------------------------

TUNE_DEFAULTS = {"%s_%s" % (name, side): tile[i]
                 for name, tile in TILES.items()
                 for i, side in enumerate(("bq", "bk"))}
# the probe's rows: chip_smoke.py's training attention, batch 8 x 8 heads
PROBE_ROWS = 64
# a candidate's outputs against the plain versions', relative to each
# output's largest magnitude (chip_smoke.py's kernels C-E tolerances);
# lse in f32 always
SWEEP_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7, "lse": 1e-5}


def _tuning_candidates(shape_class, interpret):
    """The compiled tiles, the only plan the kernels have."""
    return [dict(TUNE_DEFAULTS)]


def _tuning_runner(params, shape_class, dtype, interpret):
    """Kernels C, then D and E on C's o / lse, causal, at the class's
    bucket (``PROBE_ROWS`` q rows of t x d, G q-rows a kv-row), checked
    against their plain versions."""
    from . import tuning

    dims = tuning.parse_shape_class(shape_class)
    t, d, groups = dims["t"], dims["d"], dims.get("g", 1)
    if params != TUNE_DEFAULTS:
        raise tuning.SpaceError("the flash tiles are compiled in: %s"
                                % TUNE_DEFAULTS)
    dt = getattr(torch, dtype, None)
    if dt not in _DTYPE_CODE or d not in HEAD_DIMS \
            or PROBE_ROWS % groups:
        raise tuning.SpaceError("no flash kernel for %s at %s"
                                % (dtype, shape_class))
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev)
    g.manual_seed(2)

    def r(rows):
        return torch.randn(rows, t, d, generator=g, device=dev).to(dt)

    q, do = r(PROBE_ROWS), r(PROBE_ROWS)
    k, v = r(PROBE_ROWS // groups), r(PROBE_ROWS // groups)
    scale = d ** -0.5
    out = {}

    def run():
        o, lse = flash_fwd(q, k, v, scale, True, groups)
        delta = flash_delta(o, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, True, groups)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, True, groups)
        out["got"] = (o, lse, dq, dk, dv)

    def check():
        o, lse, dq, dk, dv = out["got"]
        wo, wlse = flash_plain_fwd(q, k, v, scale, True, groups)
        wdq, wdk, wdv = flash_plain_bwd(q, k, v, o, lse, do, scale, True,
                                        groups)
        errs = [tuning.error_share(got, want, tol)
                for got, want, tol in ((o, wo, SWEEP_TOL[dtype]),
                                       (lse, wlse, SWEEP_TOL["lse"]),
                                       (dq, wdq, SWEEP_TOL[dtype]),
                                       (dk, wdk, SWEEP_TOL[dtype]),
                                       (dv, wdv, SWEEP_TOL[dtype]))]
        return max(e for e, _ in errs), max(sh for _, sh in errs)

    return tuning.Probe(run, check)


def _register_space():
    from . import tuning

    tuning.register_space(
        "flash_kernel", version=1, defaults=TUNE_DEFAULTS,
        constants=("TILES",), candidates=_tuning_candidates,
        runner=_tuning_runner, sources=("flash_attention",))


_register_space()
