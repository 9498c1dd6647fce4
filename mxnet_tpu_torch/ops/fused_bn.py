"""Kernel B4: fused BatchNorm-apply -> [ReLU] -> 1x1 convolution (a
matmul) (+ residual) with the per-column statistics of the f32
accumulator — the counterpart of the reference's two prototypes of that
ResNet bottleneck link, ``benchmarks/proto_fused.py:49``
(``fused_bn_matmul``, kernel ``_fused_kernel``) and
``benchmarks/proto_sweep.py:28`` (``fused``, kernel ``kern``).

    a      = [relu](x * scale + shift), rounded to bf16
    acc    = a @ W in f32 (+ residual)
    y      = acc in x's dtype (bf16)
    ysum   = acc.sum(0),  ysumsq = (acc * acc).sum(0)

The statistics are those of the accumulator after the residual add (the
prototypes' epilogue), not of the stored y as kernel A's
(``ops/fused_kernel.py``) are; W is (K, N), the prototypes' layout.

* :func:`fused_bn_matmul` returns ``(y, ysum, ysumsq)`` as
  ``proto_fused.fused_bn_matmul`` does; :func:`fused` returns y alone as
  ``proto_sweep.fused`` does (ReLU on, no residual), with the statistics
  written or not (``stats``: what the kernel writes, not what it
  returns).  Both call the torch operator
  ``mxnet_tpu_torch::fused_bn_matmul`` (:func:`fused_bn_matmul_op`),
  whose CUDA implementation launches ``csrc/fused_bn_matmul.cu`` (built
  at first use, see :mod:`~mxnet_tpu_torch.cuda_build`) or raises, and
  whose CPU implementation is :func:`fused_bn_matmul_plain`.  It has no
  gradient: the prototypes are forward only.
* :func:`library_chain`: the counterpart of ``proto_fused.xla_chain``
  (``:103``): the elementwise prologue, one cuBLAS bf16 product and the
  two sums of the stored y.  The yardstick of the timings, and the
  prototype's own ``maxerr`` / ``srel`` reference; not a plain version.
* :func:`bench_cases` and :func:`sweep`: the counterparts of the two
  prototypes' ``main()`` at ``CASES`` (``proto_fused.py:140-146``) and
  ``SWEEP_CASES`` (``proto_sweep.py:71-72``), ResNet-50's batch-256
  NHWC stage shapes.  They run on the card only
  (``python -m mxnet_tpu_torch.ops.fused_bn``).

A CUDA tensor takes the kernel or raises :class:`MXNetError`: x and W
bf16, scale and shift f32, a residual bf16 (``proto_fused.py:52``), K
and N multiples of 8, x / W / residual 16-byte aligned.  ``LAUNCHES``
counts launches; ``LAST_VARIANT`` names the tile the last one ran.

The tile variants (``VARIANTS``, BM x BN) take the place of the
prototype's (bm, bn) sweep grid; the rule (:func:`_rule`) takes the
narrowest that covers N, so x is read once for N <= 256, and walks the
row tiles in as many row groups as fill the card.
"""
from __future__ import annotations

import math
from collections import namedtuple
from typing import Optional, Tuple

import torch

from .. import cuda_build
from ..base import MXNetError
from .fused_kernel import _refuse_meta

__all__ = ["fused_bn_matmul", "fused", "fused_bn_matmul_op",
           "fused_bn_matmul_plain", "library_chain", "case_inputs",
           "bench_cases", "sweep", "LAUNCHES", "LAST_VARIANT", "VARIANTS",
           "CASES", "SWEEP_CASES"]

# kernel launches since the count was last set to 0 (plain-version calls
# do not count); the tile the last launch ran
LAUNCHES = {"fused_bn_matmul": 0}
LAST_VARIANT = {"fused_bn_matmul": None}

# the C entry's variant codes (csrc/fused_bn_matmul.cu), BM x BN
VARIANTS = ("128x64", "128x128", "128x256", "256x128")
_TILES = {v: tuple(int(d) for d in v.split("x")) for v in VARIANTS}
SMS = 132  # the SM count _plan assumes when it is given none (an H100's)

# (name, M, K, N, residual): ResNet-50 batch-256 NHWC stage shapes,
# benchmarks/proto_fused.py:140-146
CASES = [
    ("s1 c1 56x56 256->64", 256 * 56 * 56, 256, 64, False),
    ("s1 c3 56x56 64->256 +r", 256 * 56 * 56, 64, 256, True),
    ("s2 c3 28x28 128->512 +r", 256 * 28 * 28, 128, 512, True),
    ("s3 c1 14x14 1024->256", 256 * 14 * 14, 1024, 256, False),
    ("s4 c3 7x7 512->2048 +r", 256 * 7 * 7, 512, 2048, True),
]
# (name, M, K, N): benchmarks/proto_sweep.py:71-72
SWEEP_CASES = [("s1c1", 802816, 256, 64), ("s1c3", 802816, 64, 256),
               ("s4c1", 12544, 2048, 512)]
ITERS = 20  # timed calls a reading, best of 3 (the prototypes' bench)

Plan = namedtuple("Plan", "variant code rows")

_CONTRACT = ("kernel B4 (benchmarks/proto_fused.py:52) takes x (M, K) "
             "bf16, scale / shift (K,) f32, w (K, N) bf16 and a residual "
             "(M, N) bf16")
# (device index, variant) -> blocks an SM
_OCCUPANCY = {}


def _cdiv(a, b):
    return -(-a // b)


def _variant(variant):
    if variant is not None and variant not in VARIANTS:
        raise MXNetError("kernel B4: unknown variant %r (one of %s)"
                         % (variant, ", ".join(VARIANTS)))
    return variant


def _rule(n):
    """The narrowest of the 128 x 64 / 128 / 256 tiles that covers N (x
    is then read once), 128 x 256 past it."""
    return next((v for v in VARIANTS[:3] if n <= _TILES[v][1]), "128x256")


def _plan(m, n, variant=None, occupancy=1, sms=SMS):
    """The tile (``variant``, or :func:`_rule`'s) and the row groups the
    grid walks the row tiles in: about ``occupancy`` blocks an SM over
    ``sms`` SMs, each group taking an equal count of tiles.  The groups
    fix the order of the statistics' sums, so a shape on one card always
    sums alike."""
    name = _variant(variant) or _rule(n)
    bm, bn = _TILES[name]
    tiles = _cdiv(m, bm)
    cap = min(tiles, 65535, max(1, occupancy * sms // _cdiv(n, bn)))
    return Plan(name, VARIANTS.index(name), _cdiv(tiles, _cdiv(tiles, cap)))


def fused_bn_matmul_plain(x, scale, shift, w, residual=None, relu_in=True,
                          stats=True):
    """Plain PyTorch version of kernel B4: ``(y, ysum, ysumsq)``.  The
    activation is rounded to bf16 before an f32 product of the rounded
    operands, the residual is added in f32, y is cast to x's dtype, and
    the statistics are sums of the f32 accumulator (empty without
    ``stats``)."""
    a = x.float() * scale + shift
    if relu_in:
        a = torch.clamp_min(a, 0.0)
    acc = torch.matmul(a.to(torch.bfloat16).float(), w.float())
    if residual is not None:
        acc = acc + residual.float()
    if not stats:
        empty = acc.new_empty((0,))
        return acc.to(x.dtype), empty, empty.clone()
    return acc.to(x.dtype), acc.sum(0), (acc * acc).sum(0)


def _chain_y(x, scale, shift, w, residual=None, relu_in=True):
    a = x.float() * scale + shift
    if relu_in:
        a = torch.clamp_min(a, 0.0)
    a = a.to(torch.bfloat16)
    if residual is None:
        return torch.mm(a, w.to(torch.bfloat16)).to(x.dtype)
    return torch.addmm(residual.to(torch.bfloat16), a,
                       w.to(torch.bfloat16)).to(x.dtype)


def library_chain(x, scale, shift, w, residual=None, relu_in=True):
    """The library chain the kernel replaces, ``proto_fused.xla_chain``'s
    counterpart: the prologue as elementwise ops, one bf16 product
    (``mm``, or ``addmm`` with the residual: one rounding), then the
    column sums of the stored y in f32.  ``(y, ysum, ysumsq)``."""
    y = _chain_y(x, scale, shift, w, residual, relu_in)
    y32 = y.float()
    return y, y32.sum(0), (y32 * y32).sum(0)


def _check(x, scale, shift, w, residual):
    """B4's contract for a tensor off the host (a CUDA tensor, or a fake
    one while a graph is traced): ``(m, k, n)``, or an MXNetError naming
    what the kernel does not take."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise MXNetError("%s; got x %s, w %s" % (
            _CONTRACT, tuple(x.shape), tuple(w.shape)))
    m, k = x.shape
    n = w.shape[1]
    want = [("x", x, (m, k), torch.bfloat16),
            ("scale", scale, (k,), torch.float32),
            ("shift", shift, (k,), torch.float32),
            ("w", w, (k, n), torch.bfloat16)]
    if residual is not None:
        want.append(("residual", residual, (m, n), torch.bfloat16))
    for name, t, shape, dtype in want:
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != x.device:
            raise MXNetError("%s; got %s %s %s on %s" % (
                _CONTRACT, name, t.dtype, tuple(t.shape), t.device))
    if k % 8 or n % 8:
        raise MXNetError("kernel B4 loads 16-byte chunks: K and N must be "
                         "multiples of 8 (got K %d, N %d)" % (k, n))
    return m, k, n


def _occupancy(lib, variant, dev):
    key = (dev.index, variant)
    got = _OCCUPANCY.get(key)
    if got is None:
        import ctypes

        blocks = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = lib.fused_bn_occupancy(VARIANTS.index(variant),
                                        ctypes.byref(blocks))
        cuda_build.check(lib, rc, "fused_bn_occupancy")
        got = _OCCUPANCY[key] = max(1, blocks.value)
    return got


def _launch(x, scale, shift, w, residual, relu_in, stats, variant):
    """Launch kernel B4 (and, with ``stats``, its fixed-order combine)
    on checked CUDA tensors."""
    m, k = x.shape
    n = w.shape[1]
    dev = x.device
    x, w = x.contiguous(), w.contiguous()
    scale, shift = scale.contiguous(), shift.contiguous()
    if residual is not None:
        residual = residual.contiguous()
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    for name, t in (("x", x), ("w", w), ("residual", residual)):
        if t is not None and t.data_ptr() % 16:
            raise MXNetError("kernel B4 loads 16-byte chunks: %s must be "
                             "16-byte aligned (address %#x)"
                             % (name, t.data_ptr()))
    lib = cuda_build.lib("fused_bn_matmul")
    name = _variant(variant) or _rule(n)
    plan = _plan(m, n, name, _occupancy(lib, name, dev),
                 cuda_build.sm_count(dev))
    if stats:
        part = torch.empty((2, plan.rows, n), dtype=torch.float32,
                           device=dev)
        s1 = torch.empty((n,), dtype=torch.float32, device=dev)
        s2 = torch.empty((n,), dtype=torch.float32, device=dev)
    else:
        part = None
        s1 = torch.empty((0,), dtype=torch.float32, device=dev)
        s2 = torch.empty((0,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_bn_matmul(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            y.data_ptr(), part.data_ptr() if part is not None else None,
            s1.data_ptr() if stats else None,
            s2.data_ptr() if stats else None,
            m, k, n, int(bool(relu_in)), plan.code, plan.rows, stream)
    cuda_build.check(lib, rc, "fused_bn_matmul")
    LAUNCHES["fused_bn_matmul"] += 1
    LAST_VARIANT["fused_bn_matmul"] = plan.variant
    return y, s1, s2


@torch.library.custom_op("mxnet_tpu_torch::fused_bn_matmul", mutates_args=(),
                         device_types="cuda")
def fused_bn_matmul_op(x: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor, w: torch.Tensor,
                       residual: Optional[torch.Tensor], relu_in: bool,
                       stats: bool, variant: Optional[str]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B4 as a torch operator: its CUDA implementation launches
    ``csrc/fused_bn_matmul.cu``; its CPU implementation is
    :func:`fused_bn_matmul_plain`; its fake implementation gives the
    shapes and dtypes a launch gives.  Without ``stats`` the two
    statistics are empty."""
    _check(x, scale, shift, w, residual)
    return _launch(x, scale, shift, w, residual, relu_in, stats, variant)


@fused_bn_matmul_op.register_kernel("cpu")
def _fused_bn_cpu(x, scale, shift, w, residual, relu_in, stats, variant):
    _variant(variant)
    return fused_bn_matmul_plain(x, scale, shift, w, residual, relu_in,
                                 stats)


@fused_bn_matmul_op.register_fake
def _fused_bn_fake(x, scale, shift, w, residual, relu_in, stats, variant):
    _variant(variant)
    m, n = x.shape[0], w.shape[1]
    if x.device.type != "cpu":
        _check(x, scale, shift, w, residual)
        _refuse_meta(x, "fused_bn_matmul")
    width = n if stats else 0
    return (x.new_empty((m, n)),
            x.new_empty((width,), dtype=torch.float32),
            x.new_empty((width,), dtype=torch.float32))


def fused_bn_matmul(x, scale, shift, w, residual=None, relu_in=True,
                    variant=None):
    """y = [relu](x*scale + shift) @ W (+ residual) with the output's
    per-column ``(sum, sumsq)`` of the f32 accumulator; returns ``(y,
    ysum, ysumsq)`` (``proto_fused.fused_bn_matmul``).

    x: (M, K) bf16; scale, shift: (K,) f32; w: (K, N) bf16; residual:
    (M, N) bf16 or None.  ``variant``: a tile of ``VARIANTS`` (None: the
    rule's).  CPU tensors take :func:`fused_bn_matmul_plain`, CUDA
    tensors launch kernel B4."""
    return fused_bn_matmul_op(x, scale, shift, w, residual, bool(relu_in),
                              True, variant)


def fused(x, s, b, w, stats=True, variant=None):
    """relu(x*s + b) @ W in bf16 (``proto_sweep.fused``): kernel B4 with
    the ReLU on and no residual, writing the column statistics or not
    (``stats``); returns y alone, as the prototype drops them."""
    return fused_bn_matmul_op(x, s, b, w, None, True, bool(stats),
                              variant)[0].to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the prototypes' main()s on the card
# ---------------------------------------------------------------------------

def _card(device, what):
    if device is None:
        if not torch.cuda.is_available():
            raise MXNetError("%s times kernel B4 on the card: no CUDA "
                             "device is available" % what)
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type != "cuda":
        raise MXNetError("%s times kernel B4 on the card: it takes a CUDA "
                         "device, not %s" % (what, dev))
    return dev


def case_inputs(m, k, n, residual, generator, device):
    """``(x, scale, shift, w, residual or None)`` drawn as the prototypes
    draw them (x, residual ~ N(0, 1) and w ~ N(0, 0.05) in bf16; scale ~
    U(0.5, 1.5), shift ~ N(0, 0.1) in f32), from ``generator`` on
    ``device``."""
    def normal(std, *shape):
        return torch.randn(*shape, generator=generator, device=device) * std

    x = normal(1.0, m, k).to(torch.bfloat16)
    w = normal(0.05, k, n).to(torch.bfloat16)
    scale = torch.rand(k, generator=generator, device=device) + 0.5
    shift = normal(0.1, k)
    res = normal(1.0, m, n).to(torch.bfloat16) if residual else None
    return x, scale, shift, w, res


def _bench(fn):
    """``(ms, last output)``: the best of 3 means over ITERS calls, CUDA
    events, after one warm-up call (the prototypes' ``bench``)."""
    out = fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            out = fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / ITERS)
    return best, out


def bench_cases(device=None):
    """``proto_fused.main()`` on the card: each of ``CASES`` through the
    library chain and kernel B4, timed; a dict a case with the two ms,
    the speed-up, the prototype's minimum GB (x, y and W, the residual
    not counted) and effective GB/s, ``maxerr`` (max |y - y_chain|),
    ``srel`` (max |ysum - ysum_chain| / (|ysum_chain| + 1): the chain's
    statistics are of the rounded y) and the variant."""
    dev = _card(device, "bench_cases")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []
    for name, m, k, n, has_res in CASES:
        args = case_inputs(m, k, n, has_res, g, dev)
        t_lib, want = _bench(lambda: library_chain(*args))
        t_k, got = _bench(lambda: fused_bn_matmul(*args))
        gbytes = (m * k + m * n + k * n) * 2 / 1e9
        rows.append({
            "case": name, "m": m, "k": k, "n": n, "residual": has_res,
            "variant": LAST_VARIANT["fused_bn_matmul"],
            "library_ms": t_lib, "ms": t_k, "speedup": t_lib / t_k,
            "min_gb": gbytes, "gbps": gbytes / t_k * 1e3,
            "maxerr": float((got[0].float() - want[0].float()).abs().max()),
            "srel": float(((got[1] - want[1]).abs()
                           / (want[1].abs() + 1)).max())})
        del args, want, got
    return rows


def sweep(device=None):
    """``proto_sweep.main()`` on the card: at each of ``SWEEP_CASES`` the
    two floors (one bf16 ``mm`` alone; the library chain without
    statistics), then :func:`fused` under every variant with the
    statistics off and on; a dict a case."""
    dev = _card(device, "sweep")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []
    for name, m, k, n in SWEEP_CASES:
        x, s, b, w, _ = case_inputs(m, k, n, False, g, dev)
        row = {"case": name, "m": m, "k": k, "n": n,
               "matmul_ms": _bench(lambda: torch.mm(x, w))[0],
               "chain_ms": _bench(lambda: _chain_y(x, s, b, w))[0],
               "runs": []}
        for variant in VARIANTS:
            for stats in (False, True):
                ms = _bench(lambda: fused(x, s, b, w, stats, variant))[0]
                row["runs"].append({"variant": variant, "stats": stats,
                                    "ms": ms})
        rows.append(row)
        del x, s, b, w
    return rows


def main():
    print("kernel B4 on %s" % torch.cuda.get_device_name(_card(None,
                                                              "main")))
    for r in bench_cases():
        print("%(case)s: library %(library_ms)6.3f ms  kernel %(ms)6.3f ms "
              "(%(variant)s)  speedup %(speedup)4.2fx  minGB %(min_gb).2f "
              "(%(gbps).0f GB/s eff)  maxerr %(maxerr).3f  srel %(srel).1e"
              % r, flush=True)
    for r in sweep():
        print("%s: matmul-only %6.3f ms  chain(no stats) %6.3f ms"
              % (r["case"], r["matmul_ms"], r["chain_ms"]), flush=True)
        for run in r["runs"]:
            print("%s: %s stats=%d %6.3f ms" % (
                r["case"], run["variant"], run["stats"], run["ms"]),
                flush=True)


if __name__ == "__main__":
    main()
