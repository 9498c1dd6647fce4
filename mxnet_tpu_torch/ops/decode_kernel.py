"""Kernel B: paged split-K flash decoding with in-kernel dequantization —
the counterpart of ``mxnet_tpu/ops/pallas_decode.py`` — and the combine
of its split partials.

The wrappers :func:`flash_sdpa_decode` (tq = 1), :func:`flash_sdpa_verify`
(tq > 1: a verify window or a prefill chunk) and
:func:`dense_ring_attend` (dense (B, C, E) rings through an identity page
table) launch the hand-written kernels in ``csrc/paged_decode.cu`` on
CUDA tensors, or raise (also on shapes :func:`supported` refuses); on CPU
tensors they run the plain version, :func:`paged_plain`
(``paged_gather`` + ``dequantize_kv`` + the masked softmax of
``_sdpa_cache``).

Kernel B writes unnormalised per-split partials; the cross-split
logsumexp combine, jnp outside the ``pallas_call`` in the JAX package,
is a second kernel here (:func:`_launch_combine`), which writes (B, tq,
H*hd_v) in the output dtype; :func:`_combine` is its plain version.
:func:`_plan` makes the card's choices — the variant (``decode`` for
windows of at most :data:`DECODE_MAX_TQ` rows, ``chunk`` for prefill
chunks at head dims :data:`CHUNK_HEAD_DIMS`), the split count from the
card's SM count, the rows a block serves — and ``LAST_VARIANT`` records
what ran.  ``LAUNCHES["paged_decode"]`` counts kernel-B launches,
``LAUNCHES["paged_combine"]`` the combine's.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build
from .attention import QuantKV, _sdpa_cache, paged_gather

__all__ = ["flash_sdpa_decode", "flash_sdpa_verify", "dense_ring_attend",
           "paged_plain", "supported", "LAUNCHES",
           "LAST_VARIANT", "MAX_SPLITS"]

# The JAX package's split cap, kept for _num_splits (the reference's
# split rule); the card's split count comes from _plan.
MAX_SPLITS = 8
# windows of at most this many query rows take the decode variant
DECODE_MAX_TQ = 16
# head dims (Dk = Dv) the chunk variant is built for
CHUNK_HEAD_DIMS = (64, 128, 256)
# rows a decode-variant block serves (1 for a single row); the chunk
# variant's row tile
DECODE_ROWS, CHUNK_ROWS = 4, 64
# blocks a split count aims at per SM; tokens a split holds at least
BLOCKS_PER_SM = 4
MIN_SPLIT_TOKENS = {"decode": 32, "chunk": 64}
# page ids a split holds at most (the kernel keeps them in shared memory)
MAX_SPLIT_PAGES = 2048
# the largest head dim the decode variant takes (32 lanes x 16 dims)
MAX_HEAD_DIM = 512

LAUNCHES = {"paged_decode": 0, "paged_combine": 0}
# the variant the last launch of kernel B ran (see _plan)
LAST_VARIANT = {"paged_decode": None}

_POOL_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMS = {}


def _num_splits(m, cap=MAX_SPLITS):
    """Largest power-of-two split count <= min(m, cap) dividing m (1 when
    m is odd)."""
    s = 1
    while s * 2 <= min(m, cap) and m % (s * 2) == 0:
        s *= 2
    return s


def supported(q_shape, k_pool, v_pool, table_shape, num_heads,
              num_kv_heads=0):
    """Whether the kernel handles this paged shape: heads divide both
    embed dims, the pools are H_kv heads wide and quantized scale planes
    carry exactly H_kv columns.  The TPU tile gates have no counterpart:
    any page size and any head dim up to :data:`MAX_HEAD_DIM` are
    taken."""
    kd = k_pool.data if isinstance(k_pool, QuantKV) else k_pool
    vd = v_pool.data if isinstance(v_pool, QuantKV) else v_pool
    b, tq, e = q_shape
    kvh = int(num_kv_heads) or int(num_heads)
    if num_heads <= 0 or kvh <= 0 or num_heads % kvh:
        return False
    if e % num_heads or vd.shape[2] % kvh:
        return False
    if kd.shape[2] != kvh * (e // num_heads):
        return False
    if max(e // num_heads, vd.shape[2] // kvh) > MAX_HEAD_DIM:
        return False
    if isinstance(k_pool, QuantKV) and k_pool.scale.shape[-1] != kvh:
        return False
    if isinstance(v_pool, QuantKV) and v_pool.scale.shape[-1] != kvh:
        return False
    return kd.shape[1] > 0 and table_shape[1] > 0


def _dense_block(c, pt_pref=128):
    """Page size for the dense-ring identity view: the largest power of
    two <= min(c, pt_pref) dividing c."""
    bs = min(pt_pref, c)
    while c % bs:
        bs //= 2
    return bs


def _as_pool(cache, mb, bs):
    """A (B, C, E) ring (or QuantKV of rings) viewed as (B*Mb, bs, E)
    pages — a free row-major split."""
    if isinstance(cache, QuantKV):
        return QuantKV(_as_pool(cache.data, mb, bs),
                       _as_pool(cache.scale, mb, bs))
    return cache.reshape(cache.shape[0] * mb, bs, cache.shape[2])


def paged_plain(q, k_pool, v_pool, table, total_len, num_heads=1,
                scale=None, num_kv_heads=0):
    """Plain PyTorch version of the paged kernel and its combine: gather
    each slot's ring view, dequantize it, length-masked softmax."""
    return _sdpa_cache(q, paged_gather(k_pool, table),
                       paged_gather(v_pool, table), total_len, num_heads,
                       scale, num_kv_heads=num_kv_heads)


def _combine(acc, m_p, l_p, out_dtype):
    """Plain version of the combine kernel: the exact cross-split
    logsumexp combine of (B, H, S, tq, hd_v) partials -> (B, tq,
    H*hd_v)."""
    m_star = m_p.amax(dim=2, keepdim=True)
    m_star = torch.where(m_star == -torch.inf, torch.zeros_like(m_star),
                         m_star)
    alpha = torch.where(m_p == -torch.inf, torch.zeros_like(m_p),
                        torch.exp(m_p - m_star))
    l_tot = (alpha * l_p).sum(dim=2)                       # (B, H, tq)
    out = (alpha[..., None] * acc).sum(dim=2)              # (B, H, tq, hd)
    denom = torch.where(l_tot == 0, torch.ones_like(l_tot), l_tot)
    out = out / denom[..., None]
    b, h, tq, hd = out.shape
    return out.permute(0, 2, 1, 3).reshape(b, tq, h * hd).to(out_dtype)


def _launch_combine(acc, m_p, l_p, out_dtype):
    """Launch the combine kernel on kernel B's partials: acc (B, H, S, tq,
    hd_v), m_p and l_p (B, H, S, tq), f32 and contiguous on the card ->
    (B, tq, H*hd_v) in ``out_dtype`` (float32 or bfloat16).  A split whose
    m is -inf is skipped, its acc never read."""
    b, h, s, tq, hd = acc.shape
    out = torch.empty((b, tq, h * hd), dtype=out_dtype, device=acc.device)
    lib = cuda_build.lib("paged_decode")
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    rc = lib.paged_combine(_OUT_CODE[out_dtype], acc.data_ptr(),
                           m_p.data_ptr(), l_p.data_ptr(), out.data_ptr(), b,
                           tq, h, s, hd, stream)
    cuda_build.check(lib, rc, "paged_combine")
    LAUNCHES["paged_combine"] += 1
    return out


class Plan(NamedTuple):
    """Kernel B's launch on the card: ``variant`` ("decode" or "chunk",
    ``code`` its number in the C entry), ``splits`` of
    ``pages_per_split`` view pages, ``rows`` of the window a block serves
    (G q-heads x tq queries share a kv-head's pages; ``row_tiles`` blocks
    cover them), ``epl`` head dims a lane owns in the decode variant and
    ``blocks`` in the grid."""

    variant: str
    code: int
    splits: int
    pages_per_split: int
    rows: int
    row_tiles: int
    epl: int
    blocks: int


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def _plan(b, tq, heads, kv_heads, hd_k, hd_v, m, pt, sms, aligned=True):
    """The card's choices for kernel B (pure Python: the CPU tests read
    it).  One block per (split, kv-head, row tile, slot) serves every
    q-head of the kv group; the split count aims at BLOCKS_PER_SM blocks
    an SM of a card with ``sms`` SMs, since the live lengths stay on the
    device (splits past a slot's length exit at once)."""
    rows = (heads // kv_heads) * tq
    chunk = (tq > DECODE_MAX_TQ and hd_k == hd_v
             and hd_k in CHUNK_HEAD_DIMS and aligned)
    variant = "chunk" if chunk else "decode"
    row_tile = CHUNK_ROWS if chunk else (1 if rows == 1 else DECODE_ROWS)
    row_tiles = _cdiv(rows, row_tile)
    per_split = b * kv_heads * row_tiles
    splits = max(1, min(m, _cdiv(BLOCKS_PER_SM * sms, per_split)))
    pps = max(_cdiv(m, splits), _cdiv(MIN_SPLIT_TOKENS[variant], pt))
    pps = min(pps, m, MAX_SPLIT_PAGES)
    splits = _cdiv(m, pps)
    # head dims 64 / 128 / 256 / 512 fill the warp's 32 lanes exactly
    epl = next(e for e in (2, 4, 8, 16) if 32 * e >= max(hd_k, hd_v))
    return Plan(variant, int(chunk), splits, pps, row_tile, row_tiles, epl,
                splits * per_split)


def _sm_count(dev):
    got = _SMS.get(dev)
    if got is None:
        got = _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return got


def _paged_launch(q, k_pool, v_pool, table, lens, num_heads, scale,
                  num_kv_heads, combined):
    """Launch kernel B (and, with ``combined``, the combine kernel in the
    same device context); returns the output, or the split partials
    (acc, m, l) and the output dtype (the V pool's compute dtype: f32
    for quantized pools)."""
    quant = isinstance(k_pool, QuantKV)
    kd = k_pool.data if quant else k_pool
    vd = v_pool.data if quant else v_pool
    b, tq, e = q.shape
    h = int(num_heads)
    kvh = int(num_kv_heads) or h
    hd_k = e // h
    hd_v = vd.shape[2] // kvh
    pt = kd.shape[1]
    m = table.shape[1]
    scale = float(scale or 1.0 / np.sqrt(hd_k))
    dev = q.device
    code = _POOL_CODE.get(kd.dtype)
    if code is None or vd.dtype != kd.dtype:
        raise ValueError("paged decode kernel: unsupported pool dtypes %s/%s"
                         % (kd.dtype, vd.dtype))
    tensors = [kd, vd, table] + ([k_pool.scale, v_pool.scale] if quant
                                 else [])
    for t in tensors:
        if t.device != dev:
            raise ValueError("paged decode kernel: operand on %s, queries "
                             "on %s" % (t.device, dev))
        if not t.is_contiguous():
            raise ValueError("paged decode kernel: pools, scales and "
                             "table must be contiguous")
    qf = q.float().contiguous()
    if qf.data_ptr() % 16:
        qf = qf.clone()
    table = table.to(torch.int32).contiguous()
    lens = torch.as_tensor(lens, dtype=torch.int32, device=dev).reshape(
        -1).expand(b).contiguous()
    ks = k_pool.scale.float().contiguous() if quant else None
    vs = v_pool.scale.float().contiguous() if quant else None
    aligned = kd.data_ptr() % 16 == 0 and vd.data_ptr() % 16 == 0
    plan = _plan(b, tq, h, kvh, hd_k, hd_v, m, pt, _sm_count(dev), aligned)
    vec = int(aligned and hd_k == hd_v == 32 * plan.epl)
    s = plan.splits
    # the partials in one allocation: acc (B, H, S, tq, hd_v), then m, l
    n = b * h * s * tq
    buf = torch.empty(n * (hd_v + 2), dtype=torch.float32, device=dev)
    acc = buf[:n * hd_v].view(b, h, s, tq, hd_v)
    m_p = buf[n * hd_v:n * (hd_v + 1)].view(b, h, s, tq)
    l_p = buf[n * (hd_v + 1):].view(b, h, s, tq)
    out_dtype = torch.float32 if quant else vd.dtype
    lib = cuda_build.lib("paged_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_decode(
            plan.code, code, qf.data_ptr(), kd.data_ptr(), vd.data_ptr(),
            ks.data_ptr() if quant else None,
            vs.data_ptr() if quant else None,
            table.data_ptr(), lens.data_ptr(), acc.data_ptr(),
            m_p.data_ptr(), l_p.data_ptr(), b, tq, h, kvh, hd_k, hd_v, pt,
            m, s, plan.pages_per_split, plan.rows, plan.epl, vec, scale,
            stream)
        cuda_build.check(lib, rc, "paged_decode")
        LAUNCHES["paged_decode"] += 1
        LAST_VARIANT["paged_decode"] = plan.variant
        if not combined:
            return acc, m_p, l_p, out_dtype
        return _launch_combine(acc, m_p, l_p, out_dtype)


def _paged_flash_call(q, k_pool, v_pool, table, lens, num_heads, scale,
                      num_kv_heads=0):
    """Launch kernel B and the combine kernel; returns (B, tq, Ev) in the
    V pool's compute dtype (f32 for quantized pools)."""
    return _paged_launch(q, k_pool, v_pool, table, lens, num_heads, scale,
                         num_kv_heads, combined=True)


def _paged_entry(q, k_pool, v_pool, table, total_len, num_heads, scale,
                 num_kv_heads):
    if q.device.type == "cpu":
        return paged_plain(q, k_pool, v_pool, table, total_len, num_heads,
                           scale, num_kv_heads)
    if not supported(q.shape, k_pool, v_pool, table.shape, num_heads,
                     num_kv_heads=num_kv_heads):
        kd = k_pool.data if isinstance(k_pool, QuantKV) else k_pool
        vd = v_pool.data if isinstance(v_pool, QuantKV) else v_pool
        raise ValueError(
            "paged decode kernel: queries %s with %s heads (%s kv-heads) "
            "do not fit pools %s / %s through a %s table"
            % (tuple(q.shape), num_heads, num_kv_heads or num_heads,
               tuple(kd.shape), tuple(vd.shape), tuple(table.shape)))
    if q.device.type != "cuda":
        raise ValueError("paged decode kernel: unsupported device %s"
                         % q.device)
    return _paged_flash_call(q, k_pool, v_pool, table, total_len,
                             num_heads, scale, num_kv_heads=num_kv_heads)


def flash_sdpa_decode(q, k_pool, v_pool, table, total_len, num_heads=1,
                      scale=None, num_kv_heads=0):
    """Paged decode attention: (B, 1, E) queries over (P, pt, E_kv) pools
    through (B, M) page tables -> (B, 1, Ev).  ``total_len`` counts
    tokens appended including the query position; pools may be
    :class:`QuantKV` (dequantized per (token, kv-head) in the kernel)."""
    return _paged_entry(q, k_pool, v_pool, table, total_len, num_heads,
                        scale, num_kv_heads)


def flash_sdpa_verify(q, k_pool, v_pool, table, total_len, num_heads=1,
                      scale=None, num_kv_heads=0):
    """Paged multi-position attention (a verify window or a prefill
    chunk, tq > 1): query i masks to view slots v < min(total - (tq-1) +
    i, C)."""
    return _paged_entry(q, k_pool, v_pool, table, total_len, num_heads,
                        scale, num_kv_heads)


def dense_ring_attend(q, k_cache, v_cache, total_len, num_heads=1,
                      scale=None, num_kv_heads=0):
    """The dense-ring variant: the same kernel over (B, C, E) ring
    buffers, viewed as (B*Mb, bs, E) pages with ``table[b, m] = b*Mb +
    m``.  CPU tensors take ``sdpa_decode``'s plain path."""
    if q.device.type == "cpu":
        return _sdpa_cache(q, k_cache, v_cache, total_len, num_heads,
                           scale, num_kv_heads=num_kv_heads)
    kd = k_cache.data if isinstance(k_cache, QuantKV) else k_cache
    b, c = kd.shape[0], kd.shape[1]
    bs = _dense_block(c)
    mb = c // bs
    table = (torch.arange(b, dtype=torch.int32, device=q.device)[:, None]
             * mb + torch.arange(mb, dtype=torch.int32,
                                 device=q.device)[None, :])
    return _paged_entry(q, _as_pool(k_cache, mb, bs),
                        _as_pool(v_cache, mb, bs), table, total_len,
                        num_heads, scale, num_kv_heads)
