"""Kernel B: paged split-K flash decoding with in-kernel dequantization —
the counterpart of ``mxnet_tpu/ops/pallas_decode.py``.

The wrappers :func:`flash_sdpa_decode` (tq = 1), :func:`flash_sdpa_verify`
(tq > 1: a verify window or a prefill chunk) and
:func:`dense_ring_attend` (dense (B, C, E) rings through an identity page
table) launch the hand-written kernel in ``csrc/paged_decode.cu`` on CUDA
tensors, or raise (also on shapes :func:`supported` refuses); on CPU
tensors they run the plain version,
:func:`paged_plain` (``paged_gather`` + ``dequantize_kv`` + the masked
softmax of ``_sdpa_cache``).  ``LAUNCHES["paged_decode"]`` counts kernel
launches.

The kernel writes unnormalised per-split partials; the cross-split
logsumexp combine (:func:`_combine`) stays a few torch ops, as it is jnp
outside the ``pallas_call`` in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import cuda_build
from .attention import QuantKV, _sdpa_cache, paged_gather

__all__ = ["flash_sdpa_decode", "flash_sdpa_verify", "dense_ring_attend",
           "paged_plain", "supported", "LAUNCHES",
           "MAX_SPLITS"]

# Split-K: at most MAX_SPLITS splits over the view's M pages (the largest
# power of two <= min(M, MAX_SPLITS) dividing M).  A constant: this port
# has no tuning cache yet.
MAX_SPLITS = 8
# Query rows per block at most (the tq-tile height); halved until the
# block's shared memory fits the card's 227 KB.
MAX_TQ_TILE = 16
_SMEM_LIMIT = 227 * 1024

LAUNCHES = {"paged_decode": 0}

_POOL_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}


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
    any page size and head dim are taken."""
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
    """Exact cross-split logsumexp combine of (B, H, S, tq, hd_v) partials
    -> (B, tq, H*hd_v)."""
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


def _tq_tile(tq, hd_k, hd_v, lib):
    tile = min(tq, MAX_TQ_TILE)
    while tile > 1 and lib.paged_decode_smem_bytes(tile, hd_k, hd_v) \
            > _SMEM_LIMIT:
        tile //= 2
    if lib.paged_decode_smem_bytes(tile, hd_k, hd_v) > _SMEM_LIMIT:
        raise ValueError("paged decode kernel: head dims (%d, %d) exceed a "
                         "block's shared memory" % (hd_k, hd_v))
    return tile


def _paged_flash_call(q, k_pool, v_pool, table, lens, num_heads, scale,
                      num_kv_heads=0):
    """Launch kernel B and combine its split partials; returns (B, tq,
    Ev) in the V pool's compute dtype (f32 for quantized pools)."""
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
    s = _num_splits(m)
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
    table = table.to(torch.int32).contiguous()
    lens = torch.as_tensor(lens, dtype=torch.int32, device=dev).reshape(
        -1).expand(b).contiguous()
    ks = k_pool.scale.float().contiguous() if quant else None
    vs = v_pool.scale.float().contiguous() if quant else None
    acc = torch.empty((b, h, s, tq, hd_v), dtype=torch.float32, device=dev)
    m_p = torch.empty((b, h, s, tq), dtype=torch.float32, device=dev)
    l_p = torch.empty((b, h, s, tq), dtype=torch.float32, device=dev)
    lib = cuda_build.lib("paged_decode")
    tile = _tq_tile(tq, hd_k, hd_v, lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_decode(
            code, qf.data_ptr(), kd.data_ptr(), vd.data_ptr(),
            ks.data_ptr() if quant else None,
            vs.data_ptr() if quant else None,
            table.data_ptr(), lens.data_ptr(), acc.data_ptr(),
            m_p.data_ptr(), l_p.data_ptr(), b, tq, h, kvh, hd_k, hd_v, pt,
            m, s, tile, scale, stream)
    cuda_build.check(lib, rc, "paged_decode")
    LAUNCHES["paged_decode"] += 1
    return _combine(acc, m_p, l_p, torch.float32 if quant else vd.dtype)


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
