"""Attention ops of the serving slice (counterpart of
``mxnet_tpu/ops/attention.py``).

* :func:`sdpa`: full causal multi-head attention (the serving dense
  prefill and cross-attention), grouped-query aware.
* The ``dot_product_attention`` op: the shapes
  :func:`~mxnet_tpu_torch.ops.flash_kernel.supported` takes through
  :func:`sdpa_flash` (kernels C, D and E of
  :mod:`~mxnet_tpu_torch.ops.flash_kernel`, differentiable), every
  other shape through :func:`sdpa`; :data:`PATH_TAKEN` records which.
* The KV-cache ops: :class:`QuantKV` with :func:`quantize_kv` /
  :func:`dequantize_kv`, the dense ring (:func:`cache_append`,
  :func:`sdpa_decode`, :func:`sdpa_verify`) and the paged pools
  (:func:`paged_gather`, :func:`paged_append`, :func:`paged_copy`).
  Unlike the JAX package, which returns new buffers, the port updates
  caches and pools IN PLACE (and returns them) — no copy of a pool per
  step.
* :func:`paged_attend` / :func:`cache_attend`: the decode-side dispatch.
  They call kernel B's wrappers
  (:mod:`~mxnet_tpu_torch.ops.decode_kernel`): the kernel on CUDA
  tensors (or an error where it does not take the shapes), the gather +
  dequantize + masked-softmax plain version on CPU tensors, or the plain
  version everywhere when ``plain=True``.

Layouts are the JAX package's: (B, T, E) activations, (P, page_tokens,
E_kv) pools, (B, C, H_kv) / (P, page_tokens, H_kv) scale planes, (B, M)
int32 page tables.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op


def check_head_groups(num_heads, num_kv_heads, e, ev=None, kv_dim=None,
                      where="dot_product_attention"):
    """Validate a (possibly grouped) head configuration, raising
    ``ValueError``s that name the offending dims.  Returns ``(kv_heads,
    group)``: ``kv_heads`` resolved (0 -> ``num_heads``) and the group
    factor G = ``num_heads // kv_heads``."""
    heads = int(num_heads)
    kvh = int(num_kv_heads) or heads
    if heads <= 0:
        raise ValueError("%s: num_heads=%d must be positive"
                         % (where, heads))
    if kvh <= 0:
        raise ValueError("%s: num_kv_heads=%d must be positive"
                         % (where, kvh))
    if heads % kvh != 0:
        raise ValueError("%s: num_heads=%d not divisible by "
                         "num_kv_heads=%d" % (where, heads, kvh))
    if e % heads != 0:
        raise ValueError("%s: query embed dim %d not divisible by "
                         "num_heads=%d" % (where, e, heads))
    if ev is not None and ev % kvh != 0:
        raise ValueError("%s: value embed dim %d not divisible by "
                         "num_kv_heads=%d" % (where, ev, kvh))
    if kv_dim is not None and kv_dim != kvh * (e // heads):
        raise ValueError(
            "%s: key embed dim %d != num_kv_heads=%d * head_dim=%d"
            % (where, kv_dim, kvh, e // heads))
    return kvh, heads // kvh


def _softmax_rows(logits):
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    return p / p.sum(dim=-1, keepdim=True)


def sdpa(q, k, v, num_heads=1, causal=False, scale=None, num_kv_heads=0):
    """Multi-head scaled-dot-product attention: (B, Tq, E), (B, Tk, Ek),
    (B, Tk, Ev) -> (B, Tq, H*hdv).  Softmax in f32; output in v's dtype.
    Grouped K/V (``num_kv_heads``): q-head h attends kv-head h // G."""
    b, tq, e = q.shape
    tk = k.shape[1]
    ev = v.shape[2]
    kvh, g = check_head_groups(num_heads, num_kv_heads, e, ev, k.shape[2],
                               where="sdpa")
    hd = e // num_heads
    scale = float(scale or 1.0 / np.sqrt(hd))
    qh = q.reshape(b, tq, kvh, g, hd)
    kh = k.reshape(b, tk, kvh, hd)
    vh = v.reshape(b, tk, kvh, ev // kvh)
    dt = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qh.to(dt),
                          kh.to(dt)).float() * scale
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(diagonal=tk - tq)
        logits = torch.where(mask, logits,
                             torch.finfo(torch.float32).min)
    p = _softmax_rows(logits)
    out = torch.einsum("bhgqk,bkhe->bqhge", p.to(vh.dtype), vh)
    return out.reshape(b, tq, num_heads * (ev // kvh))


# ---------------------------------------------------------------------------
# KV caches: dense ring buffers and quantized storage
# ---------------------------------------------------------------------------

class QuantKV(NamedTuple):
    """A quantized cache or pool: narrow ``data`` (int8 / fp8) plus f32
    ``scale``, one per (token, kv-head)."""

    data: torch.Tensor
    scale: torch.Tensor


# quantization range per storage dtype (symmetric round-to-nearest in
# [-127, 127] for int8; the fp8 variants scale into their finite max)
_KV_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0,
            torch.float8_e5m2: 57344.0}


def kv_qmax(dtype):
    """Quantization range of a KV storage dtype (KeyError = unsupported)."""
    return _KV_QMAX[dtype]


def quantize_kv(x, dtype, num_heads=1):
    """(B, t, E) float K/V -> :class:`QuantKV` with per-(token, head)
    scales ``amax_head / qmax``; all-zero heads quantize under a floor
    scale."""
    b, t, e = x.shape
    if e % num_heads != 0:
        raise ValueError("quantize_kv: embed dim %d not divisible by "
                         "num_heads=%d" % (e, num_heads))
    qmax = kv_qmax(dtype)
    xh = x.float().reshape(b, t, num_heads, e // num_heads)
    amax = xh.abs().amax(dim=-1)                              # (B, t, H)
    scale = torch.clamp_min(amax, 1e-8) / qmax
    q = xh / scale[..., None]
    if not dtype.is_floating_point:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return QuantKV(q.to(dtype).reshape(b, t, e), scale)


def dequantize_kv(cache, num_heads=None, out_dtype=None):
    """:class:`QuantKV` -> the float (B, C, E) buffer (``data * scale``
    per head); plain tensors pass through."""
    if not isinstance(cache, QuantKV):
        return cache
    b, c, e = cache.data.shape
    h = cache.scale.shape[-1]
    if num_heads is not None and num_heads != h:
        raise ValueError("cache quantized with %d heads, caller expects %d"
                         % (h, num_heads))
    x = cache.data.float().reshape(b, c, h, e // h) * cache.scale[..., None]
    x = x.reshape(b, c, e)
    return x.to(out_dtype) if out_dtype is not None else x


_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _raw(t):
    """fp8 buffers are indexed as bytes: PyTorch's indexing kernels do
    not all take the fp8 dtypes."""
    return t.view(torch.uint8) if t.dtype in _FP8 else t


def _as_lens(start_pos, b, device):
    return torch.as_tensor(start_pos, dtype=torch.int64,
                           device=device).reshape(-1).expand(b)


def cache_append(cache, new, start_pos, num_heads=1):
    """Write ``new`` (B, t, E) into ring slots [start_pos, start_pos+t)
    mod C of ``cache`` (B, C, E), in place; returns the cache.
    ``start_pos`` is a scalar or (B,) count of tokens already cached.  A
    :class:`QuantKV` cache quantizes ``new`` on the way in."""
    if isinstance(cache, QuantKV):
        qnew = quantize_kv(new, cache.data.dtype, num_heads)
        cache_append(cache.data, qnew.data, start_pos)
        cache_append(cache.scale, qnew.scale, start_pos)
        return cache
    b, t = new.shape[0], new.shape[1]
    c = cache.shape[1]
    start = _as_lens(start_pos, b, cache.device)
    new = new.to(cache.dtype)
    if t > c:
        # only the latest C tokens can land; trimming first keeps the
        # slot indices unique per row
        new = new[:, -c:]
        start = start + (t - c)
        t = c
    pos = (start[:, None] + torch.arange(t, device=cache.device)) % c
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    _raw(cache)[rows, pos] = _raw(new)
    return cache


def _sdpa_cache(q, k_cache, v_cache, total_len, num_heads, scale,
                num_kv_heads=0):
    """Length-masked cache attention behind :func:`sdpa_decode` and
    :func:`sdpa_verify`: query i of tq sees cache slots v < min(total -
    (tq-1) + i, C).  Quantized caches dequantize here, per kv-head."""
    b, tq, e = q.shape
    kvh, g = check_head_groups(num_heads, num_kv_heads, e,
                               where="sdpa_decode")
    k_cache = dequantize_kv(k_cache, kvh)
    v_cache = dequantize_kv(v_cache, kvh)
    c = k_cache.shape[1]
    ev = v_cache.shape[2]
    if ev % kvh != 0:
        raise ValueError("sdpa_decode: value cache dim %d not divisible "
                         "by num_kv_heads=%d" % (ev, kvh))
    hd = e // num_heads
    if k_cache.shape[2] != kvh * hd:
        raise ValueError(
            "sdpa_decode: key cache dim %d != num_kv_heads=%d * "
            "head_dim=%d" % (k_cache.shape[2], kvh, hd))
    scale = float(scale or 1.0 / np.sqrt(hd))
    dev = q.device
    qh = q.reshape(b, tq, kvh, g, hd)
    kh = k_cache.reshape(b, c, kvh, hd)
    vh = v_cache.reshape(b, c, kvh, ev // kvh)
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qh.to(dt),
                          kh.to(dt)).float() * scale
    total = torch.as_tensor(total_len, dtype=torch.int64,
                            device=dev).reshape(-1, 1, 1, 1, 1)
    qpos = torch.arange(tq, device=dev).reshape(1, 1, 1, tq, 1)
    limit = torch.clamp_max(total - (tq - 1) + qpos, c)
    slot = torch.arange(c, device=dev).reshape(1, 1, 1, 1, c)
    logits = torch.where(slot < limit, logits,
                         torch.finfo(torch.float32).min)
    p = _softmax_rows(logits)
    out = torch.einsum("bhgqk,bkhe->bqhge", p.to(vh.dtype), vh)
    return out.reshape(b, tq, num_heads * (ev // kvh))


def sdpa_decode(q, k_cache, v_cache, total_len, num_heads=1, scale=None,
                num_kv_heads=0):
    """Attend query position(s) (B, tq, E) against a ring-buffer cache;
    ``total_len`` counts appended tokens including the queries."""
    return _sdpa_cache(q, k_cache, v_cache, total_len, num_heads, scale,
                       num_kv_heads=num_kv_heads)


def sdpa_verify(q, k_cache, v_cache, total_len, num_heads=1, scale=None,
                num_kv_heads=0):
    """Length-masked multi-position cache attention (a k+1 verify window
    or a prefill chunk): each row sees itself and everything before it."""
    return _sdpa_cache(q, k_cache, v_cache, total_len, num_heads, scale,
                       num_kv_heads=num_kv_heads)


# ---------------------------------------------------------------------------
# Paged mode: one pool of fixed-size pages per attention node, per-slot page
# tables as data; position p of a slot lives at pool[table[slot, (p //
# page_tokens) % M], p % page_tokens].  Page 0 is the scratch page: unmapped
# table entries point at it and masked writes are redirected into it.
# ---------------------------------------------------------------------------

def paged_gather(pool, table):
    """The (B, M*page_tokens, E) dense-ring view of each slot's pages."""
    if isinstance(pool, QuantKV):
        return QuantKV(paged_gather(pool.data, table),
                       paged_gather(pool.scale, table))
    b, m = table.shape
    pages = _raw(pool)[table.long()]          # (B, M, page_tokens, E)
    return pages.reshape(b, m * pool.shape[1], pool.shape[2]).view(
        pool.dtype)


def paged_append(pool, table, new, start_pos, num_heads=1, active=None,
                 valid=None):
    """Scatter ``new`` (B, t, E) into the pool at ring positions
    [start_pos, start_pos + t) of each slot's table, in place; returns
    the pool.  Rows with ``active`` 0 and positions >= ``valid`` write to
    the scratch page instead, its own content back, so the scratch page
    keeps what it held (zeros from a fresh batch state) whatever order
    the card writes them in.  A :class:`QuantKV` pool quantizes on the
    way in."""
    if isinstance(pool, QuantKV):
        qnew = quantize_kv(new, pool.data.dtype, num_heads)
        paged_append(pool.data, table, qnew.data, start_pos, active=active,
                     valid=valid)
        paged_append(pool.scale, table, qnew.scale, start_pos,
                     active=active, valid=valid)
        return pool
    b, t = new.shape[0], new.shape[1]
    m = table.shape[1]
    pt = pool.shape[1]
    c = m * pt
    dev = pool.device
    start = _as_lens(start_pos, b, dev)
    new = new.to(pool.dtype)
    if t > c:
        new = new[:, -c:]
        start = start + (t - c)
        t = c
    pos = start[:, None] + torch.arange(t, device=dev)[None, :]  # (B, t)
    page = torch.gather(table.long(), 1, (pos // pt) % m)
    write = torch.ones((b, t), dtype=torch.bool, device=dev)
    if active is not None:
        write &= torch.as_tensor(active, device=dev).reshape(-1, 1).bool()
    if valid is not None:
        write &= torch.arange(t, device=dev)[None, :] < torch.as_tensor(
            valid, device=dev).reshape(-1, 1)
    page = torch.where(write, page, torch.zeros_like(page))
    slot = (pos % pt).reshape(-1)
    raw = _raw(pool)
    rows = _raw(new.reshape(b * t, -1))
    # the rows that do not write put back what the scratch page holds:
    # several of them land on one scratch position, and a scatter of
    # differing values there keeps whichever the card wrote last, which
    # rows of a pad or an idle slot then read (a mixture of experts
    # routes those rows, and they take capacity)
    rows = torch.where(write.reshape(-1, 1), rows,
                       raw[0].index_select(0, slot))
    raw[page.reshape(-1), slot] = rows
    return pool


def paged_copy(pool, src, dst):
    """Copy page ``src`` -> page ``dst`` in place (the device half of a
    copy-on-write fork); :class:`QuantKV` pools copy both planes.  The
    ids are ints, or (1,) int64 tensors on the pool's device (what a
    captured fork reads)."""
    if isinstance(pool, QuantKV):
        paged_copy(pool.data, src, dst)
        paged_copy(pool.scale, src, dst)
        return pool
    raw = _raw(pool)
    src, dst = (torch.as_tensor(i, dtype=torch.int64,
                                device=pool.device).reshape(1)
                for i in (src, dst))
    raw.index_copy_(0, dst, raw.index_select(0, src))
    return pool


# Which path the last decode-side dispatch took: "kernel" (kernel B
# launched) or "plain" (its plain version: CPU tensors or plain=True).
DECODE_PATH = {"last": None}


def paged_attend(q, k_pool, v_pool, table, total_len, num_heads=1,
                 scale=None, num_kv_heads=0, plain=False):
    """Decode/verify/chunk attention over shared page pools — the one
    entry the decode layer calls.  Kernel B's wrapper
    (``flash_sdpa_decode`` at tq = 1, ``flash_sdpa_verify`` otherwise;
    it raises on CUDA shapes the kernel does not take) unless ``plain``:
    then the gather + dequantize + masked-softmax plain version."""
    from . import decode_kernel as dk

    if plain:
        out = dk.paged_plain(q, k_pool, v_pool, table, total_len,
                             num_heads, scale, num_kv_heads)
    else:
        fn = dk.flash_sdpa_decode if q.shape[1] == 1 \
            else dk.flash_sdpa_verify
        out = fn(q, k_pool, v_pool, table, total_len, num_heads=num_heads,
                 scale=scale, num_kv_heads=num_kv_heads)
    DECODE_PATH["last"] = ("plain" if plain or q.device.type == "cpu"
                           else "kernel")
    return out


def cache_attend(q, k_cache, v_cache, total_len, num_heads=1, scale=None,
                 num_kv_heads=0, plain=False):
    """Decode/verify attention over dense (B, C, E) ring buffers: kernel
    B through an identity page table
    (:func:`~mxnet_tpu_torch.ops.decode_kernel.dense_ring_attend`), or
    :func:`sdpa_decode`'s masked softmax when ``plain``."""
    from . import decode_kernel as dk

    if plain:
        out = _sdpa_cache(q, k_cache, v_cache, total_len, num_heads, scale,
                          num_kv_heads=num_kv_heads)
    else:
        out = dk.dense_ring_attend(q, k_cache, v_cache, total_len,
                                   num_heads=num_heads, scale=scale,
                                   num_kv_heads=num_kv_heads)
    DECODE_PATH["last"] = ("plain" if plain or q.device.type == "cpu"
                           else "kernel")
    return out


def _attn_shape(attrs, in_shapes, aux_shapes):
    q, k, v = in_shapes
    heads = attrs.get("num_heads", 1)
    kvh, _ = check_head_groups(heads, attrs.get("num_kv_heads", 0),
                               q[-1], v[-1], k[-1],
                               where="dot_product_attention")
    if k[0] != v[0] or k[1] != v[1]:
        raise ValueError("dot_product_attention: key/value (B, T) differ")
    out = (q[0], q[1], heads * (v[-1] // kvh))
    return [tuple(q), tuple(k), tuple(v)], [out], []


# Which path the last dot_product_attention op took: "flash" (kernels C,
# D and E through FlashAttentionFn), "plain" (FlashAttentionFn on their
# plain versions: CPU tensors or a plain run) or "einsum" (sdpa: every
# shape flash_kernel.supported refuses — cross-attention, a value head
# dim other than the query's, a head dim or dtype the kernels are not
# built for — on every device, as the JAX package's gate routes them)
PATH_TAKEN = {"last": None}


def sdpa_flash(q, k, v, num_heads, causal, scale=None, num_kv_heads=0,
               plain=False):
    """Self-attention (B, T, E) -> (B, T, E) through
    :class:`~mxnet_tpu_torch.ops.flash_kernel.FlashAttentionFn`, heads
    folded into the batch dim (q at H heads, K/V at H_kv; q-row b reads
    kv-row b // G) — ``pallas_attention.sdpa_flash``'s contract."""
    from .flash_kernel import FlashAttentionFn

    b, t, e = q.shape
    kvh = int(num_kv_heads) or int(num_heads)
    g = num_heads // kvh
    hd = e // num_heads
    scale = float(scale or 1.0 / np.sqrt(hd))

    def fold(x, h):
        return x.reshape(b, t, h, x.shape[2] // h).transpose(1, 2) \
            .reshape(b * h, t, x.shape[2] // h)

    out = FlashAttentionFn.apply(fold(q, num_heads), fold(k, kvh),
                                 fold(v, kvh), scale, bool(causal), g,
                                 bool(plain))
    return out.reshape(b, num_heads, t, hd).transpose(1, 2).reshape(b, t, e)


def register_all():
    from . import flash_kernel

    def _compute_full(attrs, inputs, aux, octx):
        q, k, v = inputs
        heads = attrs.get("num_heads", 1)
        kv_heads = attrs.get("num_kv_heads", 0) or heads
        causal = attrs.get("causal", False)
        scale = attrs.get("scale", 0.0) or None
        check_head_groups(heads, kv_heads, q.shape[2], v.shape[2],
                          k.shape[2], where="dot_product_attention")
        if q.dtype == k.dtype == v.dtype and flash_kernel.supported(
                q.shape, k.shape, q.dtype, heads, kv_heads, v.shape):
            out = sdpa_flash(q, k, v, heads, causal, scale,
                             num_kv_heads=kv_heads, plain=octx.plain)
            PATH_TAKEN["last"] = ("plain" if octx.plain
                                  or q.device.type == "cpu" else "flash")
            return [out], []
        PATH_TAKEN["last"] = "einsum"
        return [sdpa(q, k, v, num_heads=heads, causal=causal, scale=scale,
                     num_kv_heads=kv_heads)], []

    register_op(OpDef(
        "dot_product_attention", _compute_full,
        schema=ParamSchema(
            Param("num_heads", int, default=1),
            Param("num_kv_heads", int, default=0,
                  doc="grouped-query attention: K/V head count "
                      "(must divide num_heads); 0 = num_heads (MHA)"),
            Param("causal", bool, default=False),
            Param("scale", float, default=0.0,
                  doc="0 = 1/sqrt(head_dim)"),
        ),
        num_inputs=3, arguments=["query", "key", "value"],
        infer_shape=_attn_shape,
        doc="Multi-head scaled-dot-product attention over projected "
            "(B, T, E) inputs; self-attention runs the flash kernels."),
        aliases=("_contrib_DotProductAttention",))
