"""Ring attention: explicit-collective sequence parallelism (the
counterpart of ``mxnet_tpu/parallel/ring.py``).

Each rank holds one sequence block of Q, K and V; the K/V blocks travel
around the ``seq`` group (:class:`~mxnet_tpu_torch.parallel.collectives.
RingShift`, ``lax.ppermute``'s counterpart: every rank sends to the next
and receives from the previous one) while each rank accumulates its
queries' attention over every block with a streaming log-sum-exp merge,
so no rank holds the full (T, T) scores or the full K/V.

Usage, under :func:`~mxnet_tpu_torch.parallel.compat.shard_map` over a
mesh with a ``seq`` axis (every rank holds the global arrays)::

    out = shard_map(
        lambda q, k, v: ring_attention(q, k, v, axis_name="seq",
                                       num_heads=16, causal=True),
        mesh=mesh, in_specs=((None, "seq", None),) * 3,
        out_specs=(None, "seq", None))(q, k, v)

or with the seq ``ProcessGroup`` itself as ``axis_name`` (what a mesh
``Module``'s walk passes).  Ring x TP: with the embed dims also split
over a model axis in whole head groups, pass ``head_axis`` (its name or
group) and the GLOBAL head counts; each model rank rotates its own
heads' K/V only.

The per-hop compute:

* ``flash`` (:class:`_RingFlashFn`): kernels C, D and E a hop through
  their operators (``ops.flash_kernel``; on CPU tensors the operators'
  plain versions, under ``plain`` the plain functions directly).  The
  forward runs C with ``lse`` on each block: a block from an earlier
  rank in full, the rank's own block causal, a later rank's skipped
  (no launch), chosen by the block's global offset; the partials merge
  by their ``lse`` weights.  The backward is a second ring of D and E
  fed the GLOBAL ``lse`` and a ``delta`` computed once from the merged
  output (``flash_kernel.flash_delta``), the dK / dV accumulators (f32,
  at the kv width) travelling with their blocks and arriving home after
  n rotations.  Grouped K/V (G = H / H_kv) stay at their kv width: every
  shift is G times smaller, and the kernels' ``groups`` map q-head h
  onto kv block h // G.
* ``streaming``: plain torch, the reference's jnp math (a running
  (m, l, acc) merge in f32, the causal mask from global offsets, guards
  for fully masked rows), differentiated by autograd through
  :func:`~mxnet_tpu_torch.parallel.collectives.ring_shift_grad`.

``ring_attention`` takes the flash path wherever
``flash_kernel.supported`` takes the local shapes (head dims 64 / 128,
f32 / bf16, value width = head dim), on the card and on the CPU alike,
and the streaming path elsewhere; ``RING_PATH`` records which ran.
``use_flash=True`` on a shape the kernels refuse raises.

Schedules of the flash path (``double_buffer``, default
``MXNET_RING_DOUBLE_BUFFER``): the double-buffered ring posts hop r+1's
K/V shift (and, backward, the accumulator rotation carrying hops <= r-1)
before hop r's kernels, so the transfer runs while the card computes;
the serial ring shifts after them.  Both visit the blocks and merge the
partials in the same order, so they are bit-identical; both drop the
last hop's K/V rotation (an n-hop ring moves n-1 K/V blocks a tensor
forward, n-1 backward, and n dK / dV rotations).  The streaming path has
one schedule, the serial one, and ignores ``double_buffer``.

Stated differences: ``interpret`` is accepted and means nothing (there
is no Pallas interpreter), so the reference's interpreter warning is
gone; the backward kernels take ``delta`` from the merged output,
where the reference's ``_bwd_call`` recomputes it; ``plain`` (the
per-hop compute on the plain versions) is the port's own.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from . import collectives as C

__all__ = ["ring_attention", "dense_attention", "RING_PATH"]

# which per-hop compute the last ring_attention call used ("flash" |
# "streaming"), as ops.attention.PATH_TAKEN records the op's path
RING_PATH = {"last": None}

# shift tags: (K, V) forward, (K, V) and (dK, dV) backward, a hop each
_TAGS = {"kv": (1, 2), "kv_bwd": (3, 4), "dkv": (5, 6)}


def _tags(kind, hop):
    return tuple(8 * hop + t for t in _TAGS[kind])


class _Done:
    """A shift of a ring of one: the tensors themselves."""

    def __init__(self, tensors):
        self._out = list(tensors)

    def wait(self):
        return self._out


def _post(tensors, ring, tags):
    group, n, _ = ring
    if n == 1:
        return _Done(tensors)
    return C.RingShift(tensors, group, tags)


def dense_attention(q, k, v, num_heads=1, causal=False, scale=None,
                    num_kv_heads=0):
    """Single-device reference: the ``dot_product_attention`` op's own
    einsum path (``ops.attention.sdpa``)."""
    from ..ops.attention import sdpa

    return sdpa(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                num_heads=num_heads, causal=causal, scale=scale,
                num_kv_heads=num_kv_heads)


def _resolve(axis, what):
    """``(group, size, index)`` of a mesh axis name (the innermost
    ``compat.shard_map``'s), a ``compat.MeshAxis`` or a ProcessGroup."""
    from . import compat

    if isinstance(axis, str):
        axis = compat.axis(axis)
    if isinstance(axis, compat.MeshAxis):
        return axis.group, axis.size, axis.index
    if axis is None:
        raise MXNetError("ring_attention: %s is None: name a mesh axis or "
                         "pass a ProcessGroup" % what)
    return axis, C._group_size(axis), C._group_rank(axis)


def ring_attention(q, k, v, axis_name, num_heads=1, causal=False,
                   scale=None, use_flash=None, interpret=None,
                   head_axis=None, double_buffer=None, num_kv_heads=0,
                   plain=False):
    """Blockwise ring attention over ``axis_name`` (a mesh axis name
    bound by ``compat.shard_map``, or a ProcessGroup).

    ``q``, ``k``, ``v`` are this rank's sequence blocks (B, T_local,
    E_local); rank i starts with K/V block i and ends with its queries'
    attention over the whole sequence (causal masking by global block
    offsets), equal to :func:`dense_attention` on the gathered
    sequence.  ``head_axis`` (ring x TP): the embed dims are split over
    that axis in whole head groups and ``num_heads`` / ``num_kv_heads``
    are the GLOBAL counts, divided here by its size.  ``use_flash``
    forces the per-hop compute (None: the kernels wherever they take the
    shapes); ``interpret`` means nothing here; ``double_buffer`` picks
    the flash path's schedule (None: ``MXNET_RING_DOUBLE_BUFFER``; the
    streaming path has one); ``plain`` runs the
    flash path's hops on the kernels' plain versions."""
    from .. import config as _config
    from ..ops import flash_kernel
    from ..ops.attention import check_head_groups

    del interpret
    ring = _resolve(axis_name, "axis_name")
    b, t_local, e = q.shape
    if head_axis is not None:
        # head-group sharding: the counts are global and must divide the
        # axis, at kv-head granularity too (named ValueErrors, not a
        # reshape error inside the ring)
        _, head_par, _ = _resolve(head_axis, "head_axis")
        if num_heads % head_par != 0:
            raise ValueError(
                "ring_attention: num_heads=%d not divisible by %r axis "
                "size %d" % (num_heads, head_axis, head_par))
        kvh_global = int(num_kv_heads) or int(num_heads)
        if kvh_global % head_par != 0:
            raise ValueError(
                "ring_attention: num_kv_heads=%d not divisible by %r "
                "axis size %d" % (kvh_global, head_axis, head_par))
        num_heads //= head_par
        num_kv_heads = kvh_global // head_par
    num_kv_heads, group = check_head_groups(
        num_heads, num_kv_heads, e, v.shape[2], k.shape[2],
        where="ring_attention")
    hd = e // num_heads
    ev = v.shape[2] // num_kv_heads
    scale = float(scale or 1.0 / np.sqrt(hd))
    if double_buffer is None:
        double_buffer = _config.get("MXNET_RING_DOUBLE_BUFFER")
    # the kernels' own gate (one copy of the rule); the ring also needs
    # one value width (ev == hd) and one dtype
    fits = (q.dtype == k.dtype == v.dtype and ev == hd
            and tuple(k.shape[:2]) == (b, t_local)
            and flash_kernel.supported(q.shape, k.shape, q.dtype, num_heads,
                                       num_kv_heads, v.shape))
    if use_flash and not fits:
        raise ValueError(
            "ring_attention(use_flash=True): kernels C-E do not take q %s "
            "%s, k %s, v %s at %d heads / %d kv-heads (head dims %s, "
            "float32 / bfloat16, value width = head dim)"
            % (tuple(q.shape), q.dtype, tuple(k.shape), tuple(v.shape),
               num_heads, num_kv_heads, flash_kernel.HEAD_DIMS))
    if use_flash is None:
        use_flash = fits
    if use_flash:
        RING_PATH["last"] = "flash"
        return _RingFlashFn.apply(q, k, v, ring, num_heads, num_kv_heads,
                                  scale, bool(causal), bool(double_buffer),
                                  bool(plain))
    RING_PATH["last"] = "streaming"
    if group == 1:
        qh = q.reshape(b, t_local, num_heads, hd) * scale
        kh = k.reshape(b, t_local, num_heads, hd)
        vh = v.reshape(b, t_local, num_heads, ev)
        out = _ring_stream(qh, kh, vh, ring, causal)
        return out.to(v.dtype).reshape(b, t_local, v.shape[2])
    # grouped: only the (B, T_local, H_kv * hd) K/V blocks enter the ring
    qh = q.reshape(b, t_local, num_kv_heads, group, hd) * scale
    kh = k.reshape(b, t_local, num_kv_heads, hd)
    vh = v.reshape(b, t_local, num_kv_heads, ev)
    out = _ring_stream_grouped(qh, kh, vh, ring, causal)
    return out.to(v.dtype).reshape(b, t_local, num_heads * ev)


def _shift_kv(kb, vb, ring, hop):
    group, n, _ = ring
    if n == 1:
        return kb, vb
    return C.ring_shift_grad((kb, vb), group, _tags("kv", hop),
                             _tags("kv_bwd", hop))


def _causal_mask(ring, hop, t_local, device):
    """(T_local, T_local) bool: query idx*T + i sees key src*T + j."""
    _, n, idx = ring
    src = (idx - hop) % n
    iq = idx * t_local + torch.arange(t_local, device=device)
    ik = src * t_local + torch.arange(t_local, device=device)
    return iq[:, None] >= ik[None, :]


def _merge_step(logits, m, l, neg_inf):
    """One block's (new m, correction, p, new l) of the streaming merge,
    fully masked rows guarded: exp(neg_inf - neg_inf) stays 0."""
    blk_m = logits.amax(dim=-1)
    new_m = torch.maximum(m, blk_m)
    safe = torch.where(new_m == neg_inf, torch.zeros_like(new_m), new_m)
    corr = torch.where(m == neg_inf, torch.zeros_like(m),
                       torch.exp(m - safe))
    p = torch.exp(logits - safe[..., None])
    p = torch.where(logits == neg_inf, torch.zeros_like(p), p)
    return new_m, corr, p, l * corr + p.sum(dim=-1)


def _ring_stream(qh, kh, vh, ring, causal):
    """The streaming ring: head-split (B, T_local, H, hd / ev) inputs,
    ``qh`` pre-scaled; the normalized (B, T_local, H, ev) f32 output.
    The hop loop is unrolled (n is the group's size); each hop's K/V
    shift follows its einsums (one schedule: the differentiable shift
    blocks, so posting it earlier would overlap nothing)."""
    _, n, _ = ring
    b, t_local, heads, _ = qh.shape
    ev = vh.shape[3]
    neg_inf = torch.finfo(torch.float32).min
    dev = qh.device
    m = torch.full((b, heads, t_local), neg_inf, device=dev)
    l = torch.zeros((b, heads, t_local), device=dev)
    acc = torch.zeros((b, t_local, heads, ev), device=dev)
    kb, vb = kh, vh
    for r in range(n):
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kb).float()
        if causal:
            mask = _causal_mask(ring, r, t_local, dev)
            logits = torch.where(mask[None, None], logits,
                                 torch.full_like(logits, neg_inf))
        m, corr, p, l = _merge_step(logits, m, l, neg_inf)
        acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhe->bqhe", p, vb.float())
        if r < n - 1:
            kb, vb = _shift_kv(kb, vb, ring, r)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / denom.transpose(1, 2)[..., None]


def _ring_stream_grouped(qh, kh, vh, ring, causal):
    """Grouped-query twin of :func:`_ring_stream`: ``qh`` is (B, T_local,
    H_kv, G, hd) (pre-scaled), K/V stay (B, T_local, H_kv, hd / ev), and
    q-head (h, g) scores kv-head h inside the einsum.  Returns the
    normalized (B, T_local, H_kv, G, ev) f32 output."""
    _, n, _ = ring
    b, t_local, kv_heads, group, _ = qh.shape
    ev = vh.shape[3]
    neg_inf = torch.finfo(torch.float32).min
    dev = qh.device
    m = torch.full((b, kv_heads, group, t_local), neg_inf, device=dev)
    l = torch.zeros((b, kv_heads, group, t_local), device=dev)
    acc = torch.zeros((b, t_local, kv_heads, group, ev), device=dev)
    kb, vb = kh, vh
    for r in range(n):
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qh, kb).float()
        if causal:
            mask = _causal_mask(ring, r, t_local, dev)
            logits = torch.where(mask[None, None, None], logits,
                                 torch.full_like(logits, neg_inf))
        m, corr, p, l = _merge_step(logits, m, l, neg_inf)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
            "bhgqk,bkhe->bqhge", p, vb.float())
        if r < n - 1:
            kb, vb = _shift_kv(kb, vb, ring, r)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / denom.permute(0, 3, 1, 2)[..., None]


# ---------------------------------------------------------------------------
# the flash ring: kernels C, D and E a hop
# ---------------------------------------------------------------------------

def _fold(x, heads):
    """(B, T, H * d) -> (B * H, T, d), contiguous."""
    b, t, e = x.shape
    return x.reshape(b, t, heads, e // heads).transpose(1, 2) \
        .reshape(b * heads, t, e // heads).contiguous()


def _unfold(x, b, heads):
    """(B * H, T, d) -> (B, T, H * d)."""
    _, t, d = x.shape
    return x.reshape(b, heads, t, d).transpose(1, 2).reshape(b, t, heads * d)


def _hop(ring, hop, causal):
    """"full", "diag" (the rank's own block, causal) or "skip" (a later
    rank's block under the causal mask) for hop ``hop``."""
    _, n, idx = ring
    src = (idx - hop) % n
    if not causal or src < idx:
        return "full"
    return "diag" if src == idx else "skip"


class _RingFlashFn(torch.autograd.Function):
    """The flash ring as one autograd function (the reference's
    ``custom_vjp``): forward a ring of kernel C, backward a ring of
    kernels D and E (see the module's docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, ring, heads, kv_heads, scale, causal,
                double_buffer, plain):
        from ..ops import flash_kernel as fl

        b = q.shape[0]
        groups = heads // kv_heads
        fwd = fl.flash_plain_fwd if plain else fl.flash_fwd
        qf = _fold(q, heads)
        k0, v0 = _fold(k, kv_heads), _fold(v, kv_heads)
        bh, tl, hd = qf.shape
        neg_inf = float("-inf")
        # the merge: o_w = sum_b o_b exp(lse_b - m), l_w = sum_b exp(lse_b
        # - m), m the running max of the blocks' lse
        o_w = torch.zeros((bh, tl, hd), dtype=torch.float32, device=q.device)
        l_w = torch.zeros((bh, tl), dtype=torch.float32, device=q.device)
        m = torch.full((bh, tl), neg_inf, dtype=torch.float32,
                       device=q.device)
        kb, vb = k0, v0
        _, n, _ = ring
        for r in range(n):
            last = r == n - 1
            # posted before this hop's kernel (the last hop's rotation is
            # dropped: its buffers would be discarded)
            nxt = _post((kb, vb), ring, _tags("kv", r)) \
                if double_buffer and not last else None
            kind = _hop(ring, r, causal)
            if kind != "skip":
                ob, lseb = fwd(qf, kb, vb, scale, kind == "diag", groups)
                m_new = torch.maximum(m, lseb)
                m_safe = torch.where(m_new == neg_inf,
                                     torch.zeros_like(m_new), m_new)
                c = torch.where(m == neg_inf, torch.zeros_like(m),
                                torch.exp(m - m_safe))
                cb = torch.where(lseb == neg_inf, torch.zeros_like(lseb),
                                 torch.exp(lseb - m_safe))
                o_w = o_w * c[..., None] + ob.float() * cb[..., None]
                l_w = l_w * c + cb
                m = m_new
            if not last:
                kb, vb = (nxt if nxt is not None else _post(
                    (kb, vb), ring, _tags("kv", r))).wait()
        denom = torch.where(l_w == 0.0, torch.ones_like(l_w), l_w)
        o = (o_w / denom[..., None]).to(q.dtype)
        lse = torch.where(l_w == 0.0, torch.full_like(l_w, neg_inf),
                          m + torch.log(denom))
        ctx.save_for_backward(qf, k0, v0, o, lse)
        ctx.args = (ring, b, heads, kv_heads, scale, causal, double_buffer,
                    plain)
        return _unfold(o, b, heads)

    @staticmethod
    def backward(ctx, do):
        from ..ops import flash_kernel as fl

        qf, k0, v0, o, lse = ctx.saved_tensors
        ring, b, heads, kv_heads, scale, causal, double_buffer, plain = \
            ctx.args
        none = (None,) * 7
        if do is None:
            return (None, None, None) + none
        groups = heads // kv_heads
        _, n, _ = ring
        dof = _fold(do.to(qf.dtype), heads)
        delta = fl.flash_delta(o, dof)
        if plain:
            def grads(kb, vb, diag):
                return fl._plain_grads(qf, kb, vb, dof, lse, delta, scale,
                                       diag, groups)
        else:
            def grads(kb, vb, diag):
                dq_b = fl.flash_bwd_dq(qf, kb, vb, dof, lse, delta, scale,
                                       diag, groups)
                dk_b, dv_b = fl.flash_bwd_dkv(qf, kb, vb, dof, lse, delta,
                                              scale, diag, groups)
                return dq_b, dk_b, dv_b

        def hop(r, kb, vb):
            kind = _hop(ring, r, causal)
            return None if kind == "skip" else grads(kb, vb, kind == "diag")

        f32 = dict(dtype=torch.float32, device=qf.device)
        dq = torch.zeros(qf.shape, **f32)
        # the traveling dK / dV accumulators, f32 at the kv width
        dkb = torch.zeros(k0.shape, **f32)
        dvb = torch.zeros(v0.shape, **f32)
        kb, vb = k0, v0
        if double_buffer:
            # hop r-1's contribution folded and rotated at the START of
            # hop r, before its kernels: each contribution still rotates
            # n - r times and arrives home with its block
            pend = None
            for r in range(n):
                last = r == n - 1
                acc = None
                if r > 0:
                    if pend is not None:
                        dkb = dkb + pend[1].float()
                        dvb = dvb + pend[2].float()
                    acc = _post((dkb, dvb), ring, _tags("dkv", r - 1))
                nxt = None if last else _post((kb, vb), ring,
                                              _tags("kv_bwd", r))
                pend = hop(r, kb, vb)
                if pend is not None:
                    dq = dq + pend[0].float()
                if acc is not None:
                    dkb, dvb = acc.wait()
                if nxt is not None:
                    kb, vb = nxt.wait()
            if pend is not None:
                dkb = dkb + pend[1].float()
                dvb = dvb + pend[2].float()
            dkb, dvb = _post((dkb, dvb), ring, _tags("dkv", n - 1)).wait()
        else:
            for r in range(n):
                last = r == n - 1
                got = hop(r, kb, vb)
                if got is not None:
                    dq = dq + got[0].float()
                    dkb = dkb + got[1].float()
                    dvb = dvb + got[2].float()
                # the accumulators travel with their blocks: after n
                # rotations each block's gradient is home
                acc = _post((dkb, dvb), ring, _tags("dkv", r))
                nxt = None if last else _post((kb, vb), ring,
                                              _tags("kv_bwd", r))
                dkb, dvb = acc.wait()
                if nxt is not None:
                    kb, vb = nxt.wait()
        dtype = qf.dtype
        return (_unfold(dq, b, heads).to(dtype),
                _unfold(dkb, b, kv_heads).to(k0.dtype),
                _unfold(dvb, b, kv_heads).to(v0.dtype)) + none
