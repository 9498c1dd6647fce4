"""Kernel B1: the multi-tensor optimizer update over persistent slabs —
the counterpart of ``mxnet_tpu/ops/pallas_update.py``.

Under the slab plan, which the train step arms wherever :func:`plan_for`
accepts the optimizer and the masters, the trainable
masters, their f32 gradients and the optimizer's slots live in
dtype-homogeneous **slabs**: every parameter padded to a whole number of
(block_rows, 128) blocks (16 rows of 2,048 elements unless the tuning
cache says otherwise), the parameters of one dtype concatenated and
viewed as (rows, 128).  One pass per slab does the whole
update chain, in place::

    g = g * rescale;  g = clip > 0 ? clamp(g, -clip, clip) : g
    sgd:      w' = w - lr * (g + wd * w)
    sgd-mom:  m' = momentum * m - lr * (g + wd * w);  w' = w + m'
    adam:     g = g + wd * w;  mean' = b1 * mean + (1 - b1) * g
              var' = b2 * var + (1 - b2) * g * g
              w' = w - lr * mean' / (sqrt(var') + eps)
    store w' in the master dtype, the slots in theirs, and (has_wc) w' in
    the compute dtype, the copy the next forward reads

with f32 arithmetic in exactly that order, every product and sum rounded
on its own.  lr and wd come per block (Adam's bias correction already
folded into lr on the host); ``hyp`` is ``[rescale, clip, momentum]`` or
``[rescale, clip, b1, b2, eps]``.

* :class:`UpdatePlan` / :func:`plan_for` — the layout (``_segments_for``,
  ``UpdatePlan.rows``, ``lr_wd_blocks`` as in the JAX package) and pack /
  unpack.  The block height is the tunable space ``"update_kernel"``
  (``ops/tuning.py``): ``block_rows`` in {16, 32, 64} per class of the
  slab's element count, resolved by :func:`plan_for` before the store is
  built; the cold-cache ``BLOCK_ROWS = 16`` gives the JAX package's
  layout exactly;
* :func:`multi_tensor_update` — the wrapper onto the torch operator
  ``mxnet_tpu_torch::multi_tensor_update`` (:func:`multi_tensor_update_op`,
  which writes w, the slots and wc in place): CUDA slabs launch kernel
  B1 (``csrc/multi_tensor_update.cu``, built at first use) or raise; CPU
  slabs take :func:`update_plain` through the operator's dispatch, and
  ``plain=True`` calls it directly.  :func:`update_plain` repeats the
  kernel's arithmetic as torch ops with the hyperparameters as f32
  tensors (``1 - b1`` rounds in f32, as the kernel computes it).

``LAUNCHES["multi_tensor_update"]`` counts kernel launches;
``UPDATE_PATH["last"]`` names the path the last train step's update took
("kernel", "plain", or "per_param" when no plan is armed).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from .. import cuda_build

__all__ = ["BLOCK_ROWS", "LANES", "BLOCK", "UPDATE_PATH", "LAUNCHES",
           "UpdatePlan", "kind_of", "plan_for", "multi_tensor_update",
           "multi_tensor_update_op", "update_plain"]

BLOCK_ROWS = 16
LANES = 128
BLOCK = BLOCK_ROWS * LANES

UPDATE_PATH = {"last": None}
# kernel launches since the count was last set to 0 (plain-version calls
# do not count)
LAUNCHES = {"multi_tensor_update": 0}

_BUCKET_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MASTER_CODE = {torch.float32: 0, torch.bfloat16: 1}
_WC_CODE = {None: 0, torch.bfloat16: 1, torch.float16: 2}
_KIND_CODE = {"sgd": 0, "adam": 1}


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def kind_of(optimizer):
    """``("sgd", nslots)`` / ``("adam", 2)`` for the optimizers the kernel
    implements, else None.  Exact-type checks: NAG subclasses SGD with
    other math and keeps the per-parameter update."""
    from ..optimizer import SGD, Adam, ccSGD

    if type(optimizer) in (SGD, ccSGD):
        return ("sgd", 1 if optimizer.momentum != 0.0 else 0)
    if type(optimizer) is Adam:
        return ("adam", 2)
    return None


class _Segment:
    __slots__ = ("name", "shape", "size", "row0", "nblocks")

    def __init__(self, name, shape, size, row0, nblocks):
        self.name = name
        self.shape = shape
        self.size = size
        self.row0 = row0
        self.nblocks = nblocks


def _segments_for(params, block_rows=BLOCK_ROWS):
    """``{bucket: [_Segment...]}`` from ``{name: tensor}``: one bucket per
    dtype name, parameters in the dict's order, each padded to whole
    blocks of ``block_rows`` x 128 elements (at least one)."""
    block = block_rows * LANES
    entries = {}
    for name, v in params.items():
        entries.setdefault(_dtype_name(v.dtype), []).append(
            (name, tuple(v.shape)))
    segs = {}
    for bk, items in entries.items():
        row, out = 0, []
        for name, shape in items:
            size = int(np.prod(shape)) if shape else 1
            nblocks = max(1, -(-size // block))
            out.append(_Segment(name, shape, size, row, nblocks))
            row += nblocks * block_rows
        segs[bk] = out
    return segs


class UpdatePlan:
    """Which parameter lives where in which slab, and the update over the
    slabs.  ``cdtype`` is the compute dtype (None for f32 compute);
    ``block_rows`` the block height the segments were laid out with."""

    def __init__(self, kind, nslots, segments_by_bucket, compute_dtype,
                 block_rows=BLOCK_ROWS):
        self.kind = kind
        self.nslots = nslots
        self.buckets = segments_by_bucket
        self.cdtype = compute_dtype
        self.block_rows = block_rows

    # -- layout ---------------------------------------------------------
    def rows(self, bucket):
        last = self.buckets[bucket][-1]
        return last.row0 + last.nblocks * self.block_rows

    def dtype(self, bucket):
        return _BUCKET_DTYPES[bucket]

    def has_wc(self, bucket):
        """Whether the bucket keeps a compute-dtype slab beside its
        masters (the kernel's recast output)."""
        return self.cdtype is not None and self.dtype(bucket) != self.cdtype

    # -- pack / unpack --------------------------------------------------
    def _pack_bucket(self, bk, tree, dtype, device):
        slab = torch.zeros((self.rows(bk), LANES), dtype=dtype,
                           device=device)
        flat = slab.view(-1)
        with torch.no_grad():
            for seg in self.buckets[bk]:
                start = seg.row0 * LANES
                flat[start:start + seg.size].copy_(tree[seg.name].reshape(-1))
        return slab

    def pack(self, tree, device, dtype=None):
        """``{name: tensor}`` -> ``{bucket: (rows, 128) slab}`` on
        ``device``, padding zero, in ``dtype`` or else the bucket's.  The
        grad slabs are f32 whatever the masters' dtype: the per-parameter
        path casts each gradient up to the f32 master before its update,
        so a bf16 grad slab would round once more."""
        return {bk: self._pack_bucket(bk, tree, dtype or self.dtype(bk),
                                      device) for bk in self.buckets}

    def pack_slots(self, slots, device):
        """``{name: tuple}`` -> ``{bucket: tuple of slabs}`` (slots keep
        the master dtype)."""
        return {bk: tuple(
            self._pack_bucket(bk, {s.name: slots[s.name][i]
                                   for s in self.buckets[bk]},
                              self.dtype(bk), device)
            for i in range(self.nslots)) for bk in self.buckets}

    def cast_slabs(self, w_slabs):
        """The compute-dtype slabs of the has_wc buckets."""
        return {bk: w_slabs[bk].to(self.cdtype)
                for bk in self.buckets if self.has_wc(bk)}

    def unpack(self, bucket, slab):
        """``{name: view}`` into one slab (views share its storage)."""
        flat = slab.view(-1)
        out = {}
        for seg in self.buckets[bucket]:
            start = seg.row0 * LANES
            out[seg.name] = flat[start:start + seg.size].view(seg.shape)
        return out

    def unpack_all(self, slabs):
        out = {}
        for bk in self.buckets:
            out.update(self.unpack(bk, slabs[bk]))
        return out

    def unpack_slots(self, slot_slabs):
        """``{bucket: tuple of slabs}`` -> ``{name: tuple of views}``."""
        out = {}
        for bk in self.buckets:
            per_slot = [self.unpack(bk, s) for s in slot_slabs[bk]]
            for seg in self.buckets[bk]:
                out[seg.name] = tuple(p[seg.name] for p in per_slot)
        return out

    # -- per-block hyperparameters --------------------------------------
    def lr_wd_blocks(self, lrs, wds):
        """Per-name lr / wd -> per-bucket per-block f32 numpy arrays."""
        lrb, wdb = {}, {}
        for bk, segs in self.buckets.items():
            lr = np.empty(self.rows(bk) // self.block_rows, np.float32)
            wd = np.empty_like(lr)
            for seg in segs:
                b0 = seg.row0 // self.block_rows
                lr[b0:b0 + seg.nblocks] = lrs[seg.name]
                wd[b0:b0 + seg.nblocks] = wds[seg.name]
            lrb[bk], wdb[bk] = lr, wd
        return lrb, wdb

    # -- the update -----------------------------------------------------
    def apply(self, w_slabs, g_slabs, slot_slabs, wc_slabs, lrb, wdb, hyp,
              plain=False):
        """One pass per bucket, in place; returns the path taken
        ("kernel" or "plain")."""
        path = None
        for bk in self.buckets:
            path = multi_tensor_update(
                self.kind, self.nslots, w_slabs[bk], g_slabs[bk],
                slot_slabs[bk], wc_slabs.get(bk), lrb[bk], wdb[bk], hyp,
                plain=plain, block_rows=self.block_rows)
        return path


def plan_for(optimizer, params, grad_names, compute_dtype):
    """An :class:`UpdatePlan` over ``grad_names`` (``params`` maps names to
    tensors), or None where the JAX package keeps the per-parameter path:
    an optimizer the kernel does not implement, or a trainable that is not
    float32 / bfloat16.  The block height is the tuning cache's for the
    trainables' element count on their device (``BLOCK_ROWS`` on the CPU
    or with a cold cache)."""
    kind = kind_of(optimizer)
    if kind is None or not grad_names:
        return None
    if any(params[n].dtype not in _MASTER_CODE for n in grad_names):
        return None
    total = sum(params[n].numel() or 1 for n in grad_names)
    br = _tuned_block_rows(total, params[grad_names[0]].device)
    segs = _segments_for({n: params[n] for n in grad_names}, block_rows=br)
    cdtype = None if compute_dtype in (None, torch.float32) \
        else compute_dtype
    return UpdatePlan(kind[0], kind[1], segs, cdtype, block_rows=br)


def update_plain(kind, nslots, w, g, slots, wc, lrb, wdb, hyp,
                 block_rows=BLOCK_ROWS):
    """Plain PyTorch version of kernel B1, in place on the slabs: the
    same f32 chain as torch ops, the hyperparameters as f32 tensors
    (filled on the device, so a captured step can hold it); lr / wd
    hold one value a block of ``block_rows`` x 128 elements."""
    f32 = torch.float32
    dev = w.device
    block = block_rows * LANES
    h = [torch.full((), float(v), dtype=f32, device=dev) for v in hyp]
    lr = lrb.to(dev, f32).repeat_interleave(block).view(w.shape)
    wd = wdb.to(dev, f32).repeat_interleave(block).view(w.shape)
    rescale, clip = h[0], h[1]
    with torch.no_grad():
        w32 = w.to(f32)
        gs = g.to(f32) * rescale
        gs = torch.where(clip > 0, torch.clamp(gs, -clip, clip), gs)
        if kind == "sgd":
            if nslots:
                m = h[2] * slots[0].to(f32) - lr * (gs + wd * w32)
                new_w, new_slots = w32 + m, (m,)
            else:
                new_w, new_slots = w32 - lr * (gs + wd * w32), ()
        else:
            b1, b2, eps = h[2], h[3], h[4]
            one = torch.ones((), dtype=f32, device=dev)
            gs = gs + wd * w32
            mean = b1 * slots[0].to(f32) + (one - b1) * gs
            var = b2 * slots[1].to(f32) + (one - b2) * (gs * gs)
            new_w = w32 - lr * mean / (torch.sqrt(var) + eps)
            new_slots = (mean, var)
        w.copy_(new_w)
        for s, v in zip(slots, new_slots):
            s.copy_(v)
        if wc is not None:
            wc.copy_(new_w)


def _check(t, name, shape, dtypes, device, fake=False):
    if t.device != device:
        raise ValueError("multi_tensor_update: %s on %s, w on %s"
                         % (name, t.device, device))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("multi_tensor_update: %s shape %s != %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if t.dtype not in dtypes:
        raise ValueError("multi_tensor_update: %s dtype %s not in %s"
                         % (name, t.dtype, [str(d) for d in dtypes]))
    if not t.is_contiguous() or (not fake and t.data_ptr() % 16):
        raise ValueError("multi_tensor_update: %s must be contiguous and "
                         "16-byte aligned" % name)


def _b1_check(kind, nslots, w, g, slots, wc, lrb, wdb, block_rows,
              fake=False):
    """Kernel B1's contract for slabs off the host (CUDA tensors, or fake
    ones while a graph is traced): the number of blocks, or a ValueError
    naming what the kernel does not take.  ``fake``: the pointers are
    not read."""
    if w.device.type != "cuda" and not (fake and is_fake(w)):
        raise ValueError("multi_tensor_update: unsupported device %s"
                         % w.device)
    valid = (kind == "sgd" and nslots in (0, 1)) or \
        (kind == "adam" and nslots == 2)
    if not valid or len(slots) != nslots:
        raise ValueError("multi_tensor_update: kind %r with %d slots is "
                         "not an update the kernel implements"
                         % (kind, nslots))
    dev = w.device
    if block_rows <= 0 or block_rows % BLOCK_ROWS:
        raise ValueError("multi_tensor_update: block_rows %r is not a "
                         "multiple of %d" % (block_rows, BLOCK_ROWS))
    if w.dim() != 2 or w.shape[1] != LANES or w.shape[0] % block_rows:
        raise ValueError("multi_tensor_update: w must be a (%d k, 128) "
                         "slab, got %s" % (block_rows, tuple(w.shape)))
    _check(w, "w", w.shape, tuple(_MASTER_CODE), dev, fake)
    _check(g, "g", w.shape, (torch.float32,), dev, fake)
    for i, s in enumerate(slots):
        _check(s, "slot %d" % i, w.shape, (w.dtype,), dev, fake)
    if wc is not None:
        _check(wc, "wc", w.shape, (torch.bfloat16, torch.float16), dev,
               fake)
    nblocks = w.shape[0] // block_rows
    _check(lrb, "lr", (nblocks,), (torch.float32,), dev, fake)
    _check(wdb, "wd", (nblocks,), (torch.float32,), dev, fake)
    return nblocks


@torch.library.custom_op("mxnet_tpu_torch::multi_tensor_update",
                         mutates_args=("w", "slots", "wc"),
                         device_types="cuda")
def multi_tensor_update_op(kind: str, nslots: int, w: torch.Tensor,
                           g: torch.Tensor, slots: List[torch.Tensor],
                           wc: Optional[torch.Tensor], lrb: torch.Tensor,
                           wdb: torch.Tensor, hyp: List[float],
                           block_rows: int) -> None:
    """Kernel B1 as a torch operator, writing w, the slots and wc in
    place: its CUDA implementation launches
    ``csrc/multi_tensor_update.cu``; its CPU implementation is
    :func:`update_plain`; its fake implementation checks the slabs and
    writes nothing, so a traced training graph holds this one node with
    its in-place writes in its schema."""
    nblocks = _b1_check(kind, nslots, w, g, slots, wc, lrb, wdb,
                        block_rows)
    h = [float(v) for v in hyp] + [0.0] * (5 - len(hyp))
    s0 = slots[0].data_ptr() if nslots > 0 else None
    s1 = slots[1].data_ptr() if nslots > 1 else None
    dev = w.device
    lib = cuda_build.lib("multi_tensor_update")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.multi_tensor_update(
            _KIND_CODE[kind], nslots, _MASTER_CODE[w.dtype],
            _WC_CODE[None if wc is None else wc.dtype], w.data_ptr(),
            g.data_ptr(), s0, s1, None if wc is None else wc.data_ptr(),
            lrb.data_ptr(), wdb.data_ptr(), nblocks, block_rows * LANES, *h,
            stream)
    cuda_build.check(lib, rc, "multi_tensor_update")
    LAUNCHES["multi_tensor_update"] += 1


@multi_tensor_update_op.register_kernel("cpu")
def _multi_tensor_update_cpu(kind, nslots, w, g, slots, wc, lrb, wdb, hyp,
                             block_rows):
    update_plain(kind, nslots, w, g, tuple(slots), wc, lrb, wdb, hyp,
                 block_rows)


@multi_tensor_update_op.register_fake
def _multi_tensor_update_fake(kind, nslots, w, g, slots, wc, lrb, wdb, hyp,
                              block_rows):
    if w.device.type != "cpu":
        _b1_check(kind, nslots, w, g, slots, wc, lrb, wdb, block_rows,
                  fake=True)


def multi_tensor_update(kind, nslots, w, g, slots, wc, lrb, wdb, hyp,
                        plain=False, block_rows=BLOCK_ROWS):
    """The update over one bucket's slabs, in place: w (rows, 128) f32 or
    bf16, g (rows, 128) f32, ``slots`` a tuple of ``nslots`` slabs in w's
    dtype, ``wc`` a bf16 / f16 slab or None, ``lrb`` / ``wdb`` (rows /
    block_rows,) f32, ``hyp`` floats; ``block_rows`` the plan's block
    height (a multiple of 16).  The call is the operator
    ``mxnet_tpu_torch::multi_tensor_update``: CPU slabs take
    :func:`update_plain`, CUDA slabs launch kernel B1, any other device
    raises; ``plain`` calls :func:`update_plain` directly.  Returns
    "kernel" or "plain"."""
    if plain:
        update_plain(kind, nslots, w, g, tuple(slots), wc, lrb, wdb, hyp,
                     block_rows)
        return "plain"
    multi_tensor_update_op(kind, int(nslots), w, g, list(slots), wc, lrb,
                           wdb, [float(v) for v in hyp], int(block_rows))
    return "plain" if w.device.type == "cpu" else "kernel"


# ---------------------------------------------------------------------------
# tunable space (ops/tuning.py): the block height per element-count class
# ---------------------------------------------------------------------------

BLOCK_ROWS_CANDIDATES = (16, 32, 64)
# the probe's update: the ResNet-50 path's SGD-momentum over f32 masters
# with the bf16 compute copy, no clip; held bit for bit against
# update_plain (chip_smoke.py's B1 gate for SGD)
_PROBE_HYP = (1.0, -1.0, 0.9)


def _tuned_block_rows(total, device):
    """The tuning cache's block height for a trainable population of
    ``total`` elements on ``device`` (:data:`BLOCK_ROWS` on the CPU, or
    when the cache is cold and no sweep is armed), rounded down to a
    multiple of 16."""
    from . import tuning

    br = int(tuning.resolve("update_kernel",
                            tuning.shape_class_for(n=max(int(total), 1)),
                            "any", device=device)["block_rows"])
    return max(BLOCK_ROWS, (br // BLOCK_ROWS) * BLOCK_ROWS)


def _tuning_candidates(shape_class, interpret):
    return [{"block_rows": br} for br in BLOCK_ROWS_CANDIDATES]


def _tuning_runner(params, shape_class, dtype, interpret):
    """One SGD-momentum update (f32 masters, bf16 copy) over a slab of the
    class's ``n`` elements at ``block_rows``; the check holds the first
    launch bit for bit against :func:`update_plain` from the same
    start."""
    from . import tuning

    n = tuning.parse_shape_class(shape_class)["n"]
    br = int(params["block_rows"])
    if br <= 0 or br % BLOCK_ROWS:
        raise tuning.SpaceError("block_rows %r not a multiple of %d"
                                % (br, BLOCK_ROWS))
    nb = max(1, -(-n // (br * LANES)))
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    shape = (nb * br, LANES)
    w0 = torch.randn(shape, generator=gen, device=dev)
    m0 = torch.randn(shape, generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev)
    lrb = torch.full((nb,), 0.1, device=dev)
    wdb = torch.full((nb,), 1e-4, device=dev)
    w, m = w0.clone(), m0.clone()
    wc = torch.empty(shape, dtype=torch.bfloat16, device=dev)

    def run():
        multi_tensor_update("sgd", 1, w, g, (m,), wc, lrb, wdb, _PROBE_HYP,
                            block_rows=br)

    def check():
        want = [w0.clone(), m0.clone(), torch.empty_like(wc)]
        update_plain("sgd", 1, want[0], g, (want[1],), want[2], lrb, wdb,
                     _PROBE_HYP, block_rows=br)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip((w, m, wc), want))
        return err, 0.0 if err == 0.0 else float("inf")

    return tuning.Probe(run, check)


def _register_space():
    from . import tuning

    tuning.register_space(
        "update_kernel", version=1, defaults={"block_rows": BLOCK_ROWS},
        constants=("BLOCK_ROWS", "BLOCK"), candidates=_tuning_candidates,
        runner=_tuning_runner, sources=("multi_tensor_update",))


_register_space()
