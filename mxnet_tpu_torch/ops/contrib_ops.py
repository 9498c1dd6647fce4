"""Contrib ops (names, schemas, hints and aliases as in
``mxnet_tpu/ops/contrib_ops.py``): ``CTCLoss``, the SSD ops
``MultiBoxPrior`` / ``MultiBoxTarget`` / ``MultiBoxDetection``,
Faster-RCNN's ``Proposal``, ``fft`` / ``ifft``, ``quantize`` /
``dequantize`` and ``count_sketch``.

Ordinary torch ops throughout (the JAX package's are ``jnp`` code, no
Pallas), batched over the images where the JAX package ``vmap``s, and
capturable in a CUDA graph: no value is read back to the host, no mask
indexes a tensor, and the greedy non-max suppression is a loop of one
fixed step a sorted row (:func:`_greedy_nms`).  Constant anchors are
built once on the host, as the JAX package does, and kept on the device
per shape (:func:`_cached`), so a captured replay copies them there.

What decides the outputs is kept as the JAX package computes it:

* sort order is output: every ranking is a stable ascending
  ``argsort`` of the negated key, as ``jnp.argsort`` is, so ties keep
  index order;
* ``MultiBoxPrior``'s half sizes are computed in float64 and cast to
  float32;
* ``CTCLoss`` is the JAX package's log-space alpha recursion with the
  same ``_NEG`` (-1e30) for minus infinity, autograd through it (not
  ``F.ctc_loss``, which gives ``inf`` for an infeasible alignment);
* ``count_sketch``'s scatter-add is ``index_add``: atomics on the
  card, so it is reproducible there only up to float addition order;
* gradients are autograd's through the same arithmetic, as the JAX
  package's are ``jax.vjp``'s: they reach the inputs through the box
  encoding and decoding and the gathered scores, and nothing through
  the sorts, thresholds, matches and the suppression.
"""
from __future__ import annotations

import numpy as np
import torch

from ..attrs import Param, ParamSchema
from ..base import MXNetError
from ..registry import OpDef, register_op, simple_compute

_NEG = -1e30  # log-space "minus infinity" that survives f32 arithmetic
_IOU_ROWS = 1024  # rows of an IoU matrix built at once (the NMS's memory)

_CONSTS = {}


def _cached(key, device, build):
    """The tensor ``build()`` makes on the host, on ``device``, built once
    per key and device; the caller gets a copy (a device-to-device copy
    a CUDA graph records).  The first call of a shape must not come in a
    capture: the captured programs run their body once before they
    capture it."""
    full = (key, str(device))
    hit = _CONSTS.get(full)
    if hit is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise MXNetError("constant %r first built inside a CUDA-graph "
                             "capture; run the program once first" % (key,))
        hit = build().to(device)
        _CONSTS[full] = hit
    return hit.clone()


# ---------------------------------------------------------------------------
# CTC loss
# ---------------------------------------------------------------------------

def _ctc_loss(attrs, data, label):
    """CTC negative log-likelihood: data (T, N, A) activations (blank at
    0), label (N, L) ids 0-padded; output (N,).  The alpha recursion over
    the blank-interleaved label in log space, one step a time step."""
    t_len, n, _ = data.shape
    l_len = label.shape[1]
    dev = data.device
    logp = torch.log_softmax(data.float(), dim=-1)

    lab = label.to(torch.int64)                          # (N, L)
    lengths = (lab > 0).sum(dim=1)
    s = 2 * l_len + 1
    ext = torch.zeros((n, s), dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    prev_lab = torch.nn.functional.pad(ext, (2, 0))[:, :s]
    can_skip = (ext != 0) & (ext != prev_lab)
    positions = torch.arange(s, device=dev)
    valid = positions[None, :] < (2 * lengths + 1)[:, None]

    base = torch.where(positions < 2, 0.0, _NEG).to(torch.float32)
    emit0 = torch.gather(logp[0], 1, ext)
    init = torch.where(valid, base[None, :] + emit0, _NEG)
    alpha = torch.where(positions[None, :] >= 2, _NEG, init)

    for t in range(1, t_len):
        from_prev = torch.nn.functional.pad(alpha, (1, 0),
                                            value=_NEG)[:, :s]
        from_skip = torch.nn.functional.pad(alpha, (2, 0),
                                            value=_NEG)[:, :s]
        from_skip = torch.where(can_skip, from_skip, _NEG)
        merged = torch.logaddexp(torch.logaddexp(alpha, from_prev),
                                 from_skip)
        emit = torch.gather(logp[t], 1, ext)
        alpha = torch.where(valid, merged + emit, _NEG)

    last = 2 * lengths
    a_end = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_end2 = torch.gather(alpha, 1,
                          torch.clamp_min(last - 1, 0)[:, None])[:, 0]
    loglike = torch.logaddexp(a_end, torch.where(lengths > 0, a_end2, _NEG))
    return (-loglike).to(data.dtype)


def _ctc_shape(attrs, in_shapes, aux_shapes):
    return in_shapes, [(in_shapes[0][1],)], []


# ---------------------------------------------------------------------------
# box helpers (over a trailing box axis of 4, any leading axes)
# ---------------------------------------------------------------------------

def _iou_matrix(a, b):
    """Pairwise IoU of corner-format boxes: a (..., A, 4) x b (..., B, 4)
    -> (..., A, B), each product and sum as the JAX package's."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = torch.clamp_min(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                         0.0)
    ih = torch.clamp_min(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                         0.0)
    inter = iw * ih
    area_a = torch.clamp_min((a[..., 2] - a[..., 0])
                             * (a[..., 3] - a[..., 1]), 0.0)
    area_b = torch.clamp_min((b[..., 2] - b[..., 0])
                             * (b[..., 3] - b[..., 1]), 0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _corner_to_center(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.stack([boxes[..., 0] + w / 2, boxes[..., 1] + h / 2, w, h],
                       dim=-1)


def _order_desc(scores):
    """Indices sorting the last axis descending, ties in index order (the
    stable ascending sort of the negated scores, as ``jnp.argsort``)."""
    return torch.argsort(-scores, dim=-1, stable=True)


def _rank_desc(scores):
    """Each element's 0-based rank when sorting the last axis descending
    (rank < k selects the top k): the inverse of :func:`_order_desc`."""
    order = _order_desc(scores)
    ranks = torch.arange(scores.shape[-1], device=scores.device)
    return torch.empty_like(order).scatter_(
        -1, order, ranks.expand(order.shape).contiguous())


def _take(x, idx):
    """``x[i, idx[i]]`` along axis 1 for every image i, for x (N, A) or
    (N, A, F) and idx (N, K)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _exp(x):
    """exp in float64, rounded to x's dtype: the same bits on the card
    and the host (their float32 exp differ in the last place), so the
    suppression's IoU thresholds decide alike on both."""
    return torch.exp(x.double()).to(x.dtype)


def _decode_boxes(anc_c, loc, variances):
    """Inverse of the target encoding -> corner boxes (..., A, 4)."""
    cx = loc[..., 0] * variances[0] * anc_c[..., 2] + anc_c[..., 0]
    cy = loc[..., 1] * variances[1] * anc_c[..., 3] + anc_c[..., 1]
    w = _exp(torch.clamp(loc[..., 2] * variances[2], -10, 10)) \
        * anc_c[..., 2]
    h = _exp(torch.clamp(loc[..., 3] * variances[3], -10, 10)) \
        * anc_c[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _greedy_nms(boxes, scores, thresh, class_ids=None):
    """Greedy non-max suppression over each image's rows, capturable.

    boxes (N, A, 4), scores (N, A).  Rows are sorted by score; row i is
    kept iff no higher-scoring kept row overlaps it above ``thresh``
    (with ``class_ids``: of its own class, the reference's
    force_suppress=False).  Returns ``(order, keep)``, keep in sorted
    order.  One loop step a row (A device steps, every image at once):
    the JAX package's ``lax.scan``.  The IoU is built _IOU_ROWS rows of
    one image at a time, so only the (N, A, A) overlap mask is whole.
    """
    order = _order_desc(scores)
    sorted_boxes = _take(boxes.detach(), order)
    a = scores.shape[1]
    with torch.no_grad():
        over = torch.stack([
            torch.cat([_iou_matrix(b[r:r + _IOU_ROWS], b) > thresh
                       for r in range(0, a, _IOU_ROWS)])
            for b in sorted_boxes])
        if class_ids is not None:
            cls = _take(class_ids, order)
            over &= cls[:, :, None] == cls[:, None, :]
        keep = torch.ones(scores.shape, dtype=torch.bool,
                          device=scores.device)
        for i in range(1, a):
            torch.logical_not((keep[:, :i] & over[:, i, :i]).any(dim=1),
                              out=keep[:, i])
    return order, keep


# ---------------------------------------------------------------------------
# MultiBox* (SSD)
# ---------------------------------------------------------------------------

def _prior_half(attrs):
    """(K, 2) half widths / heights, in float64 then float32 (the JAX
    package's numpy arithmetic)."""
    sizes, ratios = attrs["sizes"], attrs["ratios"]
    half = [(s * np.sqrt(ratios[0]) / 2, s / np.sqrt(ratios[0]) / 2)
            for s in sizes]
    half += [(sizes[0] * np.sqrt(r) / 2, sizes[0] / np.sqrt(r) / 2)
             for r in ratios[1:]]
    return torch.from_numpy(np.asarray(half, np.float64).astype(np.float32))


def _prior_boxes(attrs, h, w):
    """MultiBoxPrior's (1, h*w*K, 4) anchors, on the host in float32."""
    steps, offsets = attrs["steps"], attrs["offsets"]
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32) + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=torch.float32) + offsets[1]) * step_x
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    half = _prior_half(attrs)
    centers = torch.stack([gx, gy], dim=-1).reshape(-1, 1, 2)
    boxes = torch.cat([centers - half[None], centers + half[None]], dim=-1)
    if attrs["clip"]:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes.reshape(1, -1, 4)


def _multibox_prior(attrs, data):
    """Anchor boxes per feature-map cell (ref: multibox_prior.cc): all
    sizes at ratios[0], then ratios[1:] at sizes[0]."""
    h, w = data.shape[2], data.shape[3]
    return _cached(("MultiBoxPrior", attrs, h, w), data.device,
                   lambda: _prior_boxes(attrs, h, w))


def _prior_count(attrs):
    return len(attrs["sizes"]) + len(attrs["ratios"]) - 1


def _multibox_prior_shape(attrs, in_shapes, aux_shapes):
    h, w = in_shapes[0][2], in_shapes[0][3]
    return in_shapes, [(1, h * w * _prior_count(attrs), 4)], []


def _multibox_target(attrs, anchors, labels, cls_preds):
    """Match anchors to ground truth (ref: multibox_target.cc).

    anchors (1, A, 4); labels (N, O, 5) rows [cls, x1, y1, x2, y2] with
    cls -1 padding; cls_preds (N, classes, A).  Outputs loc_target
    (N, A*4), loc_mask (N, A*4), cls_target (N, A): 0 is background, the
    ground truth's classes shift by +1, and with hard-negative mining the
    unmined negatives take ``ignore_label``.
    """
    iou_thresh = attrs["overlap_threshold"]
    variances = attrs["variances"]
    mining_ratio = attrs.get("negative_mining_ratio", -1.0)
    mining_thresh = attrs.get("negative_mining_thresh", 0.5)
    ignore_label = attrs.get("ignore_label", -1.0)
    anc = anchors[0]                                     # (A, 4)
    n, _, width = labels.shape
    a = anc.shape[0]
    valid = labels[:, :, 0] >= 0                         # (N, O)
    with torch.no_grad():
        iou = torch.stack([_iou_matrix(anc, lab[:, 1:5])
                           for lab in labels.detach()])  # (N, A, O)
        iou = torch.where(valid[:, None, :], iou, -1.0)
        best_o = torch.argmax(iou, dim=2)                # (N, A)
        best_iou = torch.gather(iou, 2, best_o[..., None])[..., 0]
        # force-match: each real gt claims its best anchor.  Padding rows
        # all argmax to anchor 0; a count (not a set) keeps them from
        # overwriting a real gt's claim
        best_a = torch.argmax(iou, dim=1)                # (N, O)
        claims = torch.zeros((n, a), dtype=torch.int32, device=anc.device)
        claims.scatter_add_(1, best_a, valid.to(torch.int32))
        matched = (claims > 0) | (best_iou >= iou_thresh)
    gt = torch.gather(labels, 1, best_o[..., None].expand(n, a, width))
    if mining_ratio > 0:
        # hard-negative mining (ref multibox_target.cc:162-221): the
        # unmatched anchors below negative_mining_thresh with the lowest
        # background probability, num_positive * ratio of them, become
        # background; every other unmatched anchor is ignored
        with torch.no_grad():
            num_pos = matched.sum(dim=1)
            num_neg = torch.minimum((num_pos * mining_ratio)
                                    .to(torch.int32), a - num_pos)
            bg_prob = torch.softmax(cls_preds.detach().float(), dim=1)[:, 0]
            cand = ~matched & (best_iou < mining_thresh)
            hardness = torch.where(cand, -bg_prob, -torch.inf)
            neg = cand & (_rank_desc(hardness) < num_neg[:, None])
        cls_t = torch.where(matched, gt[..., 0] + 1.0,
                            torch.where(neg, 0.0, ignore_label))
    else:
        cls_t = torch.where(matched, gt[..., 0] + 1.0, 0.0)

    a_c = _corner_to_center(anc)[None]
    g_c = _corner_to_center(gt[..., 1:5])
    aw = torch.clamp_min(a_c[..., 2], 1e-8)
    ah = torch.clamp_min(a_c[..., 3], 1e-8)
    loc = torch.stack([
        (g_c[..., 0] - a_c[..., 0]) / aw / variances[0],
        (g_c[..., 1] - a_c[..., 1]) / ah / variances[1],
        torch.log(torch.clamp_min(g_c[..., 2], 1e-8) / aw) / variances[2],
        torch.log(torch.clamp_min(g_c[..., 3], 1e-8) / ah) / variances[3],
    ], dim=-1)                                           # (N, A, 4)
    mask = matched[..., None].to(torch.float32)
    return (loc * mask).reshape(n, -1), \
        mask.expand(loc.shape).reshape(n, -1), cls_t


def _multibox_target_shape(attrs, in_shapes, aux_shapes):
    a = in_shapes[0][1]
    n = in_shapes[1][0]
    return in_shapes, [(n, a * 4), (n, a * 4), (n, a)], []


def _multibox_detection(attrs, cls_prob, loc_pred, anchors):
    """Decode + per-class NMS (ref: multibox_detection.cc).

    cls_prob (N, classes+1, A) with background at 0; output (N, A, 6)
    rows [cls_id, score, x1, y1, x2, y2] in score order, suppressed rows
    with cls_id -1.  With 0 < ``nms_topk`` < A only the top k rows by
    score enter the suppression (k steps over a k x k IoU); the rest
    follow in score order, suppressed."""
    thresh = attrs["threshold"]
    nms_thresh = attrs["nms_threshold"]
    variances = attrs["variances"]
    force_suppress = attrs["force_suppress"]
    nms_topk = attrs.get("nms_topk", -1)
    n, _, a = cls_prob.shape
    anc_c = _corner_to_center(anchors[0])
    boxes = _decode_boxes(anc_c[None], loc_pred.reshape(n, -1, 4),
                          variances)                     # (N, A, 4)
    fg = cls_prob[:, 1:]                                 # (N, classes, A)
    cls_id = torch.argmax(fg, dim=1)                     # (N, A)
    score = torch.amax(fg, dim=1)
    keep_score = score > thresh
    if 0 < nms_topk < a:
        order_full = _order_desc(torch.where(keep_score, score, -torch.inf))
        top = order_full[:, :nms_topk]
        top_keep = _take(keep_score, top)
        torder, tkeep = _greedy_nms(
            _take(boxes, top),
            torch.where(top_keep, _take(score, top), 0.0), nms_thresh,
            class_ids=None if force_suppress else _take(cls_id, top))
        sorted_ids = torch.cat([_take(top, torder),
                                order_full[:, nms_topk:]], dim=1)
        kept = torch.cat([tkeep & _take(top_keep, torder),
                          torch.zeros((n, a - nms_topk), dtype=torch.bool,
                                      device=score.device)], dim=1)
    else:
        sorted_ids, keep_nms = _greedy_nms(
            boxes, torch.where(keep_score, score, 0.0), nms_thresh,
            class_ids=None if force_suppress else cls_id)
        kept = keep_nms & _take(keep_score, sorted_ids)
    cls_col = torch.where(kept, _take(cls_id, sorted_ids)
                          .to(torch.float32), -1.0)
    return torch.cat([cls_col[..., None], _take(score, sorted_ids)[..., None],
                      _take(boxes, sorted_ids)], dim=2)


def _multibox_detection_shape(attrs, in_shapes, aux_shapes):
    n, _, a = in_shapes[0]
    return in_shapes, [(n, a, 6)], []


# ---------------------------------------------------------------------------
# Proposal (Faster-RCNN)
# ---------------------------------------------------------------------------

def _proposal_anchors(attrs, h, w):
    """The (h*w*K, 4) RPN anchors, on the host in float32."""
    stride = attrs["feature_stride"]
    base = []
    for r in attrs["ratios"]:
        for s in attrs["scales"]:
            ww = stride * s * np.sqrt(1.0 / r)
            hh = stride * s * np.sqrt(r)
            base.append([-ww / 2, -hh / 2, ww / 2, hh / 2])
    base = torch.from_numpy(np.asarray(base, np.float64).astype(np.float32))
    sy = torch.arange(h, dtype=torch.float32) * stride
    sx = torch.arange(w, dtype=torch.float32) * stride
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([gx, gy, gx, gy], dim=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def _proposal(attrs, cls_prob, bbox_pred, im_info):
    """RPN proposals: anchors + deltas, clip, min-size filter, pre-NMS
    top-n, NMS, post-NMS top-n (ref: src/operator/contrib/proposal.cc).
    Output (rpn_post_nms_top_n, 5) with batch index 0; a short output
    cycles the kept boxes (the reference's ``keep[i % out_size]``)."""
    pre_top = attrs["rpn_pre_nms_top_n"]
    post_top = attrs["rpn_post_nms_top_n"]
    _, _, h, w = cls_prob.shape
    k = len(attrs["scales"]) * len(attrs["ratios"])
    dev = cls_prob.device
    anchors = _cached(("Proposal", attrs, h, w), dev,
                      lambda: _proposal_anchors(attrs, h, w))
    deltas = bbox_pred[0].reshape(k, 4, h, w).permute(2, 3, 0, 1) \
        .reshape(-1, 4)
    scores = cls_prob[0, k:].permute(1, 2, 0).reshape(-1)
    boxes = _decode_boxes(_corner_to_center(anchors), deltas,
                          (1.0, 1.0, 1.0, 1.0))
    im_h, im_w = im_info[0, 0], im_info[0, 1]
    boxes = torch.stack([
        torch.minimum(torch.clamp_min(boxes[:, 0], 0), im_w - 1),
        torch.minimum(torch.clamp_min(boxes[:, 1], 0), im_h - 1),
        torch.minimum(torch.clamp_min(boxes[:, 2], 0), im_w - 1),
        torch.minimum(torch.clamp_min(boxes[:, 3], 0), im_h - 1),
    ], dim=-1)
    # the min-size filter scales with the image (proposal.cc:
    # rpn_min_size * im_info[2])
    scaled_min = attrs["rpn_min_size"] * im_info[0, 2]
    big = ((boxes[:, 2] - boxes[:, 0] + 1) >= scaled_min) & \
          ((boxes[:, 3] - boxes[:, 1] + 1) >= scaled_min)
    scores = torch.where(big, scores, 0.0)
    if pre_top > 0:
        pre_rank = _rank_desc(torch.where(scores > 0, scores, -torch.inf))
        scores = torch.where(pre_rank < pre_top, scores, 0.0)
    order, keep = _greedy_nms(boxes[None], scores[None], attrs["threshold"])
    order, keep = order[0], keep[0]
    valid = keep & (scores[order] > 0)
    rank = torch.argsort((~valid).to(torch.uint8), stable=True)
    nkept = torch.clamp_min(valid.sum(), 1)
    pos = torch.arange(post_top, device=dev) % nkept
    top = order[rank][pos]
    return torch.cat([torch.zeros((post_top, 1), dtype=boxes.dtype,
                                  device=dev), boxes[top]], dim=1)


def _proposal_shape(attrs, in_shapes, aux_shapes):
    return in_shapes, [(attrs.get("rpn_post_nms_top_n", 300), 5)], []


# ---------------------------------------------------------------------------
# fft / ifft / quantization / count sketch
# ---------------------------------------------------------------------------

def _fft(attrs, data):
    """Real -> interleaved re/im complex (contrib/fft.cc's packing):
    (..., d) -> (..., 2d), out[..., 2i] = Re, out[..., 2i+1] = Im."""
    x = data.to(torch.float32)
    spec = torch.fft.fft(torch.complex(x, torch.zeros_like(x)), dim=-1)
    out = torch.stack([spec.real, spec.imag], dim=-1)
    return out.reshape(*data.shape[:-1], -1)


def _ifft(attrs, data):
    """Interleaved re/im -> real inverse FFT, (..., 2d) -> (..., d),
    unnormalized as contrib/ifft.cc is."""
    pairs = data.to(torch.float32).reshape(*data.shape[:-1], -1, 2)
    spec = torch.complex(pairs[..., 0], pairs[..., 1])
    return torch.fft.ifft(spec, dim=-1).real * pairs.shape[-2]


def _quantize(attrs, data, min_range, max_range):
    """Affine uint8 quantization over [min_range, max_range]
    (ref: contrib/quantize.cc)."""
    lo = min_range.reshape(())
    hi = max_range.reshape(())
    scale = 255.0 / torch.clamp_min(hi - lo, 1e-8)
    q = torch.clamp(torch.round((data - lo) * scale), 0, 255)
    return q.to(torch.uint8), lo, hi


def _dequantize(attrs, data, min_range, max_range):
    lo = min_range.reshape(())
    hi = max_range.reshape(())
    scale = torch.clamp_min(hi - lo, 1e-8) / 255.0
    return data.to(torch.float32) * scale + lo


def _count_sketch(attrs, data, h, s):
    """Count-sketch projection: out[b, h[i]] += s[i] * data[b, i]; the
    gradient reaches data only."""
    idx = h.reshape(-1).to(torch.int64)
    signed = data * s.reshape(1, -1).to(data.dtype)
    out = torch.zeros((data.shape[0], attrs["out_dim"]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, idx, signed)


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

def register_all():
    register_op(OpDef(
        "CTCLoss", simple_compute(_ctc_loss),
        num_inputs=2, arguments=["data", "label"],
        infer_shape=_ctc_shape, hint="ctcloss",
        doc="CTC negative log-likelihood; blank=0, labels 0-padded "
            "(ref: src/operator/contrib/ctc_loss.cc)."),
        aliases=("_contrib_CTCLoss", "ctc_loss"))

    register_op(OpDef(
        "MultiBoxPrior", simple_compute(_multibox_prior),
        schema=ParamSchema(
            Param("sizes", "float_tuple", default=(1.0,)),
            Param("ratios", "float_tuple", default=(1.0,)),
            Param("clip", bool, default=False),
            Param("steps", "float_tuple", default=(-1.0, -1.0)),
            Param("offsets", "float_tuple", default=(0.5, 0.5))),
        num_inputs=1, arguments=["data"],
        infer_shape=_multibox_prior_shape, hint="multiboxprior",
        doc="SSD anchor generation "
            "(ref: src/operator/contrib/multibox_prior.cc)."),
        aliases=("_contrib_MultiBoxPrior",))

    register_op(OpDef(
        "MultiBoxTarget", simple_compute(_multibox_target),
        schema=ParamSchema(
            Param("overlap_threshold", float, default=0.5),
            Param("ignore_label", float, default=-1.0),
            Param("negative_mining_ratio", float, default=-1.0),
            Param("negative_mining_thresh", float, default=0.5),
            Param("variances", "float_tuple", default=(0.1, 0.1, 0.2, 0.2))),
        num_inputs=3, num_outputs=3,
        arguments=["anchor", "label", "cls_pred"],
        outputs=["loc_target", "loc_mask", "cls_target"],
        infer_shape=_multibox_target_shape, hint="multiboxtarget",
        doc="SSD anchor-to-ground-truth matching "
            "(ref: src/operator/contrib/multibox_target.cc)."),
        aliases=("_contrib_MultiBoxTarget",))

    register_op(OpDef(
        "MultiBoxDetection", simple_compute(_multibox_detection),
        schema=ParamSchema(
            Param("threshold", float, default=0.01),
            Param("nms_threshold", float, default=0.5),
            Param("force_suppress", bool, default=False),
            Param("variances", "float_tuple", default=(0.1, 0.1, 0.2, 0.2)),
            Param("nms_topk", int, default=-1)),
        num_inputs=3, arguments=["cls_prob", "loc_pred", "anchor"],
        infer_shape=_multibox_detection_shape, hint="multiboxdetection",
        doc="SSD decode + NMS "
            "(ref: src/operator/contrib/multibox_detection.cc)."),
        aliases=("_contrib_MultiBoxDetection",))

    register_op(OpDef(
        "Proposal", simple_compute(_proposal),
        schema=ParamSchema(
            Param("scales", "float_tuple", default=(4.0, 8.0, 16.0, 32.0)),
            Param("ratios", "float_tuple", default=(0.5, 1.0, 2.0)),
            Param("feature_stride", int, default=16),
            Param("threshold", float, default=0.7),
            Param("rpn_pre_nms_top_n", int, default=6000),
            Param("rpn_post_nms_top_n", int, default=300),
            Param("rpn_min_size", int, default=16)),
        num_inputs=3, arguments=["cls_prob", "bbox_pred", "im_info"],
        infer_shape=_proposal_shape, hint="proposal",
        doc="RPN region proposals: decode anchors + NMS + top-k "
            "(ref: src/operator/contrib/proposal.cc)."),
        aliases=("_contrib_Proposal",))

    register_op(OpDef(
        "fft", simple_compute(_fft), num_inputs=1,
        infer_shape=lambda a, i, x: (i, [i[0][:-1] + (2 * i[0][-1],)], []),
        hint="fft",
        doc="FFT along the last axis, interleaved re/im output "
            "(ref: src/operator/contrib/fft.cc)."),
        aliases=("_contrib_fft",))

    register_op(OpDef(
        "ifft", simple_compute(_ifft), num_inputs=1,
        infer_shape=lambda a, i, x: (i, [i[0][:-1] + (i[0][-1] // 2,)], []),
        hint="ifft",
        doc="Inverse FFT from interleaved re/im "
            "(ref: src/operator/contrib/ifft.cc)."),
        aliases=("_contrib_ifft",))

    f32 = np.dtype(np.float32)
    register_op(OpDef(
        "quantize", simple_compute(_quantize),
        num_inputs=3, num_outputs=3,
        arguments=["data", "min_range", "max_range"],
        outputs=["output", "min_output", "max_output"],
        infer_shape=lambda a, i, x: (i, [i[0], (), ()], []),
        infer_type=lambda a, i, x: (i, [np.dtype(np.uint8), f32, f32], x),
        hint="quantize",
        doc="uint8 range quantization "
            "(ref: src/operator/contrib/quantize.cc)."),
        aliases=("_contrib_quantize",))

    register_op(OpDef(
        "dequantize", simple_compute(_dequantize),
        num_inputs=3, arguments=["data", "min_range", "max_range"],
        infer_shape=lambda a, i, x: (i, [i[0]], []),
        infer_type=lambda a, i, x: (i, [f32], x),
        hint="dequantize",
        doc="Inverse of quantize "
            "(ref: src/operator/contrib/dequantize.cc)."),
        aliases=("_contrib_dequantize",))

    register_op(OpDef(
        "count_sketch", simple_compute(_count_sketch),
        schema=ParamSchema(Param("out_dim", int, required=True),
                           Param("processing_batch_size", int, default=32)),
        num_inputs=3, arguments=["data", "h", "s"],
        infer_shape=lambda a, i, x: (i, [(i[0][0], a["out_dim"])], []),
        hint="count_sketch",
        doc="Count-sketch random projection "
            "(ref: src/operator/contrib/count_sketch.cc); h = hash "
            "indices (in_dim,), s = signs (in_dim,)."),
        aliases=("_contrib_count_sketch",))
