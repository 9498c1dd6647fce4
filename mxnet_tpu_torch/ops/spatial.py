"""Spatial ops (names, schemas and hints as in
``mxnet_tpu/ops/spatial.py``): ``ROIPooling``, ``GridGenerator``,
``BilinearSampler``, ``SpatialTransformer``, ``Crop`` and
``Correlation``.

Ordinary torch ops with the JAX package's formulas, so autograd gives
the gradients its ``jax.vjp`` gives: ROI pooling is a masked max over
each bin's membership (ties share the gradient, as both libraries'
max reductions do; empty bins pool to 0), bilinear sampling is four
gathers with zero padding outside the image (its backward is a
scatter-add: atomics on the card), and the correlation is one shifted
product a displacement.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op, simple_compute


def _pair(v, n=2):
    if isinstance(v, int):
        return (v,) * n
    if len(v) == 1:
        return tuple(v) * n
    return tuple(v)


# ---------------------------------------------------------------------------
# ROIPooling
# ---------------------------------------------------------------------------

def _c_round(v):
    """C's round(): half away from zero (torch.round is half to even)."""
    return torch.trunc(v + torch.copysign(torch.full_like(v, 0.5), v)) \
        .to(torch.int64)


def _bin_bounds(i, length, n_bins, origin):
    """[lo, hi) of bins ``i`` (P,) over windows of ``length`` (R,) at
    ``origin`` (R,): floor(i * l / P) and ceil((i + 1) * l / P), so bins
    may overlap by one row as in roi_pooling.cc.  -> (R, P) each."""
    lo = origin[:, None] + torch.div(i[None] * length[:, None], n_bins,
                                     rounding_mode="floor")
    hi = origin[:, None] - torch.div(-(i[None] + 1) * length[:, None],
                                     n_bins, rounding_mode="floor")
    return lo, hi


def _roi_pooling(attrs, data, rois):
    """Max-pool each ROI (R, 5) [batch, x1, y1, x2, y2] of data (N, C,
    H, W) into (R, C, ph, pw) bins over the scaled, C-rounded window."""
    ph, pw = _pair(attrs["pooled_size"])
    scale = attrs["spatial_scale"]
    _, _, h, w = data.shape
    dev = data.device
    images = data.index_select(0, rois[:, 0].to(torch.int64))  # (R,C,H,W)
    x1, y1, x2, y2 = (_c_round(rois[:, j] * scale) for j in range(1, 5))
    roi_h = torch.clamp_min(y2 - y1 + 1, 1)
    roi_w = torch.clamp_min(x2 - x1 + 1, 1)
    y_lo, y_hi = _bin_bounds(torch.arange(ph, device=dev), roi_h, ph, y1)
    x_lo, x_hi = _bin_bounds(torch.arange(pw, device=dev), roi_w, pw, x1)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    ymask = (ys >= y_lo[..., None]) & (ys < y_hi[..., None])   # (R,ph,H)
    xmask = (xs >= x_lo[..., None]) & (xs < x_hi[..., None])   # (R,pw,W)
    mask = ymask[:, :, None, :, None] & xmask[:, None, :, None, :]
    masked = torch.where(mask[:, None], images[:, :, None, None],
                         -torch.inf)
    out = torch.amax(masked, dim=(-2, -1))               # (R,C,ph,pw)
    # empty bins pool to 0 (the reference memsets the output)
    return torch.where(torch.isfinite(out), out, 0.0).to(data.dtype)


def _roi_shape(attrs, in_shapes, aux_shapes):
    dshape, rshape = in_shapes
    ph, pw = _pair(attrs["pooled_size"])
    return in_shapes, [(rshape[0], dshape[1], ph, pw)], []


# ---------------------------------------------------------------------------
# GridGenerator / BilinearSampler / SpatialTransformer
# ---------------------------------------------------------------------------

def _base_grid(h, w, dtype, device):
    """Normalized target coordinates in [-1, 1]: (3, h*w) rows x, y, 1."""
    ys = torch.linspace(-1.0, 1.0, h, dtype=dtype, device=device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)])


def _affine_grid(theta, h, w, dtype):
    """(N, 2, h, w) sampling grid of the affine maps ``theta`` (N, 6)."""
    grid = theta.reshape(-1, 2, 3) @ _base_grid(h, w, dtype, theta.device)
    return grid.reshape(-1, 2, h, w)


def _grid_generator(attrs, data):
    mode = attrs["transform_type"]
    if mode == "affine":
        h, w = _pair(attrs["target_shape"])
        return _affine_grid(data, h, w, data.dtype)
    if mode == "warp":
        # data: (N, 2, H, W) pixel flow -> normalized sample coordinates
        _, _, h, w = data.shape
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=data.dtype, device=data.device),
            torch.arange(w, dtype=data.dtype, device=data.device),
            indexing="ij")
        x = data[:, 0] + gx
        y = data[:, 1] + gy
        xn = 2.0 * x / max(w - 1, 1) - 1.0
        yn = 2.0 * y / max(h - 1, 1) - 1.0
        return torch.stack([xn, yn], dim=1)
    raise ValueError("transform_type must be 'affine' or 'warp'")


def _grid_shape(attrs, in_shapes, aux_shapes):
    dshape = in_shapes[0]
    if attrs["transform_type"] == "affine":
        h, w = _pair(attrs["target_shape"])
        return [(dshape[0], 6)], [(dshape[0], 2, h, w)], []
    return in_shapes, [dshape], []


def _bilinear_sample(data, grid):
    """Sample (N, C, H, W) at the normalized grid (N, 2, h, w); zero
    outside the image."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0               # (N, gh, gw)
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[:, None]
    wy = (gy - y0)[:, None]
    flat = data.reshape(n, c, h * w)

    def gather(yi, xi):
        """data at integer coordinates, 0 outside the image."""
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
        xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(n, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(n, c, idx.shape[-1]))
        vals = vals.reshape(n, c, *yi.shape[1:])
        return vals * valid[:, None].to(data.dtype)

    tl = gather(y0, x0)
    tr = gather(y0, x0 + 1)
    bl = gather(y0 + 1, x0)
    br = gather(y0 + 1, x0 + 1)
    return (tl * (1 - wx) * (1 - wy) + tr * wx * (1 - wy)
            + bl * (1 - wx) * wy + br * wx * wy)


def _bilinear_sampler(attrs, data, grid):
    return _bilinear_sample(data, grid).to(data.dtype)


def _sampler_shape(attrs, in_shapes, aux_shapes):
    dshape, gshape = in_shapes
    return in_shapes, [(dshape[0], dshape[1], gshape[2], gshape[3])], []


def _spatial_transformer(attrs, data, loc):
    h, w = _pair(attrs["target_shape"])
    return _bilinear_sample(data, _affine_grid(loc, h, w, data.dtype)) \
        .to(data.dtype)


def _st_shape(attrs, in_shapes, aux_shapes):
    dshape = in_shapes[0]
    h, w = _pair(attrs["target_shape"])
    return [dshape, (dshape[0], 6)], [(dshape[0], dshape[1], h, w)], []


# ---------------------------------------------------------------------------
# Crop
# ---------------------------------------------------------------------------

def _crop_window(attrs, h, w, th, tw):
    """(oy, ox) of the crop, checked to fit (the reference's crop-inl.h
    CHECKs its bounds)."""
    if attrs["center_crop"]:
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = _pair(attrs["offset"])
    if th > h or tw > w or oy < 0 or ox < 0 or oy + th > h or ox + tw > w:
        raise ValueError(
            "Crop window offset=(%d,%d) size=(%d,%d) exceeds input (%d,%d)"
            % (oy, ox, th, tw, h, w))
    return oy, ox


def _crop(attrs, data, *like):
    if like:
        th, tw = like[0].shape[2], like[0].shape[3]
    else:
        th, tw = _pair(attrs["h_w"])
    oy, ox = _crop_window(attrs, data.shape[2], data.shape[3], th, tw)
    return data[:, :, oy:oy + th, ox:ox + tw]


def _crop_shape(attrs, in_shapes, aux_shapes):
    dshape = in_shapes[0]
    if len(in_shapes) > 1:
        th, tw = in_shapes[1][2], in_shapes[1][3]
    else:
        th, tw = _pair(attrs["h_w"])
    _crop_window(attrs, dshape[2], dshape[3], th, tw)
    return in_shapes, [(dshape[0], dshape[1], th, tw)], []


# ---------------------------------------------------------------------------
# Correlation (FlowNet)
# ---------------------------------------------------------------------------

def _correlation(attrs, data1, data2):
    """Patch cross-correlation of two feature maps: for each displacement
    on the search grid, the channel mean of data1 * shifted data2 (or
    |data1 - shifted data2|), averaged over the kernel window ("SAME"
    zero padding), at every stride1-th position."""
    max_disp = attrs["max_displacement"]
    stride1 = attrs["stride1"]
    kernel = attrs["kernel_size"]
    pad = max(attrs["pad_size"], max_disp)
    _, _, h, w = data1.shape
    p2 = F.pad(data2, (pad, pad, pad, pad))
    offsets = range(-max_disp, max_disp + 1, attrs["stride2"])
    lo = (kernel - 1) // 2
    maps = []
    for dy in offsets:
        for dx in offsets:
            shifted = p2[:, :, pad + dy:pad + dy + h, pad + dx:pad + dx + w]
            prod = data1 * shifted if attrs["is_multiply"] \
                else torch.abs(data1 - shifted)
            corr = prod.mean(dim=1)
            if kernel > 1:
                window = F.pad(corr, (lo, kernel - 1 - lo,
                                      lo, kernel - 1 - lo))
                corr = F.avg_pool2d(window[:, None], kernel, stride=1)[:, 0]
            maps.append(corr[:, ::stride1, ::stride1])
    return torch.stack(maps, dim=1).to(data1.dtype)


def _correlation_shape(attrs, in_shapes, aux_shapes):
    dshape = in_shapes[0]
    max_disp = attrs["max_displacement"]
    s1 = attrs["stride1"]
    d = len(range(-max_disp, max_disp + 1, attrs["stride2"]))
    return in_shapes, [(dshape[0], d * d, -(-dshape[2] // s1),
                        -(-dshape[3] // s1))], []


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

def register_all():
    register_op(OpDef(
        "ROIPooling", simple_compute(_roi_pooling),
        schema=ParamSchema(
            Param("pooled_size", "shape", required=True),
            Param("spatial_scale", float, required=True)),
        num_inputs=2, arguments=["data", "rois"],
        infer_shape=_roi_shape, hint="roipooling",
        doc="Max-pool regions of interest to a fixed size "
            "(ref: src/operator/roi_pooling.cc)."))

    register_op(OpDef(
        "GridGenerator", simple_compute(_grid_generator),
        schema=ParamSchema(
            Param("transform_type", str, required=True),
            Param("target_shape", "shape", default=(0, 0))),
        num_inputs=1, arguments=["data"],
        infer_shape=_grid_shape, hint="gridgenerator",
        doc="Sampling-grid generation for bilinear sampling "
            "(ref: src/operator/grid_generator-inl.h)."))

    register_op(OpDef(
        "BilinearSampler", simple_compute(_bilinear_sampler),
        num_inputs=2, arguments=["data", "grid"],
        infer_shape=_sampler_shape, hint="bilinearsampler",
        doc="Bilinear sampling by normalized grid, zero padding outside "
            "(ref: src/operator/bilinear_sampler-inl.h)."))

    register_op(OpDef(
        "SpatialTransformer", simple_compute(_spatial_transformer),
        schema=ParamSchema(
            Param("target_shape", "shape", required=True),
            Param("transform_type", str, default="affine"),
            Param("sampler_type", str, default="bilinear")),
        num_inputs=2, arguments=["data", "loc"],
        infer_shape=_st_shape, hint="spatialtransformer",
        doc="Affine spatial transformer network layer "
            "(ref: src/operator/spatial_transformer-inl.h)."))

    register_op(OpDef(
        "Crop", simple_compute(_crop),
        schema=ParamSchema(
            Param("num_args", int, required=True),
            Param("offset", "shape", default=(0, 0)),
            Param("h_w", "shape", default=(0, 0)),
            Param("center_crop", bool, default=False)),
        num_inputs=lambda a: a["num_args"],
        arguments=lambda a: ["data"] if a["num_args"] == 1
        else ["data", "crop_like"],
        key_var_num_args="num_args",
        infer_shape=_crop_shape, hint="crop",
        doc="Spatial crop to explicit size or a reference symbol's size "
            "(ref: src/operator/crop-inl.h)."))

    register_op(OpDef(
        "Correlation", simple_compute(_correlation),
        schema=ParamSchema(
            Param("kernel_size", int, default=1),
            Param("max_displacement", int, default=1),
            Param("stride1", int, default=1),
            Param("stride2", int, default=1),
            Param("pad_size", int, default=0),
            Param("is_multiply", bool, default=True)),
        num_inputs=2, arguments=["data1", "data2"],
        infer_shape=_correlation_shape, hint="correlation",
        doc="Patch cross-correlation of two feature maps "
            "(ref: src/operator/correlation-inl.h)."))
