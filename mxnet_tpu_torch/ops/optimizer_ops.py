"""The optimizer update ops ``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``rmsprop_update`` and ``rmspropalex_update`` (names,
schemas and arithmetic of ``mxnet_tpu/ops/optimizer_ops.py``, MXNet's
``src/operator/optimizer_op.cc``).

Each returns the new weight and the new states as outputs and leaves its
inputs as they are, as the reference's ops do; the optimizers
(``optimizer.py``) update in place through their own ``apply`` bodies and
do not call these.  The gradient is rescaled, then clipped to
±``clip_gradient`` when that is positive; RMSProp clips the new weight
to ±``clip_weights`` when that is positive.
"""
from __future__ import annotations

import torch

from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op, simple_compute


def _common_params(*extra):
    return ParamSchema(
        *extra,
        Param("lr", float, required=True),
        Param("wd", float, default=0.0),
        Param("rescale_grad", float, default=1.0),
        Param("clip_gradient", float, default=-1.0),
    )


def _prep_grad(attrs, grad):
    g = grad * attrs.get("rescale_grad", 1.0)
    clip = attrs.get("clip_gradient", -1.0)
    if clip is not None and clip > 0:
        g = torch.clamp(g, -clip, clip)
    return g


def _clip_weights(attrs, w):
    cw = attrs.get("clip_weights", -1.0)
    if cw is not None and cw > 0:
        w = torch.clamp(w, -cw, cw)
    return w


def _sgd(attrs, weight, grad):
    g = _prep_grad(attrs, grad)
    return weight - attrs["lr"] * (g + attrs.get("wd", 0.0) * weight)


def _sgd_mom(attrs, weight, grad, mom):
    g = _prep_grad(attrs, grad)
    new_mom = attrs.get("momentum", 0.0) * mom \
        - attrs["lr"] * (g + attrs.get("wd", 0.0) * weight)
    return weight + new_mom, new_mom


def _adam(attrs, weight, grad, mean, var):
    g = _prep_grad(attrs, grad)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    g = g + attrs.get("wd", 0.0) * weight
    new_mean = b1 * mean + (1 - b1) * g
    new_var = b2 * var + (1 - b2) * torch.square(g)
    w = weight - attrs["lr"] * new_mean / (torch.sqrt(new_var) + eps)
    return w, new_mean, new_var


def _rmsprop(attrs, weight, grad, n):
    g = _prep_grad(attrs, grad)
    g = g + attrs.get("wd", 0.0) * weight
    rho = attrs.get("gamma1", 0.95)
    eps = attrs.get("epsilon", 1e-8)
    new_n = rho * n + (1 - rho) * torch.square(g)
    w = weight - attrs["lr"] * g / torch.sqrt(new_n + eps)
    return _clip_weights(attrs, w), new_n


def _rmspropalex(attrs, weight, grad, n, g_state, delta):
    g = _prep_grad(attrs, grad)
    g = g + attrs.get("wd", 0.0) * weight
    rho = attrs.get("gamma1", 0.95)
    mom = attrs.get("gamma2", 0.9)
    eps = attrs.get("epsilon", 1e-8)
    new_n = rho * n + (1 - rho) * torch.square(g)
    new_g = rho * g_state + (1 - rho) * g
    new_delta = mom * delta - attrs["lr"] * g / torch.sqrt(
        new_n - torch.square(new_g) + eps)
    return _clip_weights(attrs, weight + new_delta), new_n, new_g, new_delta


def register_all():
    register_op(OpDef("sgd_update", simple_compute(_sgd),
                      schema=_common_params(), num_inputs=2,
                      arguments=["weight", "grad"]))
    register_op(OpDef("sgd_mom_update", simple_compute(_sgd_mom),
                      schema=_common_params(
                          Param("momentum", float, default=0.0)),
                      num_inputs=3, num_outputs=2,
                      arguments=["weight", "grad", "mom"],
                      outputs=["weight", "mom"]))
    register_op(OpDef("adam_update", simple_compute(_adam),
                      schema=_common_params(
                          Param("beta1", float, default=0.9),
                          Param("beta2", float, default=0.999),
                          Param("epsilon", float, default=1e-8)),
                      num_inputs=4, num_outputs=3,
                      arguments=["weight", "grad", "mean", "var"],
                      outputs=["weight", "mean", "var"]))
    register_op(OpDef("rmsprop_update", simple_compute(_rmsprop),
                      schema=_common_params(
                          Param("gamma1", float, default=0.95),
                          Param("epsilon", float, default=1e-8),
                          Param("clip_weights", float, default=-1.0)),
                      num_inputs=3, num_outputs=2,
                      arguments=["weight", "grad", "n"],
                      outputs=["weight", "n"]))
    register_op(OpDef("rmspropalex_update", simple_compute(_rmspropalex),
                      schema=_common_params(
                          Param("gamma1", float, default=0.95),
                          Param("gamma2", float, default=0.9),
                          Param("epsilon", float, default=1e-8),
                          Param("clip_weights", float, default=-1.0)),
                      num_inputs=5, num_outputs=4,
                      arguments=["weight", "grad", "n", "g", "delta"],
                      outputs=["weight", "n", "g", "delta"]))
